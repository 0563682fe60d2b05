"""Checkpoint IO on torch files with the reference's artifact semantics
(counterpart of t2ms_tpu/training/checkpoints.py, which writes Orbax).

The reference saves {model, optimizer, epoch, loss_list} every N epochs
(train.py:92-95) and resumes optimizer state and epoch from
--checkpoint_path (train.py:42-47). As in the JAX package, a checkpoint
is a directory ``model_{epoch}`` holding the payload {params, opt_state,
step, epoch} (here one torch file, ``checkpoint.pt``: the model's and the
optimizer's state_dicts, the optimizer-step count and the epoch) with the
loss history as a ``model_{epoch}.loss_history.npy`` sidecar beside it;
a params-only checkpoint (the VAE's ``final_model``, an EMA shadow) is a
directory holding ``params.pt``. Retention (``max_to_keep``,
``keep_period``) follows Orbax's CheckpointManager.

``load_torch_file`` reads a reference checkpoint (.pth: a whole pickled
module, a state_dict or a train-loop dict) without the reference package;
its names are the port's module names, so it loads straight into them.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["TrainCheckpointManager", "save_train_ckpt", "load_train_ckpt",
           "save_params", "load_params", "latest_step", "load_torch_file",
           "load_reference_state_dict"]

_CKPT, _PARAMS = "checkpoint.pt", "params.pt"


def _to_cpu(tree):
    """A state_dict's tensors on the host, so a checkpoint does not name
    the device it was written from."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save(obj, path: str) -> None:
    """torch.save through a temporary name, so a reader never sees half a
    file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _sidecar(path: str) -> str:
    return os.path.abspath(path) + ".loss_history.npy"


def _steps(directory: str) -> List[int]:
    """The N of every ``model_N`` checkpoint directory, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for entry in os.listdir(directory):
        m = re.fullmatch(r"model_(\d+)", entry)
        if m and os.path.isfile(os.path.join(directory, entry, _CKPT)):
            out.append(int(m.group(1)))
    return sorted(out)


def save_train_ckpt(directory: str, step: int, params, opt_state,
                    loss_history=None, opt_step: Optional[int] = None
                    ) -> str:
    """Write {params, opt_state, step, epoch} to directory/model_{step}
    and the loss history beside it. ``step`` names the checkpoint (the
    reference's epoch); ``opt_step`` is the optimizer-step count (default
    ``step``)."""
    path = os.path.abspath(os.path.join(directory, f"model_{step}"))
    _save({"params": _to_cpu(params), "opt_state": _to_cpu(opt_state),
           "step": int(step if opt_step is None else opt_step),
           "epoch": int(step)}, os.path.join(path, _CKPT))
    np.save(_sidecar(path), np.asarray(
        loss_history if loss_history is not None else [], dtype=np.float32))
    return path


def load_train_ckpt(path: str) -> Dict[str, Any]:
    """{params, opt_state, step, epoch, loss_history} of a ``model_N``
    checkpoint; ``step`` is the optimizer-step count, ``epoch`` the
    checkpoint's epoch, restored apart."""
    restored = dict(_load(os.path.join(path, _CKPT)))
    hist = _sidecar(path)
    restored["loss_history"] = (np.load(hist).tolist()
                                if os.path.exists(hist) else [])
    return restored


class TrainCheckpointManager:
    """``model_{step}`` checkpoints in one directory with Orbax's
    retention: after each save every checkpoint but the newest
    ``max_to_keep`` is deleted unless its step is a multiple of
    ``keep_period``; None for either keeps all, the reference's
    behaviour. Each loss-history sidecar goes with its checkpoint.
    Checkpoints already in the directory count, as in Orbax."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 keep_period: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep, self.keep_period = max_to_keep, keep_period
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, params, opt_state, loss_history=None,
             opt_step: Optional[int] = None) -> None:
        save_train_ckpt(self.directory, step, params, opt_state,
                        loss_history, opt_step)
        if self.max_to_keep is None:
            return
        for s in self.all_steps()[:-self.max_to_keep]:
            if self.keep_period and s % self.keep_period == 0:
                continue
            path = os.path.join(self.directory, f"model_{s}")
            shutil.rmtree(path, ignore_errors=True)
            if os.path.exists(_sidecar(path)):
                os.remove(_sidecar(path))

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
        return load_train_ckpt(os.path.join(self.directory, f"model_{step}"))

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def save_params(directory: str, params, name: str = "final_model") -> str:
    """A params-only checkpoint: directory/name/params.pt."""
    path = os.path.abspath(os.path.join(directory, name))
    _save({"params": _to_cpu(params)}, os.path.join(path, _PARAMS))
    return path


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a params-only checkpoint, or the params of a
    train checkpoint."""
    f = os.path.join(path, _PARAMS)
    if not os.path.exists(f):
        f = os.path.join(path, _CKPT)
    return _load(f)["params"]


def latest_step(directory: str) -> Optional[int]:
    """Largest N among model_N checkpoints."""
    steps = _steps(directory)
    return steps[-1] if steps else None


# -------------------------------------------------- reference checkpoints

def _shim_torch_load(path: str):
    """torch.load(weights_only=False) without the reference package on the
    import path: classes it cannot import resolve to empty nn.Module
    subclasses, so a pickled whole module restores its parameter tree and
    a working state_dict(). Unpickling runs code: load only checkpoints
    you trust."""

    class _ShimUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                shim = type(name, (torch.nn.Module,), {})
                shim.__module__ = module
                return shim

    class _PickleShim:
        Unpickler = _ShimUnpickler
        load = staticmethod(lambda f, **kw: _ShimUnpickler(f).load())
        loads = staticmethod(
            lambda b, **kw: _ShimUnpickler(io.BytesIO(b)).load())

    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PickleShim)


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """The flat name -> tensor state_dict of a reference checkpoint: a
    whole pickled module (infer.py:39-41), a state_dict, or a train-loop
    dict {model, optimizer, epoch, loss_list} (train.py:92-95)."""
    obj = _shim_torch_load(path)
    if isinstance(obj, dict) and "model" in obj and hasattr(
            obj["model"], "keys"):
        obj = obj["model"]
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"unrecognized checkpoint object: {type(obj)}")
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def load_reference_state_dict(module: torch.nn.Module, path: str) -> None:
    """Load a reference checkpoint into ``module``, whose names are the
    reference's. Keys the module does not have are left out (the DiT's
    unused ``unpatch`` and fixed ``pos_embed``, a train-loop dict's
    grafted ``encoder.*``); a key the module has and the file lacks
    raises."""
    sd = load_torch_file(path)
    own = module.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"{path} lacks {missing[:5]} "
                       f"({len(missing)} of {len(own)} keys)")
    module.load_state_dict({k: sd[k] for k in own})
