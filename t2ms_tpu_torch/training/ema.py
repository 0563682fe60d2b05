"""Opt-in exponential moving average of the denoiser's weights
(counterpart of t2ms_tpu/training/ema.py).

The reference has no EMA; ``--ema_decay`` on the train CLI (0 = off, the
reference's behaviour) keeps a shadow ``ema = decay * ema + (1 - decay) *
params`` after each step, saved beside each ``model_{epoch}`` as the
params-only checkpoint ``model_{epoch}_ema``; ``--use_ema`` on the infer
CLI samples from it. The shadow is a state_dict (name -> f32 tensor on
the model's device).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["make_ema_update", "ema_name", "prune_ema", "setup_cli_ema",
           "save_cli_ema", "load_ema_for_inference"]


def ema_name(step) -> str:
    """Checkpoint name for the shadow next to ``model_{step}``."""
    return f"model_{step}_ema"


def prune_ema(directory: str, keep_steps, current: int) -> None:
    """Drop ``model_{s}_ema`` whose step the checkpoint manager no longer
    keeps (as it drops the loss-history sidecars)."""
    keep = set(int(s) for s in keep_steps) | {int(current)}
    for entry in os.listdir(directory):
        m = re.fullmatch(r"model_(\d+)_ema", entry)
        if m and int(m.group(1)) not in keep:
            shutil.rmtree(os.path.join(directory, entry),
                          ignore_errors=True)


def make_ema_update(decay: float) -> Callable:
    """``update(ema, model)``: ema = decay * ema + (1 - decay) * params in
    place, for every parameter of ``model`` (no bias correction, the
    diffusion convention)."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {decay}")

    @torch.no_grad()
    def update(ema: Dict[str, torch.Tensor], model: torch.nn.Module) -> None:
        for name, p in model.named_parameters():
            e = ema[name]
            e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay)

    return update


def setup_cli_ema(decay: float, model: torch.nn.Module,
                  checkpoint_path: str = "") -> Tuple[Optional[dict],
                                                      Optional[Callable]]:
    """Train-CLI entry: ``(ema, update)``, or ``(None, None)`` when decay
    is 0. The shadow starts as a copy of the live parameters; on resume a
    saved ``{checkpoint_path}_ema`` takes its place."""
    if not decay:
        return None, None
    update = make_ema_update(decay)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    path = checkpoint_path + "_ema" if checkpoint_path else ""
    if path and os.path.isdir(path):
        from t2ms_tpu_torch.training import checkpoints as ckpt
        for n, v in ckpt.load_params(path).items():
            ema[n].copy_(v)
        print(f"Resumed EMA weights from {path}")
    return ema, update


def save_cli_ema(directory: str, ema: dict, epoch: int, keep_steps) -> None:
    """Persist the shadow next to ``model_{epoch}`` and prune the shadows
    the checkpoint manager no longer keeps."""
    from t2ms_tpu_torch.training import checkpoints as ckpt
    ckpt.save_params(directory, ema, name=ema_name(epoch))
    prune_ema(directory, keep_steps, epoch)


def load_ema_for_inference(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """Infer-CLI entry for ``--use_ema``: the ``{checkpoint_path}_ema``
    state_dict, or FileNotFoundError (sampling silently from the live
    weights would defeat the flag)."""
    path = checkpoint_path + "_ema"
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"--use_ema: no EMA checkpoint at {path} (train with "
            f"--ema_decay to produce one)")
    from t2ms_tpu_torch.training import checkpoints as ckpt
    params = ckpt.load_params(path)
    print(f"Loaded EMA weights from {path}")
    return params
