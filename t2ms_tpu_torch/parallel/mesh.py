"""Device mesh and batch placement (counterpart of
t2ms_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``('data', 'model')`` mesh and
lets XLA insert every collective from sharding annotations. The port uses
PyTorch's idiom instead: one process per device in a ``torch.distributed``
process group (NCCL on CUDA, gloo when the caller asks for the CPU), a
``DeviceMesh`` of shape (data, model) over the group's ranks, and every
collective written out where XLA would have put it
(``parallel/collectives.py``).

Rank r sits at mesh coordinate (r // model, r % model), as JAX reshapes
its device list. With no process group, or a group of one, ``make_mesh``
gives a 1x1 mesh on which every collective is the identity, so one chip
and many chips run the same code.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicated",
           "shard_batch", "host_local_batch_size", "init_process_group",
           "init_from_env", "is_main"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


# the timeout ``init_process_group`` gave the group (None: made elsewhere)
_group_timeout_s: Optional[float] = None


def _timeout_s() -> float:
    """The shortest timeout any group of a mesh can have: the default
    group's, and torch's default for the subgroups a ``DeviceMesh`` makes
    (10 minutes for NCCL, 30 for gloo)."""
    from torch.distributed import constants
    sub = (constants.default_pg_nccl_timeout if dist.get_backend() == "nccl"
           else constants.default_pg_timeout).total_seconds()
    return sub if _group_timeout_s is None else min(sub, _group_timeout_s)


def is_main() -> bool:
    """True on rank 0, or without a process group: the rank that writes a
    run's files."""
    return not _initialized() or dist.get_rank() == 0


class Mesh:
    """A named grid of ranks. ``shape`` maps each axis name to its size;
    ``group(axis)`` is the process group of the ranks that share this
    rank's coordinates on every other axis (None without a process
    group); ``index(axis)`` is this rank's coordinate on ``axis``;
    ``timeout_s`` is the shortest time a collective of its groups may wait
    before the group aborts (None without a process group)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device_mesh=None, timeout_s: Optional[float] = None):
        self.devices = ranks
        self.timeout_s = timeout_s
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        self.device_mesh = device_mesh
        me = dist.get_rank() if device_mesh is not None else int(
            ranks.reshape(-1)[0])
        coord = np.argwhere(ranks == me)[0]
        self._coord = dict(zip(self.axis_names, (int(c) for c in coord)))

    @property
    def distributed(self) -> bool:
        """True when the mesh's collectives run over a process group."""
        return self.device_mesh is not None

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self._coord[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, distributed={self.distributed})"


def make_mesh(devices: Optional[Sequence[int]] = None, data: int = -1,
              model: int = 1,
              axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """Build a 2-D ('data','model') mesh over ``devices``, the global ranks
    of the process group (default: all of them, or rank 0 alone without a
    group). ``data=-1`` means 'all remaining devices'."""
    if devices is None:
        devices = range(dist.get_world_size() if _initialized() else 1)
    devices = [int(d) for d in devices]
    n = len(devices)
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    ranks = np.asarray(devices).reshape(data, model)
    if not _initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} devices needs a process group of {n} ranks "
                f"(parallel.mesh.init_process_group); there is none")
        return Mesh(ranks, axis_names)
    if sorted(devices) != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh must hold every rank of the process "
                         f"group once: {devices} over "
                         f"{dist.get_world_size()} ranks")
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(ranks, axis_names,
                DeviceMesh(device_type, torch.as_tensor(ranks),
                           mesh_dim_names=tuple(axis_names)), _timeout_s())


def data_sharding(mesh: Mesh, ndim: int = 1) -> tuple:
    """The placement of a batch: axis 0 split over 'data', the rest
    replicated (JAX's ``P('data', None, ...)``)."""
    return ("data",) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> tuple:
    """The placement of a replicated array (JAX's ``P()``)."""
    return ()


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every array leaf of a global batch (a tuple,
    list or dict of numpy arrays or tensors): data coordinate r takes rows
    [r*b, (r+1)*b) with b = B / n_data, JAX's row order. Ranks that differ
    only on 'model' hold the same rows. Every rank loads the global batch,
    so this is also JAX's multi-host ``global_shard_batch``."""
    n, r = mesh.shape["data"], mesh.index("data")

    def _rows(a):
        if not isinstance(a, (np.ndarray, torch.Tensor)):
            return a
        if a.shape[0] % n:
            raise ValueError(f"batch {a.shape[0]} not divisible by data "
                             f"axis {n}")
        b = a.shape[0] // n
        return a[r * b:(r + 1) * b]
    return _map(_rows, batch)


def host_local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows each process supplies of a global batch, with JAX's two
    refusals."""
    n_data = mesh.shape["data"]
    if global_batch % n_data != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {n_data}")
    pc = dist.get_world_size() if _initialized() else 1
    if global_batch % pc != 0:
        # the data axis can be smaller than the process count (TP-heavy
        # meshes): integer division here would under-supply the batch
        raise ValueError(
            f"global batch {global_batch} not divisible by process "
            f"count {pc}")
    return global_batch // pc


def init_process_group(device, store_dir: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device. The backend
    follows the device: NCCL for CUDA (never gloo), gloo for the CPU.
    ``store_dir`` joins through a ``FileStore`` there (no TCP port is
    chosen); without it the group rendezvouses through the environment
    (``torchrun``'s MASTER_ADDR/MASTER_PORT). ``rank`` and ``world_size``
    default to RANK and WORLD_SIZE. On CUDA the rank binds to card
    LOCAL_RANK (default: rank modulo the visible cards)."""
    global _group_timeout_s
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    dev = torch.device(device)
    kw = dict(rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store_dir is not None:
        kw["store"] = dist.FileStore(os.path.join(store_dir, "store"),
                                     world_size)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: CUDA is not available; "
                               "pass device='cpu' for a gloo group")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", **kw)
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    _group_timeout_s = float(timeout_s)
    return dev


def init_from_env(device) -> torch.device:
    """For the CLIs under ``torchrun``: join the group the environment
    describes when WORLD_SIZE > 1 (and no group exists yet), and return
    this rank's device; else return ``device`` as it is."""
    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and not _initialized():
        return init_process_group(device)
    if _initialized() and torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
