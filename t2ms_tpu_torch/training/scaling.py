"""CLI-facing scaling policy: the data-parallel mesh, gradient
accumulation and the compute dtype (counterpart of
t2ms_tpu/training/scaling.py).

The CLIs derive a ScalingPlan from the same flags as the JAX package:

  * mesh / n_data: with a process group of W ranks (``torchrun``, one
    process per device), data parallelism over all W, and a batch that W
    does not divide is refused; without a group, one device (``n_data``
    1, no mesh);
  * accum_steps: the smallest count whose per-device microbatch is at
    most ``--microbatch_cap`` rows and still splits evenly over the data
    axis (``--accum_steps`` sets it);
  * compute_dtype: the activation dtype (params stay f32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from t2ms_tpu_torch.parallel.mesh import make_mesh

__all__ = ["ScalingPlan", "parse_dtype", "auto_accum_steps",
           "setup_scaling", "add_scaling_args", "DEFAULT_MICROBATCH_CAP"]

# The JAX package's default per-device microbatch, kept so both packages
# accumulate the same way for the same flags.
DEFAULT_MICROBATCH_CAP = 1024

_DTYPE_ALIASES = {
    "f32": torch.float32, "float32": torch.float32, "fp32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


class ScalingPlan(NamedTuple):
    n_data: int                   # data-parallel width
    accum_steps: int              # gradient-accumulation microsteps
    compute_dtype: torch.dtype    # activation dtype (params stay f32)
    mesh: object = None           # parallel.mesh.Mesh, None on one device

    def describe(self) -> str:
        name = str(self.compute_dtype).replace("torch.", "")
        world = (dist.get_world_size() if dist.is_available()
                 and dist.is_initialized() else 1)
        return (f"devices={self.n_data} (of {world}), "
                f"accum_steps={self.accum_steps}, compute_dtype={name}")


def parse_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPE_ALIASES[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown compute dtype {name!r}; use f32 or bf16") from None


def auto_accum_steps(global_batch: int, n_data: int = 1,
                     microbatch_cap: int = DEFAULT_MICROBATCH_CAP) -> int:
    """Smallest accum count so that (a) the per-device microbatch is at
    most ``microbatch_cap`` rows, (b) the microbatch divides the global
    batch, and (c) the microbatch still splits evenly over ``n_data``.
    Terminates: a = global_batch // n_data meets (b) and (c)."""
    if global_batch % n_data:
        raise ValueError(
            f"global batch {global_batch} not divisible by DP width "
            f"{n_data}")
    a = max(1, math.ceil(global_batch / (n_data * microbatch_cap)))
    while global_batch % a or (global_batch // a) % n_data:
        a += 1
    return a


def add_scaling_args(p, default_dtype: str = "f32",
                     default_cap: int = DEFAULT_MICROBATCH_CAP) -> None:
    """Install the shared scaling flags on an ArgumentParser."""
    p.add_argument("--accum_steps", type=int, default=0,
                   help="gradient accumulation microsteps "
                        "(0 = auto from --microbatch_cap)")
    p.add_argument("--microbatch_cap", type=int, default=default_cap,
                   help="max per-device rows in one unaccumulated "
                        "forward+backward")
    p.add_argument("--compute_dtype", type=str, default=default_dtype,
                   choices=["f32", "float32", "bf16", "bfloat16"],
                   help="activation dtype; params stay f32")


def setup_scaling(args, batch_size: Optional[int] = None,
                  for_training: bool = True) -> ScalingPlan:
    """The ScalingPlan of a CLI call. ``batch_size`` defaults to
    args.batch_size; serving (``for_training=False``) never accumulates."""
    if batch_size is None:
        batch_size = args.batch_size
    mesh = None
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        # every rank runs the step, so every rank joins the mesh: demand
        # divisibility instead of shrinking the DP width
        n_data = dist.get_world_size()
        if batch_size % n_data:
            raise ValueError(
                f"global batch {batch_size} must divide over all "
                f"{n_data} devices in a multi-host run (every host's "
                f"chips must join the mesh); pad the batch or adjust "
                f"--batch_size")
        mesh = make_mesh(data=n_data, model=1)
    else:
        n_data = 1
    dtype = parse_dtype(getattr(args, "compute_dtype", "f32"))
    if not for_training:
        return ScalingPlan(n_data, 1, dtype, mesh)
    cap = getattr(args, "microbatch_cap", DEFAULT_MICROBATCH_CAP)
    accum = getattr(args, "accum_steps", 0)
    if accum:
        mb = batch_size // accum
        if batch_size % accum or mb % n_data:
            raise ValueError(
                f"--accum_steps {accum} does not evenly split batch "
                f"{batch_size} over {n_data} devices")
    else:
        accum = auto_accum_steps(batch_size, n_data, cap)
    return ScalingPlan(n_data, accum, dtype, mesh)
