"""Pipeline parallelism: stage tags and a GPipe microbatch pipeline
(counterpart of t2ms_tpu/parallel/pp.py).

* ``stage(i)`` / ``current_stage()``: profiler-visible stage tags
  (``torch.profiler.record_function(f"pp_stage_{i}")``).
* ``pipeline_apply(fn, stage_params, x, mesh, ...)``: run S stages of one
  signature over an S-sized ``'stage'`` mesh axis with JAX's GPipe
  schedule. The batch is split into M microbatches; at tick t stage 0
  takes microbatch t, every stage computes, and activations move one stage
  on by ``ppermute``; after M + S - 1 ticks the last stage has produced
  every microbatch (microbatch t - (S - 1) at tick t), and a masked
  ``psum`` hands the output to every rank. Gradients flow backwards
  through ``ppermute``'s reverse permutation.

Rank s holds only stage s's parameters. Every rank runs the same ticks
and builds the same graph (masks are ``torch.where``, never a branch on
the rank), so the backward's sends and receives pair up on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch

from t2ms_tpu_torch.parallel.collectives import copy_to, ppermute, psum

__all__ = ["stage", "current_stage", "pipeline_apply"]

_STAGE_STACK: list = []


@contextlib.contextmanager
def stage(index: int) -> Iterator[None]:
    """Mark a region as pipeline stage ``index``: an informational tag,
    visible in a profiler trace; ``current_stage`` reads it.
    ``pipeline_apply`` does not consume it. Not thread-safe."""
    _STAGE_STACK.append(index)
    with torch.profiler.record_function(f"pp_stage_{index}"):
        try:
            yield
        finally:
            _STAGE_STACK.pop()


def current_stage() -> Optional[int]:
    return _STAGE_STACK[-1] if _STAGE_STACK else None


def pipeline_apply(fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "stage",
                   n_microbatches: Optional[int] = None) -> torch.Tensor:
    """GPipe forward over the mesh axis ``axis`` (S = its size).

    ``fn(params, h) -> h`` keeps the activation's shape; ``stage_params``
    are THIS rank's stage's parameters (stage s = this rank's coordinate
    on ``axis``); ``x`` is the full batch (B, ...), the same on every
    rank, with B divisible by ``n_microbatches`` (default S). Returns
    fn_{S-1}(... fn_0(x)) on every rank. The gradient of x reaches every
    rank whole; each rank's stage parameters get their own gradient."""
    S = mesh.shape[axis]
    s_idx = mesh.index(axis)
    group = mesh.group(axis)
    M = n_microbatches or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    micro = copy_to(x, group).reshape(M, B // M, *x.shape[1:])
    first = torch.tensor(s_idx == 0, device=x.device)
    last = torch.tensor(s_idx == S - 1, device=x.device)
    fwd_perm = [(s, s + 1) for s in range(S - 1)]

    buf = torch.zeros_like(micro[0])
    outs = [None] * M
    n_ticks = M + S - 1
    for t in range(n_ticks):
        # inject microbatch t at stage 0 (clamped; masked off elsewhere)
        h_in = torch.where(first, micro[min(t, M - 1)], buf)
        with stage(s_idx):
            h = fn(stage_params, h_in)
        j = t - (S - 1)
        if 0 <= j < M:
            # only the last stage's output is real
            outs[j] = torch.where(last, h, torch.zeros_like(h))
        if S > 1 and t != n_ticks - 1:
            buf = ppermute(h, fwd_perm, group)
    out = psum(torch.stack(outs), group)
    return out.reshape(B, *x.shape[1:])
