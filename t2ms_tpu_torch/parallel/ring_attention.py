"""Ring attention: sequence-parallel attention over a mesh axis
(counterpart of t2ms_tpu/parallel/ring_attention.py).

The token axis is split over the ranks of a mesh axis: each rank holds one
Q/K/V shard, and the K/V shards move one hop around the ring per step
(``ppermute``) while an online-softmax accumulator folds in one block per
hop. No rank ever holds the full (N, N) score matrix. JAX computes this
with einsums, not a Pallas kernel, so the port uses stock torch ops; it is
differentiable through ``ppermute``.
"""

from __future__ import annotations

from typing import Optional

import torch

from t2ms_tpu_torch.parallel.collectives import (all_gather, group_size,
                                                 ppermute)

__all__ = ["ring_attention", "ring_attention_sharded"]


def _online_block(q, k_blk, v_blk, acc, row_max, row_sum, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
    new_max = torch.maximum(row_max, s.amax(dim=-1))
    corr = torch.exp(row_max - new_max)
    p = torch.exp(s - new_max[..., None])
    acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
    row_sum = row_sum * corr + p.sum(dim=-1)
    return acc, new_max, row_sum


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, scale: Optional[float] = None) -> torch.Tensor:
    """Per-shard body: q/k/v are this rank's token shards (B, H, n_local,
    D); returns its output shard. ``acc``, ``row_max`` and ``row_sum`` are
    f32; the last hop sends nothing."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n_dev = group_size(group)
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    qf = q.float()
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    row_max = torch.full(q.shape[:-1], -torch.inf, dtype=torch.float32,
                         device=q.device)
    row_sum = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    k_blk, v_blk = k.float(), v.float()
    for hop in range(n_dev):
        acc, row_max, row_sum = _online_block(qf, k_blk, v_blk, acc,
                                              row_max, row_sum, scale)
        if hop != n_dev - 1:
            k_blk = ppermute(k_blk, perm, group)
            v_blk = ppermute(v_blk, perm, group)
    return (acc / row_sum[..., None]).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, axis_name: str = "data",
                           scale: Optional[float] = None) -> torch.Tensor:
    """Full-array entry point: every rank passes the whole (B, H, N, D)
    arrays, keeps its N / axis-size token shard, runs the ring and returns
    the whole output. The axis size must divide N."""
    n, r = mesh.shape[axis_name], mesh.index(axis_name)
    N = q.shape[2]
    if N % n:
        raise ValueError(f"{N} tokens not divisible by the {axis_name} "
                         f"axis of {n}")
    b = N // n
    cut = lambda a: a[:, :, r * b:(r + 1) * b]
    group = mesh.group(axis_name)
    out = ring_attention(cut(q), cut(k), cut(v), group, scale)
    return all_gather(out, group, dim=2)
