"""Differentiable collectives: the port's counterparts of ``lax.ppermute``,
``lax.psum`` and ``lax.all_gather``, which JAX gets from XLA.

Every function takes a process group (a mesh axis's ``mesh.group(axis)``)
and is the identity when the group is None (no process group: the 1x1
mesh). A group of one still runs its collective, so one card exercises
NCCL as several do.

Gradient convention: an output that every rank of the group holds alike
(``psum``, ``all_gather``) is consumed alike by every rank, so the
gradient reaching each rank is already the whole gradient: ``psum``
passes it through and ``all_gather`` hands each rank its own slice.
``copy_to`` marks a replicated tensor entering a rank-local partial
computation: identity forward, and an all-reduce of the partial gradients
backward. ``ppermute``'s backward is the reverse permutation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["ppermute", "psum", "all_gather", "copy_to", "group_size"]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _permute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group) -> torch.Tensor:
    """Send x to every dst with (me, dst) in perm and return what arrives
    from the src with (src, me) in perm (zeros when nothing does). One
    ``batch_isend_irecv`` carries all of this rank's sends and receives,
    so no ordering of blocking calls can deadlock."""
    out = torch.zeros_like(x)
    if group is None:
        for s, d in perm:
            if s == d == 0:
                out.copy_(x)
        return out
    me = dist.get_rank(group)
    x = x.contiguous()
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, d), group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, s), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, inverse, ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` lists (source, destination) group ranks;
    a rank that is no destination receives zeros. Every rank of the group
    must call it with the same ``perm``."""
    return _PPermute.apply(x, [tuple(p) for p in perm], group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, held alike by every rank (backward: identity)."""
    return x if group is None else _PSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate the group's tensors along ``dim`` in rank order
    (backward: this rank's slice of the gradient)."""
    return x if group is None else _AllGather.apply(x, group, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; all-reduces the gradient over the group."""
    return x if group is None else _CopyTo.apply(x, group)
