"""Plain attention oracles (counterparts of t2ms_tpu/ops/attention.py
``einsum_attention`` / ``_einsum_natural`` and the ``attn_heads_natural``
recipe that every fused TPU kernel shares).

``attn_heads_natural`` keeps the kernels' order of precision steps:
q scaled at input width, f32 scores, row max subtracted then cast to input
width before exp, f32 row sum and f32 PV accumulation, normalization after
PV. The CUDA kernel in ``csrc/dit_stack.cu`` follows the same steps."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["einsum_attention", "einsum_natural", "attn_heads_natural"]


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Eager attention on the head-split (B, H, N, D) layout, softmax in
    the caller's dtype (as the JAX oracle)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def einsum_natural(q, k, v, num_heads: int,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Natural (B, N, H*D) layout: split -> einsum_attention -> merge."""
    B, N, HD = q.shape
    D = HD // num_heads

    def split(x):
        return x.reshape(B, N, num_heads, D).transpose(1, 2)

    y = einsum_attention(split(q), split(k), split(v), scale)
    return y.transpose(1, 2).reshape(B, N, HD)


def attn_heads_natural(q_all, k_all, v_all, num_heads: int, scale: float):
    """Per-head attention on natural (B, N, H*D) tensors. Yields
    (head, lane_slice, out_f32) with out (B, N, D)."""
    dt = q_all.dtype
    D = q_all.shape[-1] // num_heads
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        q = q_all[..., sl] * torch.tensor(scale, dtype=dt)
        k = k_all[..., sl]
        v = v_all[..., sl]
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))  # f32
        # the max is detached as the JAX recipe stops its gradient: the
        # exact gradient through it is zero, but in bf16 amax's backward
        # would hand rounding residue to the tied maxima
        m = s.amax(dim=-1, keepdim=True).detach()
        e = torch.exp((s - m).to(dt))                 # exp at input width
        r = e.float().sum(dim=-1)                     # f32 row sum
        o = torch.matmul(e.float(), v.float())        # f32 PV
        yield h, sl, o / r[..., None]
