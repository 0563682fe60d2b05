"""Attention: the plain oracles (counterparts of t2ms_tpu/ops/attention.py
``einsum_attention`` / ``_einsum_natural`` and the ``attn_heads_natural``
recipe that every fused TPU kernel shares) and the port of the fused-heads
kernels (``fused_heads_attention``, ``fused_heads_attention_bwd``,
``fused_heads_attention_bwd_two_pass``, the lse family
``fused_heads_attention_with_stats``, ``fused_heads_attention_bwd_lean``
and ``fused_heads_attention_bwd_lean_two_pass``, and
``fused_heads_diffable``).

``attn_heads_natural`` keeps the kernels' order of precision steps:
q scaled at input width, f32 scores, row max subtracted then cast to input
width before exp, f32 row sum and f32 PV accumulation, normalization after
PV. The CUDA kernels in ``csrc/dit_stack.cu``, ``csrc/attn_heads.cuh`` and
``csrc/fused_heads.cu`` follow the same steps.

The fused-heads wrappers take q, k and v on the natural (B, N, H*D)
layout, as the column slices of one qkv projection: the kernels read each
operand through its own batch and row strides, so the slices are not
copied. On a CUDA tensor they launch ``csrc/fused_heads.cu`` (counted
under their JAX names) or raise; on a CPU tensor they run the plain twins.

The backward has two recipes with other rounding points: the pipelined
one (the JAX default where it walks head groups) and the recompute one (its
ungrouped single-pass kernels and its two-pass kernel). ``_FusedHeads``
picks the one JAX's ``_fused_heads_bwd`` runs on a TPU, from copies of the
three integer predicates it consults (``_bwd_block_q``,
``_bwd_head_groups``, ``_bwd_two_pass_blocks``): they decide the recipe and
the kernel here, not tiles. ``T2MS_ATTN_PIPE_BWD`` forces the recipe as it
does in JAX (``_pipe_bwd_enabled``). ``T2MS_ATTN_LEAN_BWD=1`` (off by
default, as in JAX: ``_lean_bwd_enabled``) turns on the lean route where
JAX's predicates admit it (``fused_heads_lean_route``): the forward saves
its output and the rows' log-sum-exp, and the backward rebuilds p from
them with no stats pass (the third recipe).

The head-split kernels take (B, H, N, D) operands, read through their own
batch, head and row strides (so the head-split views of one qkv projection
are not copied): ``flash_attention`` (online softmax, all f32 inside),
``vmem_attention`` and ``packed_attention`` (the exact softmax, p
normalised and cast to v's dtype before PV). On a CUDA tensor they launch
``csrc/split_heads.cu`` or raise; on a CPU tensor they run the plain twins
``flash_reference``, ``vmem_reference`` and ``packed_reference``.
``attention`` is JAX's dispatcher on that layout; its 'flash' and 'packed'
impls train through an einsum-recompute backward. ``attention_route``
copies the choice JAX's ``_Attention`` makes on a TPU from the predicates
``fused_heads_block_q`` and ``_auto_block``: again a route, never a tile.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from t2ms_tpu_torch.ops import _build

__all__ = ["einsum_attention", "einsum_natural", "attn_heads_natural",
           "fused_heads_reference", "fused_heads_bwd_reference",
           "fused_heads_bwd_two_pass_reference", "fused_heads_attention",
           "fused_heads_attention_bwd", "fused_heads_attention_bwd_two_pass",
           "fused_heads_stats_reference", "fused_heads_bwd_lean_reference",
           "fused_heads_attention_with_stats",
           "fused_heads_attention_bwd_lean",
           "fused_heads_attention_bwd_lean_two_pass",
           "fused_heads_diffable", "fused_heads_supported",
           "fused_heads_bwd_route", "fused_heads_lean_route",
           "FUSED_HEADS_KERNEL", "FUSED_HEADS_BWD_KERNEL",
           "FUSED_HEADS_TWO_PASS_KERNEL", "FUSED_HEADS_STATS_KERNEL",
           "FUSED_HEADS_LEAN_KERNEL", "FUSED_HEADS_LEAN_TWO_PASS_KERNEL",
           "fused_heads_block_q", "attention_route", "attention",
           "flash_attention", "vmem_attention", "packed_attention",
           "flash_reference", "vmem_reference", "packed_reference",
           "split_heads_supported", "split_heads_route", "FLASH_KERNEL",
           "VMEM_KERNEL", "PACKED_KERNEL", "SPLIT_HEAD_WIDTHS"]

FUSED_HEADS_KERNEL = "fused_heads_attention"
FUSED_HEADS_BWD_KERNEL = "fused_heads_attention_bwd"
FUSED_HEADS_TWO_PASS_KERNEL = "fused_heads_attention_bwd_two_pass"
FUSED_HEADS_STATS_KERNEL = "fused_heads_attention_with_stats"
FUSED_HEADS_LEAN_KERNEL = "fused_heads_attention_bwd_lean"
FUSED_HEADS_LEAN_TWO_PASS_KERNEL = "fused_heads_attention_bwd_lean_two_pass"
_FWD_ENTRY = {torch.bfloat16: "fused_heads_forward_bf16",
              torch.float32: "fused_heads_forward_f32"}
_STATS_ENTRY = {torch.bfloat16: "fused_heads_forward_stats_bf16",
                torch.float32: "fused_heads_forward_stats_f32"}
_BWD_ENTRY = {torch.bfloat16: "fused_heads_backward_bf16",
              torch.float32: "fused_heads_backward_f32"}
_LEAN_ENTRY = {torch.bfloat16: "fused_heads_backward_lean_bf16",
               torch.float32: "fused_heads_backward_lean_f32"}
_INT_MAX = 2 ** 31 - 1


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


def attn_heads_natural(q_all, k_all, v_all, num_heads: int, scale: float,
                       with_stats: bool = False):
    """Per-head attention on natural (B, N, H*D) tensors. Yields
    (head, lane_slice, out_f32) with out (B, N, D); with ``with_stats``
    also the rows' log-sum-exp lse = m + log(r) (B, N) in f32."""
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
        if with_stats:
            yield h, sl, o / r[..., None], m[..., 0] + torch.log(r)
        else:
            yield h, sl, o / r[..., None]


# -------------------------------------------------------- fused heads

def _scale(q, num_heads, scale):
    return (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale


def fused_heads_reference(q, k, v, num_heads: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``fused_heads_attention``: every head through
    ``attn_heads_natural``, cast to q's dtype and merged (B, N, H*D)."""
    dt = q.dtype
    parts = [None] * num_heads
    for h, _, o in attn_heads_natural(q, k, v, num_heads,
                                      _scale(q, num_heads, scale)):
        parts[h] = o.to(dt)
    return torch.cat(parts, dim=-1)


def fused_heads_bwd_reference(q, k, v, g, num_heads: int,
                              scale: Optional[float] = None):
    """Plain twin of ``fused_heads_attention_bwd`` with the pipelined
    recipe: that of the JAX kernel (``_bwd_pipelined_blocked_kernel``)
    per head, on whole rows: p = e / r is never formed; gs = T(g / r),
    dv = e^T gs, t = rowsum(dp * e) / r, ds_u = T(e * (dp - t)),
    dq = (ds_u k) * scale / r, dk = ds_u^T T(q * scale / r). Returns
    (dq, dk, dv) in q's dtype. The recompute recipe's twin is
    ``fused_heads_bwd_two_pass_reference``."""
    dt = q.dtype
    scale = _scale(q, num_heads, scale)
    D = q.shape[-1] // num_heads
    outs = ([], [], [])
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        qh, kh, vh = (a[..., sl].float() for a in (q, k, v))
        gh = g[..., sl].to(dt).float()
        s = torch.matmul((q[..., sl] * torch.tensor(scale, dtype=dt)).float(),
                         kh.transpose(-1, -2))
        dp = torch.matmul(gh, vh.transpose(-1, -2))
        m = s.amax(dim=-1, keepdim=True)
        ef = torch.exp((s - m).to(dt)).float()
        inv_r = 1.0 / ef.sum(dim=-1, keepdim=True)
        gs = (gh * inv_r).to(dt).float()
        dv = torch.matmul(ef.transpose(-1, -2), gs)
        t = (dp * ef).sum(dim=-1, keepdim=True) * inv_r
        ds_u = (ef * (dp - t)).to(dt).float()
        dq = torch.matmul(ds_u, kh) * (scale * inv_r)
        qs = (qh * (scale * inv_r)).to(dt).float()
        dk = torch.matmul(ds_u.transpose(-1, -2), qs)
        for acc, d in zip(outs, (dq, dk, dv)):
            acc.append(d.to(dt))
    return tuple(torch.cat(o, dim=-1) for o in outs)


def fused_heads_bwd_two_pass_reference(q, k, v, g, num_heads: int,
                                       scale: Optional[float] = None):
    """Plain twin of ``fused_heads_attention_bwd_two_pass`` and of
    ``fused_heads_attention_bwd`` with ``pipelined=False``: the recompute
    recipe of the JAX kernels (``_bwd_pass1_kernel``/``_bwd_pass2_kernel``,
    the same as the ungrouped single-pass ``_fused_heads_bwd_kernel``) per
    head, on whole rows: s = T(q * scale) k^T in f32, e = exp(T(s - m)),
    r = sum f32(e), p = f32(e) / r, delta = rowsum(dp * p),
    ds = T(p * (dp - delta)), dq = (ds k) * scale, dk = (ds^T q) * scale
    with q unscaled, dv = T(p)^T g. Returns (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    scale = _scale(q, num_heads, scale)
    D = q.shape[-1] // num_heads
    outs = ([], [], [])
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        qh, kh, vh = (a[..., sl].float() for a in (q, k, v))
        gh = g[..., sl].to(dt).float()
        s = torch.matmul((q[..., sl] * torch.tensor(scale, dtype=dt)).float(),
                         kh.transpose(-1, -2))
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp((s - m).to(dt)).float()
        p = e / e.sum(dim=-1, keepdim=True)
        dp = torch.matmul(gh, vh.transpose(-1, -2))
        delta = (dp * p).sum(dim=-1, keepdim=True)
        ds = (p * (dp - delta)).to(dt).float()
        dq = torch.matmul(ds, kh) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
        for acc, d in zip(outs, (dq, dk, dv)):
            acc.append(d.to(dt))
    return tuple(torch.cat(o, dim=-1) for o in outs)


def fused_heads_stats_reference(q, k, v, num_heads: int,
                                scale: Optional[float] = None):
    """Plain twin of ``fused_heads_attention_with_stats``: the output of
    ``fused_heads_reference`` and the rows' log-sum-exp lse = m + log(r)
    per head, (B, N, H) in f32."""
    dt = q.dtype
    parts, lses = [None] * num_heads, [None] * num_heads
    for h, _, o, lse in attn_heads_natural(q, k, v, num_heads,
                                           _scale(q, num_heads, scale),
                                           with_stats=True):
        parts[h], lses[h] = o.to(dt), lse
    return torch.cat(parts, dim=-1), torch.stack(lses, dim=-1)


def _lean_stats(g, o, lse, num_heads: int):
    """The lean backward's row terms (JAX's ``_lean_stats``,
    t2ms_tpu/ops/attention.py:971, without its [lse | delta] concatenation,
    a layout for TPU lanes): lse as contiguous f32 and delta_h =
    rowsum(f32(g_h) * f32(o_h)), each (B, N, H)."""
    B, N, HD = g.shape
    D = HD // num_heads
    delta = (g.float() * o.float()).reshape(B, N, num_heads, D).sum(dim=-1)
    return lse.float().contiguous(), delta.contiguous()


def fused_heads_bwd_lean_reference(q, k, v, g, o, lse, num_heads: int,
                                   scale: Optional[float] = None):
    """Plain twin of ``fused_heads_attention_bwd_lean`` and
    ``fused_heads_attention_bwd_lean_two_pass``: the lean recipe of the JAX
    kernels (``_bwd_lean_kernel``, ``_bwd_lean_p1_kernel``/
    ``_bwd_lean_p2_kernel``) per head, on whole rows, from the forward's
    output o and log-sum-exp lse: s = T(q * scale) k^T in f32,
    p = T(exp(T(s - lse))), delta = rowsum(f32(g) f32(o)), dv = p^T g,
    dp = g v^T, ds = T(p * (dp - delta)), dq = (ds k) * scale,
    dk = (ds^T q) * scale with q unscaled. Returns (dq, dk, dv) in q's
    dtype."""
    dt = q.dtype
    scale = _scale(q, num_heads, scale)
    D = q.shape[-1] // num_heads
    lse, delta = _lean_stats(g, o, lse, num_heads)
    outs = ([], [], [])
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        qh, kh, vh = (a[..., sl].float() for a in (q, k, v))
        gh = g[..., sl].to(dt).float()
        s = torch.matmul((q[..., sl] * torch.tensor(scale, dtype=dt)).float(),
                         kh.transpose(-1, -2))
        p = torch.exp((s - lse[..., h, None]).to(dt)).float()
        dv = torch.matmul(p.transpose(-1, -2), gh)
        dp = torch.matmul(gh, vh.transpose(-1, -2))
        ds = (p * (dp - delta[..., h, None])).to(dt).float()
        dq = torch.matmul(ds, kh) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
        for acc, d in zip(outs, (dq, dk, dv)):
            acc.append(d.to(dt))
    return tuple(torch.cat(o_, dim=-1) for o_ in outs)


# The integer predicates of JAX's _fused_heads_bwd (t2ms_tpu/ops/attention.py
# :785, :1202, :1251), copied as they are: on a TPU they size VMEM tiles; in
# the port they only say which branch, and so which recipe and which kernel,
# the JAX default takes at a geometry (``fused_heads_bwd_route``).

def _bwd_two_pass_blocks(n: int, hd: int, bpe: int = 2):
    if n % 8 != 0 or n < 256:
        return None
    budget = 11 * 2 ** 20
    per_elem = 14 + 2 * bpe
    full_row = 2 * 2 * n * hd * bpe
    stats = 2 * n * 128 * 4
    p1 = None
    for bq in (256, 128, 64, 32):
        if n % bq == 0 and full_row + per_elem * bq * n < budget:
            p1 = bq
            break
    if p1 is None:
        return None
    for bk in (512, 256, 128):
        cq = 512 if n % 512 == 0 else 256
        if n % bk == 0 and n % cq == 0 \
                and full_row + stats + per_elem * cq * bk < budget:
            return (p1, bk, cq)
    return None


def _bwd_head_groups(n: int, hd: int, num_heads: int, bpe: int = 2):
    if n % 8 != 0 or n < 128:
        return None
    d = hd // num_heads
    proven = {(1024, 512, 8): (2, 512)}
    got = proven.get((n, hd, num_heads))
    if got:
        return got
    budget = 11 * 2 ** 20
    for g in (2, 4, 8, 16):
        ghd = hd // g
        if num_heads % g or ghd % 128 or ghd < d:
            continue
        refs = 14 * n * ghd * bpe
        if refs >= budget:
            continue
        for bq in (512, 384, 256, 128, 64, 32):
            if n % bq == 0 and bq * n * 16 + refs < budget:
                return (g, bq)
    return None


def _bwd_block_q(n: int, hd: int, bpe: int = 2) -> int:
    if n % 8 != 0 or n < 128:
        return 0
    budget = 11 * 2 ** 20
    refs = 14 * n * hd * bpe
    if n * n * 18 + refs < budget:
        return n
    for bq in (512, 384, 256, 128):
        if n % bq == 0 and bq * n * 16 + refs < budget:
            return bq
    return 0


# JAX's default for the pipelined backward (t2ms_tpu/ops/attention.py:1362)
_PIPE_BWD_DEFAULT_ON = True


def _pipe_bwd_enabled(grouped: bool = True) -> bool:
    """JAX's gate of the pipelined recipe (``_pipe_bwd_enabled``,
    t2ms_tpu/ops/attention.py:1365): T2MS_ATTN_PIPE_BWD=0 gives the
    recompute recipe everywhere, =1 the pipelined one everywhere; unset,
    the pipelined recipe for the head-grouped branch only. The two recipes
    round at other points, so the switch changes results."""
    flag = os.environ.get("T2MS_ATTN_PIPE_BWD", "")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return grouped and _PIPE_BWD_DEFAULT_ON


def fused_heads_bwd_route(n: int, hd: int, num_heads: int,
                          bpe: int = 2) -> str:
    """The branch JAX's ``_fused_heads_bwd`` takes on a TPU for N = ``n``
    rows of H*D = ``hd`` in ``num_heads`` heads of ``bpe``-byte values:
    "single" (the ungrouped single pass: #11 with the recompute recipe),
    "grouped" (head groups: #11 pipelined), "two_pass" (#12), or "eager"
    (its eager einsum VJP, where no Pallas backward fits; the port has no
    eager fallback on CUDA and runs #12 there)."""
    if _bwd_block_q(n, hd, bpe):
        return "single"
    if _bwd_head_groups(n, hd, num_heads, bpe):
        return "grouped"
    if _bwd_two_pass_blocks(n, hd, bpe):
        return "two_pass"
    return "eager"


# The lean route's predicates (t2ms_tpu/ops/attention.py:928, :1124), copied
# as they are, proven table included: on a TPU they size the lean kernels'
# VMEM tiles; in the port they only say whether the forward saves lse and
# which lean kernel the backward runs (``fused_heads_lean_route``).

def _bwd_lean_groups(n: int, hd: int, num_heads: int, bpe: int = 2):
    if n % 8 != 0 or n < 128:
        return None
    d = hd // num_heads
    proven = {(1024, 512, 8): (4, 512)}
    got = proven.get((n, hd, num_heads))
    if got:
        return got
    budget = 11 * 2 ** 20
    stats = 2 * n * 128 * 4
    for g in (1, 2, 4, 8, 16):
        if num_heads % g:
            continue
        ghd = hd // g
        if ghd % 128 or ghd < d:
            continue
        refs = 14 * n * ghd * bpe
        if refs + stats >= budget:
            continue
        cands = ([n] if n <= 1024 else []) + [512, 384, 256, 128, 64, 32]
        for bq in cands:
            if n % bq == 0 and refs + stats + bq * n * 16 < budget:
                return (g, bq)
    return None


def _bwd_lean_two_pass_blocks(n: int, hd: int, bpe: int = 2):
    if n % 8 != 0 or n < 256:
        return None
    budget = 11 * 2 ** 20
    per_elem = 12 + 2 * bpe
    full_row = 2 * 2 * n * hd * bpe
    stats = 2 * n * 128 * 4
    p1 = None
    for bq in (256, 128, 64, 32):
        if n % bq == 0 and full_row + 2 * bq * 128 * 4 \
                + per_elem * bq * n < budget:
            p1 = bq
            break
    if p1 is None:
        return None
    for bk in (512, 256, 128):
        cq = 512 if n % 512 == 0 else 256
        if n % bk == 0 and n % cq == 0 \
                and full_row + stats + per_elem * cq * bk < budget:
            return (p1, bk, cq)
    return None


# JAX's default for the lean backward (t2ms_tpu/ops/attention.py:1348)
_LEAN_BWD_DEFAULT_ON = False


def _lean_bwd_enabled() -> bool:
    """JAX's gate of the lean backward (``_lean_bwd_enabled``,
    t2ms_tpu/ops/attention.py:1378): T2MS_ATTN_LEAN_BWD=0 turns it off, =1
    on; any other value, or none, leaves the default (off)."""
    flag = os.environ.get("T2MS_ATTN_LEAN_BWD", "")
    if flag == "0":
        return False
    return flag == "1" or _LEAN_BWD_DEFAULT_ON


def fused_heads_lean_route(n: int, hd: int, num_heads: int,
                           bpe: int = 2) -> Optional[str]:
    """The lean kernel JAX's custom VJP runs on a TPU, with the lean switch
    on, for N = ``n`` rows of H*D = ``hd`` in ``num_heads`` heads of
    ``bpe``-byte values: None where its forward does not save lse (the
    stats forward's envelope ``fused_heads_block_q`` is 0, or neither lean
    backward admits the geometry), else "lean" (#13) where
    ``_bwd_lean_groups`` admits it, else "lean_two_pass" (#14)."""
    if not fused_heads_block_q(n, hd, bpe):
        return None
    if _bwd_lean_groups(n, hd, num_heads, bpe):
        return "lean"
    if _bwd_lean_two_pass_blocks(n, hd, bpe):
        return "lean_two_pass"
    return None


def fused_heads_supported(HD: int, num_heads: int,
                          dtype: torch.dtype) -> bool:
    """Whether the CUDA fused-heads kernels, forward and backward, take
    H*D = ``HD`` split into ``num_heads`` heads in ``dtype``
    (``fused_heads_check`` in fused_heads.cu). The JAX VMEM envelope
    ``fused_heads_block_q`` is not ported; the backward's predicates pick
    a recipe only (``fused_heads_bwd_route``)."""
    if dtype not in _FWD_ENTRY:
        return False
    return _build.supported("fused_heads", "fused_heads_check", HD,
                            num_heads, int(dtype == torch.bfloat16))


def _check_heads(name, *ts):
    shape, dt, dev = ts[0].shape, ts[0].dtype, ts[0].device
    if len(shape) != 3 or any(
            t.shape != shape or t.dtype != dt or t.device != dev
            for t in ts):
        raise ValueError(
            f"{name}: q, k, v (and g) must share one (B, N, H*D) shape, "
            f"dtype and device, got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in ts]}")


def _strided(t):
    """t itself when the kernels can read it through its batch and row
    strides (unit column stride, 16-byte aligned rows), else a contiguous
    copy."""
    e = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s * e % 16 for s in t.stride()[:2])):
        t = t.contiguous()
    return t


def _heads_operands(name, entries, ts, num_heads):
    B, N, HD = ts[0].shape
    refused = ValueError(f"{name} CUDA kernel does not take B={B} N={N} "
                         f"H*D={HD} heads={num_heads} dtype={ts[0].dtype}")
    if ts[0].dtype not in entries:
        raise refused
    ts = [_strided(t) for t in ts]
    strides = [s for t in ts for s in t.stride()[:2]]
    if max(strides) > _INT_MAX:
        raise refused
    return refused, _build.load("fused_heads"), ts, strides


def _launch_fused_heads(q, k, v, num_heads, scale):
    refused, lib, ts, strides = _heads_operands(
        FUSED_HEADS_KERNEL, _FWD_ENTRY, (q, k, v), num_heads)
    dt = q.dtype
    o = torch.empty(q.shape, device=q.device, dtype=dt)
    _build.launch(lib, _FWD_ENTRY[dt], FUSED_HEADS_KERNEL, refused,
                  q.device, *ts, o, *q.shape, num_heads, *strides,
                  float(torch.tensor(scale, dtype=dt)))
    return o


def _launch_fused_heads_stats(q, k, v, num_heads, scale):
    refused, lib, ts, strides = _heads_operands(
        FUSED_HEADS_STATS_KERNEL, _STATS_ENTRY, (q, k, v), num_heads)
    dt = q.dtype
    B, N, _ = q.shape
    o = torch.empty(q.shape, device=q.device, dtype=dt)
    lse = torch.empty((B, N, num_heads), device=q.device,
                      dtype=torch.float32)
    _build.launch(lib, _STATS_ENTRY[dt], FUSED_HEADS_STATS_KERNEL, refused,
                  q.device, *ts, o, lse, *q.shape, num_heads, *strides,
                  float(torch.tensor(scale, dtype=dt)))
    return o, lse


def _launch_fused_heads_bwd_lean(q, k, v, g, o, lse, num_heads, scale, name):
    """The lean recipe's two launches (dq, then dk/dv; no stats launch),
    counted once under ``name``; delta is computed here in plain torch."""
    refused, lib, ts, strides = _heads_operands(
        name, _LEAN_ENTRY, (q, k, v, g.to(q.dtype)), num_heads)
    lse, delta = _lean_stats(g, o, lse, num_heads)
    dt = q.dtype
    dq, dk, dv = (torch.empty(q.shape, device=q.device, dtype=dt)
                  for _ in range(3))
    _build.launch(lib, _LEAN_ENTRY[dt], name, refused, q.device, *ts, lse,
                  delta, dq, dk, dv, *q.shape, num_heads, *strides,
                  float(scale), float(torch.tensor(scale, dtype=dt)))
    return dq, dk, dv


def _launch_fused_heads_bwd(q, k, v, g, num_heads, scale, pipelined=True,
                            name=FUSED_HEADS_BWD_KERNEL):
    """The backward's two launches (the q-tile kernel with the rows'
    statistics and dq, then the k-tile kernel with dk and dv; f32: a stats,
    a dq and a dk/dv kernel) with the pipelined or the recompute recipe,
    counted once under ``name``. The workspace holds the statistics and,
    pipelined, T(q * scale / r) and T(g / r)."""
    refused, lib, ts, strides = _heads_operands(
        name, _BWD_ENTRY, (q, k, v, g.to(q.dtype)), num_heads)
    dt = q.dtype
    B, N, HD = q.shape
    dq, dk, dv = (torch.empty(q.shape, device=q.device, dtype=dt)
                  for _ in range(3))
    work = torch.empty(lib.fused_heads_backward_workspace(
        B, N, HD, num_heads, int(pipelined)), device=q.device,
        dtype=torch.uint8)
    _build.launch(lib, _BWD_ENTRY[dt], name, refused, q.device, *ts, dq, dk,
                  dv, work, B, N, HD, num_heads, *strides, int(pipelined),
                  float(scale), float(torch.tensor(scale, dtype=dt)))
    return dq, dk, dv


def fused_heads_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: Optional[float] = None,
                          block_q: Optional[int] = None) -> torch.Tensor:
    """Exact softmax attention on the natural (B, N, H*D) layout, head h
    the columns [h*D, (h+1)*D): f32 scores, exp at input width,
    normalisation after PV; returns the merged (B, N, H*D) output in q's
    dtype. CUDA tensor -> ``csrc/fused_heads.cu``; CPU tensor -> the twin.
    ``block_q`` is the JAX signature's q row-block: the kernel picks its
    own tiles, so it is ignored. Forward only: on CUDA it raises under
    grad mode when an input requires grad (train through
    ``fused_heads_diffable``)."""
    del block_q
    _check_heads(FUSED_HEADS_KERNEL, q, k, v)
    scale = _scale(q, num_heads, scale)
    if q.is_cuda:
        _build.refuse_autograd(FUSED_HEADS_KERNEL, (q, k, v),
                               "fused_heads_diffable")
        return _launch_fused_heads(q, k, v, num_heads, scale)
    if q.device.type != "cpu":
        raise ValueError(f"{FUSED_HEADS_KERNEL}: unsupported device "
                         f"{q.device}")
    return fused_heads_reference(q, k, v, num_heads, scale)


def _check_bwd(name, q, k, v, g):
    _check_heads(name, q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"{name}: g must be {tuple(q.shape)}, got "
                         f"{tuple(g.shape)}")
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {q.device}")


def fused_heads_attention_bwd(q, k, v, g, num_heads: int,
                              scale: Optional[float] = None,
                              block_q: Optional[int] = None,
                              head_groups: int = 1,
                              pipelined: Optional[bool] = None):
    """VJP of ``fused_heads_attention``: (dq, dk, dv) in q's dtype for the
    upstream gradient g, all (B, N, H*D), recomputing the probabilities
    from q and k. ``pipelined`` picks the recipe as in JAX: None reads
    ``_pipe_bwd_enabled`` (``T2MS_ATTN_PIPE_BWD``; unset means pipelined
    where ``head_groups`` > 1, the JAX default, else the recompute
    recipe). CUDA tensor -> ``csrc/fused_heads.cu`` (bf16: a q-tile
    kernel with the rows' statistics and dq, then a k-tile kernel with dk
    and dv; no atomics, so runs repeat bit for bit); CPU tensor -> the
    twin. ``block_q`` and ``head_groups`` shape the TPU
    kernel's VMEM tiles and are otherwise ignored."""
    del block_q
    _check_bwd(FUSED_HEADS_BWD_KERNEL, q, k, v, g)
    HD = q.shape[-1]
    if head_groups > 1 and (HD % head_groups or num_heads % head_groups
                            or (HD // head_groups) % (HD // num_heads)):
        raise ValueError(f"head_groups {head_groups} incompatible with "
                         f"HD={HD}, num_heads={num_heads}")
    if pipelined is None:
        pipelined = _pipe_bwd_enabled(grouped=head_groups > 1)
    scale = _scale(q, num_heads, scale)
    if q.is_cuda:
        return _launch_fused_heads_bwd(q, k, v, g, num_heads, scale,
                                       pipelined)
    twin = (fused_heads_bwd_reference if pipelined
            else fused_heads_bwd_two_pass_reference)
    return twin(q, k, v, g, num_heads, scale)


def fused_heads_attention_bwd_two_pass(q, k, v, g, num_heads: int,
                                       scale: Optional[float] = None,
                                       blocks=None):
    """The long-series VJP of ``fused_heads_attention`` (JAX's two-pass
    kernel): (dq, dk, dv) in q's dtype with the recompute recipe. CUDA
    tensor -> ``csrc/fused_heads.cu`` (the q-tile and k-tile kernels with
    the recompute recipe); CPU tensor -> the twin. ``blocks`` is
    the JAX signature's (block_q, block_k, chunk_q) of VMEM tiles: the
    kernels pick their own, so it is ignored."""
    del blocks
    _check_bwd(FUSED_HEADS_TWO_PASS_KERNEL, q, k, v, g)
    scale = _scale(q, num_heads, scale)
    if q.is_cuda:
        return _launch_fused_heads_bwd(q, k, v, g, num_heads, scale, False,
                                       FUSED_HEADS_TWO_PASS_KERNEL)
    return fused_heads_bwd_two_pass_reference(q, k, v, g, num_heads, scale)


def fused_heads_attention_with_stats(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, num_heads: int,
                                     scale: Optional[float] = None,
                                     block_q: Optional[int] = None):
    """``fused_heads_attention`` that also returns each row's log-sum-exp
    per head, (B, N, H) in f32: the residual of the lean backward. The
    output is the same, bit for bit. CUDA tensor -> ``csrc/fused_heads.cu``
    (the forward kernel with its lse output); CPU tensor -> the twin
    ``fused_heads_stats_reference``. ``block_q`` must divide N, as in JAX,
    and is otherwise ignored (the kernel picks its own tiles). Forward
    only: on CUDA it raises under grad mode when an input requires grad."""
    _check_heads(FUSED_HEADS_STATS_KERNEL, q, k, v)
    N = q.shape[1]
    if block_q is not None and N % block_q:
        raise ValueError(f"block_q {block_q} must divide N {N}")
    scale = _scale(q, num_heads, scale)
    if q.is_cuda:
        _build.refuse_autograd(FUSED_HEADS_STATS_KERNEL, (q, k, v),
                               "fused_heads_diffable")
        return _launch_fused_heads_stats(q, k, v, num_heads, scale)
    if q.device.type != "cpu":
        raise ValueError(f"{FUSED_HEADS_STATS_KERNEL}: unsupported device "
                         f"{q.device}")
    return fused_heads_stats_reference(q, k, v, num_heads, scale)


def _check_lean(name, q, k, v, g, o, lse, num_heads):
    _check_bwd(name, q, k, v, g)
    B, N, _ = q.shape
    if o.shape != q.shape or tuple(lse.shape) != (B, N, num_heads) \
            or o.device != q.device or lse.device != q.device:
        raise ValueError(
            f"{name}: o must be {tuple(q.shape)} and lse "
            f"{(B, N, num_heads)} on {q.device}, got o "
            f"{tuple(o.shape)} on {o.device}, lse {tuple(lse.shape)} on "
            f"{lse.device}")


def fused_heads_attention_bwd_lean(q, k, v, g, o, lse, num_heads: int,
                                   scale: Optional[float] = None,
                                   groups: Optional[int] = None,
                                   block_q: Optional[int] = None):
    """The lean VJP of ``fused_heads_attention`` (JAX's single-pass lean
    kernel): (dq, dk, dv) in q's dtype from the forward's output ``o`` and
    log-sum-exp ``lse`` (``fused_heads_attention_with_stats``), with no
    pass to recompute the softmax statistics. CUDA tensor ->
    ``csrc/fused_heads.cu`` (the dq and dk/dv kernels with the lean recipe;
    delta in plain torch); CPU tensor -> the twin
    ``fused_heads_bwd_lean_reference``. ``groups`` and ``block_q`` are the
    JAX signature's head groups and q block of VMEM tiles: refused where
    JAX refuses them (one without the other, groups not dividing the
    heads or H*D, a block not dividing N), otherwise ignored."""
    _check_lean(FUSED_HEADS_LEAN_KERNEL, q, k, v, g, o, lse, num_heads)
    B, N, HD = q.shape
    if (groups is None) != (block_q is None):
        raise ValueError("pass both groups and block_q, or neither")
    if groups is not None:
        if num_heads % groups or HD % groups:
            raise ValueError(f"groups {groups} incompatible with HD={HD}, "
                             f"num_heads={num_heads}")
        if N % block_q:
            raise ValueError(f"block_q {block_q} must divide N={N}")
    scale = _scale(q, num_heads, scale)
    if q.is_cuda:
        return _launch_fused_heads_bwd_lean(q, k, v, g, o, lse, num_heads,
                                            scale, FUSED_HEADS_LEAN_KERNEL)
    return fused_heads_bwd_lean_reference(q, k, v, g, o, lse, num_heads,
                                          scale)


def fused_heads_attention_bwd_lean_two_pass(q, k, v, g, o, lse,
                                            num_heads: int,
                                            scale: Optional[float] = None,
                                            blocks=None):
    """The long-series lean VJP (JAX's lean two-pass kernels): the same
    function as ``fused_heads_attention_bwd_lean``, (dq, dk, dv) in q's
    dtype. CUDA tensor -> ``csrc/fused_heads.cu`` (the same two lean
    launches, counted under this name); CPU tensor -> the twin. ``blocks``
    is the JAX signature's (block_q, block_k, chunk_q) of VMEM tiles:
    refused where one does not divide N, as in JAX, otherwise ignored."""
    _check_lean(FUSED_HEADS_LEAN_TWO_PASS_KERNEL, q, k, v, g, o, lse,
                num_heads)
    N = q.shape[1]
    if blocks is not None and any(N % b for b in blocks):
        raise ValueError(f"blocks {tuple(blocks)} must divide N={N}")
    scale = _scale(q, num_heads, scale)
    if q.is_cuda:
        return _launch_fused_heads_bwd_lean(
            q, k, v, g, o, lse, num_heads, scale,
            FUSED_HEADS_LEAN_TWO_PASS_KERNEL)
    return fused_heads_bwd_lean_reference(q, k, v, g, o, lse, num_heads,
                                          scale)


class _FusedHeads(torch.autograd.Function):
    """JAX's custom VJP of ``fused_heads_diffable`` with its lean gate
    (``_fused_heads_fwd``/``_fused_heads_bwd``, t2ms_tpu/ops/attention.py
    :1397-1451), "on a TPU" read as "on any tensor". With
    ``T2MS_ATTN_LEAN_BWD=1`` (read at each forward) and a geometry that
    ``fused_heads_lean_route`` admits, the forward is
    ``fused_heads_attention_with_stats`` and saves q, k, v, o and lse; the
    backward, decided by what the forward saved, is
    ``fused_heads_attention_bwd_lean`` (#13) where ``_bwd_lean_groups``
    admits the geometry, else ``fused_heads_attention_bwd_lean_two_pass``
    (#14). Otherwise the forward is ``fused_heads_attention`` and saves q,
    k and v, and the backward is what ``fused_heads_bwd_route`` names:
    ``fused_heads_attention_bwd`` with the recompute recipe (ungrouped
    single pass) or the pipelined one (head groups), else
    ``fused_heads_attention_bwd_two_pass``."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.num_heads = num_heads
        _, N, HD = q.shape
        ctx.lean = (fused_heads_lean_route(N, HD, num_heads,
                                           q.element_size())
                    if _lean_bwd_enabled() else None)
        if ctx.lean:
            o, lse = fused_heads_attention_with_stats(q, k, v, num_heads)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        ctx.save_for_backward(q, k, v)
        return fused_heads_attention(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        H = ctx.num_heads
        if ctx.lean:
            q, k, v, o, lse = ctx.saved_tensors
            bwd = (fused_heads_attention_bwd_lean if ctx.lean == "lean"
                   else fused_heads_attention_bwd_lean_two_pass)
            return (*bwd(q, k, v, g, o, lse, H), None)
        q, k, v = ctx.saved_tensors
        _, N, HD = q.shape
        route = fused_heads_bwd_route(N, HD, H, q.element_size())
        if route == "single":
            grads = fused_heads_attention_bwd(q, k, v, g, H)
        elif route == "grouped":
            groups, bq = _bwd_head_groups(N, HD, H, q.element_size())
            grads = fused_heads_attention_bwd(q, k, v, g, H, block_q=bq,
                                              head_groups=groups)
        else:
            grads = fused_heads_attention_bwd_two_pass(q, k, v, g, H)
        return (*grads, None)


def fused_heads_diffable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """``fused_heads_attention`` with its hand-written backward, routed as
    JAX's custom VJP with its lean gate (``_FusedHeads``): grads in q's
    dtype for q, k and v (pass the qkv projection's column slices; the
    kernels read them in place)."""
    return _FusedHeads.apply(q, k, v, num_heads)


# ------------------------------------------------- the head-split kernels

FLASH_KERNEL = "flash_attention"
VMEM_KERNEL = "vmem_attention"
PACKED_KERNEL = "packed_attention"
SPLIT_HEAD_WIDTHS = (16, 32, 64, 128)     # split_heads_check in split_heads.cu
_SPLIT_ENTRY = {torch.bfloat16: "split_heads_forward_bf16",
                torch.float32: "split_heads_forward_f32"}
# Shared memory (bytes) a resident block may take so that two share an
# H100 SM: 228 KB an SM, 1 KB of it reserved for each block.
SPLIT_RESIDENT_SMEM = (228 * 1024) // 2 - 1024


def _auto_block(n: int, cap: int = 256) -> int:
    """Largest divisor of n that is <= cap and a multiple of 8 (JAX's
    ``_auto_block``, t2ms_tpu/ops/attention.py:81, copied as it is): the
    TPU kernel's block; here it only says whether ``flash_attention``
    reaches its kernel and whether ``attention`` picks it."""
    best = 0
    for b in range(8, cap + 1, 8):
        if n % b == 0:
            best = b
    return best


def fused_heads_block_q(n: int, hd: int, bpe: int = 2,
                        budget: int = 10 * 2 ** 20) -> int:
    """JAX's VMEM envelope of the fused-heads forward
    (t2ms_tpu/ops/attention.py:352, copied as it is): 0 where its
    ``_Attention`` does not take fused heads on a TPU. A route predicate
    here (``attention_route``), never a tile."""
    if n % 8 != 0 or n < 128:
        return 0

    def fits(bq):
        return (bq * n * 4 + bq * n * bpe + 2 * n * hd * bpe
                + 3 * bq * hd * bpe) < budget

    if n <= 1024 and fits(n):
        return n
    for bq in (1024, 512, 384, 256, 128):
        if n % bq == 0 and fits(bq):
            return bq
    return 0


def attention_route(n: int, hd: int, bpe: int = 2,
                    flash_threshold: int = 1024) -> str:
    """The attention JAX's ``_Attention`` runs on a TPU for N = ``n``
    tokens of H*D = ``hd`` in ``bpe``-byte values with
    ``attention_impl='auto'`` (t2ms_tpu/models/denoisers/dit.py:88-109):
    "fused" (``fused_heads_diffable``) where ``fused_heads_block_q`` is
    non-zero, else what ``attention`` picks on a TPU: "flash" for N >=
    ``flash_threshold`` with a non-zero ``_auto_block(n)``, else
    "einsum"."""
    if fused_heads_block_q(n, hd, bpe):
        return "fused"
    if n >= flash_threshold and _auto_block(n):
        return "flash"
    return "einsum"


def _split_scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def flash_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``flash_attention`` (JAX ``_flash_kernel``): q cast to
    f32 and scaled, f32 scores, the exp, the row max and the row sum in
    f32, PV in f32 from f32 v, normalised once at the end and cast to q's
    dtype. Whole rows at once: the kernel's online rescaling over key
    blocks is the same function up to f32 rounding."""
    s = torch.matmul(q.float() * _split_scale(q, scale),
                     k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype)


def vmem_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``vmem_attention`` (JAX ``_vmem_attn_kernel``): q cast
    to f32 and scaled, f32 scores, the row max subtracted, the exp and the
    row sum in f32, p normalised, then cast to v's dtype before PV, PV
    accumulated in f32 and cast to q's dtype."""
    s = torch.matmul(q.float() * _split_scale(q, scale),
                     k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def packed_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain twin of ``packed_attention`` (JAX ``_packed_kernel``): the same
    precision steps as ``vmem_reference``; the TPU kernel only packs
    several (b, h) rows into one program."""
    return vmem_reference(q, k, v, scale)


def _packed_pack(bh: int, n: int, d: int, bpe: int, pack: int) -> int:
    """JAX's ``pack`` halving and refusal (t2ms_tpu/ops/attention.py
    :208-217), copied as they are: raises where even pack = 1 would
    exceed the TPU program's VMEM budget, so the port refuses the same
    geometries. The returned pack is not used as a tile."""
    vmem = lambda p: p * (n * n * (8 + bpe) + n * d * (8 + 8 * bpe))
    while pack > 1 and (bh % pack or vmem(pack) >= 11 * 2 ** 20):
        pack //= 2
    if vmem(pack) >= 11 * 2 ** 20:
        raise ValueError(
            f"packed attention exceeds VMEM at N={n}, D={d} even at "
            f"pack=1; use flash or einsum for this geometry")
    return pack


def split_heads_supported(head_width: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA head-split kernels (``flash_attention``,
    ``vmem_attention``, ``packed_attention``) take this head width in
    ``dtype`` (``split_heads_check`` in split_heads.cu: head widths 16,
    32, 64 and 128, bf16 or f32; needs nvcc and a card)."""
    if dtype not in _SPLIT_ENTRY:
        return False
    return _build.supported("split_heads", "split_heads_check", head_width,
                            int(dtype == torch.bfloat16))


def split_heads_route(n: int, d: int, dtype: torch.dtype,
                      exact: bool) -> str:
    """The route of ``csrc/split_heads.cu`` for N = ``n`` tokens at head
    width ``d``: "resident" where the exact softmax (#16, #17) runs in bf16
    and the head's whole K and V (N rounded up to the 64-key tile, rows
    padded by 16 bytes: 2 * N * (d + 8) bf16 values) fit
    ``SPLIT_RESIDENT_SMEM``, so each block loads them once; else "stream",
    the cp.async ring over 64-key tiles (always for the online softmax,
    #15, and for f32)."""
    rows = -(-n // 64) * 64
    if exact and dtype == torch.bfloat16 and (
            2 * rows * (d + 8) * 2 <= SPLIT_RESIDENT_SMEM):
        return "resident"
    return "stream"


def _check_split(name, q, k, v):
    if q.dim() != 4 or any(t.shape != q.shape or t.dtype != q.dtype
                           or t.device != q.device for t in (k, v)):
        raise ValueError(
            f"{name}: q, k, v must share one (B, H, N, D) shape, dtype and "
            f"device, got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in (q, k, v)]}")
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {q.device}")


def _strided4(t):
    """t itself when the kernels can read it through its batch, head and
    row strides (unit column stride, 16-byte aligned rows), else a
    contiguous copy."""
    e = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s * e % 16 for s in t.stride()[:3])):
        t = t.contiguous()
    return t


def _launch_split_heads(name, exact, q, k, v, scale):
    """One launch of ``csrc/split_heads.cu``, counted under ``name``: the
    online-softmax kernel (#15) or, with ``exact``, the exact-softmax one
    (#16, #17), on the route ``split_heads_route`` picks. The output is a
    (B, H, N, D) view of a (B, N, H, D) tensor, so merging the heads back
    into (B, N, H*D) copies nothing."""
    B, H, N, D = q.shape
    refused = ValueError(
        f"{name} CUDA kernel does not take B={B} H={H} N={N} head width "
        f"{D} dtype={q.dtype}: it takes head widths "
        f"{', '.join(map(str, SPLIT_HEAD_WIDTHS))} in bf16 or f32")
    if q.dtype not in _SPLIT_ENTRY:
        raise refused
    _build.refuse_autograd(name, (q, k, v), "attention(..., impl)")
    q, k, v = (_strided4(t) for t in (q, k, v))
    o = torch.empty((B, N, H, D), device=q.device,
                    dtype=q.dtype).permute(0, 2, 1, 3)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    resident = split_heads_route(N, D, q.dtype, exact) == "resident"
    _build.launch(_build.load("split_heads"), _SPLIT_ENTRY[q.dtype], name,
                  refused, q.device, q, k, v, o, B, H, N, D, *strides,
                  int(exact), int(resident), float(scale))
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention on the head-split (B, H, N, D) layout, all
    f32 inside, the output in q's dtype (JAX ``flash_attention``). Where
    no block of JAX's (``block_q``, ``block_k``, by default
    ``_auto_block(N)``) divides N, JAX computes ``einsum_attention``
    instead, and so does this wrapper; elsewhere a CUDA tensor runs
    ``csrc/split_heads.cu`` (its own tiles; the blocks are not used as
    tiles) and a CPU tensor the twin ``flash_reference``. Forward only:
    train through ``attention(..., 'flash')``."""
    _check_split(FLASH_KERNEL, q, k, v)
    scale = _split_scale(q, scale)
    N = q.shape[2]
    if block_q is None:
        block_q = _auto_block(N)
    if block_k is None:
        block_k = _auto_block(N)
    if not block_q or not block_k or N % block_k or N % block_q:
        return einsum_attention(q, k, v, scale)
    if q.is_cuda:
        return _launch_split_heads(FLASH_KERNEL, False, q, k, v, scale)
    return flash_reference(q, k, v, scale)


def vmem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact-softmax attention on the head-split (B, H, N, D) layout
    (JAX ``vmem_attention``): f32 softmax, p cast to v's dtype before PV.
    CUDA tensor -> ``csrc/split_heads.cu`` (two passes over K, so any N;
    head widths 16, 32, 64, 128, else it raises); CPU tensor -> the twin
    ``vmem_reference``. No ``attention`` impl reaches it, as in JAX."""
    _check_split(VMEM_KERNEL, q, k, v)
    scale = _split_scale(q, scale)
    if q.is_cuda:
        return _launch_split_heads(VMEM_KERNEL, True, q, k, v, scale)
    return vmem_reference(q, k, v, scale)


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     pack: int = 4) -> torch.Tensor:
    """Exact-softmax attention on the head-split (B, H, N, D) layout
    (JAX ``packed_attention``): the same function as ``vmem_attention``.
    It raises where JAX raises (even pack = 1 would not fit the TPU
    program's VMEM); ``pack`` is kept for the signature and is not a tile.
    CUDA tensor -> ``csrc/split_heads.cu``; CPU tensor -> the twin
    ``packed_reference``. Forward only: train through
    ``attention(..., 'packed')``."""
    _check_split(PACKED_KERNEL, q, k, v)
    scale = _split_scale(q, scale)
    B, H, N, D = q.shape
    _packed_pack(B * H, N, D, q.element_size(), pack)
    if q.is_cuda:
        return _launch_split_heads(PACKED_KERNEL, True, q, k, v, scale)
    return packed_reference(q, k, v, scale)


class _EinsumVJP(torch.autograd.Function):
    """A head-split kernel's forward with JAX's einsum-recompute backward
    (``_flash_bwd``, t2ms_tpu/ops/attention.py:1483): autograd over
    ``einsum_attention`` on the saved q, k and v. The forward saves no
    (N, N) tensor; the backward builds them for one layer at a time."""

    @staticmethod
    def forward(ctx, q, k, v, kernel):
        ctx.save_for_backward(q, k, v)
        return kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        ts = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = einsum_attention(*ts)
        return (*torch.autograd.grad(o, ts, g.to(o.dtype)), None)


def _flash_diffable(q, k, v):
    """``flash_attention`` with the einsum-recompute backward."""
    return _EinsumVJP.apply(q, k, v, flash_attention)


def _packed_diffable(q, k, v):
    """``packed_attention`` with the einsum-recompute backward."""
    return _EinsumVJP.apply(q, k, v, packed_attention)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", flash_threshold: int = 1024
              ) -> torch.Tensor:
    """JAX's dispatcher on the head-split (B, H, N, D) layout
    (t2ms_tpu/ops/attention.py:1493): 'einsum', 'flash', 'packed', or
    'auto' (and any other value), which is 'flash' on a CUDA tensor with
    N >= ``flash_threshold`` and a non-zero ``_auto_block(N)`` (JAX: on a
    TPU), else 'einsum'. Differentiable in every mode."""
    if impl == "einsum":
        return einsum_attention(q, k, v)
    if impl == "flash":
        return _flash_diffable(q, k, v)
    if impl == "packed":
        return _packed_diffable(q, k, v)
    n = q.shape[2]
    if q.is_cuda and n >= flash_threshold and _auto_block(n):
        return _flash_diffable(q, k, v)
    return einsum_attention(q, k, v)
