"""DiT forwards through the fused kernels (counterpart of
t2ms_tpu/models/denoisers/dit_fast.py).

``fast_dit_forward`` (serving) mirrors ``DiT.forward``: the same ``embed``
and ``finalize`` halves, with the L adaLN-zero blocks run by
``ops.dit_block.fused_dit_stack`` (the hand-written CUDA kernel on a CUDA
tensor, its plain twin on a CPU tensor). The per-layer weights are stacked
and cast once per parameter version and cached on the module: eager torch
would otherwise restack them on every one of the sampler's steps. That
cache is built under ``no_grad``, so it serves inference only.

``split_dit_forward`` (serving, wide geometries such as the scaled DiT's
d_model 512) runs the same halves with one ``ops.dit_block.
fused_dit_block_split`` per layer, indexing layer l of the same cached
weights.

``fast_dit_train_forward`` (training) runs each block as
``ops.dit_block.fused_dit_block_diffable``, whose forward and backward are
the hand-written block kernels on CUDA; its weights are views of the
parameters, so the grads reach them.

``flax_path_forward`` (serving and training, geometries the block kernels
do not take, such as the scaled DiT's d_model 512 or the long-series DiTs'
4096 and 8192 tokens) is the counterpart of the TPU branch of the flax
``DiT.__call__`` with its default residual + LayerNorm fusion: block 0's
leading LayerNorm + modulate in ``ops.dit_block.mod_ln_diffable``, every
later block boundary (a gated residual and the next LayerNorm + modulate)
in ``ops.dit_block.res_mod_ln_diffable``, the attention as JAX's
``_Attention`` picks it on a TPU (``ops.attention.attention_route``):
``fused_heads_diffable`` on the qkv projection's column slices where
JAX's ``fused_heads_block_q`` admits the geometry, else ``attention`` on
the head-split views with 'flash' (#15, for N >= 1024 with a block that
divides N, such as 8192 tokens) or 'einsum'; and the Dense layers, GELU
and the last gated residual as the eager module computes them (XLA
computes them outside any Pallas kernel).

The stack, split and block routes take the JAX package's token range,
128 <= N <= 1024 with N % 8 == 0 for N patch tokens (its gates
``fast_forward_supported``, ``split_block_q`` and ``block_vjp_supported``
state it); inside it each kernel library answers for its own shapes.
"""

from __future__ import annotations

from typing import Optional

import torch

from t2ms_tpu_torch.models.denoisers.dit import DiT, dense, qkv_attention
from t2ms_tpu_torch.ops.attention import (SPLIT_HEAD_WIDTHS, _lean_bwd_enabled,
                                          attention_route,
                                          fused_heads_lean_route,
                                          fused_heads_supported,
                                          split_heads_supported)
from t2ms_tpu_torch.ops.dit_block import (block_kernel_supported,
                                          fused_dit_block_diffable,
                                          fused_dit_block_split,
                                          fused_dit_stack, mod_ln_diffable,
                                          mod_ln_supported,
                                          res_mod_ln_diffable,
                                          res_mod_ln_supported,
                                          split_kernel_supported,
                                          stack_kernel_supported)

__all__ = ["fast_dit_forward", "fast_forward_supported",
           "split_dit_forward", "split_forward_supported",
           "fast_dit_train_forward", "train_forward_supported",
           "flax_path_forward", "flax_path_supported",
           "flax_attention_route", "flax_path_kernels",
           "fused_path_eligible"]

_WEIGHTS = (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
            ("mlp", "fc2"))


def fused_path_eligible(denoiser, device) -> bool:
    """The opt-in gate of the fused forwards: the denoiser is a DiT, its
    attention_impl is 'auto' (any explicit impl is an opt-out, for oracle
    runs and A/B benches), and it runs on CUDA. Geometry is not checked
    here: each path's kernels answer for their own shapes, and no forward
    falls back to the eager module."""
    return (isinstance(denoiser, DiT)
            and getattr(denoiser, "attention_impl", "auto") == "auto"
            and torch.device(device).type == "cuda")


def _in_token_range(dit: DiT) -> bool:
    """128 <= N <= 1024 and N % 8 == 0 for the DiT's N patch tokens: the
    range of the JAX package's stack, split and block-VJP gates
    (t2ms_tpu/models/denoisers/dit_fast.py:56, t2ms_tpu/ops/dit_block.py
    :319, :437). The DiTs outside it take the flax path, as in JAX."""
    n = dit.num_patches
    return 128 <= n <= 1024 and n % 8 == 0


def fast_forward_supported(dit: DiT) -> bool:
    """Whether the CUDA stack kernel takes this DiT's geometry: the JAX
    token range, then the kernel library itself
    (``ops.dit_block.stack_kernel_supported``; needs nvcc and a card)."""
    if not _in_token_range(dit):
        return False
    return stack_kernel_supported(dit.d_model, int(dit.d_model
                                                   * dit.mlp_ratio),
                                  dit.num_heads, dit.compute_dtype)


def split_forward_supported(dit: DiT) -> bool:
    """Whether the CUDA split block kernel takes this DiT's geometry: the
    JAX token range, then the kernel library itself
    (``ops.dit_block.split_kernel_supported``; needs nvcc and a card). The
    JAX gate's VMEM envelope (``split_block_q``) is not ported: Hopper
    kernels pick their own tiles."""
    if not _in_token_range(dit):
        return False
    return split_kernel_supported(dit.d_model, int(dit.d_model
                                                   * dit.mlp_ratio),
                                  dit.num_heads, dit.compute_dtype)


def train_forward_supported(dit: DiT) -> bool:
    """Whether the CUDA block kernels (forward and backward) take this
    DiT's geometry: the JAX token range, then the backward's library
    (``ops.dit_block.block_kernel_supported``; needs nvcc and a card). An
    explicit ``attention_impl`` opts out, as in the JAX gate."""
    if (getattr(dit, "attention_impl", "auto") != "auto"
            or not _in_token_range(dit)):
        return False
    return block_kernel_supported(dit.d_model, int(dit.d_model
                                                   * dit.mlp_ratio),
                                  dit.num_heads, dit.compute_dtype)


def flax_attention_route(dit: DiT) -> str:
    """The flax path's attention for this DiT: "fused", "flash" or
    "einsum", as JAX's ``_Attention`` picks it on a TPU
    (``ops.attention.attention_route`` at the DiT's tokens, width and
    compute dtype)."""
    return attention_route(dit.num_patches, dit.d_model,
                           torch.finfo(dit.compute_dtype).bits // 8)


def flax_path_supported(dit: DiT) -> bool:
    """Whether the flax path's kernels take this DiT's geometry, asked of
    the LayerNorm library (``ops.dit_block.mod_ln_supported``,
    ``ops.dit_block.res_mod_ln_supported``) and of the attention library
    that the route picks (``ops.attention.fused_heads_supported`` or
    ``split_heads_supported``; none for einsum); needs nvcc and a card. An
    explicit ``attention_impl`` opts out, as in the JAX gates."""
    if getattr(dit, "attention_impl", "auto") != "auto":
        return False
    dt, route = dit.compute_dtype, flax_attention_route(dit)
    if not (mod_ln_supported(dit.d_model, dt)
            and res_mod_ln_supported(dit.d_model, dt)):
        return False
    if route == "fused":
        return fused_heads_supported(dit.d_model, dit.num_heads, dt)
    if route == "flash":
        return split_heads_supported(dit.d_model // dit.num_heads, dt)
    return True


def flax_path_kernels(dit: DiT, train: bool = False) -> str:
    """The kernels the flax path would run for this DiT, with their
    limits, for the routes' refusal messages; for training, the lean
    route's kernels (#10 with #13 or #14) where ``T2MS_ATTN_LEAN_BWD=1``
    and ``fused_heads_lean_route`` admits the geometry."""
    widths = ", ".join(map(str, SPLIT_HEAD_WIDTHS))
    lean = train and _lean_bwd_enabled() and fused_heads_lean_route(
        dit.num_patches, dit.d_model, dit.num_heads,
        torch.finfo(dit.compute_dtype).bits // 8)
    if lean:
        fused = ("#10 fused_heads_attention_with_stats with "
                 + ("#13 fused_heads_attention_bwd_lean" if lean == "lean"
                    else "#14 fused_heads_attention_bwd_lean_two_pass"))
    else:
        fused = "#9 fused_heads_attention" + (
            " with #11/#12 its single-pass and two-pass backwards"
            if train else "")
    attn = {
        "fused": fused + ", head widths 32, 64 or 128",
        "flash": ("#15 flash_attention" + (
            " with the einsum-recompute backward" if train else "")
            + f", head widths {widths}"),
        "einsum": "einsum attention (no kernel)"}[flax_attention_route(dit)]
    ln = ("#5/#6 _mod_ln_call, #7/#8 _res_mod_ln_call" if train
          else "#5 _mod_ln_call, #7 _res_mod_ln_call")
    return f"{ln} (d_model <= 1024), {attn}; bf16 or f32"


def _stacked_weights(dit: DiT, dtype: torch.dtype):
    """(wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2) stacked over the
    layers in flax layout (kernel (in, out)) and cast to ``dtype``; rebuilt
    only when a parameter changes (its version counter, storage or device)
    or the dtype does."""
    params = [getattr(getattr(blk, a), b) for blk in dit.layers
              for a, b in _WEIGHTS]
    key = (dtype,) + tuple((p.weight._version, p.bias._version,
                            p.weight.data_ptr(), p.bias.data_ptr(),
                            p.weight.device) for p in params)
    cache = dit.__dict__.get("_fused_stack_cache")
    if cache is not None and cache[0] == key:
        return cache[1]
    n = len(_WEIGHTS)
    out = []
    with torch.no_grad():
        for j in range(n):
            lins = params[j::n]
            out.append(torch.stack([p.weight.t() for p in lins]).to(
                dtype).contiguous())
            out.append(torch.stack([p.bias for p in lins]).to(
                dtype).contiguous())
    out = tuple(out)
    dit.__dict__["_fused_stack_cache"] = (key, out)
    return out


def fast_dit_forward(dit: DiT, x: torch.Tensor, t: torch.Tensor,
                     text_emb: Optional[torch.Tensor] = None,
                     text_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """DiT forward with the L blocks in ``fused_dit_stack``."""
    h, c = dit.embed(x, t, text_emb, text_mask)
    mods = torch.stack([blk.modulation(c, dit.compute_dtype)
                        for blk in dit.layers], dim=1)        # (B, L, 6, D)
    h = fused_dit_stack(h, mods, *_stacked_weights(dit, h.dtype),
                        dit.num_heads)
    return dit.finalize(h, x.dtype)


def split_dit_forward(dit: DiT, x: torch.Tensor, t: torch.Tensor,
                      text_emb: Optional[torch.Tensor] = None,
                      text_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """DiT forward with each block in ``fused_dit_block_split`` (weights
    from the per-parameter-version cache, layer by layer)."""
    h, c = dit.embed(x, t, text_emb, text_mask)
    ws = _stacked_weights(dit, h.dtype)
    for l, blk in enumerate(dit.layers):
        h = fused_dit_block_split(h, blk.modulation(c, dit.compute_dtype),
                                  *(w[l] for w in ws), dit.num_heads)
    return dit.finalize(h, x.dtype)


def fast_dit_train_forward(dit: DiT, x: torch.Tensor, t: torch.Tensor,
                           text_emb: Optional[torch.Tensor] = None,
                           text_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Differentiable DiT forward with each block in
    ``fused_dit_block_diffable`` (adaLN vectors in the compute dtype)."""
    h, c = dit.embed(x, t, text_emb, text_mask)
    for blk in dit.layers:
        a, m = blk.attn, blk.mlp
        h = fused_dit_block_diffable(
            h, blk.modulation(c, dit.compute_dtype), a.qkv.weight.t(),
            a.qkv.bias, a.proj.weight.t(), a.proj.bias, m.fc1.weight.t(),
            m.fc1.bias, m.fc2.weight.t(), m.fc2.bias, dit.num_heads)
    return dit.finalize(h, x.dtype)


def flax_path_forward(dit: DiT, x: torch.Tensor, t: torch.Tensor,
                      text_emb: Optional[torch.Tensor] = None,
                      text_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Differentiable DiT forward through the flax path's kernels, as
    ``DiT.__call__`` with the residual fusion on (t2ms_tpu/models/denoisers
    /dit.py:232-263, :323-340): block 0's leading LayerNorm + modulate in
    ``mod_ln_diffable``; each gated residual deferred into the next
    LayerNorm + modulate, ``res_mod_ln_diffable`` (2 * depth - 1
    boundaries); the attention as JAX's ``_Attention`` picks it on a TPU
    (``flax_attention_route``, run by ``dit.qkv_attention``:
    ``fused_heads_diffable``, or ``attention`` with 'flash' or 'einsum' on
    the head-split views); the last gated residual eager before the final
    LayerNorm. On CPU tensors the kernels run their plain twins, on the
    same route."""
    h, c = dit.embed(x, t, text_emb, text_mask)
    dt = dit.compute_dtype
    route = flax_attention_route(dit)
    pending = None                     # the previous block's (mlp, gate)
    for blk in dit.layers:
        m = blk.modulation(c, dt)      # (B, 6, D): sh_a sc_a g_a sh_m sc_m g_m
        a = blk.attn
        if pending is None:
            z = mod_ln_diffable(h, m[:, 0:2])
        else:
            z, h = res_mod_ln_diffable(
                h, pending[0], torch.stack([pending[1], m[:, 0], m[:, 1]], 1))
        y = qkv_attention(dense(z, a.qkv.weight, a.qkv.bias, dt),
                          dit.num_heads, route).to(dt)
        z, h = res_mod_ln_diffable(h, dense(y, a.proj.weight, a.proj.bias,
                                            dt), m[:, 2:5])
        pending = (blk.mlp(z, dt), m[:, 5])
    h = h + pending[1][:, None] * pending[0]
    return dit.finalize(h, x.dtype)
