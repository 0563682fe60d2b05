"""Eager T2S-DiT denoiser (counterpart of t2ms_tpu/models/denoisers/dit.py).

latent (B, C=latent_dim, L=latent_len) -> permute -> 1xHxW "image"
-> 2x2 patchify -> linear to d_model -> +sinusoidal pos-emb
-> depth x adaLN-zero DiT blocks conditioned on c = TimeEmb(t) + text_emb
-> LN -> linear un-patchify -> inverse reshape.

Submodules carry the reference state_dict names (``conv``, ``patch_emb``,
``layers.{i}.attn.qkv/proj``, ``layers.{i}.mlp.fc1/fc2``,
``layers.{i}.adaLN_modulation.1``, ``ln``, ``linear_emb_to_patch``), so
``tools/import_torch_ckpt.py`` maps a port state_dict into the flax tree.
Parameters are f32; activations and products run in ``compute_dtype``
with the JAX package's rounding points (flax Dense: product rounded to the
compute dtype, then the bias added at that width). This eager model is the
plain path; the fused serving forward lives in ``dit_fast``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.ops.attention import (attention, attention_route,
                                          fused_heads_diffable)

__all__ = ["DiT", "sinusoidal_positions", "time_embedding", "qkv_attention"]


def sinusoidal_positions(num_positions: int, d_model: int) -> torch.Tensor:
    """Interleaved sin/cos table (reference transformer.py:14-23), computed
    in float64 numpy and rounded once to f32."""
    position = np.arange(num_positions, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))[None, :]
    pe = np.zeros((num_positions, d_model), np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe.astype(np.float32))


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion-time embedding with the reference's t*100 scaling and
    10000**linspace frequency table (transformer.py:25-40)."""
    t = t.float() * 100.0
    n = dim // 2
    # jnp.linspace(0, 1, n) in f32 is iota * f32(1 / (n - 1)), which
    # differs from torch.linspace in the last bit
    step = torch.tensor(1.0) / max(n - 1, 1)
    freqs = torch.pow(10000.0, torch.arange(n, dtype=torch.float32) * step)
    freqs = freqs.to(t.device)
    ang = t[:, None] / freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)`` numerics: x @ W^T rounded to ``dtype``,
    then the bias added at that width. ``weight`` is (out, in)."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    return y if bias is None else y + bias.to(dtype)


def _ln(x, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def qkv_attention(qkv: torch.Tensor, num_heads: int,
                  impl: str) -> torch.Tensor:
    """The attention of a (B, N, 3*H*D) qkv projection, whose features are
    [q | k | v] x [head-major], as (B, N, H*D): 'fused' runs
    ``fused_heads_diffable`` on its column slices; any other impl runs
    ``attention`` on the head-split (B, H, N, D) views."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    if impl == "fused":
        return fused_heads_diffable(qkv[..., :D], qkv[..., D:2 * D],
                                    qkv[..., 2 * D:], num_heads)
    q, k, v = qkv.reshape(B, N, 3, num_heads, D // num_heads).permute(
        2, 0, 3, 1, 4).unbind(0)
    return attention(q, k, v, impl=impl).transpose(1, 2).reshape(B, N, D)


class _Attention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)

    def forward(self, x, dtype, impl: str = "einsum"):
        """JAX's ``_Attention`` dispatch (t2ms_tpu/models/denoisers/dit.py
        :87-109), "on a TPU" read as "on a CUDA tensor": 'auto' is JAX's
        route on a CUDA tensor (``attention_route``: fused heads, flash or
        einsum) and einsum on the CPU; 'fused', 'einsum', 'flash' and
        'packed' run as ``qkv_attention`` runs them."""
        B, N, D = x.shape
        qkv = dense(x, self.qkv.weight, self.qkv.bias, dtype)
        if impl == "auto":
            impl = (attention_route(N, D, qkv.element_size()) if qkv.is_cuda
                    else "einsum")
        y = qkv_attention(qkv, self.num_heads, impl)
        return dense(y.to(dtype), self.proj.weight, self.proj.bias, dtype)


class _Mlp(nn.Module):
    def __init__(self, d_model: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d_model, hidden)
        self.fc2 = nn.Linear(hidden, d_model)

    def forward(self, x, dtype):
        h = F.gelu(dense(x, self.fc1.weight, self.fc1.bias, dtype),
                   approximate="tanh")
        return dense(h, self.fc2.weight, self.fc2.bias, dtype)


class DiTBlock(nn.Module):
    """adaLN-zero transformer block (transformer.py:94-124)."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = _Attention(d_model, num_heads)
        self.mlp = _Mlp(d_model, int(d_model * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(d_model, 6 * d_model))

    def modulation(self, c, dtype):
        """(B, 6, D) adaLN vectors [shift_a, scale_a, gate_a, shift_m,
        scale_m, gate_m] in ``dtype``."""
        lin = self.adaLN_modulation[1]
        mod = dense(F.silu(c), lin.weight, lin.bias, dtype)
        return mod.reshape(c.shape[0], 6, -1)

    def forward(self, x, c, dtype, impl: str = "einsum"):
        m = self.modulation(c, dtype)[:, :, None, :]          # (B, 6, 1, D)
        z = (_ln(x, 1e-6).to(dtype) * (1.0 + m[:, 1]) + m[:, 0])
        x = x + m[:, 2] * self.attn(z, dtype, impl)
        z = (_ln(x, 1e-6).to(dtype) * (1.0 + m[:, 4]) + m[:, 3])
        return x + m[:, 5] * self.mlp(z, dtype)


def _init_like_jax(model: "DiT") -> None:
    """Initializers of the JAX DiT: xavier-uniform Linear kernels with zero
    bias, zero adaLN (adaLN-zero), torch-default patchify conv."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            if name.endswith("adaLN_modulation.1"):
                nn.init.zeros_(mod.weight)
            else:
                nn.init.xavier_uniform_(mod.weight)
            nn.init.zeros_(mod.bias)


class DiT(nn.Module):
    """Parametric-H DiT denoiser: ``forward(x, t, text_emb, text_mask)``
    with x (B, latent_dim, latent_len), t (B,), text_emb (B, d_model) or
    None, text_mask (B,) of {0, 1} (0 = the uncond half of the CFG pair).
    Returns x's shape and dtype. Parameters are created on ``device``
    (None = CUDA). ``attention_impl='auto'`` lets the samplers and the
    train step route the forward through the fused CUDA kernels; any other
    value opts out of them. The eager forward dispatches the attention on
    ``attention_impl`` as JAX's ``_Attention`` does ('auto', 'fused',
    'einsum', 'flash', 'packed'); its LayerNorms stay eager."""

    def __init__(self, latent_len: int = 30, latent_dim: int = 64,
                 d_model: int = 128, depth: int = 4, num_heads: int = 4,
                 mlp_ratio: float = 2.0, patch_size: int = 2,
                 compute_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", device=None):
        super().__init__()
        self.latent_len, self.latent_dim = latent_len, latent_dim
        self.d_model, self.depth, self.num_heads = d_model, depth, num_heads
        self.mlp_ratio, self.patch_size = mlp_ratio, patch_size
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        p = patch_size
        self.conv = nn.Conv2d(1, p * p, kernel_size=p, stride=p)
        self.patch_emb = nn.Linear(p * p, d_model)
        self.layers = nn.ModuleList(
            [DiTBlock(d_model, num_heads, mlp_ratio) for _ in range(depth)])
        self.ln = nn.LayerNorm(d_model, eps=1e-5)
        self.linear_emb_to_patch = nn.Linear(d_model, p * p)
        _init_like_jax(self)
        self.register_buffer(
            "pos", sinusoidal_positions(self.num_patches, d_model),
            persistent=False)
        self.to(resolve_device(device))

    @property
    def num_patches(self) -> int:
        return ((self.latent_len // self.patch_size)
                * (self.latent_dim // self.patch_size))

    def embed(self, x, t, text_emb=None, text_mask=None):
        """Front half shared with the fused forward: patchify + positions
        + time/text conditioning. Returns (h (B, N, D), c (B, D))."""
        B = x.shape[0]
        H, W, p = self.latent_len, self.latent_dim, self.patch_size
        if x.shape[1] != W or x.shape[2] != H:
            raise ValueError(f"expected latent (B,{W},{H}), got "
                             f"{tuple(x.shape)}")
        nh, nw = H // p, W // p
        dt = self.compute_dtype
        img = x.to(dt).transpose(1, 2)                          # (B, H, W)
        patches = img.reshape(B, nh, p, nw, p).permute(0, 1, 3, 2, 4)
        patches = patches.reshape(B, nh * nw, p * p)
        # the k=stride=2 patchify conv is a per-patch linear map
        h = dense(patches, self.conv.weight.reshape(p * p, p * p),
                  self.conv.bias, dt)
        h = dense(h, self.patch_emb.weight, self.patch_emb.bias, dt)
        h = h + self.pos.to(dt)[None]
        c = time_embedding(t, self.d_model).to(dt)
        if text_emb is not None:
            te = text_emb.to(dt)
            if text_mask is not None:
                te = te * text_mask[:, None].to(dt)
            c = c + te
        return h, c

    def finalize(self, h, out_dtype):
        """Back half: affine final LN (eps 1e-5, f32) + linear unpatchify
        back to the (B, W, H) latent layout."""
        B = h.shape[0]
        H, W, p = self.latent_len, self.latent_dim, self.patch_size
        hf = _ln(h, 1e-5)
        h = (hf * self.ln.weight.float() + self.ln.bias.float()).to(
            self.compute_dtype)
        h = dense(h, self.linear_emb_to_patch.weight,
                  self.linear_emb_to_patch.bias, self.compute_dtype)
        out = h.reshape(B, H // p, W // p, p, p).permute(0, 1, 3, 2, 4)
        out = out.reshape(B, H, W).transpose(1, 2)              # (B, W, H)
        return out.to(out_dtype)

    def forward(self, x, t, text_emb=None, text_mask=None):
        h, c = self.embed(x, t, text_emb, text_mask)
        for blk in self.layers:
            h = blk(h, c, self.compute_dtype, self.attention_impl)
        return self.finalize(h, x.dtype)
