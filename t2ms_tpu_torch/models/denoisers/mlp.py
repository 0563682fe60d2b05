"""MLP denoiser with text cross-attention (counterpart of
t2ms_tpu/models/denoisers/mlp.py).

Reference: model/denoiser/mlp.py — stacked layers; each adds a time
embedding over the feature axis (broadcast over tokens), applies text
cross-attention (query from the series, key/value from the text embedding
repeated over the tokens), a LayerNorm, an MLP over the feature axis
(feat -> hidden -> feat, residual) and an MLP over the token axis
(L -> hidden -> L). Latents are (B, feat_dim, latent_len): (B, 64, 6) for
a reference checkpoint, (B, 64, 30) on the LA-VAE grid.

Submodules carry the reference state_dict names
(``layers.{i}.cross_attn.{key,query,value,proj}``, ``layers.{i}.norm2``,
``layers.{i}.mlp.{0,2}``, ``layers.{i}.mlp2.{0,2}``), so a reference
``.pth`` loads unchanged; its unused ``norm1``, ``norm3``, ``pos_emb`` and
``self_attn*`` are not built. Linears keep torch's default init (the
reference's, which the JAX module copies). Parameters are f32; products run
in ``compute_dtype`` with flax's rounding points (``dit.dense``) and the
LayerNorm is flax's: eps 1e-6, statistics in f32. No kernel: the MLP runs
eager on every device, as it runs ``denoiser.apply`` in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.models.denoisers.dit import dense, time_embedding

__all__ = ["MLPDenoiser"]


def _flax_layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
                     dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=...)``: mean and E[x^2] - mean^2 (clipped
    at 0) in f32, (x - mean) * (rsqrt(var + eps) * scale) + bias in f32,
    rounded once to ``dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp(torch.square(xf).mean(dim=-1, keepdim=True)
                      - torch.square(mu), min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.float()
    return ((xf - mu) * mul + norm.bias.float()).to(dtype)


def _sequential_mlp(d_in: int, hidden: int) -> nn.Sequential:
    """The reference's ``nn.Sequential(Linear, ReLU, Linear)``."""
    return nn.Sequential(nn.Linear(d_in, hidden), nn.ReLU(),
                         nn.Linear(hidden, d_in))


def _mlp_apply(seq: nn.Sequential, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    fc1, fc2 = seq[0], seq[2]
    h = torch.relu(dense(x, fc1.weight, fc1.bias, dtype))
    return dense(h, fc2.weight, fc2.bias, dtype)


class _TextCrossAttention(nn.Module):
    """Cross-attention from series tokens to text tokens
    (reference mlp.py:21-47)."""

    def __init__(self, n_embd: int, condition_dim: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.key = nn.Linear(condition_dim, n_embd)
        self.query = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(condition_dim, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)

    def forward(self, x, encoder_output, dtype):
        B, T, C = x.shape
        T_E = encoder_output.shape[1]
        h = self.n_head
        hd = C // h
        k = dense(encoder_output, self.key.weight, self.key.bias, dtype)
        q = dense(x, self.query.weight, self.query.bias, dtype)
        v = dense(encoder_output, self.value.weight, self.value.bias, dtype)
        q = q.reshape(B, T, h, hd).transpose(1, 2)
        k = k.reshape(B, T_E, h, hd).transpose(1, 2)
        v = v.reshape(B, T_E, h, hd).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-2, -1)) * (hd ** -0.5)
        att = torch.softmax(att.float(), dim=-1).to(dtype)
        y = torch.matmul(att, v).transpose(1, 2).reshape(B, T, C)
        return dense(y, self.proj.weight, self.proj.bias, dtype)


class _MLPLayer(nn.Module):
    def __init__(self, feat_dim: int, latent_len: int, text_dim: int,
                 hidden: int, n_head: int):
        super().__init__()
        self.latent_len = latent_len
        self.cross_attn = _TextCrossAttention(feat_dim, text_dim, n_head)
        self.norm2 = nn.LayerNorm(feat_dim, eps=1e-6)
        self.mlp = _sequential_mlp(feat_dim, hidden)
        self.mlp2 = _sequential_mlp(latent_len, hidden)

    def forward(self, x, temb, text_emb, text_mask, dtype):
        # the time embedding over the feature axis, broadcast over tokens
        # (mlp.py:73-75)
        h = (x + temb[:, :, None]).transpose(1, 2)     # (B, L, feat)
        if text_emb is not None:
            tokens = text_emb[:, None, :].to(dtype).expand(
                -1, self.latent_len, -1)
            attn = self.cross_attn(h, tokens, dtype)
            if text_mask is not None:
                # 0 zeroes the whole cross-attention residual, the
                # reference's text_input=None (mlp.py:77): zeroing the
                # embedding would leave the k/v/proj biases in
                attn = attn * text_mask[:, None, None].to(dtype)
            h = h + attn
        h = _flax_layer_norm(h, self.norm2, dtype)
        h = h + _mlp_apply(self.mlp, h, dtype)
        return _mlp_apply(self.mlp2, h.transpose(1, 2), dtype)


class MLPDenoiser(nn.Module):
    """The reference's MLP denoiser (mlp.py:87-94): ``forward(x, t,
    text_emb=None, text_mask=None)`` with x (B, feat_dim, latent_len), t
    (B,), text_emb (B, text_dim) or None (no cross-attention) and
    text_mask (B,) of {0, 1} (0 = the uncond half of the CFG pair).
    Returns x's shape and dtype. Parameters are created on ``device``
    (None = CUDA)."""

    def __init__(self, feat_dim: int = 64, latent_len: int = 6,
                 text_dim: int = 128, depth: int = 8, hidden: int = 256,
                 n_head: int = 4, compute_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.feat_dim, self.latent_len = feat_dim, latent_len
        self.text_dim, self.depth = text_dim, depth
        self.hidden, self.n_head = hidden, n_head
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleList(
            [_MLPLayer(feat_dim, latent_len, text_dim, hidden, n_head)
             for _ in range(depth)])
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                text_emb: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        # every layer adds the same embedding: built once a forward (its
        # frequency table is copied to the device on each build)
        temb = time_embedding(t, self.feat_dim).to(dtype)
        h = x.to(dtype)
        for layer in self.layers:
            h = layer(h, temb, text_emb, text_mask, dtype)
        return h.to(x.dtype)
