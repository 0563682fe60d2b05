"""Attention-based seq2seq autoencoder, the T2MS alternative VAE
(counterpart of t2ms_tpu/models/vae/tsae.py).

Reference: model/pretrained/TSae.py — transformer encoder over (B, T, n_f)
with sinusoidal positions (:93-187), a condition-fusion module with AdaLN
and a variable-input text projection (:189-274), and a causal transformer
decoder trained with teacher forcing (:356-389) / slow autoregressive
``generate`` at inference (:391-421). Used by pretrained_mylavae.py:185.

The JAX module computes it in plain jnp (no Pallas kernel), so the port
uses stock torch ops: einsum attention, Linear, LayerNorm. Its numbers are
the flax module's: every LayerNorm has eps 1e-6, the AdaLN's GELU is the
exact one and the feed-forwards use ReLU, masks fill with -1e30, the
positional table is computed in float64, Linears start from flax's
lecun-normal kernels and zero biases. ``generate`` reruns the whole
decoder over a fixed (B, T, flow_dim) buffer at each of T steps, as the
JAX scan does (no KV cache, which would round differently).

Dropout (p = 0.1 at the reference's seven kinds of site) is applied only
when a ``DropoutDraws`` is passed: its keep masks come from a dict keyed by
the flax module path of each site (``"enc_0/self_attn/Dropout_0"``,
``"pe_dropout"``, ...), so a test can inject the masks JAX used, or else
from a torch generator. Without one every method is deterministic (flax's
``train=False``).

Submodules carry names that map one to one onto the flax tree
(``convert.tsae_params_from_jax``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2ms_tpu_torch import resolve_device

__all__ = ["TSae", "TSaeDiffusion", "DropoutDraws", "tsae_adapter_loss",
           "tsae_loss"]


@functools.lru_cache(maxsize=None)
def _positional_encoding_np(T: int, d: int) -> np.ndarray:
    """Classic interleaved table (reference PositionalEncoding :19-37),
    computed in float64 and rounded once to f32."""
    pos = np.arange(T, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d))
    pe = np.zeros((T, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, : d // 2]
    return pe.astype(np.float32)


def _positional_encoding(T: int, d: int, device) -> torch.Tensor:
    return torch.from_numpy(_positional_encoding_np(T, d)).to(device)


class DropoutDraws:
    """The dropout of one forward in train mode. ``masks`` maps a site's
    flax module path to its keep mask (bool, the shape of the site's
    input); a site with no mask draws ``rand < 1 - rate`` from
    ``generator``. A kept element is scaled by 1 / (1 - rate), as flax
    does."""

    def __init__(self, rate: float,
                 masks: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        self.rate, self.masks, self.generator = rate, masks, generator

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if self.masks is not None and name in self.masks:
            keep = torch.as_tensor(self.masks[name], device=x.device)
            if keep.shape != x.shape:
                raise ValueError(f"dropout mask {name}: {tuple(keep.shape)} "
                                 f"for an input of {tuple(x.shape)}")
        else:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _site(drop: Optional[DropoutDraws], name: str, x: torch.Tensor):
    return x if drop is None else drop(name, x)


def _linear(d_in: int, d_out: int) -> nn.Linear:
    """nn.Linear with flax's Dense init: lecun-normal kernel (a normal
    truncated at two standard deviations, rescaled to variance 1/fan_in),
    zero bias."""
    lin = nn.Linear(d_in, d_out)
    std = (1.0 / d_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std)
        lin.bias.zero_()
    return lin


def _ln(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-6)    # flax's epsilon


class _MHA(nn.Module):
    """torch nn.MultiheadAttention equivalent, with its dropout on the
    attention probabilities."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = _linear(d_model, d_model)
        self.k = _linear(d_model, d_model)
        self.v = _linear(d_model, d_model)
        self.out = _linear(d_model, d_model)

    def forward(self, q_in, kv_in, mask=None, drop=None, path: str = ""):
        B, Tq, D = q_in.shape
        Tk = kv_in.shape[1]
        h = self.num_heads
        hd = D // h
        q = self.q(q_in).reshape(B, Tq, h, hd)
        k = self.k(kv_in).reshape(B, Tk, h, hd)
        v = self.v(kv_in).reshape(B, Tk, h, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        if mask is not None:
            att = att.masked_fill(mask, -1e30)
        att = torch.softmax(att, dim=-1)
        att = _site(drop, f"{path}/Dropout_0", att)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, Tq, D)
        return self.out(out)


class _EncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer (norm_first=True in the
    reference, TSae.py:138-145), with torch's three dropout sites: after
    self-attention, after the FF's activation and after the FF output."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int):
        super().__init__()
        self.norm1 = _ln(d_model)
        self.self_attn = _MHA(d_model, num_heads)
        self.norm2 = _ln(d_model)
        self.ff1 = _linear(d_model, d_ff)
        self.ff2 = _linear(d_ff, d_model)

    def forward(self, x, drop=None, path: str = ""):
        h = self.norm1(x)
        x = x + _site(drop, f"{path}/Dropout_0",
                      self.self_attn(h, h, None, drop, f"{path}/self_attn"))
        h = self.norm2(x)
        h = _site(drop, f"{path}/Dropout_1", F.relu(self.ff1(h)))
        return x + _site(drop, f"{path}/Dropout_2", self.ff2(h))


class _DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int):
        super().__init__()
        self.norm1 = _ln(d_model)
        self.self_attn = _MHA(d_model, num_heads)
        self.norm2 = _ln(d_model)
        self.cross_attn = _MHA(d_model, num_heads)
        self.norm3 = _ln(d_model)
        self.ff1 = _linear(d_model, d_ff)
        self.ff2 = _linear(d_ff, d_model)

    def forward(self, x, memory, causal_mask, drop=None, path: str = ""):
        h = self.norm1(x)
        x = x + _site(drop, f"{path}/Dropout_0", self.self_attn(
            h, h, causal_mask, drop, f"{path}/self_attn"))
        h = self.norm2(x)
        x = x + _site(drop, f"{path}/Dropout_1", self.cross_attn(
            h, memory, None, drop, f"{path}/cross_attn"))
        h = self.norm3(x)
        h = _site(drop, f"{path}/Dropout_2", F.relu(self.ff1(h)))
        return x + _site(drop, f"{path}/Dropout_3", self.ff2(h))


class _AdaLN(nn.Module):
    """LN modulated by a condition vector (reference AdaLN :52-91; torch
    nn.GELU() default is the exact gelu, not the tanh approximation)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.norm = _ln(d_model)
        self.fc1 = _linear(d_model, 4 * d_model)
        self.fc2 = _linear(4 * d_model, 2 * d_model)

    def forward(self, x, condition):
        x_ln = self.norm(x)
        gb = self.fc2(F.gelu(self.fc1(condition)))
        gamma, beta = torch.chunk(gb, 2, dim=-1)
        return gamma[:, None, :] * x_ln + beta[:, None, :]


class TSae(nn.Module):
    """AttentionSeq2SeqAutoencoder (reference TSae.py:428-579).

    n_features=input_dim, flow_dim=d_model; encoder/decoder layer counts
    and d_ff/num_heads from the per-sport vae config (config.yaml:50-55).
    Parameters are created on ``device`` (None = CUDA)."""

    def __init__(self, n_features: int = 10, flow_dim: int = 64,
                 num_encoder_layers: int = 3, num_decoder_layers: int = 3,
                 d_ff: int = 128, num_heads: int = 8,
                 max_text_dim: int = 128, dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.n_features, self.flow_dim = n_features, flow_dim
        self.dropout = dropout     # reference default everywhere (:114)
        d = flow_dim
        self.value_embedding = _linear(n_features, d)
        self.embedding_ln = _ln(d)
        self.enc_layers = nn.ModuleList(
            [_EncoderLayer(d, num_heads, d_ff)
             for _ in range(num_encoder_layers)])
        self.text_projection = _linear(max_text_dim, d)
        self.condition_projection = _linear(d, d)
        self.fusion_fc1 = _linear(2 * d, 4 * d)
        self.fusion_fc2 = _linear(4 * d, d)
        self.fusion_ln = _ln(d)
        self.ada_ln = _AdaLN(d)
        self.input_projection = _linear(n_features, d)
        self.output_projection = _linear(d, n_features)
        self.dec_layers = nn.ModuleList(
            [_DecoderLayer(d, num_heads, d_ff)
             for _ in range(num_decoder_layers)])
        self.to(resolve_device(device))

    def dropout_draws(self, masks=None, generator=None) -> DropoutDraws:
        """The train-mode dropout of one forward at this model's rate."""
        return DropoutDraws(self.dropout, masks, generator)

    # -- pieces ------------------------------------------------------------

    def encode(self, series: torch.Tensor,
               drop: Optional[DropoutDraws] = None) -> torch.Tensor:
        """(B, T, n_f) -> (B, T, flow_dim) memory. Dropout sites mirror the
        reference (TSae.py:127,131-135,170-180): embedding dropout BEFORE
        the LN, positional-encoding dropout on the summed input, and the
        torch TransformerEncoderLayer dropouts inside each layer."""
        h = _site(drop, "embedding_dropout", self.value_embedding(series))
        h = self.embedding_ln(h)
        T = h.shape[1]
        h = _site(drop, "pe_dropout",
                  h + _positional_encoding(T, self.flow_dim, h.device)[None])
        for i, layer in enumerate(self.enc_layers):
            h = layer(h, drop, f"enc_{i}")
        return h

    def fuse_condition(self, memory: torch.Tensor, text_emb: torch.Tensor,
                       drop: Optional[DropoutDraws] = None) -> torch.Tensor:
        """Text fusion + AdaLN (reference ConditionFusionModule :245-274;
        dropout between the fusion MLP's ReLU and its second Linear)."""
        B, T, _ = memory.shape
        text_cond = self.text_projection(text_emb.reshape(B, -1))
        expanded = text_cond[:, None, :].expand(B, T, self.flow_dim)
        fused = torch.cat([memory, expanded], dim=-1)
        fused = self.fusion_fc2(_site(drop, "fusion_dropout",
                                      F.relu(self.fusion_fc1(fused))))
        fused = self.fusion_ln(fused + memory)
        return self.ada_ln(fused, self.condition_projection(text_cond))

    def _decoder(self, h, memory, mask, drop=None):
        for i, layer in enumerate(self.dec_layers):
            h = layer(h, memory, mask, drop, f"dec_{i}")
        return h

    def decode_teacher_forced(self, memory: torch.Tensor,
                              target_seq: torch.Tensor,
                              drop: Optional[DropoutDraws] = None
                              ) -> torch.Tensor:
        """Shifted-right teacher forcing with causal mask (reference
        TimeSeriesDecoder.forward :356-389)."""
        B, T, _ = target_seq.shape
        emb = self.input_projection(target_seq)
        bos = torch.zeros((B, 1, self.flow_dim), dtype=emb.dtype,
                          device=emb.device)
        dec_in = torch.cat([bos, emb[:, :-1]], dim=1)
        dec_in = _site(drop, "dec_pe_dropout", dec_in + _positional_encoding(
            T, self.flow_dim, emb.device)[None])
        causal = torch.triu(torch.ones((T, T), dtype=torch.bool,
                                       device=emb.device), diagonal=1)
        return self.output_projection(
            self._decoder(dec_in, memory, causal[None, None], drop))

    def generate(self, memory: torch.Tensor) -> torch.Tensor:
        """Autoregressive generation of len(memory) steps (reference
        :391-421): T reruns of the whole decoder over a fixed-size input
        buffer, position i seeing positions up to i; the prediction at i
        is projected into the buffer at i + 1 (the last step writes
        nothing)."""
        B, T, _ = memory.shape
        dev = memory.device
        pe = _positional_encoding(T, self.flow_dim, dev)[None]
        idx = torch.arange(T, device=dev)
        causal = torch.triu(torch.ones((T, T), dtype=torch.bool, device=dev),
                            diagonal=1)
        buf = torch.zeros((B, T, self.flow_dim), dtype=memory.dtype,
                          device=dev)
        preds = []
        for i in range(T):
            mask = (causal | (idx[None, :] > i))[None, None]
            h = self._decoder(buf + pe, memory, mask)
            pred = self.output_projection(h[:, i])            # (B, n_f)
            preds.append(pred)
            if i + 1 < T:
                buf = buf.clone()
                buf[:, i + 1] = self.input_projection(pred)
        return torch.stack(preds, dim=1)                      # (B, T, n_f)

    # -- entry points ------------------------------------------------------

    def forward(self, series, text_emb, drop: Optional[DropoutDraws] = None):
        """Teacher-forced conditional reconstruction (reference forward
        :476-521)."""
        mem = self.encode(series, drop)
        mem = self.fuse_condition(mem, text_emb, drop)
        return self.decode_teacher_forced(mem, series, drop)

    def reconstruct_teacher_forced(self, series,
                                   drop: Optional[DropoutDraws] = None):
        """Unconditioned teacher-forced path used by shared_eval 'train'
        (reference :556-571, fusion commented out there)."""
        mem = self.encode(series, drop)
        return self.decode_teacher_forced(mem, series, drop)

    def reconstruct_autoregressive(self, series):
        """Inference path (reference forward_inference :523-554)."""
        return self.generate(self.encode(series))


class TSaeDiffusion:
    """LAVAE-interface adapter over a TSae: ``encode(x) -> (z, aux)`` and
    ``decode(z, length) -> (x, aux)`` in the conv VAE's (B, F, T)
    channel-first layout, so the TSae can stand in wherever a LAVAE feeds
    the diffusion stack (``make_denoiser_train_step``,
    ``make_cfg_sampler``). The latent z is the encoder memory transposed to
    (B, flow_dim, T); decode runs the autoregressive generator. The latent
    length equals the series length (the TSae has no length adaptation),
    and ``decode`` ignores ``length`` as the JAX adapter does.

    As in JAX it is a plain object over ``self.tsae`` that duck-types the
    surface the trainer and sampler use (``parameters``, ``to``, ``eval``,
    ``encode``, ``decode``); its state_dict is the TSae's own, so
    ``cli.pretrain_mylavae`` checkpoints load directly."""

    def __init__(self, n_features: int = 10, flow_dim: int = 64,
                 num_encoder_layers: int = 3, num_decoder_layers: int = 3,
                 d_ff: int = 128, num_heads: int = 8,
                 dropout: float = 0.1, device=None):
        self.n_features = n_features
        self.flow_dim = flow_dim
        self.tsae = TSae(n_features=n_features, flow_dim=flow_dim,
                         num_encoder_layers=num_encoder_layers,
                         num_decoder_layers=num_decoder_layers,
                         d_ff=d_ff, num_heads=num_heads, dropout=dropout,
                         device=device)

    # module surface, delegated
    def parameters(self, recurse: bool = True):
        return self.tsae.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self.tsae.named_parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self.tsae.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self.tsae.load_state_dict(*args, **kwargs)

    def to(self, *args, **kwargs) -> "TSaeDiffusion":
        self.tsae.to(*args, **kwargs)
        return self

    def eval(self) -> "TSaeDiffusion":
        self.tsae.eval()
        return self

    # layout adapters
    @staticmethod
    def _to_series(x):
        if x.ndim == 2:                   # univariate (B, T) -> (B, T, 1)
            return x[:, :, None]
        return x.transpose(1, 2)          # (B, F, T) -> (B, T, F)

    @staticmethod
    def _from_series(r, squeeze: bool):
        if squeeze:
            return r[:, :, 0]             # (B, T)
        return r.transpose(1, 2)          # (B, F, T)

    def encode(self, x):
        mem = self.tsae.encode(self._to_series(x))       # (B, T, flow)
        return mem.transpose(1, 2), mem                  # z: (B, flow, T)

    def decode(self, z, length: int):
        mem = z.transpose(1, 2)                          # (B, T, flow)
        out = self.tsae.generate(mem)                    # (B, T, n_f)
        return self._from_series(out, self.n_features == 1), mem

    def reconstruct_teacher_forced(self, x,
                                   drop: Optional[DropoutDraws] = None):
        """Channel-first teacher-forced reconstruction (pretraining
        target, reference shared_eval TSae.py:556-571)."""
        _, recon = tsae_loss(self.tsae, self._to_series(x), drop)
        return self._from_series(recon, x.ndim == 2)

    def reconstruct_autoregressive(self, x):
        z, _ = self.encode(x)
        out, _ = self.decode(z, x.shape[-1])
        return out

    def __call__(self, x):
        z, mem = self.encode(x)
        recon, after = self.decode(z, x.shape[-1])
        return recon, z, mem, after


def tsae_adapter_loss(model: TSaeDiffusion, batch: torch.Tensor,
                      drop: Optional[DropoutDraws] = None):
    """Teacher-forced MSE through the adapter, channel-first layout —
    drop-in for lavae_loss in pretraining loops. Returns
    (loss, (recon_error, recon)) like the LAVAE loss."""
    recon = model.reconstruct_teacher_forced(batch, drop)
    loss = torch.mean(torch.square(recon - batch))
    return loss, (loss, recon)


def tsae_loss(model: TSae, series: torch.Tensor,
              drop: Optional[DropoutDraws] = None):
    """Teacher-forced MSE (reference shared_eval :556-571). With ``drop``
    the forward runs in train mode with the reference's p=0.1 dropout
    everywhere; without it it is deterministic (eval). Returns
    (loss, recon)."""
    recon = model.reconstruct_teacher_forced(series, drop)
    return torch.mean(torch.square(recon - series)), recon
