"""Tensor-parallel DiT over the ``model`` mesh axis (counterpart of
t2ms_tpu/parallel/tp.py).

The partition rules are JAX's, by parameter name (Megatron pairing):
``qkv`` and ``fc1`` are column-parallel (their output features split),
``proj`` and ``fc2`` row-parallel (their input features split), and
``adaLN_modulation`` column-parallel; biases, norms and the embeddings are
replicated. A spec is written in torch's (out, in) weight layout:
``("model", None)`` splits the rows (JAX's ``P(None, 'model')`` on the
(in, out) kernel), ``(None, "model")`` the columns, ``()`` replicates.

JAX lets XLA place the collectives; ``tp_dit_forward`` places them by
hand: a replicated activation enters each column-parallel product through
``copy_to`` (its partial gradients all-reduced), each row-parallel product
is summed with ``psum`` over ``model``, and the column-parallel adaLN
output is gathered whole before its six chunks are read. A replicated
bias is added after the collective, or sliced through ``copy_to``, so
every rank's replicated parameters get the whole gradient.

The qkv columns are laid out (3, H, dh). A contiguous split of the 3D
output columns, as JAX's spec reads, would give rank 0 all of q and part
of k (XLA reshards around it; nothing does here). So q, k and v are each
split by whole heads, and ``proj``'s input columns split to match.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from t2ms_tpu_torch.models.denoisers.dit import DiT, _ln, qkv_attention
from t2ms_tpu_torch.ops.attention import attention_route
from t2ms_tpu_torch.parallel.collectives import all_gather, copy_to, psum

__all__ = ["dit_param_spec", "shard_dit_params", "unshard_dit_params",
           "TPDiT", "tp_dit_forward"]

_COLUMN, _ROW, _REPLICATED = ("model", None), (None, "model"), ()


def _spec_for(name: str, ndim: int) -> tuple:
    if ndim < 2:
        return _REPLICATED                 # biases, norms: replicated
    if name.endswith(("qkv.weight", "fc1.weight")):
        return _COLUMN
    if name.endswith(("proj.weight", "fc2.weight")):
        return _ROW
    if name.endswith("adaLN_modulation.1.weight"):
        return _COLUMN
    return _REPLICATED                     # patch/unpatch embeddings


def dit_param_spec(state_dict) -> Dict[str, tuple]:
    """The spec of every entry of a DiT state_dict."""
    return {k: _spec_for(k, v.ndim) for k, v in state_dict.items()}


def _split(name: str, w: torch.Tensor, spec: tuple, n: int,
           j: int) -> torch.Tensor:
    if spec == _REPLICATED:
        return w
    dim = 0 if spec == _COLUMN else 1
    if w.shape[dim] % (3 * n if name.endswith("qkv.weight") else n):
        raise ValueError(f"{name} {tuple(w.shape)} does not split over "
                         f"model={n}")
    if name.endswith("qkv.weight"):
        # q, k and v each by whole heads: rows (3, D) -> (3, n, D / n)
        return w.reshape(3, n, -1, w.shape[1])[:, j].reshape(-1, w.shape[1])
    return w.chunk(n, dim=dim)[j]


def shard_dit_params(state_dict, mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of every entry of a DiT state_dict."""
    n, j = mesh.shape["model"], mesh.index("model")
    spec = dit_param_spec(state_dict)
    return {k: _split(k, v, spec[k], n, j).clone()
            for k, v in state_dict.items()}


def unshard_dit_params(shards, mesh) -> Dict[str, torch.Tensor]:
    """The whole state_dict back from every rank's shards (a collective
    over ``model``: every rank of the axis must call it)."""
    n, group = mesh.shape["model"], mesh.group("model")
    out = {}
    for k, v in dit_param_spec(shards).items():
        w = shards[k].detach()
        if v == _REPLICATED or group is None:
            out[k] = w.clone()
            continue
        parts = [torch.empty_like(w) for _ in range(n)]
        torch.distributed.all_gather(parts, w.contiguous(), group=group)
        if k.endswith("qkv.weight"):
            out[k] = torch.stack([p.reshape(3, -1, w.shape[1])
                                  for p in parts], 1).reshape(-1, w.shape[1])
        else:
            out[k] = torch.cat(parts, dim=0 if v == _COLUMN else 1)
    return out


class TPDiT(nn.Module):
    """A DiT whose column- and row-parallel weights are this rank's shards
    (``state_dict()`` gives them under the DiT's own names); its forward
    is ``tp_dit_forward``. Build it from a whole DiT on every rank of the
    mesh, with the same weights."""

    num_patches = DiT.num_patches
    embed = DiT.embed
    finalize = DiT.finalize

    def __init__(self, dit: DiT, mesh):
        super().__init__()
        n = mesh.shape["model"]
        if dit.num_heads % n:
            raise ValueError(f"{dit.num_heads} heads do not split over "
                             f"model={n}")
        for k in ("latent_len", "latent_dim", "d_model", "depth",
                  "num_heads", "mlp_ratio", "patch_size", "compute_dtype",
                  "attention_impl"):
            setattr(self, k, getattr(dit, k))
        self.mesh = mesh
        local = copy.deepcopy(dit)
        shards = shard_dit_params(dit.state_dict(), mesh)
        for name, p in local.named_parameters():
            if shards[name].shape != p.shape:
                mod = local.get_submodule(name.rsplit(".", 1)[0])
                setattr(mod, name.rsplit(".", 1)[1],
                        nn.Parameter(shards[name].to(p.device)))
        self.conv, self.patch_emb = local.conv, local.patch_emb
        self.layers, self.ln = local.layers, local.ln
        self.linear_emb_to_patch = local.linear_emb_to_patch
        self.register_buffer("pos", local.pos, persistent=False)

    def forward(self, x, t, text_emb=None, text_mask=None):
        return tp_dit_forward(self, x, t, text_emb, text_mask)


def _local_cols(bias: torch.Tensor, n: int, j: int, qkv: bool):
    """This rank's entries of a replicated column-parallel bias."""
    if qkv:
        return bias.reshape(3, n, -1)[:, j].reshape(-1)
    return bias.chunk(n)[j]


def _tp_block(blk, x, c, dt, impl, group, n, j, heads):
    B, N, D = x.shape
    lin = blk.adaLN_modulation[1]
    mod = all_gather(torch.matmul(copy_to(F.silu(c), group).to(dt),
                                  lin.weight.to(dt).t()), group, dim=-1)
    m = (mod + lin.bias.to(dt)).reshape(B, 6, D)[:, :, None, :]

    z = _ln(x, 1e-6).to(dt) * (1.0 + m[:, 1]) + m[:, 0]
    att = blk.attn
    qkv = (torch.matmul(copy_to(z, group).to(dt), att.qkv.weight.to(dt).t())
           + _local_cols(copy_to(att.qkv.bias, group), n, j, True).to(dt))
    route = impl
    if impl == "auto":
        route = (attention_route(N, qkv.shape[-1] // 3, qkv.element_size())
                 if qkv.is_cuda else "einsum")
    y = qkv_attention(qkv, heads, route)
    out = psum(torch.matmul(y.to(dt), att.proj.weight.to(dt).t()), group)
    x = x + m[:, 2] * (out + att.proj.bias.to(dt))

    z = _ln(x, 1e-6).to(dt) * (1.0 + m[:, 4]) + m[:, 3]
    mlp = blk.mlp
    h = F.gelu(torch.matmul(copy_to(z, group).to(dt),
                            mlp.fc1.weight.to(dt).t())
               + _local_cols(copy_to(mlp.fc1.bias, group), n, j,
                             False).to(dt), approximate="tanh")
    out = psum(torch.matmul(h, mlp.fc2.weight.to(dt).t()), group)
    return x + m[:, 5] * (out + mlp.fc2.bias.to(dt))


def tp_dit_forward(model: TPDiT, x, t, text_emb=None, text_mask=None):
    """The eager DiT forward on this rank's shards, with the collectives
    over ``model`` placed by hand; every rank of the axis returns the
    whole output. Attention runs on this rank's H / model heads, routed
    as the eager DiT routes it."""
    mesh = model.mesh
    group, n, j = mesh.group("model"), mesh.shape["model"], mesh.index(
        "model")
    h, c = model.embed(x, t, text_emb, text_mask)
    for blk in model.layers:
        h = _tp_block(blk, h, c, model.compute_dtype, model.attention_impl,
                      group, n, j, model.num_heads // n)
    return model.finalize(h, x.dtype)
