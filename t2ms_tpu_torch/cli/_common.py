"""Shared CLI plumbing: model factories and the CLIs' seeds (counterpart of
t2ms_tpu/cli/_common.py)."""

from __future__ import annotations

import torch

from t2ms_tpu_torch.models.denoisers import DiT, MLPDenoiser
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.utils.prng import root_key, step_key

__all__ = ["build_denoiser", "build_t2s_vae", "build_motion_vae",
           "batch_seed", "DENOISER_CHOICES"]

DENOISER_CHOICES = ("DiT", "MLP")


def build_denoiser(name: str, latent_len: int, latent_dim: int = 64,
                   compute_dtype=torch.float32, device=None):
    """The reference factory {'DiT': Transformer, 'MLP': MLP} (train.py:16)
    at a parametric latent geometry; ``compute_dtype`` is the activation
    dtype (params stay f32). ``latent_len=30`` is the flagship DiT (480
    tokens, d 128, 4 heads, depth 4) or the MLP on the LA-VAE grid (feat
    64, depth 8, hidden 256, 4 heads, text 128)."""
    if name == "DiT":
        return DiT(latent_len=latent_len, latent_dim=latent_dim,
                   compute_dtype=compute_dtype, device=device)
    if name == "MLP":
        return MLPDenoiser(feat_dim=latent_dim, latent_len=latent_len,
                           compute_dtype=compute_dtype, device=device)
    raise ValueError("No denoiser found")


def build_t2s_vae(args=None, device=None) -> LAVAE:
    """T2S LA-VAE at the reference pretraining defaults
    (pretrained_lavae_unified.py:119-122)."""
    g = (lambda k, d: getattr(args, k, d)) if args is not None else (
        lambda k, d: d)
    return LAVAE(in_channels=1,
                 num_hiddens=g("block_hidden_size", 128),
                 num_residual_layers=g("num_residual_layers", 2),
                 num_residual_hiddens=g("res_hidden_size", 256),
                 embedding_dim=g("embedding_dim", 64),
                 latent_grid=g("latent_grid", 30),
                 exact_length_output=False, device=device)


def build_motion_vae(args, device=None) -> LAVAE:
    """Motion conv VAE (model/pretrained/myvqvae.py topology): channels =
    input_dim, latent grid = flow_dim, exact-length decode."""
    return LAVAE(in_channels=args.input_dim,
                 num_hiddens=getattr(args, "block_hidden_size", 128),
                 num_residual_layers=getattr(args, "num_residual_layers", 3),
                 num_residual_hiddens=getattr(args, "res_hidden_size", 256),
                 embedding_dim=getattr(args, "embedding_dim", 64),
                 latent_grid=args.flow_dim,
                 exact_length_output=True, device=device)


def batch_seed(seed: int, index: int) -> int:
    """The seed of draw ``index`` under run seed ``seed``: ``index`` folded
    into ``root_key(seed)``, as the JAX CLIs do. A run that resumes at an
    optimizer step draws what the uninterrupted run would have."""
    return step_key(root_key(seed), index)
