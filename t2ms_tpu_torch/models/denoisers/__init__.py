"""Denoisers: the eager DiT and its fused serving and training forwards,
and the MLP denoiser."""

from t2ms_tpu_torch.models.denoisers.dit import DiT
from t2ms_tpu_torch.models.denoisers.mlp import MLPDenoiser

__all__ = ["DiT", "MLPDenoiser"]
