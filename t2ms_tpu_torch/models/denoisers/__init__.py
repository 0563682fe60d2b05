"""Denoisers: the eager DiT and its fused serving and training forwards."""

from t2ms_tpu_torch.models.denoisers.dit import DiT

__all__ = ["DiT"]
