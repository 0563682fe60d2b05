"""LA-VAE."""

from t2ms_tpu_torch.models.vae.lavae import (LAVAE, lavae_loss,
                                             smooth_l1_temporal_loss)

__all__ = ["LAVAE", "lavae_loss", "smooth_l1_temporal_loss"]
