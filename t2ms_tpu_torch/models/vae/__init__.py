"""LA-VAE and the TSae."""

from t2ms_tpu_torch.models.vae.lavae import (LAVAE, lavae_loss,
                                             smooth_l1_temporal_loss)
from t2ms_tpu_torch.models.vae.tsae import (DropoutDraws, TSae,
                                            TSaeDiffusion,
                                            tsae_adapter_loss, tsae_loss)

__all__ = ["LAVAE", "lavae_loss", "smooth_l1_temporal_loss", "TSae",
           "TSaeDiffusion", "DropoutDraws", "tsae_adapter_loss",
           "tsae_loss"]
