"""Training: optimizers and schedules, the denoiser and LA-VAE steps."""

from t2ms_tpu_torch.training.optim import (ScheduledAdamW, onecycle_adamw,
                                           onecycle_schedule, vae_schedule,
                                           warmup_cosine_adamw)
from t2ms_tpu_torch.training.trainer import (encode_with_vae,
                                             make_denoiser_train_step,
                                             make_vae_train_step,
                                             precompute_latent_buckets)

__all__ = ["ScheduledAdamW", "onecycle_adamw", "onecycle_schedule",
           "vae_schedule", "warmup_cosine_adamw", "encode_with_vae",
           "make_denoiser_train_step", "make_vae_train_step",
           "precompute_latent_buckets"]
