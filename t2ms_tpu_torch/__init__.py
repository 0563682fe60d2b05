"""t2ms_tpu_torch — the PyTorch / CUDA port of t2ms_tpu for NVIDIA Hopper.

The JAX package ``t2ms_tpu`` is the reference; this package reproduces its
serving and training paths in PyTorch, with every TPU (Pallas) kernel on
those paths rewritten by hand as a CUDA C++ kernel for ``sm_90a``. It imports torch and
numpy only: never jax, and nothing from ``t2ms_tpu`` or ``tools``.

Layout (mirrors t2ms_tpu):
  ops/                  resize-as-matmul, conv1d, attention oracles, the
                        fused DiT stack and block, forward and backward
                        (CUDA kernels + plain twins), build
  models/vae/           LA-VAE
  models/backbones/     rectified flow, DDPM
  models/denoisers/     eager DiT + the fused serving and training
                        forwards (dit_fast); the MLP denoiser
  sampling/             CFG sampler (euler / heun / midpoint; DDPM
                        ancestral / ddim)
  serving/              dynamic-batching ServingEngine
  training/             AdamW with optax's semantics and schedules, the
                        denoiser and LA-VAE train steps, checkpoints on
                        torch files, EMA, the scaling plan
  data/                 the T2S CSV corpora, length-bucketed batches,
                        prefetch to the device
  cli/                  ``python -m t2ms_tpu_torch.cli.train`` / ``.infer``
                        / ``.serve`` (HTTP) / ``.pretrain_vae`` /
                        ``.evaluation``
  config.py, utils/, visualize/
                        artifact paths, step logs and the profiler hook,
                        the infer CLI's figures
  convert.py            JAX param tree / optax AdamW state -> port

Entry points take ``device=None``, which means CUDA; without a card they
raise unless the caller passes ``device="cpu"``. Kernels build at their
first CUDA call (``ops/_build.py``), never at import.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"
__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is requested but absent, so a
    caller never drops silently onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "t2ms_tpu_torch: CUDA is not available on this host; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
