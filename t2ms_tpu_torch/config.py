"""Reference-compatible path derivation and the framework's environment
knobs (counterpart of t2ms_tpu/config.py, less its yaml ``get_cfg``, which
comes with the motion track).

The reference CLIs derive checkpoint and generation directories from
``{backbone}_{denoiser}_{dataset}...`` tuples (train.py:153-157,
infer.py:144-146); the port keeps those schemas, so its artifacts land
where the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["denoiser_ckpt_dir", "generation_dir", "t2s_pretrained_dir",
           "FrameworkConfig"]


def denoiser_ckpt_dir(save_path: str, backbone: str, denoiser: str,
                      dataset_name: str, caption: Optional[str] = None,
                      pretrained_epc: Optional[int] = None) -> str:
    """T2S: {save}/checkpoints/{backbone}_{denoiser}_{dataset} (train.py:157).
    T2MS adds _{caption}_{pretrained_epc} (mytrain.py:115)."""
    if caption is None:
        name = f"{backbone}_{denoiser}_{dataset_name}"
    else:
        name = f"{backbone}_{denoiser}_{dataset_name}_{caption}_{pretrained_epc}"
    return os.path.join(save_path, "checkpoints", name)


def generation_dir(save_path: str, backbone: str, denoiser: str,
                   dataset_name: str, cfg_scale, total_step) -> str:
    """{save}/generation/{backbone}_{denoiser}_{dataset}_{cfg}_{steps}
    (infer.py:146, myinfer.py:243)."""
    name = f"{backbone}_{denoiser}_{dataset_name}_{cfg_scale}_{total_step}"
    return os.path.join(save_path, "generation", name)


def t2s_pretrained_dir(dataset_name: str, epochs: int = 2000) -> str:
    """VAE dir for the T2S track: results/saved_pretrained_models/
    dataset{root}_epoch{N} (train.py:155-156)."""
    root = dataset_name.split("_")[0]
    return os.path.join("results", "saved_pretrained_models",
                        f"dataset{root}_epoch{epochs}")


@dataclasses.dataclass
class FrameworkConfig:
    """Knobs read from the environment by the CLIs."""
    profile_dir: Optional[str] = None   # torch.profiler trace output

    @classmethod
    def from_env(cls) -> "FrameworkConfig":
        return cls(profile_dir=os.environ.get("T2MS_PROFILE_DIR") or None)
