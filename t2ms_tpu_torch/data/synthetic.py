"""Synthetic T2S corpus for tests and the on-card smoke (counterpart of
t2ms_tpu/data/synthetic.py ``write_t2s_csv``).

The reference assumes downloaded corpora (TSFragment-600K CSVs); this
writes a file in exactly that format, from the same draws and with the
same text as the JAX package's writer, through the ``csv`` module in
place of pandas. ``write_motion_dataset`` comes with the motion track.
"""

from __future__ import annotations

import csv
import os

import numpy as np

__all__ = ["write_t2s_csv"]


def _trend_series(rng: np.random.Generator, T: int) -> np.ndarray:
    t = np.linspace(0, 1, T)
    kind = rng.integers(0, 4)
    base = {
        0: np.sin(2 * np.pi * rng.uniform(1, 4) * t),
        1: t * rng.uniform(-2, 2),
        2: np.exp(-t * rng.uniform(1, 5)),
        3: np.cumsum(rng.standard_normal(T)) * 0.1,
    }[int(kind)]
    return base + 0.05 * rng.standard_normal(T)


def write_t2s_csv(path: str, n: int = 64, T: int = 24, emb_dim: int = 128,
                  seed: int = 0, mmd_style: bool = False) -> str:
    """Emit an embedding_cleaned_*.csv with Text / OT / TextEmbedding
    columns matching the reference parser (datafactory/dataset.py:72-96):
    the embedding as a comma literal (``mmd_style``) or a space-separated
    dump."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["Text", "OT", "TextEmbedding"])
        for i in range(n):
            series = _trend_series(rng, T)
            emb = rng.standard_normal(emb_dim).astype(np.float32)
            emb /= np.linalg.norm(emb)
            if mmd_style:
                emb_str = str([float(f"{v:.6f}") for v in emb])
            else:
                emb_str = "[" + " ".join(f"{v:.6f}" for v in emb) + "]"
            w.writerow([f"synthetic trend caption {i}",
                        str([float(f"{v:.6f}") for v in series]), emb_str])
    return path
