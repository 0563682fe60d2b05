"""Synthetic corpora for tests and the on-card smoke (counterpart of
t2ms_tpu/data/synthetic.py).

The reference assumes downloaded corpora (TSFragment-600K CSVs, motion
data.json + caption trees); these writers emit files in exactly those
formats, from the same draws and with the same text as the JAX package's
writers, the CSV through the ``csv`` module in place of pandas.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

__all__ = ["write_t2s_csv", "write_motion_dataset"]


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


def write_motion_dataset(root: str, sport: str = "benchpress",
                         n_subjects: int = 3, clips_per_subject: int = 6,
                         emb_dim: int = 128, seed: int = 0,
                         caption_dir: str = "Caption_synth") -> str:
    """Emit Data/<sport>/data.json + caption tree matching the motion
    datasets (datafactory/benchpress/dataset.py:27-41)."""
    rng = np.random.default_rng(seed)
    n_raw_features = {"benchpress": 13, "deadlift": 7}[sport]
    length_pool = {"benchpress": [40, 50, 60, 70, 80, 100],
                   "deadlift": [40, 70, 85, 95, 100, 120]}[sport]
    sport_root = os.path.join(root, sport)
    cap_root = os.path.join(sport_root, caption_dir)
    data = {}
    cats = ["correct", "tilting_to_the_right", "elbows_flaring"]
    for s in range(n_subjects):
        subject = f"{cats[s % len(cats)]}_subject_{s}"
        data[subject] = {}
        for c in range(clips_per_subject):
            clip = f"clip_{c:03d}"
            T = int(length_pool[(s * clips_per_subject + c)
                                % len(length_pool)])
            feats = {}
            for f in range(n_raw_features):
                feats[f"feature_{f}"] = [float(v) for v in
                                         _trend_series(rng, T)]
            data[subject][clip] = feats
            cap = {"Summary": f"synthetic {sport} caption {subject}/{clip}"}
            if sport == "benchpress":
                for k in ("Prefix_embedding", "Summary_embedding"):
                    v = rng.standard_normal(emb_dim)
                    cap[k] = [float(x) for x in v / np.linalg.norm(v)]
            else:
                v = rng.standard_normal(emb_dim)
                cap["embedding"] = [float(x) for x in v / np.linalg.norm(v)]
            cdir = os.path.join(cap_root, subject, clip)
            os.makedirs(cdir, exist_ok=True)
            with open(os.path.join(cdir, "caption.json"), "w") as f:
                json.dump(cap, f)
    os.makedirs(sport_root, exist_ok=True)
    with open(os.path.join(sport_root, "data.json"), "w") as f:
        json.dump(data, f)
    return sport_root
