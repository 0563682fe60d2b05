"""Motion (benchpress / deadlift) JSON datasets with length bucketing
(counterpart of t2ms_tpu/data/motion.py).

Reference: datafactory/benchpress/dataset.py and datafactory/deadlift/
dataset.py — per-subject/clip feature dicts in data.json, per-clip
caption.json with Summary + embeddings, length-consistency checks, and
train-time bucketing to {base, 2x, 4x} of split_base_num via per-sport
thresholds, resizing with adaptive-avg-pool (down) / linear interp (up).

Records are materialized once into per-bucket columnar numpy arrays
(fixed shapes per bucket) instead of ragged per-item Datasets. The
resizes use the same matrices as ``ops.resize``, which are the JAX
package's, so the port's records equal JAX's bit for bit.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from t2ms_tpu_torch.ops.resize import (_adaptive_avg_pool_matrix_np,
                                 _linear_resize_matrix_np)

__all__ = ["MotionRecord", "load_motion_records", "map_target_len",
           "reference_random_split", "SPORT_SPECS"]


# per-sport feature handling, bucketing thresholds, caption schema
SPORT_SPECS = {
    "benchpress": dict(
        drop_features=("feature_0", "feature_1", "feature_2"),
        # benchpress/dataset.py:100-117: 36 if T<58; 72 if 58<=T<78;
        # 144 if T>=78
        base=36,
        thresholds=(58, 78),
        min_len=0,
        caption_fields=("Prefix_embedding", "Summary_embedding"),
    ),
    "deadlift": dict(
        drop_features=(),
        # deadlift/dataset.py:97-114: 48 if T<81; 96 if 81<=T<99; 192 if >=99
        base=48,
        thresholds=(81, 99),
        min_len=10,     # skip clips with T<10 (deadlift/dataset.py:70-72)
        caption_fields=("embedding",),
    ),
}


def map_target_len(sport: str, T: int, target_T: int) -> int:
    """Return target_T if clip length T falls in target_T's band, else 0
    (reference _map_target_len)."""
    spec = SPORT_SPECS[sport]
    base, (lo, hi) = spec["base"], spec["thresholds"]
    if target_T == base:
        return target_T if T < lo else 0
    if target_T == base * 2:
        return target_T if lo <= T < hi else 0
    if target_T == base * 4:
        return target_T if T >= hi else 0
    raise ValueError(f"Undefined length {target_T} for {sport}.")


def _resize_np(x: np.ndarray, out_len: int) -> np.ndarray:
    """adaptive-avg-pool down / linear-interp up on host numpy
    (benchpress/dataset.py:79-87)."""
    T = x.shape[-1]
    if T == out_len:
        return x
    mat = (_adaptive_avg_pool_matrix_np(T, out_len) if T > out_len
           else _linear_resize_matrix_np(T, out_len))
    return (x @ mat).astype(np.float32)


@dataclass
class MotionRecord:
    text: str
    x: np.ndarray                        # (n_f, T) float32
    embeddings: Tuple[np.ndarray, ...]   # per caption_fields order
    subject: str
    clip: str


def load_motion_records(sport: str, json_path: str, caption_root: str,
                        period: str, data_dim: int) -> List[MotionRecord]:
    """Load and (for train) bucket-filter + resize all clips for one target
    length.

    period='train': keep only clips in data_dim's band, resized to data_dim.
    period='test': keep every valid clip at its native length."""
    spec = SPORT_SPECS[sport]
    with open(json_path, "r", encoding="utf-8") as f:
        all_data = json.load(f)
    records: List[MotionRecord] = []
    for subject, clips in all_data.items():
        for clip, feat_dict in clips.items():
            cap_path = os.path.join(caption_root, subject, clip,
                                    "caption.json")
            with open(cap_path, "r", encoding="utf-8") as f:
                cap = json.load(f)
            text = cap["Summary"]
            embs = tuple(np.asarray(cap[k], dtype=np.float32)
                         for k in spec["caption_fields"])

            seqs, lens = [], []
            for k, v in feat_dict.items():
                if k in spec["drop_features"]:
                    continue
                arr = np.asarray(v, dtype=np.float32)
                if arr.ndim != 1:
                    raise ValueError(
                        f"Feature '{k}' must be [T], got {arr.shape}")
                seqs.append(arr)
                lens.append(arr.shape[0])
            if len(set(lens)) != 1:
                continue  # inconsistent clip, skipped like the reference
            T = lens[0]
            if T < spec["min_len"]:
                continue
            x = np.stack(seqs, axis=0)
            if period == "train":
                tgt = map_target_len(sport, T, data_dim)
                if not tgt:
                    continue
                x = _resize_np(x, tgt)
            records.append(MotionRecord(text, x, embs, subject, clip))
    return records


def reference_random_split(n: int, seed: int, r_train: float = 0.9):
    """Reproduce torch.utils.data.random_split([0.9, 0.1],
    Generator().manual_seed(seed)) index sets (benchpress/dataloader.py:89-93):
    floor lengths, remainder distributed round-robin, torch randperm stream."""
    fracs = (r_train, 1.0 - r_train)
    lengths = [int(np.floor(n * f)) for f in fracs]
    rem = n - sum(lengths)
    for i in range(rem):
        lengths[i % len(lengths)] += 1
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g).tolist()
    return perm[:lengths[0]], perm[lengths[0]:lengths[0] + lengths[1]]
