"""Loader providers (counterpart of t2ms_tpu/data/provider.py).

Reference loader_provider semantics:
  * T2S (datafactory/dataloader.py:79-113): mix-train = the three length
    variants (24/48/96) interleaved; otherwise a single CSV; root
    directory rules per dataset family.
  * Motion (datafactory/benchpress/dataloader.py:50-97): three bucket
    datasets over the same data.json, combined, then a seeded 0.9/0.1
    random split over the combined index space (torch RNG parity).

Outputs are BucketBatchers (fixed shapes per bucket) instead of torch
DataLoaders with a ragged collate.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from t2ms_tpu_torch.data.loaders import BucketBatcher
from t2ms_tpu_torch.data.motion import (MotionRecord, load_motion_records,
                                        reference_random_split)
from t2ms_tpu_torch.data.registry import DATA_DICT, csv_path_for
from t2ms_tpu_torch.data.t2s import T2SData, load_t2s_csv

__all__ = ["t2s_loader_provider", "motion_loader_provider"]


def t2s_loader_provider(args, period: str) -> Tuple[List[T2SData],
                                                    BucketBatcher]:
    """Reference loader_provider for the CSV track."""
    name = DATA_DICT[args.dataset_name]
    root = csv_path_for(args.dataset_name, getattr(args, "data_root",
                                                   "./Data"),
                        mix_train=args.mix_train)
    if args.mix_train and args.dataset_name != "SUSHI":
        datasets = [load_t2s_csv(f"{name}_{L}", root, period)
                    for L in (24, 48, 96)]
    else:
        datasets = [load_t2s_csv(name, root, period)]
    batcher = BucketBatcher.from_t2s(
        datasets, args.batch_size,
        seed=getattr(args, "general_seed", 2025),
        drop_last=(period == "train"))
    return datasets, batcher


def motion_loader_provider(args, period: str = "train"
                           ) -> Tuple[BucketBatcher, BucketBatcher]:
    """Reference motion loader_provider: returns (train, test) batchers.

    The combined record list's 0.9/0.1 split reproduces
    torch.random_split(seed=general_seed) over the same index space."""
    sport = args.dataset_name
    json_path = os.path.join(args.dataset_root, sport, "data.json")
    caption_root = os.path.join(args.dataset_root, sport, args.caption)
    base = args.split_base_num

    if period == "train":
        per_bucket = [load_motion_records(sport, json_path, caption_root,
                                          "train", base * m)
                      for m in (1, 2, 4)]
        combined: List[Tuple[int, MotionRecord]] = []
        for recs, mult in zip(per_bucket, (1, 2, 4)):
            combined.extend((base * mult, r) for r in recs)
    else:
        # reference test period: native lengths, data_dim 2*base (ignored
        # because period='test' skips bucketing)
        recs = load_motion_records(sport, json_path, caption_root, "test",
                                   base * 2)
        combined = [(r.x.shape[-1], r) for r in recs]

    train_idx, test_idx = reference_random_split(
        len(combined), args.general_seed)
    chosen = train_idx if period == "train" else test_idx

    by_bucket: Dict[int, list] = {}
    for i in chosen:
        length, rec = combined[i]
        by_bucket.setdefault(length, []).append(rec)

    emb_index = 0  # Prefix_embedding for benchpress, embedding for deadlift
    batcher = BucketBatcher.from_motion(
        by_bucket, args.batch_size, seed=args.general_seed,
        drop_last=(period == "train"), emb_index=emb_index)
    if period == "train":
        # test loader over the SAME train-mode dataset's 10% (reference
        # train branch returns both loaders from one dataset)
        test_bucket: Dict[int, list] = {}
        for i in test_idx:
            length, rec = combined[i]
            test_bucket.setdefault(length, []).append(rec)
        test_batcher = BucketBatcher.from_motion(
            test_bucket, args.batch_size, seed=args.general_seed,
            drop_last=False, emb_index=emb_index)
        return batcher, test_batcher
    # period='test' builds only the 10% split (native lengths); the
    # train slot is its 90% complement over the same record space so the
    # documented (train, test) contract holds for every period
    train_bucket: Dict[int, list] = {}
    for i in train_idx:
        length, rec = combined[i]
        train_bucket.setdefault(length, []).append(rec)
    train_batcher = BucketBatcher.from_motion(
        train_bucket, args.batch_size, seed=args.general_seed,
        drop_last=True, emb_index=emb_index)
    return train_batcher, batcher
