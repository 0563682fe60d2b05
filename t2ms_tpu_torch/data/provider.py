"""Loader provider for the T2S CSV track (counterpart of
t2ms_tpu/data/provider.py ``t2s_loader_provider``; the motion track's
provider comes with it).

Reference loader_provider semantics (datafactory/dataloader.py:79-113):
mix-train = the three length variants (24/48/96) interleaved; otherwise a
single CSV; root directory rules per dataset family. Outputs a
BucketBatcher (fixed shapes per bucket) instead of torch DataLoaders with
a ragged collate.
"""

from __future__ import annotations

from typing import List, Tuple

from t2ms_tpu_torch.data.loaders import BucketBatcher
from t2ms_tpu_torch.data.registry import DATA_DICT, csv_path_for
from t2ms_tpu_torch.data.t2s import T2SData, load_t2s_csv

__all__ = ["t2s_loader_provider"]


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
