"""Fixed-shape, length-bucketed batch streams (counterpart of
t2ms_tpu/data/loaders.py).

Each length bucket yields fixed-size batches (drop_last like the
reference train loaders, dataloader.py:98) and the epoch interleaves the
buckets' batches in a seeded shuffled order, so the same seed gives the
same batch order as the JAX package. The JAX package reads the process
topology from jax when none is passed; the port runs one process unless
``process_index``/``process_count`` are passed, which are honoured as
there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ArrayBatch", "BucketBatcher"]


@dataclass
class ArrayBatch:
    """One batch from a single length bucket."""
    x: np.ndarray                 # (B, ...) series
    embedding: np.ndarray         # (B, E)
    texts: List[str]
    bucket: int                   # series length of this bucket
    subjects: Optional[List[str]] = None
    extra_embedding: Optional[np.ndarray] = None  # e.g. summary embedding
    # (B,) bool, set only when a multi-process tail batch was wrap-padded:
    # the wrapped (duplicated) rows carry False; None = all rows real
    valid: Optional[np.ndarray] = None

    def __len__(self):
        return self.x.shape[0]


class BucketBatcher:
    """Epoch iterator over per-bucket columnar stores.

    buckets: dict length -> dict(x=(N,...), embedding=(N,E), texts=[...],
    subjects?/extra_embedding?). Each epoch: shuffle within buckets, emit
    fixed-size batches, interleave across buckets in shuffled order. With
    ``process_count`` > 1, ``batch_size`` is the global batch and process
    ``process_index`` keeps its contiguous slice of each batch."""

    def __init__(self, buckets: Dict[int, dict], batch_size: int,
                 seed: int = 0, drop_last: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.buckets = buckets
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count

    def _local_slice(self, idx: np.ndarray):
        """-> (local_idx, valid_mask-or-None)."""
        pc = self.process_count or 1
        pi = self.process_index or 0
        if pc <= 1:
            return idx, None
        # every process takes an equal slice: a tail batch that does not
        # divide is padded by wrapping, the wrapped rows flagged invalid
        per = -(-len(idx) // pc)
        if per * pc != len(idx):
            pad = np.resize(idx, per * pc)
            pos = np.arange(pi * per, (pi + 1) * per)
            return pad[pi * per:(pi + 1) * per], pos < len(idx)
        return idx[pi * per:(pi + 1) * per], None

    def __len__(self):
        n = 0
        for data in self.buckets.values():
            size = data["x"].shape[0]
            n += (size // self.batch_size if self.drop_last
                  else -(-size // self.batch_size))
        return n

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def epoch(self, epoch_idx: int = 0) -> Iterator[ArrayBatch]:
        rng = np.random.default_rng((self.seed, epoch_idx))
        slots: List[Tuple[int, np.ndarray]] = []
        for length, data in self.buckets.items():
            size = data["x"].shape[0]
            perm = rng.permutation(size)
            n_full = size // self.batch_size
            for b in range(n_full):
                slots.append((length, perm[b * self.batch_size:
                                           (b + 1) * self.batch_size]))
            if not self.drop_last and size % self.batch_size:
                slots.append((length, perm[n_full * self.batch_size:]))
        order = rng.permutation(len(slots))
        for i in order:
            length, idx = slots[i]
            idx, valid = self._local_slice(idx)
            data = self.buckets[length]
            yield ArrayBatch(
                x=data["x"][idx],
                embedding=data["embedding"][idx],
                texts=[data["texts"][j] for j in idx],
                bucket=length,
                subjects=([data["subjects"][j] for j in idx]
                          if "subjects" in data else None),
                extra_embedding=(data["extra_embedding"][idx]
                                 if "extra_embedding" in data else None),
                valid=valid,
            )

    @staticmethod
    def from_t2s(datasets: Sequence, batch_size: int, seed: int = 0,
                 drop_last: bool = True) -> "BucketBatcher":
        """Build from T2SData splits (one per length)."""
        buckets = {}
        for ds in datasets:
            buckets[ds.length] = dict(x=ds.samples, embedding=ds.embeddings,
                                      texts=ds.texts)
        return BucketBatcher(buckets, batch_size, seed, drop_last)

    @staticmethod
    def from_motion(records_by_bucket: Dict[int, list], batch_size: int,
                    seed: int = 0, drop_last: bool = True,
                    emb_index: int = 0) -> "BucketBatcher":
        """Build from {target_len: [MotionRecord,...]}. ``emb_index`` picks
        which caption embedding is the conditioning one (benchpress trains on
        Prefix_embedding — pretrained_mylavae.py:207-210 and mytrain.py:61
        consume the 3rd tuple slot)."""
        buckets = {}
        for length, recs in records_by_bucket.items():
            if not recs:
                continue
            buckets[length] = dict(
                x=np.stack([r.x for r in recs]),
                embedding=np.stack([r.embeddings[emb_index] for r in recs]),
                texts=[r.text for r in recs],
                subjects=[r.subject for r in recs],
            )
            if len(recs[0].embeddings) > 1:
                buckets[length]["extra_embedding"] = np.stack(
                    [r.embeddings[1] for r in recs])
        return BucketBatcher(buckets, batch_size, seed, drop_last)
