"""T2S CSV dataset: parsing, scaling and the seeded train/test split
(counterpart of t2ms_tpu/data/t2s.py).

Reference: datafactory/dataset.py —
  * CSV columns: Text (caption), OT (series literal), TextEmbedding
    (128-d literal), parsed at dataset.py:72-96;
  * MinMax scaling over the whole table (dataset.py:81-82) unless the name
    contains 'TSL', whose rows may be ragged and stay unscaled;
  * the split: np.random.RandomState(seed).permutation, ceil(size*ratio)
    train ids (dataset.py:44-69).

The JAX package reads the CSV with pandas and parses the literals with a
native scanner; the port reads it with the ``csv`` module and parses the
literals with numpy (both literal forms: ``[a, b, ...]`` and
``[a b ...]``), so it needs neither. Both convert each decimal string to
the nearest float64, so the two loaders agree bit for bit.
"""

from __future__ import annotations

import csv
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = ["T2SData", "load_t2s_csv", "split_indices", "parse_literal_rows"]

_SEPARATORS = str.maketrans("[],", "   ")


def _tokens(r: str) -> List[str]:
    """The number tokens of one bracketed literal, comma- or
    space-separated (reference dataset.py:76, :84-94)."""
    return r.translate(_SEPARATORS).split()


def _parse_row(r) -> np.ndarray:
    if not isinstance(r, str):
        return np.asarray(r, np.float64)
    return np.asarray(_tokens(r), dtype=np.float64)


def parse_literal_rows(rows, row_len: Optional[int] = None) -> np.ndarray:
    """Parse a column of bracketed float-list literals into (N, L)
    float64; raises ValueError when a row's length is not L (the first
    row's by default)."""
    rows = list(rows)
    if row_len is None:
        row_len = len(_parse_row(rows[0]))
    toks = []
    for i, r in enumerate(rows):
        t = _tokens(r) if isinstance(r, str) else list(r)
        if len(t) != row_len:
            raise ValueError(f"row {i} holds {len(t)} values, want {row_len}")
        toks.extend(t)
    return np.asarray(toks, dtype=np.float64).reshape(len(rows), row_len)


def split_indices(size: int, ratio: float, seed: int = 123):
    """Reference divide() split ids (dataset.py:44-69)."""
    rs = np.random.RandomState(seed)
    n_train = int(np.ceil(size * ratio))
    perm = rs.permutation(size)
    return perm[:n_train], perm[n_train:]


@dataclass
class T2SData:
    """One split of a T2S CSV dataset."""
    samples: np.ndarray              # (N, T) float32
    texts: List[str]
    embeddings: np.ndarray           # (N, 128) float32
    name: str = ""
    bucket: Optional[int] = None     # series length tag for mix-train

    def __len__(self):
        return self.samples.shape[0]

    @property
    def length(self) -> int:
        return self.samples.shape[-1]


def _read_columns(path: str):
    """(texts, OT literals, TextEmbedding literals) of one CSV."""
    # a long series' literal can exceed the csv module's default 128 KB
    csv.field_size_limit(max(csv.field_size_limit(), sys.maxsize >> 32))
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return ([r["Text"] for r in rows], [r["OT"] for r in rows],
            [r["TextEmbedding"] for r in rows])


def load_t2s_csv(name: str, data_root: str, period: str = "train",
                 proportion: float = 0.99, seed: int = 123) -> T2SData:
    """Load + scale + split one CSV (reference T2SDataset.__init__)."""
    if period not in ("train", "test"):
        raise ValueError("period must be train or test")
    texts, ot, emb = _read_columns(os.path.join(data_root, name + ".csv"))
    if "TSL" in name.split("_"):
        # TSL rows may be RAGGED and are kept unscaled as an object array
        # (reference dataset.py:77-78 np.array(parsed, dtype=object))
        parsed = [_parse_row(r) for r in ot]
        if len({len(p) for p in parsed}) == 1:
            series = np.asarray(parsed, np.float64)
        else:
            series = np.empty(len(parsed), dtype=object)
            for i, p in enumerate(parsed):
                series[i] = p
    else:
        series = parse_literal_rows(ot)
        # MinMaxScaler fit/transform over columns (dataset.py:81-82)
        mn = series.min(axis=0)
        rng_ = series.max(axis=0) - mn
        rng_[rng_ == 0] = 1.0
        series = (series - mn) / rng_
    embeddings = parse_literal_rows(emb).astype(np.float32)

    tr, te = split_indices(series.shape[0], proportion, seed)
    idx = tr if period == "train" else te
    return T2SData(
        samples=(series[idx] if series.dtype == object
                 else series[idx].astype(np.float32)),
        texts=[texts[i] for i in idx],
        embeddings=embeddings[idx],
        name=name,
    )
