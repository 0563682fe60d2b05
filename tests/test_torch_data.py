"""The port's T2S data path held to the JAX package on the CPU, bit for
bit: ``load_t2s_csv`` on both embedding literal forms and on a ragged
``TSL`` table, ``split_indices``, ``BucketBatcher``'s batch order over two
epochs (one process and a sliced multi-process stream), the
``t2s_loader_provider`` batches, the port's ``write_t2s_csv`` read back by
the JAX loader, ``FakeEmbedder`` and ``precompute_latent_buckets``; and
``prefetch_to_device`` on the CPU. Every test of the port's loader runs
with pandas hidden (removed from ``sys.modules`` and made unimportable):
the card's machine has no pandas."""

import argparse
import builtins
import csv
import os
import sys

import numpy as np
import pytest
import torch

from t2ms_tpu.data import loaders as jloaders
from t2ms_tpu.data import provider as jprovider
from t2ms_tpu.data import t2s as jt2s
from t2ms_tpu.data.embedder import FakeEmbedder as JFakeEmbedder
from t2ms_tpu.data.synthetic import write_t2s_csv as j_write_t2s_csv
from t2ms_tpu_torch.data import embedder, loaders, provider, t2s
from t2ms_tpu_torch.data.prefetch import prefetch_to_device
from t2ms_tpu_torch.data.registry import DATA_DICT, csv_path_for
from t2ms_tpu_torch.data.synthetic import write_t2s_csv


class _Hidden:
    """pandas out of sys.modules and unimportable; ``jax(fn, ...)`` runs
    a JAX-package function, which needs pandas, with it back in place."""

    def __init__(self):
        self.mods = {m: sys.modules[m] for m in list(sys.modules)
                     if m == "pandas" or m.startswith("pandas.")}
        self.real = builtins.__import__

    def guarded(self, name, *a, **kw):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError("pandas is hidden from the port's data path")
        return self.real(name, *a, **kw)

    def hide(self):
        for m in self.mods:
            sys.modules.pop(m, None)
        builtins.__import__ = self.guarded

    def show(self):
        sys.modules.update(self.mods)
        builtins.__import__ = self.real

    def jax(self, fn, *a, **kw):
        self.show()
        try:
            return fn(*a, **kw)
        finally:
            self.hide()


@pytest.fixture(autouse=True)
def no_pandas():
    h = _Hidden()
    h.hide()
    try:
        yield h
    finally:
        h.show()


def _jax(no_pandas, fn, *a, **kw):
    return no_pandas.jax(fn, *a, **kw)


def _equal(a, b):
    assert a.texts == b.texts and a.name == b.name
    assert a.samples.dtype == b.samples.dtype
    assert a.embeddings.dtype == b.embeddings.dtype
    if a.samples.dtype == object:
        assert len(a.samples) == len(b.samples)
        for x, y in zip(a.samples, b.samples):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(a.samples, b.samples)
    np.testing.assert_array_equal(a.embeddings, b.embeddings)


def test_pandas_is_hidden():
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    assert "pandas" not in sys.modules


@pytest.mark.parametrize("mmd_style", [False, True])
@pytest.mark.parametrize("period", ["train", "test"])
def test_load_t2s_csv_equals_jax(tmp_path, no_pandas, mmd_style, period):
    path = str(tmp_path / "embedding_cleaned_ETTh1_48.csv")
    write_t2s_csv(path, n=150, T=48, seed=7, mmd_style=mmd_style)
    want = _jax(no_pandas, jt2s.load_t2s_csv, "embedding_cleaned_ETTh1_48",
                str(tmp_path), period)
    got = t2s.load_t2s_csv("embedding_cleaned_ETTh1_48", str(tmp_path),
                           period)
    _equal(got, want)
    assert got.samples.dtype == np.float32 and got.length == 48


def test_write_t2s_csv_is_read_by_jax_as_written_by_jax(tmp_path, no_pandas):
    """The port's writer gives the JAX writer's file byte for byte, and the
    JAX loader reads it as the port's loader does."""
    for mmd in (False, True):
        mine = str(tmp_path / f"p{int(mmd)}.csv")
        theirs = str(tmp_path / f"j{int(mmd)}.csv")
        write_t2s_csv(mine, n=120, T=24, seed=3, mmd_style=mmd)
        _jax(no_pandas, j_write_t2s_csv, theirs, n=120, T=24, seed=3,
             mmd_style=mmd)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        for period in ("train", "test"):
            _equal(t2s.load_t2s_csv(f"p{int(mmd)}", str(tmp_path), period),
                   _jax(no_pandas, jt2s.load_t2s_csv, f"p{int(mmd)}",
                        str(tmp_path), period))


@pytest.mark.parametrize("ragged", [True, False])
def test_tsl_rows_equal_jax(tmp_path, no_pandas, ragged):
    """TSL tables stay unscaled; ragged rows become an object array."""
    rng = np.random.default_rng(1)
    path = tmp_path / "embedding_cleaned_TSL_x.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["Text", "OT", "TextEmbedding"])
        for i in range(120):
            n = int(rng.integers(5, 9)) if ragged else 6
            w.writerow([f"cap {i}", str([round(float(v), 5) for v in
                                         rng.standard_normal(n) * 3]),
                        "[" + " ".join(f"{v:.6f}" for v in
                                       rng.standard_normal(16)) + "]"])
    for period in ("train", "test"):
        got = t2s.load_t2s_csv("embedding_cleaned_TSL_x", str(tmp_path),
                               period)
        assert (got.samples.dtype == object) == ragged
        _equal(got, _jax(no_pandas, jt2s.load_t2s_csv,
                         "embedding_cleaned_TSL_x", str(tmp_path), period))


def test_parse_literal_rows_forms_and_ragged_refusal():
    rows = ["[1.5, -2.0, 3e-3]", "[4 5.25 6]", "[ 7,8 , 9 ]"]
    np.testing.assert_array_equal(
        t2s.parse_literal_rows(rows),
        np.array([[1.5, -2.0, 3e-3], [4, 5.25, 6], [7, 8, 9]]))
    with pytest.raises(ValueError, match="row 1 holds 2 values"):
        t2s.parse_literal_rows(["[1, 2, 3]", "[1, 2]"])


@pytest.mark.parametrize("size,ratio,seed", [(100, 0.99, 123),
                                             (2100, 0.99, 123),
                                             (37, 0.5, 7)])
def test_split_indices_equal_jax(size, ratio, seed):
    for a, b in zip(t2s.split_indices(size, ratio, seed),
                    jt2s.split_indices(size, ratio, seed)):
        np.testing.assert_array_equal(a, b)


def _buckets(rng):
    return {L: dict(x=rng.standard_normal((n, L)).astype(np.float32),
                    embedding=rng.standard_normal((n, 8)).astype(np.float32),
                    texts=[f"{L}-{i}" for i in range(n)])
            for L, n in ((24, 23), (48, 17), (96, 9))}


def _stream(b, epochs=(0, 1)):
    return [(x.bucket, x.x, x.embedding, x.texts,
             None if x.valid is None else x.valid.tolist())
            for e in epochs for x in b.epoch(e)]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("procs", [None, (1, 3)])
def test_bucket_batcher_order_equals_jax(drop_last, procs):
    """The same seed gives the same batches in the same order over two
    epochs, one process or a process's slice of the global stream (a
    wrapped tail flagged invalid)."""
    bk = _buckets(np.random.default_rng(0))
    pi, pc = procs or (0, 1)
    kw = dict(process_index=pi, process_count=pc)
    mine = loaders.BucketBatcher(bk, 4, seed=5, drop_last=drop_last, **kw)
    theirs = jloaders.BucketBatcher(bk, 4, seed=5, drop_last=drop_last, **kw)
    assert len(mine) == len(theirs) and mine.num_buckets == 3
    a, b = _stream(mine), _stream(theirs)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[3] == y[3] and x[4] == y[4]
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[2], y[2])
    if procs is None:
        # no topology given: one process, as the JAX batcher on one host
        assert _stream(loaders.BucketBatcher(bk, 4, seed=5,
                                             drop_last=drop_last))[0][3] \
            == a[0][3]


def test_t2s_loader_provider_equals_jax(tmp_path, no_pandas):
    data = tmp_path / "Data"
    for L in (24, 48, 96):
        write_t2s_csv(str(data / "TSFragment-600K" /
                          f"embedding_cleaned_ETTh1_{L}.csv"), n=60, T=L,
                      seed=L)
        write_t2s_csv(str(data / "our" / f"embedding_cleaned_ETTh1_{L}.csv"),
                      n=200, T=L, seed=L + 1)
    cases = [(dict(dataset_name="ETTh1", mix_train=True, batch_size=8),
              "train"),
             (dict(dataset_name="ETTh1_24", mix_train=False, batch_size=2),
              "test")]
    for kw, period in cases:
        args = argparse.Namespace(data_root=str(data), general_seed=2025,
                                  **kw)
        d_mine, b_mine = provider.t2s_loader_provider(args, period)
        d_theirs, b_theirs = _jax(no_pandas, jprovider.t2s_loader_provider,
                                  args, period)
        for a, b in zip(d_mine, d_theirs):
            _equal(a, b)
        sa, sb = _stream(b_mine), _stream(b_theirs)
        assert len(sa) == len(sb) > 0
        for x, y in zip(sa, sb):
            assert x[0] == y[0] and x[3] == y[3]
            np.testing.assert_array_equal(x[1], y[1])


def test_registry_paths():
    assert DATA_DICT["ETTh1_24"] == "embedding_cleaned_ETTh1_24"
    assert csv_path_for("ETTh1", "D", mix_train=True) == os.path.join(
        "D", "TSFragment-600K")
    assert csv_path_for("ETTh1_24", "D") == os.path.join("D", "our")
    with pytest.raises(ValueError, match="bare family"):
        csv_path_for("ETTh1_24", "D", mix_train=True)


def test_fake_embedder_equals_jax(no_pandas):
    texts = ["a caption", "another one", ""]
    got = embedder.get_embedder("fake", 32).embed(texts)
    want = _jax(no_pandas, JFakeEmbedder(32).embed, texts)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    with pytest.raises(RuntimeError, match="expects embeddings"):
        embedder.get_embedder("precomputed").embed(texts)


def test_precompute_latent_buckets_encodes_each_row_once():
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.training.trainer import precompute_latent_buckets
    torch.manual_seed(0)
    vae = LAVAE(1, 16, 1, 16, 8, 6, device="cpu")
    bk = _buckets(np.random.default_rng(2))
    b = loaders.BucketBatcher(bk, 4, seed=1)
    got = precompute_latent_buckets(vae, b, chunk=5)
    assert got.batch_size == 4 and got.seed == 1
    for L, data in bk.items():
        with torch.no_grad():
            want = vae.encode(torch.from_numpy(data["x"]))[0].numpy()
        np.testing.assert_allclose(got.buckets[L]["x"], want, rtol=1e-6,
                                   atol=1e-6)
        assert got.buckets[L]["texts"] == data["texts"]
    assert precompute_latent_buckets(vae, b, max_bytes=10) is None


def test_prefetch_passes_batches_through_on_the_cpu():
    src = [np.full((2, 3), i, np.float32) for i in range(5)]
    out = list(prefetch_to_device(iter(src), transform=lambda a: (a, a * 2)))
    assert [int(b[0, 0]) for b, _ in out] == list(range(5))
    for b, (x, y) in out:
        assert torch.is_tensor(x) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), b)
        np.testing.assert_array_equal(y.numpy(), b * 2)


def test_prefetch_raises_the_producer_error_and_releases_the_worker():
    def bad():
        yield np.zeros(2)
        raise KeyError("boom")

    it = prefetch_to_device(bad())
    next(it)
    with pytest.raises(KeyError, match="boom"):
        next(it)
    # an abandoned consumer releases its worker
    it = prefetch_to_device(iter([np.zeros(2)] * 10), size=1)
    next(it)
    it.close()
