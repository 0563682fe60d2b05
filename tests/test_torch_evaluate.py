"""The port's host evaluation (``t2ms_tpu_torch.evaluate``: the metrics,
the feature measures, FID, DTW) and ``smooth_l1_temporal_loss`` held to
the JAX package's on the same seeded inputs on the CPU; the port's native
loader (its own build directory, a failed build raises); the wavefront
DTW against the numpy DP; and ``cli.metrics_experiment`` against JAX's.

Tolerances: the copied numpy/scipy code 1e-12 relative in f64; DTW in f64
1e-12 relative (the wavefront sums each frame's cost in another order),
the f32 wavefront against JAX's f32 wavefront 1e-5;
``smooth_l1_temporal_loss`` in f32 1e-6 relative."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.cli import metrics_experiment as jexp
from t2ms_tpu.evaluate import dtw as jdtw
from t2ms_tpu.evaluate import feature_measures as jfm
from t2ms_tpu.evaluate import fid as jfid
from t2ms_tpu.evaluate import metrics as jmetrics
from t2ms_tpu.models.vae.lavae import \
    smooth_l1_temporal_loss as j_smooth_l1
from t2ms_tpu.utils import logging as jlogging
from t2ms_tpu_torch.cli import metrics_experiment as texp
from t2ms_tpu_torch.evaluate import dtw as tdtw
from t2ms_tpu_torch.evaluate import feature_measures as tfm
from t2ms_tpu_torch.evaluate import fid as tfid
from t2ms_tpu_torch.evaluate import metrics as tmetrics
from t2ms_tpu_torch.models.vae import smooth_l1_temporal_loss
from t2ms_tpu_torch.utils import logging as tlogging
from t2ms_tpu_torch.utils import native

RNG = np.random.default_rng(0)
ORI = RNG.standard_normal((6, 24, 3))
GEN = ORI + 0.3 * RNG.standard_normal((6, 24, 3))
# generations with the best match away from index 0 exercise MRR's
# rank-is-generation-order quirk
GEN_MULTI = np.stack([ORI + s * RNG.standard_normal(ORI.shape)
                      for s in (1.5, 0.9, 0.2, 1.1, 0.6)], axis=-1)
ACTS = (RNG.standard_normal((60, 8)), 0.5 + RNG.standard_normal((60, 8)))
FLAT_TRUE = RNG.standard_normal((5, 12))
FLAT_GEN = FLAT_TRUE[:, None] + RNG.standard_normal((5, 10, 12))


def _eq(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("mod,name,args", [
    ("metrics", "calculate_mse", (ORI, GEN)),
    ("metrics", "calculate_wape", (ORI, GEN)),
    ("metrics", "calculate_ed", (ORI, GEN)),
    ("metrics", "calculate_crps", (ORI, GEN_MULTI)),
    ("metrics", "calculate_mrr", (ORI, GEN_MULTI)),
    ("metrics", "calculate_mrr", (ORI, GEN_MULTI, 3, 0.9)),
    ("metrics", "mrr_at_10", (FLAT_TRUE, FLAT_GEN, 0.5)),
    ("metrics", "wape", (ORI[0], GEN[0])),
    ("metrics", "calculate_correlational_score", (ORI, GEN)),
    ("metrics", "sequence_correlation", (ORI[0], GEN[1])),
    ("metrics", "calculate_sequence_correlation", (ORI, GEN)),
    ("metrics", "normalize_per_row", (GEN[0].T,)),
    ("metrics", "min_max_normalize_columns", (GEN[0],)),
    ("metrics", "zscore_normalize_columns", (GEN[0],)),
    ("feature_measures", "calculate_acd", (ORI, GEN)),
    ("feature_measures", "calculate_sd", (ORI, GEN)),
    ("feature_measures", "calculate_kd", (ORI, GEN)),
    ("feature_measures", "calculate_mdd", (ORI, GEN)),
    ("fid", "calculate_fid", ACTS),
])
def test_host_metrics_match_jax(mod, name, args):
    jmod = {"metrics": jmetrics, "feature_measures": jfm, "fid": jfid}[mod]
    tmod = {"metrics": tmetrics, "feature_measures": tfm, "fid": tfid}[mod]
    want = getattr(jmod, name)(*[np.copy(a) for a in args])
    got = getattr(tmod, name)(*[np.copy(a) for a in args])
    _eq(got, want)
    if name == "calculate_mrr":
        assert 0.0 <= got <= 1.0


def test_min_max_scaler_matches_jax():
    j, t = jmetrics.MinMaxScaler(), tmetrics.MinMaxScaler()
    _eq(t.fit_transform(GEN[0]), j.fit_transform(GEN[0]))
    _eq(t.inverse_transform(GEN[1]), j.inverse_transform(GEN[1]))


A, B = RNG.standard_normal((20, 3)), RNG.standard_normal((17, 3))


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("a,b", [(A, B), (A[:, 0], B[:, 0])])
def test_dtw_pairs_match_jax(a, b, window):
    want = jdtw.dtw_numpy(a, b, window)
    assert tdtw.dtw_numpy(a, b, window) == want
    got = tdtw.dtw_native(a, b, window)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(jdtw.dtw_native(a, b, window), rel=1e-12)
    wf = tdtw.dtw_wavefront(torch.from_numpy(a), torch.from_numpy(b),
                            window)
    assert wf.dtype == torch.float64
    assert float(wf) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("shape", [(5, 24, 2), (5, 24)])
def test_calculate_dtw_matches_jax(shape, window):
    r = np.random.default_rng(len(shape) + window)
    ori, gen = r.standard_normal(shape), r.standard_normal(shape)
    got = tdtw.calculate_dtw(ori, gen, window)
    assert got == pytest.approx(jdtw.calculate_dtw(ori, gen, window),
                                rel=1e-12)
    with pytest.raises(ValueError, match="batch mismatch"):
        tdtw.calculate_dtw(ori, gen[:4], window)


@pytest.mark.parametrize("window", [0, 2, 5])
@pytest.mark.parametrize("T1,T2,D", [(24, 24, 7), (30, 21, 1), (9, 16, 2)])
def test_wavefront_batch_matches_the_dp(T1, T2, D, window):
    r = np.random.default_rng(T1 + T2 + D)
    a, b = r.standard_normal((4, T1, D)), r.standard_normal((4, T2, D))
    got = tdtw.dtw_wavefront_batch(torch.from_numpy(a), torch.from_numpy(b),
                                   window).numpy()
    want = [tdtw.dtw_numpy(x, y, window) for x, y in zip(a, b)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    if window == 0:
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        got32 = tdtw.dtw_wavefront_batch(torch.from_numpy(a32),
                                         torch.from_numpy(b32)).numpy()
        np.testing.assert_allclose(
            got32, np.asarray(jdtw.dtw_jax_batch(jnp.asarray(a32),
                                                 jnp.asarray(b32))),
            rtol=1e-5)


def test_native_builds_in_its_own_directory():
    lib = native.load_native()
    assert os.path.dirname(lib._name) == native.build_dir()
    assert native.build_dir().endswith(
        os.path.join("build", "t2ms_tpu_torch", "native"))
    assert not os.path.dirname(lib._name).startswith(native.native_dir())


def test_native_build_failure_raises(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "native_dir", lambda: str(src))
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.load_native()
    with pytest.raises(RuntimeError, match="native build failed"):
        tdtw.dtw_native(A, B)
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "out"))


@pytest.mark.parametrize("lam", [0.1, 0.7])
def test_smooth_l1_temporal_loss_matches_jax(lam):
    r = np.random.default_rng(int(lam * 10))
    x = (2 * r.standard_normal((3, 2, 24))).astype(np.float32)
    y = (2 * r.standard_normal((3, 2, 24))).astype(np.float32)
    want = float(j_smooth_l1(jnp.asarray(x), jnp.asarray(y), lam))
    got = float(smooth_l1_temporal_loss(torch.from_numpy(x),
                                        torch.from_numpy(y), lam))
    assert got == pytest.approx(want, rel=1e-6)


def _merged_layout(root, seed, n_files=3):
    r = np.random.default_rng(seed)
    d = root / "filtered_norm"
    d.mkdir(parents=True)
    for i in range(1, n_files + 1):
        rows = r.standard_normal((10 + i, 3))
        (d / f"merged_{i}.txt").write_text(
            "\n".join(",".join(f"{v:.6f}" for v in row) for row in rows))
    return str(root)


@pytest.mark.parametrize("rival", [False, True])
def test_metrics_experiment_matches_jax(tmp_path, rival):
    root = _merged_layout(tmp_path / "a", 1)
    other = _merged_layout(tmp_path / "b", 2) if rival else root
    args = (("filtered_norm",), 3)
    want = jexp.run_experiment(root, other, str(tmp_path / "jax"), *args)
    got = texp.run_experiment(root, other, str(tmp_path / "port"), *args)
    assert sorted(got) == sorted(want) and len(got) == 5
    for key, arr in want.items():
        assert got[key].shape == arr.shape == ((3, 2) if not rival
                                               else (3, 3))
        np.testing.assert_allclose(got[key], arr, rtol=1e-12, err_msg=key)
    assert os.path.exists(tmp_path / "port" / "dtw" /
                          "filtered_norm_result.jpg")


def test_metrics_experiment_main(tmp_path, capsys):
    root = _merged_layout(tmp_path / "a", 3)
    texp.main(["--root", root, "--out_dir", str(tmp_path / "out"),
               "--variants", "filtered_norm", "--n_files", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        f"filtered_norm {m}" for m in ("mse", "wape", "correlational_score",
                                       "dtw", "sequence_correlation")]


def test_logging_helpers_match_jax(tmp_path, capsys):
    outs = []
    for mod, name in ((jlogging, "jax"), (tlogging, "port")):
        mod.show_with_start_divider("start")
        mod.show_with_end_divider("end")
        mod.write_json_data({"MSE": 0.5}, str(tmp_path / name / "r.json"))
        assert mod.plot_loss_curve([], str(tmp_path / name)) is None
        mod.plot_loss_curve([3.0, 2.0, 1.5], str(tmp_path / name))
        outs.append(capsys.readouterr().out.replace(str(tmp_path / name),
                                                    "DIR"))
    assert outs[0] == outs[1]
    assert outs[1].startswith("=" * 20 + "\nstart\nend\n" + "=" * 20)
    for name in ("jax", "port"):
        assert (tmp_path / name / "r.json").read_text() == (
            tmp_path / "jax" / "r.json").read_text()
        assert os.path.exists(tmp_path / name / "loss_curve.png")
