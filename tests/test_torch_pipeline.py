"""The port's copy of the dataset-construction pipeline
(``t2ms_tpu_torch.pipeline``) and its seed derivation
(``t2ms_tpu_torch.utils.prng``) held to the JAX package's on the CPU.

Each pipeline function runs in both packages on the same inputs, each in
a directory of its own, and must return the same values and write the
same files, byte for byte (the cases of the JAX package's
tests/test_pipeline.py and tests/test_mergers.py). The prng checks: the
name tag is JAX's, ``seed_everything`` leaves ``random`` and numpy in the
JAX package's state, the CLIs' ``batch_seed`` gives the seeds it gave
before it went through ``utils/prng``, and ``torch_seed`` makes two keys
draw apart on torch's CPU generator, which keeps a seed's low 32 bits."""

import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

import t2ms_tpu.pipeline as jpipe
import t2ms_tpu_torch.pipeline as tpipe
from t2ms_tpu.data.embedder import FakeEmbedder as JFakeEmbedder
from t2ms_tpu.data.t2s import load_t2s_csv as j_load_t2s_csv
from t2ms_tpu.pipeline import captions as jcap
from t2ms_tpu.pipeline import corpus as jcorpus
from t2ms_tpu.pipeline import embeddings as jemb
from t2ms_tpu.pipeline import mergers as jmerge
from t2ms_tpu.utils import prng as jprng
from t2ms_tpu_torch.cli._common import batch_seed
from t2ms_tpu_torch.data.embedder import FakeEmbedder
from t2ms_tpu_torch.data.t2s import load_t2s_csv
from t2ms_tpu_torch.pipeline import captions as tcap
from t2ms_tpu_torch.pipeline import corpus as tcorpus
from t2ms_tpu_torch.pipeline import embeddings as temb
from t2ms_tpu_torch.pipeline import mergers as tmerge
from t2ms_tpu_torch.utils import prng as tprng

BP_FEATURE = {f"feature_{i}": n for i, n in enumerate(
    ["bar_x", "bar_y", "barx/bar_y", "left_shoulder_y", "right_shoulder_y",
     "left_dist", "right_dist", "left_elbow", "left_shoulder", "right_elbow",
     "right_shoulder", "left_torso-arm", "right_torso-arm"])}
DL_FEATURE = {f"feature_{i}": n for i, n in enumerate(
    ["left_knee", "left_hip", "right_knee", "right_hip", "body_length",
     "left_torso-arm", "right_torso-arm"])}


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, fn):
    """fn(package modules, its own directory) in each package; returns the
    two (value, files) pairs."""
    out = []
    for name, mods in (("jax", (jcap, jcorpus, jemb, jmerge, jpipe)),
                       ("torch", (tcap, tcorpus, temb, tmerge, tpipe))):
        d = tmp_path / name
        d.mkdir()
        value = fn(*mods, d)
        out.append((value, _tree(d)))
    return out


def _same(tmp_path, fn):
    (vj, fj), (vt, ft) = _both(tmp_path, fn)
    assert vt == vj
    assert ft.keys() == fj.keys()
    for k in fj:
        assert ft[k] == fj[k], k
    return vt, ft


@pytest.mark.parametrize("case", [
    lambda m: m[1].sliding_windows(list(range(10)), 4),
    lambda m: m[1].cosine_similarity(np.array([1.0, 2.0]),
                                     np.array([-2.0, 0.5])),
    lambda m: m[1].cosine_similarity(np.array([1.0, 0.0]), np.zeros(2)),
    lambda m: m[1].select_best_captions({
        0: np.array([[1.0, 0.0], [1.0, 0.1], [-1.0, 0.0]]),
        3: np.array([[0.0, 1.0], [1.0, 0.0], [0.7, 0.7]])}),
    lambda m: m[1].trend_caption(m[4].FakeChat(), [0.5, 1.25, -3.0]),
    lambda m: [m[2].subject_classes(s) for s in
               ("x_correct_y", "nothing", "s_tilting_to_the_right_elbows")],
    lambda m: m[2].build_prefix(36, "correct"),
    lambda m: [m[3].perpendicular_distance(p, [0, 0], [2, 0])
               for p in ([1, 3], [5, -2])]
    + [m[3].perpendicular_distance([1, 1], [0, 0], [0, 0])],
    lambda m: m[3].wrist_to_shoulder_distances([[
        [0, 0], [2, 0], [0, -2], [2, -2], [0, -1], [2, -1], [0.5, -1.5],
        [1.5, -2.5]]]),
    lambda m: m[0].clip_caption(m[4].FakeChat(), {
        "f0": [1, 2], "f1": [2, 3], "f2": [1, 1], "f3": [0, 1]},
        {"f0": "first"}),
    lambda m: [m[4].FakeChat().complete("s", u) for u in
               ("Trend Analysis?", "JSON format", "pairs")],
    lambda m: m[4].FakeEmbed(16).embed("a caption"),
])
def test_pure_functions_match_jax(case):
    j = case((jcap, jcorpus, jemb, jmerge, jpipe))
    t = case((tcap, tcorpus, temb, tmerge, tpipe))
    assert json.dumps(t, sort_keys=True, default=str) == json.dumps(
        j, sort_keys=True, default=str)


def test_fake_embedder_delegates_to_fake_embed():
    texts = ["one", "two words", ""]
    np.testing.assert_array_equal(FakeEmbedder(32).embed(texts),
                                  JFakeEmbedder(32).embed(texts))
    np.testing.assert_array_equal(
        FakeEmbedder(8).embed(["x"])[0],
        np.asarray(tpipe.FakeEmbed(8).embed("x"), np.float32))


@pytest.mark.skipif(importlib.util.find_spec("openai") is not None,
                    reason="the gate shows only where openai is absent")
def test_openai_clients_stay_gated():
    for cls in ("OpenAIChat", "OpenAIEmbed"):
        with pytest.raises(ImportError):
            getattr(jpipe, cls)()
        with pytest.raises(ImportError):
            getattr(tpipe, cls)()


def test_with_retries_logs_like_jax(tmp_path, capsys):
    def run(llm, d):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 2:
                raise RuntimeError("boom")
            return "ok"
        log = str(d / "errors.txt")
        got = [llm.with_retries(flaky, 3, log, "a"),
               llm.with_retries(lambda: 1 / 0, 2, log, "b")]
        return got, capsys.readouterr().out

    from t2ms_tpu.pipeline import llm as jllm
    from t2ms_tpu_torch.pipeline import llm as tllm
    (dj := tmp_path / "j").mkdir()
    (dt := tmp_path / "t").mkdir()
    assert run(tllm, dt) == run(jllm, dj)
    assert _tree(dt) == _tree(dj)


def _motion_data(d):
    # one feature pair after the two skipped: the pairwise answers are
    # joined in completion order, which several pairs would make vary
    data = {"subj_correct": {"clip0": {
        "feature_0": [1.0, 2.0], "feature_1": [2.0, 3.0],
        "feature_2": [0.1, 0.2], "feature_3": [3.0, 1.0]}},
        "s_tilting_to_the_right_elbows_flaring": {
            "c0": {"feature_0": [1.0] * 7, "feature_1": [2.0] * 7}}}
    p = d / "data.json"
    p.write_text(json.dumps(data))
    return str(p)


def test_generate_and_enrich_captions_match_jax(tmp_path):
    def run(cap, corpus, emb, merge, pipe, d):
        data = _motion_data(d)
        out = str(d / "captions")
        n = [cap.generate_captions(pipe.FakeChat(), data, out,
                                   {"feature_0": "bar"},
                                   make_figures=False)]
        # resumable: a second run skips every clip
        n.append(cap.generate_captions(pipe.FakeChat(), data, out, {},
                                       make_figures=False))
        n.append(emb.enrich_captions(pipe.FakeEmbed(), data, out))
        return n

    (n, files) = _same(tmp_path, run)
    assert n == [2, 0, 2]
    cap = json.loads(files[os.path.join(
        "captions", "s_tilting_to_the_right_elbows_flaring", "c0",
        "caption.json")])
    assert len(cap["Summary_embedding"]) == 128
    assert "tilting to the right and elbows flaring" in cap["Prefix"]


def test_corpus_to_csv_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    series = np.sin(np.linspace(0, 20, 40)) + 0.1 * rng.standard_normal(40)

    def run(cap, corpus, emb, merge, pipe, d):
        out = str(d / "corpus")
        n = [corpus.generate_corpus(pipe.FakeChat(), pipe.FakeEmbed(),
                                    series, 24, out)]
        n.append(corpus.find_missing_ids(out))
        n.append(corpus.check_directory(out, 24))
        n.append(corpus.validate_sample_json(
            os.path.join(out, "data_sample_0_1.json"), 24))
        n.append(corpus.corpus_to_csv(
            out, str(d / "embedding_cleaned_synth_24.csv"), 24))
        n.append(corpus.generate_corpus(pipe.FakeChat(), pipe.FakeEmbed(),
                                        series, 24, out))
        (d / "none").mkdir()
        n.append(corpus.corpus_to_csv(str(d / "none"), str(d / "e.csv"), 24))
        return n

    n, _ = _same(tmp_path, run)
    assert n[0] == 16 and n[4] == 16 and n[5] == 0
    # the port's loader reads the port's CSV as JAX's reads JAX's
    got = load_t2s_csv("embedding_cleaned_synth_24", str(tmp_path / "torch"),
                       "train", proportion=0.9)
    want = j_load_t2s_csv("embedding_cleaned_synth_24",
                          str(tmp_path / "jax"), "train", proportion=0.9)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.embeddings, want.embeddings)
    assert got.samples.shape == (15, 24)


def test_validation_of_bad_samples_matches_jax(tmp_path):
    def run(cap, corpus, emb, merge, pipe, d):
        (d / "data_sample_3_1.json").write_text(json.dumps(
            {"sampled_time_series": [1, 2], "embedding": [0.0] * 5}))
        (d / "data_sample_5_1.json").write_text("{not json")
        return [corpus.validate_sample_json(str(d / "data_sample_3_1.json"),
                                            24),
                [m.replace(str(d), "D") for m in
                 corpus.check_directory(str(d), 24)],
                corpus.find_missing_ids(str(d))]

    _same(tmp_path, run)


def _benchpress_tree(root, n_frames=6):
    subj = root / "correct" / "subjA"
    angles = ["left_elbow", "left_shoulder", "right_elbow", "right_shoulder",
              "left_torso-arm", "right_torso-arm"]
    for view, names in (("rear", angles[:4]), ("top", angles[4:])):
        for name in names:
            d = subj / "angle_dataset" / view / name
            d.mkdir(parents=True, exist_ok=True)
            (d / "clip1.txt").write_text("\n".join(
                f"{i},{90 + i}" for i in range(n_frames)))
    for view, fmt in (("lateral_view", "{i},{a},{b}"),
                      ("rear_view", "Frame {i}: [[(10, {a}), (20, {b}), "
                                    "(1, 1)]]")):
        d = subj / "coordinate_dataset" / view
        d.mkdir(parents=True)
        (d / "clip1.txt").write_text("\n".join(
            fmt.format(i=i, a=100 + i, b=200 + i) for i in range(n_frames)))
    top = subj / "coordinate_dataset" / "top_view"
    top.mkdir(parents=True)
    pose = ("[[(0, 0), (2, 0), (0, -2), (2, -2), (0, -1), (2, -1), "
            "(0.5, -1.5), (1.5, -2.5)]]")
    (top / "clip1.txt").write_text("\n".join(
        f"Frame {i}: {pose}" for i in range(n_frames)))


def _deadlift_tree(root, n_frames=5):
    rows = "\n".join(",".join([str(i)] + [f"{10.0 + i + j / 3}"
                                          for j in range(7)])
                     for i in range(n_frames))
    for s, board in (("set1", True), ("set2", False)):
        d = root / "correct" / "subjB" / s / "Angle" / "3D"
        d.mkdir(parents=True)
        (d / "clip_1.csv").write_text(rows + "\n\n")
        (d / "clip_2.csv").write_text(rows.replace(",10.0,", ",,"))
        if board:
            (root / "correct" / "subjB" / s / "Chessboard").mkdir()


@pytest.mark.parametrize("sport", ["benchpress", "deadlift"])
@pytest.mark.parametrize("multi_error", [False, True])
def test_mergers_write_jax_data_json(tmp_path, sport, multi_error):
    def run(cap, corpus, emb, merge, pipe, d):
        rec = d / "rec"
        me = ""
        if sport == "benchpress":
            _benchpress_tree(rec)
            if multi_error:
                me = str(d / "me.csv")
                (d / "me.csv").write_text(
                    "subject,err1,err2\nsubjA,tilting_to_the_right,"
                    "elbows_flaring\n")
            feature = BP_FEATURE
        else:
            _deadlift_tree(rec)
            if multi_error:
                me = str(d / "me.json")
                (d / "me.json").write_text(json.dumps({"subjB": [[
                    {"error": "correct", "set": "set1", "clips": [1]},
                    {"error": "Lower_back_rounding", "set": "set1",
                     "clips": [2]}]]}))
            feature = DL_FEATURE
        m = corpus.rebuild_motion_json(sport, [str(rec / "correct")],
                                       str(d / "out"), me, feature)
        return json.dumps(m.data, sort_keys=True)

    data, files = _same(tmp_path, run)
    assert json.loads(data)


def test_named_fold_tag_is_jax(monkeypatch):
    import jax
    seen = []
    real = jax.random.fold_in
    monkeypatch.setattr(jprng.jax.random, "fold_in",
                        lambda k, d: seen.append(int(d)) or real(k, d))
    names = ["t", "noise", "cfg", "a longer stream name"]
    for name in names:
        jprng.named_fold(jprng.root_key(0), name)
    assert [tprng.name_tag(n) for n in names] == seen
    folds = {tprng.named_fold(tprng.root_key(3), n) for n in names}
    assert len(folds) == len(names)
    assert all(0 <= k < 2 ** 63 and k & 0xFFFFFFFF == 0 for k in folds)


def test_seed_everything_leaves_jax_state(capsys):
    for seed in (0, 2025):
        jprng.seed_everything(seed)
        want = (random.random(), np.random.rand(3).tolist())
        jout = capsys.readouterr().out
        key = tprng.seed_everything(seed)
        got = (random.random(), np.random.rand(3).tolist())
        assert got == want and capsys.readouterr().out == jout
        assert key == tprng.root_key(seed)
        first = torch.rand(2)
        torch.manual_seed(seed)
        assert torch.equal(first, torch.rand(2))
    # None seeds nothing and returns a fresh root key, as in JAX
    state = random.getstate()
    k = tprng.seed_everything(None)
    assert random.getstate() == state and capsys.readouterr().out == ""
    assert k & 0xFFFFFFFF == 0 and k >= 0


def test_batch_seed_is_unchanged():
    old = lambda s, i: ((int(s) & 0x7FFFFFFF) << 32) | (int(i) & 0xFFFFFFFF)
    for seed in (0, 1, 2025, 2 ** 31 + 5, -3):
        for index in (0, 1, 7, 1000, 2 ** 32 + 3):
            assert batch_seed(seed, index) == old(seed, index)
            assert batch_seed(seed, index) == tprng.step_key(
                tprng.root_key(seed), index)
    # a step key folded again moves to a stream of its own
    k = tprng.step_key(tprng.root_key(1), 5)
    assert tprng.step_key(k, 0) != k and tprng.step_key(k, 1) != \
        tprng.step_key(k, 2)


def _draw(seed):
    return torch.randn(8, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("pair", ["root_keys", "named_folds", "batch_seeds",
                                  "steps"])
def test_torch_seed_draws_streams_apart(pair):
    """Two streams seed a CPU generator apart through ``torch_seed``,
    where the raw keys (low 32 bits zero, or equal) draw the same."""
    a, b = {"root_keys": (tprng.root_key(0), tprng.root_key(5)),
            "named_folds": (tprng.named_fold(tprng.root_key(3), "t"),
                            tprng.named_fold(tprng.root_key(3), "noise")),
            "batch_seeds": (batch_seed(0, 7), batch_seed(5, 7)),
            "steps": (batch_seed(0, 1), batch_seed(0, 2))}[pair]
    assert a != b
    if pair != "steps":   # the fault: mt19937 keeps the low 32 bits alone
        assert torch.equal(_draw(a), _draw(b))
    sa, sb = tprng.torch_seed(a), tprng.torch_seed(b)
    assert (sa ^ sb) & 0xFFFFFFFF
    assert not torch.allclose(_draw(sa), _draw(sb))


def test_torch_seed_is_a_pure_function_of_the_key():
    """The same key gives the same seed and draws (a resumed run draws
    what the uninterrupted one would), every seed fits a generator, and
    every bit of a key reaches the low 32 bits of its seed."""
    keys = [tprng.root_key(s) for s in (0, 1, 2025)] + [
        batch_seed(3, i) for i in (0, 1, 2 ** 31)] + [
        tprng.named_fold(tprng.root_key(1), "cfg")]
    for k in keys:
        s = tprng.torch_seed(k)
        assert s == tprng.torch_seed(k) and 0 <= s < 2 ** 63
        assert torch.equal(_draw(s), _draw(tprng.torch_seed(k)))
    low = lambda k: tprng.torch_seed(k) & 0xFFFFFFFF
    k = batch_seed(11, 4)
    assert all(low(k ^ (1 << bit)) != low(k) for bit in range(63))
