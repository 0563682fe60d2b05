"""The port's motion data path held to the JAX package on the CPU, bit for
bit: ``get_cfg`` on the repository's config.yaml for both sports, the
port's YAML reader against ``yaml.safe_load`` (and its refusal of what it
does not read), ``get_cfg`` in a fresh interpreter where ``yaml`` cannot
be imported, the pooling matrices and ``resize_time_axis``, the motion
writer's files, ``load_motion_records`` for both sports and periods,
``reference_random_split`` and ``motion_loader_provider``'s batches over
two epochs."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from t2ms_tpu import config as jconfig
from t2ms_tpu.data import motion as jmotion
from t2ms_tpu.data import provider as jprovider
from t2ms_tpu.data.synthetic import write_motion_dataset as j_write_motion
from t2ms_tpu.ops import resize as jresize
from t2ms_tpu_torch import config
from t2ms_tpu_torch.data import motion, provider
from t2ms_tpu_torch.data.loaders import BucketBatcher
from t2ms_tpu_torch.data.synthetic import write_motion_dataset
from t2ms_tpu_torch.ops import resize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config.yaml")
SPORTS = ("benchpress", "deadlift")


# ------------------------------------------------------------ config.yaml

@pytest.mark.parametrize("sport", SPORTS)
def test_get_cfg_matches_jax_on_the_repository_config(sport):
    ns = lambda: argparse.Namespace(config=CONFIG, dataset_name=sport)
    got = vars(config.get_cfg(ns()))
    want = vars(jconfig.get_cfg(ns()))
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    # the reference's odd default survives where the section omits it
    if sport == "deadlift":
        assert got["num_encoder_layers"] == 128


def test_motion_pretrained_dir_matches_jax():
    assert (config.motion_pretrained_dir(36, "benchpress", 16000)
            == jconfig.motion_pretrained_dir(36, "benchpress", 16000))


_VARIANTS = {
    "comments": "# head\na: 1   # tail\n\n  # indented comment\nb: x#y\n",
    "nesting": "a:\n  b:\n    c: 3\n    d: -4\n  e: text with spaces\n",
    "int_keys": "f:\n  0:\n    - name: bar_x\n    - definition: one\n"
                "  12:\n    - name: y\n",
    "indentless": "f:\n  0:\n  - name: a/b\n  - definition: x, y\n",
    "scalar_items": "a:\n  - one\n  - 2\n",
    "plain": "k: ./Data\nv: Caption_explain_no_barbell_length\n"
             "w: -dash\nu: 0\n",
}


@pytest.mark.parametrize("name", ["config.yaml"] + sorted(_VARIANTS))
def test_yaml_reader_matches_safe_load(name):
    if name == "config.yaml":
        with open(CONFIG, encoding="utf-8") as f:
            text = f.read()
    else:
        text = _VARIANTS[name]
    assert config.read_yaml_subset(text) == yaml.safe_load(text)


def test_yaml_reader_reads_what_safe_dump_writes():
    cfg = {"dataset_root": "./Data", "general_seed": 2025,
           "deadlift": {"input_dim": 7, "features": {
               i: [{"name": f"feat_{i}"}, {"definition": "synthetic"}]
               for i in range(9)}, "vae": {"epoch": 4}}}
    text = yaml.safe_dump(cfg)
    assert config.read_yaml_subset(text) == cfg


@pytest.mark.parametrize("text,line", [
    ("a: 1.5\n", 1), ("a: yes\n", 1), ("a: ~\n", 1), ("a: 0x1f\n", 1),
    ("a: 2024-01-01\n", 1), ("a: [1, 2]\n", 1), ("a: {b: 1}\n", 1),
    ("a: 'q'\n", 1), ('a: "q"\n', 1), ("a: &x 1\n", 1), ("a: *x\n", 1),
    ("a: !!str 1\n", 1), ("a: |\n  text\n", 1), ("a: >\n  text\n", 1),
    ("a: 1\na: 2\n", 2), ("a:\n", 1), ("a:\n\tb: 1\n", 2),
    ("---\na: 1\n", 1), ("a: b: c\n", 1),
    ("a:\n  - name: x\n    more: y\n", 3),
    ("a: long text\n  continued\n", 2), ("  a: 1\n", 1),
])
def test_yaml_reader_refuses_what_it_does_not_read(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        config.read_yaml_subset(text)


def test_get_cfg_runs_without_yaml():
    """The card's machine has no YAML library: get_cfg reads config.yaml
    in an interpreter where ``import yaml`` fails."""
    code = ("import argparse, sys\n"
            "sys.modules['yaml'] = None\n"
            "from t2ms_tpu_torch.config import get_cfg\n"
            f"a = get_cfg(argparse.Namespace(config={CONFIG!r}, "
            "dataset_name='benchpress'))\n"
            "assert 'yaml' not in [m for m in sys.modules if sys.modules[m]]\n"
            "print(a.flow_dim, a.input_dim, len(a.features), a.caption)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["64", "10", "13",
                                "Caption_explain_no_barbell_length"]


# ------------------------------------------------------------ resampling

_PAIRS = [(100, 36), (144, 36), (40, 36), (7, 1), (50, 50), (36, 144),
          (40, 72), (120, 192), (64, 25)]


@pytest.mark.parametrize("in_len,out_len", _PAIRS)
def test_resize_matrices_and_rule_match_jax(in_len, out_len):
    if in_len >= out_len:
        np.testing.assert_array_equal(
            resize._adaptive_avg_pool_matrix_np(in_len, out_len),
            jresize._adaptive_avg_pool_matrix_np(in_len, out_len))
        np.testing.assert_array_equal(
            resize.adaptive_avg_pool_matrix(in_len, out_len).numpy(),
            np.asarray(jresize.adaptive_avg_pool_matrix(in_len, out_len)))
    x = np.random.default_rng(in_len).standard_normal(
        (2, 3, in_len)).astype(np.float32)
    for name in ("resize_time_axis", "adaptive_avg_pool1d"):
        if name == "adaptive_avg_pool1d" and in_len < out_len:
            continue
        got = getattr(resize, name)(torch.from_numpy(x), out_len).numpy()
        want = np.asarray(getattr(jresize, name)(x, out_len))
        assert got.shape == want.shape == (2, 3, out_len)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the loader's host resize is the JAX loader's, bit for bit
    np.testing.assert_array_equal(motion._resize_np(x, out_len),
                                  jmotion._resize_np(x, out_len))


def test_map_target_len_matches_jax():
    for sport in SPORTS:
        base = motion.SPORT_SPECS[sport]["base"]
        for T in range(1, 160):
            for tgt in (base, 2 * base, 4 * base):
                assert (motion.map_target_len(sport, T, tgt)
                        == jmotion.map_target_len(sport, T, tgt))
        with pytest.raises(ValueError):
            motion.map_target_len(sport, 50, base + 1)


# ------------------------------------------------------------ the corpus

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Each sport written by the port's writer; deadlift also gets a
    clip too short to keep and one with ragged features."""
    root = tmp_path_factory.mktemp("motion") / "Data"
    for i, sport in enumerate(SPORTS):
        write_motion_dataset(str(root), sport, n_subjects=4,
                             clips_per_subject=9, seed=i, caption_dir="Cap")
    path = root / "deadlift" / "data.json"
    data = json.loads(path.read_text())
    subject = next(iter(data))
    data[subject]["clip_short"] = {f"feature_{f}": [0.5] * 5
                                   for f in range(7)}
    data[subject]["clip_ragged"] = {f"feature_{f}": [0.5] * (60 + f)
                                    for f in range(7)}
    path.write_text(json.dumps(data))
    for clip in ("clip_short", "clip_ragged"):
        d = root / "deadlift" / "Cap" / subject / clip
        d.mkdir(parents=True)
        (d / "caption.json").write_text(json.dumps(
            {"Summary": clip, "embedding": [0.1] * 128}))
    return root


@pytest.mark.parametrize("sport", SPORTS)
def test_writer_writes_the_jax_writers_files(sport, corpora, tmp_path):
    if sport == "deadlift":
        corpora = corpora.parent / "clean"
        write_motion_dataset(str(corpora), sport, n_subjects=4,
                             clips_per_subject=9, seed=1, caption_dir="Cap")
    j_write_motion(str(tmp_path), sport, n_subjects=4, clips_per_subject=9,
                   seed=SPORTS.index(sport), caption_dir="Cap")
    for d, _, names in os.walk(tmp_path / sport):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), tmp_path)
            with open(os.path.join(d, n), "rb") as a, \
                    open(os.path.join(corpora, rel), "rb") as b:
                assert a.read() == b.read(), rel


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.text, g.subject, g.clip) == (w.text, w.subject, w.clip)
        assert g.x.dtype == w.x.dtype
        np.testing.assert_array_equal(g.x, w.x)
        assert len(g.embeddings) == len(w.embeddings)
        for a, b in zip(g.embeddings, w.embeddings):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sport", SPORTS)
@pytest.mark.parametrize("period", ["train", "test"])
def test_load_motion_records_matches_jax(sport, period, corpora):
    jp = os.path.join(corpora, sport, "data.json")
    cr = os.path.join(corpora, sport, "Cap")
    base = motion.SPORT_SPECS[sport]["base"]
    for m in ((1, 2, 4) if period == "train" else (2,)):
        _same_records(
            motion.load_motion_records(sport, jp, cr, period, base * m),
            jmotion.load_motion_records(sport, jp, cr, period, base * m))


@pytest.mark.parametrize("n,seed", [(37, 2025), (1800, 2025), (10, 0),
                                    (1, 3)])
def test_reference_random_split_matches_jax(n, seed):
    assert (motion.reference_random_split(n, seed)
            == jmotion.reference_random_split(n, seed))


def _batches(batcher, epoch):
    return [(b.bucket, b.x, b.embedding, b.texts, b.subjects,
             b.extra_embedding) for b in batcher.epoch(epoch)]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3] and g[4] == w[4]
        for a, b in zip(g[1:3] + g[5:], w[1:3] + w[5:]):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sport", SPORTS)
@pytest.mark.parametrize("period", ["train", "test"])
def test_motion_loader_provider_matches_jax(sport, period, corpora):
    args = argparse.Namespace(
        dataset_name=sport, dataset_root=str(corpora), caption="Cap",
        split_base_num=motion.SPORT_SPECS[sport]["base"], general_seed=2025,
        batch_size=3)
    got = provider.motion_loader_provider(args, period)
    want = jprovider.motion_loader_provider(args, period)
    for g, w in zip(got, want):        # the (train, test) pair
        assert isinstance(g, BucketBatcher)
        assert (len(g), g.drop_last) == (len(w), w.drop_last)
        for epoch in (0, 1):
            _same_batches(_batches(g, epoch), _batches(w, epoch))
