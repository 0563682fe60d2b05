"""The port's motion CLIs on the CPU (``device="cpu"``), at a small
synthetic benchpress corpus and narrow widths, with two torch threads: the
chain pretrain_mylavae (conv and tsae) -> mytrain -> myinfer ->
myevaluation writes the files the JAX CLIs write (names and shapes, from
the JAX CLIs' code: ``final_model``, ``model_{e}``, ``run_{i}/sample_{b}
/data.json``, ...); a resumed mytrain continues the uninterrupted run bit
for bit; mytrain's first step equals JAX's on the JAX step's draws (loss
within 1e-4); myevaluation's ``evaluate_data`` and its JSON equal JAX's on
the same arrays; myinfer without matplotlib skips the figures and GIFs
with one line each and writes the arrays and JSON; the benchpress pose
math equals JAX's; the entry points refuse a machine with no card."""

import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from t2ms_tpu.cli import myevaluation as j_myevaluation
from t2ms_tpu.cli._common import build_denoiser as j_build_denoiser
from t2ms_tpu.cli._common import build_motion_vae as j_build_motion_vae
from t2ms_tpu.data.provider import (
    motion_loader_provider as j_motion_loader_provider)
from t2ms_tpu.training import optim as joptim
from t2ms_tpu.training.trainer import TrainState
from t2ms_tpu.training.trainer import make_denoiser_train_step as j_make_step
from t2ms_tpu.utils.prng import named_fold, root_key, step_key
from t2ms_tpu.visualize import benchpress as j_benchpress
from t2ms_tpu_torch.cli import (myevaluation, myinfer, mytrain,
                                pretrain_mylavae)
from t2ms_tpu_torch.convert import dit_params_from_jax, lavae_params_from_jax
from t2ms_tpu_torch.data.synthetic import write_motion_dataset
from t2ms_tpu_torch.training import make_denoiser_train_step, onecycle_adamw
from t2ms_tpu_torch.visualize import benchpress

SPORT, FLOW, EMB, CAP = "benchpress", 8, 8, "Caption_synth"
VAE_DIR = "results/saved_pretrained_models/36_benchpress_epoch4"
CKPT = ("results/denoiser_results/checkpoints/"
        "flowmatching_DiT_benchpress_Caption_synth_4")
GEN = "results/denoiser_results/generation/flowmatching_DiT_benchpress_3_5"
EVAL = "results/denoiser_results/evaluation/flowmatching_DiT_benchpress_3_5"
PRETRAIN = ["--dataset_name", SPORT, "--batch_size", "4", "--max_updates",
            "4"]
TRAIN = ["--dataset_name", SPORT, "--batch_size", "4", "--total_step", "5",
         "--save_every", "1"]
INFER = ["--dataset_name", SPORT, "--total_step", "5", "--checkpoint_id",
         "1", "--run_time", "2", "--max_batches", "1", "--render_gifs", "0"]
EVALUATE = ["--dataset_name", SPORT, "--total_step", "5", "--run_time", "2",
            "--n_samples", "2", "--method_list",
            "MSE,WAPE,MRR,CRPS,ED,ACD,SD,KD,DTW"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A benchpress corpus of 3 subjects x 12 clips (the port's writer) and
    a config.yaml in the repository's layout at narrow widths."""
    root = tmp_path_factory.mktemp("motion")
    write_motion_dataset(str(root / "Data"), SPORT, n_subjects=3,
                         clips_per_subject=12, caption_dir=CAP)
    cfg = {"dataset_root": "./Data", "general_seed": 2025, SPORT: {
        "input_dim": 10,
        "features": {i: [{"name": f"feat_{i}"}, {"definition": "synthetic"}]
                     for i in range(13)},
        "flow_dim": FLOW,
        "dataset": {"split_base_num": 36, "caption": CAP},
        "vae": {"d_ff": 32, "num_encoder_layers": 1, "num_decoder_layers": 1,
                "num_heads": 4, "embedding_dim": EMB, "epoch": 4,
                "block_hidden_size": 16, "num_residual_layers": 1,
                "res_hidden_size": 16},
        "diffusion": {"denoiser": "DiT", "backbone": "flowmatching"}}}
    (root / "config.yaml").write_text(yaml.safe_dump(cfg, width=1000))
    return root


def _workdir(tmp_path, corpus):
    for name in ("Data", "config.yaml"):
        os.symlink(corpus / name, tmp_path / name)
    return tmp_path


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = (np.load(p).shape
                                             if n.endswith(".npy") else None)
    return out


def test_chain_writes_the_jax_clis_files(tmp_path, corpus, monkeypatch):
    monkeypatch.chdir(_workdir(tmp_path, corpus))
    real, reco = pretrain_mylavae.main(PRETRAIN + ["--vae_kind", "conv"],
                                       device="cpu")
    assert len(real) == len(reco) > 0
    assert all(a.shape == b.shape for a, b in zip(real, reco))
    figs = importlib.util.find_spec("matplotlib") is not None
    # pretrain_mylavae.py: model_epoch_{e} every total_epochs // 10 epochs,
    # final_model, train_log.jsonl, the loss curve and pca_tsne.png
    want = {"final_model/params.pt", "model_epoch_0/params.pt",
            "train_log.jsonl"} | ({"loss_curve_epoch.png", "pca_tsne.png"}
                                  if figs else set())
    got = set(_tree(VAE_DIR))
    assert {"final_model/params.pt", "train_log.jsonl"} <= got
    assert got - {f"model_epoch_{e}/params.pt" for e in range(1, 4)} == want

    real, reco = pretrain_mylavae.main(
        PRETRAIN + ["--vae_kind", "tsae", "--save_path", "tsae_out/"],
        device="cpu")
    assert [a.shape for a in real] == [b.shape for b in reco]
    assert np.isfinite(np.concatenate([r.ravel() for r in reco])).all()
    assert os.path.exists("tsae_out/36_benchpress_epoch4/final_model/"
                          "params.pt")

    mytrain.main(TRAIN + ["--epochs", "2"], device="cpu")
    # mytrain.py: model_{e} each epoch (--save_every 1), their loss
    # histories (epoch means), train_log.jsonl and loss_curve.png
    want = {"model_0/checkpoint.pt", "model_1/checkpoint.pt",
            "model_0.loss_history.npy", "model_1.loss_history.npy",
            "train_log.jsonl"} | ({"loss_curve.png"} if figs else set())
    tree = _tree(CKPT)
    assert set(tree) == want
    assert tree["model_1.loss_history.npy"] == (2,)

    myinfer.main(INFER, device="cpu")
    tree = _tree(GEN)
    for b in (0, 1):
        T = tree[f"x_1_sample_{b}.npy"][-1]
        assert tree[f"x_1_sample_{b}.npy"] == (10, T)
        for r in (0, 1):
            assert tree[f"run_{r}/x_t_sample_{b}.npy"] == (10, T)
            assert tree[f"run_{r}/sample_{b}/x_t.npy"] == (1, 10, T)
            with open(os.path.join(GEN, f"run_{r}/sample_{b}/data.json")) as f:
                feats = json.load(f)
            # the last input_dim feature names of the config
            assert list(feats) == [f"feat_{i}" for i in range(3, 13)]
            assert all(len(v) == T for v in feats.values())
    figures = ({f"run_{r}/{n}" for r in (0, 1)
                for n in ("sample_0.jpg", "sample_1.jpg", "pca_tsne.png")}
               if figs else set())
    assert {k for k, v in tree.items() if v is None} == figures | {
        f"run_{r}/sample_{b}/data.json" for r in (0, 1) for b in (0, 1)}
    for rel, shape in tree.items():
        if shape is not None:
            assert np.isfinite(np.load(os.path.join(GEN, rel))).all(), rel

    result = myevaluation.main(EVALUATE, device="cpu")
    files = os.listdir(EVAL)
    assert len(files) == 1 and files[0].startswith(
        "flowmatching_DiT_benchpress_3_5_benchpress_")
    with open(os.path.join(EVAL, files[0])) as f:
        on_disk = json.load(f)
    assert sorted(on_disk) == ["0", "1", "summary"]
    assert on_disk["summary"] == result["summary"]
    assert sorted(result["summary"]) == sorted(EVALUATE[-1].split(","))
    assert all(np.isfinite(v) for v in result["summary"].values())

    # JAX's myevaluation over the same arrays writes the same numbers
    os.rename(os.path.join(EVAL, files[0]), str(tmp_path / "port.json"))
    j_myevaluation.main(EVALUATE)
    (jfile,) = os.listdir(EVAL)
    with open(os.path.join(EVAL, jfile)) as f:
        assert json.load(f) == on_disk


def test_resume_continues_the_run_bit_for_bit(tmp_path, corpus,
                                              monkeypatch):
    """Two epochs in one run, and a run cut after epoch 0 by
    --hard_stop_epoch then resumed from model_0: the epoch and the
    optimizer step come back apart, and model_1 and its loss history are
    the same bit for bit."""
    monkeypatch.chdir(_workdir(tmp_path, corpus))
    ck = lambda root: os.path.join(root, CKPT.split("denoiser_results/")[1])
    pretrain_mylavae.main(PRETRAIN + ["--vae_kind", "conv"], device="cpu")
    mytrain.main(TRAIN + ["--epochs", "2", "--save_path", "a"],
                 device="cpu")
    mytrain.main(TRAIN + ["--epochs", "2", "--save_path", "b",
                          "--hard_stop_epoch", "0"], device="cpu")
    assert not os.path.exists(os.path.join(ck("b"), "model_1"))
    mytrain.main(TRAIN + ["--epochs", "2", "--save_path", "b",
                          "--checkpoint_path",
                          os.path.join(ck("b"), "model_0")], device="cpu")
    a = torch.load(os.path.join(ck("a"), "model_1", "checkpoint.pt"))
    b = torch.load(os.path.join(ck("b"), "model_1", "checkpoint.pt"))
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"] == 1
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    np.testing.assert_array_equal(
        np.load(os.path.join(ck("a"), "model_1.loss_history.npy")),
        np.load(os.path.join(ck("b"), "model_1.loss_history.npy")))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_first_step_matches_jax(tmp_path, corpus, monkeypatch):
    """mytrain's first step on both packages: the conv VAE and the DiT
    built by each CLI's factories over the (embedding_dim, flow_dim)
    latent, the port's weights converted from JAX's, the first batch of
    epoch 0 encoded once (the latent cache), JAX's draws for
    step_key(root_key(general_seed), 0) injected: the loss within 1e-4."""
    monkeypatch.chdir(_workdir(tmp_path, corpus))
    args = mytrain.get_args(TRAIN + ["--epochs", "1"])
    jv = j_build_motion_vae(args)
    vp = jax.jit(jv.init)(jax.random.key(0),
                          jnp.zeros((2, args.input_dim, 36)))
    tv = mytrain.load_motion_vae(args, "cpu", "absent")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    jd = j_build_denoiser("DiT", latent_len=FLOW, latent_dim=EMB)
    jp = jax.jit(jd.init)(jax.random.key(1), jnp.zeros((2, EMB, FLOW)),
                          jnp.zeros(2), jnp.zeros((2, 128)))
    td = mytrain.build_motion_denoiser(args, torch.float32, "cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))

    batch = next(iter(mytrain.motion_loader_provider(args, "train")[0]
                      .epoch(0)))
    jbatch = next(iter(j_motion_loader_provider(args, "train")[0].epoch(0)))
    np.testing.assert_array_equal(batch.x, jbatch.x)
    z = jv.apply(vp, jnp.asarray(batch.x), method=jv.encode)[0]
    with torch.no_grad():
        tz = tv.encode(torch.from_numpy(batch.x))[0]
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-4,
                               atol=1e-5)
    jopt = joptim.onecycle_adamw(4)
    state = TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jstep = j_make_step(jd, jv, jopt, args.backbone, args.total_step,
                        donate=False, precoded=True)
    key = step_key(root_key(args.general_seed), 0)
    _, jloss = jstep(state, vp, key, z, jnp.asarray(batch.embedding))
    tstep = make_denoiser_train_step(td, tv, onecycle_adamw(
        td.parameters(), 4), args.backbone, args.total_step, precoded=True,
        device="cpu")
    T_ = lambda a: torch.from_numpy(np.array(a))
    tloss = tstep(tz, torch.from_numpy(batch.embedding),
                  u=T_(jax.random.uniform(named_fold(key, "t"), (4,))),
                  x_0=T_(jax.random.normal(named_fold(key, "noise"),
                                           z.shape)),
                  coin=T_(jax.random.uniform(named_fold(key, "cfg"), ())))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)


def test_mytrain_refuses_a_batch_no_bucket_fills(tmp_path, corpus,
                                                 monkeypatch):
    monkeypatch.chdir(_workdir(tmp_path, corpus))
    with pytest.raises(ValueError, match="no motion bucket holds a full"):
        mytrain.main(["--dataset_name", SPORT, "--batch_size", "1000"],
                     device="cpu")


@pytest.mark.parametrize("methods", ["MSE,WAPE,MRR,CRPS,ED,ACD,SD,KD,DTW",
                                     "MSE"])
def test_evaluate_data_matches_jax(methods):
    """evaluate_data on (runs, D, T) stacks: the same numbers as JAX's, a
    mismatched sample skipped with the results so far kept."""
    r = np.random.default_rng(3)
    ori = np.repeat(np.abs(r.standard_normal((1, 4, 24))) + 1.0, 3, axis=0)
    gen = ori + 0.3 * r.standard_normal(ori.shape)
    args = argparse.Namespace(method_list=methods, device="cpu")
    got = myevaluation.evaluate_data(args, ori, gen, 0, {})
    want = j_myevaluation.evaluate_data(args, ori, gen, 0, {})
    assert got == want and sorted(got[0]) == sorted(methods.split(","))
    got = myevaluation.evaluate_data(args, ori, gen[..., :20], 1, got)
    assert 1 not in got and 0 in got
    assert myevaluation.evaluate_data(args, ori, gen, 2, got)[2] == want[0]


def test_myinfer_without_matplotlib_skips_figures_and_gifs(
        tmp_path, corpus, monkeypatch, capsys):
    """The card's machine has no matplotlib: one line for the GIFs, one for
    the figures, and the arrays and JSON written all the same."""
    monkeypatch.chdir(_workdir(tmp_path, corpus))
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name in ("matplotlib", "imageio", "sklearn")
        else real(name, *a)))
    myinfer.main(INFER[:-2] + ["--run_time", "1"], device="cpu")
    out = capsys.readouterr().out
    assert out.count("skeleton GIFs skipped: matplotlib, imageio not "
                     "installed") == 1
    assert out.count("figures skipped: matplotlib, sklearn not "
                     "installed") == 1
    tree = _tree(GEN)
    assert not [k for k in tree if k.endswith((".gif", ".jpg", ".png"))]
    assert {"run_0/sample_1/data.json", "run_0/sample_1/x_t.npy",
            "x_1_sample_1.npy"} <= set(tree)


def test_save_result_skips_gifs_on_a_missing_feature(tmp_path, capsys):
    myinfer.save_result(str(tmp_path / "s"), {"bar_x": [1.0, 2.0]})
    assert "skipping skeleton GIFs (missing feature" in capsys.readouterr().out
    with open(tmp_path / "s" / "data.json") as f:
        assert json.load(f) == {"bar_x": [1.0, 2.0]}


def _pose_config(n=3):
    """tests/test_animators.py's config."""
    t = np.linspace(0, 1, n)
    return {
        "left_shoulder": 30 + 10 * t, "right_shoulder": 30 + 10 * t,
        "left_elbow": 90 + 20 * t, "right_elbow": 90 + 20 * t,
        "left_shoulder_y": 320 + 50 * t, "right_shoulder_y": 320 + 50 * t,
        "left_torso-arm": 45 + 5 * t, "right_torso-arm": 45 + 5 * t,
        "left_dist": 200 + 20 * t, "right_dist": 200 + 20 * t,
    }


def test_benchpress_pose_math_matches_jax():
    cfg = _pose_config()
    rear = benchpress.RearV_BenchpressAnimator(cfg)
    jrear = j_benchpress.RearV_BenchpressAnimator(cfg)
    for n in ("l_sh", "l_el", "l_wr", "r_sh", "r_el", "r_wr"):
        np.testing.assert_array_equal(getattr(rear, n), getattr(jrear, n))
    np.testing.assert_allclose(np.linalg.norm(rear.l_wr - rear.l_el, axis=1),
                               rear.L_fore, rtol=1e-6)
    np.testing.assert_allclose(
        np.linalg.norm(rear.l_el - rear.l_sh, axis=1),
        rear.L_upper * np.abs(np.sin(np.deg2rad(rear.th_l))), rtol=1e-6)
    top = benchpress.TopV_BenchpressAnimator(cfg)
    np.testing.assert_array_equal(
        top.pts, j_benchpress.TopV_BenchpressAnimator(cfg).pts)
    assert top.pts.shape == (3, 8, 2)
    np.testing.assert_allclose(top.pts[:, 0, 0], -0.5)
    np.testing.assert_allclose(top.pts[:, 6, 1], top.pts[:, 0, 1] - top.d_r)
    del cfg["left_elbow"]
    with pytest.raises(KeyError):
        benchpress.RearV_BenchpressAnimator(cfg)


def test_benchpress_gif(tmp_path):
    if any(importlib.util.find_spec(m) is None
           for m in ("matplotlib", "imageio")):
        pytest.skip("the GIF needs matplotlib and imageio")
    out = benchpress.TopV_BenchpressAnimator(_pose_config()).animate(
        str(tmp_path / "top.gif"))
    assert os.path.getsize(out) > 1000


@pytest.mark.parametrize("cli,argv", [
    (pretrain_mylavae, PRETRAIN), (mytrain, TRAIN), (myinfer, INFER),
    (myevaluation, EVALUATE)], ids=["pretrain_mylavae", "mytrain",
                                    "myinfer", "myevaluation"])
def test_entry_points_refuse_missing_cuda(cli, argv, tmp_path, corpus,
                                          monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    monkeypatch.chdir(_workdir(tmp_path, corpus))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
