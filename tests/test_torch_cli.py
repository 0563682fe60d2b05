"""The port's T2S CLIs on the CPU (``device="cpu"``) against the JAX CLIs:
train -> infer on a tiny synthetic corpus writes the JAX CLIs' files with
the same array shapes (flowmatching/euler, one epoch, ``--total_step
4``); the DDPM backbone trains and samples with DDIM, writing the single
run's figures and GIF; a reference ``.pth`` checkpoint samples as the
checkpoint it was made from; a resumed run continues the uninterrupted
one bit for bit (the epoch and the optimizer step restored apart); the
whole chain pretrain_vae -> train (which loads the pretrained VAE) ->
infer -> evaluation writes the JAX CLIs' artifacts, with MSE, WAPE, CRPS
and MRR equal to JAX's ``evaluate_data``/``evaluate_muldata`` on the same
arrays; the entry points refuse a machine with no card unless given the
CPU, and run as ``python -m``."""

import importlib.util
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from t2ms_tpu_torch.cli import evaluation as tevaluation
from t2ms_tpu_torch.cli import infer as tinfer
from t2ms_tpu_torch.cli import pretrain_vae as tpretrain
from t2ms_tpu_torch.cli import train as ttrain
from t2ms_tpu_torch.data.synthetic import write_t2s_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--dataset_name", "ETTh1", "--batch_size", "10", "--epochs", "1",
         "--total_step", "4", "--save_every", "1"]
INFER = ["--dataset_name", "ETTh1_24", "--total_step", "4",
         "--checkpoint_id", "0", "--run_multi", "1", "--max_batches", "1"]
CKPT = "results/denoiser_results/checkpoints/{}_DiT_ETTh1"
GEN = "results/denoiser_results/generation/{}_DiT_ETTh1_24_7_4"


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """The CLIs train and sample the flagship DiT on the CPU; beside the
    other test workers on the host's cores, two threads a worker run it
    several times faster than one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus, written by the port's writer: the mix-train
    CSVs (2 batches of 10 per length) and the 0.99-split test CSV (2 test
    rows)."""
    data = tmp_path_factory.mktemp("corpus") / "Data"
    for L in (24, 48, 96):
        write_t2s_csv(str(data / "TSFragment-600K" /
                          f"embedding_cleaned_ETTh1_{L}.csv"),
                      n=20, T=L, seed=L)
    write_t2s_csv(str(data / "our" / "embedding_cleaned_ETTh1_24.csv"),
                  n=200, T=24, seed=24)
    return data


def _workdir(tmp_path, corpus, name):
    d = tmp_path / name
    d.mkdir()
    os.symlink(corpus, d / "Data")
    return d


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = (np.load(p).shape
                                             if n.endswith(".npy") else None)
    return out


def test_train_infer_write_the_jax_clis_files(tmp_path, corpus, monkeypatch):
    from t2ms_tpu.cli import infer as jinfer
    from t2ms_tpu.cli import train as jtrain
    monkeypatch.chdir(_workdir(tmp_path, corpus, "jax"))
    jtrain.main(TRAIN)
    jinfer.main(INFER)
    jax_ckpt = sorted(os.listdir(CKPT.format("flowmatching")))
    jax_gen = _tree(GEN.format("flowmatching"))
    jax_hist = np.load(os.path.join(CKPT.format("flowmatching"),
                                    "model_0.loss_history.npy"))

    monkeypatch.chdir(_workdir(tmp_path, corpus, "port"))
    ttrain.main(TRAIN, device="cpu")
    tinfer.main(INFER, device="cpu")
    ckpt_dir = CKPT.format("flowmatching")
    assert sorted(os.listdir(ckpt_dir)) == jax_ckpt == [
        "model_0", "model_0.loss_history.npy", "train_log.jsonl"]
    hist = np.load(os.path.join(ckpt_dir, "model_0.loss_history.npy"))
    assert hist.shape == jax_hist.shape == (6,) and np.isfinite(hist).all()
    with open(os.path.join(ckpt_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["epoch"] for r in log] == [0]
    assert set(log[0]) == {"epoch", "loss", "steps_per_sec", "time"}
    gen = _tree(GEN.format("flowmatching"))
    assert gen == jax_gen
    assert "run_9/x_1.npy" in gen and gen["x_t.npy"] == (2, 24, 1)
    assert gen["x_t_latent_dec_array.npy"] == (2, 64, 30)
    for rel, shape in gen.items():
        if shape is not None:
            assert np.isfinite(np.load(os.path.join(
                GEN.format("flowmatching"), rel))).all(), rel


def test_ddpm_trains_and_samples_with_ddim(tmp_path, corpus, monkeypatch):
    """DDPM through both CLIs; the single run (no run_multi) writes the
    arrays, the figures and the diffusion GIF, as the JAX CLI does; a
    reference .pth made from the checkpoint samples the same series."""
    monkeypatch.chdir(_workdir(tmp_path, corpus, "ddpm"))
    ttrain.main(TRAIN + ["--backbone", "ddpm"], device="cpu")
    args = ["--dataset_name", "ETTh1_24", "--total_step", "4",
            "--checkpoint_id", "0", "--backbone", "ddpm", "--solver", "ddim",
            "--sample_steps", "2"]
    tinfer.main(args, device="cpu")
    gen = GEN.format("ddpm")
    assert sorted(os.listdir(gen)) == [
        "animation_ddpm.gif", "fig_0.jpg", "fig_1.jpg", "x_1.npy", "x_t.npy",
        "x_t_latent_dec_array.npy", "x_t_latent_enc_array.npy"]
    x_t = np.load(os.path.join(gen, "x_t.npy"))
    assert x_t.shape == (2, 24, 1) and np.isfinite(x_t).all()

    sd = torch.load(os.path.join(CKPT.format("ddpm"), "model_0",
                                 "checkpoint.pt"))["params"]
    ref = {"model": dict(sd, **{"unpatch.weight": torch.zeros(1)}),
           "epoch": 0}
    torch.save(ref, tmp_path / "ref.pth")
    os.rename(gen, str(tmp_path / "first"))
    tinfer.main(args + ["--checkpoint_file", str(tmp_path / "ref.pth")],
                device="cpu")
    np.testing.assert_array_equal(np.load(os.path.join(gen, "x_t.npy")), x_t)


def test_resume_continues_the_uninterrupted_run(tmp_path, corpus,
                                                monkeypatch):
    monkeypatch.chdir(_workdir(tmp_path, corpus, "resume"))
    two = ["--dataset_name", "ETTh1", "--batch_size", "20", "--epochs", "2",
           "--total_step", "4", "--save_every", "1"]
    ttrain.main(two + ["--save_path", "a"], device="cpu")
    a = os.path.join(CKPT.format("flowmatching").replace(
        "results/denoiser_results", "a"))
    ttrain.main(two + ["--save_path", "b", "--checkpoint_path",
                       os.path.join(a, "model_0")], device="cpu")
    b = a.replace("a/", "b/", 1)
    assert sorted(os.listdir(b)) == ["model_1", "model_1.loss_history.npy",
                                     "train_log.jsonl"]
    ra = torch.load(os.path.join(a, "model_1", "checkpoint.pt"))
    rb = torch.load(os.path.join(b, "model_1", "checkpoint.pt"))
    assert (ra["epoch"], ra["step"]) == (rb["epoch"], rb["step"]) == (1, 6)
    for n, v in ra["params"].items():
        assert torch.equal(v, rb["params"][n]), n
    np.testing.assert_array_equal(
        np.load(os.path.join(a, "model_1.loss_history.npy")),
        np.load(os.path.join(b, "model_1.loss_history.npy")))


def test_main_refuses_a_machine_with_no_card(tmp_path, corpus, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    monkeypatch.chdir(_workdir(tmp_path, corpus, "nocard"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(TRAIN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinfer.main(INFER)
    assert not os.path.exists("results")


def test_entry_points_run_as_modules():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for mod, flag in (("train", "--ema_decay"), ("infer", "--sample_steps")):
        r = subprocess.run([sys.executable, "-m", f"t2ms_tpu_torch.cli.{mod}",
                            "--help"], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0 and flag in r.stdout, r.stderr


PRETRAIN = ["--dataset_path", "ETTh1", "--batch_size", "10",
            "--num_training_updates", "6", "--data_root", "./PData",
            "--inference_samples", "4", "--num_embeddings", "128",
            "--commitment_cost", "0.25", "--compression_factor", "4"]
EVAL = ["--dataset_name", "ETTh1_24", "--cfg_scale", "7.0", "--total_step",
        "2", "--method_list", "MSE,WAPE,MRR,CRPS,C-FID"]


def test_pretrain_train_infer_evaluate_chain(tmp_path, corpus, monkeypatch,
                                             capsys):
    """The user's chain on the CPU. The pretrain corpus holds 3 test rows
    a length; the infer corpus 10 test series, the C-FID's sample."""
    from t2ms_tpu.cli import evaluation as jevaluation
    work = tmp_path / "chain"
    for L in (24, 48, 96):
        write_t2s_csv(str(work / "PData" / "TSFragment-600K" /
                          f"embedding_cleaned_ETTh1_{L}.csv"),
                      n=300, T=L, seed=L)
    os.makedirs(work / "Data")
    os.symlink(corpus / "TSFragment-600K", work / "Data" / "TSFragment-600K")
    write_t2s_csv(str(work / "Data" / "our" /
                      "embedding_cleaned_ETTh1_24.csv"), n=1000, T=24, seed=7)
    monkeypatch.chdir(work)

    tpretrain.main(PRETRAIN, device="cpu")
    d = "results/saved_pretrained_models/datasetETTh1_epoch6"
    names = set(os.listdir(d))
    assert {"final_model", "model_epoch_0", "train_log.jsonl",
            "metrics.txt"} <= names
    if all(importlib.util.find_spec(m) for m in ("matplotlib", "sklearn")):
        assert "pca_tsne.png" in names and "comparison_0.png" in names
    assert os.path.exists(os.path.join(d, "final_model", "params.pt"))
    with open(os.path.join(d, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["epoch"] for r in log] == [0]
    with open(os.path.join(d, "metrics.txt")) as f:
        metrics = f.read().splitlines()
    assert metrics[0].startswith("MAE: ") and metrics[1].startswith("RMSE: ")
    assert [ln.split(":")[0] for ln in metrics[2:]] == [
        "MAE_24", "RMSE_24", "MAE_48", "RMSE_48", "MAE_96", "RMSE_96"]
    for ln in metrics:
        assert np.isfinite(float(ln.split(": ")[1])), ln

    # cli.train looks for the VAE of a 2000-update pretrain
    os.rename(d, d.replace("epoch6", "epoch2000"))
    capsys.readouterr()
    ttrain.main(["--dataset_name", "ETTh1", "--batch_size", "20",
                 "--epochs", "1", "--total_step", "2"], device="cpu")
    assert "Loaded pretrained VAE from" in capsys.readouterr().out
    tinfer.main(["--dataset_name", "ETTh1_24", "--total_step", "2",
                 "--checkpoint_id", "0", "--run_multi", "1", "--max_batches",
                 "1", "--batch_size", "10", "--cfg_scale", "7.0"],
                device="cpu")
    tevaluation.main(EVAL + ["--device", "cpu"])

    out = "results/denoiser_results/evaluation/flowmatching_DiT_ETTh1_24_7.0_2"
    files = sorted(os.listdir(out))
    assert len(files) == 2 and files[1].endswith("_multi.json")
    assert files[0].startswith("flowmatching_DiT_ETTh1_24_7.0_2_ETTh1_24_")
    with open(os.path.join(out, files[0])) as f:
        single = json.load(f)
    with open(os.path.join(out, files[1])) as f:
        multi = json.load(f)
    assert sorted(single) == ["C-FID", "MSE", "WAPE"]
    assert sorted(multi) == ["CRPS", "MRR"]
    assert all(np.isfinite(v) for v in [*single.values(), *multi.values()])
    assert 0.0 <= multi["MRR"] <= 1.0

    # JAX's evaluation functions on the same arrays
    gen = "results/denoiser_results/generation/flowmatching_DiT_ETTh1_24_7.0_2"
    args = jevaluation.get_args(EVAL[:-2] + ["--method_list",
                                             "MSE,WAPE,MRR,CRPS"])
    args.evaluation_save_path = str(tmp_path / "jax_eval")
    x_1 = np.load(os.path.join(gen, "run_0", "x_1.npy"))
    assert x_1.shape == (10, 24, 1)
    want = jevaluation.evaluate_data(
        args, np.transpose(x_1, (0, 2, 1)),
        np.transpose(np.load(os.path.join(gen, "x_t.npy")), (0, 2, 1)))
    runs = [np.load(os.path.join(gen, f"run_{i}", "x_t.npy"))[..., None]
            for i in range(10)]
    x_1 = np.load(os.path.join(gen, "run_9", "x_1.npy"))
    want.update(jevaluation.evaluate_muldata(args, x_1,
                                             np.concatenate(runs, -1)))
    for k in ("MSE", "WAPE"):
        assert single[k] == pytest.approx(want[k], rel=1e-12), k
    for k in ("CRPS", "MRR"):
        assert multi[k] == pytest.approx(want[k], rel=1e-12), k


@pytest.mark.parametrize("mod,argv", [
    (tpretrain, PRETRAIN),
    (tevaluation, EVAL),
])
def test_pretrain_and_evaluation_refuse_a_machine_with_no_card(
        tmp_path, corpus, monkeypatch, mod, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    monkeypatch.chdir(_workdir(tmp_path, corpus, "nocard"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not os.path.exists("results")


@pytest.mark.parametrize("mod,flag", [
    ("pretrain_vae", "--dataset_path"), ("evaluation", "--method_list"),
    ("metrics_experiment", "--rival_root")])
def test_new_entry_points_run_as_modules(mod, flag, monkeypatch, capsys):
    """``python -m`` in this process (runpy), so no interpreter starts."""
    monkeypatch.setattr(sys, "argv", [mod, "--help"])
    monkeypatch.delitem(sys.modules, f"t2ms_tpu_torch.cli.{mod}",
                        raising=False)
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"t2ms_tpu_torch.cli.{mod}", run_name="__main__")
    assert e.value.code == 0 and flag in capsys.readouterr().out
