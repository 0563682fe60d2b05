"""The port package stands alone: importing it pulls in neither jax nor
the JAX package, nor pandas, matplotlib, imageio, yaml or sklearn, which
the card's machine lacks (checked in a fresh interpreter, since this test
process has jax loaded by conftest); no source file imports the first at
all, nor the others at module level; and every entry point refuses to
drop onto the CPU unless asked."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import t2ms_tpu_torch
from t2ms_tpu_torch.cli import quality_gate
from t2ms_tpu_torch.models.denoisers import DiT, MLPDenoiser
from t2ms_tpu_torch.models.vae import LAVAE, TSae, TSaeDiffusion
from t2ms_tpu_torch.sampling import make_cfg_sampler
from t2ms_tpu_torch.serving import ServingEngine, make_serving_sampler
from t2ms_tpu_torch.training import (make_denoiser_train_step,
                                     make_vae_train_step, onecycle_adamw)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "t2ms_tpu_torch")
MODULES = [
    "t2ms_tpu_torch", "t2ms_tpu_torch.convert", "t2ms_tpu_torch.ops._build",
    "t2ms_tpu_torch.ops.resize", "t2ms_tpu_torch.ops.conv1d",
    "t2ms_tpu_torch.ops.attention", "t2ms_tpu_torch.ops.dit_block",
    "t2ms_tpu_torch.models.vae.lavae",
    "t2ms_tpu_torch.models.backbones.rectified_flow",
    "t2ms_tpu_torch.models.denoisers.dit",
    "t2ms_tpu_torch.models.denoisers.dit_fast",
    "t2ms_tpu_torch.models.denoisers.mlp",
    "t2ms_tpu_torch.models.backbones.ddpm",
    "t2ms_tpu_torch.sampling.sampler", "t2ms_tpu_torch.serving.engine",
    "t2ms_tpu_torch.training", "t2ms_tpu_torch.training.optim",
    "t2ms_tpu_torch.training.trainer", "t2ms_tpu_torch.training.checkpoints",
    "t2ms_tpu_torch.training.scaling", "t2ms_tpu_torch.training.ema",
    "t2ms_tpu_torch.config", "t2ms_tpu_torch.utils.logging",
    "t2ms_tpu_torch.data.registry", "t2ms_tpu_torch.data.t2s",
    "t2ms_tpu_torch.data.synthetic", "t2ms_tpu_torch.data.loaders",
    "t2ms_tpu_torch.data.embedder", "t2ms_tpu_torch.data.provider",
    "t2ms_tpu_torch.data.prefetch", "t2ms_tpu_torch.visualize.diagnostics",
    "t2ms_tpu_torch.cli._common", "t2ms_tpu_torch.cli.train",
    "t2ms_tpu_torch.cli.infer", "t2ms_tpu_torch.cli.pretrain_vae",
    "t2ms_tpu_torch.cli.evaluation", "t2ms_tpu_torch.cli.metrics_experiment",
    "t2ms_tpu_torch.cli.serve", "t2ms_tpu_torch.cli.pretrain_mylavae",
    "t2ms_tpu_torch.cli.mytrain", "t2ms_tpu_torch.cli.myinfer",
    "t2ms_tpu_torch.cli.myevaluation", "t2ms_tpu_torch.data.motion",
    "t2ms_tpu_torch.models.vae.tsae", "t2ms_tpu_torch.visualize.benchpress",
    "t2ms_tpu_torch.utils.native", "t2ms_tpu_torch.evaluate.dtw",
    "t2ms_tpu_torch.evaluate.metrics", "t2ms_tpu_torch.evaluate.fid",
    "t2ms_tpu_torch.evaluate.feature_measures",
    "t2ms_tpu_torch.evaluate.ts2vec", "t2ms_tpu_torch.utils.prng",
    "t2ms_tpu_torch.parallel", "t2ms_tpu_torch.parallel.mesh",
    "t2ms_tpu_torch.parallel.collectives", "t2ms_tpu_torch.parallel.pp",
    "t2ms_tpu_torch.parallel.ring_attention", "t2ms_tpu_torch.parallel.tp",
    "t2ms_tpu_torch.parallel.dryrun", "t2ms_tpu_torch.pipeline",
    "t2ms_tpu_torch.pipeline.llm", "t2ms_tpu_torch.pipeline.captions",
    "t2ms_tpu_torch.pipeline.corpus", "t2ms_tpu_torch.pipeline.embeddings",
    "t2ms_tpu_torch.pipeline.mergers", "t2ms_tpu_torch.cli.quality_gate"]

# an import of jax/flax, of the JAX package or of tools/ — never the port
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|t2ms_tpu|tools)(?:[.\s]|$)", re.M)
# packages the card's machine lacks: imported inside a function, never at
# module level (an unindented import)
_ABSENT = ("pandas", "matplotlib", "imageio", "yaml", "sklearn")
_TOP_LEVEL_ABSENT = re.compile(
    r"^(?:import|from)\s+(?:%s)(?:[.\s]|$)" % "|".join(_ABSENT), re.M)


def test_import_leaves_out_jax_and_the_jax_package():
    roots = ("jax", "flax", "t2ms_tpu", "tools") + _ABSENT
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            f"roots = {roots!r}\n"
            "bad = sorted(m for m in sys.modules if m in roots or "
            "m.startswith(tuple(r + '.' for r in roots)))\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _py_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_import_check_names_every_module():
    """A module added to the port joins the fresh-interpreter import check
    (package __init__ files are imported as the modules' parents)."""
    found = {os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
             for p in _py_sources() if p.startswith(PKG)}
    leaves = {m for m in found if not m.endswith(".__init__")}
    assert leaves <= set(MODULES), sorted(leaves - set(MODULES))


def test_sources_import_no_jax_nor_jax_package():
    assert len(_py_sources()) >= len(MODULES)
    for path in _py_sources():
        with open(path) as f:
            src = f.read()
        assert not _FORBIDDEN.search(src), path
        assert not _TOP_LEVEL_ABSENT.search(src), path


def test_forbidden_pattern_spares_the_port():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from t2ms_tpu.ops import resize")
    assert _FORBIDDEN.search("import t2ms_tpu")
    assert _FORBIDDEN.search("from tools.import_torch_ckpt import x")
    assert not _FORBIDDEN.search("from t2ms_tpu_torch.ops import resize")
    assert not _FORBIDDEN.search("import t2ms_tpu_torch")
    assert _TOP_LEVEL_ABSENT.search("import pandas as pd")
    assert _TOP_LEVEL_ABSENT.search("import matplotlib.pyplot as plt")
    assert not _TOP_LEVEL_ABSENT.search("    import matplotlib")
    assert not _TOP_LEVEL_ABSENT.search("import pandas_like")


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")


@pytest.mark.parametrize("make", [
    lambda: t2ms_tpu_torch.resolve_device(),
    lambda: DiT(latent_len=6, latent_dim=8, d_model=32, depth=1,
                num_heads=2),
    lambda: LAVAE(num_hiddens=16, num_residual_hiddens=16,
                  embedding_dim=8, latent_grid=6),
    lambda: MLPDenoiser(latent_len=6, depth=1),
    lambda: make_cfg_sampler(
        DiT(6, 8, 32, 1, 2, device="cpu"),
        LAVAE(1, 16, 1, 16, 8, 6, device="cpu")),
    lambda: make_serving_sampler(
        DiT(6, 8, 32, 1, 2, device="cpu"),
        LAVAE(1, 16, 1, 16, 8, 6, device="cpu"), latent_shape=(8, 6),
        out_length=24),
    lambda: ServingEngine(DiT(6, 8, 32, 1, 2, device="cpu"),
                          LAVAE(1, 16, 1, 16, 8, 6, device="cpu"),
                          out_lengths=(24,), text_emb_dim=32),
    lambda: make_denoiser_train_step(
        DiT(6, 8, 32, 1, 2, device="cpu"),
        LAVAE(1, 16, 1, 16, 8, 6, device="cpu"),
        onecycle_adamw(DiT(6, 8, 32, 1, 2, device="cpu").parameters(), 4)),
    lambda: make_vae_train_step(
        LAVAE(1, 16, 1, 16, 8, 6, device="cpu"),
        onecycle_adamw(LAVAE(1, 16, 1, 16, 8, 6, device="cpu").parameters(),
                       4)),
    lambda: TSae(n_features=3, flow_dim=8, num_heads=2),
    lambda: TSaeDiffusion(n_features=3, flow_dim=8, num_heads=2),
    lambda: quality_gate.main(["--steps", "1", "--vae_steps", "1"]),
], ids=["resolve_device", "DiT", "LAVAE", "MLPDenoiser",
        "make_cfg_sampler", "make_serving_sampler", "ServingEngine",
        "make_denoiser_train_step", "make_vae_train_step", "TSae",
        "TSaeDiffusion", "quality_gate"])
def test_entry_points_refuse_missing_cuda(make):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_explicit_cpu_device_is_honoured():
    assert t2ms_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    dit = DiT(6, 8, 32, 1, 2, device="cpu")
    assert all(p.device.type == "cpu" for p in dit.parameters())
    x = torch.from_numpy(np.zeros((2, 8, 6), np.float32))
    assert dit(x, torch.zeros(2)).shape == (2, 8, 6)
