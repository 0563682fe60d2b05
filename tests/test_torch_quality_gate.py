"""The port's quality gate (``t2ms_tpu_torch/cli/quality_gate.py``) on the
CPU against ``scripts/quality_gate.py``: the bucket schedule and its
refusal, the argparse refusals, the noise floors of the t2s and deadlift
tracks, the summary and gates over JAX's own per-bucket rows, the JSON's
keys (``mse_beats_noise`` named ``mse_under_half_noise_floor``) and exit
code, the EMA shadow being what is scored, and the C-FID block with its
cfg sweep and solver A/B. The two JAX runs (``--denoiser MLP`` at one
step) start as subprocesses when the module's first test runs and are
read by the last tests."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from t2ms_tpu_torch.cli import quality_gate as q
from t2ms_tpu_torch.evaluate.ts2vec import TS2Vec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "quality_gate.py")
TINY = ["--denoiser", "MLP", "--latent_grid", "6", "--steps", "1",
        "--vae_steps", "1", "--batch", "8", "--sample_steps", "1"]
TRACKS = {"t2s": [], "deadlift": ["--track", "deadlift"]}
GATE_KEY = {"mse_beats_noise": "mse_under_half_noise_floor"}


@pytest.fixture(scope="module")
def jax_gate():
    """``scripts/quality_gate.py`` as a module (its ``main`` reads
    ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location("jax_quality_gate",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def jax_runs():
    """The JAX script's JSON on each track, at TINY settings on the CPU:
    both subprocesses start with the module and are read on demand."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {t: subprocess.Popen(
        [sys.executable, JAX_SCRIPT] + TINY + extra, cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for t, extra in TRACKS.items()}
    got = {}

    def result(track):
        if track not in got:
            p = procs[track]
            out, err = p.communicate(timeout=600)
            assert p.returncode in (0, 1), err[-3000:]
            got[track] = (json.loads(out), p.returncode)
        return got[track]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(argv, capsys):
    """The port's gate on the CPU: (summary, exit code)."""
    rc = q.main(argv, device="cpu")
    return json.loads(capsys.readouterr().out), rc


def _keys(d):
    """The nested key set, with JAX's gate key under the port's name."""
    return {GATE_KEY.get(k, k): (_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


@pytest.mark.parametrize("buckets,ratios", [
    ((96,), ""), ((48, 96, 192), ""), ((48, 96, 192), "1,1,2"),
    ((48, 96, 192), "3,1,1"), ((96,), "2"), ((48, 96, 192), "1,1"),
    ((48, 96, 192), "0,1,1"), ((96,), "1,1")])
def test_bucket_schedule_matches_jax(jax_gate, buckets, ratios):
    try:
        want = jax_gate.build_bucket_schedule(buckets, ratios)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            q.build_bucket_schedule(buckets, ratios)
        assert str(got.value) == str(e)
    else:
        assert q.build_bucket_schedule(buckets, ratios) == want


@pytest.mark.parametrize("argv", [
    ["--cfg_sweep", "1,3"], ["--solver_ab", "euler:100"],
    ["--track", "deadlift", "--vae_kind", "tsae"],
    ["--track", "deadlift", "--bucket_steps", "1,1"],
    ["--track", "deadlift", "--bucket_steps", "0,1,1"],
    ["--bucket_steps", "1,2"], ["--track", "ettm1"], ["--solver", "rk4"],
    ["--attention_impl", "fused"]],
    ids=["sweep_without_cfid", "solver_ab_without_cfid", "tsae_deadlift",
         "ratios_short", "ratio_zero", "ratios_t2s", "track", "solver",
         "impl"])
def test_argparse_refusals_match_jax(jax_gate, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT] + argv)
    with pytest.raises(SystemExit) as want:
        jax_gate.main()
    with pytest.raises(SystemExit) as got:
        q.main(argv, device="cpu")
    assert want.value.code == got.value.code == 2


def _flags(call, monkeypatch):
    """(dest, option strings, default, type, choices, action class) of
    every flag of the parser that ``call`` builds."""
    seen = []

    def parse(self, args=None, namespace=None):
        seen.extend((a.dest, tuple(a.option_strings), a.default, a.type,
                     a.choices, type(a).__name__) for a in self._actions)
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(SystemExit):
            call()
    return seen


def test_flags_and_defaults_match_jax(jax_gate, monkeypatch):
    """Every flag of the JAX script, with its default and choices, and no
    other."""
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT])
    want = _flags(jax_gate.main, monkeypatch)
    assert len(want) == 19            # -h and the 18 flags
    assert _flags(lambda: q.main([], device="cpu"), monkeypatch) == want


def test_make_batch_is_the_corpus():
    """Each call draws from its own generator; the multivariate copies
    are phase-shifted versions of the univariate series' class."""
    x, e, cls = q.make_batch(5, 16, 96)
    x2, _, _ = q.make_batch(5, 16, 96)
    np.testing.assert_array_equal(x, x2)
    assert x.dtype == np.float32 and x.shape == (16, 96)
    np.testing.assert_array_equal(e.argmax(1), cls)
    assert e.shape == (16, 128) and e.sum() == 16
    xm, _, clsm = q.make_batch(5, 16, 48, n_feat=7)
    assert xm.shape == (16, 7, 48)
    np.testing.assert_array_equal(clsm, q.make_batch(5, 16, 48)[2])
    assert 0.9 < float(np.corrcoef(xm[:, 0].ravel(),
                                   q.make_batch(5, 16, 48)[0].ravel())[0, 1])


def test_gate_names_the_mse_test():
    res = {"MSE": 0.1, "MSE_noise_floor": 0.21, "SD": 0.5, "KD": 2.0,
           "C-FID": 1.0}
    assert q.gate(res) == {"mse_under_half_noise_floor": True,
                           "finite": True, "distribution_close": True}
    assert not q.gate(dict(res, MSE=0.105))["mse_under_half_noise_floor"]
    assert not q.gate(dict(res, KD=-3.0))["distribution_close"]
    assert not q.gate(dict(res, **{"C-FID": float("nan")}))["finite"]


def test_ema_decay_scores_the_shadow(monkeypatch, capsys):
    """With --ema_decay the sampler sees the shadow, not the live
    weights the last step left."""
    live, shadow, scored = {}, {}, []
    real_step, real_ema = q.make_denoiser_train_step, q.setup_cli_ema
    real_sampler = q.make_cfg_sampler

    def make_step(dit, *a, **k):
        step = real_step(dit, *a, **k)

        def run(*args, **kw):
            loss = step(*args, **kw)
            live.update({n: p.detach().clone()
                         for n, p in dit.named_parameters()})
            return loss
        return run

    def ema_setup(decay, model):
        ema, update = real_ema(decay, model)
        shadow["ema"] = ema
        return ema, update

    def sampler(dit, *a, **k):
        scored.append({n: p.detach().clone()
                       for n, p in dit.named_parameters()})
        return real_sampler(dit, *a, **k)

    monkeypatch.setattr(q, "make_denoiser_train_step", make_step)
    monkeypatch.setattr(q, "setup_cli_ema", ema_setup)
    monkeypatch.setattr(q, "make_cfg_sampler", sampler)
    argv = ["--denoiser", "MLP", "--latent_grid", "6", "--steps", "3",
            "--vae_steps", "1", "--batch", "8", "--sample_steps", "1",
            "--ema_decay", "0.5"]
    res, rc = _run(argv, capsys)
    assert rc == int(not all(res["gates"].values()))
    assert len(scored) == 1
    moved = 0
    for n, p in scored[0].items():
        torch.testing.assert_close(p, shadow["ema"][n], rtol=0, atol=0)
        moved += int(not torch.equal(p, live[n]))
    assert moved > len(scored[0]) // 2


def test_cfid_block_scores_sweep_and_solvers(monkeypatch, capsys):
    """C-FID on the sampled middle bucket, the cfg sweep and the solver
    A/B from the same trained DiT (TS2Vec cut to 2 iterations here); the
    sweep's and the A/B's arm at the run's own settings repeat the main
    sample, as its reuse promises."""
    fit = TS2Vec.fit
    monkeypatch.setattr(TS2Vec, "fit", lambda self, data, **kw: fit(
        self, data, **dict(kw, n_iters=2)))
    argv = ["--latent_grid", "6", "--steps", "2", "--vae_steps", "1",
            "--batch", "8", "--sample_steps", "2", "--eval_cfid",
            "--cfg_scale", "3", "--cfg_sweep", "1,3",
            "--solver_ab", "euler:2,heun:1,midpoint:1"]
    res, rc = _run(argv, capsys)
    assert set(res["cfg_sweep"]) == {"1.0", "3.0"}
    assert set(res["solver_ab"]) == {"euler:2", "heun:1", "midpoint:1"}
    for arm in (res["cfg_sweep"]["3.0"], res["solver_ab"]["euler:2"]):
        assert arm == {"MSE": res["MSE"], "C-FID": res["C-FID"]}
    assert all(np.isfinite(v) for d in (res["cfg_sweep"], res["solver_ab"])
               for arm in d.values() for v in arm.values())
    assert res["cfg_sweep"]["1.0"]["MSE"] != res["MSE"]
    assert rc == int(not all(res["gates"].values()))


def test_cfid_block_ddim_pairs_need_ddpm(monkeypatch, capsys):
    fit = TS2Vec.fit
    monkeypatch.setattr(TS2Vec, "fit", lambda self, data, **kw: fit(
        self, data, **dict(kw, n_iters=2)))
    base = TINY + ["--eval_cfid", "--solver_ab", "euler:1,ddim:1"]
    res, _ = _run(base + ["--backbone", "ddpm"], capsys)
    assert set(res["solver_ab"]) == {"euler:1", "ddim:1"}
    assert np.isfinite(res["solver_ab"]["ddim:1"]["C-FID"])
    with pytest.raises(ValueError, match="ddim subsamples the DDPM"):
        q.main(base, device="cpu")


def test_t2s_json_and_floor_match_jax(jax_runs, capsys):
    want, want_rc = jax_runs("t2s")
    res, rc = _run(TINY, capsys)
    assert _keys(res) == _keys(want)
    assert abs(res["MSE_noise_floor"] - want["MSE_noise_floor"]) <= 1e-12
    assert res["MSE_noise_floor"] == pytest.approx(0.20946913918608598,
                                                   abs=1e-12)
    assert rc == int(not all(res["gates"].values()))
    assert want_rc == int(not all(want["gates"].values()))


def test_deadlift_floors_match_jax(jax_runs, capsys):
    want, _ = jax_runs("deadlift")
    res, rc = _run(TINY + TRACKS["deadlift"], capsys)
    assert _keys(res) == _keys(want)
    for L in ("48", "96", "192"):
        assert abs(res["per_bucket"][L]["MSE_noise_floor"]
                   - want["per_bucket"][L]["MSE_noise_floor"]) <= 1e-12
    assert abs(res["MSE_noise_floor"] - want["MSE_noise_floor"]) <= 1e-12
    assert rc == int(not all(res["gates"].values()))


def test_summary_and_gates_of_jax_rows(jax_runs):
    """Given JAX's deadlift rows, the port's summary is JAX's top level
    and its gates JAX's, key for key."""
    want, _ = jax_runs("deadlift")
    rows = {int(L): row for L, row in want["per_bucket"].items()}
    res = q.summarize(rows, want["vae_recon_error"],
                      want["final_train_loss"])
    assert res == {k: v for k, v in want.items() if k != "gates"}
    assert q.gate(res) == {GATE_KEY.get(k, k): v
                           for k, v in want["gates"].items()}


# ---------------------------------------- the motion track against JAX

MOTION_B = 2


def _uniform_ok(t, bound):
    """All of t within (-bound, bound) and, for tensors of 256 values or
    more, its largest magnitude above 0.9 bound and its std within 2.7 /
    sqrt(n) (six standard errors of a uniform sample's std) of
    bound / sqrt(3)."""
    t = np.asarray(t, np.float64).ravel()
    if np.abs(t).max() > bound * (1 + 1e-6):
        return False
    if t.size < 256:
        return True
    rel = t.std() / (bound / np.sqrt(3)) - 1
    return np.abs(t).max() > 0.9 * bound and abs(rel) < 2.7 / np.sqrt(t.size)


def _family(name, mod, p):
    """The initializer the JAX package gives the port's parameter ``name``
    of module ``mod``: ("zeros",), ("ones",) or ("uniform", bound) —
    xavier-uniform Linear kernels with zero bias, zero adaLN (adaLN-zero),
    the torch-conv uniform U(+-1/sqrt(fan_in)) of t2ms_tpu/ops/conv1d.py
    (fan_in = weight.size(1) * kernel, for ConvTranspose1d too) on conv
    weights and biases, LayerNorm scale one and bias zero."""
    if isinstance(mod, torch.nn.Linear):
        if "adaLN_modulation" in name or name.endswith("bias"):
            return ("zeros",)
        return ("uniform", float(np.sqrt(6 / (mod.in_features
                                               + mod.out_features))))
    if isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d,
                        torch.nn.Conv2d)):
        w = mod.weight
        return ("uniform", float(w.shape[1] * np.prod(w.shape[2:])) ** -0.5)
    if isinstance(mod, torch.nn.LayerNorm):
        return ("ones",) if name.endswith("weight") else ("zeros",)
    raise AssertionError(f"{name}: no JAX initializer for {type(mod)}")


def _jax_motion_models(dt):
    """The JAX gate's motion models (scripts/quality_gate.py) and their
    initial params from the gate's keys 0 and 1."""
    import jax
    import jax.numpy as jnp
    from t2ms_tpu.models.denoisers import DiT as JDiT
    from t2ms_tpu.models.vae import LAVAE as JLAVAE
    x0, e0, _ = q.make_batch(0, MOTION_B, 96, 10)
    jv = JLAVAE(in_channels=10, num_residual_layers=3, latent_grid=64,
                exact_length_output=True)
    vp = jv.init(jax.random.key(0), jnp.asarray(x0))
    jd = JDiT(latent_len=64, latent_dim=64, compute_dtype=dt)
    z, _ = jv.apply(vp, jnp.asarray(x0), method=jv.encode)
    dp = jd.init(jax.random.key(1), z, jnp.zeros(MOTION_B), jnp.asarray(e0))
    return jv, vp, jd, dp


def test_motion_models_draw_from_jax_initializers():
    """Every parameter of the gate's motion models as the port builds them
    (``_build_models``: the 10-feature LAVAE with 3 residual layers and
    exact_length_output, the DiT over the 64 x 64 latent) is drawn from the
    initializer family and bounds that JAX's gate draws the same parameter
    from: the family is read off the port's module, and JAX's initial
    value of that parameter (through ``t2ms_tpu_torch.convert``) is held
    to it as well, by range and std over each tensor."""
    import jax
    import jax.numpy as jnp
    from t2ms_tpu_torch.convert import (dit_params_from_jax,
                                        lavae_params_from_jax)
    vae, dit = q._build_models(q.get_args(["--track", "motion"]), "cpu")
    _, vp, _, dp = _jax_motion_models(jnp.bfloat16)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    seen = 0
    for model, want in ((vae, lavae_params_from_jax(tree(vp))),
                        (dit, dit_params_from_jax(tree(dp)))):
        assert set(want) == {n for n, _ in model.named_parameters()}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                name = f"{mname}.{pname}" if mname else pname
                fam = _family(name, mod, p)
                for who, t in (("port", p.detach().float().numpy()),
                               ("jax", want[name].float().numpy())):
                    assert t.shape == tuple(p.shape), (name, who)
                    if fam[0] == "zeros":
                        ok = not t.any()
                    elif fam[0] == "ones":
                        ok = (t == 1).all()
                    else:
                        ok = _uniform_ok(t, fam[1])
                    assert ok, (name, who, fam)
                seen += 1
    assert seen == len(list(vae.parameters())) + len(list(dit.parameters()))


def test_motion_loop_matches_jax_from_jax_weights():
    """Two VAE steps and three denoiser steps of the gate's motion loop
    (B=2 series of 10 features, length 96; warmup-cosine AdamW on the VAE,
    one-cycle AdamW over 3 steps on the DiT; flow matching over 100 steps;
    the gate's --f32 denoiser) from JAX's initial weights, with JAX's draws
    injected into the port's denoiser step: the losses within rtol 1e-4
    and, after the steps, every weight within 2 * the sum of the applied
    learning rates (Adam's normalised update turns a gradient that differs
    by rounding near zero into a full +-lr step) and rtol 1e-4. The
    denoiser stage starts both sides from JAX's pretrained VAE."""
    import jax
    import jax.numpy as jnp
    from t2ms_tpu.training import optim as joptim
    from t2ms_tpu.training.trainer import TrainState
    from t2ms_tpu.training.trainer import \
        make_denoiser_train_step as j_make_step
    from t2ms_tpu.training.trainer import make_vae_train_step as j_vae_step
    from t2ms_tpu_torch.convert import (dit_params_from_jax,
                                        lavae_params_from_jax)
    from t2ms_tpu_torch.training import (make_denoiser_train_step,
                                         make_vae_train_step,
                                         onecycle_adamw, onecycle_schedule,
                                         vae_schedule, warmup_cosine_adamw)
    from test_torch_training import _draws

    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jv, vp, jd, dp = _jax_motion_models(jnp.float32)
    vae, dit = q._build_models(
        q.get_args(["--track", "motion", "--f32"]), "cpu")
    vae.load_state_dict(lavae_params_from_jax(tree(vp)))
    dit.load_state_dict(dit_params_from_jax(tree(dp)))

    jopt = joptim.warmup_cosine_adamw(1e-3, warmup_steps=100,
                                      cosine_period=600)
    jstep = j_vae_step(jv, jopt, donate=False)
    sv = TrainState(vp, jopt.init(vp), jnp.zeros((), jnp.int32))
    tstep = make_vae_train_step(vae, warmup_cosine_adamw(
        vae.parameters(), 1e-3, warmup_steps=100, cosine_period=600),
        device="cpu")
    for i in range(2):
        x, _, _ = q.make_batch(i, MOTION_B, 96, 10)
        sv, (jl, jre) = jstep(sv, jnp.asarray(x))
        tl, tre = tstep(torch.from_numpy(x))
        np.testing.assert_allclose([tl.item(), tre.item()],
                                   [float(jl), float(jre)], rtol=1e-4)
    sched = vae_schedule(1e-3, warmup_steps=100, cosine_period=600)
    atol = 2 * sum(sched(i) for i in range(2)) + 1e-7
    want = lavae_params_from_jax(tree(sv.params))
    for name, p in vae.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=atol, err_msg=name)

    vp = sv.params
    vae.load_state_dict(lavae_params_from_jax(tree(vp)))
    jopt = joptim.onecycle_adamw(3)
    jstep = j_make_step(jd, jv, jopt, "flowmatching", 100, donate=False)
    sd = TrainState(dp, jopt.init(dp), jnp.zeros((), jnp.int32))
    tstep = make_denoiser_train_step(dit, vae, onecycle_adamw(
        dit.parameters(), 3), "flowmatching", 100, device="cpu")
    for i in range(3):
        x, e, _ = q.make_batch(1000 + i, MOTION_B, 96, 10)
        key = jax.random.key(i)
        sd, jl = jstep(sd, vp, key, jnp.asarray(x), jnp.asarray(e))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(e),
                   **_draws(key, jv, vp, jnp.asarray(x)))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    sched = onecycle_schedule(3)
    atol = 2 * sum(sched(i) for i in range(3))
    want = dit_params_from_jax(tree(sd.params))
    for name, p in dit.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("track", ["t2s", "deadlift"])
def test_gate_models_init_from_two_streams(monkeypatch, track):
    """``_build_models`` seeds the VAE's init and the denoiser's from
    ``root_key(0)`` and ``root_key(1)`` through ``torch_seed``: two seeds
    whose low 32 bits differ, so the two inits draw apart on the CPU, as
    JAX's ``key(0)`` and ``key(1)`` do."""
    from t2ms_tpu_torch.utils.prng import root_key, torch_seed
    seeds = []
    real = torch.manual_seed
    monkeypatch.setattr(q.torch, "manual_seed",
                        lambda s: seeds.append(s) or real(s))
    q._build_models(q.get_args(TINY + TRACKS[track]), "cpu")
    assert seeds == [torch_seed(root_key(0)), torch_seed(root_key(1))]
    assert (seeds[0] ^ seeds[1]) & 0xFFFFFFFF
    draws = [torch.randn(16, generator=torch.Generator().manual_seed(s))
             for s in seeds]
    assert not torch.allclose(draws[0], draws[1])
