"""The port's samplers and serving engine held to the JAX package on the
CPU: ``make_cfg_sampler`` (euler / heun / midpoint) and
``make_serving_sampler`` against the JAX samplers on a tiny stack with
the same injected noise (drawn with ``jax.random`` and handed to both),
and the ``ServingEngine``'s batching contract (results equal direct
sampler calls, rows independent of batch composition, tiers, deadline,
admission control, shutdown).

Tolerance: f32 rtol 2e-4 / atol 2e-5 on the decoded series, the JAX
serving tests' own bound for the same comparison."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.sampling import make_cfg_sampler as j_make_cfg_sampler
from t2ms_tpu.serving import make_serving_sampler as j_make_serving_sampler
from t2ms_tpu_torch.convert import dit_params_from_jax, lavae_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.sampling import decode_trajectory, make_cfg_sampler
from t2ms_tpu_torch.serving import (EngineOverloaded, ServingEngine,
                                    make_serving_sampler)
from t2ms_tpu_torch.serving.engine import row_noise

T = 24
EMB = 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def stack():
    """Tiny LA-VAE + 1-block DiT in both packages with the same weights
    (adaLN perturbed so the block acts)."""
    jv = JLAVAE(in_channels=1, latent_grid=6, num_hiddens=16,
                num_residual_hiddens=16, embedding_dim=8)
    x = jax.random.normal(jax.random.key(0), (4, T))
    vp = jv.init(jax.random.key(1), x)
    jd = JDiT(latent_len=6, latent_dim=8, d_model=EMB, depth=1, num_heads=2)
    z, _ = jv.apply(vp, x, method=jv.encode)
    dp = jd.init(jax.random.key(2), z, jnp.zeros(4), jnp.zeros((4, EMB)))
    dp = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(3), p.shape),
        dp)
    tv = LAVAE(1, 16, 2, 16, 8, 6, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    td = DiT(6, 8, EMB, 1, 2, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(dp)))
    return dict(jv=jv, vp=vp, jd=jd, dp=dp, tv=tv, td=td, x=x,
                lat=tuple(z.shape[1:]))


@pytest.mark.parametrize("solver,steps", [("euler", 5), ("heun", 3),
                                          ("midpoint", 3)])
def test_cfg_sampler_matches_jax(stack, solver, steps):
    s = stack
    emb = jax.random.normal(jax.random.key(4), (4, EMB))
    key = jax.random.key(5)
    jsamp = j_make_cfg_sampler(s["jd"], s["jv"], "flowmatching", steps, 3.0,
                               T, collect_trajectory=True, solver=solver)
    jout = jsamp(s["dp"], s["vp"], key, s["x"], emb)
    # the JAX sampler's initial noise, handed to the port
    x_t0 = np.array(jax.random.normal(key, jout.latent_enc.shape))
    tsamp = make_cfg_sampler(s["td"], s["tv"], "flowmatching", steps, 3.0, T,
                             collect_trajectory=True, solver=solver,
                             device="cpu")
    tout = tsamp(np.array(s["x"]), np.array(emb),
                 x_t0=torch.from_numpy(x_t0))
    for name in ("series", "latent", "latent_enc", "trajectory"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert tuple(tout.trajectory.shape) == (steps, 4) + s["lat"]
    traj = decode_trajectory(s["tv"], tout.trajectory, T, sample_index=1)
    np.testing.assert_allclose(traj[-1].numpy(), tout.series[1].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_cfg_sampler_draws_from_generator(stack):
    s = stack
    samp = make_cfg_sampler(s["td"], s["tv"], total_step=2, out_length=T,
                            device="cpu")
    emb = np.zeros((4, EMB), np.float32)
    a = samp(np.array(s["x"]), emb, generator=torch.Generator().manual_seed(1))
    b = samp(np.array(s["x"]), emb, generator=torch.Generator().manual_seed(1))
    c = samp(np.array(s["x"]), emb, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a.series, b.series, rtol=0, atol=0)
    assert not torch.equal(a.series, c.series)
    assert a.trajectory is None and tuple(a.series.shape) == (4, T)


def _route_as_on_cuda(monkeypatch, dit, stack=False, split=False,
                      flax=False):
    """Let the fused gate pass as it does on CUDA (its DiT and opt-out
    conditions kept), let the stack, split and flax-path kernels' checks
    answer ``stack``, ``split`` and ``flax`` as their libraries would, and
    count each check ("stack?", "split?", "flax?"), the calls of each
    kernel path (which run the eager forward here) and of the eager
    module."""
    calls = {"stack?": 0, "split?": 0, "flax?": 0, "stack": 0, "split": 0,
             "flax": 0, "eager": 0}
    monkeypatch.setattr(
        dit_fast, "fused_path_eligible",
        lambda d, device: isinstance(d, DiT) and d.attention_impl == "auto")
    eager = dit.forward

    def count(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(dit_fast, "fast_forward_supported",
                        count("stack?", lambda d: stack))
    monkeypatch.setattr(dit_fast, "split_forward_supported",
                        count("split?", lambda d: split))
    monkeypatch.setattr(dit_fast, "flax_path_supported",
                        count("flax?", lambda d: flax))
    monkeypatch.setattr(dit_fast, "fast_dit_forward",
                        count("stack", lambda d, *a: eager(*a)))
    monkeypatch.setattr(dit_fast, "split_dit_forward",
                        count("split", lambda d, *a: eager(*a)))
    monkeypatch.setattr(dit_fast, "flax_path_forward",
                        count("flax", lambda d, *a: eager(*a)))
    monkeypatch.setattr(dit, "forward", count("eager", eager))
    return calls


@pytest.mark.parametrize("entry,geometry", [
    ("offline", dict(d_model=48, num_heads=2)),        # D not a 64 multiple
    ("offline", dict(compute_dtype=torch.float16)),    # no f16 kernel
    ("serving", dict(d_model=48, num_heads=2)),
    ("serving", dict(d_model=64, num_heads=8)),        # head width 8 < 16
])
def test_sampler_sends_every_cuda_dit_to_the_kernel(stack, monkeypatch,
                                                    entry, geometry):
    """Every DiT on CUDA goes to a kernel: a geometry that none of the
    stack, the split and the flax-path kernels takes (their libraries
    refuse these, as ``tests/test_torch_cuda.py`` checks on the card)
    raises out of the sampler build instead of running the eager model."""
    s = stack
    kw = dict(latent_len=6, latent_dim=8, d_model=EMB, depth=1, num_heads=2,
              device="cpu")
    kw.update(geometry)
    td = DiT(**kw)
    calls = _route_as_on_cuda(monkeypatch, td)
    with pytest.raises(ValueError, match="does not take"):
        if entry == "offline":
            make_cfg_sampler(td, s["tv"], total_step=2, out_length=T,
                             device="cpu")
        else:
            make_serving_sampler(td, s["tv"], "flowmatching", 2, s["lat"], T,
                                 device="cpu")
    assert calls == {"stack?": 1, "split?": 1, "flax?": 1, "stack": 0,
                     "split": 0, "flax": 0, "eager": 0}


def test_sampler_explicit_opt_out_runs_the_eager_model(stack, monkeypatch):
    """``attention_impl`` other than 'auto' is the one way onto the eager
    model on CUDA (the plain path oracle runs compare against)."""
    s = stack
    emb = np.random.default_rng(3).standard_normal((2, EMB)).astype(
        np.float32)
    x_t0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2,) + s["lat"]).astype(np.float32))
    run = lambda d: make_cfg_sampler(d, s["tv"], total_step=2, out_length=T,
                                     device="cpu")(
        np.array(s["x"])[:2], emb, x_t0=x_t0).series
    want = run(s["td"])
    plain = DiT(6, 8, EMB, 1, 2, attention_impl="einsum", device="cpu")
    plain.load_state_dict(s["td"].state_dict())
    calls = _route_as_on_cuda(monkeypatch, plain)
    got = run(plain)
    assert calls == {"stack?": 0, "split?": 0, "flax?": 0, "stack": 0,
                     "split": 0, "flax": 0, "eager": 2}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["offline", "serving"])
@pytest.mark.parametrize("takes_stack,takes_split,want", [
    (True, True, "stack"),          # the stack first, as in JAX
    (False, True, "split"),         # the scaled geometry
    (False, False, "flax"),         # the long-series geometry: flax path
    (False, False, None),           # none: refuse, never eager
])
def test_sampler_route_stack_then_split_then_refuse(
        stack, monkeypatch, entry, takes_stack, takes_split, want):
    """The route is picked once per sampler build (each check asked at
    most once, whatever the steps) and every step's forward goes to it:
    the stack, else the split, else the flax path, else a refusal."""
    s, steps = stack, 3
    td = DiT(6, 8, EMB, 1, 2, device="cpu")
    td.load_state_dict(s["td"].state_dict())
    calls = _route_as_on_cuda(monkeypatch, td, takes_stack, takes_split,
                              want == "flax")
    emb = np.zeros((2, EMB), np.float32)

    def build():
        if entry == "offline":
            return make_cfg_sampler(td, s["tv"], total_step=steps,
                                    out_length=T, device="cpu")
        return make_serving_sampler(td, s["tv"], "flowmatching", steps,
                                    s["lat"], T, device="cpu")

    if want is None:
        with pytest.raises(ValueError, match="does not take.*flax path.*"
                                             "eager model is not run"):
            build()
        assert calls == {"stack?": 1, "split?": 1, "flax?": 1, "stack": 0,
                         "split": 0, "flax": 0, "eager": 0}
        return
    sample = build()
    for _ in range(2):
        if entry == "offline":
            out = sample(np.array(s["x"])[:2], emb).series
        else:
            out = sample(np.array([1, 2], np.uint32), np.array([3.0, 3.0]),
                         emb)
        assert tuple(out.shape) == (2, T) and torch.isfinite(out).all()
    assert calls == {"stack?": 1, "split?": int(want != "stack"),
                     "flax?": int(want == "flax"), "stack": 0, "split": 0,
                     "flax": 0, "eager": 0, want: 2 * steps}


def test_solver_validation_and_ddpm_not_ported(stack):
    s = stack
    mk = lambda **kw: make_cfg_sampler(s["td"], s["tv"], device="cpu", **kw)
    with pytest.raises(ValueError, match="Unsupported backbone"):
        mk(backbone="vae")
    with pytest.raises(ValueError, match="Unsupported solver"):
        mk(solver="rk4")
    with pytest.raises(ValueError, match="ddim subsamples"):
        mk(solver="ddim")
    with pytest.raises(ValueError, match="sample_steps only applies"):
        mk(sample_steps=10)
    with pytest.raises(ValueError, match="higher-order solvers"):
        mk(backbone="ddpm", solver="heun")
    # the DDPM backbone is ported now (tests/test_torch_ddpm.py): both
    # solvers build
    assert callable(mk(backbone="ddpm"))
    assert callable(make_serving_sampler(s["td"], s["tv"], "ddpm",
                                         solver="ddim", sample_steps=4,
                                         latent_shape=s["lat"],
                                         out_length=T, device="cpu"))


@pytest.mark.parametrize("solver", ["euler", "heun"])
def test_serving_sampler_matches_jax(stack, solver):
    s = stack
    seeds = jnp.array([11, 12, 13], dtype=jnp.uint32)
    cfg = jnp.array([2.0, 6.0, 1.0], dtype=jnp.float32)
    emb = jax.random.normal(jax.random.key(6), (3, EMB))
    jsamp = j_make_serving_sampler(s["jd"], s["jv"], "flowmatching", 4,
                                   s["lat"], T, solver)
    want = np.asarray(jsamp(s["dp"], s["vp"], seeds, cfg, emb))
    x_t0 = np.array(jax.vmap(lambda k: jax.random.normal(
        jax.random.key(k), s["lat"], jnp.float32))(seeds))
    tsamp = make_serving_sampler(s["td"], s["tv"], "flowmatching", 4,
                                 s["lat"], T, solver, device="cpu")
    got = tsamp(np.array(seeds), np.array(cfg), np.array(emb),
                x_t0=torch.from_numpy(x_t0)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_serving_rows_independent_of_batch_composition(stack):
    s = stack
    samp = make_serving_sampler(s["td"], s["tv"], "flowmatching", 3,
                                s["lat"], T, device="cpu")
    emb = np.random.default_rng(7).standard_normal((4, EMB)).astype(
        np.float32)
    seeds = np.array([5, 6, 7, 8], np.uint32)
    cfg = np.array([1.0, 3.0, 5.0, 7.0], np.float32)
    full = samp(seeds, cfg, emb).numpy()
    perm = np.array([2, 0, 3, 1])
    permuted = samp(seeds[perm], cfg[perm], emb[perm]).numpy()
    np.testing.assert_allclose(permuted, full[perm], rtol=1e-6, atol=1e-7)
    solo = samp(seeds[2:3], cfg[2:3], emb[2:3]).numpy()
    np.testing.assert_allclose(solo[0], full[2], rtol=1e-5, atol=1e-6)
    noise = row_noise(seeds, s["lat"], "cpu")
    torch.testing.assert_close(noise[2], row_noise([7], s["lat"], "cpu")[0])


def _engine(s, **kw):
    kw.setdefault("total_step", 3)
    kw.setdefault("out_lengths", (T,))
    kw.setdefault("batch_tiers", (1, 2, 4))
    kw.setdefault("max_wait_ms", 40.0)
    kw.setdefault("text_emb_dim", EMB)
    kw.setdefault("device", "cpu")
    return ServingEngine(s["td"], s["tv"], **kw)


def test_engine_results_match_direct_sampler(stack):
    s = stack
    emb = np.random.default_rng(11).standard_normal((6, EMB)).astype(
        np.float32)
    with _engine(s) as eng:
        assert eng._latent[T] == s["lat"]
        futs = [eng.submit(emb[i], T, cfg_scale=1.0 + i, seed=100 + i)
                for i in range(6)]
        results = [f.result(timeout=120) for f in futs]
    direct = make_serving_sampler(s["td"], s["tv"], "flowmatching", 3,
                                  s["lat"], T, device="cpu")
    for i, r in enumerate(results):
        want = direct(np.array([100 + i], np.uint32),
                      np.array([1.0 + i], np.float32), emb[i:i + 1]).numpy()
        np.testing.assert_allclose(r.series, want[0], rtol=1e-5, atol=1e-6)
        assert r.seed == 100 + i and r.cfg_scale == 1.0 + i
        assert r.out_length == T and r.batched_with >= 1


def test_engine_multi_bucket_pads_to_tier_and_reports(stack):
    s = stack
    emb = np.zeros((EMB,), np.float32)
    with _engine(s, out_lengths=(16, T), max_wait_ms=200.0) as eng:
        rs = eng.generate([(emb, 16), (emb, T), (emb, 16), (emb, T),
                           (emb, T)])
        st = eng.stats()
    assert [r.series.shape for r in rs] == [(16,), (T,), (16,), (T,), (T,)]
    assert all(np.isfinite(r.series).all() for r in rs)
    assert st["requests"] == 5 and st["served_rows"] == 5
    assert set(st["per_bucket"]) == {"16", str(T)}
    for r in rs:
        assert r.batch_size >= r.batched_with
        assert r.batch_size in (1, 2, 4)
    padded = [r for r in rs if r.batch_size > r.batched_with]
    assert (st["padding_fraction"] > 0) == bool(padded)


def test_engine_deadline_flush_single_request(stack):
    s = stack
    with _engine(s, max_wait_ms=5.0) as eng:
        t0 = time.monotonic()
        r = eng.submit(np.zeros(EMB, np.float32), T).result(timeout=60)
        assert time.monotonic() - t0 < 60
    assert r.batch_size == 1 and r.batched_with == 1
    assert r.cfg_scale == 7.0 and r.seed == 0             # engine defaults


def test_engine_rejects_bad_requests_admission_and_shutdown(stack):
    s = stack
    with pytest.raises(ValueError, match="scaling_plan"):
        _engine(s, scaling_plan=object())
    with pytest.raises(ValueError):
        _engine(s, batch_tiers=())
    eng = _engine(s, max_wait_ms=10_000.0, max_pending=2,
                  batch_tiers=(1, 8))
    try:
        with pytest.raises(ValueError, match="bucket"):
            eng.submit(np.zeros(EMB, np.float32), 48)
        with pytest.raises(ValueError, match="text_emb"):
            eng.submit(np.zeros(EMB + 1, np.float32), T)
        f1 = eng.submit(np.zeros(EMB, np.float32), T)
        f2 = eng.submit(np.zeros(EMB, np.float32), T)
        with pytest.raises(EngineOverloaded):
            eng.submit(np.zeros(EMB, np.float32), T)
    finally:
        eng.close(drain=False)
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="shut down"):
            f.result(timeout=5)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(np.zeros(EMB, np.float32), T)


def test_engine_close_drains_and_concurrent_submitters(stack):
    s = stack
    eng = _engine(s, max_wait_ms=10_000.0, batch_tiers=(1, 4))
    futs, lock = [], threading.Lock()

    def client(k):
        f = eng.submit(np.full(EMB, 0.1 * k, np.float32), T, seed=k)
        with lock:
            futs.append((k, f))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    eng.close(drain=True)                  # serves what is queued first
    assert not eng._worker.is_alive() and not eng._completer.is_alive()
    got = {k: f.result(timeout=5) for k, f in futs}
    assert sorted(got) == list(range(6))
    assert all(r.seed == k and np.isfinite(r.series).all()
               for k, r in got.items())
    assert eng.stats()["served_rows"] == 6
