"""The port's DDPM backbone held to the JAX package on the CPU: every
function of ``models/backbones/ddpm.py`` in f32, the offline ancestral and
DDIM samplers against the JAX sampler fed JAX's own noise (x_t0 and, for
the ancestral loop, ``jax.random.normal(fold_in(key, j))`` at step j), the
DDPM train step's loss and gradients against the JAX step's on injected
draws, and the serving engine's DDPM rows: independent of batch
composition, and equal to the offline sampler under the same noise.

Tolerances: the schedule and the step functions rtol 1e-6 (XLA contracts
the linspace into FMAs and scans the cumprod in another order: an ulp or
two); the samplers 1e-4 * max|ref| (f32, summation order through the
DiT); the f32 train step's loss rtol 1e-4 and gradients 1e-4 * max|ref|
each; bf16 as the block tests: 3e-2 * max|ref| and correlation >= 0.999
with the JAX bf16 gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2ms_tpu.models.backbones import ddpm as jddpm
from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.sampling import make_cfg_sampler as j_make_cfg_sampler
from t2ms_tpu.training.trainer import TrainState
from t2ms_tpu.training.trainer import \
    make_denoiser_train_step as j_make_step
from t2ms_tpu.utils.prng import named_fold
from t2ms_tpu_torch.convert import dit_params_from_jax, lavae_params_from_jax
from t2ms_tpu_torch.models.backbones import ddpm
from t2ms_tpu_torch.models.denoisers import DiT
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.sampling import make_cfg_sampler
from t2ms_tpu_torch.serving import ServingEngine, make_serving_sampler
from t2ms_tpu_torch.serving.engine import row_draws
from t2ms_tpu_torch.training import make_denoiser_train_step

T_LEN, EMB, STEPS = 24, 64, 6
T_ = lambda a: torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------------ the backbone

@pytest.mark.parametrize("T", [1, 10, 100, 1000])
def test_schedule_matches_jax(T):
    j, p = jddpm.make_schedule(T), ddpm.make_schedule(T)
    assert p.total_steps == T
    for name in ("beta", "alpha", "alpha_bar"):
        got = getattr(p, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_step_functions_match_jax():
    T = 100
    js, ps = jddpm.make_schedule(T), ddpm.make_schedule(T)
    r = np.random.default_rng(0)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    x0, xt, eps, eps_pred = f(5, 8, 6), f(5, 8, 6), f(5, 8, 6), f(5, 8, 6)
    t = np.array([0, 1, 37, 98, 99], np.int32)
    t_prev = np.array([-1, 0, 20, 50, 98], np.int32)

    jq, je = jddpm.q_sample(js, x0, t, eps)
    pq, pe = ddpm.q_sample(ps, T_(x0), T_(t), T_(eps))
    _close(pq, jq, 1e-6)
    assert torch.equal(pe, T_(eps))

    jm, jv = jddpm.p_sample_mean_var(js, xt, eps_pred, t)
    pm, pv = ddpm.p_sample_mean_var(ps, T_(xt), T_(eps_pred), T_(t))
    _close(pm, jm, 1e-6)
    _close(pv, jv, 1e-6)

    key = jax.random.key(3)
    noise = jax.random.normal(key, xt.shape)          # p_sample's own draw
    _close(ddpm.p_sample(ps, T_(xt), T_(eps_pred), T_(t), noise=T_(noise)),
           jddpm.p_sample(js, key, xt, eps_pred, t), 1e-6)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a = ddpm.p_sample(ps, T_(xt), T_(eps_pred), T_(t), generator=g1)
    b = ddpm.p_sample(ps, T_(xt), T_(eps_pred), T_(t),
                      noise=torch.randn(xt.shape, generator=g2))
    assert torch.equal(a, b)

    _close(ddpm.ddim_step(ps, T_(xt), T_(eps_pred), T_(t), T_(t_prev)),
           jddpm.ddim_step(js, xt, eps_pred, t, t_prev), 1e-6)
    _close(ddpm.loss(T_(eps_pred), T_(eps)), jddpm.loss(eps_pred, eps), 1e-6)


@pytest.mark.parametrize("T,S", [(100, 25), (100, 100), (100, 99), (10, 1),
                                 (10, 7), (1000, 50)])
def test_ddim_timesteps_equal_jax(T, S):
    jt, jp = jddpm.ddim_timesteps(T, S)
    pt, pp = ddpm.ddim_timesteps(T, S)
    assert pt.dtype == np.int32 and pp.dtype == np.int32
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pp, jp)
    assert pp[-1] == -1 and (np.diff(pt) < 0).all()


def test_ddim_timesteps_refuse_out_of_range():
    for S in (0, 11):
        with pytest.raises(ValueError, match="sample_steps"):
            ddpm.ddim_timesteps(10, S)


# ------------------------------------------------------------ the samplers

@pytest.fixture(scope="module")
def stack():
    """Tiny LA-VAE + depth-2, d 64 DiT in both packages with the same
    weights (every parameter moved off its init: adaLN-zero hides
    faults)."""
    jv = JLAVAE(in_channels=1, latent_grid=6, num_hiddens=16,
                num_residual_hiddens=16, embedding_dim=8)
    x = jax.random.normal(jax.random.key(0), (4, T_LEN))
    vp = jv.init(jax.random.key(1), x)
    jd = JDiT(latent_len=6, latent_dim=8, d_model=EMB, depth=2, num_heads=4)
    z, _ = jv.apply(vp, x, method=jv.encode)
    dp = jd.init(jax.random.key(2), z, jnp.zeros(4), jnp.zeros((4, EMB)))
    r = np.random.default_rng(3)
    dp = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * r.standard_normal(
            p.shape).astype(np.float32)), dp)
    tv = LAVAE(1, 16, 2, 16, 8, 6, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    td = DiT(6, 8, EMB, 2, 4, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(dp)))
    return dict(jv=jv, vp=vp, jd=jd, dp=dp, tv=tv, td=td, x=x,
                lat=tuple(z.shape[1:]))


@pytest.mark.parametrize("solver,sample_steps", [("euler", None),
                                                 ("ddim", 4), ("ddim", None)])
def test_offline_sampler_matches_jax(stack, solver, sample_steps):
    s = stack
    emb = jax.random.normal(jax.random.key(4), (4, EMB))
    key = jax.random.key(5)
    jsamp = j_make_cfg_sampler(s["jd"], s["jv"], "ddpm", STEPS, 3.0, T_LEN,
                               collect_trajectory=True, solver=solver,
                               sample_steps=sample_steps)
    jout = jsamp(s["dp"], s["vp"], key, s["x"], emb)
    shape = jout.latent_enc.shape
    x_t0 = np.array(jax.random.normal(key, shape))
    # the JAX ancestral loop's draw at step j (sampler.py ddpm_step)
    noise = np.stack([np.array(jax.random.normal(jax.random.fold_in(key, j),
                                                 shape))
                      for j in range(STEPS)])
    tsamp = make_cfg_sampler(s["td"], s["tv"], "ddpm", STEPS, 3.0, T_LEN,
                             collect_trajectory=True, solver=solver,
                             sample_steps=sample_steps, device="cpu")
    tout = tsamp(np.array(s["x"]), np.array(emb), x_t0=T_(x_t0),
                 step_noise=T_(noise) if solver == "euler" else None)
    n_steps = (STEPS if solver == "euler" else
               len(ddpm.ddim_timesteps(STEPS, sample_steps or STEPS)[0]))
    assert tuple(tout.trajectory.shape) == (n_steps, 4) + s["lat"]
    for name in ("series", "latent", "latent_enc", "trajectory"):
        _close(getattr(tout, name).numpy(), getattr(jout, name), 1e-4)


def test_ancestral_sampler_draws_step_noise_after_x_t0(stack):
    """Without ``step_noise`` each step's noise comes from the generator
    after x_t0: the same seed repeats, and injecting the generator's own
    sequence gives the same series."""
    s = stack
    samp = make_cfg_sampler(s["td"], s["tv"], "ddpm", 3, 2.0, T_LEN,
                            device="cpu")
    emb = np.zeros((4, EMB), np.float32)
    x = np.array(s["x"])
    a = samp(x, emb, generator=torch.Generator().manual_seed(1))
    b = samp(x, emb, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.series, b.series, rtol=0, atol=0)
    g = torch.Generator().manual_seed(1)
    x_t0 = torch.randn((4,) + s["lat"], generator=g)
    noise = torch.stack([torch.randn((4,) + s["lat"], generator=g)
                         for _ in range(3)])
    c = samp(x, emb, x_t0=x_t0, step_noise=noise)
    torch.testing.assert_close(a.series, c.series, rtol=0, atol=0)


def test_timestep_reaches_the_dit_as_an_integer(stack, monkeypatch):
    """The denoiser sees t = T-1-j (ancestral) or the DDIM sub-schedule as
    int32, never in the latent's dtype: the DiT scales it by 100 in f32."""
    s = stack
    seen = []
    fwd = s["td"].forward

    def spy(x, t, *a):
        seen.append((t.dtype, t[0].item()))
        return fwd(x, t, *a)

    monkeypatch.setattr(s["td"], "forward", spy)
    emb = np.zeros((4, EMB), np.float32)
    make_cfg_sampler(s["td"], s["tv"], "ddpm", STEPS, 2.0, T_LEN,
                     device="cpu")(np.array(s["x"]), emb)
    make_cfg_sampler(s["td"], s["tv"], "ddpm", 100, 2.0, T_LEN,
                     solver="ddim", sample_steps=3,
                     device="cpu")(np.array(s["x"]), emb)
    assert seen == ([(torch.int32, STEPS - 1 - j) for j in range(STEPS)]
                    + [(torch.int32, 99), (torch.int32, 50),
                       (torch.int32, 0)])


# ----------------------------------------------------------- the train step

def _grab_grads():
    """An optax transformation whose state is the last gradient: the JAX
    step's new opt_state is the gradient tree, its update zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_train_step_loss_and_grads_match_jax(stack, dt):
    s = stack
    jd = JDiT(latent_len=6, latent_dim=8, d_model=EMB, depth=2, num_heads=4,
              compute_dtype=getattr(jnp, dt))
    jstep = j_make_step(jd, s["jv"], _grab_grads(), backbone="ddpm",
                        total_step=100, donate=False)
    td = DiT(6, 8, EMB, 2, 4, compute_dtype=getattr(torch, dt),
             device="cpu")
    td.load_state_dict(s["td"].state_dict())
    tstep = make_denoiser_train_step(
        td, s["tv"], torch.optim.SGD(td.parameters(), lr=0.0), "ddpm",
        total_step=100, device="cpu")
    r = np.random.default_rng(2)
    for i in range(2):
        x = jnp.asarray(r.standard_normal((4, T_LEN)).astype(np.float32))
        e = jnp.asarray(r.standard_normal((4, EMB)).astype(np.float32))
        key = jax.random.key(20 + i)
        state = TrainState(s["dp"], _grab_grads().init(s["dp"]),
                           jnp.zeros((), jnp.int32))
        state, jloss = jstep(state, s["vp"], key, x, e)
        z = s["jv"].apply(s["vp"], x, method=s["jv"].encode)[0]
        draws = dict(
            u=T_(jax.random.uniform(named_fold(key, "t"), (4,))),
            x_0=T_(jax.random.normal(named_fold(key, "noise"), z.shape)),
            coin=T_(jax.random.uniform(named_fold(key, "cfg"), ())))
        tloss = tstep(T_(x), T_(e), **draws)
        np.testing.assert_allclose(tloss.item(), float(jloss),
                                   rtol=1e-4 if dt == "float32" else 3e-2)
        want = dit_params_from_jax(_np_tree(state.opt_state))
        for name, p in td.named_parameters():
            g, w = p.grad.numpy(), want[name].numpy()
            if dt == "float32":
                _close(g, w, 1e-4)
            else:
                _close(g, w, 3e-2)
                if w.size > 8:
                    assert np.corrcoef(g.ravel(), w.ravel())[0, 1] >= 0.999


def test_train_step_timestep_is_floor_of_u_times_T(stack, monkeypatch):
    s = stack
    td = DiT(6, 8, EMB, 2, 4, device="cpu")
    seen = []
    fwd = td.forward
    monkeypatch.setattr(td, "forward",
                        lambda x, t, *a: seen.append(t) or fwd(x, t, *a))
    step = make_denoiser_train_step(
        td, s["tv"], torch.optim.SGD(td.parameters(), lr=0.0), "ddpm",
        total_step=100, device="cpu")
    u = torch.tensor([0.0, 0.0099, 0.5, 0.99999])
    step(torch.zeros(4, T_LEN), torch.zeros(4, EMB), u=u,
         x_0=torch.zeros((4,) + s["lat"]), coin=torch.tensor(0.9))
    assert seen[0].dtype == torch.int32
    assert seen[0].tolist() == [0, 0, 50, 99]


# ------------------------------------------------------------- the engine

def test_serving_ddpm_rows_are_independent_and_match_offline(stack):
    s = stack
    emb = np.asarray(jax.random.normal(jax.random.key(6), (3, EMB)))
    seeds = np.array([11, 12, 13], np.uint32)
    cfg = np.array([2.0, 6.0, 1.0], np.float32)
    serve = make_serving_sampler(s["td"], s["tv"], "ddpm", STEPS, s["lat"],
                                 T_LEN, device="cpu")
    full = serve(seeds, cfg, emb)
    alone = serve(seeds[1:2], cfg[1:2], emb[1:2])
    torch.testing.assert_close(full[1:2], alone, rtol=1e-5, atol=1e-6)
    # each row's draws: x_t0, then its (T, C, H) step noise, one generator
    x_t0, noise = row_draws(seeds, s["lat"], STEPS, "cpu")
    assert tuple(noise.shape) == (STEPS, 3) + s["lat"]
    g = torch.Generator().manual_seed(12)
    torch.testing.assert_close(x_t0[1], torch.randn(s["lat"], generator=g))
    torch.testing.assert_close(noise[:, 1],
                               torch.randn((STEPS,) + s["lat"], generator=g))
    torch.testing.assert_close(serve(seeds, cfg, emb, x_t0=x_t0,
                                     step_noise=noise), full, rtol=0, atol=0)
    with pytest.raises(ValueError, match="step_noise"):
        serve(seeds, cfg, emb, x_t0=x_t0)
    # the engine's sampler and the offline one agree under the same noise
    # (the offline sampler's per-sample scale is one scalar: one row)
    off = make_cfg_sampler(s["td"], s["tv"], "ddpm", STEPS, 6.0, T_LEN,
                           device="cpu")
    o = off(np.array(s["x"])[:1], emb[1:2], x_t0=x_t0[1:2],
            step_noise=noise[:, 1:2]).series
    torch.testing.assert_close(o, full[1:2], rtol=1e-5, atol=1e-6)


def test_engine_serves_ddpm_and_ddim(stack):
    s = stack
    emb = np.asarray(jax.random.normal(jax.random.key(7), (5, EMB)))
    for solver, steps in (("euler", None), ("ddim", 3)):
        with ServingEngine(s["td"], s["tv"], backbone="ddpm",
                           total_step=STEPS, solver=solver,
                           sample_steps=steps, out_lengths=(T_LEN,),
                           batch_tiers=(1, 4), max_wait_ms=1.0,
                           text_emb_dim=EMB, device="cpu") as eng:
            res = eng.generate([(emb[i], T_LEN, 3.0, 100 + i)
                                for i in range(5)])
            solo = eng.submit(emb[2], T_LEN, 3.0, 102).result(timeout=60)
        assert all(r.series.shape == (T_LEN,) for r in res)
        np.testing.assert_allclose(solo.series, res[2].series, rtol=1e-5,
                                   atol=1e-6)
