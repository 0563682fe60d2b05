"""The port's training path held to the JAX package on the CPU: the LR
schedules and AdamW against optax step by step, the optax -> torch AdamW
state bridge, the denoiser train step against JAX
``make_denoiser_train_step`` (the flax path: on the CPU both packages run
the eager DiT) with the JAX draws injected, its accumulation, precoded,
nan_guard and refusal contracts, the LA-VAE step, and the routing of the
train forward (block kernels, else the flax path, else a refusal).

Tolerances: schedules rtol 2e-6 and atol 2e-7 * the peak lr (optax
evaluates in f32, where the cosine's cancellation near its floor loses
digits relative to the peak); AdamW on a quadratic rtol 1e-4 / atol 1e-5
(the JAX package's own torch-vs-optax bound); parameters after train steps
atol 2 * the sum of the applied lrs (Adam's normalised update turns a
gradient that differs by rounding near zero into a full +-lr step) and rtol 1e-4;
losses rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.training import optim as joptim
from t2ms_tpu.training.trainer import TrainState
from t2ms_tpu.training.trainer import \
    make_denoiser_train_step as j_make_step
from t2ms_tpu.training.trainer import make_vae_train_step as j_make_vae_step
from t2ms_tpu.utils.prng import named_fold
from t2ms_tpu_torch.convert import (adamw_state_from_optax,
                                    dit_params_from_jax,
                                    lavae_params_from_jax)
from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.training import (ScheduledAdamW, make_denoiser_train_step,
                                     make_vae_train_step, onecycle_adamw,
                                     onecycle_schedule, vae_schedule,
                                     warmup_cosine_adamw)
from t2ms_tpu_torch.training import trainer as ttrainer

EMB, T = 32, 24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ----------------------------------------------------------------- optim

@pytest.mark.parametrize("total", [1, 2, 3, 4, 500])
def test_onecycle_schedule_matches_optax(total):
    want = optax.cosine_onecycle_schedule(
        transition_steps=max(total, 4), peak_value=1e-4, pct_start=0.3,
        div_factor=25.0, final_div_factor=1e4)
    got = onecycle_schedule(total, 1e-4)
    steps = range(max(total, 4) + 5)
    np.testing.assert_allclose([got(i) for i in steps],
                               [float(want(i)) for i in steps], rtol=2e-6,
                               atol=2e-7 * 1e-4)


def test_vae_schedule_matches_jax():
    want, got = joptim.vae_schedule(1e-3), vae_schedule(1e-3)
    np.testing.assert_allclose([got(i) for i in range(1800)],
                               [float(want(i)) for i in range(1800)],
                               rtol=2e-6, atol=2e-7 * 1e-3)


@pytest.mark.parametrize("recipe", ["onecycle", "warmup_cosine", "default"])
def test_adamw_tracks_optax(recipe):
    """50 updates on a quadratic: the port's AdamW against optax's, with
    step i at sched(i) and optax's constants (default weight decay 1e-4)."""
    r = np.random.default_rng(0)
    w0 = r.standard_normal(6).astype(np.float32)
    tgt = r.standard_normal(6).astype(np.float32)
    wt = torch.nn.Parameter(torch.tensor(w0))
    if recipe == "onecycle":
        opt_t, opt_j = (onecycle_adamw([wt], 50, 1e-2),
                        joptim.onecycle_adamw(50, 1e-2))
    elif recipe == "warmup_cosine":
        opt_t = warmup_cosine_adamw([wt], 1e-2, warmup_steps=20,
                                    cosine_period=15)
        opt_j = joptim.warmup_cosine_adamw(1e-2, warmup_steps=20,
                                           cosine_period=15)
    else:
        opt_t, opt_j = ScheduledAdamW([wt], lambda _: 1e-2), optax.adamw(1e-2)
    wj = jnp.asarray(w0)
    st = opt_j.init(wj)
    grad = jax.grad(lambda w: jnp.sum((w - tgt) ** 2))
    for _ in range(50):
        opt_t.zero_grad()
        torch.sum((wt - torch.from_numpy(tgt)) ** 2).backward()
        opt_t.step()
        u, st = opt_j.update(grad(wj), st, wj)
        wj = optax.apply_updates(wj, u)
    assert opt_t.applied_updates() == 50
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj),
                               rtol=1e-4, atol=1e-5)


def _tiny_dit_pair(depth=1, seed=1, scale=0.05):
    jd = JDiT(latent_len=6, latent_dim=8, d_model=EMB, depth=depth,
              num_heads=2)
    jp = jd.init(jax.random.key(seed), jnp.zeros((2, 8, 6)), jnp.zeros(2),
                 jnp.zeros((2, EMB)))
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    keys = jax.random.split(jax.random.key(seed + 100), len(leaves))
    # off adaLN-zero: a fresh DiT's gates are 0 and most grads vanish
    jp = jax.tree_util.tree_unflatten(tdef, [
        p + scale * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    td = DiT(6, 8, EMB, depth, 2, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    return jd, jp, td


def _close_params(td, jparams, atol, rtol=1e-4):
    want = dit_params_from_jax(_np_tree(jparams))
    for name, p in td.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_adamw_state_from_optax_resumes_a_jax_run():
    """optax.adamw runs 3 updates; its state and params move into the port,
    and 3 more updates on the same gradients track the continued optax run
    (the grad trees map with dit_params_from_jax too)."""
    jd, jp, td = _tiny_dit_pair()
    opt_j = optax.adamw(1e-3)
    st = opt_j.init(jp)
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    grads = [jax.tree_util.tree_unflatten(tdef, [
        jax.random.normal(k, p.shape) for p, k in
        zip(leaves, jax.random.split(jax.random.key(50 + i), len(leaves)))])
        for i in range(6)]
    for g in grads[:3]:
        u, st = opt_j.update(g, st, jp)
        jp = optax.apply_updates(jp, u)
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    opt_t = ScheduledAdamW(td.parameters(), lambda _: 1e-3)
    adamw_state_from_optax(opt_t, td, _np_tree(st))
    assert opt_t.applied_updates() == 3
    for g in grads[3:]:
        u, st = opt_j.update(g, st, jp)
        jp = optax.apply_updates(jp, u)
        gt = dit_params_from_jax(_np_tree(g))
        for name, p in td.named_parameters():
            p.grad = gt[name]
        opt_t.step()
    _close_params(td, jp, 1e-7, rtol=1e-5)
    st_t = opt_t.state[td.patch_emb.weight]
    np.testing.assert_allclose(
        st_t["exp_avg"].numpy(),
        np.asarray(st[0].mu["params"]["patch_emb"]["kernel"]).T, rtol=1e-5,
        atol=1e-7)


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def stack():
    jv = JLAVAE(in_channels=1, latent_grid=6, num_hiddens=16,
                num_residual_hiddens=16, embedding_dim=8)
    vp = jv.init(jax.random.key(0), jnp.ones((2, T)))
    tv = LAVAE(1, 16, 2, 16, 8, 6, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    return jv, vp, tv


def _draws(key, jv, vp, x, accum=1, precoded=False):
    """The JAX step's draws for step key ``key``: per microbatch i (key
    fold_in(key, i) under accumulation) u behind t and the noise x_0, and
    the one CFG coin of the step."""
    z = x if precoded else jv.apply(vp, x, method=jv.encode)[0]
    mb = x.shape[0] // accum
    us, x0s = [], []
    for i in range(accum):
        k = jax.random.fold_in(key, i) if accum > 1 else key
        us.append(jax.random.uniform(named_fold(k, "t"), (mb,)))
        x0s.append(jax.random.normal(named_fold(k, "noise"),
                                     z[i * mb:(i + 1) * mb].shape))
    coin = jax.random.uniform(named_fold(key, "cfg"), ())
    T_ = lambda a: torch.from_numpy(np.array(a))
    return dict(u=T_(jnp.concatenate(us)), x_0=T_(jnp.concatenate(x0s)),
                coin=T_(coin))


@pytest.mark.parametrize("accum,precoded,depth", [(1, False, 2),
                                                  (2, False, 1),
                                                  (1, True, 1)])
def test_train_step_matches_jax(stack, accum, precoded, depth):
    """Loss and params after 1 and 3 steps of onecycle AdamW, on the JAX
    step's own draws; accum_steps=2 shares one CFG coin per step."""
    jv, vp, tv = stack
    jd, jp, td = _tiny_dit_pair(depth)
    lr, total = 1e-3, 3
    jopt = joptim.onecycle_adamw(total, lr)
    jstep = j_make_step(jd, jv, jopt, total_step=10, donate=False,
                        accum_steps=accum, precoded=precoded)
    state = TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    tstep = make_denoiser_train_step(
        td, tv, onecycle_adamw(td.parameters(), total, lr), total_step=10,
        accum_steps=accum, precoded=precoded, device="cpu")
    r = np.random.default_rng(2)
    for s in range(3):
        x = jnp.asarray(r.standard_normal((4, T)).astype(np.float32))
        if precoded:
            x = jv.apply(vp, x, method=jv.encode)[0]
        e = jnp.asarray(r.standard_normal((4, EMB)).astype(np.float32))
        key = jax.random.key(10 + s)
        state, jloss = jstep(state, vp, key, x, e)
        tloss = tstep(torch.from_numpy(np.array(x)),
                      torch.from_numpy(np.array(e)),
                      **_draws(key, jv, vp, x, accum, precoded))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
        if s in (0, 2):
            # Adam moves each param by at most ~lr per step
            sched = onecycle_schedule(total, lr)
            _close_params(td, state.params,
                          2 * sum(sched(i) for i in range(s + 1)))
    assert tstep.steps == 3


def test_train_step_nan_guard_skips_the_whole_update(stack):
    _, _, tv = stack
    _, _, td = _tiny_dit_pair()
    opt = onecycle_adamw(td.parameters(), 10, 1e-3)
    step = make_denoiser_train_step(td, tv, opt, total_step=10,
                                    nan_guard=True, device="cpu")
    g = torch.Generator().manual_seed(0)
    x, e = torch.randn(4, T, generator=g), torch.randn(4, EMB, generator=g)
    assert torch.isfinite(step(x, e, generator=g))
    params = {n: p.detach().clone() for n, p in td.named_parameters()}
    moments = {n: opt.state[p]["exp_avg"].clone()
               for n, p in td.named_parameters()}
    bad = x.clone()
    bad[0, 3] = float("nan")
    assert not torch.isfinite(step(bad, e, generator=g))
    assert step.steps == 2 and opt.applied_updates() == 1
    for n, p in td.named_parameters():
        torch.testing.assert_close(p.detach(), params[n], rtol=0, atol=0)
        torch.testing.assert_close(opt.state[p]["exp_avg"], moments[n],
                                   rtol=0, atol=0)
    assert torch.isfinite(step(x, e, generator=g))
    assert opt.applied_updates() == 2


def test_train_step_refusals(stack):
    _, _, tv = stack
    _, _, td = _tiny_dit_pair()
    opt = onecycle_adamw(td.parameters(), 10)
    step = make_denoiser_train_step(td, tv, opt, accum_steps=3,
                                    device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        step(torch.ones(8, T), torch.ones(8, EMB))
    # the DDPM loss is ported now (tests/test_torch_ddpm.py)
    assert make_denoiser_train_step(td, tv, opt, backbone="ddpm",
                                    device="cpu").sched.total_steps == 100
    with pytest.raises(ValueError, match="Unsupported backbone"):
        make_denoiser_train_step(td, tv, opt, backbone="edm", device="cpu")


def test_vae_train_step_matches_jax(stack):
    jv, vp, _ = stack
    tv = LAVAE(1, 16, 2, 16, 8, 6, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    jopt = joptim.warmup_cosine_adamw(1e-3, warmup_steps=2, cosine_period=3)
    jstep = j_make_vae_step(jv, jopt, donate=False)
    state = TrainState(vp, jopt.init(vp), jnp.zeros((), jnp.int32))
    tstep = make_vae_train_step(
        tv, warmup_cosine_adamw(tv.parameters(), 1e-3, warmup_steps=2,
                                cosine_period=3), device="cpu")
    r = np.random.default_rng(3)
    for _ in range(3):
        x = r.standard_normal((4, T)).astype(np.float32)
        state, (jl, jre) = jstep(state, jnp.asarray(x))
        tl, tre = tstep(torch.from_numpy(x))
        np.testing.assert_allclose([tl.item(), tre.item()],
                                   [float(jl), float(jre)], rtol=1e-4)
    want = lavae_params_from_jax(_np_tree(state.params))
    for name, p in tv.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=2 * 1e-3 * 3,
                                   err_msg=name)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports CUDA (the fused gate keys on the device)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("takes_block,takes_flax,want", [
    (True, True, "block"),          # the block kernels first, as in JAX
    (False, True, "flax"),          # the scaled geometry
    (False, False, None),           # neither: refuse, never eager
])
def test_training_forward_routes_only_cuda_input_to_the_kernels(
        monkeypatch, takes_block, takes_flax, want):
    """On CUDA input: the block kernels when they take the geometry, else
    the flax path's kernels, else a refusal naming the geometry; the CPU
    and an explicit attention_impl take the eager module."""
    calls = []
    monkeypatch.setattr(dit_fast, "fast_dit_train_forward",
                        lambda *a: calls.append("block") or "block")
    monkeypatch.setattr(dit_fast, "flax_path_forward",
                        lambda *a: calls.append("flax") or "flax")
    monkeypatch.setattr(dit_fast, "train_forward_supported",
                        lambda d: takes_block)
    monkeypatch.setattr(dit_fast, "flax_path_supported",
                        lambda d: takes_flax)
    td = DiT(6, 8, EMB, 1, 2, device="cpu")
    fwd = ttrainer._training_forward(td)
    x, t = torch.zeros(2, 8, 6), torch.zeros(2)
    if want is None:
        with pytest.raises(ValueError, match="does not train.*d_model=32 "
                                             "heads=2.*eager model is not"):
            fwd(x.as_subclass(_FakeCuda), t, None, None)
    else:
        assert fwd(x.as_subclass(_FakeCuda), t, None, None) == want
    assert fwd(x, t, None, None).shape == x.shape       # CPU: eager module
    opt_out = ttrainer._training_forward(
        DiT(6, 8, EMB, 1, 2, attention_impl="einsum", device="cpu"))
    assert opt_out(x.as_subclass(_FakeCuda), t, None, None).shape == x.shape
    assert calls == ([want] if want else [])
