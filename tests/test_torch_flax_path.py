"""The port's flax-path kernels and the scaled train step held to the JAX
package on the CPU: the ``mod_ln_diffable`` twin (LayerNorm + modulate,
#5 and #6) against the JAX kernels in interpret mode and their
``jax.grad``; the ``fused_heads_attention`` twin (#9) against the JAX
kernel in interpret mode; the ``fused_heads_attention_bwd`` twin (#11)
against the JAX pipelined, head-grouped backward in interpret mode and
against the eager einsum VJP; ``flax_path_forward``'s loss and gradients
against ``jax.grad`` of flax ``DiT.apply`` with the LayerNorm kernel on and
the residual fusion off and on (the port runs the fusion; both give the
same numbers); and one train step through the flax path at d_model 512
against JAX ``make_denoiser_train_step`` on the same draws. The
kernel-vs-twin checks need a card and live in ``test_torch_cuda.py``.

Tolerances: f32 rtol 1e-5 / atol 1e-5 * max|ref| for one op (summation
order only); bf16 1e-2 * max|ref| for one op (a rounding flip is one bf16
ulp, 2^-8 relative, after f32 sums in another order); bf16 dmod2 against
the JAX backward at several q-blocks 3e-2 * max|ref| (the JAX kernel rounds
each block's partial to bf16 before the f32 sum, the port rounds the total
once: a deliberate difference); f32 backward against the eager VJP rtol
1e-3 / atol 1e-4 (the JAX test's own bound); whole-model f32 gradients
rtol 2e-3 / atol 2e-4 (the JAX block-VJP test's bound) and losses rtol
1e-4; parameters after a step atol 2 * lr (Adam's normalised update turns
a gradient that differs by rounding near zero into a full +-lr step)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.ops import attention as jattn
from t2ms_tpu.ops import dit_block as jblock
from t2ms_tpu.training.trainer import TrainState
from t2ms_tpu.training.trainer import \
    make_denoiser_train_step as j_make_step
from t2ms_tpu.utils.prng import named_fold
from t2ms_tpu_torch.convert import dit_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import attention as tattn
from t2ms_tpu_torch.ops import dit_block as tblock
from t2ms_tpu_torch.training import ScheduledAdamW, make_denoiser_train_step


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *s: r.standard_normal(s).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, dt, rtol32=1e-5, tol16=1e-2, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all(), err_msg
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol32,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol16 * np.abs(want).max(),
                                   err_msg=err_msg)


# ------------------------------------------------- mod_ln (#5, #6)

def _mod_ln_inputs(B, N, D, seed=0):
    f = _rng(seed)
    return f(B, N, D), 0.3 * f(B, 2, D), f(B, N, D)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,D", [(3, 16, 24), (2, 16, 128)])
def test_mod_ln_twin_matches_jax_kernel(dt, B, N, D):
    """Forward and both gradients (dx in x's dtype, dmod2 in mod2's)
    against the JAX kernels at one q-block, the JAX default at these
    shapes."""
    x, mod2, w = _mod_ln_inputs(B, N, D)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)

    def jloss(a, m):
        out = jblock.mod_ln_diffable(a, m, 1e-6, 0, True)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(mod2, jdt))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, mod2)]
    _build.reset_launch_counts()
    out = tblock.mod_ln_diffable(*ts)
    tg = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ts)
    assert not _build.launch_counts                 # CPU: the twins only
    assert out.dtype == tdt and [g.dtype for g in tg] == [tdt, tdt]
    _close(out.float(), jout, dt, err_msg="out")
    for name, g, want in zip(("dx", "dmod2"), tg, jg):
        _close(g.float(), want, dt, err_msg=name)


def test_mod_ln_dmod_rounds_once_against_the_blocked_jax_kernel():
    """At N=64 with block_q=16 the JAX backward rounds four per-block
    dshift/dscale partials to bf16 before summing them in f32; the port
    rounds the f32 total once. The two agree within a few bf16 roundings
    (ROADMAP section C), and in f32 within summation order."""
    x, mod2, w = _mod_ln_inputs(2, 64, 128, seed=1)
    for dt, tol in (("bfloat16", 3e-2), ("float32", 1e-5)):
        jdt = jnp.dtype(dt)
        want = jax.grad(lambda m: jnp.sum(jblock.mod_ln_diffable(
            jnp.asarray(x, jdt), m, 1e-6, 16, True).astype(jnp.float32)
            * w))(jnp.asarray(mod2, jdt))
        m = torch.from_numpy(mod2).to(getattr(torch, dt)).requires_grad_()
        out = tblock.mod_ln_diffable(
            torch.from_numpy(x).to(getattr(torch, dt)), m)
        got, = torch.autograd.grad(
            (out.float() * torch.from_numpy(w)).sum(), m)
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_mod_ln_refuses_mismatched_mod2():
    x = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="mod2"):
        tblock.mod_ln_diffable(x, torch.zeros(2, 6, 32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [128, 512])
def test_ln_twins_match_jax_on_views_of_one_modulation(dt, D):
    """The flax path's own operands: mod2 = m[:, 0:2] and gm3 = m[:, 2:5],
    views of one (B, 6, D) modulation, through the twins of #5/#6
    (``mod_ln_diffable``) and #7/#8 (``res_mod_ln_diffable``) against the
    JAX kernels in interpret mode: the three outputs and the gradients of
    x, h and the whole modulation (both views' cotangents land in m's).
    dm holds dgate, which the JAX kernel sums at bf16 width (see
    ``test_res_mod_ln_twin_matches_jax_kernel``): 3e-2 * max|ref| in
    bf16."""
    B, N = 2, 16
    f = _rng(7)
    x, h, m = f(B, N, D), f(B, N, D), 0.3 * f(B, 6, D)
    ws = [f(B, N, D) for _ in range(3)]
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)

    def jloss(a, b, mm):
        z = jblock.mod_ln_diffable(a, mm[:, 0:2], 1e-6, 0, True)
        o, y = jblock.res_mod_ln_diffable(a, b, mm[:, 2:5], 1e-6, 0, True)
        return sum(jnp.sum(t.astype(jnp.float32) * w)
                   for t, w in zip((z, o, y), ws)), (z, o, y)

    (_, jouts), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                        has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (x, h, m)))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, h, m)]
    _build.reset_launch_counts()
    z = tblock.mod_ln_diffable(ts[0], ts[2][:, 0:2])
    o, y = tblock.res_mod_ln_diffable(ts[0], ts[1], ts[2][:, 2:5])
    tg = torch.autograd.grad(sum((t.float() * torch.from_numpy(w)).sum()
                                 for t, w in zip((z, o, y), ws)), ts)
    assert not _build.launch_counts                 # CPU: the twins only
    assert [t.dtype for t in (z, o, y, *tg)] == [tdt] * 6
    for name, g, want in zip(("z", "out", "y", "dx", "dh"), (z, o, y, *tg),
                             (*jouts, *jg)):
        _close(g.float(), want, dt, err_msg=name)
    _close(tg[2].float(), jg[2], dt, tol16=3e-2, err_msg="dm")


# ------------------------------------------------- fused heads (#9, #11)

def _qkv_slices(B, N, HD, dt, seed=0):
    """q, k, v as the column slices of one (B, N, 3*HD) projection, the
    layout the DiT hands the kernels."""
    f = _rng(seed)
    qkv = np.concatenate([1.5 * f(B, N, HD), 1.5 * f(B, N, HD),
                          f(B, N, HD)], axis=-1)
    t = torch.from_numpy(qkv).to(getattr(torch, dt))
    j = jnp.asarray(qkv, jnp.dtype(dt))
    cut = lambda a: (a[..., :HD], a[..., HD:2 * HD], a[..., 2 * HD:])
    return cut(t), cut(j)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,HD,H", [(96, 128, 4), (40, 128, 2),
                                    (130, 256, 2)]  # head width 128, 3 tiles
                         # the bf16 kernel's tile edges (64-key tiles,
                         # 128-row blocks) at head widths 16 and 32
                         + [(n, 64, h) for n in (1, 127, 128, 129, 480)
                            for h in (4, 2)])
def test_fused_heads_twin_matches_jax_kernel(dt, N, HD, H):
    (q, k, v), (jq, jk, jv) = _qkv_slices(2, N, HD, dt)
    want = jattn.fused_heads_attention(jq, jk, jv, H, interpret=True)
    _build.reset_launch_counts()
    got = tattn.fused_heads_attention(q, k, v, H)
    assert not _build.launch_counts
    assert got.dtype == q.dtype and tuple(got.shape) == (2, N, HD)
    _close(got.float(), want, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_heads_bwd_twin_matches_jax_pipelined_kernel(dt):
    """The JAX default at the scaled geometry is the pipelined, head-
    grouped backward (groups 2, q-blocks of N/2); the twin runs whole rows
    with the same rounding points."""
    N, HD, H = 64, 128, 4
    (q, k, v), (jq, jk, jv) = _qkv_slices(2, N, HD, dt, seed=1)
    g = _rng(2)(2, N, HD)
    want = jattn.fused_heads_attention_bwd(
        jq, jk, jv, jnp.asarray(g, jnp.dtype(dt)), H, pipelined=True,
        head_groups=2, block_q=N // 2, interpret=True)
    got = tattn.fused_heads_attention_bwd(
        q, k, v, torch.from_numpy(g).to(q.dtype), H, head_groups=2,
        block_q=N // 2)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and a.shape == q.shape, name
        _close(a.float(), b, dt, rtol32=1e-4, err_msg=name)


def test_fused_heads_diffable_matches_eager_vjp_f32():
    """Autograd through ``fused_heads_diffable`` (its backward the twin
    on the CPU) against the eager einsum VJP of the JAX package
    (``_einsum_natural``, the oracle of tests/test_attention.py) and of
    the port."""
    N, HD, H = 48, 128, 4
    (q, k, v), (jq, jk, jv) = _qkv_slices(2, N, HD, "float32", seed=3)
    g = _rng(4)(2, N, HD)
    ts = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tattn.fused_heads_diffable(*ts, H), ts,
                              torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b, c: jattn._einsum_natural(a, b, c, H),
                     jq, jk, jv)
    ts2 = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    for want in (vjp(jnp.asarray(g)),
                 torch.autograd.grad(tattn.einsum_natural(*ts2, H), ts2,
                                     torch.from_numpy(g))):
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                       atol=1e-4, err_msg=name)


def test_fused_heads_refuses_mismatched_operands():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="one \\(B, N, H\\*D\\) shape"):
        tattn.fused_heads_attention(q, q[:, :4], q, 2)
    with pytest.raises(ValueError, match="g must be"):
        tattn.fused_heads_attention_bwd(q, q, q, q[:1], 2)


# ------------------------------------------------ the flax-path DiT

def _perturbed(params, seed, scale=0.02):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        p + scale * jax.random.normal(k, p.shape)
        for p, k in zip(leaves, keys)])


@pytest.mark.parametrize("res_ln", ["0", "1"])
def test_flax_path_forward_loss_and_grads_match_jax(monkeypatch, res_ln):
    """``flax_path_forward`` (the twins on the CPU, the residual fusion
    always on) against ``jax.grad`` of flax ``DiT.apply`` with the JAX
    LayerNorm kernel forced on (interpret mode) and the residual fusion
    off or on (its kernels in interpret mode): both configurations give
    the same numbers; every gradient maps through
    ``dit_params_from_jax``."""
    monkeypatch.setenv("T2MS_FUSED_MOD_LN", "1")
    monkeypatch.setenv("T2MS_FUSED_RES_LN", res_ln)
    kw = dict(latent_len=8, latent_dim=32, d_model=64, depth=2, num_heads=4,
              mlp_ratio=2.0)
    jd = JDiT(**kw)
    x = jax.random.normal(jax.random.key(0), (2, 32, 8))
    t = jnp.array([0.25, 0.75])
    emb = jax.random.normal(jax.random.key(1), (2, 64))
    mask = jnp.array([0.0, 1.0])
    jp = _perturbed(jd.init(jax.random.key(2), x, t, emb), 3)
    tgt = jax.random.normal(jax.random.key(6), x.shape)
    lw, gw = jax.value_and_grad(lambda p: jnp.mean(jnp.square(
        jd.apply(p, x, t, emb, mask) - tgt)))(jp)

    td = DiT(**kw, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    T = lambda a: torch.from_numpy(np.array(a))
    _build.reset_launch_counts()
    loss = torch.mean(torch.square(
        dit_fast.flax_path_forward(td, T(x), T(t), T(emb), T(mask)) - T(tgt)))
    loss.backward()
    assert not _build.launch_counts
    np.testing.assert_allclose(loss.item(), float(lw), rtol=1e-4)
    want = dit_params_from_jax(_np_tree(gw))
    for name, p in td.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


def test_scaled_train_step_through_the_flax_path_matches_jax(monkeypatch):
    """One train step of a d_model 512, 8-head DiT (depth 1, a 16-token
    latent for CPU time), precoded latents, optax.adamw(1e-4) against
    ScheduledAdamW at a constant 1e-4: the port's step routed as on CUDA
    for a geometry the block kernels do not take (the flax path with the
    residual fusion, its twins on the CPU), the JAX step with the
    LayerNorm kernel on and the residual fusion off (the same numbers), on
    the JAX step's own draws."""
    monkeypatch.setenv("T2MS_FUSED_MOD_LN", "1")
    monkeypatch.setenv("T2MS_FUSED_RES_LN", "0")
    kw = dict(latent_len=8, latent_dim=8, d_model=512, depth=1, num_heads=8,
              mlp_ratio=4.0)
    jd = JDiT(**kw)
    B = 4
    r = np.random.default_rng(5)
    z = jnp.asarray(r.standard_normal((B, 8, 8)).astype(np.float32))
    e = jnp.asarray(r.standard_normal((B, 512)).astype(np.float32))
    jp = _perturbed(jd.init(jax.random.key(2), z, jnp.zeros(B), e), 4)
    jopt = optax.adamw(1e-4)
    jstep = j_make_step(jd, None, jopt, total_step=100, donate=False,
                        precoded=True)
    key = jax.random.key(9)
    state, jloss = jstep(TrainState(jp, jopt.init(jp),
                                    jnp.zeros((), jnp.int32)), None, key, z, e)

    td = DiT(**kw, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    routes = []
    monkeypatch.setattr(dit_fast, "fused_path_eligible", lambda d, dev: True)
    monkeypatch.setattr(dit_fast, "train_forward_supported",
                        lambda d: routes.append("block?") or False)
    monkeypatch.setattr(dit_fast, "flax_path_supported",
                        lambda d: routes.append("flax?") or True)
    vae = LAVAE(1, 16, 1, 16, 8, 8, device="cpu")
    step = make_denoiser_train_step(
        td, vae, ScheduledAdamW(td.parameters(), lambda _: 1e-4),
        total_step=100, precoded=True, device="cpu")
    T = lambda a: torch.from_numpy(np.array(a))
    draws = dict(u=T(jax.random.uniform(named_fold(key, "t"), (B,))),
                 x_0=T(jax.random.normal(named_fold(key, "noise"), z.shape)),
                 coin=T(jax.random.uniform(named_fold(key, "cfg"), ())))
    _build.reset_launch_counts()
    tloss = step(T(z), T(e), **draws)
    assert routes == ["block?", "flax?"] and not _build.launch_counts
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    want = dit_params_from_jax(_np_tree(state.params))
    for name, p in td.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=2 * 1e-4, err_msg=name)
