"""The port's differentiable DiT block held to the JAX package on the CPU:
``attn_heads_natural`` gradients (the row max carries none), the
``fused_dit_block`` twin against the JAX kernel in interpret mode, the
gradients of ``fused_dit_block_diffable`` (autograd over the twin on the
CPU) against ``jax.grad`` of the JAX custom VJP, its mixed-dtype grad
contract, and ``fast_dit_train_forward`` against the JAX train forward and
flax ``apply``. The kernel-vs-twin checks need a card and live in
``test_torch_cuda.py``.

Tolerances: f32 forward rtol 2e-4 / atol 2e-5 (summation order only);
f32 gradients rtol 2e-3 / atol 2e-4, the JAX block-VJP test's own bound
(tests/test_dit_fast.py); bf16 atol 3e-2 * max|ref| plus correlation
>= 0.999 with the f32 result (one bf16 ulp is 2^-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.denoisers.dit_fast import \
    fast_dit_train_forward as j_train_forward
from t2ms_tpu.ops import attention as jattn
from t2ms_tpu.ops import dit_block as jblock
from t2ms_tpu_torch.convert import dit_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT
from t2ms_tpu_torch.models.denoisers.dit_fast import fast_dit_train_forward
from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import attention as tattn
from t2ms_tpu_torch.ops import dit_block as tblock

NAMES = ("x", "mod", "wqkv", "bqkv", "wproj", "bproj", "wfc1", "bfc1",
         "wfc2", "bfc2")


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *s: r.standard_normal(s).astype(np.float32)


def _block_inputs(B=3, N=24, D=32, hidden=64, seed=0):
    """The JAX block tests' inputs (random mod: adaLN-zero hides faults)."""
    f = _rng(seed)
    return [f(B, N, D), 0.1 * f(B, 6, D), 0.2 * f(D, 3 * D), 0.1 * f(3 * D),
            0.2 * f(D, D), 0.1 * f(D), 0.2 * f(D, hidden), 0.1 * f(hidden),
            0.2 * f(hidden, D), 0.1 * f(D)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attn_heads_natural_grads_match_jax(dt):
    """The row max is detached as JAX stops its gradient; with amax's own
    backward the bf16 dq differed from jax.grad by 0.039 at max 2.83."""
    f = _rng(4)
    q, k, v, w = 2 * f(24, 32), 2 * f(24, 32), f(24, 32), f(24, 32)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    scale = 8 ** -0.5

    def jloss(q, k, v):
        return sum(jnp.sum(o * w[:, sl]) for _, sl, o in
                   jattn.attn_heads_natural(q, k, v, 4, scale))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    loss = sum((o[0] * torch.from_numpy(w)[:, sl]).sum() for _, sl, o in
               tattn.attn_heads_natural(*(t[None] for t in ts), 4, scale))
    got = torch.autograd.grad(loss, ts)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_, np.float32)
        if dt == "float32":
            np.testing.assert_allclose(g.numpy(), w_, rtol=2e-4, atol=2e-5)
        else:
            np.testing.assert_allclose(g.float().numpy(), w_, rtol=0,
                                       atol=2e-3 * np.abs(w_).max())


def _jax_block(a, dt):
    return np.asarray(jblock.fused_dit_block(
        jnp.asarray(a[0], dt), jnp.asarray(a[1], dt), *map(jnp.asarray, a[2:]),
        num_heads=4, interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_block_twin_matches_jax_kernel(dt):
    a = _block_inputs(seed=1)
    got = tblock.fused_dit_block(
        torch.from_numpy(a[0]).to(getattr(torch, dt)),
        torch.from_numpy(a[1]).to(getattr(torch, dt)),
        *map(torch.from_numpy, a[2:]), num_heads=4).float().numpy()
    want = _jax_block(a, jnp.dtype(dt))
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())
        want32 = _jax_block(a, jnp.float32)
        assert np.corrcoef(got.ravel(), want32.ravel())[0, 1] >= 0.999


def _jax_block_grads(a, x_dtype=jnp.float32):
    args = [jnp.asarray(a[0], x_dtype)] + [jnp.asarray(v) for v in a[1:]]

    def loss(*p):
        out = jblock.fused_dit_block_diffable(*p, 4, True)
        return jnp.sum(jnp.square(out.astype(jnp.float32)))

    return jax.grad(loss, argnums=tuple(range(10)))(*args)


def _torch_block_grads(a, x_dtype=torch.float32):
    ts = [torch.from_numpy(a[0]).to(x_dtype).requires_grad_()] + [
        torch.from_numpy(v).requires_grad_() for v in a[1:]]
    out = tblock.fused_dit_block_diffable(*ts, 4)
    return torch.autograd.grad(out.float().square().sum(), ts)


def test_block_grads_match_jax_block_vjp():
    """All 10 gradients against jax.grad over the JAX custom VJP (its
    Pallas backward in interpret mode), at the JAX test's tolerance."""
    a = _block_inputs()
    _build.reset_launch_counts()
    got = _torch_block_grads(a)
    assert not _build.launch_counts                 # CPU: the twin only
    want = _jax_block_grads(a)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4, err_msg=f"d{name}")


def test_block_grads_mixed_dtypes():
    """bf16 activations with f32 mod and weights: dx follows x (bf16), dmod
    follows mod (f32), weight grads f32, as the JAX contract; the values
    agree with JAX's within bf16 rounding."""
    a = _block_inputs(B=2)
    got = _torch_block_grads(a, torch.bfloat16)
    want = _jax_block_grads(a, jnp.bfloat16)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(NAMES, got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-2 * np.abs(w).max(),
                                   err_msg=f"d{name}")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_train_forward_loss_and_grads_match_jax():
    """The port's train forward (per-block diffable twin on the CPU) against
    the JAX train forward (Pallas block kernels in interpret mode) and flax
    apply, on the same params; the JAX grad trees map through
    dit_params_from_jax onto the port's parameter names."""
    jd = JDiT(latent_len=8, latent_dim=32, d_model=64, depth=2, num_heads=4,
              mlp_ratio=2.0)
    B = 2
    x = jax.random.normal(jax.random.key(0), (B, 32, 8))
    t = jnp.array([0.25, 0.75])
    emb = jax.random.normal(jax.random.key(1), (B, 64))
    jp = jd.init(jax.random.key(2), x, t, emb)
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    keys = jax.random.split(jax.random.key(3), len(leaves))
    jp = jax.tree_util.tree_unflatten(tdef, [
        p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    mask = jnp.array([0.0, 1.0])
    tgt = jax.random.normal(jax.random.key(6), x.shape)

    def j_loss(fwd):
        return jax.value_and_grad(
            lambda p: jnp.mean(jnp.square(fwd(p) - tgt)))(jp)

    lk, gk = j_loss(lambda p: j_train_forward(jd, p, x, t, emb, mask,
                                              interpret=True))
    lf, gf = j_loss(lambda p: jd.apply(p, x, t, emb, mask))

    td = DiT(latent_len=8, latent_dim=32, d_model=64, depth=2, num_heads=4,
             mlp_ratio=2.0, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    T = lambda a: torch.from_numpy(np.array(a))
    loss = torch.mean(torch.square(
        fast_dit_train_forward(td, T(x), T(t), T(emb), T(mask)) - T(tgt)))
    loss.backward()
    for lw, gw in ((lk, gk), (lf, gf)):
        np.testing.assert_allclose(loss.item(), float(lw), rtol=1e-4)
        want = dit_params_from_jax(_np_tree(gw))
        for name, p in td.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       rtol=2e-3, atol=2e-4, err_msg=name)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach the CUDA branch's checks
    without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("fn", ["fused_dit_stack", "fused_dit_block",
                                "fused_dit_block_split"])
def test_cuda_forward_refuses_autograd(fn, monkeypatch):
    """The CUDA forwards write through a raw pointer (no grad_fn): under
    grad mode with an input that requires grad they raise, naming the
    training path; under no_grad they go on to the launch."""
    a = _block_inputs(B=1)
    if fn == "fused_dit_stack":
        a = [a[0], a[1][:, None]] + [w[None] for w in a[2:]]
    x = torch.from_numpy(a[0]).as_subclass(_FakeCuda)
    rest = [torch.from_numpy(v) for v in a[1:]]
    rest[2].requires_grad_()
    launched = []
    for launcher in ("_launch_stack", "_launch_split"):
        monkeypatch.setattr(tblock, launcher,
                            lambda *args, **kw: launched.append(1))
    call = getattr(tblock, fn)
    with pytest.raises(RuntimeError, match="no backward.*train through"):
        call(x, *rest, num_heads=4)
    assert not launched
    with torch.no_grad():
        call(x, *rest, num_heads=4)
    assert launched == [1]


def test_block_refuses_mismatched_operands():
    a = [torch.from_numpy(v) for v in _block_inputs(B=1)]
    with pytest.raises(ValueError, match="fused_dit_block: wfc2 must be"):
        tblock.fused_dit_block(*a[:8], a[8][:, :-1], a[9], num_heads=4)
    with pytest.raises(ValueError, match="mod must be"):
        tblock.fused_dit_block(a[0], a[1][:, None], *a[2:], num_heads=4)
