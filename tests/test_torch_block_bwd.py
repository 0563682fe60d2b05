"""The block backward's attention VJP recipe held to the JAX package on the
CPU. ``block_attn_bwd_reference`` is the plain twin of the BLOCK recipe of
``csrc/heads_bwd.cuh`` (the DiT block backward's attention half, which
rebuilds p from the recompute's row max and row sum and takes delta from
the attention output): here it is held to ``jax.vjp`` over JAX's
``attn_heads_natural`` (the attention inside ``_block_vjp_kernel``) and to
autograd over the port's ``attn_heads_natural``, at ragged token counts and
head widths 16 and 32. The kernel against this twin needs a card and lives
in ``test_torch_cuda.py``.

Tolerances: f32 rtol 2e-3 / atol 2e-4, the JAX block-VJP test's own bound
(the recipe's only differences are summation order and 1/r as a multiply);
bf16 3e-2 * max|ref| with correlation >= 0.999 (bf16 rounds p, ds and the
products' operands at other points than JAX's autodiff does).

The twins of the backward's two LayerNorm-VJP row kernels,
``mlp_half_bwd_reference`` and ``qkv_half_bwd_reference``, are held the
same way to ``jax.vjp`` of the JAX package's own halves (``_mlp_half``, and
``_dense(_mod_ln(x, mod[0], mod[1]), wqkv, bqkv)``): every output the
kernels write, the intermediates (z2, h1, dh2, da1) against JAX's forward
and the VJPs of its steps, at ragged token counts and D 64 and 128. Same
tolerances: in f32 the twins' GELU differs from jax.nn.gelu in the last
bits only; in bf16 JAX's autodiff also rounds the GELU's arithmetic and
the dense VJPs' outputs, which the twins keep in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.ops import attention as jattn
from t2ms_tpu.ops import dit_block as jblock
from t2ms_tpu_torch.ops import attention as tattn
from t2ms_tpu_torch.ops import dit_block as tblock

CASES = [(N, dh, dt) for N in (72, 130) for dh in (16, 32)
         for dt in ("float32", "bfloat16")]


def _inputs(N, dh, heads=4, B=2, seed=0):
    r = np.random.default_rng(seed + N + dh)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    D = heads * dh
    return 2 * f(B, N, D), 2 * f(B, N, D), f(B, N, D), f(B, N, D)


def _recipe(q, k, v, do, heads, scale):
    m, r, delta = tblock.block_attn_stats(q, k, v, do, heads, scale)
    return tblock.block_attn_bwd_reference(q, k, v, do, m, r, delta, scale)


def _close(got, want, dt):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert np.isfinite(g).all()
        if dt == "float32":
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
        else:
            ref = np.abs(w).max()
            assert np.abs(g - w).max() <= 3e-2 * ref
            assert np.corrcoef(g.ravel(), w.ravel())[0, 1] >= 0.999


@pytest.mark.parametrize("N,dh,dt", CASES)
def test_block_attention_recipe_matches_jax_vjp(N, dh, dt):
    heads = 4
    q, k, v, do = _inputs(N, dh, heads)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    scale = float(torch.tensor(dh ** -0.5, dtype=tdt))

    def f(q, k, v):
        return jnp.concatenate(
            [o.astype(q.dtype) for _, _, o in
             jattn.attn_heads_natural(q, k, v, heads, dh ** -0.5)], axis=-1)

    _, vjp = jax.vjp(jax.vmap(f), *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    got = _recipe(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, do)),
                  heads, scale)
    assert [g.dtype for g in got] == [tdt] * 3
    _close([g.float().numpy() for g in got], want, dt)


@pytest.mark.parametrize("N,dh,dt", CASES)
def test_block_attention_recipe_matches_autograd_over_the_twin(N, dh, dt):
    heads = 4
    tdt = getattr(torch, dt)
    q, k, v, do = (torch.from_numpy(a).to(tdt)
                   for a in _inputs(N, dh, heads, seed=1))
    scale = float(torch.tensor(dh ** -0.5, dtype=tdt))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    o = torch.cat([o.to(tdt) for _, _, o in
                   tattn.attn_heads_natural(*ts, heads, dh ** -0.5)], dim=-1)
    want = torch.autograd.grad(o, ts, do)
    got = _recipe(q, k, v, do, heads, scale)
    _close([g.float().numpy() for g in got],
           [w.float().numpy() for w in want], dt)


HALF_CASES = [(N, D, hidden, dt) for N in (17, 130)
              for D, hidden in ((64, 128), (128, 256))
              for dt in ("float32", "bfloat16")]


def _half_inputs(N, D, hidden, B=2, seed=0):
    """x, mod (random adaLN rows), weights of standard deviation
    1/sqrt(fan-in), biases, and the cotangents dy, dqkv, dx1."""
    r = np.random.default_rng(seed + N + D)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return dict(x=f(B, N, D), mod=0.3 * f(B, 6, D),
                w1=f(D, hidden) / np.sqrt(D), b1=0.1 * f(hidden),
                w2=f(hidden, D) / np.sqrt(hidden), b2=0.1 * f(D),
                wqkv=f(D, 3 * D) / np.sqrt(D), bqkv=0.1 * f(3 * D),
                dy=f(B, N, D), dqkv=f(B, N, 3 * D), dx1=f(B, N, D))


def _rows(f, a):
    """f over (rows, columns) matrices, as the JAX kernels apply _dense."""
    return f(a.reshape(-1, a.shape[-1])).reshape(*a.shape[:-1], -1)


@pytest.mark.parametrize("N,D,hidden,dt", HALF_CASES)
def test_mlp_half_twin_matches_jax_vjp(N, D, hidden, dt):
    a = _half_inputs(N, D, hidden)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    J = {k: jnp.asarray(v, jnp.float32 if k == "mod" else jdt)
         for k, v in a.items()}
    sh, sc, gate = (J["mod"][:, i, None, :] for i in (3, 4, 5))
    eps = 1e-6

    def half(x, sh, sc, gate):
        return jax.vmap(lambda x, sh, sc, gate: jblock._mlp_half(
            x, sh, sc, gate, J["w1"], J["b1"], J["w2"], J["b2"], eps))(
                x, sh, sc, gate)

    _, vjp = jax.vjp(half, J["x"], sh, sc, gate)
    dx, dsh, dsc, dgate = vjp(J["dy"])
    z2 = jblock._mod_ln(J["x"], sh, sc, eps)
    h1 = jax.nn.gelu(_rows(lambda t: jblock._dense(t, J["w1"], J["b1"]), z2),
                     approximate=True)
    _, vjp_h2 = jax.vjp(lambda h2: J["x"] + gate.astype(jdt) * h2,
                        _rows(lambda t: jblock._dense(t, J["w2"], J["b2"]),
                              h1))
    dh2, = vjp_h2(J["dy"])
    _, vjp_a1 = jax.vjp(lambda a1: _rows(lambda t: jblock._dense(
        jax.nn.gelu(t, approximate=True), J["w2"], J["b2"]), a1),
        _rows(lambda t: jblock._dense(t, J["w1"], J["b1"]), z2))
    da1, = vjp_a1(dh2)
    T = {k: torch.from_numpy(v).to(torch.float32 if k == "mod" else tdt)
         for k, v in a.items()}
    got = tblock.mlp_half_bwd_reference(T["x"], T["mod"], T["w1"], T["b1"],
                                        T["w2"], T["b2"], T["dy"], eps)
    assert [g.dtype for g in got] == [torch.float32] + [tdt] * 4 + [
        torch.float32] * 3
    _close([g.float().numpy() for g in got],
           [dx, z2, h1, dh2, da1, dsh[:, 0], dsc[:, 0], dgate[:, 0]], dt)


@pytest.mark.parametrize("N,D,hidden,dt", HALF_CASES)
def test_qkv_half_twin_matches_jax_vjp(N, D, hidden, dt):
    a = _half_inputs(N, D, hidden, seed=1)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    J = {k: jnp.asarray(v, jnp.float32 if k in ("mod", "dx1") else jdt)
         for k, v in a.items()}
    sh, sc = (J["mod"][:, i, None, :] for i in (0, 1))
    eps = 1e-6

    def half(x, sh, sc):
        return _rows(lambda t: jblock._dense(t, J["wqkv"], J["bqkv"]),
                     jblock._mod_ln(x, sh, sc, eps))

    _, vjp = jax.vjp(half, J["x"], sh, sc)
    dxl, dsh, dsc = vjp(J["dqkv"])
    want_dx = (J["dx1"] + dxl.astype(jnp.float32)).astype(jdt)
    T = {k: torch.from_numpy(v).to(torch.float32 if k in ("mod", "dx1")
                                   else tdt) for k, v in a.items()}
    got = tblock.qkv_half_bwd_reference(T["x"], T["mod"], T["wqkv"],
                                        T["dqkv"], T["dx1"], eps)
    assert [g.dtype for g in got] == [tdt, torch.float32, torch.float32]
    _close([g.float().numpy() for g in got], [want_dx, dsh[:, 0], dsc[:, 0]],
           dt)
