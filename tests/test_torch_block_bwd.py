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
products' operands at other points than JAX's autodiff does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.ops import attention as jattn
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
