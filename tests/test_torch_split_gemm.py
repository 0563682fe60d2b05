"""The split block's GEMM stages (``split_gemm_reference``, the plain twin
of one stage of ``csrc/dit_split.cu``'s wgmma row GEMM) held to the port's
block twin and to the JAX split kernels on the CPU: the four stages with
the attention between them compose into ``fused_dit_block_reference`` bit
for bit, and the qkv stage and the MLP half (fc1 then fc2) match JAX's
``_qkv_split_kernel`` and ``_mlp_split_kernel`` run through
``pl.pallas_call(..., interpret=True)`` with ``fused_dit_block_split``'s
block specs. The stage launcher is rehearsed against the fake library of
``test_torch_split.py``; the kernel-vs-twin checks need a card and live in
``test_torch_cuda.py``.

Tolerances against JAX: f32 rtol 2e-4 / atol 2e-5 (summation order
only); bf16 one stage 1e-2 * max|ref| (a rounding flip of the output
after f32 sums in another order), the MLP half 3e-2 * max|ref| (flips in
h1 feed fc2: the block-level bf16 bound), with correlation >= 0.999
against the f32 result."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from t2ms_tpu.ops import dit_block as jblock
from t2ms_tpu_torch.ops import dit_block as tblock
from t2ms_tpu_torch.ops.attention import fused_heads_reference

B, N, D, HIDDEN, HEADS, BQ = 2, 24, 32, 64, 4, 8


def _inputs(seed=4):
    """x, mod (B, 6, D) and f32 flax-layout weights, random."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return [f(B, N, D), 0.3 * f(B, 6, D), 0.2 * f(D, 3 * D), 0.1 * f(3 * D),
            0.2 * f(D, D), 0.1 * f(D), 0.2 * f(D, HIDDEN), 0.1 * f(HIDDEN),
            0.2 * f(HIDDEN, D), 0.1 * f(D)]


def _torch(a, dt):
    """x and mod in dt, the weights cast to dt (the wrappers' w(a))."""
    return [torch.from_numpy(v).to(dt) for v in a]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_split_gemm_stages_compose_into_the_block_twin(dt):
    """qkv -> attention -> proj -> fc1 -> fc2 through the stage twin is
    ``fused_dit_block_reference`` bit for bit: the stages round where the
    block twin does."""
    x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2 = \
        _torch(_inputs(), dt)
    stage = tblock.split_gemm_reference
    qkv = stage(x, mod, wqkv, bqkv, None, "qkv")
    o = fused_heads_reference(qkv[..., :D], qkv[..., D:2 * D],
                              qkv[..., 2 * D:], HEADS)
    y1 = stage(o, mod, wproj, bproj, x, "proj")
    h1 = stage(y1, mod, wfc1, bfc1, None, "fc1")
    y = stage(h1, mod, wfc2, bfc2, y1, "fc2")
    want = tblock.fused_dit_block_reference(
        x, mod, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, HEADS)
    assert y.dtype == dt and torch.equal(y, want)


def _specs():
    const = lambda *shape: pl.BlockSpec(shape,
                                        lambda b, i: (0,) * len(shape))
    qblk = pl.BlockSpec((1, BQ, D), lambda b, i: (b, i, 0))
    mspec = pl.BlockSpec((1, 6, D), lambda b, i: (b, 0, 0))
    return const, qblk, mspec


def _jax_qkv(a, dt):
    """JAX's qkv stage as fused_dit_block_split launches it."""
    const, qblk, mspec = _specs()
    q, k, v = pl.pallas_call(
        functools.partial(jblock._qkv_split_kernel, eps=1e-6),
        out_shape=[jax.ShapeDtypeStruct((B, N, D), dt)] * 3,
        grid=(B, N // BQ),
        in_specs=[qblk, mspec, const(D, 3 * D), const(1, 3 * D)],
        out_specs=[qblk] * 3,
        interpret=True,
    )(jnp.asarray(a[0], dt), jnp.asarray(a[1], dt), jnp.asarray(a[2], dt),
      jnp.asarray(a[3], dt)[None])
    return np.asarray(jnp.concatenate([q, k, v], -1).astype(jnp.float32))


def _jax_mlp(a, y1, dt):
    """JAX's MLP half (fc1, GELU, fc2, gated residual) on y1."""
    const, qblk, mspec = _specs()
    out = pl.pallas_call(
        functools.partial(jblock._mlp_split_kernel, eps=1e-6),
        out_shape=jax.ShapeDtypeStruct((B, N, D), dt),
        grid=(B, N // BQ),
        in_specs=[qblk, mspec, const(D, HIDDEN), const(1, HIDDEN),
                  const(HIDDEN, D), const(1, D)],
        out_specs=qblk,
        interpret=True,
    )(jnp.asarray(y1, dt), jnp.asarray(a[1], dt),
      *(jnp.asarray(w, dt) if w.ndim == 2 else jnp.asarray(w, dt)[None]
        for w in a[6:]))
    return np.asarray(out.astype(jnp.float32))


def _close(got, want, dt, tol, want32):
    if dt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())
        assert np.corrcoef(got.ravel(), want32.ravel())[0, 1] >= 0.999


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_split_gemm_qkv_stage_matches_jax_kernel(dt):
    a = _inputs(seed=6)
    t = _torch(a, dt)
    got = tblock.split_gemm_reference(t[0], t[1], t[2], t[3], None, "qkv")
    jdt = jnp.dtype(str(dt).split(".")[-1])
    _close(got.float().numpy(), _jax_qkv(a, jdt), dt, 1e-2,
           _jax_qkv(a, jnp.float32))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_split_gemm_mlp_half_matches_jax_kernel(dt):
    """fc1 then fc2 (with y1 as the residual) against _mlp_split_kernel,
    on the same y1 (rounded to dt for both)."""
    a = _inputs(seed=7)
    y1 = torch.from_numpy(a[0]).to(dt)
    t = _torch(a, dt)
    h1 = tblock.split_gemm_reference(y1, t[1], t[6], t[7], None, "fc1")
    got = tblock.split_gemm_reference(h1, t[1], t[8], t[9], y1, "fc2")
    jdt = jnp.dtype(str(dt).split(".")[-1])
    y1n = y1.float().numpy()
    _close(got.float().numpy(), _jax_mlp(a, y1n, jdt), dt, 3e-2,
           _jax_mlp(a, y1n, jnp.float32))
