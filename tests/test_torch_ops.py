"""Port ops held to the JAX package on the CPU: resize-as-matmul, the
torch-semantics convs, the attention oracles, and the fused DiT stack's
plain twin against the JAX ``fused_dit_stack`` in interpret mode. The
kernel-vs-twin checks need a card and live in ``test_torch_cuda.py``.

Tolerances: f32 rtol 2e-4 / atol 2e-5 (summation order only); bf16
atol 3e-2 * max|ref| plus correlation >= 0.999 with the f32 result (one
bf16 ulp is 2^-8 relative, and rounding flips compound through layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.ops import attention as jattn
from t2ms_tpu.ops import conv1d as jconv
from t2ms_tpu.ops import dit_block as jblock
from t2ms_tpu.ops import resize as jresize
from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import attention as tattn
from t2ms_tpu_torch.ops import dit_block as tblock
from t2ms_tpu_torch.ops.conv1d import Conv1d, ConvTranspose1d
from t2ms_tpu_torch.ops.resize import _linear_resize_matrix_np, linear_resize


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *s: r.standard_normal(s).astype(np.float32)


def _close_bf16(got, want, want_f32):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    assert np.corrcoef(got.ravel(), np.asarray(want_f32).ravel())[0, 1] \
        >= 0.999


@pytest.mark.parametrize("n_in,n_out", [(24, 30), (30, 6), (30, 24),
                                        (96, 30), (7, 1), (1, 5), (30, 30)])
def test_linear_resize_matches_jax(n_in, n_out):
    x = _rng(0)(3, 4, n_in)
    want = np.asarray(jresize.linear_resize(jnp.asarray(x), n_out))
    got = linear_resize(torch.from_numpy(x), n_out).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(_linear_resize_matrix_np(n_in, n_out),
                                  jresize._linear_resize_matrix_np(n_in,
                                                                   n_out))


@pytest.mark.parametrize("k,s,p,bias", [(4, 2, 1, True), (3, 1, 1, False),
                                        (1, 1, 0, True)])
def test_conv1d_matches_jax(k, s, p, bias):
    f = _rng(1)
    x, w, b = f(2, 5, 24), f(7, 5, k), f(7)
    want = jconv.conv1d_matmul(jnp.asarray(x), jnp.asarray(w), s, p)
    if bias:
        want = want + jnp.asarray(b)[None, :, None]
    conv = Conv1d(5, 7, k, s, p, use_bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (3, 1, 1)])
def test_conv_transpose1d_matches_jax(k, s, p):
    f = _rng(2)
    x, w, b = f(2, 6, 12), f(6, 3, k), f(3)
    want = (jconv.conv_transpose1d_matmul(jnp.asarray(x), jnp.asarray(w), s,
                                          p)
            + jnp.asarray(b)[None, :, None])
    conv = ConvTranspose1d(6, 3, k, s, p)
    assert tuple(conv.weight.shape) == (6, 3, k)       # (C, O, K) layout
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(b))
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


def test_einsum_natural_matches_jax():
    f = _rng(3)
    q, k, v = f(2, 24, 32), f(2, 24, 32), f(2, 24, 32)
    want = jattn._einsum_natural(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 4)
    got = tattn.einsum_natural(*map(torch.from_numpy, (q, k, v)), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attn_heads_natural_matches_jax(dt):
    f = _rng(4)
    q, k, v = 2 * f(24, 32), 2 * f(24, 32), f(24, 32)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    scale = 8 ** -0.5
    want = {h: np.asarray(o) for h, _, o in jattn.attn_heads_natural(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), 4, scale)}
    got = {h: o[0].numpy() for h, _, o in tattn.attn_heads_natural(
        *(torch.from_numpy(a)[None].to(tdt) for a in (q, k, v)), 4, scale)}
    for h in range(4):
        np.testing.assert_allclose(got[h], want[h], rtol=2e-4, atol=2e-5)


def _stack_inputs(B=2, N=24, D=32, hidden=64, L=3, seed=0):
    f = _rng(seed)
    return (f(B, N, D), 0.3 * f(B, L, 6, D),
            [0.2 * f(L, D, 3 * D), 0.1 * f(L, 3 * D), 0.2 * f(L, D, D),
             0.1 * f(L, D), 0.2 * f(L, D, hidden), 0.1 * f(L, hidden),
             0.2 * f(L, hidden, D), 0.1 * f(L, D)])


def _jax_stack(x, mod, ws, dt, H=4):
    return np.asarray(jblock.fused_dit_stack(
        jnp.asarray(x, dt), jnp.asarray(mod, dt),
        *map(jnp.asarray, ws), num_heads=H, interpret=True)
        .astype(jnp.float32))


def _torch_stack(x, mod, ws, dt, H=4):
    return tblock.fused_dit_stack(
        torch.from_numpy(x).to(dt), torch.from_numpy(mod).to(dt),
        *map(torch.from_numpy, ws), num_heads=H).float().numpy()


def test_stack_twin_matches_jax_kernel_f32():
    x, mod, ws = _stack_inputs()
    np.testing.assert_allclose(_torch_stack(x, mod, ws, torch.float32),
                               _jax_stack(x, mod, ws, jnp.float32),
                               rtol=2e-4, atol=2e-5)


def test_stack_twin_matches_jax_kernel_bf16():
    x, mod, ws = _stack_inputs(seed=1)
    _close_bf16(_torch_stack(x, mod, ws, torch.bfloat16),
                _jax_stack(x, mod, ws, jnp.bfloat16),
                _jax_stack(x, mod, ws, jnp.float32))


@pytest.mark.parametrize("N", [24, 80])         # 80 crosses a 64-row tile
@pytest.mark.parametrize("H", [4, 2, 1])         # head widths 16, 32, 64
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_stack_twin_matches_jax_kernel_across_head_widths(dt, H, N):
    """The twin against the JAX kernel (interpret mode) at D 64 and the head
    widths the CUDA stack's tensor-core route takes, at a token count inside
    one 64-row tile and one across two; the bounds of the tests above."""
    x, mod, ws = _stack_inputs(B=2, N=N, D=64, hidden=128, L=2,
                               seed=10 * H + N)
    if dt == "float32":
        np.testing.assert_allclose(
            _torch_stack(x, mod, ws, torch.float32, H),
            _jax_stack(x, mod, ws, jnp.float32, H), rtol=2e-4, atol=2e-5)
    else:
        _close_bf16(_torch_stack(x, mod, ws, torch.bfloat16, H),
                    _jax_stack(x, mod, ws, jnp.bfloat16, H),
                    _jax_stack(x, mod, ws, jnp.float32, H))


def test_stack_twin_block_matches_jax_block_reference():
    """One layer of the twin equals the JAX eager block oracle."""
    x, mod, ws = _stack_inputs(L=1, seed=2)
    want = jblock.dit_block_reference(
        jnp.asarray(x), jnp.asarray(mod[:, 0]),
        *(jnp.asarray(w[0]) for w in ws), num_heads=4)
    got = tblock.dit_stack_reference_block(
        torch.from_numpy(x), torch.from_numpy(mod[:, 0]),
        *(torch.from_numpy(w[0]) for w in ws), num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("kw", [dict(batch_block=2),
                                dict(attn_impl="folded"),
                                dict(batch_block=2, attn_impl="folded")])
def test_stack_variants_match_jax_kernel(kw):
    """JAX's opt-in variants (``_stack_kernel_g`` with G = 2, the folded
    attention, and both) in interpret mode against the port's call with
    the same arguments: the same function as the plain stack, so the same
    f32 bound as the plain twin's test."""
    x, mod, ws = _stack_inputs(seed=3)
    want = np.asarray(jblock.fused_dit_stack(
        jnp.asarray(x), jnp.asarray(mod), *map(jnp.asarray, ws),
        num_heads=4, interpret=True, **kw))
    got = tblock.fused_dit_stack(
        torch.from_numpy(x), torch.from_numpy(mod),
        *map(torch.from_numpy, ws), num_heads=4, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    plain = _torch_stack(x, mod, ws, torch.float32)
    np.testing.assert_array_equal(got, plain)


def test_stack_batch_block_must_divide_the_batch():
    x, mod, ws = _stack_inputs(L=1)
    assert x.shape[0] % 3
    with pytest.raises(ValueError, match="batch_block 3 must divide"):
        jblock.fused_dit_stack(*map(jnp.asarray, (x, mod, *ws)),
                               num_heads=4, batch_block=3, interpret=True)
    with pytest.raises(ValueError, match="batch_block 3 must divide"):
        tblock.fused_dit_stack(torch.from_numpy(x), torch.from_numpy(mod),
                               *map(torch.from_numpy, ws), num_heads=4,
                               batch_block=3)


@pytest.mark.parametrize("bad", ["mod", "wfc2", "x"])
def test_stack_refuses_mismatched_operands(bad):
    x, mod, ws = _stack_inputs(L=2)
    args = {"x": torch.from_numpy(x), "mod": torch.from_numpy(mod)}
    ws = [torch.from_numpy(w) for w in ws]
    if bad == "mod":
        args["mod"] = args["mod"][:, :1]          # fewer layers than weights
    elif bad == "wfc2":
        ws[6] = ws[6][:, :-1]                     # hidden narrower than fc1
    else:
        args["x"] = args["x"][0]                  # no batch axis
    with pytest.raises(ValueError, match="must be"):
        tblock.fused_dit_stack(args["x"], args["mod"], *ws, num_heads=4)


def test_stack_twin_on_cpu_counts_no_launch():
    _build.reset_launch_counts()
    x, mod, ws = _stack_inputs(L=1)
    _torch_stack(x, mod, ws, torch.float32)
    assert _build.launch_counts[tblock.STACK_KERNEL] == 0


def test_build_sources_and_missing_nvcc(monkeypatch, tmp_path):
    assert "dit_stack" in _build.sources()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
