"""Card-only checks of the port's CUDA kernel. This file imports no jax, so
it also runs where jax is absent; ``tests/conftest.py`` imports jax, so on
such a machine run it without the conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
Each kernel is held to its plain PyTorch twin on the same inputs with
random adaLN vectors (the adaLN-zero init would zero every gate), at a
ragged token count and a batch that fills no tile. Tolerances: f32 2e-4 *
max|ref| (summation order only); bf16 3e-2 * max|ref| (one bf16 ulp is
2^-8 relative, and rounding flips compound through the layers); the
single-op kernels of the flax path state their own."""

import numpy as np
import pytest
import torch

from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import attention as tattn
from t2ms_tpu_torch.ops import dit_block as tblock


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stack_args(dev, dt, B=3, N=130, D=128, hidden=256, L=2, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    x, mod = f(B, N, D), 0.3 * f(B, L, 6, D)
    ws = [0.2 * f(L, D, 3 * D), 0.1 * f(L, 3 * D), 0.2 * f(L, D, D),
          0.1 * f(L, D), 0.2 * f(L, D, hidden), 0.1 * f(L, hidden),
          0.2 * f(L, hidden, D), 0.1 * f(L, D)]
    return [x.to(dev, dt), mod.to(dev, dt), *(w.to(dev) for w in ws)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 2e-4),
                                    (torch.bfloat16, 3e-2)])
def test_stack_kernel_matches_twin_on_card(cuda, dt, tol):
    args = _stack_args(cuda, dt)
    before = _build.launch_counts[tblock.STACK_KERNEL]
    got = tblock.fused_dit_stack(*args, num_heads=4)
    torch.cuda.synchronize()
    assert _build.launch_counts[tblock.STACK_KERNEL] == before + 1
    want = tblock.fused_dit_stack_reference(*args, num_heads=4)
    assert got.dtype == dt and got.shape == want.shape
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.cuda
def test_stack_kernel_raises_on_shapes_it_does_not_take(cuda):
    """A CUDA tensor the kernel cannot take raises; it never falls back to
    the twin."""
    args = _stack_args(cuda, torch.bfloat16, B=1, N=16, D=96, hidden=192,
                       L=1)
    before = _build.launch_counts[tblock.STACK_KERNEL]
    with pytest.raises(ValueError, match="does not take"):
        tblock.fused_dit_stack(*args, num_heads=4)
    assert _build.launch_counts[tblock.STACK_KERNEL] == before


@pytest.mark.cuda
def test_stack_kernel_shape_limits(cuda):
    """The limits are the kernel library's own (dit_stack_check)."""
    ok = tblock.stack_kernel_supported
    assert ok(128, 256, 4, torch.bfloat16)          # the main path
    assert ok(128, 256, 4, torch.float32)
    assert not ok(128, 256, 4, torch.float16)       # no fp16 kernel
    assert not ok(96, 192, 4, torch.bfloat16)       # D not a 64 multiple
    assert not ok(128, 256, 16, torch.bfloat16)     # head width 8 < 16
    assert not ok(512, 2048, 8, torch.bfloat16)     # LN row beyond 256
    assert not ok(256, 1024, 4, torch.float32)      # shared memory
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.denoisers.dit_fast import \
        fast_forward_supported
    assert fast_forward_supported(DiT(compute_dtype=torch.bfloat16))
    assert not fast_forward_supported(
        DiT(latent_len=6, latent_dim=8, d_model=32, depth=1, num_heads=2))


@pytest.mark.cuda
def test_stack_kernel_takes_a_batch_beyond_grid_y(cuda):
    """More batch elements than grid.y's 65535 (one token each)."""
    args = _stack_args(cuda, torch.float32, B=70000, N=1, L=1)
    got = tblock.fused_dit_stack(*args, num_heads=4)
    want = tblock.fused_dit_stack_reference(*args, num_heads=4)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [dict(d_model=96, num_heads=4),
                                      dict(compute_dtype=torch.float16)])
def test_sampler_refuses_a_dit_the_kernel_does_not_take(cuda, geometry):
    """The sampler never runs the eager model in place of the kernel."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    kw = dict(latent_len=30, latent_dim=64, d_model=128, depth=1,
              num_heads=4)
    kw.update(geometry)
    dit, vae = DiT(**kw), LAVAE(in_channels=1, latent_grid=30)
    x1 = torch.zeros(2, 96, device=cuda)
    emb = torch.zeros(2, kw["d_model"], device=cuda)
    before = _build.launch_counts[tblock.STACK_KERNEL]
    with pytest.raises(ValueError, match="does not take"):
        make_cfg_sampler(dit, vae, total_step=2)(x1, emb)
    assert _build.launch_counts[tblock.STACK_KERNEL] == before


# ----------------------- the stack's tensor-core route (csrc/dit_layer.cuh)

def _tc_route(B, N, D, hidden, heads):
    """Whether the bf16 stack runs this geometry on csrc/dit_layer.cuh's
    tensor-core kernels (dit_stack_tc_route) rather than the first ones."""
    return bool(_build.load("dit_stack").dit_stack_tc_route(B, N, D, hidden,
                                                            heads))


def _close_to_twin(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 17, 130, 480, 1000])
@pytest.mark.parametrize("heads", [8, 4, 2, 1])   # head widths 16 to 128
def test_bf16_stack_matches_twin_across_head_widths(cuda, heads, N):
    """The tensor-core route at every head width it takes, at token counts
    below, across and beyond the 64-row tiles; bf16 3e-2 * max|ref|."""
    args = _stack_args(cuda, torch.bfloat16, B=2, N=N, seed=N + heads)
    assert _tc_route(2, N, 128, 256, heads)
    got = tblock.fused_dit_stack(*args, num_heads=heads)
    want = tblock.fused_dit_stack_reference(*args, num_heads=heads)
    _close_to_twin(got, want, 3e-2)


@pytest.mark.cuda
def test_bf16_stack_at_another_head_width_takes_the_first_kernels(cuda):
    """Head width 48 (D 192, 4 heads): no heads_fwd_kernel instance, so the
    bf16 stack runs dit_common.cuh's attn_proj_kernel route."""
    assert tblock.stack_kernel_supported(192, 384, 4, torch.bfloat16)
    assert not _tc_route(2, 130, 192, 384, 4)
    args = _stack_args(cuda, torch.bfloat16, B=2, N=130, D=192, hidden=384)
    got = tblock.fused_dit_stack(*args, num_heads=4)
    want = tblock.fused_dit_stack_reference(*args, num_heads=4)
    _close_to_twin(got, want, 3e-2)


@pytest.mark.cuda
def test_bf16_stack_takes_a_batch_beyond_grid_y(cuda):
    args = _stack_args(cuda, torch.bfloat16, B=70000, N=1, L=1)
    assert _tc_route(70000, 1, 128, 256, 4)
    got = tblock.fused_dit_stack(*args, num_heads=4)
    want = tblock.fused_dit_stack_reference(*args, num_heads=4)
    _close_to_twin(got, want, 3e-2)


@pytest.mark.cuda
def test_bf16_stack_repeats_bit_for_bit(cuda):
    args = _stack_args(cuda, torch.bfloat16, B=3, N=480)
    a = tblock.fused_dit_stack(*args, num_heads=4)
    b = tblock.fused_dit_stack(*args, num_heads=4)
    assert torch.equal(a, b)


def _stack_attention(qkv, heads):
    """The tensor-core route's attention stage alone: o, row max, row sum."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    o = torch.empty((B, N, D), device=qkv.device, dtype=qkv.dtype)
    m, r = (torch.empty((B, N, heads), device=qkv.device,
                        dtype=torch.float32) for _ in range(2))
    qscale = float(torch.tensor((D // heads) ** -0.5, dtype=qkv.dtype))
    _build.launch(_build.load("dit_stack"), "dit_stack_attention_bf16",
                  "dit_stack_attention", ValueError("refused"), qkv.device,
                  qkv, o, m, r, B, N, D, heads, qscale)
    return o, m, r, qscale


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4, 2, 1])
def test_stack_attention_row_stats_match_twin(cuda, heads):
    """m and r, which the block backward rebuilds p from. q and k lie on a
    grid of 1/8 in [-1, 1], so every score (a sum of products that are
    multiples of 2^-16, below 2^3) is exact in f32 in any order: the row
    max is bit-equal to the twin's. The row sums differ by summation order
    (f32, 1e-5 relative) and at most one rounding flip of an exponential
    (2^-8). o with the stats written is #9's o bit for bit (#9 writes
    none), and within 1e-2 * max|ref| of the twin."""
    B, N, D = 2, 130, 128
    g = np.random.default_rng(heads)
    qkv = torch.from_numpy(g.integers(-8, 9, (B, N, 3 * D)) / 8).to(
        cuda, torch.bfloat16)
    o, m, r, qscale = _stack_attention(qkv, heads)
    torch.cuda.synchronize()
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    dh = D // heads
    split = lambda t: t.unflatten(-1, (heads, dh)).transpose(1, 2)
    qs = (q.float() * qscale).to(torch.bfloat16)          # T(q * scale)
    s = split(qs).float() @ split(k).float().transpose(-1, -2)
    m_twin = s.max(-1).values                              # (B, H, N)
    e = torch.exp((s - m_twin[..., None]).to(torch.bfloat16).float())
    r_twin = e.to(torch.bfloat16).float().sum(-1)
    assert torch.equal(m.transpose(1, 2), m_twin)
    torch.testing.assert_close(r.transpose(1, 2), r_twin, rtol=1e-5,
                               atol=2 ** -8)
    if dh >= 32:   # #9 takes head widths 32, 64 and 128
        assert torch.equal(o, tattn.fused_heads_attention(q, k, v, heads))
    _close_to_twin(o, tattn.fused_heads_reference(q, k, v, heads, dh ** -0.5),
                   1e-2)


# ------------------------------------------------- the block kernels (#2, #3)

def _block_args(dev, dt, B=3, N=130, D=128, hidden=256, seed=1):
    """x and mod in ``dt``, f32 weights (the params), random mod."""
    a = _stack_args(dev, dt, B=B, N=N, D=D, hidden=hidden, L=1, seed=seed)
    return [a[0], a[1][:, 0]] + [w[0] for w in a[2:]]


def _block_grads(args, dy, num_heads=4, twin=False):
    ts = [a.detach().clone().requires_grad_() for a in args]
    fn = (tblock.fused_dit_block_reference if twin
          else tblock.fused_dit_block_diffable)
    out = fn(*ts, num_heads)
    return out, torch.autograd.grad(out, ts, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_block_kernels_match_twins_on_card(cuda, dt):
    """Forward and backward kernels against the twin and autograd over it
    at a ragged N and a batch that fills no tile. f32: 5e-4 * max|ref| per
    output (summation order). bf16: 5e-2 * max|ref| against the bf16 twin
    (which rounds every op of its backward to bf16), and the kernel's mean
    error against the f32 truth at most 1.5x the bf16 twin's."""
    args = _block_args(cuda, dt)
    dy = torch.randn(args[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(3)).to(dt)
    _build.reset_launch_counts()
    out, got = _block_grads(args, dy)
    torch.cuda.synchronize()
    assert _build.launch_counts[tblock.BLOCK_KERNEL] == 1
    assert _build.launch_counts[tblock.BLOCK_BWD_KERNEL] == 1
    want_out, want = _block_grads(args, dy, twin=True)
    assert [g.dtype for g in got] == [a.dtype for a in args]
    tol = 5e-4 if dt == torch.float32 else 5e-2
    for g, w in zip((out, *got), (want_out, *want)):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= tol * w.abs().max().item()
    if dt == torch.bfloat16:
        f32 = [a.float() for a in args]
        _, truth = _block_grads(f32, dy.float(), twin=True)
        for g, w, t in zip(got, want, truth):
            ek = (g.float() - t).abs().mean().item()
            et = (w.float() - t).abs().mean().item()
            assert ek <= 1.5 * et + 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 2, 1])
def test_bf16_block_kernels_match_twins_across_head_widths(cuda, heads):
    """The block forward and backward in bf16 at the head widths 16, 64 and
    128 of the tensor-core route, which the backward's recompute takes too,
    with the bf16 bounds of test_block_kernels_match_twins_on_card. (The
    backward's kernels take D 64 and 128 only, where every head width the
    stack takes is on that route.)"""
    args = _block_args(cuda, torch.bfloat16, seed=heads)
    assert _tc_route(3, 130, 128, 256, heads)
    dy = torch.randn(args[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5)).to(
                         torch.bfloat16)
    out, got = _block_grads(args, dy, num_heads=heads)
    want_out, want = _block_grads(args, dy, num_heads=heads, twin=True)
    _close_to_twin(out, want_out, 3e-2)
    f32 = [a.float() for a in args]
    _, truth = _block_grads(f32, dy.float(), num_heads=heads, twin=True)
    for g, w, t in zip(got, want, truth):
        _close_to_twin(g, w, 5e-2)
        ek = (g.float() - t).abs().mean().item()
        et = (w.float() - t).abs().mean().item()
        assert ek <= 1.5 * et + 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [4, 1])
def test_bf16_block_kernels_match_twins_at_d64(cuda, heads):
    """D 64 and hidden 192 (head widths 16 and 64): the row GEMMs' 64-wide
    column chunks, the LayerNorm VJP's half row a thread group and the
    weight grads' 64-wide output tiles (wqkv's 192 columns), which the
    D-128 checks never reach; the bf16 bounds of
    test_block_kernels_match_twins_on_card."""
    args = _block_args(cuda, torch.bfloat16, D=64, hidden=192, seed=heads)
    assert tblock.block_kernel_supported(64, 192, heads, torch.bfloat16)
    dy = torch.randn(args[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(11)).to(
                         torch.bfloat16)
    out, got = _block_grads(args, dy, num_heads=heads)
    want_out, want = _block_grads(args, dy, num_heads=heads, twin=True)
    _close_to_twin(out, want_out, 3e-2)
    f32 = [a.float() for a in args]
    _, truth = _block_grads(f32, dy.float(), num_heads=heads, twin=True)
    for g, w, t in zip(got, want, truth):
        _close_to_twin(g, w, 5e-2)
        ek = (g.float() - t).abs().mean().item()
        et = (w.float() - t).abs().mean().item()
        assert ek <= 1.5 * et + 1e-12


@pytest.mark.cuda
def test_block_backward_repeats_bit_for_bit(cuda):
    """The bf16 block backward, whose recompute runs the tensor-core
    forward kernels, at a batch whose dmod and weight grads sum over many
    tiles: every sum has one order (ordered per-tile partials, no
    atomics), so two calls agree bit for bit."""
    args = _block_args(cuda, torch.bfloat16, B=8, N=480, seed=6)
    dy = torch.randn(args[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(7)).to(
                         torch.bfloat16)
    a = tblock._launch_block_bwd(args[0], args[1], args[2:], dy, 4, 1e-6)
    b = tblock._launch_block_bwd(args[0], args[1], args[2:], dy, 4, 1e-6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def _block_attention_bwd(qkv, do, heads):
    """The bf16 block backward's attention VJP alone (the BLOCK recipe of
    csrc/heads_bwd.cuh) on the statistics of block_attn_stats; returns the
    kernel's (dq, dk, dv), the twin's, and the qkv slices."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    qscale = float(torch.tensor((D // heads) ** -0.5, dtype=qkv.dtype))
    m, r, delta = tblock.block_attn_stats(q, k, v, do, heads, qscale)
    st = torch.stack([m, 1.0 / r, delta], dim=-1).contiguous()
    dqkv = torch.empty_like(qkv)
    _build.launch(_build.load("dit_block_bwd"), "dit_block_attention_bwd_bf16",
                  "dit_block_attention_bwd", ValueError("refused"), qkv.device,
                  qkv, do, st, dqkv, B, N, D, heads, qscale)
    want = tblock.block_attn_bwd_reference(q, k, v, do, m, r, delta, qscale)
    return dqkv.split(D, dim=-1), want


@pytest.mark.cuda
@pytest.mark.parametrize("heads,N", [(8, 130), (4, 130), (4, 480), (2, 130),
                                     (1, 130), (8, 17)])
def test_block_attention_backward_matches_twin_on_card(cuda, heads, N):
    """The block backward's attention VJP at head widths 16, 32, 64 and 128
    (D 128) and ragged token counts, against block_attn_bwd_reference on the
    same statistics: bf16 3e-2 * max|ref| and correlation >= 0.999, as the
    other attention backwards (summation order and rounding flips of e and
    ds only)."""
    g = torch.Generator(cuda).manual_seed(heads * 1000 + N)
    qkv = torch.randn(3, N, 3 * 128, device=cuda, generator=g).to(
        torch.bfloat16)
    do = torch.randn(3, N, 128, device=cuda, generator=g).to(torch.bfloat16)
    got, want = _block_attention_bwd(qkv, do, heads)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close_to_twin(a, b, 3e-2)
        a, b = a.float().flatten(), b.float().flatten()
        assert torch.corrcoef(torch.stack([a, b]))[0, 1].item() >= 0.999


@pytest.mark.cuda
def test_bf16_block_backward_runs_the_tensor_core_kernels(cuda):
    """One bf16 block backward's profile: the recompute on the stack's
    kernels, the attention VJP on heads_bwd.cuh's q-tile and kv-tile
    kernels, the MLP half, attention output, qkv half and weight grads on
    the tensor-core kernels, and none of the backward's first kernels."""
    args = _block_args(cuda, torch.bfloat16, B=2, N=130, seed=8)
    dy = torch.randn(args[0].shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(9)).to(
                         torch.bfloat16)
    names, named = _profile_names(
        lambda: tblock._launch_block_bwd(args[0], args[1], args[2:], dy, 4,
                                         1e-6))
    for n in ("modln_qkv_tc_kernel", "heads_fwd_kernel", "proj_mlp_tc_kernel",
              "mlp_bwd_tc_kernel", "attn_out_bwd_tc_kernel",
              "heads_bwd_q_kernel", "heads_bwd_kv_kernel",
              "qkv_bwd_tc_kernel", "wgrad_tc_kernel", "dmod_reduce_kernel"):
        assert named(n), (n, sorted(names))
    for n in ("attn_dq_kernel", "attn_dkdv_kernel", "mlp_bwd_kernel",
              "attn_out_bwd_kernel", "qkv_bwd_kernel", "wgrad_kernel",
              "attn_proj_kernel", "modln_qkv_kernel"):
        assert not named(n), (n, sorted(names))


@pytest.mark.cuda
def test_block_kernels_refuse_shapes_they_do_not_take(cuda):
    args = _block_args(cuda, torch.bfloat16, B=1, N=16, D=96, hidden=192)
    assert not tblock.block_kernel_supported(96, 192, 4, torch.bfloat16)
    assert tblock.block_kernel_supported(128, 256, 4, torch.bfloat16)
    assert tblock.block_kernel_supported(128, 256, 4, torch.float32)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="does not take"):
        tblock.fused_dit_block(*args, num_heads=4)
    ok = _block_args(cuda, torch.bfloat16, B=1, N=16)
    with pytest.raises(ValueError, match="does not take"):
        tblock._launch_block_bwd(args[0], args[1], args[2:], args[0], 4, 1e-6)
    assert not _build.launch_counts
    with torch.no_grad():
        tblock.fused_dit_block(*ok, num_heads=4)
    assert _build.launch_counts == {tblock.BLOCK_KERNEL: 1}


@pytest.mark.cuda
def test_stack_refuses_autograd_on_card(cuda):
    args = _stack_args(cuda, torch.float32, B=1, N=16, L=1)
    args[2].requires_grad_()
    with pytest.raises(RuntimeError, match="fast_dit_train_forward"):
        tblock.fused_dit_stack(*args, num_heads=4)


@pytest.mark.cuda
def test_train_step_launches_both_kernels_per_layer(cuda):
    """One train step on a small DiT (256 tokens, inside the JAX token
    range of the block route): the block forward and backward each launch
    depth times, the loss is finite and every parameter moves."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.training import (make_denoiser_train_step,
                                         onecycle_adamw)
    torch.manual_seed(0)
    dit = DiT(latent_len=16, latent_dim=64, d_model=64, depth=2, num_heads=2,
              compute_dtype=torch.bfloat16)
    vae = LAVAE(1, 16, 1, 16, 64, 16)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn_like(p))
    before = [p.detach().clone() for p in dit.parameters()]
    step = make_denoiser_train_step(
        dit, vae, onecycle_adamw(dit.parameters(), 10, 1e-3))
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(4, 32, device=cuda, generator=g)
    emb = torch.randn(4, 64, device=cuda, generator=g)
    _build.reset_launch_counts()
    loss = step(x, emb, coin=torch.tensor(1.0, device=cuda), generator=g)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert dict(_build.launch_counts) == {tblock.BLOCK_KERNEL: 2,
                                          tblock.BLOCK_BWD_KERNEL: 2}
    assert all((p != b).any() for p, b in zip(dit.parameters(), before))


# --------------------------------------------- the split block kernel (#4)

def _split_args(dev, dt, B=3, N=130, D=512, hidden=2048, seed=2):
    """x and mod in ``dt``, random mod, f32 weights of standard deviation
    1/sqrt(fan-in), so the scores keep unit scale at every width."""
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    w = lambda i, o: f(i, o) / i ** 0.5
    x, mod = f(B, N, D), 0.3 * f(B, 6, D)
    ws = [w(D, 3 * D), 0.1 * f(3 * D), w(D, D), 0.1 * f(D), w(D, hidden),
          0.1 * f(hidden), w(hidden, D), 0.1 * f(D)]
    return [x.to(dev, dt), mod.to(dev, dt), *(t.to(dev) for t in ws)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 2e-4),
                                    (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("D,hidden,heads", [(512, 2048, 8),   # head width 64
                                            (512, 2048, 4),   # 128
                                            (128, 256, 4)])   # 32
def test_split_kernel_matches_twin_on_card(cuda, dt, tol, D, hidden, heads):
    """At a ragged N=130 and a batch that fills no tile; the bf16 kernel's
    mean error against the f32 twin at most 1.5x the bf16 twin's."""
    args = _split_args(cuda, dt, D=D, hidden=hidden)
    _build.reset_launch_counts()
    with torch.no_grad():
        got = tblock.fused_dit_block_split(*args, num_heads=heads)
        torch.cuda.synchronize()
        assert dict(_build.launch_counts) == {tblock.SPLIT_KERNEL: 1}
        want = tblock.fused_dit_block_reference(*args, heads)
        assert got.dtype == dt and got.shape == want.shape
        g, w = got.float(), want.float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= tol * w.abs().max().item()
        if dt == torch.bfloat16:
            truth = tblock.fused_dit_block_reference(
                *(a.float() for a in args), heads)
            ek = (g - truth).abs().mean().item()
            et = (w - truth).abs().mean().item()
            assert ek <= 1.5 * et


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 2e-4),
                                    (torch.bfloat16, 3e-2)])
def test_split_kernel_matches_stack_kernel_at_reference_geometry(cuda, dt,
                                                                 tol):
    """The two kernels compute the same block (d 128, 4 heads, hidden
    256), through different tilings."""
    args = _split_args(cuda, dt, D=128, hidden=256)
    with torch.no_grad():
        split = tblock.fused_dit_block_split(*args, num_heads=4).float()
        stack = tblock.fused_dit_block(*args, num_heads=4).float()
    assert (split - stack).abs().max().item() <= \
        tol * stack.abs().max().item()


@pytest.mark.cuda
def test_split_kernel_takes_a_batch_beyond_grid_y(cuda):
    """More attention blocks (and row tiles) than grid.y's 65535."""
    args = _split_args(cuda, torch.float32, B=70000, N=1, D=128, hidden=256)
    with torch.no_grad():
        got = tblock.fused_dit_block_split(*args, num_heads=4)
        want = tblock.fused_dit_block_reference(*args, 4)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_split_kernel_shape_limits(cuda):
    """The limits are the kernel library's own (dit_split_check)."""
    ok = tblock.split_kernel_supported
    assert ok(512, 2048, 8, torch.bfloat16)         # the scaled path
    assert ok(512, 2048, 4, torch.bfloat16)         # head width 128
    assert ok(512, 2048, 8, torch.float32)
    assert ok(128, 256, 4, torch.bfloat16)          # the reference geometry
    assert not ok(512, 2048, 8, torch.float16)      # no fp16 kernel
    assert not ok(96, 192, 4, torch.bfloat16)       # D not a 128 multiple
    assert not ok(512, 2048, 32, torch.bfloat16)    # head width 16
    assert not ok(256, 1024, 1, torch.bfloat16)     # head width 256
    assert not ok(1024, 4096, 8, torch.float32)     # staged LN tile, f32
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.denoisers.dit_fast import (
        fast_forward_supported, split_forward_supported)
    scaled = DiT(latent_len=64, latent_dim=64, d_model=512, depth=1,
                 num_heads=8, mlp_ratio=4.0, compute_dtype=torch.bfloat16)
    assert split_forward_supported(scaled)
    assert not fast_forward_supported(scaled)


@pytest.mark.cuda
def test_split_kernel_refuses_what_it_does_not_take(cuda):
    """A shape the kernel does not take raises and launches nothing; so
    does an input that requires grad under grad mode."""
    bad = _split_args(cuda, torch.bfloat16, B=1, N=16, D=96, hidden=192)
    _build.reset_launch_counts()
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        tblock.fused_dit_block_split(*bad, num_heads=4)
    args = _split_args(cuda, torch.float32, B=1, N=16, D=128, hidden=256)
    args[2].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tblock.fused_dit_block_split(*args, num_heads=4)
    assert not _build.launch_counts


def _profile_names(run):
    """The kernel names in a profile of two calls of ``run`` (after one
    warm-up call), and a test of whether one names ``n`` as a whole
    identifier."""
    import re
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        run()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    return names, lambda n: any(
        re.search(r"(?<![A-Za-z0-9_])" + re.escape(n), k) for k in names)


def _stage_args(dev, stage, D, hidden, B=3, N=130, seed=11):
    """One GEMM stage's operands in bf16 (mod f32, random): a (B, N, K),
    w (K, cols) of standard deviation 1/sqrt(K), bias, res (B, N, cols)."""
    K, cols = {"qkv": (D, 3 * D), "proj": (D, D), "fc1": (D, hidden),
               "fc2": (hidden, D)}[stage]
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    bf = lambda t: t.to(dev, torch.bfloat16)
    return (bf(f(B, N, K)), (0.3 * f(B, 6, D)).to(dev),
            bf(f(K, cols) / K ** 0.5), bf(0.1 * f(cols)), bf(f(B, N, cols)))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", tblock.SPLIT_GEMM_STAGES)
@pytest.mark.parametrize("D,hidden", [(128, 256), (512, 2048), (1024, 2048)])
def test_split_gemm_stage_matches_twin_on_card(cuda, stage, D, hidden):
    """Each bf16 GEMM stage of the split block alone (the wgmma row GEMM;
    at D 1024 the LayerNorm stages take the 64-row route) against its twin
    at ragged rows (B=3, N=130): 1e-2 * max|ref| (the same f32 products
    in another order, so at most a rounding flip of the LayerNorm's output
    or of the result) and correlation >= 0.999; one launch."""
    args = _stage_args(cuda, stage, D, hidden)
    _build.reset_launch_counts()
    got = tblock._launch_split_gemm(*args, stage)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tblock.SPLIT_GEMM_KERNEL: 1}
    want = tblock.split_gemm_reference(*args, stage)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    _close_to_twin(got, want, 1e-2)
    a, b = got.float().flatten(), want.float().flatten()
    assert torch.corrcoef(torch.stack([a, b]))[0, 1].item() >= 0.999


@pytest.mark.cuda
def test_split_gemm_routes_by_width(cuda):
    """The LayerNorm GEMMs stage a 128 x D tile (128-row blocks) while it,
    the ring and the output tiles fit 227 KB, else a 64 x D tile (64-row
    blocks), up to the widest D the split kernel took before the wgmma
    GEMMs (1536)."""
    route = tblock.split_gemm_route
    assert [route(d) for d in (128, 256, 512)] == ["wide"] * 3
    assert [route(d) for d in (640, 1024, 1536)] == ["narrow"] * 3
    assert route(1664) == "none"
    ok = tblock.split_kernel_supported
    assert ok(1536, 256, 12, torch.bfloat16)
    assert not ok(1664, 256, 13, torch.bfloat16)


@pytest.mark.cuda
def test_bf16_split_kernel_narrow_route_matches_twin_on_card(cuda):
    """The block at D 1024 (the 64-row route of the LayerNorm GEMMs),
    held as test_split_kernel_matches_twin_on_card holds the others."""
    args = _split_args(cuda, torch.bfloat16, D=1024, hidden=2048)
    assert tblock.split_gemm_route(1024) == "narrow"
    with torch.no_grad():
        got = tblock.fused_dit_block_split(*args, num_heads=8).float()
        want = tblock.fused_dit_block_reference(*args, 8).float()
        truth = tblock.fused_dit_block_reference(
            *(a.float() for a in args), 8)
    _close_to_twin(got, want, 3e-2)
    assert (got - truth).abs().mean() <= 1.5 * (want - truth).abs().mean()


@pytest.mark.cuda
def test_bf16_split_kernel_repeats_bit_for_bit(cuda):
    args = _split_args(cuda, torch.bfloat16, B=2, N=1024)
    with torch.no_grad():
        a = tblock.fused_dit_block_split(*args, num_heads=8)
        b = tblock.fused_dit_block_split(*args, num_heads=8)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_split_kernel_runs_the_wgmma_gemms(cuda):
    """One bf16 split block's profile: the attention on heads_fwd_kernel,
    the four products on wg_gemm_kernel, and no WMMA gemm_kernel."""
    args = _split_args(cuda, torch.bfloat16, B=2, N=130)
    with torch.no_grad():
        names, named = _profile_names(
            lambda: tblock.fused_dit_block_split(*args, num_heads=8))
    for n in ("heads_fwd_kernel", "wg_gemm_kernel<0, 0, 2, 128>",
              "wg_gemm_kernel<1, 2, 2, 128>", "wg_gemm_kernel<0, 1, 2, 128>"):
        assert named(n), (n, sorted(names))
    assert not named("gemm_kernel"), sorted(names)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["offline", "serving"])
def test_sampler_runs_a_wide_dit_through_the_split_kernel(cuda, entry):
    """A d_model 512 DiT (depth 1, 128 tokens): one split launch per
    sampler step and no stack launch."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    from t2ms_tpu_torch.serving import make_serving_sampler
    torch.manual_seed(0)
    dit = DiT(latent_len=8, latent_dim=64, d_model=512, depth=1, num_heads=8,
              mlp_ratio=4.0, compute_dtype=torch.bfloat16)
    vae = LAVAE(in_channels=1, latent_grid=8)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn_like(p))
    g = torch.Generator(cuda).manual_seed(0)
    emb = torch.randn(2, 512, device=cuda, generator=g)
    _build.reset_launch_counts()
    if entry == "offline":
        out = make_cfg_sampler(dit, vae, total_step=3)(
            torch.randn(2, 96, device=cuda, generator=g), emb).series
    else:
        out = make_serving_sampler(dit, vae, total_step=3,
                                   latent_shape=(64, 8))(
            np.array([1, 2], np.uint32), np.array([7.0, 3.0]), emb)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 96) and torch.isfinite(out).all()
    assert dict(_build.launch_counts) == {tblock.SPLIT_KERNEL: 3}


# ------------------------------ the flax path's kernels (#5, #6, #9, #11)

def _mod_ln_args(dev, dt, B=3, N=130, D=512, seed=3):
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    return (f(B, N, D).to(dev, dt), (0.3 * f(B, 2, D)).to(dev, dt),
            f(B, N, D).to(dev, dt))


def _mod_ln_grads(x, mod2, dy, twin):
    ts = [a.detach().clone().requires_grad_() for a in (x, mod2)]
    fn = tblock.mod_ln_reference if twin else tblock.mod_ln_diffable
    out = fn(*ts)
    return (out, *torch.autograd.grad(out, ts, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4),
                                    (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("D", [512, 96])
def test_mod_ln_kernels_match_twins_on_card(cuda, dt, tol, D):
    """#5 and #6 against the twin and autograd over it at a ragged N=130
    and B=3: out, dx and dmod2 within tol * max|ref| (f32: summation
    order; bf16: one rounding flip after f32 sums in another order), in
    x's and mod2's dtypes; one launch each."""
    x, mod2, dy = _mod_ln_args(cuda, dt, D=D)
    _build.reset_launch_counts()
    got = _mod_ln_grads(x, mod2, dy, twin=False)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tblock.MOD_LN_KERNEL: 1,
                                          tblock.MOD_LN_BWD_KERNEL: 1}
    want = _mod_ln_grads(x, mod2, dy, twin=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dt and g.shape == w.shape
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.cuda
def test_mod_ln_backward_repeats_bit_for_bit(cuda):
    x, mod2, dy = _mod_ln_args(cuda, torch.bfloat16, B=8, N=1024)
    a = tblock._launch_mod_ln_bwd(x, mod2, dy, 1e-6)
    b = tblock._launch_mod_ln_bwd(x, mod2, dy, 1e-6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _heads_args(dev, dt, B=3, N=130, HD=512, seed=4):
    """q, k, v as strided column slices of one qkv tensor, and g."""
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    qkv = torch.cat([1.5 * f(B, N, HD), 1.5 * f(B, N, HD), f(B, N, HD)],
                    dim=-1).to(dev, dt)
    return (qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:],
            f(B, N, HD).to(dev, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol_f,tol_b", [(torch.float32, 2e-4, 5e-4),
                                            (torch.bfloat16, 1e-2, 3e-2)])
@pytest.mark.parametrize("heads", [16, 8, 4])         # head widths 32, 64, 128
@pytest.mark.parametrize("N", [1, 17, 130, 1000])
def test_fused_heads_kernels_match_twins_on_card(cuda, dt, tol_f, tol_b,
                                                 heads, N):
    """#9 and #11 on the column slices of one qkv tensor (read in place
    through their strides) at B=3, against the twins: one row, part of one
    64-row tile, a ragged third tile and 16 tiles of which the last is
    ragged; forward within tol_f * max|ref|, dq, dk, dv within tol_b *
    max|ref| (f32: summation order; bf16: rounding flips of e and ds_u,
    which feed sums of N terms). At N=1 the one key gets p = 1, so dq and
    dk are residues, zero in exact arithmetic, and each gradient is held
    to tol_b times the largest reference (dv = g there)."""
    q, k, v, g = _heads_args(cuda, dt, N=N)
    _build.reset_launch_counts()
    with torch.no_grad():
        o = tattn.fused_heads_attention(q, k, v, heads)
        grads = tattn.fused_heads_attention_bwd(q, k, v, g, heads,
                                                pipelined=True)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tattn.FUSED_HEADS_KERNEL: 1,
                                          tattn.FUSED_HEADS_BWD_KERNEL: 1}
    want_o = tattn.fused_heads_reference(q, k, v, heads)
    want = tattn.fused_heads_bwd_reference(q, k, v, g, heads)
    assert o.dtype == dt and o.shape == want_o.shape
    assert torch.isfinite(o).all()
    err = (o.float() - want_o.float()).abs().max().item()
    assert err <= tol_f * want_o.float().abs().max().item()
    _assert_grads_close(grads, want, dt, tol_b, scale_of_all=N == 1)


@pytest.mark.cuda
def test_fused_heads_forward_repeats_bit_for_bit(cuda):
    """The bf16 forward (#9, and #10 with its lse) at the scaled call's
    geometry, 8 heads of 64 over 16 K tiles: each row's sums have one
    order, so two calls agree bit for bit."""
    q, k, v, _ = _heads_args(cuda, torch.bfloat16, B=4, N=1024)
    a = tattn.fused_heads_attention(q, k, v, 8)
    b = tattn.fused_heads_attention(q, k, v, 8)
    sa = tattn.fused_heads_attention_with_stats(q, k, v, 8)
    sb = tattn.fused_heads_attention_with_stats(q, k, v, 8)
    assert torch.equal(a, b) and torch.equal(sa[0], a)
    assert torch.equal(sa[1], sb[1])


@pytest.mark.cuda
def test_fused_heads_backward_repeats_bit_for_bit(cuda):
    q, k, v, g = _heads_args(cuda, torch.bfloat16, B=4, N=1024)
    a = tattn.fused_heads_attention_bwd(q, k, v, g, 8, pipelined=True)
    b = tattn.fused_heads_attention_bwd(q, k, v, g, 8, pipelined=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_flax_path_kernels_refuse_what_they_do_not_take(cuda):
    """The limits are the libraries' own (mod_ln_check, fused_heads_check):
    a shape they do not take raises and launches nothing; the forward
    refuses an input that requires grad under grad mode."""
    assert tblock.mod_ln_supported(512, torch.bfloat16)
    assert tblock.mod_ln_supported(512, torch.float32)
    assert not tblock.mod_ln_supported(2048, torch.bfloat16)   # 64 a lane
    assert not tblock.mod_ln_supported(512, torch.float16)
    ok = tattn.fused_heads_supported
    assert ok(512, 8, torch.bfloat16) and ok(512, 4, torch.float32)
    assert not ok(512, 32, torch.bfloat16)                     # width 16
    assert not ok(512, 2, torch.bfloat16)                      # width 256
    assert not ok(512, 8, torch.float16)
    _build.reset_launch_counts()
    x, mod2, _ = _mod_ln_args(cuda, torch.bfloat16, B=1, N=8, D=2048)
    with pytest.raises(ValueError, match="does not take"):
        tblock.mod_ln_diffable(x, mod2)
    q, k, v, g = _heads_args(cuda, torch.bfloat16, B=1, N=8, HD=512)
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        tattn.fused_heads_attention(q, k, v, 32)
    with pytest.raises(ValueError, match="does not take"):
        tattn.fused_heads_attention_bwd(q, k, v, g, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.fused_heads_attention(q.detach().requires_grad_(), k, v, 8)
    assert not _build.launch_counts


@pytest.mark.cuda
def test_train_step_takes_the_flax_path_for_a_wide_dit(cuda):
    """One train step of a d_model 512 DiT (depth 1, 16 tokens), which the
    block kernels do not take: the flax path with the residual fusion, one
    LayerNorm + modulate and one gated residual + LayerNorm + modulate
    launch each way, and the attention as JAX's ``_Attention`` runs it on a
    TPU at 16 tokens (``fused_heads_block_q`` is 0 below 128 tokens, so
    einsum attention, no kernel); nothing else; the loss is finite and
    every parameter moves."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.denoisers.dit_fast import (
        flax_path_supported, train_forward_supported)
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    torch.manual_seed(0)
    dit = DiT(latent_len=8, latent_dim=8, d_model=512, depth=1, num_heads=8,
              mlp_ratio=4.0, compute_dtype=torch.bfloat16)
    assert not train_forward_supported(dit) and flax_path_supported(dit)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn_like(p))
    before = [p.detach().clone() for p in dit.parameters()]
    step = make_denoiser_train_step(
        dit, LAVAE(1, 16, 1, 16, 8, 8),
        ScheduledAdamW(dit.parameters(), lambda _: 1e-4), precoded=True)
    g = torch.Generator(cuda).manual_seed(0)
    _build.reset_launch_counts()
    loss = step(torch.randn(4, 8, 8, device=cuda, generator=g),
                torch.randn(4, 512, device=cuda, generator=g),
                coin=torch.tensor(1.0, device=cuda), generator=g)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert tattn.attention_route(16, 512) == "einsum"
    assert dict(_build.launch_counts) == {
        tblock.MOD_LN_KERNEL: 1, tblock.MOD_LN_BWD_KERNEL: 1,
        tblock.RES_MOD_LN_KERNEL: 1, tblock.RES_MOD_LN_BWD_KERNEL: 1}
    assert all((p != b).any() for p, b in zip(dit.parameters(), before))


@pytest.mark.cuda
def test_train_step_refuses_a_dit_no_route_takes(cuda):
    """Head width 16 at 480 tokens: neither the block kernels (D 512 >
    256) nor the fused-heads kernels, which JAX's route picks there, take
    it; the step raises, naming the kernels' limits, instead of running
    the eager model."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    dit = DiT(latent_len=30, latent_dim=64, d_model=512, depth=1,
              num_heads=32, mlp_ratio=4.0, compute_dtype=torch.bfloat16)
    assert tattn.attention_route(480, 512) == "fused"
    step = make_denoiser_train_step(
        dit, LAVAE(1, 16, 1, 16, 8, 30),
        ScheduledAdamW(dit.parameters(), lambda _: 1e-4), precoded=True)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="does not train.*head widths 32, "
                                         "64 or 128"):
        step(torch.zeros(2, 64, 30, device=cuda),
             torch.zeros(2, 512, device=cuda))
    assert not _build.launch_counts


# --------------- the long-series path's kernels (#7, #8, #12, #11 recompute)

def _res_args(dev, dt, B=3, N=130, D=512, seed=5):
    """x, h, gm3 = [gate, shift, scale] and the cotangents do, dy."""
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    return (f(B, N, D).to(dev, dt), f(B, N, D).to(dev, dt),
            (0.3 * f(B, 3, D)).to(dev, dt), f(B, N, D).to(dev, dt),
            f(B, N, D).to(dev, dt))


def _res_grads(x, h, gm3, do, dy, twin):
    ts = [a.detach().clone().requires_grad_() for a in (x, h, gm3)]
    fn = tblock.res_mod_ln_reference if twin else tblock.res_mod_ln_diffable
    out, y = fn(*ts)
    return (out, y, *torch.autograd.grad((out, y), ts, (do, dy)))


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4),
                                    (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("D", [512, 128, 96])
def test_res_mod_ln_kernels_match_twins_on_card(cuda, dt, tol, D):
    """#7 and #8 against the twin and autograd over it at a ragged N=130
    and B=3: out, y, dx, dh and dgm3 within tol * max|ref| (f32: summation
    order; bf16: one rounding flip after f32 sums in another order), in
    the inputs' dtypes; one launch each."""
    args = _res_args(cuda, dt, D=D)
    _build.reset_launch_counts()
    got = _res_grads(*args, twin=False)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tblock.RES_MOD_LN_KERNEL: 1,
                                          tblock.RES_MOD_LN_BWD_KERNEL: 1}
    want = _res_grads(*args, twin=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dt and g.shape == w.shape
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [130, 77])
@pytest.mark.parametrize("D", [64, 100, 128, 512, 1024])
def test_bf16_res_mod_ln_backward_matches_twin_across_widths(cuda, D, N):
    """#8 in bf16 against autograd over its twin at ragged token counts:
    dx, dh and dgm3 within 1e-2 * max|ref| (one rounding flip after f32
    sums in another order). D a multiple of 8 runs the 16-byte-chunk
    kernel (D 64: 8 lanes a row, 128: 16, 512: 2 chunks a lane, 1024: 4),
    D 100 the lane-strided one: the profile says which."""
    args = _res_args(cuda, torch.bfloat16, N=N, D=D)
    got = _res_grads(*args, twin=False)
    want = _res_grads(*args, twin=True)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        _close_to_twin(g, w, 1e-2)
    names, named = _profile_names(
        lambda: tblock._launch_res_mod_ln_bwd(*args[:3], *args[3:], 1e-6))
    vec = D % 8 == 0
    assert named("res_mod_ln_bwd_vec_kernel") == vec, sorted(names)
    assert named("res_mod_ln_bwd_kernel") == (not vec), sorted(names)


@pytest.mark.cuda
def test_res_mod_ln_backward_repeats_bit_for_bit(cuda):
    x, h, gm3, do, dy = _res_args(cuda, torch.bfloat16, B=4, N=4096, D=128)
    a = tblock._launch_res_mod_ln_bwd(x, h, gm3, do, dy, 1e-6)
    b = tblock._launch_res_mod_ln_bwd(x, h, gm3, do, dy, 1e-6)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 5e-4),
                                    (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("HD,heads", [(128, 4), (512, 8), (512, 4)])
@pytest.mark.parametrize("two_pass", [True, False])
def test_recompute_backward_matches_twin_on_card(cuda, dt, tol, HD, heads,
                                                 two_pass):
    """#12 (``fused_heads_attention_bwd_two_pass``) and #11 with the
    recompute recipe (``pipelined=False``) on the column slices of one qkv
    tensor at a ragged N=130 and B=3, against the recompute twin: dq, dk,
    dv within tol * max|ref| (f32: summation order; bf16: rounding flips
    of p and ds, which feed sums of 130 terms); one launch under each
    kernel's own name."""
    q, k, v, g = _heads_args(cuda, dt, HD=HD)
    _build.reset_launch_counts()
    if two_pass:
        got = tattn.fused_heads_attention_bwd_two_pass(q, k, v, g, heads)
        name = tattn.FUSED_HEADS_TWO_PASS_KERNEL
    else:
        got = tattn.fused_heads_attention_bwd(q, k, v, g, heads,
                                              pipelined=False)
        name = tattn.FUSED_HEADS_BWD_KERNEL
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {name: 1}
    want = tattn.fused_heads_bwd_two_pass_reference(q, k, v, g, heads)
    for a, w in zip(got, want):
        assert a.dtype == dt and a.shape == w.shape
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.cuda
def test_two_pass_backward_repeats_bit_for_bit(cuda):
    q, k, v, g = _heads_args(cuda, torch.bfloat16, B=2, N=4096, HD=128)
    a = tattn.fused_heads_attention_bwd_two_pass(q, k, v, g, 4)
    b = tattn.fused_heads_attention_bwd_two_pass(q, k, v, g, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _long_dit(latent_len=128, depth=1):
    """A d_model 128 DiT of 4 heads over a (latent_len, 64) latent:
    (latent_len / 2) * 32 tokens, beyond the JAX token range of the stack,
    split and block routes."""
    from t2ms_tpu_torch.models.denoisers import DiT
    torch.manual_seed(0)
    dit = DiT(latent_len=latent_len, latent_dim=64, d_model=128,
              depth=depth, num_heads=4, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn_like(p))
    return dit


@pytest.mark.cuda
def test_routes_take_the_jax_token_range_on_card(cuda):
    """The libraries take d_model 128 with 4 heads, but the stack, split
    and block routes refuse 4096 tokens (JAX: 128 <= N <= 1024), so the
    long-series DiT takes the flax path; the flagship DiT keeps the stack
    and block kernels."""
    from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
    assert tblock.res_mod_ln_supported(512, torch.bfloat16)
    assert tblock.res_mod_ln_supported(128, torch.float32)
    assert not tblock.res_mod_ln_supported(2048, torch.bfloat16)
    assert not tblock.res_mod_ln_supported(128, torch.float16)
    long = _long_dit(latent_len=256)
    assert long.num_patches == 4096
    assert not dit_fast.fast_forward_supported(long)
    assert not dit_fast.split_forward_supported(long)
    assert not dit_fast.train_forward_supported(long)
    assert dit_fast.flax_path_supported(long)
    flagship = DiT(compute_dtype=torch.bfloat16)
    assert dit_fast.fast_forward_supported(flagship)
    assert dit_fast.train_forward_supported(flagship)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["offline", "serving"])
def test_sampler_runs_a_long_dit_through_the_flax_path(cuda, entry):
    """A 2048-token DiT (depth 1): per sampler step one LayerNorm +
    modulate, one gated residual + LayerNorm + modulate and one fused-heads
    launch, and no stack or split launch."""
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    from t2ms_tpu_torch.serving import make_serving_sampler
    dit = _long_dit()
    vae = LAVAE(in_channels=1, latent_grid=128)
    g = torch.Generator(cuda).manual_seed(0)
    emb = torch.randn(2, 128, device=cuda, generator=g)
    _build.reset_launch_counts()
    if entry == "offline":
        out = make_cfg_sampler(dit, vae, total_step=3)(
            torch.randn(2, 96, device=cuda, generator=g), emb).series
    else:
        out = make_serving_sampler(dit, vae, total_step=3,
                                   latent_shape=(64, 128))(
            np.array([1, 2], np.uint32), np.array([7.0, 3.0]), emb)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, 96) and torch.isfinite(out).all()
    assert dict(_build.launch_counts) == {
        tblock.MOD_LN_KERNEL: 3, tblock.RES_MOD_LN_KERNEL: 3,
        tattn.FUSED_HEADS_KERNEL: 3}


@pytest.mark.cuda
def test_train_step_takes_the_two_pass_backward_for_a_long_dit(cuda):
    """One train step of a 2048-token DiT (depth 2): per step #5 once, #7
    three times, #9 twice forward; #6 once, #8 three times and #12 twice
    backward (JAX's two-pass branch at N=2048, H*D=128); nothing else; the
    loss is finite and every parameter moves."""
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    assert tattn.fused_heads_bwd_route(2048, 128, 4) == "two_pass"
    dit = _long_dit(depth=2)
    before = [p.detach().clone() for p in dit.parameters()]
    step = make_denoiser_train_step(
        dit, LAVAE(in_channels=1, latent_grid=128),
        ScheduledAdamW(dit.parameters(), lambda _: 1e-4))
    g = torch.Generator(cuda).manual_seed(0)
    _build.reset_launch_counts()
    loss = step(torch.randn(2, 256, device=cuda, generator=g),
                torch.randn(2, 128, device=cuda, generator=g),
                coin=torch.tensor(1.0, device=cuda), generator=g)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert dict(_build.launch_counts) == {
        tblock.MOD_LN_KERNEL: 1, tblock.MOD_LN_BWD_KERNEL: 1,
        tblock.RES_MOD_LN_KERNEL: 3, tblock.RES_MOD_LN_BWD_KERNEL: 3,
        tattn.FUSED_HEADS_KERNEL: 2, tattn.FUSED_HEADS_TWO_PASS_KERNEL: 2}
    assert all((p != b).any() for p, b in zip(dit.parameters(), before))


# --------------- the head-split kernels (#15, #16, #17) and their routes

def _head_split_args(dev, dt, B=3, H=4, N=200, D=32, seed=6):
    """q, k, v as the head-split (B, H, N, D) views of one qkv tensor."""
    r = np.random.default_rng(seed)
    qkv = torch.from_numpy(r.standard_normal((B, N, 3 * H * D)).astype(
        np.float32)).to(dev, dt)
    return qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)


_SPLIT = [("flash_attention", "flash_reference", "FLASH_KERNEL"),
          ("vmem_attention", "vmem_reference", "VMEM_KERNEL"),
          ("packed_attention", "packed_reference", "PACKED_KERNEL")]


def _split_call(fn, q, k, v):
    """One head-split kernel call; flash_attention with blocks of N, so
    that it launches its kernel at every N (its own blocks would send
    N=17 to einsum_attention, as JAX's do)."""
    if fn == "flash_attention":
        n = q.shape[2]
        return tattn.flash_attention(q, k, v, block_q=n, block_k=n)
    return getattr(tattn, fn)(q, k, v)


def _split_matches_twin(fn, twin, name, q, k, v, tol):
    before = _build.launch_counts[getattr(tattn, name)]
    B, H, N, D = q.shape
    if fn == "packed_attention":
        try:
            tattn._packed_pack(B * H, N, D, q.element_size(), 4)
        except ValueError:          # JAX refuses this geometry: so does it
            with pytest.raises(ValueError, match="exceeds VMEM"):
                _split_call(fn, q, k, v)
            assert _build.launch_counts[getattr(tattn, name)] == before
            return
    with torch.no_grad():
        got = _split_call(fn, q, k, v)
        torch.cuda.synchronize()
        want = getattr(tattn, twin)(q, k, v)
    assert _build.launch_counts[getattr(tattn, name)] == before + 1
    assert got.dtype == q.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 2e-4),
                                    (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("N", [1, 17, 130, 200, 480, 1000])
@pytest.mark.parametrize("fn,twin,name", _SPLIT)
def test_split_heads_kernels_match_twins_on_card(cuda, dt, tol, D, N, fn,
                                                 twin, name):
    """Each head-split kernel against its twin on the strided head-split
    views of one qkv tensor, one launch each: one partial tile (1, 17),
    tile edges (130, 200), and both sides of the exact kernels' switch
    from the resident route to the streaming one (split_heads_route: 480
    resident at head width 32, streamed at 64 and 128; 1000 streamed from
    32 on)."""
    q, k, v = _head_split_args(cuda, dt, N=N, D=D)
    _split_matches_twin(fn, twin, name, q, k, v, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,twin,name", _SPLIT)
def test_split_heads_kernels_split_a_few_heads_on_card(cuda, fn, twin, name):
    """Four heads of 480 tokens (B=1) in bf16: too few heads to fill the
    card, so the resident route splits each head's q tiles over several
    blocks; against the twin."""
    q, k, v = _head_split_args(cuda, torch.bfloat16, B=1, H=4, N=480)
    _split_matches_twin(fn, twin, name, q, k, v, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [480, 1000])
@pytest.mark.parametrize("fn,twin,name", _SPLIT)
def test_split_heads_kernels_repeat_bit_for_bit(cuda, N, fn, twin, name):
    """Two calls on the same inputs give the same bits (no atomics, fixed
    sums), on both routes."""
    q, k, v = _head_split_args(cuda, torch.bfloat16, N=N)
    with torch.no_grad():
        a, b = _split_call(fn, q, k, v), _split_call(fn, q, k, v)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernel_at_long_rows_matches_twin_on_card(cuda):
    """8192 tokens in bf16 (the 8192-token DiT's attention, B=1): the
    online rescaling over 128 key tiles against the whole-row twin."""
    q, k, v = _head_split_args(cuda, torch.bfloat16, B=1, N=8192)
    with torch.no_grad():
        got = tattn.flash_attention(q, k, v).float()
        want = tattn.flash_reference(q, k, v).float()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


@pytest.mark.cuda
def test_split_heads_kernels_refuse_what_they_do_not_take(cuda):
    """Head widths 16, 32, 64, 128 in bf16 or f32 (split_heads_check); a
    shape they refuse raises and launches nothing; packed_attention also
    raises where JAX's does; flash_attention falls back to
    einsum_attention where no block divides N, as JAX's does; a forward
    refuses an input that requires grad under grad mode."""
    ok = tattn.split_heads_supported
    assert ok(32, torch.bfloat16) and ok(128, torch.float32)
    assert not ok(8, torch.bfloat16) and not ok(256, torch.bfloat16)
    assert not ok(48, torch.bfloat16) and not ok(32, torch.float16)
    _build.reset_launch_counts()
    for D in (8, 256):
        q, k, v = _head_split_args(cuda, torch.bfloat16, B=1, N=64, D=D)
        for fn, _, _ in _SPLIT:
            with torch.no_grad(), pytest.raises(ValueError,
                                                match="does not take"):
                getattr(tattn, fn)(q, k, v)
    q, k, v = _head_split_args(cuda, torch.bfloat16, B=1, N=1040)
    with pytest.raises(ValueError, match="exceeds VMEM"):
        tattn.packed_attention(q, k, v)
    q, k, v = _head_split_args(cuda, torch.bfloat16, B=1, N=100)   # no block
    with torch.no_grad():
        got = tattn.flash_attention(q, k, v)
    assert torch.equal(got, tattn.einsum_attention(q, k, v))
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.vmem_attention(q.detach().requires_grad_(), k, v)
    assert not _build.launch_counts


@pytest.mark.cuda
@pytest.mark.parametrize("impl,name", [("flash", "FLASH_KERNEL"),
                                       ("packed", "PACKED_KERNEL")])
def test_attention_impls_train_through_the_kernels(cuda, impl, name):
    """``attention(..., impl)``: the kernel forward (one launch) and the
    einsum-recompute backward, whose gradients are autograd's over
    ``einsum_attention`` in f32."""
    q, k, v = (t.detach().requires_grad_()
               for t in _head_split_args(cuda, torch.float32, B=2, N=256))
    g = torch.randn(q.shape, device=cuda, generator=torch.Generator(
        cuda).manual_seed(1))
    _build.reset_launch_counts()
    got = torch.autograd.grad(tattn.attention(q, k, v, impl), (q, k, v), g)
    assert dict(_build.launch_counts) == {getattr(tattn, name): 1}
    want = torch.autograd.grad(tattn.einsum_attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _flash_dit(depth=1):
    """A d_model 128 DiT of 4 heads over the (66, 64) latent: 1056 tokens,
    where JAX's fused-heads envelope is 0 and the flash blocks divide N."""
    from t2ms_tpu_torch.models.denoisers import DiT
    torch.manual_seed(0)
    dit = DiT(latent_len=66, latent_dim=64, d_model=128, depth=depth,
              num_heads=4, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn_like(p))
    return dit


@pytest.mark.cuda
def test_sampler_and_train_step_take_the_flash_route(cuda):
    """At 1056 tokens the flax path runs #15 (JAX's route on a TPU): per
    sampler step #5, #7 and #15 once each (depth 1) and no stack, split or
    fused-heads launch; a train step launches #5, #7 and #15 forward and
    #6 and #8 backward (the attention backward is the einsum recompute),
    with a finite loss."""
    from t2ms_tpu_torch.models.denoisers import dit_fast
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    dit = _flash_dit()
    assert dit_fast.flax_attention_route(dit) == "flash"
    assert dit_fast.flax_path_supported(dit)
    vae = LAVAE(in_channels=1, latent_grid=66)
    g = torch.Generator(cuda).manual_seed(0)
    emb = torch.randn(2, 128, device=cuda, generator=g)
    _build.reset_launch_counts()
    out = make_cfg_sampler(dit, vae, total_step=3)(
        torch.randn(2, 96, device=cuda, generator=g), emb).series
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert dict(_build.launch_counts) == {
        tblock.MOD_LN_KERNEL: 3, tblock.RES_MOD_LN_KERNEL: 3,
        tattn.FLASH_KERNEL: 3}
    step = make_denoiser_train_step(
        dit, vae, ScheduledAdamW(dit.parameters(), lambda _: 1e-4))
    _build.reset_launch_counts()
    loss = step(torch.randn(2, 132, device=cuda, generator=g), emb,
                coin=torch.tensor(1.0, device=cuda), generator=g)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert dict(_build.launch_counts) == {
        tblock.MOD_LN_KERNEL: 1, tblock.MOD_LN_BWD_KERNEL: 1,
        tblock.RES_MOD_LN_KERNEL: 1, tblock.RES_MOD_LN_BWD_KERNEL: 1,
        tattn.FLASH_KERNEL: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("impl,name", [("flash", "FLASH_KERNEL"),
                                       ("packed", "PACKED_KERNEL"),
                                       ("fused", "FUSED_HEADS_KERNEL")])
def test_eager_dit_dispatches_attention_impl_on_card(cuda, impl, name):
    """The eager DiT with an explicit ``attention_impl`` launches the kernel
    its impl names, once a layer, and nothing else (its LayerNorms stay
    eager, as JAX's explicit impls opt out of the LayerNorm kernels)."""
    from t2ms_tpu_torch.models.denoisers import DiT
    torch.manual_seed(0)
    dit = DiT(depth=2, compute_dtype=torch.bfloat16, attention_impl=impl)
    x = torch.randn(2, 64, 30, device=cuda)
    _build.reset_launch_counts()
    with torch.no_grad():
        out = dit(x, torch.rand(2, device=cuda), None, None)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert dict(_build.launch_counts) == {getattr(tattn, name): 2}


# ------------------------------------------------ the lse family (#10, #13, #14)

@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol_f,tol_lse", [(torch.float32, 2e-4, 1e-4),
                                              (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("heads", [16, 8, 4])         # head widths 32, 64, 128
@pytest.mark.parametrize("N", [1, 17, 130, 1000])
def test_stats_forward_matches_forward_and_twin_on_card(cuda, dt, tol_f,
                                                        tol_lse, heads, N):
    """#10 on the column slices of one qkv tensor (read in place through
    their strides) at B=3 and N from one row to 16 tiles with a ragged
    last one: o bit for bit #9's, o within tol_f * max|ref| of the twin and
    lse within tol_lse absolute (f32: summation order; bf16: rounding flips
    of e, each 2^-8 / r of lse)."""
    q, k, v, _ = _heads_args(cuda, dt, N=N)
    _build.reset_launch_counts()
    o, lse = tattn.fused_heads_attention_with_stats(q, k, v, heads)
    plain = tattn.fused_heads_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tattn.FUSED_HEADS_STATS_KERNEL: 1,
                                          tattn.FUSED_HEADS_KERNEL: 1}
    assert torch.equal(o, plain)
    want_o, want_lse = tattn.fused_heads_stats_reference(q, k, v, heads)
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    assert torch.isfinite(lse).all()
    assert (lse - want_lse).abs().max().item() <= tol_lse
    err = (o.float() - want_o.float()).abs().max().item()
    assert err <= tol_f * want_o.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 5e-4),
                                    (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("HD,heads", [(128, 4), (512, 8), (512, 4)])
@pytest.mark.parametrize("two_pass", [True, False])
def test_lean_backwards_match_twin_on_card(cuda, dt, tol, HD, heads,
                                           two_pass):
    """#13 and #14 on the column slices of one qkv tensor at a ragged N=130
    and B=3, from #10's o and lse, against the lean twin on the same o and
    lse: dq, dk, dv within tol * max|ref| (f32: summation order; bf16:
    rounding flips of p and ds, which feed sums of 130 terms); one launch
    under each kernel's own name."""
    q, k, v, g = _heads_args(cuda, dt, HD=HD)
    o, lse = tattn.fused_heads_attention_with_stats(q, k, v, heads)
    _build.reset_launch_counts()
    fn, name = ((tattn.fused_heads_attention_bwd_lean_two_pass,
                 tattn.FUSED_HEADS_LEAN_TWO_PASS_KERNEL) if two_pass else
                (tattn.fused_heads_attention_bwd_lean,
                 tattn.FUSED_HEADS_LEAN_KERNEL))
    got = fn(q, k, v, g, o, lse, heads)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {name: 1}
    want = tattn.fused_heads_bwd_lean_reference(q, k, v, g, o, lse, heads)
    for a, w in zip(got, want):
        assert a.dtype == dt and a.shape == w.shape
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.cuda
def test_lean_backward_repeats_bit_for_bit(cuda):
    q, k, v, g = _heads_args(cuda, torch.bfloat16, B=2, N=4096, HD=128)
    o, lse = tattn.fused_heads_attention_with_stats(q, k, v, 4)
    a = tattn.fused_heads_attention_bwd_lean_two_pass(q, k, v, g, o, lse, 4)
    b = tattn.fused_heads_attention_bwd_lean_two_pass(q, k, v, g, o, lse, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _recipe_grads(recipe, q, k, v, g, heads, twin):
    """(dq, dk, dv) of one backward recipe, the kernels' or (``twin``) the
    plain twin's; the lean recipe from #10's o and lse."""
    if recipe == "lean":
        o, lse = tattn.fused_heads_attention_with_stats(q, k, v, heads)
        fn = (tattn.fused_heads_bwd_lean_reference if twin
              else tattn.fused_heads_attention_bwd_lean)
        return fn(q, k, v, g, o, lse, heads)
    pipelined = recipe == "pipelined"
    if twin:
        fn = (tattn.fused_heads_bwd_reference if pipelined
              else tattn.fused_heads_bwd_two_pass_reference)
        return fn(q, k, v, g, heads)
    return tattn.fused_heads_attention_bwd(q, k, v, g, heads,
                                           pipelined=pipelined)


def _assert_grads_close(got, want, dt, tol, scale_of_all=False):
    """Each gradient within tol * max|ref|; with ``scale_of_all``, within
    tol * the largest max|ref| of the three."""
    top = max(w.float().abs().max().item() for w in want)
    for a, w in zip(got, want):
        assert a.dtype == dt and a.shape == w.shape
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all()
        ref = top if scale_of_all else w.abs().max().item()
        assert (a - w).abs().max().item() <= tol * ref


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [(torch.float32, 5e-4),
                                    (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("heads", [16, 8, 4])         # head widths 32, 64, 128
@pytest.mark.parametrize("N", [1, 64, 130, 1000])
@pytest.mark.parametrize("recipe", ["pipelined", "recompute", "lean"])
def test_backward_recipes_match_twins_across_tiles_on_card(cuda, dt, tol,
                                                           heads, N, recipe):
    """Each backward recipe (#11 pipelined, #11/#12 recompute, #13/#14
    lean) on the column slices of one qkv tensor at B=2 against its twin,
    at one row (every tile ragged), one whole 64-row tile, a ragged third
    tile and 16 tiles of which the last is ragged: dq, dk, dv within tol *
    max|ref| (f32: summation order; bf16: rounding flips of e, p and ds).
    At N=1 the one key gets p = 1, so dq and dk are the residue of
    dp - delta, zero in exact arithmetic, and each gradient is held to tol
    times the largest reference (dv = g there)."""
    q, k, v, g = _heads_args(cuda, dt, B=2, N=N)
    with torch.no_grad():
        got = _recipe_grads(recipe, q, k, v, g, heads, twin=False)
        torch.cuda.synchronize()
        want = _recipe_grads(recipe, q, k, v, g, heads, twin=True)
    _assert_grads_close(got, want, dt, tol, scale_of_all=N == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["pipelined", "recompute", "lean"])
def test_backward_recipes_match_twins_over_many_waves_on_card(cuda, recipe):
    """B=4, N=2048, 8 heads of 64 in bf16: 1024 blocks a kernel, more than
    the card holds at once, against the twin within 3e-2 * max|ref|."""
    q, k, v, g = _heads_args(cuda, torch.bfloat16, B=4, N=2048)
    with torch.no_grad():
        got = _recipe_grads(recipe, q, k, v, g, 8, twin=False)
        torch.cuda.synchronize()
        want = _recipe_grads(recipe, q, k, v, g, 8, twin=True)
    _assert_grads_close(got, want, torch.bfloat16, 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,HD,heads,name", [
    (2, 1024, 512, 8, "FUSED_HEADS_LEAN_KERNEL"),            # scaled
    (1, 4096, 128, 4, "FUSED_HEADS_LEAN_TWO_PASS_KERNEL")])  # long series
def test_diffable_takes_the_lean_kernels_on_card(cuda, monkeypatch, B, N, HD,
                                                 heads, name):
    """``fused_heads_diffable`` with ``T2MS_ATTN_LEAN_BWD=1`` launches #10
    forward and the lean kernel JAX's predicates pick backward, and its
    grads agree with those of the switch off (the recompute and pipelined
    recipes round elsewhere: 3e-2 * max|ref|)."""
    q, k, v, _ = _heads_args(cuda, torch.bfloat16, B=B, N=N, HD=HD)
    w = torch.randn(q.shape, device=cuda)

    def grads():
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        o = tattn.fused_heads_diffable(*ts, heads)
        (o.float() * w).sum().backward()
        return [t.grad.float() for t in ts]

    monkeypatch.setenv("T2MS_ATTN_LEAN_BWD", "1")
    _build.reset_launch_counts()
    lean = grads()
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tattn.FUSED_HEADS_STATS_KERNEL: 1,
                                          getattr(tattn, name): 1}
    monkeypatch.delenv("T2MS_ATTN_LEAN_BWD")
    for a, b in zip(lean, grads()):
        assert (a - b).abs().max().item() <= 3e-2 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(batch_block=3),
                                dict(attn_impl="folded"),
                                dict(batch_block=3, attn_impl="folded")])
def test_stack_variants_equal_the_plain_call_on_card(cuda, kw):
    """``fused_dit_stack``'s ``batch_block`` and ``folded`` variants run the
    plain call's launch: bit for bit its output, counted as the stack."""
    args = _stack_args(cuda, torch.bfloat16)
    plain = tblock.fused_dit_stack(*args, num_heads=4)
    _build.reset_launch_counts()
    got = tblock.fused_dit_stack(*args, num_heads=4, **kw)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tblock.STACK_KERNEL: 1}
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_prefetch_copies_batches_to_the_card(cuda):
    """Pinned copies on a side stream: every batch arrives whole, and work
    queued on the consumer's stream right after a batch is handed out
    reads the copied values (the consumer waits on the copy's event)."""
    from t2ms_tpu_torch.data.prefetch import prefetch_to_device
    src = [np.full((4096, 4096), i, np.float32) for i in range(4)]
    sums = []
    for b, (x,) in prefetch_to_device(iter(src), device=cuda,
                                      transform=lambda a: (a,)):
        assert x.is_cuda and x.shape == b.shape
        sums.append(x.sum())
    got = [float(s) for s in sums]
    assert got == [i * 4096.0 * 4096.0 for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("solver,steps,want", [("euler", None, 5),
                                               ("ddim", 3, 3)])
def test_ddpm_samplers_launch_the_stack_once_a_step(cuda, solver, steps,
                                                   want):
    """The DDPM samplers at a stack-eligible geometry (480 tokens, bf16):
    one stack launch a (sub-)schedule step, finite series."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.vae import LAVAE
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    torch.manual_seed(0)
    dit = DiT(latent_len=30, latent_dim=64, d_model=128, depth=2,
              num_heads=4, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn_like(p))
    vae = LAVAE(1, 16, 1, 16, 64, 30)
    sample = make_cfg_sampler(dit, vae, "ddpm", total_step=5 if steps is
                              None else 20, out_length=96, solver=solver,
                              sample_steps=steps)
    x1 = torch.randn(2, 96, device=cuda)
    emb = torch.randn(2, 128, device=cuda)
    _build.reset_launch_counts()
    out = sample(x1, emb, generator=torch.Generator(cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {tblock.STACK_KERNEL: want}
    assert out.series.shape == (2, 96)
    assert torch.isfinite(out.series).all()
