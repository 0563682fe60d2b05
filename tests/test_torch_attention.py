"""The port's head-split attention held to the JAX package on the CPU: the
twins of ``flash_attention`` (#15), ``vmem_attention`` (#16) and
``packed_attention`` (#17) against the JAX kernels in interpret mode, the
packed refusal, ``attention``'s modes and the gradients of its 'flash' and
'packed' impls against ``jax.grad``, the copied route predicates
(``_auto_block``, ``fused_heads_block_q``) against JAX's, the eager DiT
under every ``attention_impl`` against flax ``DiT.apply`` (C2), and
``flax_path_forward`` at a flash-routed geometry (1056 tokens) against
``jax.grad`` of ``DiT.apply`` with ``attention_impl='flash'`` (C1). The
launchers are rehearsed against the fake library of ``test_torch_split``;
the kernel-vs-twin checks need a card and live in ``test_torch_cuda.py``.

Inputs come from numpy with a seed. Tolerances: one attention call f32
1e-5 * max|ref| (summation order only), bf16 1e-2 * max|ref| (a rounding
flip of the output is one bf16 ulp, 2^-8 relative, and the exact kernels
round p to bf16 after f32 sums in another order); gradients f32 1e-5 *
max|ref|; the DiT f32 2e-4 * max|ref| (sums over layers and tokens)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.ops import attention as jattn
from t2ms_tpu_torch.convert import dit_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import attention as tattn

from test_torch_split import _one_launch, _rehearse


def _qkv(B=2, H=4, N=128, D=32, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, H, N, D)).astype(np.float32)
            for _ in range(3)]


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture
def interpret(monkeypatch):
    """The JAX kernels in interpret mode, as tests/test_attention.py runs
    them on the CPU."""
    for name in ("flash_attention", "vmem_attention", "packed_attention",
                 "fused_heads_attention"):
        orig = getattr(jattn, name)
        monkeypatch.setattr(jattn, name, lambda *a, _f=orig, **kw: _f(
            *a, **kw, interpret=True))


_DT = [("float32", 1e-5), ("bfloat16", 1e-2)]


def _both(arrays, dt):
    j = [jnp.asarray(a).astype(dt) for a in arrays]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dt)) for a in j]
    return j, t


# ------------------------------------------------------- the three twins

@pytest.mark.parametrize("dt,tol", _DT)
@pytest.mark.parametrize("N,blocks", [(256, (None, None)), (256, (128, 64)),
                                      (200, (None, None)),
                                      (100, (None, None))])   # fallback
def test_flash_twin_matches_jax_kernel(dt, tol, N, blocks):
    """``flash_attention`` (its twin on the CPU) against JAX's in
    interpret mode, at the auto blocks and at explicit ones; at N=100 no
    block divides N and both fall back to ``einsum_attention``."""
    (jq, jk, jv), ts = _both(_qkv(N=N), dt)
    bq, bk = blocks
    want = jattn.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                 interpret=True)
    got = tattn.flash_attention(*ts, block_q=bq, block_k=bk)
    assert got.dtype == ts[0].dtype
    _close(got, want, tol)
    if N == 100:
        assert jattn._auto_block(N) == 0
        assert torch.equal(got, tattn.einsum_attention(*ts))


@pytest.mark.parametrize("dt,tol", _DT)
@pytest.mark.parametrize("N,D", [(64, 32), (96, 16)])
def test_vmem_twin_matches_jax_kernel(dt, tol, N, D):
    (jq, jk, jv), ts = _both(_qkv(N=N, D=D, seed=1), dt)
    want = jattn.vmem_attention(jq, jk, jv, interpret=True)
    got = tattn.vmem_attention(*ts)
    assert got.dtype == ts[0].dtype
    _close(got, want, tol)


@pytest.mark.parametrize("dt,tol", _DT)
@pytest.mark.parametrize("shape,pack", [((2, 4, 96, 32), 1),
                                        ((2, 4, 96, 32), 4),
                                        ((2, 4, 96, 32), 8),
                                        ((3, 2, 32, 16), 4)])   # odd: -> 2
def test_packed_twin_matches_jax_kernel(dt, tol, shape, pack):
    """Every pack gives the same function; bh = 6 with pack 4 degrades to
    2 in JAX, and the port takes pack for the signature only."""
    B, H, N, D = shape
    (jq, jk, jv), ts = _both(_qkv(B, H, N, D, seed=7), dt)
    want = jattn.packed_attention(jq, jk, jv, pack=pack, interpret=True)
    got = tattn.packed_attention(*ts, pack=pack)
    assert got.dtype == ts[0].dtype
    _close(got, want, tol)


class _Ran(Exception):
    pass


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [928, 936, 1024, 1032, 1040, 2048])
def test_packed_refuses_where_jax_refuses(monkeypatch, dt, N):
    """The port raises where JAX raises (even pack = 1 exceeds the TPU
    program's VMEM budget) and nowhere else; JAX's kernel is stubbed out
    so that the geometries it takes are not run."""

    def stub(*a, **kw):
        raise _Ran

    monkeypatch.setattr(jattn.pl, "pallas_call", stub)
    jz = jnp.zeros((1, 1, N, 32), dt)
    try:
        jattn.packed_attention(jz, jz, jz)
        raise AssertionError("the stub did not run")
    except _Ran:
        jax_refuses = False
    except ValueError:
        jax_refuses = True
    tz = torch.zeros((1, 1, N, 32), dtype=getattr(torch, dt))
    if jax_refuses:
        with pytest.raises(ValueError, match="exceeds VMEM"):
            tattn.packed_attention(tz, tz, tz)
    else:
        assert tuple(tattn.packed_attention(tz, tz, tz).shape) == tz.shape
    assert jax_refuses == (N >= {"float32": 936, "bfloat16": 1040}[dt])


# ------------------------------------------------- the dispatcher and VJP

def test_attention_modes_on_the_cpu():
    """'einsum' and 'auto' (einsum off the card, as JAX's off the TPU) are
    one function; 'flash' and 'packed' run the twins; an unknown impl is
    'auto', as in JAX."""
    ts = [torch.from_numpy(a) for a in _qkv(N=512, D=16, B=1, H=2)]
    e = tattn.einsum_attention(*ts)
    for impl in ("auto", "einsum", "unknown"):
        assert torch.equal(tattn.attention(*ts, impl=impl), e)
    assert torch.equal(tattn.attention(*ts, impl="flash"),
                       tattn.flash_reference(*ts))
    assert torch.equal(tattn.attention(*ts, impl="packed"),
                       tattn.packed_reference(*ts))


@pytest.mark.parametrize("impl,jfn", [("flash", "_flash_diffable"),
                                      ("packed", "_packed_diffable")])
def test_attention_grads_match_jax(interpret, impl, jfn):
    """The gradients of ``attention(..., 'flash' | 'packed')`` against
    ``jax.grad`` of JAX's custom-VJP wrappers (the einsum recompute) for
    the same cotangent, in f32."""
    q, k, v = _qkv(B=1, H=2, N=64, D=32, seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    jf = getattr(jattn, jfn)
    want = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * g),
                    argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tattn.attention(*ts, impl=impl), ts,
                              torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


# --------------------------------------------------- the route predicates

@pytest.mark.parametrize("hd", [128, 512])
@pytest.mark.parametrize("bpe", [2, 4])
def test_route_predicates_match_jax(hd, bpe):
    """``_auto_block`` and ``fused_heads_block_q`` as copied, and the route
    they give, against JAX's over N = 8 .. 9000 in steps of 8."""
    for n in range(8, 9001, 8):
        assert tattn._auto_block(n) == jattn._auto_block(n), n
        fb = jattn.fused_heads_block_q(n, hd, bpe)
        assert tattn.fused_heads_block_q(n, hd, bpe) == fb, n
        want = ("fused" if fb else "flash"
                if n >= 1024 and jattn._auto_block(n) else "einsum")
        assert tattn.attention_route(n, hd, bpe) == want, n


@pytest.mark.parametrize("n,bpe,want", [(120, 2, "einsum"), (480, 2, "fused"),
                                        (1056, 2, "flash"),
                                        (4096, 2, "fused"),
                                        (8192, 2, "flash"),
                                        (4096, 4, "fused"),
                                        (8192, 4, "flash")])
def test_route_at_the_configured_token_counts(n, bpe, want):
    assert tattn.attention_route(n, 128, bpe) == want


@pytest.mark.parametrize("n,d,want", [
    (1, 16, "resident"), (1152, 16, "resident"), (1153, 16, "stream"),
    (1, 32, "resident"), (480, 32, "resident"), (704, 32, "resident"),
    (705, 32, "stream"), (1000, 32, "stream"), (8192, 32, "stream"),
    (200, 64, "resident"), (384, 64, "resident"), (385, 64, "stream"),
    (480, 64, "stream"), (130, 128, "resident"), (192, 128, "resident"),
    (193, 128, "stream"), (480, 128, "stream")])
def test_split_heads_route_keeps_k_and_v_resident_where_they_fit(n, d,
                                                                 want):
    """The head-split kernels' route (csrc/split_heads.cu): the exact
    softmax (#16, #17) in bf16 holds the head's whole K and V in shared
    memory where 2 * ceil(N / 64) * 64 * (d + 8) bf16 values fit half an
    H100 SM's 228 KB less 1 KB (two blocks an SM), else streams them; the
    online softmax (#15) and f32 always stream."""
    assert tattn.split_heads_route(n, d, torch.bfloat16, True) == want
    assert tattn.split_heads_route(n, d, torch.bfloat16, False) == "stream"
    assert tattn.split_heads_route(n, d, torch.float32, True) == "stream"


# ------------------------------------------------------- the eager DiT (C2)

def _perturbed(params, seed, scale=0.02):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        p + scale * jax.random.normal(k, p.shape)
        for p, k in zip(leaves, keys)])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("impl", ["auto", "einsum", "flash", "packed",
                                  "fused"])
def test_eager_dit_follows_jax_for_every_impl(interpret, impl):
    """The eager DiT with ``attention_impl`` = ``impl`` against flax
    ``DiT.apply`` with the same impl (its kernels in interpret mode; 'auto'
    is einsum off the TPU and off the card), in f32, at 64 tokens, d_model
    32 and 2 heads of 16."""
    kw = dict(latent_len=16, latent_dim=16, d_model=32, depth=2,
              num_heads=2, mlp_ratio=2.0, attention_impl=impl)
    jd = JDiT(**kw)
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 16, 16)).astype(np.float32)
    t = np.array([0.25, 0.75], np.float32)
    emb = r.standard_normal((2, 32)).astype(np.float32)
    mask = np.array([0.0, 1.0], np.float32)
    jp = _perturbed(jd.init(jax.random.key(2), x, t, emb), 3, 0.05)
    want = np.asarray(jd.apply(jp, x, t, emb, mask))
    td = DiT(**kw, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    _build.reset_launch_counts()
    with torch.no_grad():
        got = td(*map(torch.from_numpy, (x, t, emb, mask)))
    assert not _build.launch_counts
    _close(got, want, 2e-4)


# ------------------------------------- the flax path at a flash route (C1)

def test_flax_path_at_1056_tokens_matches_jax_flash(interpret):
    """``flax_path_forward`` at 1056 tokens (latent 66 x 64, d_model 128,
    4 heads of 32; depth 1, B = 1 for CPU time), where JAX's route on a
    TPU is flash: its loss and gradients (the LayerNorm twins, the flash
    twin and the einsum-recompute backward) against ``jax.grad`` of flax
    ``DiT.apply`` with ``attention_impl='flash'`` (eager LayerNorms: the
    same function in f32)."""
    kw = dict(latent_len=66, latent_dim=64, d_model=128, depth=1,
              num_heads=4, mlp_ratio=2.0)
    r = np.random.default_rng(9)
    x = r.standard_normal((1, 64, 66)).astype(np.float32)
    t = np.array([0.4], np.float32)
    emb = r.standard_normal((1, 128)).astype(np.float32)
    mask = np.array([1.0], np.float32)
    tgt = r.standard_normal(x.shape).astype(np.float32)
    jd = JDiT(**kw, attention_impl="flash")
    jp = _perturbed(jd.init(jax.random.key(2), x, t, emb), 5)
    (lw, ow), gw = jax.value_and_grad(lambda p: (lambda o: (jnp.mean(
        jnp.square(o - tgt)), o))(jd.apply(p, x, t, emb, mask)),
        has_aux=True)(jp)

    td = DiT(**kw, device="cpu")
    assert td.num_patches == 1056
    assert dit_fast.flax_attention_route(td) == "flash"
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    _build.reset_launch_counts()
    out = dit_fast.flax_path_forward(td, *map(torch.from_numpy,
                                              (x, t, emb, mask)))
    loss = torch.mean(torch.square(out - torch.from_numpy(tgt)))
    loss.backward()
    assert not _build.launch_counts
    _close(out, ow, 2e-4)
    np.testing.assert_allclose(loss.item(), float(lw), rtol=1e-5)
    want = dit_params_from_jax(_np_tree(gw))
    for name, p in td.named_parameters():
        _close(p.grad, want[name].numpy(), 2e-4)


# ---------------------------------------------------------- the launchers

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,exact,name", [
    ("flash_attention", 0, tattn.FLASH_KERNEL),
    ("vmem_attention", 1, tattn.VMEM_KERNEL),
    ("packed_attention", 1, tattn.PACKED_KERNEL)])
def test_split_heads_launchers_pass_their_declared_arguments(
        monkeypatch, fn, exact, name, dt):
    """#15, #16 and #17 on the head-split views of one qkv tensor that
    report CUDA, against the fake library: one entry with the shape, the
    strides of q, k, v and o (read in place: the batch stride of the qkv
    row block, the head stride D), the mode flag, the route flag (resident
    for the exact softmax in bf16 at 16 tokens), the f32 scale and the
    stream, counted under the kernel's own name; the output is a view of
    the merged (B, N, H*D) layout."""
    lib = _rehearse(monkeypatch)
    B, N, H, D = 2, 16, 4, 32
    qkv = torch.randn(B, N, 3 * H * D).to(dt)
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    o = getattr(tattn, fn)(q, k, v)
    call = _one_launch(lib, "split_heads_forward", dt)
    assert dict(_build.launch_counts) == {name: 1}
    _, _, _, _, b, h, n, d, *strides, flag, resident, scale, stream = call
    assert (b, h, n, d) == (B, H, N, D)
    assert strides[:9] == [N * 3 * H * D, D, 3 * H * D] * 3
    assert strides[9:] == list(o.stride()[:3]) == [N * H * D, D, H * D]
    assert flag == exact and stream.value == 7
    assert resident == (exact and dt == torch.bfloat16)   # split_heads_route
    assert scale.value == pytest.approx(D ** -0.5)
    assert o.transpose(1, 2).is_contiguous()
