"""The port's lse attention family held to the JAX package on the CPU: the
twins of ``fused_heads_attention_with_stats`` (#10),
``fused_heads_attention_bwd_lean`` (#13) and
``fused_heads_attention_bwd_lean_two_pass`` (#14) against the JAX kernels
in interpret mode; the lean route's predicates and switch against JAX's;
``fused_heads_diffable`` and ``flax_path_forward`` with
``T2MS_ATTN_LEAN_BWD=1`` against ``jax.grad`` with the switch on; the
launchers, and ``fused_dit_stack``'s ``batch_block`` and ``folded``
variants, against a fake library (their parity with the JAX kernel is in
``test_torch_ops.py``). The kernel-vs-twin checks need a card and live in
``test_torch_cuda.py``.

Tolerances: f32 rtol 1e-5 / atol 1e-5 * max|ref| for the forward's output
(summation order only), 1e-4 for the backward (sums over N rows); lse
absolute, f32 1e-5 (it is about 10 here, so a few f32 ulps) and bf16 1e-2
(a rounding flip of one e, one bf16 ulp of at most 1, moves lse by 2^-8 / r
with r >= 1); bf16 outputs 1e-2 * max|ref| for the forward (a rounding flip
is one bf16 ulp, 2^-8 relative) and 3e-2 for the backward (flips of p and
ds feed sums over N rows), as the other attention twins; whole-model f32
gradients rtol 2e-3 / atol 2e-4 and losses rtol 1e-4 (the JAX block-VJP
test's bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.ops import attention as jattn
from t2ms_tpu_torch.convert import dit_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import attention as tattn
from t2ms_tpu_torch.ops import dit_block as tblock

from test_torch_split import _one_launch, _rehearse

LEAN = "T2MS_ATTN_LEAN_BWD"


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *s: r.standard_normal(s).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _close(got, want, dt, rtol32=1e-5, tol16=1e-2, err_msg=""):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all(), err_msg
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol32,
                                   atol=rtol32 * np.abs(want).max(),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol16 * np.abs(want).max(),
                                   err_msg=err_msg)


def _inputs(B, N, HD, dt, seed=0):
    """q, k, v as the column slices of one (B, N, 3*HD) projection on both
    sides, and an upstream gradient g."""
    f = _rng(seed)
    qkv = np.concatenate([1.5 * f(B, N, HD), 1.5 * f(B, N, HD),
                          f(B, N, HD)], axis=-1)
    g = f(B, N, HD)
    t = torch.from_numpy(qkv).to(getattr(torch, dt))
    j = jnp.asarray(qkv, jnp.dtype(dt))
    cut = lambda a: (a[..., :HD], a[..., HD:2 * HD], a[..., 2 * HD:])
    return ((*cut(t), torch.from_numpy(g).to(t.dtype)),
            (*cut(j), jnp.asarray(g, jnp.dtype(dt))))


def _jax_stats(jq, jk, jv, H):
    jo, jl = jattn.fused_heads_attention_with_stats(jq, jk, jv, H,
                                                    interpret=True)
    return jo, jl, torch.from_numpy(_np(jo)).to(
        getattr(torch, str(jo.dtype))), torch.from_numpy(_np(jl))


# ------------------------------------------------------------ the twins

@pytest.mark.parametrize("dt,N,HD,H", [
    pytest.param("float32", 128, 128, 4, id="float32"),
    pytest.param("bfloat16", 128, 128, 4, id="bfloat16"),
    ("float32", 130, 256, 2), ("bfloat16", 130, 256, 2)] + [
    (dt, n, 64, h) for dt in ("float32", "bfloat16")
    for n in (1, 127, 128, 129, 480) for h in (4, 2)])
def test_stats_twin_matches_jax_kernel(dt, N, HD, H):
    """#10's twin against ``fused_heads_attention_with_stats`` in interpret
    mode at (2, 128, 128), 4 heads of 32, at (2, 130, 256), 2 heads of 128
    over three K tiles with a ragged end, and at the bf16 kernel's tile
    edges (N from 1 to 480 across its 64-key tiles and 128-row blocks) at
    head widths 16 and 32: o as #9's, lse absolute; no launch on the CPU,
    and o equal to ``fused_heads_attention``'s bit for bit."""
    (q, k, v, _), (jq, jk, jv, _) = _inputs(2, N, HD, dt)
    jo, jl = jattn.fused_heads_attention_with_stats(jq, jk, jv, H,
                                                    interpret=True)
    _build.reset_launch_counts()
    o, lse = tattn.fused_heads_attention_with_stats(q, k, v, H)
    assert not _build.launch_counts
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, N, H)
    _close(o, jo, dt, err_msg="o")
    np.testing.assert_allclose(_np(lse), _np(jl), rtol=0,
                               atol=1e-5 if dt == "float32" else 1e-2)
    assert torch.equal(o, tattn.fused_heads_attention(q, k, v, H))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,block_q", [(1, 128), (2, 64), (4, 32)])
def test_lean_twin_matches_jax_lean_kernel(dt, groups, block_q):
    """#13's twin against ``fused_heads_attention_bwd_lean`` in interpret
    mode with explicit head groups and q blocks, both fed JAX's o and
    lse; ``groups`` and ``block_q`` do not change the port's result."""
    (q, k, v, g), (jq, jk, jv, jg) = _inputs(2, 128, 128, dt, seed=1)
    jo, jl, o, lse = _jax_stats(jq, jk, jv, 4)
    want = jattn.fused_heads_attention_bwd_lean(
        jq, jk, jv, jg, jo, jl, 4, groups=groups, block_q=block_q,
        interpret=True)
    got = tattn.fused_heads_attention_bwd_lean(q, k, v, g, o, lse, 4,
                                               groups=groups,
                                               block_q=block_q)
    plain = tattn.fused_heads_attention_bwd_lean(q, k, v, g, o, lse, 4)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, plain):
        assert a.dtype == q.dtype and a.shape == q.shape, name
        _close(a, b, dt, rtol32=1e-4, tol16=3e-2, err_msg=name)
        assert torch.equal(a, c), name


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_lean_twin_matches_jax_two_pass_kernel(dt):
    """#14's twin against ``fused_heads_attention_bwd_lean_two_pass`` in
    interpret mode at N=256, H*D=64 (2 heads of 32), where JAX's predicate
    gives the blocks and the lean single pass does not fit, so the lean
    route is the two-pass one."""
    bpe = 4 if dt == "float32" else 2
    blocks = jattn._bwd_lean_two_pass_blocks(256, 64, bpe)
    assert blocks is not None
    assert tattn.fused_heads_lean_route(256, 64, 2, bpe) == "lean_two_pass"
    (q, k, v, g), (jq, jk, jv, jg) = _inputs(2, 256, 64, dt, seed=2)
    jo, jl, o, lse = _jax_stats(jq, jk, jv, 2)
    want = jattn.fused_heads_attention_bwd_lean_two_pass(
        jq, jk, jv, jg, jo, jl, 2, blocks=blocks, interpret=True)
    _build.reset_launch_counts()
    got = tattn.fused_heads_attention_bwd_lean_two_pass(q, k, v, g, o, lse,
                                                        2, blocks=blocks)
    assert not _build.launch_counts
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, dt, rtol32=1e-4, tol16=3e-2, err_msg=name)


def test_lean_twin_is_the_recompute_twin_up_to_rounding():
    """In f32 the lean recipe (p from the saved lse, delta from the saved
    o) and the recompute recipe (p and delta rebuilt from the scores) are
    the same function."""
    (q, k, v, g), _ = _inputs(1, 128, 128, "float32", seed=3)
    o, lse = tattn.fused_heads_stats_reference(q, k, v, 4)
    got = tattn.fused_heads_bwd_lean_reference(q, k, v, g, o, lse, 4)
    want = tattn.fused_heads_bwd_two_pass_reference(q, k, v, g, 4)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b.numpy(), "float32", rtol32=1e-4, err_msg=name)


@pytest.mark.parametrize("call,match", [
    (lambda a: tattn.fused_heads_attention_bwd_lean(*a, 4, groups=2),
     "both groups and block_q"),
    (lambda a: tattn.fused_heads_attention_bwd_lean(*a, 4, block_q=64),
     "both groups and block_q"),
    (lambda a: tattn.fused_heads_attention_bwd_lean(*a, 4, groups=3,
                                                    block_q=64),
     "groups 3 incompatible"),
    (lambda a: tattn.fused_heads_attention_bwd_lean(*a, 4, groups=2,
                                                    block_q=48),
     "block_q 48 must divide"),
    (lambda a: tattn.fused_heads_attention_bwd_lean_two_pass(
        *a, 4, blocks=(64, 48, 128)), "must divide N"),
    (lambda a: tattn.fused_heads_attention_with_stats(*a[:3], 4,
                                                      block_q=96),
     "block_q 96 must divide"),
    (lambda a: tattn.fused_heads_attention_bwd_lean(*a[:5], a[5][..., :2],
                                                    4), "lse"),
])
def test_lse_family_refuses_what_jax_refuses(call, match):
    """JAX's argument refusals (not its VMEM ones), on the CPU too."""
    (q, k, v, g), _ = _inputs(1, 128, 128, "float32", seed=4)
    o, lse = tattn.fused_heads_stats_reference(q, k, v, 4)
    with pytest.raises(ValueError, match=match):
        call((q, k, v, g, o, lse))


# ------------------------------------------------- switch and predicates

@pytest.mark.parametrize("flag", ["0", "1", "", "yes", None])
def test_lean_switch_matches_jax(monkeypatch, flag):
    if flag is None:
        monkeypatch.delenv(LEAN, raising=False)
    else:
        monkeypatch.setenv(LEAN, flag)
    assert tattn._lean_bwd_enabled() == jattn._lean_bwd_enabled()
    assert tattn._lean_bwd_enabled() == (flag == "1")


@pytest.mark.parametrize("n", [128, 256, 480, 1024, 2048, 4096, 8192])
def test_lean_predicates_match_jax(n):
    """The copied predicates equal JAX's over H*D 64..512, 2..8 heads, bf16
    and f32, and the route is the branch JAX's custom VJP takes on a TPU
    with the switch on: None where its forward saves no lse."""
    for hd in (64, 128, 256, 512):
        for heads in (2, 4, 8):
            for bpe in (2, 4):
                lg = jattn._bwd_lean_groups(n, hd, heads, bpe)
                tp = jattn._bwd_lean_two_pass_blocks(n, hd, bpe)
                assert tattn._bwd_lean_groups(n, hd, heads, bpe) == lg
                assert tattn._bwd_lean_two_pass_blocks(n, hd, bpe) == tp
                saved = (lg or tp) and jattn.fused_heads_block_q(n, hd, bpe)
                want = (None if not saved else "lean" if lg
                        else "lean_two_pass")
                assert tattn.fused_heads_lean_route(n, hd, heads,
                                                    bpe) == want


def test_lean_route_at_the_main_paths():
    assert tattn._bwd_lean_groups(1024, 512, 8, 2) == (4, 512)
    assert tattn._bwd_lean_two_pass_blocks(4096, 128, 2) == (64, 256, 512)
    assert tattn._bwd_lean_groups(4096, 128, 4, 2) is None
    assert tattn.fused_heads_lean_route(1024, 512, 8) == "lean"   # scaled
    assert tattn.fused_heads_lean_route(4096, 128, 4) == "lean_two_pass"
    assert tattn.fused_heads_lean_route(8192, 128, 4) is None     # flash


# ------------------------------------------------ fused_heads_diffable

def _spies(monkeypatch):
    """Wrap the entry points ``_FusedHeads`` calls; returns the names
    called, in order."""
    calls = []
    for name in ("fused_heads_attention", "fused_heads_attention_with_stats",
                 "fused_heads_attention_bwd",
                 "fused_heads_attention_bwd_two_pass",
                 "fused_heads_attention_bwd_lean",
                 "fused_heads_attention_bwd_lean_two_pass"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=fn, **kw:
                            calls.append(_n) or _f(*a, **kw))
    return calls


def _jax_grads(jq, jk, jv, w, H):
    def loss(q, k, v):
        o = jattn.fused_heads_diffable(q, k, v, H)
        return jnp.sum(o.astype(jnp.float32) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,HD,H,route", [
    (2, 128, 128, 4, "lean"),
    (1, 256, 64, 2, "lean_two_pass"),
])
def test_diffable_lean_grads_match_jax(monkeypatch, dt, B, N, HD, H, route):
    """``fused_heads_diffable`` with the switch on against ``jax.grad`` of
    JAX's with the switch on (its stats forward and lean backward in
    interpret mode), at one geometry where the port's route is #13 and one
    where it is #14; spies show the stats forward and that lean kernel
    ran, and nothing else."""
    monkeypatch.setenv(LEAN, "1")
    bpe = 4 if dt == "float32" else 2
    assert tattn.fused_heads_lean_route(N, HD, H, bpe) == route
    (q, k, v, _), (jq, jk, jv, _) = _inputs(B, N, HD, dt, seed=5)
    w = _rng(6)(B, N, HD)
    want = _jax_grads(jq, jk, jv, jnp.asarray(w), H)
    calls = _spies(monkeypatch)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    o = tattn.fused_heads_diffable(*ts, H)
    (o.float() * torch.from_numpy(w)).sum().backward()
    assert calls == ["fused_heads_attention_with_stats",
                     f"fused_heads_attention_bwd_{route}"]
    for name, t, b in zip(("dq", "dk", "dv"), ts, want):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad, b, dt, rtol32=1e-4, tol16=3e-2, err_msg=name)


@pytest.mark.parametrize("flag", ["0", None])
@pytest.mark.parametrize("N,HD,H,bwd", [
    (128, 128, 4, "fused_heads_attention_bwd"),
    (4096, 128, 4, "fused_heads_attention_bwd_two_pass"),
])
def test_switch_off_keeps_the_route(monkeypatch, flag, N, HD, H, bwd):
    """With the switch off or unset, the forward is #9 and the backward
    what ``fused_heads_bwd_route`` names (the kernels stubbed, so no
    N x N work runs)."""
    if flag is None:
        monkeypatch.delenv(LEAN, raising=False)
    else:
        monkeypatch.setenv(LEAN, flag)
    calls = []
    zeros = lambda q, *a, **kw: (torch.zeros_like(q),) * 3
    for name in ("fused_heads_attention_bwd",
                 "fused_heads_attention_bwd_two_pass",
                 "fused_heads_attention_bwd_lean",
                 "fused_heads_attention_bwd_lean_two_pass"):
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, **kw:
                            calls.append(_n) or zeros(*a))
    for name in ("fused_heads_attention",
                 "fused_heads_attention_with_stats"):
        monkeypatch.setattr(tattn, name, lambda q, *a, _n=name, **kw:
                            calls.append(_n) or torch.zeros_like(q))
    q, k, v = (torch.zeros(1, N, HD, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    tattn.fused_heads_diffable(q, k, v, H).float().sum().backward()
    assert calls == ["fused_heads_attention", bwd]


def test_backward_reads_what_the_forward_saved(monkeypatch):
    """The backward follows the forward's choice, not the environment at
    backward time."""
    monkeypatch.setenv(LEAN, "1")
    calls = _spies(monkeypatch)
    (q, k, v, _), _ = _inputs(1, 128, 128, "float32", seed=7)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    o = tattn.fused_heads_diffable(*ts, 4)
    monkeypatch.setenv(LEAN, "0")
    o.sum().backward()
    assert calls == ["fused_heads_attention_with_stats",
                     "fused_heads_attention_bwd_lean"]


# ---------------------------------------------------------- flax path

def _perturbed(params, seed, scale=0.02):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        p + scale * jax.random.normal(k, p.shape)
        for p, k in zip(leaves, keys)])


def test_flax_path_forward_lean_matches_jax(monkeypatch):
    """``flax_path_forward`` (its twins on the CPU) with the switch on
    against ``jax.grad`` of flax ``DiT.apply`` with fused-heads attention,
    the LayerNorm and residual fusion kernels and the switch on (interpret
    mode): d_model 128, 4 heads of 32, depth 2, mlp x2, 128 tokens, where
    the lean predicates admit the single-pass lean kernel. Each layer runs
    the stats forward and the lean backward once."""
    for flag in ("T2MS_FUSED_MOD_LN", "T2MS_FUSED_RES_LN", LEAN):
        monkeypatch.setenv(flag, "1")
    kw = dict(latent_len=8, latent_dim=64, d_model=128, depth=2,
              num_heads=4, mlp_ratio=2.0)
    jd = JDiT(**kw, attention_impl="fused")
    x = jax.random.normal(jax.random.key(0), (2, 64, 8))
    t = jnp.array([0.25, 0.75])
    emb = jax.random.normal(jax.random.key(1), (2, 128))
    mask = jnp.array([0.0, 1.0])
    # init through the einsum impl (the same parameters): outside jax.grad
    # the fused forward is not an interpret-mode call
    jp = _perturbed(JDiT(**kw).init(jax.random.key(2), x, t, emb), 3)
    tgt = jax.random.normal(jax.random.key(6), x.shape)
    lw, gw = jax.value_and_grad(lambda p: jnp.mean(jnp.square(
        jd.apply(p, x, t, emb, mask) - tgt)))(jp)

    td = DiT(**kw, device="cpu")
    assert td.num_patches == 128
    assert dit_fast.flax_attention_route(td) == "fused"
    assert tattn.fused_heads_lean_route(128, 128, 4, 4) == "lean"
    assert "#13 fused_heads_attention_bwd_lean" in \
        dit_fast.flax_path_kernels(td, train=True)
    td.load_state_dict(dit_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    T = lambda a: torch.from_numpy(np.array(a))
    calls = _spies(monkeypatch)
    loss = torch.mean(torch.square(
        dit_fast.flax_path_forward(td, T(x), T(t), T(emb), T(mask)) - T(tgt)))
    loss.backward()
    assert calls == (["fused_heads_attention_with_stats"] * 2
                     + ["fused_heads_attention_bwd_lean"] * 2)
    np.testing.assert_allclose(loss.item(), float(lw), rtol=1e-4)
    want = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, gw))
    for name, p in td.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


def test_flax_path_kernels_name_the_lean_route(monkeypatch):
    """The refusal text names #10 with #13 or #14 for training with the
    switch on, and #9 with #11/#12 without it or for serving."""
    scaled = DiT(latent_len=64, latent_dim=64, d_model=512, depth=1,
                 num_heads=8, compute_dtype=torch.bfloat16, device="cpu")
    long_ = DiT(latent_len=256, latent_dim=64, d_model=128, depth=1,
                num_heads=4, compute_dtype=torch.bfloat16, device="cpu")
    monkeypatch.setenv(LEAN, "1")
    assert "#13" in dit_fast.flax_path_kernels(scaled, train=True)
    assert "#14" in dit_fast.flax_path_kernels(long_, train=True)
    assert "#10" not in dit_fast.flax_path_kernels(long_)
    monkeypatch.setenv(LEAN, "0")
    assert "#9 fused_heads_attention with #11/#12" in \
        dit_fast.flax_path_kernels(scaled, train=True)


def test_eager_fused_dit_takes_the_lean_route(monkeypatch):
    """The eager DiT with ``attention_impl='fused'`` reaches the switch
    through ``fused_heads_diffable`` too."""
    monkeypatch.setenv(LEAN, "1")
    td = DiT(latent_len=8, latent_dim=64, d_model=128, depth=1, num_heads=4,
             attention_impl="fused", device="cpu")
    calls = _spies(monkeypatch)
    x = torch.from_numpy(_rng(8)(2, 64, 8))
    td(x, torch.tensor([0.2, 0.7]),
       torch.from_numpy(_rng(9)(2, 128))).square().mean().backward()
    assert calls == ["fused_heads_attention_with_stats",
                     "fused_heads_attention_bwd_lean"]


# ------------------------------------------- launchers, fake library

def _slices(dt, B=2, N=8, HD=64):
    qkv = torch.randn(B, N, 3 * HD).to(dt)
    return qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_stats_launcher_passes_its_declared_arguments(monkeypatch, dt):
    """#10 on a tensor that reports CUDA, against the fake library: one
    stats-forward entry with q, k, v read in place through their strides,
    o and a (B, N, H) f32 lse, the scale cast to q's dtype, counted under
    the JAX name."""
    lib = _rehearse(monkeypatch)
    q, k, v = _slices(dt)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    o, lse = tattn.fused_heads_attention_with_stats(q, k, v, 2)
    call = _one_launch(lib, "fused_heads_forward_stats", dt)
    assert dict(_build.launch_counts) == {tattn.FUSED_HEADS_STATS_KERNEL: 1}
    ptrs, (B, N, HD, H), strides = call[:5], call[5:9], call[9:15]
    assert [p.value for p in ptrs] == [t.data_ptr()
                                      for t in (q, k, v, o, lse)]
    assert (B, N, HD, H) == (2, 8, 64, 2)
    assert strides == (8 * 192, 192) * 3
    assert call[15].value == float(torch.tensor(32 ** -0.5, dtype=dt))
    assert call[16].value == 7
    assert o.dtype == dt and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 8, 2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,name", [
    ("fused_heads_attention_bwd_lean", tattn.FUSED_HEADS_LEAN_KERNEL),
    ("fused_heads_attention_bwd_lean_two_pass",
     tattn.FUSED_HEADS_LEAN_TWO_PASS_KERNEL)])
def test_lean_launchers_pass_their_declared_arguments(monkeypatch, fn, name,
                                                      dt):
    """#13 and #14 on a tensor that reports CUDA, against the fake
    library: one lean entry with q, k, v (in place), a non-contiguous g,
    lse and delta as contiguous (B, N, H) f32 and dq, dk, dv; no stats
    workspace; the f32 and the cast scale and the stream last; counted
    under the kernel's own name."""
    lib = _rehearse(monkeypatch)
    q, k, v = _slices(dt)
    g = torch.randn(2, 64, 8).to(dt).transpose(1, 2)
    o = torch.randn(2, 8, 64).to(dt)
    lse = torch.randn(2, 8, 2)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    grads = getattr(tattn, fn)(q, k, v, g, o, lse, 2)
    call = _one_launch(lib, "fused_heads_backward_lean", dt)
    assert not any(c[0] == "fused_heads_backward_workspace"
                   for c in lib.calls)
    assert dict(_build.launch_counts) == {name: 1}
    assert [p.value for p in call[:3]] == [t.data_ptr() for t in (q, k, v)]
    assert call[9:13] == (2, 8, 64, 2)
    assert call[13:19] == (8 * 192, 192) * 3
    assert call[19:21] == (8 * 64, 64)            # g, made contiguous
    assert call[21].value == pytest.approx(32 ** -0.5)
    assert call[22].value == float(torch.tensor(32 ** -0.5, dtype=dt))
    assert call[23].value == 7
    assert [t.dtype for t in grads] == [dt] * 3


# ------------------------------------ fused_dit_stack's variants (B3)

def _stack_inputs(B=4, N=16, D=64, hidden=128, L=2, seed=0):
    f = _rng(seed)
    x, mod = f(B, N, D), 0.3 * f(B, L, 6, D)
    ws = [0.2 * f(L, D, 3 * D), 0.1 * f(L, 3 * D), 0.2 * f(L, D, D),
          0.1 * f(L, D), 0.2 * f(L, D, hidden), 0.1 * f(L, hidden),
          0.2 * f(L, hidden, D), 0.1 * f(L, D)]
    return x, mod, ws


@pytest.mark.parametrize("kw", [dict(batch_block=2),
                                dict(attn_impl="folded"),
                                dict(batch_block=2, attn_impl="folded")])
def test_stack_variants_launch_as_the_plain_call(monkeypatch, kw):
    """On a tensor that reports CUDA, each variant makes the plain call's
    one launch, with the same arguments, counted as ``fused_dit_stack``."""
    lib = _rehearse(monkeypatch)
    x, mod, ws = _stack_inputs()
    args = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mod),
            *map(torch.from_numpy, ws)]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    tblock.fused_dit_stack(*args, num_heads=4)
    plain = _one_launch(lib, "dit_stack_forward", torch.bfloat16)
    lib.calls.clear()
    _build.reset_launch_counts()
    tblock.fused_dit_stack(*args, num_heads=4, **kw)
    got = _one_launch(lib, "dit_stack_forward", torch.bfloat16)
    assert dict(_build.launch_counts) == {tblock.STACK_KERNEL: 1}
    assert len(got) == len(plain) and got[13:19] == plain[13:19]
    assert [a.value for a in got[19:]] == [a.value for a in plain[19:]]
