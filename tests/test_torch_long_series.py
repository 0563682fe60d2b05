"""The port's long-series path and the residual + LayerNorm fusion held to
the JAX package on the CPU: the ``res_mod_ln_diffable`` twin (#7, #8)
against the JAX kernels in interpret mode and their ``jax.grad``; the
recompute-recipe twin of ``fused_heads_attention_bwd_two_pass`` (#12) and
of the ungrouped single-pass ``fused_heads_attention_bwd`` against the JAX
kernels in interpret mode; the attention backward's route against the JAX
predicates; the token-range gates against a fake library that takes every
shape; ``flax_path_forward`` (res-LN on) against ``jax.grad`` of flax
``DiT.apply`` at a long-series-shaped DiT; the weight bridge and the LA-VAE
at latent 256; the samplers' third route; and the new launchers against a
fake library. The kernel-vs-twin checks need a card and live in
``test_torch_cuda.py``.

Tolerances: f32 rtol 1e-5 / atol 1e-5 * max|ref| for one op (summation
order only), 1e-4 for the attention backward (sums over N rows); bf16
1e-2 * max|ref| for one op (a rounding flip is one bf16 ulp, 2^-8
relative, after f32 sums in another order), 3e-2 for the two-pass
backward and for dgm3 against the JAX backward at several q-blocks (the
JAX kernel rounds each block's partial to bf16 before the f32 sum, the
port rounds the total once: a deliberate difference); whole-model f32
gradients rtol 2e-3 / atol 2e-4 and losses rtol 1e-4 (the JAX block-VJP
test's bounds); the sampler rtol 2e-4 / atol 2e-5 (the JAX serving tests'
bound)."""

import ctypes

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.ops import attention as jattn
from t2ms_tpu.ops import dit_block as jblock
from t2ms_tpu.sampling import make_cfg_sampler as j_make_cfg_sampler
from t2ms_tpu_torch.convert import dit_params_from_jax, lavae_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
from t2ms_tpu_torch.models.denoisers import dit as tdit
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import attention as tattn
from t2ms_tpu_torch.ops import dit_block as tblock
from t2ms_tpu_torch.sampling import make_cfg_sampler

from test_torch_split import (_check_ln_launch, _modulation, _one_launch,
                              _rehearse)


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
                                   atol=rtol32 * np.abs(want).max(),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol16 * np.abs(want).max(),
                                   err_msg=err_msg)


# ------------------------------------------------- res_mod_ln (#7, #8)

def _res_inputs(B, N, D, seed=0):
    f = _rng(seed)
    return f(B, N, D), f(B, N, D), 0.3 * f(B, 3, D), f(B, N, D), f(B, N, D)


def _res_jax(x, h, gm3, w_out, w_y, dt, block_q=0):
    """out, y and the grads of sum(out * w_out) + sum(y * w_y) through the
    JAX kernels in interpret mode."""
    jdt = jnp.dtype(dt)

    def loss(a, b, m):
        out, y = jblock.res_mod_ln_diffable(a, b, m, 1e-6, block_q, True)
        return (jnp.sum(out.astype(jnp.float32) * w_out)
                + jnp.sum(y.astype(jnp.float32) * w_y)), (out, y)

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (x, h, gm3)))
    return outs, grads


def _res_torch(x, h, gm3, w_out, w_y, dt):
    ts = [torch.from_numpy(a).to(getattr(torch, dt)).requires_grad_()
          for a in (x, h, gm3)]
    out, y = tblock.res_mod_ln_diffable(*ts)
    loss = ((out.float() * torch.from_numpy(w_out)).sum()
            + (y.float() * torch.from_numpy(w_y)).sum())
    return (out, y), torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,D", [(3, 16, 24), (2, 16, 128)])
def test_res_mod_ln_twin_matches_jax_kernel(dt, B, N, D):
    """Forward (out, y) and the three gradients (dx in x's dtype, dh in
    h's, dgm3 in gm3's) with both outputs' cotangents, against the JAX
    kernels at one q-block, the JAX default at these shapes. In bf16 the
    JAX kernel's dgate is the transpose of a bf16 broadcast, a row sum
    that XLA accumulates at bf16 width; the port sums in f32 and rounds
    once (ROADMAP section C). So bf16 dgm3 is held to 3e-2 * max|ref| and
    to rounding no worse than JAX's against the f32 kernel."""
    x, h, gm3, w_out, w_y = _res_inputs(B, N, D)
    jouts, jgrads = _res_jax(x, h, gm3, w_out, w_y, dt)
    _build.reset_launch_counts()
    touts, tgrads = _res_torch(x, h, gm3, w_out, w_y, dt)
    assert not _build.launch_counts                 # CPU: the twins only
    tdt = getattr(torch, dt)
    assert [t.dtype for t in (*touts, *tgrads)] == [tdt] * 5
    for name, g, want in zip(("out", "y", "dx", "dh"), (*touts, *tgrads),
                             (*jouts, *jgrads)):
        _close(g, want, dt, err_msg=name)
    _close(tgrads[2], jgrads[2], dt, tol16=3e-2, err_msg="dgm3")
    if dt == "bfloat16":
        truth = np.asarray(_res_jax(x, h, gm3, w_out, w_y, "float32")[1][2])
        port = np.abs(tgrads[2].float().numpy() - truth).mean()
        jax_ = np.abs(np.asarray(jgrads[2], np.float32) - truth).mean()
        assert port <= jax_


def test_res_mod_ln_dgm3_rounds_once_against_the_blocked_jax_kernel():
    """At N=64 with block_q=16 the JAX backward rounds four per-block
    dgate/dshift/dscale partials to bf16 before summing them in f32; the
    port rounds the f32 total once. The two agree within a few bf16
    roundings (ROADMAP section C), and in f32 within summation order."""
    x, h, gm3, w_out, w_y = _res_inputs(2, 64, 128, seed=1)
    for dt, tol in (("bfloat16", 3e-2), ("float32", 1e-5)):
        _, jgrads = _res_jax(x, h, gm3, w_out, w_y, dt, block_q=16)
        _, tgrads = _res_torch(x, h, gm3, w_out, w_y, dt)
        want = np.asarray(jgrads[2], np.float32)
        np.testing.assert_allclose(tgrads[2].float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_res_mod_ln_refuses_mismatched_operands():
    x = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="gm3"):
        tblock.res_mod_ln_diffable(x, x, torch.zeros(2, 2, 32))
    with pytest.raises(ValueError, match="gm3"):
        tblock.res_mod_ln_diffable(x, x[:, :4], torch.zeros(2, 3, 32))


# ----------------------------------- the recompute recipe (#12, #11)

def _qkv_slices(B, N, HD, dt, seed=0):
    """q, k, v as the column slices of one (B, N, 3*HD) projection."""
    f = _rng(seed)
    qkv = np.concatenate([1.5 * f(B, N, HD), 1.5 * f(B, N, HD),
                          f(B, N, HD)], axis=-1)
    t = torch.from_numpy(qkv).to(getattr(torch, dt))
    j = jnp.asarray(qkv, jnp.dtype(dt))
    cut = lambda a: (a[..., :HD], a[..., HD:2 * HD], a[..., 2 * HD:])
    return cut(t), cut(j)


@pytest.mark.parametrize("dt,tol16", [("float32", None),
                                      ("bfloat16", 3e-2)])
def test_two_pass_twin_matches_jax_kernel(dt, tol16):
    """The two-pass twin against ``fused_heads_attention_bwd_two_pass`` in
    interpret mode at (2, 256, 128), 4 heads, blocks (64, 128, 128): its
    pass 1 walks four q-blocks, its pass 2 two k-blocks in chunks of 128
    q rows."""
    (q, k, v), (jq, jk, jv) = _qkv_slices(2, 256, 128, dt, seed=2)
    g = _rng(3)(2, 256, 128)
    want = jattn.fused_heads_attention_bwd_two_pass(
        jq, jk, jv, jnp.asarray(g, jnp.dtype(dt)), 4, blocks=(64, 128, 128),
        interpret=True)
    _build.reset_launch_counts()
    got = tattn.fused_heads_attention_bwd_two_pass(
        q, k, v, torch.from_numpy(g).to(q.dtype), 4, blocks=(64, 128, 128))
    assert not _build.launch_counts
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and a.shape == q.shape, name
        _close(a, b, dt, rtol32=1e-4, tol16=tol16, err_msg=name)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_q", [64, 32])
def test_recompute_twin_matches_jax_single_pass_kernels(dt, block_q):
    """``fused_heads_attention_bwd(pipelined=False)`` (the twin on the CPU)
    against the JAX ungrouped recompute kernels in interpret mode: the
    whole-row ``_fused_heads_bwd_kernel`` (block_q = N) and the blocked
    one. They and the two-pass kernels share one recipe."""
    N, HD, H = 64, 128, 4
    (q, k, v), (jq, jk, jv) = _qkv_slices(2, N, HD, dt, seed=4)
    g = _rng(5)(2, N, HD)
    want = jattn.fused_heads_attention_bwd(
        jq, jk, jv, jnp.asarray(g, jnp.dtype(dt)), H, block_q=block_q,
        pipelined=False, interpret=True)
    gt = torch.from_numpy(g).to(q.dtype)
    got = tattn.fused_heads_attention_bwd(q, k, v, gt, H, pipelined=False)
    same = tattn.fused_heads_attention_bwd_two_pass(q, k, v, gt, H)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, same):
        _close(a, b, dt, rtol32=1e-4, err_msg=name)
        assert torch.equal(a, c), name


def test_pipelined_flag_picks_the_recipe_as_in_jax(monkeypatch):
    """``pipelined`` None means pipelined exactly where head_groups > 1
    (the JAX default, ``_pipe_bwd_enabled``); an explicit False gives the
    recompute recipe, True the pipelined one; a head grouping JAX refuses
    raises."""
    monkeypatch.delenv("T2MS_ATTN_PIPE_BWD", raising=False)
    assert not jattn._pipe_bwd_enabled(grouped=False)
    assert jattn._pipe_bwd_enabled(grouped=True)
    (q, k, v), _ = _qkv_slices(1, 32, 128, "float32", seed=6)
    g = torch.from_numpy(_rng(7)(1, 32, 128))
    pipe = tattn.fused_heads_bwd_reference(q, k, v, g, 4)
    rec = tattn.fused_heads_bwd_two_pass_reference(q, k, v, g, 4)
    for kw, want in ((dict(), rec), (dict(head_groups=2), pipe),
                     (dict(pipelined=False, head_groups=2), rec),
                     (dict(pipelined=True), pipe)):
        got = tattn.fused_heads_attention_bwd(q, k, v, g, 4, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kw
    with pytest.raises(ValueError, match="head_groups 3"):
        tattn.fused_heads_attention_bwd(q, k, v, g, 4, head_groups=3)


@pytest.mark.parametrize("n", [128, 480, 1024, 2048, 4096])
def test_bwd_route_follows_the_jax_predicates(n):
    """The copied predicates equal JAX's, and the route is the branch JAX's
    ``_fused_heads_bwd`` takes on a TPU, over H*D 128/256/512, 4 and 8
    heads, bf16 and f32."""
    for hd in (128, 256, 512):
        for heads in (4, 8):
            for bpe in (2, 4):
                bq = jattn._bwd_block_q(n, hd, bpe)
                hg = jattn._bwd_head_groups(n, hd, heads, bpe)
                tp = jattn._bwd_two_pass_blocks(n, hd, bpe)
                assert tattn._bwd_block_q(n, hd, bpe) == bq
                assert tattn._bwd_head_groups(n, hd, heads, bpe) == hg
                assert tattn._bwd_two_pass_blocks(n, hd, bpe) == tp
                want = ("single" if bq else "grouped" if hg
                        else "two_pass" if tp else "eager")
                assert tattn.fused_heads_bwd_route(n, hd, heads, bpe) == want


def test_bwd_route_at_the_main_paths():
    route = tattn.fused_heads_bwd_route
    assert route(480, 128, 4) == "single"          # flagship geometry
    assert route(1024, 512, 8) == "grouped"        # scaled train
    assert route(4096, 128, 4) == "two_pass"       # long-series train
    assert route(16, 512, 8) == "eager"            # no Pallas fit: #12


@pytest.mark.parametrize("n,hd,heads,want", [
    (128, 128, 4, ("bwd", dict())),
    (1024, 512, 8, ("bwd", dict(block_q=512, head_groups=2))),
    (4096, 128, 4, ("two_pass", dict())),
    (16, 512, 8, ("two_pass", dict())),
])
def test_diffable_backward_takes_the_jax_branch(monkeypatch, n, hd, heads,
                                                want):
    """``fused_heads_diffable``'s backward calls what the route names, with
    JAX's arguments (the forward and the backwards stubbed, so no N x N
    work runs)."""
    calls = []
    zeros = lambda q, *a, **kw: (torch.zeros_like(q),) * 3
    monkeypatch.setattr(tattn, "fused_heads_attention",
                        lambda q, k, v, h: torch.zeros_like(q))
    monkeypatch.setattr(tattn, "fused_heads_attention_bwd",
                        lambda *a, **kw: calls.append(("bwd", kw))
                        or zeros(*a))
    monkeypatch.setattr(tattn, "fused_heads_attention_bwd_two_pass",
                        lambda *a, **kw: calls.append(("two_pass", kw))
                        or zeros(*a))
    q, k, v = (torch.zeros(1, n, hd, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    tattn.fused_heads_diffable(q, k, v, heads).float().sum().backward()
    assert calls == [want]


# --------------------------------------------------- the routes' gates

def _dit(latent_len, latent_dim, **kw):
    return DiT(latent_len=latent_len, latent_dim=latent_dim, device="cpu",
               **kw)


@pytest.mark.parametrize("latent,tokens,inside", [
    ((30, 64), 480, True),            # flagship
    ((64, 64), 1024, True),           # scaled
    ((16, 32), 128, True),            # the range's low end
    ((256, 64), 4096, False),         # long series
    ((66, 64), 1056, False),          # above 1024
    ((30, 16), 120, False),           # below 128
    ((22, 24), 132, False),           # N % 8 == 4
    ((512, 64), 8192, False),         # the 8192-token DiT
])
def test_token_range_gates_against_a_fake_library(monkeypatch, latent,
                                                  tokens, inside):
    """With a library that takes every shape, the stack, split and block
    routes answer the JAX token range (128 <= N <= 1024, N % 8 == 0) and
    ask the library only inside it; the flax path takes every N, its
    attention on JAX's route on a TPU (fused heads where JAX's
    ``fused_heads_block_q`` admits the geometry, else flash for N >= 1024
    with a non-zero ``_auto_block``, else einsum), and it asks the
    LayerNorm library and only the attention library of that route."""
    asked = []
    monkeypatch.setattr(_build, "supported",
                        lambda lib, check, *a: asked.append(check) or True)
    dit = _dit(*latent)
    assert dit.num_patches == tokens
    for gate in (dit_fast.fast_forward_supported,
                 dit_fast.split_forward_supported,
                 dit_fast.train_forward_supported):
        assert gate(dit) is inside
    bpe = dit.pos.element_size()
    want = ("fused" if jattn.fused_heads_block_q(tokens, dit.d_model, bpe)
            else "flash" if tokens >= 1024 and jattn._auto_block(tokens)
            else "einsum")
    assert dit_fast.flax_attention_route(dit) == want
    assert want == {120: "einsum", 132: "einsum", 1056: "flash",
                    8192: "flash"}.get(tokens, "fused")
    assert dit_fast.flax_path_supported(dit)
    kernel_checks = ["dit_stack_check", "dit_split_check", "dit_block_check"]
    assert asked == (kernel_checks if inside else []) + [
        "mod_ln_check", "res_mod_ln_check"] + {
        "fused": ["fused_heads_check"], "flash": ["split_heads_check"],
        "einsum": []}[want]


_PIPE_GEOMETRIES = {"grouped": (1024, 512, 8), "ungrouped": (480, 128, 4)}


@pytest.mark.parametrize("flag", [None, "0", "1"])
@pytest.mark.parametrize("geometry", ["grouped", "ungrouped"])
def test_pipe_switch_picks_the_recipe_as_jax(monkeypatch, flag, geometry):
    """``T2MS_ATTN_PIPE_BWD`` unset, 0 or 1: the recipe
    ``_FusedHeads.backward`` runs (pipelined or recompute, told apart by
    the twin it calls on the CPU) equals JAX's ``_pipe_bwd_enabled`` for
    the branch the route takes, head-grouped (N 1024, H*D 512, 8 heads) or
    ungrouped (N 480, H*D 128, 4 heads)."""
    if flag is None:
        monkeypatch.delenv("T2MS_ATTN_PIPE_BWD", raising=False)
    else:
        monkeypatch.setenv("T2MS_ATTN_PIPE_BWD", flag)
    n, hd, heads = _PIPE_GEOMETRIES[geometry]
    route = tattn.fused_heads_bwd_route(n, hd, heads, 4)
    assert route == ("grouped" if geometry == "grouped" else "single")
    recipes = []
    zeros = lambda q, *a, **kw: (torch.zeros_like(q),) * 3
    monkeypatch.setattr(tattn, "fused_heads_bwd_reference",
                        lambda *a, **kw: recipes.append(True) or zeros(*a))
    monkeypatch.setattr(tattn, "fused_heads_bwd_two_pass_reference",
                        lambda *a, **kw: recipes.append(False) or zeros(*a))
    monkeypatch.setattr(tattn, "fused_heads_attention",
                        lambda q, k, v, h: torch.zeros_like(q))
    q, k, v = (torch.zeros(1, n, hd, requires_grad=True) for _ in range(3))
    tattn.fused_heads_diffable(q, k, v, heads).sum().backward()
    assert recipes == [jattn._pipe_bwd_enabled(grouped=route == "grouped")]
    assert recipes == [{None: geometry == "grouped", "0": False,
                        "1": True}[flag]]


# ------------------------------------------------ the flax-path DiT

def _perturbed(params, seed, scale=0.02):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        p + scale * jax.random.normal(k, p.shape)
        for p, k in zip(leaves, keys)])


def test_flax_path_forward_matches_jax_at_a_long_series_shape(monkeypatch):
    """``flax_path_forward`` (its twins on the CPU) against ``jax.grad`` of
    flax ``DiT.apply`` with the LayerNorm and residual fusion kernels on
    (interpret mode) at a long-series-shaped DiT: d_model 128, 4 heads of
    32, depth 2, mlp x2, 512 tokens. The attention backward takes JAX's
    single-pass recompute branch at this size."""
    monkeypatch.setenv("T2MS_FUSED_MOD_LN", "1")
    monkeypatch.setenv("T2MS_FUSED_RES_LN", "1")
    kw = dict(latent_len=32, latent_dim=64, d_model=128, depth=2,
              num_heads=4, mlp_ratio=2.0)
    jd = JDiT(**kw)
    x = jax.random.normal(jax.random.key(0), (2, 64, 32))
    t = jnp.array([0.25, 0.75])
    emb = jax.random.normal(jax.random.key(1), (2, 128))
    mask = jnp.array([0.0, 1.0])
    jp = _perturbed(jd.init(jax.random.key(2), x, t, emb), 3)
    tgt = jax.random.normal(jax.random.key(6), x.shape)
    lw, gw = jax.value_and_grad(lambda p: jnp.mean(jnp.square(
        jd.apply(p, x, t, emb, mask) - tgt)))(jp)

    td = DiT(**kw, device="cpu")
    assert td.num_patches == 512
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


def test_flax_path_forward_runs_the_boundaries_in_order(monkeypatch):
    """Per forward: one ``mod_ln_diffable`` (block 0's leading boundary),
    2 * depth - 1 ``res_mod_ln_diffable`` and depth
    ``fused_heads_diffable`` (128 tokens: JAX's fused-heads route); the
    result equals the eager module's."""
    calls = []
    for mod, name in ((dit_fast, "mod_ln_diffable"),
                      (dit_fast, "res_mod_ln_diffable"),
                      (tdit, "fused_heads_diffable")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    torch.manual_seed(0)
    dit = _dit(16, 32, d_model=32, depth=3, num_heads=2)
    assert dit.num_patches == 128
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.05 * torch.randn_like(p))
        x, t, e = torch.randn(2, 32, 16), torch.rand(2), torch.randn(2, 32)
        got = dit_fast.flax_path_forward(dit, x, t, e, torch.ones(2))
        want = dit(x, t, e, torch.ones(2))
    assert calls.count("mod_ln_diffable") == 1 and calls[0] == "mod_ln_diffable"
    assert calls.count("res_mod_ln_diffable") == 5
    assert calls.count("fused_heads_diffable") == 3
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("latent,route", [((8, 16), "einsum"),
                                          ((66, 64), "flash")])
def test_flax_path_forward_takes_the_split_heads_routes(monkeypatch, latent,
                                                        route):
    """Where JAX's ``fused_heads_block_q`` refuses (32 tokens, below 128;
    1056 tokens, above 1024 with no 128-multiple block),
    ``flax_path_forward`` runs ``attention`` on the head-split views with
    the route's impl (einsum below 1024 tokens, else flash), once a layer,
    and no fused heads; the result equals the eager module's."""
    calls = []
    attn = tdit.attention
    monkeypatch.setattr(tdit, "attention", lambda *a, impl: (
        calls.append(impl) or attn(*a, impl=impl)))
    monkeypatch.setattr(tdit, "fused_heads_diffable",
                        lambda *a: calls.append("fused"))
    torch.manual_seed(0)
    dit = _dit(*latent, d_model=32, depth=2, num_heads=2)
    assert dit_fast.flax_attention_route(dit) == route
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.05 * torch.randn_like(p))
        x = torch.randn(2, latent[1], latent[0])
        t, e = torch.rand(2), torch.randn(2, 32)
        got = dit_fast.flax_path_forward(dit, x, t, e, torch.ones(2))
        assert calls == [route] * 2
        want = dit(x, t, e, torch.ones(2))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_dit_bridge_and_lavae_at_latent_256():
    """The weight bridge at the long-series DiT (latent 256 x 64, 4096
    tokens; depth cut to 1 and one series for CPU time): the eager model
    and the flax path reproduce flax apply; the LA-VAE at latent grid 256
    encodes and decodes a length-2048 series as JAX does."""
    kw = dict(latent_len=256, latent_dim=64, d_model=128, depth=1,
              num_heads=4, mlp_ratio=2.0)
    jd = JDiT(**kw)
    x = jax.random.normal(jax.random.key(0), (1, 64, 256))
    t, emb = jnp.array([0.5]), jax.random.normal(jax.random.key(1), (1, 128))
    jp = _perturbed(jd.init(jax.random.key(2), x, t, emb), 4)
    want = np.asarray(jd.apply(jp, x, t, emb, jnp.array([1.0])))
    td = DiT(**kw, device="cpu")
    sd = dit_params_from_jax(_np_tree(jp))
    assert sd.keys() == td.state_dict().keys()
    td.load_state_dict(sd)
    T = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        for got in (td(T(x), T(t), T(emb), torch.ones(1)),
                    dit_fast.flax_path_forward(td, T(x), T(t), T(emb),
                                               torch.ones(1))):
            np.testing.assert_allclose(got.numpy(), want, rtol=5e-4,
                                       atol=5e-5)

    jv = JLAVAE(in_channels=1, latent_grid=256)
    s = np.random.default_rng(2).standard_normal((2, 2048)).astype(np.float32)
    vp = jv.init(jax.random.key(1), jnp.asarray(s))
    tv = LAVAE(in_channels=1, latent_grid=256, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    jz, _ = jv.apply(vp, jnp.asarray(s), method=jv.encode)
    jx, _ = jv.apply(vp, jz, 2048, method=jv.decode)
    with torch.no_grad():
        tz, _ = tv.encode(torch.from_numpy(s))
        tx, _ = tv.decode(torch.from_numpy(np.array(jz)), 2048)
    assert tuple(tz.shape) == (2, 64, 256)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=5e-4,
                               atol=5e-5)


def test_sampler_third_route_matches_jax(monkeypatch):
    """``make_cfg_sampler`` routed as on CUDA for a DiT the stack and split
    kernels refuse: it takes ``flax_path_forward`` (its twins on the CPU,
    under no_grad) and gives the JAX sampler's series on the same noise,
    the JAX DiT running its LayerNorm and residual fusion kernels."""
    monkeypatch.setenv("T2MS_FUSED_MOD_LN", "1")
    monkeypatch.setenv("T2MS_FUSED_RES_LN", "1")
    jv = JLAVAE(in_channels=1, latent_grid=6, num_hiddens=16,
                num_residual_hiddens=16, embedding_dim=8)
    xs = jax.random.normal(jax.random.key(0), (2, 24))
    vp = jv.init(jax.random.key(1), xs)
    jd = JDiT(latent_len=6, latent_dim=8, d_model=32, depth=2, num_heads=2)
    z, _ = jv.apply(vp, xs, method=jv.encode)
    dp = _perturbed(jd.init(jax.random.key(2), z, jnp.zeros(2),
                            jnp.zeros((2, 32))), 5, 0.05)
    emb = jax.random.normal(jax.random.key(4), (2, 32))
    key = jax.random.key(5)
    want = j_make_cfg_sampler(jd, jv, "flowmatching", 3, 3.0, 24)(
        dp, vp, key, xs, emb)
    x_t0 = np.array(jax.random.normal(key, want.latent_enc.shape))

    tv = LAVAE(1, 16, 2, 16, 8, 6, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    td = DiT(6, 8, 32, 2, 2, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(dp)))
    routes, grad_modes = [], []
    monkeypatch.setattr(dit_fast, "fused_path_eligible", lambda d, dev: True)
    monkeypatch.setattr(dit_fast, "fast_forward_supported",
                        lambda d: routes.append("stack?") or False)
    monkeypatch.setattr(dit_fast, "split_forward_supported",
                        lambda d: routes.append("split?") or False)
    monkeypatch.setattr(dit_fast, "flax_path_supported",
                        lambda d: routes.append("flax?") or True)
    flax = dit_fast.flax_path_forward
    monkeypatch.setattr(dit_fast, "flax_path_forward", lambda *a: (
        grad_modes.append(torch.is_grad_enabled()) or flax(*a)))
    got = make_cfg_sampler(td, tv, "flowmatching", 3, 3.0, 24,
                           device="cpu")(np.array(xs), np.array(emb),
                                         x_t0=torch.from_numpy(x_t0))
    assert routes == ["stack?", "split?", "flax?"]
    assert grad_modes == [False] * 3
    np.testing.assert_allclose(got.series.numpy(), np.asarray(want.series),
                               rtol=2e-4, atol=2e-5)


# ------------------------------------------ launchers, fake library

def _check_res_mod_ln_launch(monkeypatch, launcher, entry, dt, gm3):
    x = torch.randn(2, 8, 32).to(dt)
    args = (x, x, gm3, 1e-6) if launcher == "_launch_res_mod_ln" else (
        x, x, gm3, x, x, 1e-6)
    out = _check_ln_launch(monkeypatch, launcher, entry, dt, gm3, 2, args)
    if launcher == "_launch_res_mod_ln":
        assert [o.dtype for o in out] == [dt, dt]
    else:
        assert [o.dtype for o in out] == [dt, dt, gm3.dtype]
        assert tuple(out[2].shape) == (2, 3, 32)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("launcher,entry", [
    ("_launch_res_mod_ln", "res_mod_ln_forward"),
    ("_launch_res_mod_ln_bwd", "res_mod_ln_backward")])
def test_res_mod_ln_launchers_pass_their_declared_arguments(
        monkeypatch, launcher, entry, dt):
    """The residual + LayerNorm launchers against the fake library, gm3
    the flax path's view of a (B, 6, D) modulation: both read it in place,
    with its batch stride of 6 * D and whether it is bf16, and the
    backward returns dx, dh and dgm3 in the inputs' dtypes. The shape goes
    over as (B, N, D), eps and the stream last."""
    gm3 = _modulation("view", 2, 3, 32, dt)
    assert gm3.stride(0) == 6 * 32
    _check_res_mod_ln_launch(monkeypatch, launcher, entry, dt, gm3)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "f16"])
@pytest.mark.parametrize("launcher,entry", [
    ("_launch_res_mod_ln", "res_mod_ln_forward"),
    ("_launch_res_mod_ln_bwd", "res_mod_ln_backward")])
def test_res_mod_ln_launchers_take_contiguous_and_f16_modulations(
        monkeypatch, launcher, entry, layout, dt):
    """The same launchers with gm3 a contiguous (B, 3, D) tensor (read in
    place at stride 3 * D) and a float16 one (a contiguous f32 copy goes
    over; dgm3 comes back in float16)."""
    _check_res_mod_ln_launch(monkeypatch, launcher, entry, dt,
                             _modulation(layout, 2, 3, 32, dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [4, 2, 1])          # head widths 32 to 128
@pytest.mark.parametrize("fn,entry", [
    ("fused_heads_attention", "fused_heads_forward"),
    ("fused_heads_attention_with_stats", "fused_heads_forward_stats")])
def test_forward_launchers_leave_the_sizing_to_the_library(
        monkeypatch, fn, entry, heads, dt):
    """#9 and #10 on a tensor that reports CUDA, against the fake library:
    one forward entry with (B, N, H*D, H), the strides and the scale, and
    no other call. The grid and the shared memory are the library's own
    (attn_heads.cuh's launch_fwd_bf16, whose shared memory
    ``fused_heads_forward_smem`` reports), so a new tile height changes no
    wrapper; no workspace is asked for."""
    lib = _rehearse(monkeypatch)
    qkv = torch.randn(2, 130, 3 * 128).to(dt)
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    out = getattr(tattn, fn)(q, k, v, heads)
    call = _one_launch(lib, entry, dt)
    assert [c[0] for c in lib.calls] == [
        f"{entry}_{'bf16' if dt == torch.bfloat16 else 'f32'}"]
    assert tuple(call[-12:-8]) == (2, 130, 128, heads)   # B, N, H*D, H
    assert list(call[-8:-2]) == [130 * 384, 384] * 3     # q, k, v strides
    assert call[-1].value == 7
    o = out[0] if fn.endswith("stats") else out
    assert o.shape == q.shape and o.dtype == dt
    assert lib.fused_heads_forward_smem.argtypes == [ctypes.c_int]
    assert lib.fused_heads_forward_smem.restype == ctypes.c_longlong


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,pipelined,name", [
    ("fused_heads_attention_bwd_two_pass", 0,
     tattn.FUSED_HEADS_TWO_PASS_KERNEL),
    ("fused_heads_attention_bwd", 0, tattn.FUSED_HEADS_BWD_KERNEL),
    ("fused_heads_attention_bwd", 1, tattn.FUSED_HEADS_BWD_KERNEL)])
def test_backward_launchers_pass_the_recipe(monkeypatch, fn, pipelined, name,
                                            dt):
    """#12 and #11 on a tensor that reports CUDA, against the fake
    library: one backward entry with the recipe flag after the strides,
    counted under the kernel's own name."""
    lib = _rehearse(monkeypatch)
    qkv = torch.randn(2, 8, 3 * 64).to(dt)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    kw = {} if fn.endswith("two_pass") else dict(pipelined=bool(pipelined))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    getattr(tattn, fn)(q, k, v, q.contiguous(), 2, **kw)
    call = _one_launch(lib, "fused_heads_backward", dt)
    assert dict(_build.launch_counts) == {name: 1}
    *_, flag, scale, qscale, stream = call
    assert flag == pipelined and stream.value == 7
    assert scale.value == pytest.approx(32 ** -0.5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,pipelined", [
    ("fused_heads_attention_bwd_two_pass", 0),
    ("fused_heads_attention_bwd", 0),
    ("fused_heads_attention_bwd", 1)])
def test_backward_launchers_size_the_workspace_by_recipe(monkeypatch, fn,
                                                         pipelined, dt):
    """#11 and #12 ask ``fused_heads_backward_workspace`` once, for (B, N,
    H*D, H, pipelined): the rows' statistics, and with the pipelined
    recipe also the (B, N, H*D) bf16 T(q * scale / r) and T(g / r) the
    q-tile kernel writes once for the k-tile kernel."""
    lib = _rehearse(monkeypatch)
    qkv = torch.randn(2, 8, 3 * 64).to(dt)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    kw = {} if fn.endswith("two_pass") else dict(pipelined=bool(pipelined))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    getattr(tattn, fn)(q, k, v, q.contiguous(), 2, **kw)
    asked = [c[1] for c in lib.calls
             if c[0] == "fused_heads_backward_workspace"]
    assert asked == [(2, 8, 64, 2, pipelined)]
    _one_launch(lib, "fused_heads_backward", dt)
