"""The port's scaled-geometry serving path held to the JAX package on the
CPU: the ``fused_dit_block_split`` twin against the JAX split kernels in
interpret mode, ``split_dit_forward`` against the JAX split forward and
flax ``apply``, the weight bridge at the scaled width, the LA-VAE at
``latent_grid=64`` and the serving sampler at the scaled latent shape
(64, 64); and the kernel launchers (those of the flax path's kernels
too) rehearsed against a fake library. The
samplers' route (stack first, split second, else refuse) is tested with
the other routing cases in ``test_torch_sampling.py``, the split's
autograd refusal with the other forwards' in ``test_torch_block.py``;
the kernel-vs-twin checks need a card and live in
``test_torch_cuda.py``.

Tolerances: f32 forward rtol 2e-4 / atol 2e-5 (summation order only);
whole-model f32 rtol 5e-4 / atol 5e-5, the JAX split-forward test's own
bound (tests/test_dit_fast.py); bf16 atol 3e-2 * max|ref| plus correlation
>= 0.999 with the f32 result (one bf16 ulp is 2^-8 relative)."""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.denoisers.dit_fast import \
    split_dit_forward as j_split_dit_forward
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.ops import dit_block as jblock
from t2ms_tpu.serving import make_serving_sampler as j_make_serving_sampler
from t2ms_tpu_torch.convert import dit_params_from_jax, lavae_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT, dit_fast
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.ops import _build
from t2ms_tpu_torch.ops import dit_block as tblock
from t2ms_tpu_torch.serving import ServingEngine, make_serving_sampler


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturbed(params, seed=3, scale=0.02):
    """Every param moved off its init (adaLN-zero would zero the gates)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        p + scale * jax.random.normal(k, p.shape)
        for p, k in zip(leaves, keys)])


def _block_inputs(B, N, D, hidden, seed=0):
    """The JAX split test's inputs (random mod, f32 weights)."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return [f(B, N, D), 0.1 * f(B, 6, D), 0.2 * f(D, 3 * D), 0.1 * f(3 * D),
            0.2 * f(D, D), 0.1 * f(D), 0.2 * f(D, hidden), 0.1 * f(hidden),
            0.2 * f(hidden, D), 0.1 * f(D)]


def _jax_split(a, dt, block_q):
    return np.asarray(jblock.fused_dit_block_split(
        jnp.asarray(a[0], dt), jnp.asarray(a[1], dt), *map(jnp.asarray, a[2:]),
        num_heads=4, block_q=block_q, interpret=True).astype(jnp.float32))


# (B, N, D, hidden, the JAX block_q, the port's block_q). The JAX default
# (block_q=0: its VMEM envelope) refuses N=24, so the tiny geometry of
# tests/test_dit_fast.py runs at block_q=8 there; the port ignores block_q
# and is held to it with 8 and with its default. At N=128, D=128 both run
# their defaults (the JAX envelope picks 128).
SPLIT_CASES = {"bq8": (2, 24, 32, 64, 8, 8),
               "port_default": (2, 24, 32, 64, 8, 0),
               "defaults": (2, 128, 128, 256, 0, 0)}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_twin_matches_jax_kernel(case, dt):
    B, N, D, hidden, j_bq, t_bq = SPLIT_CASES[case]
    a = _block_inputs(B, N, D, hidden, seed=1)
    tdt = getattr(torch, dt)
    _build.reset_launch_counts()
    got = tblock.fused_dit_block_split(
        torch.from_numpy(a[0]).to(tdt), torch.from_numpy(a[1]).to(tdt),
        *map(torch.from_numpy, a[2:]), num_heads=4, block_q=t_bq)
    assert not _build.launch_counts                  # CPU: the twin only
    assert got.dtype == tdt and tuple(got.shape) == (B, N, D)
    got = got.float().numpy()
    want = _jax_split(a, jnp.dtype(dt), j_bq)
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())
        want32 = _jax_split(a, jnp.float32, j_bq)
        assert np.corrcoef(got.ravel(), want32.ravel())[0, 1] >= 0.999


def test_split_refuses_mismatched_operands():
    a = [torch.from_numpy(v) for v in _block_inputs(1, 8, 32, 64)]
    with pytest.raises(ValueError, match="fused_dit_block_split: wfc2 must"):
        tblock.fused_dit_block_split(*a[:8], a[8][:-1], a[9], num_heads=4)
    with pytest.raises(ValueError, match="mod must be"):
        tblock.fused_dit_block_split(a[0], a[1][:, None], *a[2:],
                                     num_heads=4)


class _FakeLib:
    """Stands in for a kernel library: its C entries carry the argument
    types ``_build._declare`` gives the real ones, check each call against
    them, record it and return success."""

    ENTRIES = ("dit_stack_forward_bf16", "dit_stack_forward_f32",
               "dit_split_forward_bf16", "dit_split_forward_f32",
               "dit_split_gemm_bf16",
               "dit_block_backward_bf16", "dit_block_backward_f32",
               "dit_block_check", "dit_block_backward_workspace",
               "dit_block_mlp_bwd_bf16", "dit_block_qkv_bwd_bf16",
               "mod_ln_forward_bf16", "mod_ln_forward_f32",
               "mod_ln_backward_bf16", "mod_ln_backward_f32",
               "mod_ln_backward_workspace",
               "res_mod_ln_forward_bf16", "res_mod_ln_forward_f32",
               "res_mod_ln_backward_bf16", "res_mod_ln_backward_f32",
               "res_mod_ln_backward_workspace",
               "fused_heads_forward_bf16", "fused_heads_forward_f32",
               "fused_heads_forward_stats_bf16",
               "fused_heads_forward_stats_f32",
               "fused_heads_backward_bf16", "fused_heads_backward_f32",
               "fused_heads_backward_lean_bf16",
               "fused_heads_backward_lean_f32",
               "fused_heads_backward_workspace", "fused_heads_forward_smem",
               "split_heads_forward_bf16", "split_heads_forward_f32")

    def __init__(self):
        self.calls = []
        for name in self.ENTRIES:
            setattr(self, name, self._entry(name))
        _build._declare(self)

    def _entry(self, name):
        def call(*args):
            assert len(args) == len(call.argtypes), name
            for a, t in zip(args, call.argtypes):
                assert (type(a) is int
                        if t in (ctypes.c_int, ctypes.c_longlong)
                        else isinstance(a, t)), (name, a, t)
            self.calls.append((name, args))
            return 16 if name.endswith("workspace") else 0
        return call


def _rehearse(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    _build.reset_launch_counts()
    return lib


def _one_launch(lib, entry, dt):
    suffix = "bf16" if dt == torch.bfloat16 else "f32"
    launches = [c for c in lib.calls if c[0] == f"{entry}_{suffix}"]
    assert len(launches) == 1
    assert sum(_build.launch_counts.values()) == 1
    return launches[0][1]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("launcher,entry", [
    ("_launch_stack", "dit_stack_forward"),
    ("_launch_split", "dit_split_forward"),
    ("_launch_block_bwd", "dit_block_backward")])
def test_launchers_pass_each_entry_its_declared_arguments(
        monkeypatch, launcher, entry, dt):
    """Rehearses the CUDA launch path on the CPU against a fake library:
    every argument has the kind and count the C entry declares, the
    softmax scale is cast to x's dtype, the stream rides last, and the
    launch is counted once."""
    lib = _rehearse(monkeypatch)
    a = [torch.from_numpy(v) for v in _block_inputs(2, 8, 32, 64)]
    x, mod, ws = a[0].to(dt), a[1], a[2:]
    if launcher == "_launch_stack":
        args = (x, mod[:, None], [w[None] for w in ws], 4, 1e-6)
    elif launcher == "_launch_split":
        args = (x, mod, ws, 4, 1e-6)
    else:
        args = (x, mod, ws, x, 4, 1e-6)
    getattr(tblock, launcher)(*args)
    *_, eps, qscale, stream = _one_launch(lib, entry, dt)
    assert stream.value == 7 and eps.value == pytest.approx(1e-6)
    assert qscale.value == float(torch.tensor(8 ** -0.5, dtype=dt))


@pytest.mark.parametrize("stage", tblock.SPLIT_GEMM_STAGES)
def test_split_gemm_launcher_passes_its_declared_arguments(monkeypatch,
                                                           stage):
    """One GEMM stage of the split block against the fake library: six
    pointers (a first, the output last), rows, N, K, cols and the stage's
    index as ints, eps and the stream last; one launch counted as
    split_gemm; an input other than bf16 or a mismatched operand refused
    before any call."""
    lib = _rehearse(monkeypatch)
    B, N, D, hidden = 2, 8, 32, 64
    K, cols = {"qkv": (D, 3 * D), "proj": (D, D), "fc1": (D, hidden),
               "fc2": (hidden, D)}[stage]
    bf = lambda *s: torch.randn(*s).to(torch.bfloat16)
    a, w, bias, res = bf(B, N, K), bf(K, cols), bf(cols), bf(B, N, cols)
    out = tblock._launch_split_gemm(a, torch.randn(B, 6, D), w, bias, res,
                                    stage)
    *ptrs, rows, n, k, c, idx, eps, stream = _one_launch(
        lib, "dit_split_gemm", torch.bfloat16)
    assert dict(_build.launch_counts) == {tblock.SPLIT_GEMM_KERNEL: 1}
    assert ptrs[0].value == a.data_ptr() and ptrs[5].value == out.data_ptr()
    assert (rows, n, k, c) == (B * N, N, K, cols)
    assert idx == tblock.SPLIT_GEMM_STAGES.index(stage)
    assert eps.value == pytest.approx(1e-6) and stream.value == 7
    assert out.shape == (B, N, cols) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not take"):
        tblock._launch_split_gemm(a.float(), torch.randn(B, 6, D), w, bias,
                                  res, stage)
    with pytest.raises(ValueError, match="bias must be"):
        tblock._launch_split_gemm(a, torch.randn(B, 6, D), w, bias[:-1],
                                  res, stage)
    assert len(lib.calls) == 1


@pytest.mark.parametrize("rows", [2 * 1024, 32 * 1024])
@pytest.mark.parametrize("code,route", [(0, "none"), (1, "narrow"),
                                        (2, "wide"), (3, "persistent")])
def test_split_gemm_route_asks_the_library_for_a_calls_rows(monkeypatch, rows,
                                                            code, route):
    """split_gemm_route passes the width and the call's rows (one server
    request's CFG batch and the scaled sampler's, the two sides of the
    persistent kernel's row threshold) to dit_split_route as the two ints
    it declares, and names the route the library answers."""
    calls = []

    def dit_split_route(*args):
        assert len(args) == len(dit_split_route.argtypes) == 2
        assert all(t is ctypes.c_int for t in dit_split_route.argtypes)
        calls.append(args)
        return code

    lib = types.SimpleNamespace(dit_split_route=dit_split_route)
    _build._declare(lib)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert tblock.split_gemm_route(512, rows) == route
    assert calls == [(512, rows)]


@pytest.mark.parametrize("half", ["mlp", "qkv"])
def test_row_backward_launchers_pass_their_declared_arguments(monkeypatch,
                                                              half):
    """The block backward's MLP-half and qkv-half kernels alone against the
    fake library: the pointers (inputs first, part last), B, N, D (and the
    MLP's hidden) as ints, eps and the stream last; one launch counted
    under the half's own name; the twin's output shapes and dtypes; an f32
    input or a mismatched operand refused before any call."""
    lib = _rehearse(monkeypatch)
    B, N, D, hidden = 2, 70, 64, 128
    bf = lambda *s: torch.randn(*s).to(torch.bfloat16)
    mod = torch.randn(B, 6, D)
    if half == "mlp":
        fn, entry, name = (tblock._launch_mlp_half_bwd, "dit_block_mlp_bwd",
                           tblock.MLP_HALF_BWD_KERNEL)
        args = [bf(B, N, D), mod, bf(D, hidden), bf(hidden), bf(hidden, D),
                bf(D), bf(B, N, D)]
        shapes = [(B, N, D), (B, N, D), (B, N, hidden), (B, N, D),
                  (B, N, hidden)] + [(B, D)] * 3
        dtypes = [torch.float32] + [torch.bfloat16] * 4 + [torch.float32] * 3
        bad, what = 4, "w2 must be"
    else:
        fn, entry, name = (tblock._launch_qkv_half_bwd, "dit_block_qkv_bwd",
                           tblock.QKV_HALF_BWD_KERNEL)
        args = [bf(B, N, D), mod, bf(D, 3 * D), bf(B, N, 3 * D),
                torch.randn(B, N, D)]
        shapes = [(B, N, D), (B, D), (B, D)]
        dtypes = [torch.bfloat16, torch.float32, torch.float32]
        bad, what = 3, "dqkv must be"
    out = fn(*args)
    call = _one_launch(lib, entry, torch.bfloat16)
    ints = [a for a in call if type(a) is int]
    assert ints == ([B, N, D, hidden] if half == "mlp" else [B, N, D])
    assert call[0].value == args[0].data_ptr()
    assert call[-2].value == pytest.approx(1e-6) and call[-1].value == 7
    assert dict(_build.launch_counts) == {name: 1}
    assert [tuple(o.shape) for o in out] == shapes
    assert [o.dtype for o in out] == dtypes
    with pytest.raises(ValueError, match="does not take"):
        fn(*[args[0].float()] + args[1:])
    with pytest.raises(ValueError, match=what):
        fn(*args[:bad] + [args[bad][..., :-1]] + args[bad + 1:])
    assert len(lib.calls) == 1


def _modulation(layout, B, k, D, dt):
    """A (B, k, D) modulation as a caller hands it over: ``view`` the flax
    path's slice of a (B, 6, D) one in ``dt``, ``contiguous`` its own
    tensor in ``dt``, ``f16`` its own tensor in float16 (a dtype the
    kernels do not read)."""
    if layout == "view":   # mod2 = m[:, 0:2], gm3 = m[:, 2:5]
        return torch.randn(B, 6, D).to(dt)[:, 0:2] if k == 2 else \
            torch.randn(B, 6, D).to(dt)[:, 2:5]
    return torch.randn(B, k, D).to(torch.float16 if layout == "f16" else dt)


def _check_ln_launch(monkeypatch, launcher, entry, dt, mod, at, args):
    """One LayerNorm launcher against the fake library: the modulation
    ``mod`` goes over in place (its pointer, its batch stride, whether it
    is bf16) at argument ``at``, or, in float16, as a contiguous f32 copy;
    the shape as (B, N, D), eps and the stream last; one launch. Returns
    the outputs."""
    lib = _rehearse(monkeypatch)
    out = getattr(tblock, launcher)(*args)
    call = _one_launch(lib, entry, dt)
    *_, B, N, D, eps, stream = call
    assert (B, N, D) == tuple(args[0].shape) and stream.value == 7
    assert eps.value == pytest.approx(1e-6)
    m, ms, mbf16 = call[at:at + 3]
    if mod.dtype == torch.float16:
        assert m.value != mod.data_ptr() and ms == mod.shape[1] * D
        assert mbf16 == 0
    else:
        assert m.value == mod.data_ptr() and ms == mod.stride(0)
        assert mbf16 == int(mod.dtype == torch.bfloat16)
    return out


def _check_mod_ln_launch(monkeypatch, launcher, entry, dt, mod2):
    x = torch.randn(2, 8, 32).to(dt)
    args = (x, mod2, 1e-6) if launcher == "_launch_mod_ln" else (
        x, mod2, x, 1e-6)
    out = _check_ln_launch(monkeypatch, launcher, entry, dt, mod2, 1, args)
    if launcher == "_launch_mod_ln_bwd":
        assert out[0].dtype == dt and out[1].dtype == mod2.dtype
        assert tuple(out[1].shape) == (2, 2, 32)
    else:
        assert out.dtype == dt and tuple(out.shape) == (2, 8, 32)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("launcher,entry", [
    ("_launch_mod_ln", "mod_ln_forward"),
    ("_launch_mod_ln_bwd", "mod_ln_backward")])
def test_mod_ln_launchers_pass_their_declared_arguments(
        monkeypatch, launcher, entry, dt):
    """The LayerNorm + modulate launchers against the fake library, mod2
    the flax path's view of a (B, 6, D) modulation: both read it in place,
    with its batch stride of 6 * D and whether it is bf16, and the
    backward's dmod2 comes back in mod2's dtype. The shape goes over as
    (B, N, D), eps and the stream last."""
    mod2 = _modulation("view", 2, 2, 32, dt)
    assert mod2.stride(0) == 6 * 32
    _check_mod_ln_launch(monkeypatch, launcher, entry, dt, mod2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "f16"])
@pytest.mark.parametrize("launcher,entry", [
    ("_launch_mod_ln", "mod_ln_forward"),
    ("_launch_mod_ln_bwd", "mod_ln_backward")])
def test_mod_ln_launchers_take_contiguous_and_f16_modulations(
        monkeypatch, launcher, entry, layout, dt):
    """The same launchers with mod2 a contiguous (B, 2, D) tensor (read in
    place at stride 2 * D) and a float16 one (a contiguous f32 copy goes
    over; dmod2 comes back in float16)."""
    _check_mod_ln_launch(monkeypatch, launcher, entry, dt,
                         _modulation(layout, 2, 2, 32, dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("launcher,entry", [
    ("_launch_fused_heads", "fused_heads_forward"),
    ("_launch_fused_heads_bwd", "fused_heads_backward")])
def test_fused_heads_launchers_read_the_qkv_slices_in_place(
        monkeypatch, launcher, entry, dt):
    """The fused-heads launchers against the fake library: q, k and v go
    over as the pointers of the qkv projection's column slices (no copy)
    with the projection's batch and row strides; the scale follows the
    JAX recipe (q scaled by the scale rounded to the dtype)."""
    from t2ms_tpu_torch.ops import attention as tattn
    lib = _rehearse(monkeypatch)
    qkv = torch.randn(2, 8, 3 * 64).to(dt)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    extra = (qkv[..., :64].contiguous(),) if "bwd" in launcher else ()
    getattr(tattn, launcher)(q, k, v, *extra, 2, 32 ** -0.5)
    call = _one_launch(lib, entry, dt)
    ptrs = [c.value for c in call[:3]]
    assert ptrs == [t.data_ptr() for t in (q, k, v)]
    n_ptrs = 8 if extra else 4        # + g, dq, dk, dv, workspace
    assert tuple(call[n_ptrs:n_ptrs + 4]) == (2, 8, 64, 2)
    assert list(call[n_ptrs + 4:n_ptrs + 10]) == [8 * 192, 192] * 3
    *_, qscale, stream = call
    assert stream.value == 7
    assert qscale.value == float(torch.tensor(32 ** -0.5, dtype=dt))


def _dit_pair(**kw):
    """A JAX DiT with perturbed params and the port's DiT holding them."""
    jd = JDiT(**kw)
    x = jax.random.normal(jax.random.key(0), (2, kw["latent_dim"],
                                              kw["latent_len"]))
    t = jnp.array([0.25, 0.75])
    emb = jax.random.normal(jax.random.key(1), (2, jd.d_model))
    jp = _perturbed(jd.init(jax.random.key(2), x, t, emb))
    td = DiT(**kw, device="cpu")
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    return jd, jp, td, (x, t, emb, jnp.array([0.0, 1.0]))


def test_split_dit_forward_matches_jax():
    """The port's split forward (the twin per layer on the CPU) against the
    JAX split forward (its Pallas kernels in interpret mode) and flax
    apply, at the JAX test's geometry (128 tokens, d 128)."""
    jd, jp, td, args = _dit_pair(latent_len=8, latent_dim=64)
    T = lambda v: torch.from_numpy(np.array(v))
    _build.reset_launch_counts()
    with torch.no_grad():
        got = dit_fast.split_dit_forward(td, *map(T, args)).numpy()
    assert not _build.launch_counts
    for want in (j_split_dit_forward(jd, jp, *args, interpret=True),
                 jd.apply(jp, *args)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4,
                                   atol=5e-5)


def test_dit_params_from_jax_at_the_scaled_width():
    """The weight bridge at d_model 512, 8 heads, mlp x4 (depth cut to 2
    for CPU time): every tensor maps with the port's shape, and the eager
    model and the split forward reproduce flax apply."""
    jd, jp, td, args = _dit_pair(latent_len=8, latent_dim=64, d_model=512,
                                 depth=2, num_heads=8, mlp_ratio=4.0)
    sd = dit_params_from_jax(_np_tree(jp))
    assert sd.keys() == td.state_dict().keys()
    assert tuple(sd["layers.1.attn.qkv.weight"].shape) == (1536, 512)
    assert tuple(sd["layers.1.mlp.fc1.weight"].shape) == (2048, 512)
    assert tuple(sd["layers.0.adaLN_modulation.1.weight"].shape) == (3072,
                                                                     512)
    T = lambda v: torch.from_numpy(np.array(v))
    want = np.asarray(jd.apply(jp, *args))
    with torch.no_grad():
        for got in (td(*map(T, args)),
                    dit_fast.split_dit_forward(td, *map(T, args))):
            np.testing.assert_allclose(got.numpy(), want, rtol=5e-4,
                                       atol=5e-5)


def test_lavae_at_latent_grid_64_matches_jax():
    """The scaled path's LA-VAE (latent 64 x 64) through the weight
    bridge: encode and decode agree with JAX at the LA-VAE tests' bound."""
    jv = JLAVAE(in_channels=1, latent_grid=64)
    x = np.random.default_rng(2).standard_normal((2, 96)).astype(np.float32)
    jp = jv.init(jax.random.key(1), jnp.asarray(x))
    tv = LAVAE(in_channels=1, latent_grid=64, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(jp)))
    jz, _ = jv.apply(jp, jnp.asarray(x), method=jv.encode)
    jx, _ = jv.apply(jp, jz, 96, method=jv.decode)
    with torch.no_grad():
        tz, _ = tv.encode(torch.from_numpy(x))
        tx, _ = tv.decode(torch.from_numpy(np.array(jz)), 96)
    assert tuple(tz.shape) == (2, 64, 64)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=5e-4,
                               atol=5e-5)


def test_serving_sampler_at_the_scaled_latent_matches_jax():
    """make_serving_sampler with latent_shape=(64, 64) (1024 tokens, a
    narrow DiT for CPU time) against the JAX serving sampler on the same
    injected noise; the engine derives that latent shape from the VAE."""
    jv = JLAVAE(in_channels=1, latent_grid=64, num_hiddens=16,
                num_residual_hiddens=16)
    vp = jv.init(jax.random.key(1), jnp.zeros((1, 96)))
    tv = LAVAE(1, 16, 2, 16, 64, 64, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    jd, dp, td, _ = _dit_pair(latent_len=64, latent_dim=64, d_model=64,
                              depth=1, num_heads=2)
    seeds = jnp.array([3, 4], dtype=jnp.uint32)
    cfg = jnp.array([7.0, 3.0], dtype=jnp.float32)
    emb = jax.random.normal(jax.random.key(6), (2, 64))
    lat = (64, 64)
    want = np.asarray(j_make_serving_sampler(jd, jv, "flowmatching", 2, lat,
                                             96)(dp, vp, seeds, cfg, emb))
    x_t0 = np.array(jax.vmap(lambda k: jax.random.normal(
        jax.random.key(k), lat, jnp.float32))(seeds))
    got = make_serving_sampler(td, tv, "flowmatching", 2, lat, 96,
                               device="cpu")(
        np.array(seeds), np.array(cfg), np.array(emb),
        x_t0=torch.from_numpy(x_t0)).numpy()
    assert got.shape == (2, 96)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    with ServingEngine(td, tv, total_step=1, out_lengths=(96,),
                       batch_tiers=(1,), text_emb_dim=64,
                       device="cpu") as eng:
        assert eng._latent[96] == lat
