"""The port's TSae held to the JAX package on the CPU (f32, flow_dim 16, 2
heads, 1 + 1 layers, T <= 24): every method within 1e-5 relative through
``tsae_params_from_jax``; ``tsae_loss`` and its gradients within 1e-4, in
eval mode and in train mode with the same dropout masks injected into both
(flax's ``Dropout`` patched in this test to read them by module path, the
names the port's sites carry); ``TSaeDiffusion``'s encode, its decode that
ignores ``length``, ``tsae_adapter_loss`` and its state_dict; the adapter
through the port's train step and sampler; and the motion conv VAE through
``lavae_params_from_jax`` at 10 and 7 channels."""

import argparse
import functools
import zlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from t2ms_tpu.cli._common import build_motion_vae as j_build_motion_vae
from t2ms_tpu.models.vae.tsae import TSae as JTSae
from t2ms_tpu.models.vae.tsae import TSaeDiffusion as JTSaeDiffusion
from t2ms_tpu.models.vae.tsae import tsae_adapter_loss as j_adapter_loss
from t2ms_tpu.models.vae.tsae import tsae_loss as j_tsae_loss
from t2ms_tpu_torch.cli._common import build_motion_vae
from t2ms_tpu_torch.convert import lavae_params_from_jax, tsae_params_from_jax
from t2ms_tpu_torch.models.denoisers import DiT
from t2ms_tpu_torch.models.vae import (DropoutDraws, TSae, TSaeDiffusion,
                                       tsae_adapter_loss, tsae_loss)
from t2ms_tpu_torch.sampling import make_cfg_sampler
from t2ms_tpu_torch.training import make_denoiser_train_step, onecycle_adamw

NF, FLOW, HEADS, DFF = 5, 16, 2, 32
KW = dict(n_features=NF, flow_dim=FLOW, num_encoder_layers=1,
          num_decoder_layers=1, d_ff=DFF, num_heads=HEADS)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _apply(module, params, *args, **kw):
    """``module.apply`` compiled once (eager flax compiles op by op)."""
    return jax.jit(functools.partial(module.apply, **kw))(params, *args)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def pair():
    """The flax TSae and the port's, on the same weights (the flax init
    moved off its zero biases and unit LayerNorm scales)."""
    jm = JTSae(**KW)
    jp = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, 6, NF)),
                          jnp.zeros((2, 128)))
    leaves, tdef = jax.tree_util.tree_flatten(jp)
    keys = jax.random.split(jax.random.key(1), len(leaves))
    jp = jax.tree_util.tree_unflatten(tdef, [
        p + 0.05 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
    tm = TSae(**KW, device="cpu")
    tm.load_state_dict(tsae_params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _data(T, B=3, seed=0):
    r = np.random.default_rng(seed + T)
    return (r.standard_normal((B, T, NF)).astype(np.float32),
            r.standard_normal((B, 128)).astype(np.float32))


@pytest.fixture
def masks(monkeypatch):
    """flax's Dropout reading its keep mask from a dict by module path
    (drawn once per path with numpy); the port's DropoutDraws reads the
    same dict and records the sites it met."""
    table = {}

    def patched(self, inputs, deterministic=None, rng=None):
        det = self.deterministic if deterministic is None else deterministic
        if det or self.rate == 0.0:
            return inputs
        name = "/".join(self.path)
        if name not in table:
            r = np.random.default_rng(zlib.crc32(name.encode()))
            table[name] = r.random(inputs.shape) < 1.0 - self.rate
        keep = jnp.asarray(table[name])
        return lax.select(keep, inputs / (1.0 - self.rate),
                          jnp.zeros_like(inputs))

    monkeypatch.setattr(nn.Dropout, "__call__", patched)

    class Recorded(DropoutDraws):
        met = set()

        def __call__(self, name, x):
            Recorded.met.add(name)
            return super().__call__(name, x)

    def draws():
        return Recorded(0.1, {k: torch.from_numpy(v)
                              for k, v in table.items()})

    draws.table, draws.met = table, Recorded.met
    return draws


_METHODS = {
    "__call__": (lambda m, x, e: (x, e), None),
    "encode": (lambda m, x, e: (x,), "encode"),
    "reconstruct_teacher_forced": (lambda m, x, e: (x,),
                                   "reconstruct_teacher_forced"),
    "reconstruct_autoregressive": (lambda m, x, e: (x,),
                                   "reconstruct_autoregressive"),
}


@pytest.mark.parametrize("T", [12, 24])
@pytest.mark.parametrize("name", sorted(_METHODS))
def test_methods_match_jax(pair, name, T):
    jm, jp, tm = pair
    x, e = _data(T)
    args, method = _METHODS[name]
    want = _apply(jm, jp, *args(jm, x, e), method=(
        None if method is None else getattr(jm, method)))
    with torch.no_grad():
        fn = tm if method is None else getattr(tm, method)
        got = fn(*(torch.from_numpy(a) for a in args(tm, x, e)))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("T", [12, 24])
def test_fuse_condition_decode_and_generate_match_jax(pair, T):
    """The pieces on JAX's own memory: the fusion + AdaLN, the
    teacher-forced decoder and the autoregressive generator."""
    jm, jp, tm = pair
    x, e = _data(T)
    mem = np.array(_apply(jm, jp, x, method=jm.encode))
    tgt = _data(T, seed=7)[0]
    cases = (("fuse_condition", (mem, e)), ("decode_teacher_forced",
                                            (mem, tgt)), ("generate", (mem,)))
    for name, args in cases:
        want = _apply(jm, jp, *args, method=getattr(jm, name))
        with torch.no_grad():
            got = getattr(tm, name)(*(torch.from_numpy(a) for a in args))
        assert _rel(got.numpy(), want) <= 1e-5, name


@pytest.mark.parametrize("train", [False, True])
def test_loss_and_grads_match_jax(pair, masks, train):
    """tsae_loss and every parameter's gradient (mapped by the params'
    rules) within 1e-4, without dropout and with the same masks."""
    jm, jp, tm = pair
    x, _ = _data(16)
    key = jax.random.key(3) if train else None
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: j_tsae_loss(jm, p, jnp.asarray(x), dropout_key=key),
        has_aux=True))(jp)
    tm.zero_grad()
    tl, _ = tsae_loss(tm, torch.from_numpy(x), masks() if train else None)
    tl.backward()
    if train:
        assert masks.met == set(masks.table) and len(masks.table) == 13
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    want = tsae_params_from_jax(_np_tree(jg))
    scale = max(np.abs(w.numpy()).max() for w in want.values())
    for n, p in tm.named_parameters():
        if n.startswith(("text_projection", "condition_projection",
                         "fusion_", "ada_ln")):
            assert p.grad is None, n        # the unconditioned path
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=n)


def test_conditional_forward_with_dropout_matches_jax(pair, masks):
    """TSae.__call__ in train mode: all 14 dropout sites, the fusion MLP's
    among them, with the same masks."""
    jm, jp, tm = pair
    x, e = _data(12)
    want = _apply(jm, jp, x, e, train=True,
                  rngs={"dropout": jax.random.key(4)})
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(e), masks())
    assert masks.met == set(masks.table) and len(masks.table) == 14
    assert _rel(got.numpy(), want) <= 1e-5


def test_dropout_draws_from_a_generator():
    x = torch.ones(64, 64)
    g = lambda: torch.Generator().manual_seed(5)
    a = DropoutDraws(0.1, generator=g())("s", x)
    b = DropoutDraws(0.1, generator=g())("s", x)
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.85 < kept.float().mean().item() < 0.95
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.9))
    assert torch.equal(DropoutDraws(0.0)("s", x), x)
    with pytest.raises(ValueError, match="dropout mask s"):
        DropoutDraws(0.1, {"s": torch.ones(3, dtype=torch.bool)})("s", x)


def test_teacher_forced_decoder_is_causal(pair):
    _, _, tm = pair
    x, _ = _data(12)
    with torch.no_grad():
        mem = tm.encode(torch.from_numpy(x))
        tgt = torch.from_numpy(_data(12, seed=3)[0])
        a = tm.decode_teacher_forced(mem, tgt)
        tgt[:, -1] += 100.0
        b = tm.decode_teacher_forced(mem, tgt)
        ar = tm.generate(mem)
        tf = tm.decode_teacher_forced(mem, torch.from_numpy(x))
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=1e-5)
    # with the same zero BOS, AR step 0 is teacher-forced step 0
    torch.testing.assert_close(ar[:, 0], tf[:, 0], rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ the adapter

@pytest.fixture(scope="module")
def adapter():
    jv = JTSaeDiffusion(**KW)
    x = np.random.default_rng(1).standard_normal((4, NF, 16)).astype(
        np.float32)
    jp = jax.jit(jv.init)(jax.random.key(0), jnp.asarray(x))
    tv = TSaeDiffusion(**KW, device="cpu")
    tv.load_state_dict(tsae_params_from_jax(_np_tree(jp)))
    return jv, jp, tv, x


def test_adapter_encode_and_decode_match_jax(adapter):
    jv, jp, tv, x = adapter
    jz, jmem = jv.apply(jp, jnp.asarray(x), method=jv.encode)
    with torch.no_grad():
        z, mem = tv.encode(torch.from_numpy(x))
        # decode ignores ``length`` as the JAX adapter does: the output is
        # as long as the latent, whatever length asks for
        out, after = tv.decode(z, 16 + 5)
    jout, _ = jv.apply(jp, jz, 16 + 5, method=jv.decode)
    assert z.shape == (4, FLOW, 16) and out.shape == x.shape
    assert _rel(z.numpy(), jz) <= 1e-5 and _rel(mem.numpy(), jmem) <= 1e-5
    assert _rel(out.numpy(), jout) <= 1e-5
    assert torch.equal(after, z.transpose(1, 2))


def test_adapter_loss_matches_jax(adapter, masks):
    jv, jp, tv, x = adapter
    for drop in (None, masks):
        key = None if drop is None else jax.random.key(2)
        jl, (_, jrec) = j_adapter_loss(jv, jp, jnp.asarray(x),
                                       dropout_key=key)
        with torch.no_grad():
            tl, (_, rec) = tsae_adapter_loss(
                tv, torch.from_numpy(x), None if drop is None else drop())
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
        assert _rel(rec.numpy(), jrec) <= 1e-5


def test_adapter_state_dict_is_the_tsae_own(adapter):
    _, _, tv, _ = adapter
    base = TSae(**KW, device="cpu")
    assert list(tv.state_dict()) == list(base.state_dict())
    assert [n for n, _ in tv.named_parameters()] == [
        n for n, _ in base.named_parameters()]
    assert tv.to("cpu") is tv and tv.eval() is tv


def test_adapter_feeds_the_train_step_and_the_sampler(adapter):
    """TSae latents through the port's denoiser train step (the weights
    move, the loss is finite) and the CFG sampler (finite series of the
    input's shape), as tests/test_tsae_diffusion.py drives JAX's."""
    _, _, tv, x = adapter
    torch.manual_seed(0)
    dit = DiT(latent_len=16, latent_dim=FLOW, d_model=32, depth=1,
              num_heads=2, device="cpu")
    before = [p.detach().clone() for p in dit.parameters()]
    step = make_denoiser_train_step(
        dit, tv, onecycle_adamw(dit.parameters(), 4, 1e-3), total_step=10,
        device="cpu")
    emb = torch.zeros(4, 32)
    loss = step(torch.from_numpy(x), emb,
                generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(loss)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, dit.parameters()))
    out = make_cfg_sampler(dit, tv, total_step=3, cfg_scale=2.0,
                           out_length=16, device="cpu")(
        x, emb, generator=torch.Generator().manual_seed(2))
    assert out.series.shape == x.shape
    assert torch.isfinite(out.series).all()


# ------------------------------------------------------------ conv VAE

@pytest.mark.parametrize("n_f,flow", [(10, 64), (7, 50)])
def test_motion_conv_vae_matches_jax(n_f, flow):
    """build_motion_vae (channels = input_dim, latent grid = flow_dim,
    exact-length decode) through lavae_params_from_jax, at the two
    sports' channel counts, narrow hidden widths."""
    args = argparse.Namespace(input_dim=n_f, flow_dim=flow,
                              block_hidden_size=16, num_residual_layers=2,
                              res_hidden_size=16, embedding_dim=8)
    jv = j_build_motion_vae(args)
    jp = jax.jit(jv.init)(jax.random.key(0), jnp.zeros((2, n_f, 72)))
    tv = build_motion_vae(args, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(jp)))
    for T in (40, 100):
        x = np.random.default_rng(T).standard_normal((2, n_f, T)).astype(
            np.float32)
        want = _apply(jv, jp, jnp.asarray(x))
        with torch.no_grad():
            got = tv(torch.from_numpy(x))
        assert got[0].shape == (2, n_f, T) and got[1].shape == (2, 8, flow)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= 1e-5


def test_tsae_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSae(**KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSaeDiffusion(**KW)
