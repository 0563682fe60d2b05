"""Port models held to the JAX package on the CPU through the weight
bridge (``t2ms_tpu_torch.convert``): LA-VAE encode/decode at the flagship
configuration, the eager DiT against ``DiT.apply``, the fused forward
(plain twin on CPU) against the JAX ``fast_dit_forward`` in interpret
mode, rectified-flow math, and the JAX tree -> port state_dict ->
``tools/import_torch_ckpt.py`` -> JAX tree round trip.

Tolerances: f32 rtol 5e-4 / atol 5e-5 for whole models (the JAX fast
forward's own pin against DiT.apply); bf16 atol 3e-2 * max|ref| plus
correlation >= 0.999 with the f32 result."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.models.backbones import rectified_flow as jrf
from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.denoisers.dit import time_embedding as j_time_emb
from t2ms_tpu.models.denoisers.dit_fast import fast_dit_forward as j_fast
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.models.vae.lavae import lavae_loss as j_lavae_loss
from t2ms_tpu_torch.convert import dit_params_from_jax, lavae_params_from_jax
from t2ms_tpu_torch.models.backbones import rectified_flow as trf
from t2ms_tpu_torch.models.denoisers import DiT
from t2ms_tpu_torch.models.denoisers.dit import (sinusoidal_positions,
                                                 time_embedding)
from t2ms_tpu_torch.models.denoisers.dit_fast import (_stacked_weights,
                                                      fast_dit_forward,
                                                      fused_path_eligible)
from t2ms_tpu_torch.models.vae import LAVAE, lavae_loss

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import tools.import_torch_ckpt as ckpt  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturbed(params, seed=3, scale=0.02):
    """adaLN-zero init hides faults (every gate 0): move every leaf."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        p + scale * jax.random.normal(k, p.shape)
        for p, k in zip(leaves, keys)])


# ------------------------------------------------------------------ LA-VAE

def _vae_pair(exact=False, in_ch=1):
    jv = JLAVAE(in_channels=in_ch, latent_grid=30, exact_length_output=exact)
    x = jax.random.normal(jax.random.key(0), (2, 96) if in_ch == 1
                          else (2, in_ch, 96))
    jp = jv.init(jax.random.key(1), x)
    tv = LAVAE(in_channels=in_ch, latent_grid=30, exact_length_output=exact,
               device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(jp)))
    return jv, jp, tv


@pytest.mark.parametrize("length", [24, 48, 96])
def test_lavae_encode_decode_match_jax(length):
    jv, jp, tv = _vae_pair()
    x = np.random.default_rng(length).standard_normal((3, length)).astype(
        np.float32)
    jz, jb = jv.apply(jp, jnp.asarray(x), method=jv.encode)
    with torch.no_grad():
        tz, tb = tv.encode(torch.from_numpy(x))
    assert tuple(tz.shape) == (3, 64, 30)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=5e-4,
                               atol=5e-5)
    jx, ja = jv.apply(jp, jz, length, method=jv.decode)
    with torch.no_grad():
        tx, ta = tv.decode(_t(jz), length)
    assert tuple(tx.shape) == (3, length)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=5e-4,
                               atol=5e-5)


def test_lavae_exact_length_multivariate_matches_jax():
    jv, jp, tv = _vae_pair(exact=True, in_ch=3)
    x = np.random.default_rng(5).standard_normal((2, 3, 50)).astype(
        np.float32)
    jr, jz, jb, ja = jv.apply(jp, jnp.asarray(x))
    with torch.no_grad():
        tr, tz, tb, ta = tv(torch.from_numpy(x))
    assert tuple(tr.shape) == (2, 3, 50)          # exact length, 50 % 4 != 0
    for t, j in ((tr, jr), (tz, jz), (tb, jb), (ta, ja)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-4,
                                   atol=5e-5)


def test_lavae_loss_matches_jax():
    jv, jp, tv = _vae_pair()
    x = np.random.default_rng(6).standard_normal((4, 48)).astype(np.float32)
    jl, (jre, _, _) = j_lavae_loss(jv, jp, jnp.asarray(x))
    with torch.no_grad():
        tl, (tre, _, _) = lavae_loss(tv, torch.from_numpy(x))
        tl3, _ = lavae_loss(tv, torch.from_numpy(x)[:, None, :])
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
    np.testing.assert_allclose(float(tre), float(jre), rtol=2e-4)
    np.testing.assert_allclose(float(tl3), float(jl), rtol=2e-4)


def test_lavae_state_dict_names_follow_reference():
    keys = set(LAVAE(device="cpu").state_dict())
    for k in ("encoder._conv_1.weight", "encoder._pre_vq_conv.bias",
              "encoder._residual_stack._layers.1._block.1.weight",
              "encoder._residual_stack._layers.0._block.3.weight",
              "decoder._conv_1.weight", "decoder._conv_trans_2.bias"):
        assert k in keys, k


# -------------------------------------------------------------------- DiT

def _dit_pair(dtype="float32", depth=4, **geom):
    geom = dict(dict(latent_len=30, latent_dim=64), **geom)
    jd = JDiT(compute_dtype=jnp.dtype(dtype), depth=depth, **geom)
    B = 3
    x = jax.random.normal(jax.random.key(0), (B, geom["latent_dim"],
                                              geom["latent_len"]))
    t = jnp.array([0.1, 0.5, 0.9])
    emb = jax.random.normal(jax.random.key(1), (B, jd.d_model))
    jp = _perturbed(jd.init(jax.random.key(2), x, t, emb))
    td = DiT(compute_dtype=getattr(torch, dtype), depth=depth, device="cpu",
             **geom)
    td.load_state_dict(dit_params_from_jax(_np_tree(jp)))
    return jd, jp, td, (x, t, emb, jnp.array([0.0, 1.0, 1.0]))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("text", ["none", "emb", "emb+mask"])
def test_dit_matches_jax_apply_f32(text):
    jd, jp, td, (x, t, emb, mask) = _dit_pair()
    args = {"none": (), "emb": (emb,), "emb+mask": (emb, mask)}[text]
    want = np.asarray(jd.apply(jp, x, t, *args))
    with torch.no_grad():
        got = td(_t(x), _t(t), *map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


def test_dit_matches_jax_apply_bf16():
    jd, jp, td, (x, t, emb, mask) = _dit_pair("bfloat16")
    _, _, td32, _ = _dit_pair("float32")
    want = np.asarray(jd.apply(jp, x, t, emb, mask))
    with torch.no_grad():
        got = td(_t(x), _t(t), _t(emb), _t(mask)).numpy()
        f32 = td32(_t(x), _t(t), _t(emb), _t(mask)).numpy()
    assert got.dtype == np.float32                 # returns x's dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    assert np.corrcoef(got.ravel(), f32.ravel())[0, 1] >= 0.999


def test_time_embedding_and_positions_match_jax():
    import t2ms_tpu.models.denoisers.dit as jdit
    t = np.array([0.0, 0.013, 0.5, 0.99, 1.0], np.float32)
    for dim in (32, 128):
        # sin/cos of the same f32 angles, from two math libraries
        np.testing.assert_allclose(time_embedding(_t(t), dim).numpy(),
                                   np.asarray(j_time_emb(t, dim)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            sinusoidal_positions(480, dim).numpy(),
            np.asarray(jdit.sinusoidal_positions(480, dim)))


def test_dit_state_dict_names_follow_reference():
    keys = set(DiT(device="cpu").state_dict())
    for k in ("conv.weight", "conv.bias", "patch_emb.weight",
              "layers.3.attn.qkv.weight", "layers.0.attn.proj.bias",
              "layers.2.mlp.fc1.weight", "layers.1.mlp.fc2.bias",
              "layers.0.adaLN_modulation.1.weight", "ln.weight", "ln.bias",
              "linear_emb_to_patch.weight"):
        assert k in keys, k
    assert not any(k.startswith("pos") for k in keys)   # non-persistent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_forward_matches_jax_fast_forward(dtype):
    """The fused forward (plain stack twin on CPU) against the JAX
    fast_dit_forward (Pallas stack kernel in interpret mode)."""
    jd, jp, td, (x, t, emb, mask) = _dit_pair(dtype, depth=2)
    want = np.asarray(j_fast(jd, jp, x, t, emb, mask, interpret=True))
    with torch.no_grad():
        got = fast_dit_forward(td, _t(x), _t(t), _t(emb), _t(mask)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)
    else:
        want32 = np.asarray(j_fast(*_dit_pair("float32", depth=2)[:2],
                                   x, t, emb, mask, interpret=True))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())
        assert np.corrcoef(got.ravel(), want32.ravel())[0, 1] >= 0.999


def test_fast_forward_matches_eager_dit():
    _, _, td, (x, t, emb, mask) = _dit_pair(depth=2)
    with torch.no_grad():
        want = td(_t(x), _t(t), _t(emb), _t(mask)).numpy()
        got = fast_dit_forward(td, _t(x), _t(t), _t(emb), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


def test_stacked_weights_cached_per_parameter_version():
    td = DiT(latent_len=6, latent_dim=8, d_model=64, depth=2, num_heads=4,
             device="cpu")
    a = _stacked_weights(td, torch.float32)
    assert _stacked_weights(td, torch.float32) is a          # cached
    assert tuple(a[0].shape) == (2, 64, 192)                 # (L, in, out)
    torch.testing.assert_close(a[0][1], td.layers[1].attn.qkv.weight.t())
    with torch.no_grad():
        td.layers[1].mlp.fc2.bias.add_(1.0)                  # new version
    b = _stacked_weights(td, torch.float32)
    assert b is not a
    torch.testing.assert_close(b[7][1], td.layers[1].mlp.fc2.bias)
    assert _stacked_weights(td, torch.bfloat16)[0].dtype == torch.bfloat16


def test_fused_gates():
    """The gate looks at the model and the device only; the geometry is the
    kernel's to refuse (its limits: ``tests/test_torch_cuda.py``)."""
    td = DiT(device="cpu")
    x = torch.zeros(1, 64, 30)
    assert not fused_path_eligible(td, x.device)             # CPU tensor
    assert not fused_path_eligible(torch.nn.Identity(), x.device)  # no DiT
    assert not fused_path_eligible(
        DiT(attention_impl="einsum", device="cpu"), x.device)  # opt-out
    assert fused_path_eligible(td, "cuda")                   # the card


# --------------------------------------------------------- rectified flow

def test_rectified_flow_matches_jax():
    r = np.random.default_rng(9)
    x1 = r.standard_normal((4, 8, 6)).astype(np.float32)
    x0 = r.standard_normal((4, 8, 6)).astype(np.float32)
    u = r.uniform(size=(4,)).astype(np.float32)
    t = np.round(u * 100) / 100
    tt = trf.sample_t(4, 100, u=_t(u))
    np.testing.assert_allclose(tt.numpy(), t.astype(np.float32), rtol=1e-6)
    xt, x0_out = trf.create_flow(_t(x1), tt, x_0=_t(x0))
    want = np.asarray(jnp.asarray(t)[:, None, None] * x1
                      + (1 - jnp.asarray(t)[:, None, None]) * x0)
    np.testing.assert_allclose(xt.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(x0_out.numpy(), x0)
    v = r.standard_normal((4, 8, 6)).astype(np.float32)
    np.testing.assert_allclose(trf.euler(_t(x1), _t(v), 0.01).numpy(),
                               np.asarray(jrf.euler(x1, v, 0.01)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(trf.loss(_t(v), _t(x1 - x0))),
                               float(jrf.loss(v, x1 - x0)), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    drawn, noise = trf.create_flow(_t(x1), tt, generator=g)
    assert noise.shape == x1.shape and torch.isfinite(drawn).all()


# -------------------------------------------------------------- round trip

def test_weight_round_trip_through_import_tool():
    """JAX tree -> convert.py -> port state_dict -> import_torch_ckpt ->
    the same JAX tree (DiT and LA-VAE)."""
    _, jp, td, _ = _dit_pair(depth=2)
    sd = {k: v.numpy() for k, v in td.state_dict().items()}
    back = ckpt.dit_params_from_state_dict(sd, depth=2)
    want = _np_tree(jp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, want)

    _, vp, tv = _vae_pair()
    sd = {k: v.numpy() for k, v in tv.state_dict().items()}
    back = ckpt.lavae_params_from_state_dict(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           _np_tree(vp))
