"""The port's MLP denoiser held to the JAX package on the CPU: the forward
against JAX ``MLPDenoiser.apply`` (depth 2, feat 64, latent 6; weights
carried by ``mlp_params_from_jax``) in f32 and bf16, with and without a
``text_mask``; mask 0 against the reference's text=None; the fused CFG
forward against the two-pass one; the flow-matching loss and every
parameter's gradient against ``jax.grad`` on injected draws; the train
step's loss against JAX's on the same draws; the serving sampler against
JAX's on injected noise; a reference ``.pth`` (unused keys included)
loaded with ``load_reference_state_dict`` against
``tools/import_torch_ckpt.py``'s import; the routes (the MLP runs eager
on CUDA too, as in JAX); and ``--denoiser MLP`` through ``cli.train`` and
``cli.infer``, with infer's geometry check of a reference MLP checkpoint.

Tolerances: f32 forward 1e-5 of max|ref|; the other f32 outputs and the
samplers rtol 2e-4 / atol 2e-5 of the values (the serving tests' bound);
f32 loss rtol 1e-5 and gradients 1e-5 of each tensor's max (at least
1e-6 of the largest gradient); the train step's loss rtol 1e-5; bf16
forward 1e-2 of max|ref| (the MLP runs the same rounding points as flax,
so the two agree to a few bf16 ulps).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from t2ms_tpu.models.denoisers import MLPDenoiser as JMLP
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.sampling.sampler import _fused_cfg_forward as j_fused_cfg
from t2ms_tpu.serving import make_serving_sampler as j_make_serving_sampler
from t2ms_tpu_torch.cli import infer as tinfer
from t2ms_tpu_torch.cli import train as ttrain
from t2ms_tpu_torch.cli._common import DENOISER_CHOICES, build_denoiser
from t2ms_tpu_torch.convert import lavae_params_from_jax, mlp_params_from_jax
from t2ms_tpu_torch.data.synthetic import write_t2s_csv
from t2ms_tpu_torch.models.denoisers import DiT, MLPDenoiser
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.sampling.sampler import (_fused_cfg_forward,
                                             _serving_forward)
from t2ms_tpu_torch.serving import make_serving_sampler
from t2ms_tpu_torch.training import make_denoiser_train_step, onecycle_adamw
from t2ms_tpu_torch.training import trainer as ttrainer
from t2ms_tpu_torch.training.checkpoints import load_reference_state_dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import tools.import_torch_ckpt as ckpt_tool  # noqa: E402

L, FEAT, TEXT = 6, 64, 128
# params do not depend on the compute dtype: one compiled init serves all
_J_INIT = jax.jit(JMLP(feat_dim=FEAT, latent_len=L, depth=2).init)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _pair(dtype="float32", seed=0):
    """JAX and port MLPs (depth 2) with the same weights, every parameter
    moved off its init so the masked branch is visible."""
    jm = JMLP(feat_dim=FEAT, latent_len=L, depth=2,
              compute_dtype=jnp.dtype(dtype))
    jp = _J_INIT(jax.random.key(seed), jnp.zeros((2, FEAT, L)),
                 jnp.zeros(2), jnp.zeros((2, TEXT)))
    r = np.random.default_rng(seed + 100)
    jp = jax.tree_util.tree_map(
        lambda p: p + 0.05 * r.standard_normal(p.shape).astype(np.float32),
        _np_tree(jp))
    tm = MLPDenoiser(FEAT, L, depth=2,
                     compute_dtype=getattr(torch, dtype), device="cpu")
    tm.load_state_dict(mlp_params_from_jax(_np_tree(jp)))
    return jm, jp, tm


def _inputs(B=3, seed=1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, FEAT, L)).astype(np.float32),
            r.uniform(size=B).astype(np.float32),
            r.standard_normal((B, TEXT)).astype(np.float32),
            (np.arange(B) % 2).astype(np.float32))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("text", ["none", "emb", "emb+mask"])
def test_forward_matches_jax(dtype, text):
    jm, jp, tm = _pair(dtype)
    x, t, e, m = _inputs()
    e = None if text == "none" else e
    m = m if text == "emb+mask" else None
    want = np.asarray(jm.apply(jp, x, t, e, m)).astype(np.float32)
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(e), _t(m)).float().numpy()
    err = np.abs(got - want).max()
    assert err <= (1e-5 if dtype == "float32" else 1e-2) * np.abs(
        want).max(), err
    assert got.shape == x.shape


def test_uncond_mask_equals_text_none():
    """mask 0 reproduces text=None bit for bit (the whole cross-attention
    residual is dropped, biases included) and equals JAX's text=None; a
    zero embedding does not."""
    jm, jp, tm = _pair()
    x, t, e, _ = _inputs()
    with torch.no_grad():
        masked = tm(_t(x), _t(t), _t(e), torch.zeros(3)).numpy()
        none = tm(_t(x), _t(t)).numpy()
        zero = tm(_t(x), _t(t), torch.zeros(3, TEXT)).numpy()
    np.testing.assert_array_equal(masked, none)
    np.testing.assert_allclose(none, np.asarray(jm.apply(jp, x, t, None)),
                               rtol=2e-4, atol=2e-5)
    assert np.abs(zero - none).max() > 1e-3


def test_fused_cfg_matches_two_pass_and_jax():
    jm, jp, tm = _pair(seed=2)
    x, _, e, _ = _inputs(B=4, seed=2)
    t = np.full((4,), 0.3, np.float32)
    with torch.no_grad():
        fused = _fused_cfg_forward(tm, _t(x), _t(t), _t(e), 7.0).numpy()
        uncond, cond = tm(_t(x), _t(t)), tm(_t(x), _t(t), _t(e))
    two_pass = (uncond + 7.0 * (cond - uncond)).numpy()
    np.testing.assert_allclose(fused, two_pass, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax.jit(lambda *a: j_fused_cfg(jm, *a, 7.0))(
        jp, x, t, e))
    np.testing.assert_allclose(fused, want, rtol=2e-4, atol=2e-4)


def test_loss_and_every_gradient_match_jax():
    """The flow-matching loss at t = round(u * 100) / 100 on injected u and
    noise, the uncond half masked, and its gradient for every parameter."""
    jm, jp, tm = _pair(seed=3)
    z, _, e, m = _inputs(B=4, seed=3)
    r = np.random.default_rng(4)
    u = r.uniform(size=4).astype(np.float32)
    x_0 = r.standard_normal(z.shape).astype(np.float32)
    t = np.round(u * 100) / 100

    def j_loss(params):
        tt = jnp.asarray(t)[:, None, None]
        x_t = tt * z + (1.0 - tt) * x_0
        pred = jm.apply(params, x_t, jnp.asarray(t), e, m)
        return jnp.mean(jnp.square(pred - (z - x_0)))

    jl, jg = jax.jit(jax.value_and_grad(j_loss))(jp)
    from t2ms_tpu_torch.models.backbones import rectified_flow as trf
    tt = trf.sample_t(4, 100, u=_t(u))
    x_t, noise = trf.create_flow(_t(z), tt, x_0=_t(x_0))
    loss = trf.loss(tm(x_t, tt, _t(e), _t(m)), _t(z) - noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = mlp_params_from_jax(_np_tree(jg))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    gmax = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        # some gradients are 0 up to rounding: key's (the text tokens
        # repeat one embedding, so the softmax is uniform) and the
        # token-axis output bias of a layer before another (a per-token
        # constant that the next LayerNorm removes); their floor is 1e-6
        # of the largest gradient
        tol = max(1e-5 * np.abs(w).max(), 1e-6 * gmax)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)


def test_train_step_loss_matches_jax():
    """The port's denoiser train step on an MLP (the port's LA-VAE encode
    inside, the draws injected, the CFG coin keeping the text) against the
    JAX flow-matching loss on the same latents and draws; then a dropped
    coin masks every row, as JAX's step does."""
    torch.manual_seed(0)
    tv = LAVAE(1, 16, 2, 16, FEAT, L, device="cpu")
    jm, jp, tm = _pair(seed=5)
    r = np.random.default_rng(6)
    x = r.standard_normal((4, 24)).astype(np.float32)
    e = r.standard_normal((4, TEXT)).astype(np.float32)
    u = r.uniform(size=4).astype(np.float32)
    with torch.no_grad():
        z = tv.encode(_t(x))[0].numpy()
    x_0 = r.standard_normal(z.shape).astype(np.float32)
    t = np.round(u * 10) / 10
    x_t = t[:, None, None] * z + (1.0 - t[:, None, None]) * x_0
    tstep = make_denoiser_train_step(tm, tv, onecycle_adamw(
        tm.parameters(), 2, 1e-3), total_step=10, device="cpu")
    for coin, mask in ((0.9, np.ones(4, np.float32)),
                       (0.1, np.zeros(4, np.float32))):
        want = np.mean(np.square(np.asarray(
            jax.jit(jm.apply)(jp, x_t, t, e, mask)) - (z - x_0)))
        got = tstep(_t(x), _t(e), u=_t(u), x_0=_t(x_0),
                    coin=torch.tensor(coin))
        np.testing.assert_allclose(got.item(), want, rtol=1e-5)
        # the next coin is scored against the same weights
        tm.load_state_dict(mlp_params_from_jax(_np_tree(jp)))


def test_serving_sampler_matches_jax():
    jv = JLAVAE(in_channels=1, latent_grid=L, num_hiddens=16,
                num_residual_hiddens=16, embedding_dim=FEAT)
    vp = jax.jit(jv.init)(jax.random.key(1), jnp.ones((2, 24)))
    tv = LAVAE(1, 16, 2, 16, FEAT, L, device="cpu")
    tv.load_state_dict(lavae_params_from_jax(_np_tree(vp)))
    jm, jp, tm = _pair(seed=7)
    seeds = jnp.array([3, 4, 5], dtype=jnp.uint32)
    cfg = jnp.array([1.0, 3.0, 7.0], dtype=jnp.float32)
    emb = jax.random.normal(jax.random.key(8), (3, TEXT))
    want = np.asarray(j_make_serving_sampler(jm, jv, "flowmatching", 3,
                                             (FEAT, L), 24)(
        jp, vp, seeds, cfg, emb))
    x_t0 = np.array(jax.vmap(lambda k: jax.random.normal(
        jax.random.key(k), (FEAT, L), jnp.float32))(seeds))
    got = make_serving_sampler(tm, tv, "flowmatching", 3, (FEAT, L), 24,
                               device="cpu")(
        np.array(seeds), np.array(cfg), np.array(emb),
        x_t0=_t(x_t0)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports CUDA (the routes key on the device)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda")


def test_mlp_runs_eager_on_every_route(monkeypatch):
    """The samplers and the train step hand the MLP to the eager module
    on CUDA as on the CPU (JAX runs ``denoiser.apply``): no DiT kernel
    route is asked."""
    from t2ms_tpu_torch.models.denoisers import dit_fast
    for name in ("fast_forward_supported", "split_forward_supported",
                 "flax_path_supported", "train_forward_supported"):
        monkeypatch.setattr(dit_fast, name, lambda d: pytest.fail(name))
    tm = MLPDenoiser(FEAT, L, depth=1, device="cpu")
    assert _serving_forward(tm, torch.device("cuda")) is tm
    x = torch.zeros(2, FEAT, L)
    fwd = ttrainer._training_forward(tm)
    with torch.no_grad():
        out = fwd(x.as_subclass(_FakeCuda), torch.zeros(2), None, None)
        torch.testing.assert_close(torch.Tensor(out), tm(x, torch.zeros(2)))


def _reference_state_dict(depth=2, seed=9):
    """A reference MLP state_dict (mlp.py:49-94): the keys the forward
    uses, at the port's names, and the unused ``norm1``, ``norm3``,
    ``pos_emb``, ``self_attn`` and ``self_attn2``."""
    torch.manual_seed(seed)
    sd = {}
    for i in range(depth):
        layer = MLPDenoiser(FEAT, L, depth=1, device="cpu").layers[0]
        dead = nn.ModuleDict(dict(
            norm1=nn.LayerNorm(FEAT), norm3=nn.LayerNorm(L),
            pos_emb=nn.Embedding(2 * L, FEAT),
            self_attn=nn.MultiheadAttention(FEAT, 4),
            self_attn2=nn.MultiheadAttention(L, 2)))
        for k, v in list(layer.state_dict().items()) + list(
                dead.state_dict().items()):
            sd[f"layers.{i}.{k}"] = v + 0.01 * torch.randn(v.shape)
    return sd


def test_reference_pth_loads_and_matches_the_jax_import(tmp_path):
    sd = _reference_state_dict()
    path = str(tmp_path / "mlp.pth")
    torch.save(sd, path)
    tm = MLPDenoiser(FEAT, L, depth=2, device="cpu")
    load_reference_state_dict(tm, path)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    params = ckpt_tool.mlp_params_from_state_dict(
        ckpt_tool.load_torch_file(path), depth=2)
    x, t, e, m = _inputs(seed=10)
    want = np.asarray(JMLP(feat_dim=FEAT, latent_len=L, depth=2).apply(
        params, x, t, e, m))
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(e), _t(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # and the bridge inverts the import tool
    back = mlp_params_from_jax(params)
    assert set(back) == set(tm.state_dict())
    for k, v in back.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_reference_names_init_and_layer_norm():
    tm = build_denoiser("MLP", latent_len=30, latent_dim=FEAT,
                        device="cpu")
    assert "MLP" in DENOISER_CHOICES and tm.latent_len == 30
    assert tm.depth == 8 and tm.hidden == 256 and tm.n_head == 4
    names = set(tm.state_dict())
    assert len(names) == 8 * 18
    for n in ("cross_attn.key.weight", "cross_attn.query.bias",
              "cross_attn.value.weight", "cross_attn.proj.bias",
              "norm2.weight", "mlp.0.weight", "mlp.2.bias",
              "mlp2.0.weight", "mlp2.2.bias"):
        assert f"layers.7.{n}" in names
    assert tuple(tm.layers[0].mlp2[0].weight.shape) == (256, 30)
    assert tm.layers[0].norm2.eps == 1e-6          # flax's default
    # torch's default Linear init: U(+-1/sqrt(fan_in)) weights and biases
    for lin in (tm.layers[0].cross_attn.key, tm.layers[0].mlp2[2]):
        bound = lin.in_features ** -0.5
        for p in (lin.weight, lin.bias):
            assert p.abs().max() <= bound and p.abs().max() > 0.5 * bound


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = tmp_path_factory.mktemp("mlp_corpus") / "Data"
    for n in (24, 48, 96):
        write_t2s_csv(str(data / "TSFragment-600K" /
                          f"embedding_cleaned_ETTh1_{n}.csv"),
                      n=20, T=n, seed=n)
    write_t2s_csv(str(data / "our" / "embedding_cleaned_ETTh1_24.csv"),
                  n=200, T=24, seed=24)
    return data


def test_cli_train_and_infer_take_denoiser_mlp(tmp_path, corpus,
                                               monkeypatch):
    """``--denoiser MLP`` through cli.train (one epoch) and cli.infer on
    its ``model_0``: the JAX CLIs' files under the MLP's paths."""
    os.symlink(corpus, tmp_path / "Data")
    monkeypatch.chdir(tmp_path)
    ttrain.main(["--dataset_name", "ETTh1", "--batch_size", "10",
                 "--epochs", "1", "--total_step", "4", "--save_every", "1",
                 "--denoiser", "MLP"], device="cpu")
    ck = tmp_path / "results/denoiser_results/checkpoints/" \
                    "flowmatching_MLP_ETTh1"
    assert (ck / "model_0").exists()
    tinfer.main(["--dataset_name", "ETTh1_24", "--total_step", "4",
                 "--checkpoint_id", "0", "--denoiser", "MLP",
                 "--max_batches", "1"], device="cpu")
    gen = tmp_path / "results/denoiser_results/generation/" \
                     "flowmatching_MLP_ETTh1_24_7_4"
    x_t = np.load(gen / "x_t.npy")
    assert x_t.shape == (2, 24, 1) and np.isfinite(x_t).all()
    lat = np.load(gen / "x_t_latent_dec_array.npy")
    assert lat.shape == (2, FEAT, 30)


def test_infer_refuses_a_mismatched_reference_mlp(tmp_path, corpus,
                                                  monkeypatch):
    """A reference MLP checkpoint at latent length 6 beside the VAE's grid
    of 30 raises with JAX's wording; at --latent_grid 6 it loads."""
    os.symlink(corpus, tmp_path / "Data")
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "ref_mlp.pth")
    sd = _reference_state_dict(depth=8)
    torch.save(sd, path)
    args = ["--dataset_name", "ETTh1_24", "--denoiser", "MLP",
            "--checkpoint_file", path, "--total_step", "2",
            "--max_batches", "1"]
    with pytest.raises(ValueError, match="imported reference MLP expects "
                                         "latent length 6 but the VAE "
                                         "produces 30"):
        tinfer.main(args, device="cpu")
    a = tinfer.get_args(args + ["--latent_grid", "6"])
    vae, mlp = tinfer.load_models(a, torch.device("cpu"), 24)
    assert isinstance(mlp, MLPDenoiser) and mlp.latent_len == 6
    torch.testing.assert_close(mlp.layers[7].mlp2[0].weight,
                               sd["layers.7.mlp2.0.weight"])
    # a DiT is built as before
    assert isinstance(tinfer.load_models(
        tinfer.get_args(["--dataset_name", "ETTh1_24"]),
        torch.device("cpu"), 24)[1], DiT)
