"""The port's TS2Vec (``t2ms_tpu_torch.evaluate.ts2vec``) held to the JAX
package's on the CPU at small widths: the encoder in eval mode and in
train mode with JAX's mask and dropout draws injected, from weights
mapped by ``ts2vec_params_from_jax``; the four contrastive losses and the
gradient of the exact one; a 5-iteration fit against JAX's fit (its host
draws and threefry keys captured by wrapping ``_fit_scan``); the
max_train_length split, centerize and all-NaN filter; encode, save/load,
the cumulative counters and the refusals.

Tolerances (f32): the encoder 1e-5 * max|ref|; the losses 1e-5
relative; step 1's gradients 1e-5 * max|grad| per tensor; the fit's
per-iteration losses 1e-5 relative; its parameters and SWA weights
atol 2 * lr * iterations (Adam's normalised first update turns a gradient
entry that differs by rounding near zero into a full +-lr step) with
rtol 1e-4, and at most 1% of entries beyond 1e-5; encode('full_series')
1e-4 * max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.evaluate import ts2vec as J
from t2ms_tpu_torch.convert import ts2vec_params_from_jax
from t2ms_tpu_torch.evaluate import ts2vec as P

CFG = dict(input_dims=2, output_dims=16, hidden_dims=8, depth=3)
DRAW_NAMES = ("mask1", "keep1", "mask2", "keep2")
# JAX calls run jitted: op by op, each op compiles on its own
_J_MASKED = jax.jit(J.hierarchical_contrastive_loss_masked)
_J_LOSS_GRAD = jax.jit(jax.grad(J.hierarchical_contrastive_loss,
                                argnums=(0, 1)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_encoder(T=24, depth=CFG["depth"]):
    enc = J.TSEncoder(CFG["input_dims"], CFG["output_dims"],
                      CFG["hidden_dims"], depth)
    params = jax.jit(enc.init)(jax.random.key(0), jnp.zeros((1, T, 2)))
    net = P.TSEncoder(CFG["input_dims"], CFG["output_dims"],
                      CFG["hidden_dims"], depth, device="cpu")
    net.load_state_dict(ts2vec_params_from_jax(_np_tree(params)))
    return enc, params, net


def _nan_padded(T, seed=0):
    x = np.random.default_rng(seed).standard_normal((3, T, 2)).astype(
        np.float32)
    x[1, T - 6:] = np.nan            # trailing padding
    x[2, :3] = np.nan                # leading padding
    x[0, 5, 1] = np.nan              # one missing value in a frame
    return x


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# depth 6 at T=24: dilations 32 and 64 reach past the series
@pytest.mark.parametrize("T,depth", [(24, 3), (24, 6), (96, 4)])
def test_encoder_eval_matches_jax(T, depth):
    enc, params, net = _jax_encoder(T, depth)
    x = _nan_padded(T)
    want = jax.jit(enc.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5)
    # padded positions stay exactly zero, as in JAX
    assert np.all(got.numpy()[1, T - 6:] == 0.0)


def test_encoder_train_matches_jax_with_injected_draws():
    enc, params, net = _jax_encoder()
    x = _nan_padded(24, seed=1)
    k1, k2 = jax.random.split(jax.random.key(3))
    want = jax.jit(lambda p, a: enc.apply(p, a, train=True, mask_rng=k1,
                                          dropout_rng=k2))(params,
                                                           jnp.asarray(x))
    mask = np.array(jax.random.bernoulli(k1, 0.5, (3, 24)))
    keep = np.array(jax.random.bernoulli(k2, 0.9, (3, 24, 16)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(mask),
                  torch.from_numpy(keep))
    _close(got.numpy(), want, 1e-5)


def _z(shape, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name,shape", [
    ("instance_contrastive_loss", (4, 6, 8)),
    ("instance_contrastive_loss", (1, 6, 8)),
    ("temporal_contrastive_loss", (3, 5, 8)),
    ("temporal_contrastive_loss", (3, 1, 8)),
    ("hierarchical_contrastive_loss", (4, 13, 8)),
    ("hierarchical_contrastive_loss", (1, 8, 8)),
])
def test_losses_match_jax(name, shape):
    z1, z2 = _z(shape, sum(shape))
    want = float(jax.jit(getattr(J, name))(jnp.asarray(z1),
                                           jnp.asarray(z2)))
    got = float(getattr(P, name)(torch.from_numpy(z1), torch.from_numpy(z2)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("crop_l", [2, 3, 5, 7, 8, 13, 24])
def test_masked_loss_matches_jax_and_the_exact_loss(crop_l):
    """Garbage beyond crop_l must not count: the masked loss equals JAX's
    masked loss and the port's exact loss on the first crop_l."""
    z1, z2 = _z((4, 24, 8), crop_l)
    z1[:, crop_l:] = 1e6
    z2[:, crop_l:] = -1e6
    want = float(_J_MASKED(jnp.asarray(z1), jnp.asarray(z2),
                           jnp.asarray(crop_l)))
    t1, t2 = torch.from_numpy(z1), torch.from_numpy(z2)
    got = float(P.hierarchical_contrastive_loss_masked(t1, t2, crop_l))
    exact = float(P.hierarchical_contrastive_loss(t1[:, :crop_l],
                                                  t2[:, :crop_l]))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    assert exact == pytest.approx(want, rel=1e-5, abs=1e-6)


def test_hierarchical_loss_gradient_matches_jax():
    z1, z2 = _z((4, 11, 8), 5)
    want = _J_LOSS_GRAD(jnp.asarray(z1), jnp.asarray(z2))
    t1 = torch.from_numpy(z1).requires_grad_()
    t2 = torch.from_numpy(z2).requires_grad_()
    P.hierarchical_contrastive_loss(t1, t2).backward()
    _close(t1.grad.numpy(), want[0], 1e-5)
    _close(t2.grad.numpy(), want[1], 1e-5)


def _capture_jax_fit(monkeypatch, data, n_iters, run=True, **kw):
    """JAX's fit with ``_fit_scan`` wrapped: its arguments (init params,
    the preprocessed data, the host draws, the keys) and, with ``run``,
    its outputs; without ``run`` nothing is compiled."""
    cap = {}
    real = J._fit_scan

    def spy(*args):
        cap["args"] = args
        if run:
            cap["out"] = real(*args)
            return cap["out"]
        return (args[3], args[4], args[5]), jnp.zeros((args[8].shape[0],))

    monkeypatch.setattr(J, "_fit_scan", spy)
    model = J.TS2Vec(**CFG, **kw)
    log = model.fit(data, n_iters=n_iters)
    names = ("idx", "w1_start", "w1_len", "s1", "w2_start", "w2_len",
             "crop_l")
    cap["geom"] = {k: np.asarray(v) for k, v in zip(names,
                                                     cap["args"][8:15])}
    cap["data"] = np.asarray(cap["args"][7])
    cap["params"] = _np_tree(cap["args"][3])
    return model, log, cap


def _jax_draws(keys, B, T, co):
    """Each iteration's four threefry draws, as JAX's fit makes them."""
    out = {k: [] for k in DRAW_NAMES}
    for key in keys:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        out["mask1"].append(np.asarray(jax.random.bernoulli(k1, 0.5,
                                                            (B, T))))
        out["keep1"].append(np.asarray(jax.random.bernoulli(k2, 0.9,
                                                            (B, T, co))))
        out["mask2"].append(np.asarray(jax.random.bernoulli(k3, 0.5,
                                                            (B, T))))
        out["keep2"].append(np.asarray(jax.random.bernoulli(k4, 0.9,
                                                            (B, T, co))))
    return {k: np.stack(v) for k, v in out.items()}


def _capture_port(monkeypatch, run=True):
    """The port's host draws, its preprocessed buffer and, with ``run``,
    its per-iteration losses; without ``run`` no iteration runs."""
    cap = {}
    real_draw, real_loop = P._draw_windows, P._fit_loop

    def draw(*a, **k):
        cap["geom"] = real_draw(*a, **k)
        return cap["geom"]

    def loop(*a, **k):
        cap["data"] = a[4].numpy()
        cap["losses"] = (real_loop(*a, **k) if run else
                         torch.zeros(len(a[5]["crop_l"])))
        return cap["losses"]

    monkeypatch.setattr(P, "_draw_windows", draw)
    monkeypatch.setattr(P, "_fit_loop", loop)
    return cap


def test_fit_matches_jax_with_injected_draws(monkeypatch):
    n_iters, lr = 5, 1e-3
    data = np.random.default_rng(1).standard_normal((10, 16, 2)).astype(
        np.float32)
    jm, jlog, jcap = _capture_jax_fit(monkeypatch, data, n_iters,
                                      batch_size=4, seed=7)
    B = jcap["geom"]["idx"].shape[1]
    draws = _jax_draws(jcap["args"][15], B, 16, CFG["output_dims"])

    # step 1's gradients, directly: the JAX step's loss_fn against the
    # port's exact loss on the same windows and draws
    g = {k: v[0] for k, v in jcap["geom"].items()}
    k1, k2, k3, k4 = jax.random.split(jcap["args"][15][0], 4)
    pos = jnp.arange(16)
    rows = jnp.asarray(data)[g["idx"]]

    def jwin(s, L):
        rolled = jax.vmap(lambda x, o: jnp.roll(x, -o, axis=0))(rows, s)
        return jnp.where((pos < L)[None, :, None], rolled, jnp.nan)

    def jloss(p):
        o1 = jm.encoder.apply(p, jwin(g["w1_start"], g["w1_len"]),
                              train=True, mask_rng=k1, dropout_rng=k2)
        o2 = jm.encoder.apply(p, jwin(g["w2_start"], g["w2_len"]),
                              train=True, mask_rng=k3, dropout_rng=k4)
        return J.hierarchical_contrastive_loss_masked(
            jnp.roll(o1, -g["s1"], axis=1), o2, g["crop_l"])

    jgrad = ts2vec_params_from_jax(_np_tree(
        jax.jit(jax.grad(jloss))(jcap["args"][3])))
    net = P.TSEncoder(**CFG, device="cpu")
    net.load_state_dict(ts2vec_params_from_jax(jcap["params"]))
    rows_t = torch.from_numpy(data)[torch.as_tensor(g["idx"]).long()]
    w = lambda s, L: P._window(rows_t, torch.as_tensor(s).long(), int(L))
    d = {k: torch.from_numpy(v[0]) for k, v in draws.items()}
    l1, l2, cl = int(g["w1_len"]), int(g["w2_len"]), int(g["crop_l"])
    o1 = net(w(g["w1_start"], l1), d["mask1"][:, :l1], d["keep1"][:, :l1])
    o2 = net(w(g["w2_start"], l2), d["mask2"][:, :l2], d["keep2"][:, :l2])
    P.hierarchical_contrastive_loss(o1[:, int(g["s1"]):int(g["s1"]) + cl],
                                    o2[:, :cl]).backward()
    for name, p in net.named_parameters():
        _close(p.grad.numpy(), jgrad[name].numpy(), 1e-5)

    pcap = _capture_port(monkeypatch)
    pm = P.TS2Vec(**CFG, batch_size=4, seed=7, device="cpu")
    pm.net.load_state_dict(ts2vec_params_from_jax(jcap["params"]))
    plog = pm.fit(data, n_iters=n_iters, draws=draws)
    for k, v in jcap["geom"].items():
        np.testing.assert_array_equal(pcap["geom"][k], v, err_msg=k)
    np.testing.assert_allclose(pcap["losses"].numpy(),
                               np.asarray(jcap["out"][1]), rtol=1e-5)
    np.testing.assert_allclose(plog, jlog, rtol=1e-5)
    assert (pm.swa_n, pm.n_iters, pm.n_epochs) == (
        jm.swa_n, jm.n_iters, jm.n_epochs) == (6, 5, 2)
    atol = 2 * lr * n_iters
    for mod, tree in ((pm.net, jcap["out"][0][0]),
                      (pm.swa, jcap["out"][0][2])):
        want = ts2vec_params_from_jax(_np_tree(tree))
        for name, p in mod.named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-4,
                                       atol=atol, err_msg=name)
            assert (diff > 1e-5).mean() <= 0.01, name
    _close(pm.encode(data, encoding_window="full_series"),
           jm.encode(data, encoding_window="full_series"), 1e-4)


def test_fit_preprocesses_like_jax(monkeypatch):
    """The max_train_length split (uneven: NaN-padded), centerize, the
    all-NaN-row filter and the re-crop window of a buffer still longer
    than max_train_length give JAX's buffer and host draws bit for bit;
    the default n_iters comes from the raw size."""
    r = np.random.default_rng(2)
    data = r.standard_normal((7, 49, 2)).astype(np.float32)
    data[3] = np.nan
    _, _, jcap = _capture_jax_fit(monkeypatch, data, None, run=False,
                                  batch_size=4, max_train_length=16, seed=3)
    pcap = _capture_port(monkeypatch, run=False)
    pm = P.TS2Vec(**CFG, batch_size=4, max_train_length=16, seed=3,
                  device="cpu")
    pm.fit(data)
    np.testing.assert_array_equal(pcap["data"], jcap["data"])
    assert pcap["data"].shape == (18, 17, 2)      # 3 sections, 1 row gone
    for k, v in jcap["geom"].items():
        np.testing.assert_array_equal(pcap["geom"][k], v, err_msg=k)
    assert len(pcap["geom"]["crop_l"]) == 200


def test_centerize_matches_jax():
    x = np.random.default_rng(4).standard_normal((5, 12, 2))
    x[0, 8:] = np.nan
    x[1, :3] = np.nan
    x[2, :1] = np.nan
    x[2, 9:] = np.nan
    np.testing.assert_array_equal(P._centerize_vary_length_series(x),
                                  J._centerize_vary_length_series(x))


def test_fit_counters_are_cumulative():
    data = np.random.default_rng(9).standard_normal((16, 16, 2)).astype(
        np.float32)
    m = P.TS2Vec(**CFG, batch_size=8, seed=3, device="cpu")
    log1 = m.fit(data, n_iters=4)
    p1 = m.net.input_fc.weight.detach().clone()
    assert m.swa_n == 5 and len(log1) == 2 and np.isfinite(log1).all()
    assert m.fit(data, n_iters=4) == []
    assert torch.equal(p1, m.net.input_fc.weight)
    log2 = m.fit(data, n_iters=6)
    assert m.swa_n == 7 and len(log2) == 1 and m.n_epochs == 3


def test_encode_save_load_and_refusals(tmp_path):
    data = np.random.default_rng(5).standard_normal((12, 24, 2)).astype(
        np.float32)
    m = P.TS2Vec(**CFG, batch_size=8, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="train or load"):
        m.encode(data)
    m.fit(data, n_iters=3)
    full = m.encode(data, encoding_window="full_series", batch_size=5)
    per_step = m.encode(data)
    assert full.shape == (12, 16) and per_step.shape == (12, 24, 16)
    np.testing.assert_array_equal(full, per_step.max(axis=1))
    fn = str(tmp_path / "ts2vec.pt")
    m.save(fn)
    m2 = P.TS2Vec(**CFG, device="cpu")
    m2.load(fn)
    np.testing.assert_array_equal(
        m2.encode(data, encoding_window="full_series"), full)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.TS2Vec(input_dims=1)
