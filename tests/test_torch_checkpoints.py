"""The port's checkpoints, EMA and scaling plan held to the JAX package on
the CPU: a save, restore and resume that brings back the epoch and the
optimizer-step count apart and continues bit for bit; the retention of
``TrainCheckpointManager`` (``max_to_keep``, ``keep_period``, the
loss-history sidecars) against the JAX (Orbax) manager's directory listing
for the same sequences of saves; the EMA update against JAX's, its round
trip and pruning; reference ``.pth`` checkpoints loaded into the port's
modules; ``auto_accum_steps`` and ``setup_scaling`` against JAX's over a
grid (JAX's on one device)."""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2ms_tpu.training import checkpoints as jckpt
from t2ms_tpu.training import ema as jema
from t2ms_tpu.training import scaling as jscaling
from t2ms_tpu_torch.models.denoisers import DiT
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.training import checkpoints as ckpt
from t2ms_tpu_torch.training import ema, scaling
from t2ms_tpu_torch.training.optim import onecycle_adamw


def _dit(seed=0):
    torch.manual_seed(seed)
    return DiT(6, 8, 32, 1, 2, device="cpu")


def _train(model, opt, steps, seed):
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        opt.zero_grad()
        x = torch.randn(3, 8, 6, generator=g)
        loss = torch.mean(torch.square(
            model(x, torch.rand(3, generator=g),
                  torch.randn(3, 32, generator=g)) - x))
        loss.backward()
        opt.step()


def test_save_restore_resume_keeps_epoch_and_opt_step_apart(tmp_path):
    m = _dit()
    opt = onecycle_adamw(m.parameters(), 20, 1e-3)
    _train(m, opt, 5, seed=1)
    mgr = ckpt.TrainCheckpointManager(str(tmp_path))
    mgr.save(1, m.state_dict(), opt.state_dict(), [0.5, 0.25], opt_step=5)
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    assert ckpt.latest_step(str(tmp_path)) == 1

    r = ckpt.load_train_ckpt(str(tmp_path / "model_1"))
    assert (r["epoch"], r["step"]) == (1, 5)
    assert r["loss_history"] == [0.5, 0.25]
    assert mgr.restore()["step"] == 5
    m2 = _dit(seed=7)
    opt2 = onecycle_adamw(m2.parameters(), 20, 1e-3)
    m2.load_state_dict(r["params"])
    opt2.load_state_dict(r["opt_state"])
    assert opt2.applied_updates() == 5           # the schedule's count too
    for (n, a), b in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(opt.state[a]["exp_avg_sq"],
                           opt2.state[b]["exp_avg_sq"]), n
    # the resumed run continues as the uninterrupted one
    _train(m, opt, 2, seed=2)
    _train(m2, opt2, 2, seed=2)
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    # a params-only checkpoint, and the params of a train checkpoint
    ckpt.save_params(str(tmp_path), m.state_dict(), "final_model")
    for path in ("final_model", "model_1"):
        sd = ckpt.load_params(str(tmp_path / path))
        assert set(sd) == set(m.state_dict())


def _jax_listing(directory, seq, max_to_keep, keep_period):
    for steps in seq:                  # one manager per run, as a resume
        mgr = jckpt.TrainCheckpointManager(directory, max_to_keep,
                                           keep_period)
        for s in steps:
            mgr.save(s, {"w": jnp.full(2, float(s))}, {"m": jnp.zeros(2)},
                     [float(s)])
        mgr.wait_until_finished()
        mgr.close()
    return sorted(e for e in os.listdir(directory) if e.startswith("model_"))


def _port_listing(directory, seq, max_to_keep, keep_period):
    for steps in seq:
        mgr = ckpt.TrainCheckpointManager(directory, max_to_keep,
                                          keep_period)
        for s in steps:
            mgr.save(s, {"w": torch.full((2,), float(s))}, {}, [float(s)])
    return sorted(e for e in os.listdir(directory) if e.startswith("model_"))


@pytest.mark.parametrize("seq,max_to_keep,keep_period", [
    ([range(7)], 2, 3),
    ([range(6)], 3, None),
    ([range(5)], None, 2),
    ([range(4), range(4, 9)], 2, 4),
    ([range(0, 20, 5)], 1, 10),
])
def test_retention_lists_what_the_jax_manager_lists(tmp_path, seq,
                                                    max_to_keep, keep_period):
    want = _jax_listing(str(tmp_path / "jax"), seq, max_to_keep, keep_period)
    got = _port_listing(str(tmp_path / "port"), seq, max_to_keep,
                        keep_period)
    assert got == want
    last = max(s for steps in seq for s in steps)
    assert ckpt.load_train_ckpt(str(tmp_path / "port" / f"model_{last}"))[
        "loss_history"] == [float(last)]


def test_ema_update_matches_jax():
    m = _dit()
    upd, jupd = ema.make_ema_update(0.9), jema.make_ema_update(0.9)
    shadow = {n: torch.full_like(p, 0.5) for n, p in m.named_parameters()}
    jshadow = {n: jnp.full(p.shape, 0.5) for n, p in m.named_parameters()}
    jparams = {n: jnp.asarray(p.detach().numpy())
               for n, p in m.named_parameters()}
    for _ in range(4):
        upd(shadow, m)
        jshadow = jupd(jshadow, jparams)
    for n in shadow:
        np.testing.assert_allclose(shadow[n].numpy(), np.asarray(jshadow[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError):
            ema.make_ema_update(bad)


def test_ema_round_trip_and_pruning(tmp_path):
    m = _dit()
    assert ema.setup_cli_ema(0.0, m) == (None, None)
    shadow, upd = ema.setup_cli_ema(0.99, m)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
    upd(shadow, m)
    for s in (1, 2, 3):
        ema.save_cli_ema(str(tmp_path), shadow, s, keep_steps=[2])
    # what JAX's prune leaves for the same saves
    for s in (1, 2, 3):
        os.makedirs(tmp_path / "jax" / f"model_{s}_ema", exist_ok=True)
        jema.prune_ema(str(tmp_path / "jax"), keep_steps=[2], current=s)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        e for e in os.listdir(tmp_path) if e != "jax")
    loaded = ema.load_ema_for_inference(str(tmp_path / "model_3"))
    for n, v in shadow.items():
        assert torch.equal(loaded[n], v)
    # resume: a saved {path}_ema replaces the fresh copy
    m2 = _dit(seed=5)
    resumed, _ = ema.setup_cli_ema(0.99, m2, str(tmp_path / "model_3"))
    for n, v in shadow.items():
        assert torch.equal(resumed[n], v)
    with pytest.raises(FileNotFoundError, match="use_ema"):
        ema.load_ema_for_inference(str(tmp_path / "model_9"))


def test_reference_checkpoints_load_into_the_port(tmp_path):
    """A train-loop dict with the reference's extra keys (the DiT's unused
    ``unpatch``, ``pos_embed``, a grafted ``encoder.*``) and a whole pickled
    module whose class is not importable both load by name; a missing key
    raises."""
    src = _dit(seed=3)
    sd = dict(src.state_dict())
    sd.update({"unpatch.weight": torch.zeros(2), "pos_embed": torch.zeros(3),
               "encoder._conv_1.weight": torch.zeros(1)})
    torch.save({"model": sd, "optimizer": {}, "epoch": 4, "loss_list": []},
               tmp_path / "ref.pth")
    dst = _dit(seed=4)
    ckpt.load_reference_state_dict(dst, str(tmp_path / "ref.pth"))
    for a, b in zip(src.state_dict().values(), dst.state_dict().values()):
        assert torch.equal(a, b)
    del sd["ln.weight"]
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="ln.weight"):
        ckpt.load_reference_state_dict(dst, str(tmp_path / "bad.pth"))

    (tmp_path / "refmod_vae.py").write_text(
        "import torch\n"
        "from t2ms_tpu_torch.models.vae import LAVAE\n"
        "class VQVAE(LAVAE):\n    pass\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import refmod_vae
        torch.manual_seed(0)
        whole = refmod_vae.VQVAE(1, 16, 1, 16, 8, 6, device="cpu")
        torch.save(whole, tmp_path / "vae.pth")
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("refmod_vae", None)
    vae = LAVAE(1, 16, 1, 16, 8, 6, device="cpu")
    ckpt.load_reference_state_dict(vae, str(tmp_path / "vae.pth"))
    for a, b in zip(whole.state_dict().values(), vae.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cap", [1, 7, 16, 1024])
def test_auto_accum_steps_matches_jax(cap):
    for batch in (1, 7, 10, 16, 240, 1024, 9216):
        for n in (1, 2, 8):
            try:
                want = jscaling.auto_accum_steps(batch, n, cap)
            except ValueError:
                with pytest.raises(ValueError):
                    scaling.auto_accum_steps(batch, n, cap)
                continue
            assert scaling.auto_accum_steps(batch, n, cap) == want


def test_setup_scaling_matches_jax_on_one_device(monkeypatch):
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: one)
    for batch in (10, 1024, 9216):
        for accum in (0, 1, 3, 4):
            for cap in (16, 1024):
                for dt in ("f32", "bf16", "bfloat16"):
                    ns = argparse.Namespace(batch_size=batch,
                                            accum_steps=accum,
                                            microbatch_cap=cap,
                                            compute_dtype=dt)
                    for train in (True, False):
                        try:
                            want = jscaling.setup_scaling(
                                ns, for_training=train)
                        except ValueError:
                            with pytest.raises(ValueError):
                                scaling.setup_scaling(ns, for_training=train)
                            continue
                        got = scaling.setup_scaling(ns, for_training=train)
                        assert (got.n_data, got.accum_steps) == (
                            want.n_data, want.accum_steps)
                        assert str(got.compute_dtype).replace(
                            "torch.", "") == jnp.dtype(
                                want.compute_dtype).name
    assert "accum_steps=9" in scaling.setup_scaling(argparse.Namespace(
        batch_size=9216, accum_steps=0, microbatch_cap=1024,
        compute_dtype="bf16")).describe()
    with pytest.raises(ValueError, match="unknown compute dtype"):
        scaling.parse_dtype("fp8")
