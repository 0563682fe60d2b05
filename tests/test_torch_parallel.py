"""The port's parallel layer (``t2ms_tpu_torch.parallel``, the data-parallel
train step and engine) held to the JAX package on the CPU.

The parent process builds numpy inputs from a seed and the JAX results on
the JAX package's 8 virtual CPU devices, as ``dryrun_multichip`` does
(a (4 x 2) TP mesh for the train step, 8-device rings and data meshes, a
4-stage pipeline). One module fixture spawns a gloo group of W = 4
(the train step on a 2 x 2 mesh) running the port's
``parallel.dryrun.dryrun_multichip`` at small widths, and a group of
W = 2 running the data-parallel step at ``accum_steps`` 1 and 2,
``cli.infer``'s sharded batch and the engine left idle past a 4 s group
timeout; each test compares one check.

Tolerances: JAX's own, 1e-4 (absolute) for the dry-run checks, and rtol
1e-4 / atol 1e-5 for the engine, whose reference is the port's one-process
engine (the engines draw each row's noise from its seed, and torch cannot
reproduce threefry)."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from t2ms_tpu.models.denoisers import DiT as JDiT
from t2ms_tpu.models.denoisers.dit import DiTBlock as JDiTBlock
from t2ms_tpu.models.vae import LAVAE as JLAVAE
from t2ms_tpu.ops.attention import einsum_attention
from t2ms_tpu.parallel import host_local_batch_size as j_host_local
from t2ms_tpu.parallel import make_mesh as j_make_mesh
from t2ms_tpu.parallel.tp import shard_dit_params as j_shard_dit_params
from t2ms_tpu.sampling import make_cfg_sampler as j_make_cfg_sampler
from t2ms_tpu.training.trainer import TrainState
from t2ms_tpu.training.trainer import _training_forward as j_forward
from t2ms_tpu.training.trainer import \
    make_denoiser_train_step as j_make_step
from t2ms_tpu.utils.prng import named_fold
from t2ms_tpu_torch.cli._common import batch_seed
from t2ms_tpu_torch.convert import dit_params_from_jax, lavae_params_from_jax
from t2ms_tpu_torch.parallel import mesh as tmesh
from t2ms_tpu_torch.parallel.dryrun import (CHECKS, _models, _t, launch,
                                            save_inputs)
from t2ms_tpu_torch.data.prefetch import prefetch_to_device
from t2ms_tpu_torch.sampling import make_cfg_sampler
from t2ms_tpu_torch.serving import ServingEngine
from t2ms_tpu_torch.training import ScheduledAdamW, make_denoiser_train_step

W = 4
L, C, D, DEPTH, HEADS, T = 6, 8, 32, 2, 4, 24
B = 16                       # train and sampler rows (divide 8 and 4)
TOL = 1e-4                   # dryrun_multichip's bound


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturb(tree, seed, scale):
    leaves, tdef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.key(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tdef, [
        p + scale * jax.random.normal(k, p.shape) for p, k in
        zip(leaves, keys)])


def _init(module, seed, *args, perturb=None):
    """``module.init`` (and a perturbation) as one jitted program: eager
    flax init dispatches one small program per op."""
    def f():
        p = module.init(jax.random.key(seed), *args)
        return p if perturb is None else _perturb(p, *perturb)
    return jax.jit(f)()


def _block_sd(tree):
    """A flax DiTBlock param tree -> the port DiTBlock's state_dict."""
    p = tree["params"] if "params" in tree else tree
    sd = {}
    for key, node in (("attn.qkv", p["attn"]["qkv"]),
                      ("attn.proj", p["attn"]["proj"]),
                      ("mlp.fc1", p["mlp"]["fc1"]),
                      ("mlp.fc2", p["mlp"]["fc2"]),
                      ("adaLN_modulation.1", p["adaLN_modulation"])):
        sd[f"{key}.weight"] = np.asarray(node["kernel"]).T
        sd[f"{key}.bias"] = np.asarray(node["bias"])
    return sd


def _jax_side(rng):
    """The inputs of both packages and the JAX results."""
    devices = jax.devices()
    cfg = dict(latent_len=L, latent_dim=C, d_model=D, depth=DEPTH,
               heads=HEADS, mlp_ratio=2.0, T=T, lr=1e-4,
               train_total_step=10, train_dtype="f32", serve_dtype="f32",
               samp_steps=5, cfg=7.0, eng_steps=3, pp_heads=4,
               ring_big_refused=False, train_seed=7, infer_steps=4,
               idle_timeout_s=4.0,
               vae=dict(num_hiddens=16, num_residual_layers=2,
                        num_residual_hiddens=16))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    jd = JDiT(latent_len=L, latent_dim=C, d_model=D, depth=DEPTH,
              num_heads=HEADS)
    jv = JLAVAE(in_channels=1, latent_grid=L, num_hiddens=16,
                num_residual_hiddens=16, embedding_dim=C)
    vp = _init(jv, 0, jnp.ones((2, T)))
    # nonzero adaLN, so the TP products carry the output
    dp = _init(jd, 1, jnp.zeros((2, C, L)), jnp.zeros(2), jnp.zeros((2, D)),
               perturb=(101, 0.05))
    inp = {"config": cfg}
    inp.update({f"dit.{k}": v.numpy() for k, v in
                dit_params_from_jax(_np_tree(dp)).items()})
    inp.update({f"vae.{k}": v.numpy() for k, v in
                lavae_params_from_jax(_np_tree(vp)).items()})
    want = {}

    # 1. one train step, TP over a (4 x 2) mesh, and its draws
    x, emb = f32(B, T), f32(B, D)
    key = jax.random.key(2)

    @jax.jit
    def draws(key):
        z = jv.apply(vp, jnp.asarray(x), method=jv.encode)[0]
        return (jax.random.uniform(named_fold(key, "t"), (B,)),
                jax.random.normal(named_fold(key, "noise"), z.shape),
                jax.random.uniform(named_fold(key, "cfg"), ()))

    u, x0, coin = draws(key)
    inp.update(train_x=x, train_emb=emb, train_u=np.asarray(u),
               train_x0=np.asarray(x0), train_coin=np.asarray(coin))
    opt = optax.adamw(1e-4)
    step = j_make_step(jd, jv, opt, "flowmatching", total_step=10,
                       donate=False)
    mesh = j_make_mesh(devices, data=4, model=2)
    with mesh:
        state = TrainState(j_shard_dit_params(dp, mesh),
                           jax.device_put(opt.init(dp),
                                          NamedSharding(mesh, P())),
                           jnp.zeros((), jnp.int32))
        state, loss = step(state, vp, key,
                           jax.device_put(x, NamedSharding(mesh, P("data"))),
                           jax.device_put(emb, NamedSharding(
                               mesh, P("data", None))))
    want["train_loss"] = float(loss)
    want["train_params"] = {k: v.numpy() for k, v in dit_params_from_jax(
        _np_tree(state.params)).items()}

    # the gradients that step applied: its loss on the same draws
    def train_loss(params):
        z = jv.apply(vp, jnp.asarray(x), method=jv.encode)[0]
        t = jnp.round(u * 10) / 10
        x_t = t[:, None, None] * z + (1.0 - t[:, None, None]) * x0
        keep = jnp.broadcast_to((coin >= 0.3).astype(x_t.dtype), (B,))
        pred = j_forward(jd)(params, x_t, t, jnp.asarray(emb), keep)
        return jnp.mean(jnp.square(pred - (z - x0)))

    g_loss, g_train = jax.jit(jax.value_and_grad(train_loss))(dp)
    np.testing.assert_allclose(float(g_loss), want["train_loss"], rtol=1e-5)
    want["train_grads"] = {k: v.numpy() for k, v in dit_params_from_jax(
        _np_tree(g_train)).items()}

    # 2./3. ring attention against full attention, as the JAX dry run
    # holds its ring (the JAX ring over 8 devices is held to it by the JAX
    # package's own tests)
    for name, shape in (("ring", (3, 1, 2, 16 * W, 16)),
                        ("ring_big", (3, 1, 4, 32 * W, 32))):
        qkv = f32(*shape)
        inp[f"{name}_qkv"] = qkv
        want[name] = np.asarray(jax.jit(einsum_attention)(
            *jnp.asarray(qkv)))

    # 4. a 4-stage GPipe pipeline of DiT blocks, forward and gradients,
    # against the stages applied in sequence (JAX's pipeline_apply is held
    # to the same in the JAX package's tests/test_pp.py)
    Np, Dp, Bp = 12, 32, 2 * W
    block = JDiTBlock(d_model=Dp, num_heads=4, mlp_ratio=2.0)
    px, pc, cot = f32(Bp, Np, Dp), f32(Bp, Dp), f32(Bp, Np, Dp)
    p0 = _init(block, 7, jnp.asarray(px), jnp.asarray(pc), perturb=(8, 0.02))
    inp.update(pp_x=px, pp_c=pc, pp_cot=cot)
    inp.update({f"pp_block.{k}": v for k, v in _block_sd(
        _np_tree(p0)).items()})

    def pp_loss(stages, h):
        for params in stages:
            tokens, cond = h[:, :Np], h[:, Np:]
            h = jnp.concatenate([block.apply(params, tokens, cond[:, 0]),
                                 cond], axis=1)
        return jnp.sum(h[:, :Np] * cot), h[:, :Np]

    stages = [jax.tree_util.tree_map(lambda a: a * (1.0 + 0.1 * s), p0)
              for s in range(W)]
    h0 = jnp.concatenate([jnp.asarray(px), jnp.asarray(pc)[:, None]], 1)
    (_, out), (g_p, g_h) = jax.jit(jax.value_and_grad(
        pp_loss, argnums=(0, 1), has_aux=True))(stages, h0)
    want["pp_out"], want["pp_dx"] = np.asarray(out), np.asarray(g_h)
    want["pp_grads"] = [_block_sd(_np_tree(g)) for g in g_p]

    # the JAX pipeline test's tanh stages (tests/test_pp.py), sequential
    Dt = 16
    ks = jax.random.split(jax.random.key(0), 2 * W)
    pw = np.stack([np.asarray(jax.random.normal(ks[i], (Dt, Dt)))
                   / np.sqrt(Dt) for i in range(W)])
    pb = np.stack([0.1 * np.asarray(jax.random.normal(ks[W + i], (Dt,)))
                   for i in range(W)])
    ptx, ptt = f32(8, Dt), f32(8, Dt)
    inp.update(ppt_w=pw, ppt_b=pb, ppt_x=ptx, ppt_tgt=ptt)

    def tanh_seq(p, h):
        for s in range(W):
            h = jnp.tanh(h @ p["w"][s] + p["b"][s])
        return h

    tp = {"w": jnp.asarray(pw), "b": jnp.asarray(pb)}
    want["ppt_out"] = np.asarray(jax.jit(tanh_seq)(tp, jnp.asarray(ptx)))
    g = jax.jit(jax.grad(lambda p: jnp.mean(
        (tanh_seq(p, jnp.asarray(ptx)) - ptt) ** 2)))(tp)
    want["ppt_gw"], want["ppt_gb"] = np.asarray(g["w"]), np.asarray(g["b"])

    # 5. the CFG sampler, its batch sharded over the 8-device data mesh
    dpm = j_make_mesh(devices, data=8, model=1)
    sx, se = f32(B, T), f32(B, D)
    sk = jax.random.key(9)
    z = jax.eval_shape(lambda: jv.apply(vp, jnp.asarray(sx),
                                        method=jv.encode)[0])
    inp.update(samp_x=sx, samp_emb=se, samp_x0=np.asarray(jax.jit(
        lambda k: jax.random.normal(k, z.shape, dtype=z.dtype))(sk)))
    sampler = j_make_cfg_sampler(jd, jv, "flowmatching", total_step=5,
                                 cfg_scale=7.0, out_length=T)
    repl = NamedSharding(dpm, P())
    out = sampler(jax.device_put(dp, repl), jax.device_put(vp, repl), sk,
                  jax.device_put(sx, NamedSharding(dpm, P("data"))),
                  jax.device_put(se, NamedSharding(dpm, P("data", None))))
    want["samp_series"] = np.asarray(out.series)

    # 6. data-parallel gradients of the DiT loss
    gx, ge = f32(2 * W, C, L), f32(2 * W, D)
    gt = np.linspace(0.0, 1.0, 2 * W).astype(np.float32)
    inp.update(grad_x=gx, grad_t=gt, grad_e=ge)

    def dit_loss(params, x_in, t_in, e_in):
        return jnp.mean(jnp.square(jd.apply(params, x_in, t_in, e_in)
                                   - x_in))

    g_dp = jax.jit(jax.grad(dit_loss))(
        jax.device_put(dp, repl),
        jax.device_put(gx, NamedSharding(dpm, P("data", None, None))),
        jax.device_put(gt, NamedSharding(dpm, P("data"))),
        jax.device_put(ge, NamedSharding(dpm, P("data", None))))
    want["grad"] = {k: v.numpy() for k, v in dit_params_from_jax(
        _np_tree(g_dp)).items()}

    # 7. the engine's requests (reference: the port's one-process engine)
    inp.update(eng_emb=f32(2 * W, D),
               eng_cfg=(2.0 + np.arange(2 * W)).astype(np.float32),
               eng_seed=(40 + np.arange(2 * W)).astype(np.int64))
    return inp, want


def _read(out_dir, world):
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel")
    inp, want = _jax_side(np.random.default_rng(0))
    path = str(base / "inputs.npz")
    save_inputs(path, inp)
    errors = []

    def run(world, out, checks):
        try:
            launch(world, "cpu", path, str(base / out), timeout_s=240.0,
                   checks=checks)
        except Exception as e:  # noqa: BLE001 - reported by the tests
            errors.append(e)

    threads = [threading.Thread(target=run, args=(W, "w4",
                                                  CHECKS + ("pp_tanh",))),
               threading.Thread(target=run, args=(2, "w2",
                                                  ("train_dp", "infer",
                                                   "engine_idle")))]
    for t in threads:
        t.start()
    # the one-process references of the port, meanwhile
    ref = {}
    dev = torch.device("cpu")
    cfg = inp["config"]
    dit, vae = _models(inp, cfg, dev, torch.float32)
    opt = ScheduledAdamW(dit.parameters(), lambda _: cfg["lr"])
    step = make_denoiser_train_step(dit, vae, opt, "flowmatching",
                                    cfg["train_total_step"], device=dev)
    gen = torch.Generator().manual_seed(batch_seed(cfg["train_seed"], 0))
    ref["train_dp_loss"] = float(step(_t(inp["train_x"], dev),
                                      _t(inp["train_emb"], dev),
                                      generator=gen))
    ref["train_dp_params"] = {k: v.detach().numpy()
                              for k, v in dit.state_dict().items()}
    dit, vae = _models(inp, cfg, dev, torch.float32)
    opt = ScheduledAdamW(dit.parameters(), lambda _: cfg["lr"])
    step = make_denoiser_train_step(dit, vae, opt, "flowmatching",
                                    cfg["train_total_step"], accum_steps=2,
                                    device=dev)
    gen = torch.Generator().manual_seed(batch_seed(cfg["train_seed"], 0))
    ref["train_dp_accum2_loss"] = float(step(_t(inp["train_x"], dev),
                                             _t(inp["train_emb"], dev),
                                             generator=gen))
    ref["train_dp_accum2_grads"] = {k: p.grad.numpy()
                                    for k, p in dit.named_parameters()}
    dit, vae = _models(inp, cfg, dev, torch.float32)
    sampler = make_cfg_sampler(dit, vae, "ddpm", cfg["infer_steps"],
                               cfg["cfg"], out_length=T, device=dev)
    gen = torch.Generator().manual_seed(batch_seed(cfg["train_seed"], 1))
    out = sampler(inp["samp_x"], inp["samp_emb"], generator=gen)
    ref.update({f"infer_{k}": getattr(out, k).numpy()
                for k in ("series", "latent", "latent_enc")})
    dit, vae = _models(inp, cfg, dev, torch.float32)
    emb = inp["eng_emb"]
    with ServingEngine(dit, vae, total_step=cfg["eng_steps"],
                       out_lengths=(T,), batch_tiers=(len(emb),),
                       max_wait_ms=500.0, text_emb_dim=D,
                       device=dev) as eng:
        ref["eng_series"] = np.stack([r.series for r in eng.generate(
            [(emb[i], T, float(inp["eng_cfg"][i]), int(inp["eng_seed"][i]))
             for i in range(len(emb))])])
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return dict(w4=_read(str(base / "w4"), W), w2=_read(str(base / "w2"), 2),
                want=want, ref=ref)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def test_dryrun_train_step_tp_matches_jax(runs):
    r0, want = runs["w4"][0], runs["want"]
    np.testing.assert_allclose(float(r0["train_loss"]), want["train_loss"],
                               rtol=TOL)
    for k, v in want["train_params"].items():
        assert _max_err(r0[f"train_param.{k}"], v) < TOL, k
    # every rank holds the same whole parameters after the step
    for r in runs["w4"][1:]:
        for k in want["train_params"]:
            assert _max_err(r[f"train_param.{k}"],
                            r0[f"train_param.{k}"]) == 0.0, k


def test_dryrun_train_step_tp_gradients_match_jax(runs):
    """The gradients the TP step applied (the all-reduced ``.grad``
    unsharded), against ``jax.grad`` of the JAX step's loss on the same
    draws: AdamW's first update is about lr * sign(g), so only the
    gradients show a wrong scale or a missing collective."""
    want = runs["want"]["train_grads"]
    for r in runs["w4"]:
        for k, v in want.items():
            assert _max_err(r[f"train_grad.{k}"], v) < TOL, k
    # a wrong scale would pass the parameters' bound; not this one
    big = max(float(np.max(np.abs(v))) for v in want.values())
    assert big > 10 * TOL


@pytest.mark.parametrize("name", ["ring", "ring_big"])
def test_dryrun_ring_attention_matches_jax(runs, name):
    got = runs["w4"][0][f"{name}_out"]
    assert _max_err(got, runs["want"][name]) < TOL


def test_dryrun_pipeline_of_dit_blocks_matches_jax(runs):
    want = runs["want"]
    for s, r in enumerate(runs["w4"]):
        assert _max_err(r["pp_out"], want["pp_out"]) < TOL
        assert _max_err(r["pp_dx"], want["pp_dx"]) < TOL
        for k, v in want["pp_grads"][s].items():
            assert _max_err(r[f"pp_grad{s}.{k}"], v) < TOL, (s, k)


def test_dryrun_dp_sampler_matches_jax(runs):
    got = runs["w4"][0]["samp_series"]
    assert np.isfinite(got).all()
    assert _max_err(got, runs["want"]["samp_series"]) < TOL


def test_dryrun_dp_gradients_match_jax(runs):
    r0 = runs["w4"][0]
    for k, v in runs["want"]["grad"].items():
        assert _max_err(r0[f"grad.{k}"], v) < TOL, k


def test_dryrun_dp_engine_matches_plain_engine(runs):
    got = runs["w4"][0]["eng_series"]
    np.testing.assert_allclose(got, runs["ref"]["eng_series"], rtol=1e-4,
                               atol=1e-5)
    # the other ranks served that one data-parallel dispatch
    assert all(int(r["eng_dispatches"]) == 1 for r in runs["w4"][1:])


@pytest.mark.parametrize("M", [W, 2 * W])
def test_pipeline_apply_forward_matches_jax(runs, M):
    for r in runs["w4"]:
        np.testing.assert_allclose(r[f"ppt_out{M}"], runs["want"]["ppt_out"],
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_apply_gradients_match_jax(runs):
    want = runs["want"]
    for s, r in enumerate(runs["w4"]):
        np.testing.assert_allclose(r[f"ppt_gw{s}"], want["ppt_gw"][s],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[f"ppt_gb{s}"], want["ppt_gb"][s],
                                   rtol=1e-5, atol=1e-6)


def test_two_rank_dp_step_matches_one_rank_on_concatenated_batch(runs):
    ref = runs["ref"]
    for r in runs["w2"]:
        np.testing.assert_allclose(float(r["train_dp_loss"]),
                                   ref["train_dp_loss"], rtol=1e-5)
        for k, v in ref["train_dp_params"].items():
            assert _max_err(r[f"train_dp_param.{k}"], v) < TOL, k


def test_two_rank_dp_step_at_accum_steps_2_matches_one_rank(runs):
    """At accum_steps=2 each rank's microbatches are its own rows, not the
    one-rank step's: every row still gets the draws it gets on one rank,
    so the loss and the applied gradients agree."""
    ref = runs["ref"]
    for r in runs["w2"]:
        np.testing.assert_allclose(float(r["train_dp_accum2_loss"]),
                                   ref["train_dp_accum2_loss"], rtol=1e-5)
        for k, v in ref["train_dp_accum2_grads"].items():
            assert _max_err(r[f"train_dp_accum2_grad.{k}"], v) < 1e-5, k
        # the two steps draw the same rows: same loss at accum 1 and 2
        np.testing.assert_allclose(float(r["train_dp_accum2_loss"]),
                                   float(r["train_dp_loss"]), rtol=1e-5)


def test_two_rank_engine_outlives_its_group_timeout_when_idle(runs):
    """The data-parallel engine idle for 2.5 times a 4 s group timeout,
    then one request: served at the data-parallel tier, the row the
    one-process engine gives, and the worker served that dispatch."""
    r0, r1 = runs["w2"]
    assert float(r0["idle_mesh_timeout"]) == 4.0
    assert int(r0["idle_batch"]) == 2
    np.testing.assert_allclose(r0["idle_series"], runs["ref"]["eng_series"][0],
                               rtol=1e-4, atol=1e-5)
    assert int(r1["idle_dispatches"]) == 1


def test_two_rank_infer_shards_the_one_sampler_call(runs):
    """cli.infer's sharded batch (DDPM ancestral: the initial noise and
    every step's noise drawn for the whole batch) against one sampler
    call on the whole batch from the same generator."""
    for r in runs["w2"]:
        for k in ("series", "latent", "latent_enc"):
            np.testing.assert_allclose(r[f"infer_{k}"],
                                       runs["ref"][f"infer_{k}"],
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_prefetch_places_this_ranks_rows():
    mesh = tmesh.Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    mesh._coord = dict(data=1, model=0)
    batches = [(np.arange(8.0).reshape(4, 2) + 10 * i, np.arange(4) + i)
               for i in range(3)]
    got = list(prefetch_to_device(iter(batches), mesh=mesh))
    assert len(got) == 3
    for i, (batch, (x, t)) in enumerate(got):
        assert batch is batches[i]
        np.testing.assert_array_equal(x.numpy(), batches[i][0][2:])
        np.testing.assert_array_equal(t.numpy(), batches[i][1][2:])


def test_make_mesh_and_host_local_batch_refusals_match_jax(monkeypatch):
    devices = jax.devices()
    for kw in (dict(model=3), dict(data=3, model=2), dict(data=5)):
        with pytest.raises(ValueError) as want:
            j_make_mesh(devices, **kw)
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(range(len(devices)), **kw)
        assert str(got.value) == str(want.value)
    # a mesh of several ranks needs a process group
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(range(4), data=2, model=2)
    one = tmesh.make_mesh()
    assert one.shape == {"data": 1, "model": 1} and not one.distributed
    assert tmesh.host_local_batch_size(6, one) == 6
    # a (4 x 2) mesh over 8 processes, and a (2 x 2) one over 4
    four = tmesh.Mesh(np.arange(8).reshape(4, 2), ("data", "model"))
    two = tmesh.Mesh(np.arange(4).reshape(2, 2), ("data", "model"))
    monkeypatch.setattr(tmesh, "_initialized", lambda: True)
    for mesh, jmesh, pc, batch in (
            (four, j_make_mesh(devices, data=4, model=2), 8, 6),
            (two, j_make_mesh(devices[:4], data=2, model=2), 4, 6),
            (two, j_make_mesh(devices[:4], data=2, model=2), 4, 8)):
        monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: pc)
        monkeypatch.setattr(jax, "process_count", lambda: pc)
        try:
            want = j_host_local(batch, jmesh)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tmesh.host_local_batch_size(batch, mesh)
            assert str(got.value) == str(e)
            continue
        assert tmesh.host_local_batch_size(batch, mesh) == want


def test_shard_batch_takes_jax_rows():
    mesh = tmesh.Mesh(np.arange(8).reshape(4, 2), ("data", "model"))
    x = np.arange(24).reshape(12, 2)
    for rank in range(8):
        mesh._coord = dict(data=rank // 2, model=rank % 2)
        got = tmesh.shard_batch(mesh, {"x": x, "t": torch.arange(12)})
        r = rank // 2
        np.testing.assert_array_equal(got["x"], x[3 * r:3 * r + 3])
        assert got["t"].tolist() == list(range(3 * r, 3 * r + 3))
    with pytest.raises(ValueError, match="not divisible by data axis 4"):
        tmesh.shard_batch(mesh, np.zeros((6, 1)))
