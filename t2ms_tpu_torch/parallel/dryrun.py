"""The multi-device dry run (counterpart of ``dryrun_multichip`` in the JAX
package's graft entry): seven checks of the parallel layer, made at one
rank of a process group of W ranks.

1. ``train``: one flagship train step on a (W/2 x 2) mesh with tensor
   parallelism (a (W x 1) mesh when W is odd), AdamW, injected draws;
2. ``ring``: ring attention over W ranks (to hold against full attention);
3. ``ring_big``: ring attention at a geometry the single-device kernels
   refuse (``fused_heads_block_q`` is 0) when the inputs say so;
4. ``pp``: a GPipe pipeline of real ``DiTBlock`` stages with nonzero adaLN,
   forward and gradients;
5. ``sampler``: the CFG sampler with its batch split over 'data';
6. ``grad``: data-parallel gradients of a DiT loss (all-reduced);
7. ``engine``: the ``ServingEngine`` under a data-parallel plan on rank 0,
   ``serve_worker`` on the others.

Four further checks run where a caller names them: ``train_dp``, the
data-parallel step on a (W x 1) mesh with its draws from a generator, at
``accum_steps`` 1 and 2 (to hold against the one-rank step on the
concatenated batch); ``pp_tanh``, the pipeline over tanh(h @ w + b)
stages at M = S and 2S microbatches, forward and gradients; ``infer``,
``cli.infer``'s sharded batch under the DDPM ancestral sampler (to hold
against one sampler call on the whole batch from the same generator);
and ``engine_idle``, the data-parallel engine left idle past its group's
timeout, then one request.

The train checks write the parameters after the step and the gradients
it applied (``.grad``, all-reduced), whole on every rank.

Each rank writes its arrays to ``out_dir/rank{r}.npz`` and its launch
counts and times to ``out_dir/rank{r}.json``; the caller compares them
with a reference (the JAX package's results in the CPU tests, the
one-rank no-plan path on the card). It lives in the port so that spawned
workers import torch only:

    python -m t2ms_tpu_torch.parallel.dryrun --world 4 --device cpu \\
        --inputs inputs.npz --out DIR

spawns W ranks over a ``FileStore`` in DIR (``launch``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip", "launch", "save_inputs", "load_inputs",
           "flagship_inputs", "CHECKS"]

CHECKS = ("train", "ring", "ring_big", "pp", "sampler", "grad", "engine")


def save_inputs(path: str, inputs: dict) -> None:
    """Write a dry run's inputs: numpy arrays, and the geometry under
    "config" (a JSON-able dict)."""
    arrays = {k: np.asarray(v) for k, v in inputs.items() if k != "config"}
    np.savez(path, config=np.asarray(json.dumps(inputs["config"])), **arrays)


def load_inputs(path: str) -> dict:
    with np.load(path) as f:
        out = {k: f[k] for k in f.files if k != "config"}
        out["config"] = json.loads(str(f["config"]))
    return out


def _sd(inp: dict, prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.from_numpy(np.array(v, np.float32))
            for k, v in inp.items() if k.startswith(prefix)}


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), device=dev).to(dtype)


def _models(inp, cfg, dev, dtype):
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.vae import LAVAE
    dit = DiT(cfg["latent_len"], cfg["latent_dim"], cfg["d_model"],
              cfg["depth"], cfg["heads"], cfg["mlp_ratio"],
              compute_dtype=dtype, device=dev)
    dit.load_state_dict(_sd(inp, "dit."))
    v = cfg["vae"]
    vae = LAVAE(1, v["num_hiddens"], v["num_residual_layers"],
                v["num_residual_hiddens"], cfg["latent_dim"],
                cfg["latent_len"], device=dev).eval()
    vae.load_state_dict(_sd(inp, "vae."))
    for p in vae.parameters():
        p.requires_grad_(False)
    return dit, vae


def _dtype(name):
    from t2ms_tpu_torch.training.scaling import parse_dtype
    return parse_dtype(name)


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _grads(net) -> Dict[str, torch.Tensor]:
    return {k: p.grad for k, p in net.named_parameters()}


def check_train(inp, cfg, dev, world):
    from t2ms_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from t2ms_tpu_torch.parallel.tp import TPDiT, unshard_dit_params
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    model = 2 if world % 2 == 0 else 1
    mesh = make_mesh(data=world // model, model=model)
    dit, vae = _models(inp, cfg, dev, _dtype(cfg["train_dtype"]))
    net = TPDiT(dit, mesh) if model > 1 else dit
    opt = ScheduledAdamW(net.parameters(), lambda _: cfg["lr"])
    step = make_denoiser_train_step(net, vae, opt, "flowmatching",
                                    cfg["train_total_step"], device=dev,
                                    mesh=mesh)
    x, emb = shard_batch(mesh, (inp["train_x"], inp["train_emb"]))
    loss = step(_t(x, dev), _t(emb, dev), u=_t(inp["train_u"], dev),
                x_0=_t(inp["train_x0"], dev),
                coin=_t(inp["train_coin"], dev))
    whole = ((lambda sd: unshard_dit_params(sd, mesh)) if model > 1
             else (lambda sd: sd))
    out = {"train_loss": _np(loss)}
    out.update({f"train_param.{k}": _np(v)
                for k, v in whole(net.state_dict()).items()})
    out.update({f"train_grad.{k}": _np(v)
                for k, v in whole(_grads(net)).items()})
    return out, dict(mesh.shape)


def check_train_dp(inp, cfg, dev, world):
    from t2ms_tpu_torch.cli._common import batch_seed
    from t2ms_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    from t2ms_tpu_torch.utils.prng import torch_seed
    mesh = make_mesh(data=world, model=1)
    x, emb = shard_batch(mesh, (inp["train_x"], inp["train_emb"]))
    out = {}
    for accum, tag in ((1, "train_dp"), (2, "train_dp_accum2")):
        dit, vae = _models(inp, cfg, dev, _dtype(cfg["train_dtype"]))
        opt = ScheduledAdamW(dit.parameters(), lambda _: cfg["lr"])
        step = make_denoiser_train_step(dit, vae, opt, "flowmatching",
                                        cfg["train_total_step"],
                                        accum_steps=accum, device=dev,
                                        mesh=mesh)
        gen = torch.Generator(device=dev)
        gen.manual_seed(torch_seed(batch_seed(cfg["train_seed"], 0)))
        loss = step(_t(x, dev), _t(emb, dev), generator=gen)
        out[f"{tag}_loss"] = _np(loss)
        out.update({f"{tag}_param.{k}": _np(v)
                    for k, v in dit.state_dict().items()})
        out.update({f"{tag}_grad.{k}": _np(v)
                    for k, v in _grads(dit).items()})
    return out, dict(mesh.shape)


def _ring(inp, key, dev, world):
    from t2ms_tpu_torch.parallel.mesh import make_mesh
    from t2ms_tpu_torch.parallel.ring_attention import ring_attention_sharded
    mesh = make_mesh(data=world, model=1)
    q, k, v = (_t(a, dev) for a in inp[key])
    return ring_attention_sharded(q, k, v, mesh, "data"), dict(mesh.shape)


def check_ring(inp, cfg, dev, world):
    out, shape = _ring(inp, "ring_qkv", dev, world)
    return {"ring_out": _np(out)}, shape


def check_ring_big(inp, cfg, dev, world):
    from t2ms_tpu_torch.ops.attention import fused_heads_block_q
    _, _, H, N, D = inp["ring_big_qkv"].shape
    refused = fused_heads_block_q(N, H * D) == 0
    if cfg.get("ring_big_refused") and not refused:
        raise AssertionError(
            f"N={N} H={H} D={D} fits one device's fused-heads kernel: "
            f"enlarge the check so it stays load-bearing")
    out, shape = _ring(inp, "ring_big_qkv", dev, world)
    return {"ring_big_out": _np(out),
            "ring_big_refused": np.asarray(refused)}, shape


def check_pp(inp, cfg, dev, world):
    from t2ms_tpu_torch.models.denoisers.dit import DiTBlock
    from t2ms_tpu_torch.parallel.mesh import make_mesh
    from t2ms_tpu_torch.parallel.pp import pipeline_apply
    mesh = make_mesh(data=world, model=1, axis_names=("stage", "model"))
    s = mesh.index("stage")
    Np, Dp = inp["pp_x"].shape[1:]
    blk = DiTBlock(Dp, cfg["pp_heads"], 2.0).to(dev)
    blk.load_state_dict({k: v * (1.0 + 0.1 * s)
                         for k, v in _sd(inp, "pp_block.").items()})

    def stage_fn(block, h):
        tokens, cond = h[:, :Np], h[:, Np:]
        out = block(tokens, cond[:, 0], torch.float32, "einsum")
        return torch.cat([out, cond], dim=1)

    h0 = torch.cat([_t(inp["pp_x"], dev), _t(inp["pp_c"], dev)[:, None]],
                   dim=1).requires_grad_(True)
    out = pipeline_apply(stage_fn, blk, h0, mesh, "stage")[:, :Np]
    (out * _t(inp["pp_cot"], dev)).sum().backward()
    res = {"pp_out": _np(out), "pp_dx": _np(h0.grad)}
    res.update({f"pp_grad{s}.{k}": _np(p.grad)
                for k, p in blk.named_parameters()})
    return res, dict(mesh.shape)


def check_pp_tanh(inp, cfg, dev, world):
    from t2ms_tpu_torch.parallel.mesh import make_mesh
    from t2ms_tpu_torch.parallel.pp import pipeline_apply
    mesh = make_mesh(data=world, model=1, axis_names=("stage", "model"))
    s = mesh.index("stage")
    w = _t(inp["ppt_w"][s], dev).requires_grad_(True)
    b = _t(inp["ppt_b"][s], dev).requires_grad_(True)
    x = _t(inp["ppt_x"], dev)
    fn = lambda p, h: torch.tanh(h @ p[0] + p[1])
    res = {}
    for M in (world, 2 * world):
        res[f"ppt_out{M}"] = _np(pipeline_apply(fn, (w, b), x, mesh, "stage",
                                                n_microbatches=M))
    out = pipeline_apply(fn, (w, b), x, mesh, "stage")
    torch.mean(torch.square(out - _t(inp["ppt_tgt"], dev))).backward()
    res.update({f"ppt_gw{s}": _np(w.grad), f"ppt_gb{s}": _np(b.grad)})
    return res, dict(mesh.shape)


def check_infer(inp, cfg, dev, world):
    from argparse import Namespace

    from t2ms_tpu_torch.cli._common import batch_seed
    from t2ms_tpu_torch.cli.infer import _sample_sharded
    from t2ms_tpu_torch.parallel.mesh import make_mesh
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    from t2ms_tpu_torch.utils.prng import torch_seed
    mesh = make_mesh(data=world, model=1)
    dit, vae = _models(inp, cfg, dev, _dtype(cfg["serve_dtype"]))
    sampler = make_cfg_sampler(dit, vae, "ddpm", cfg["infer_steps"],
                               cfg["cfg"], out_length=cfg["T"], device=dev)
    args = Namespace(backbone="ddpm", solver="euler",
                     total_step=cfg["infer_steps"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(torch_seed(batch_seed(cfg["train_seed"], 1)))
    out = _sample_sharded(sampler, vae, args, mesh, inp["samp_x"],
                          inp["samp_emb"], gen, dev)
    return {f"infer_{k}": _np(getattr(out, k))
            for k in ("series", "latent", "latent_enc")}, dict(mesh.shape)


def check_sampler(inp, cfg, dev, world):
    from t2ms_tpu_torch.parallel.collectives import all_gather
    from t2ms_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    mesh = make_mesh(data=world, model=1)
    dit, vae = _models(inp, cfg, dev, _dtype(cfg["serve_dtype"]))
    sampler = make_cfg_sampler(dit, vae, "flowmatching", cfg["samp_steps"],
                               cfg["cfg"], out_length=cfg["T"], device=dev)
    x, emb, x0 = shard_batch(mesh, (inp["samp_x"], inp["samp_emb"],
                                    inp["samp_x0"]))
    out = sampler(x, emb, x_t0=_t(x0, dev))
    series = all_gather(out.series, mesh.group("data"))
    return {"samp_series": _np(series)}, dict(mesh.shape)


def check_grad(inp, cfg, dev, world):
    from t2ms_tpu_torch.parallel.mesh import make_mesh, shard_batch
    mesh = make_mesh(data=world, model=1)
    dit, _ = _models(inp, cfg, dev, torch.float32)
    x, t, e = (_t(a, dev) for a in shard_batch(
        mesh, (inp["grad_x"], inp["grad_t"], inp["grad_e"])))
    torch.mean(torch.square(dit(x, t, e) - x)).backward()
    params = list(dit.parameters())
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.group("data"))
    flat /= mesh.shape["data"]
    out, i = {}, 0
    for name, p in dit.named_parameters():
        out[f"grad.{name}"] = _np(flat[i:i + p.numel()].view_as(p))
        i += p.numel()
    return out, dict(mesh.shape)


def check_engine(inp, cfg, dev, world):
    from t2ms_tpu_torch.parallel.mesh import make_mesh
    from t2ms_tpu_torch.serving import ServingEngine
    from t2ms_tpu_torch.serving.engine import serve_worker
    from t2ms_tpu_torch.training.scaling import ScalingPlan
    mesh = make_mesh(data=world, model=1)
    dtype = _dtype(cfg["serve_dtype"])
    dit, vae = _models(inp, cfg, dev, dtype)
    plan = ScalingPlan(world, 1, dtype, mesh)
    emb = inp["eng_emb"]
    kw = dict(total_step=cfg["eng_steps"], out_lengths=(cfg["T"],),
              batch_tiers=(len(emb),), max_wait_ms=500.0,
              text_emb_dim=emb.shape[1], device=dev)
    if mesh.index("data") != 0:
        n = serve_worker(plan, dit, vae, **kw)
        return {"eng_dispatches": np.asarray(n)}, dict(mesh.shape)
    reqs = [(emb[i], cfg["T"], float(inp["eng_cfg"][i]),
             int(inp["eng_seed"][i])) for i in range(len(emb))]
    with ServingEngine(dit, vae, scaling_plan=plan, **kw) as eng:
        served = eng.generate(reqs)
    return {"eng_series": np.stack([r.series for r in served])}, dict(
        mesh.shape)


def check_engine_idle(inp, cfg, dev, world):
    """The data-parallel engine left idle for 2.5 times its group's
    timeout, then one request (the first engine request): the engine's
    no-op headers keep the other ranks' pending broadcast alive. The group
    is made again with a timeout of ``cfg["idle_timeout_s"]``, its ranks
    meeting at a barrier first so that each joins well inside it."""
    from t2ms_tpu_torch.parallel.mesh import init_process_group, make_mesh
    from t2ms_tpu_torch.serving import ServingEngine
    from t2ms_tpu_torch.serving.engine import serve_worker
    from t2ms_tpu_torch.training.scaling import ScalingPlan
    rank, timeout = dist.get_rank(), float(cfg["idle_timeout_s"])
    dist.barrier()
    dist.destroy_process_group()
    store = os.path.join(cfg["store_dir"], "idle")
    os.makedirs(store, exist_ok=True)
    init_process_group(dev, store, rank, world, timeout_s=timeout)
    mesh = make_mesh(data=world, model=1)
    dtype = _dtype(cfg["serve_dtype"])
    dit, vae = _models(inp, cfg, dev, dtype)
    plan = ScalingPlan(world, 1, dtype, mesh)
    emb = inp["eng_emb"]
    kw = dict(total_step=cfg["eng_steps"], out_lengths=(cfg["T"],),
              batch_tiers=(world,), max_wait_ms=5.0,
              text_emb_dim=emb.shape[1], device=dev)
    if mesh.index("data") != 0:
        n = serve_worker(plan, dit, vae, **kw)
        return {"idle_dispatches": np.asarray(n)}, dict(mesh.shape)
    with ServingEngine(dit, vae, scaling_plan=plan, **kw) as eng:
        time.sleep(2.5 * timeout)
        r = eng.generate([(emb[0], cfg["T"], float(inp["eng_cfg"][0]),
                           int(inp["eng_seed"][0]))])[0]
    return {"idle_series": r.series, "idle_batch": np.asarray(r.batch_size),
            "idle_mesh_timeout": np.asarray(mesh.timeout_s)}, dict(
        mesh.shape)


_CHECK_FNS = dict(train=check_train, ring=check_ring,
                  ring_big=check_ring_big, pp=check_pp,
                  sampler=check_sampler, grad=check_grad,
                  engine=check_engine, train_dp=check_train_dp,
                  pp_tanh=check_pp_tanh, infer=check_infer,
                  engine_idle=check_engine_idle)


def dryrun_multichip(rank: int, world: int, device, store_dir: str,
                     inputs, out_dir: str, checks=CHECKS) -> dict:
    """Join the process group (``init_process_group`` over a FileStore in
    ``store_dir``; NCCL on CUDA, gloo on the CPU), make ``checks`` at this
    rank on ``inputs`` (a dict or a ``save_inputs`` file), write the
    results to ``out_dir`` and leave the group. Returns this rank's
    record: the mesh shape, launch counts and seconds of each check. Any
    failure raises (and the other ranks fail at their next collective)."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.parallel.mesh import init_process_group
    dev = init_process_group(device, store_dir, rank, world)
    try:
        inp = load_inputs(inputs) if isinstance(inputs, str) else inputs
        cfg = dict(inp["config"], store_dir=store_dir)
        arrays, record = {}, dict(rank=rank, world=world,
                                  backend=dist.get_backend(), meshes={},
                                  launches={}, seconds={})
        for name in checks:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            out, shape = _CHECK_FNS[name](inp, cfg, dev, world)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            record["seconds"][name] = time.perf_counter() - t0
            record["launches"][name] = dict(_build.launch_counts)
            record["meshes"][name] = shape
            arrays.update(out)
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
        dist.barrier()
        return record
    finally:
        dist.destroy_process_group()


def launch(world: int, device: str, inputs_path: str, out_dir: str,
           timeout_s: float = 600.0, checks=CHECKS) -> None:
    """Run ``dryrun_multichip`` in ``world`` processes (rank r on card r on
    CUDA) over a FileStore in ``out_dir``; raises unless every rank exits
    0 within ``timeout_s``, and kills every rank it started either way."""
    out_dir, inputs_path = os.path.abspath(out_dir), os.path.abspath(
        inputs_path)
    os.makedirs(out_dir, exist_ok=True)
    store = tempfile.mkdtemp(prefix="store_", dir=out_dir)
    # the workers import the package from the directory that holds it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m", "t2ms_tpu_torch.parallel.dryrun",
                   "--rank", str(r), "--world", str(world), "--device",
                   device, "--store", store, "--inputs", inputs_path,
                   "--out", out_dir, "--checks", ",".join(checks)]
            log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(cmd, stdout=log, cwd=root,
                                          stderr=subprocess.STDOUT))
            log.close()
        deadline = time.monotonic() + timeout_s
        for r, p in enumerate(procs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc != 0:
                with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"dry-run rank {r} exited {rc}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _vae_sd(cfg, seed, device):
    from t2ms_tpu_torch.models.vae import LAVAE
    v = cfg["vae"]
    torch.manual_seed(seed)
    vae = LAVAE(1, v["num_hiddens"], v["num_residual_layers"],
                v["num_residual_hiddens"], cfg["latent_dim"],
                cfg["latent_len"], device=device)
    return vae.state_dict()


def flagship_inputs(seed: int, world: int, train_batch: int = 1024,
                    serve_batch: int = 256, dtype: str = "bf16") -> dict:
    """Full-width inputs from a seed: the flagship DiT (latent 64 x 30, 480
    tokens, d 128, 4 heads, depth 4; adaLN moved off zero) and LA-VAE with
    seeded random weights, the train step's batch and draws at
    ``train_batch``, ring attention at 16 tokens a rank and at N 2048, 4
    heads of 512 (beyond the fused-heads kernel), the pipeline's DiT
    blocks (d 32), the sampler's batch at ``serve_batch`` (euler/100, cfg
    7), the engine's ``serve_batch`` requests (euler/100)."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.denoisers.dit import DiTBlock
    cfg = dict(latent_len=30, latent_dim=64, d_model=128, depth=4, heads=4,
               mlp_ratio=2.0, T=96, lr=1e-4, train_total_step=100,
               train_dtype=dtype, serve_dtype=dtype, samp_steps=100,
               cfg=7.0, eng_steps=100, pp_heads=4, ring_big_refused=True,
               vae=dict(num_hiddens=128, num_residual_layers=2,
                        num_residual_hiddens=256))
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    dit = DiT(30, 64, 128, 4, 4, 2.0, device="cpu")
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "adaLN" in name:
                p.add_(0.02 * torch.randn_like(p))
    inp = {"config": cfg}
    inp.update({f"dit.{k}": v.numpy() for k, v in dit.state_dict().items()})
    inp.update({f"vae.{k}": v.numpy()
                for k, v in _vae_sd(cfg, seed + 1, "cpu").items()})
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    B, S = train_batch, serve_batch
    inp.update(train_x=f32(B, 96), train_emb=f32(B, 128),
               train_u=rng.random(B).astype(np.float32),
               train_x0=f32(B, 64, 30),
               train_coin=np.asarray(0.5, np.float32))
    inp.update(ring_qkv=f32(3, 1, 2, 16 * world, 16),
               ring_big_qkv=f32(3, 1, 4, 2048, 512))
    blk = DiTBlock(32, 4, 2.0)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.02 * torch.randn_like(p))
    inp.update({f"pp_block.{k}": v.numpy()
                for k, v in blk.state_dict().items()})
    inp.update(pp_x=f32(2 * world, 12, 32), pp_c=f32(2 * world, 32),
               pp_cot=f32(2 * world, 12, 32))
    inp.update(samp_x=f32(S, 96), samp_emb=f32(S, 128),
               samp_x0=f32(S, 64, 30))
    inp.update(grad_x=f32(2 * world, 64, 30),
               grad_t=np.linspace(0, 1, 2 * world).astype(np.float32),
               grad_e=f32(2 * world, 128))
    inp.update(eng_emb=f32(S, 128),
               eng_cfg=(2.0 + np.arange(S) % 6).astype(np.float32),
               eng_seed=(40 + np.arange(S)).astype(np.int64))
    return inp


def _main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, default=None,
                    help="run this one rank (else spawn --world ranks)")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store", default=None)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checks", default=",".join(CHECKS))
    a = ap.parse_args(argv)
    checks = tuple(c for c in a.checks.split(",") if c)
    if a.rank is None:
        launch(a.world, a.device, a.inputs, a.out, checks=checks)
        return 0
    if a.device == "cpu":
        torch.set_num_threads(1)
    dryrun_multichip(a.rank, a.world, a.device, a.store, a.inputs, a.out,
                     checks)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
