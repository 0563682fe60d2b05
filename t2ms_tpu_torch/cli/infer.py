"""T2S CFG sampling CLI (counterpart of t2ms_tpu/cli/infer.py).

Reference: infer.py — flag surface (:127-147), run_multi x10 (:148-164),
the per-batch CFG loop (here one sampler call a batch), decode at
x_1.shape[-1], .npy outputs {x_1, x_t, x_t_latent_dec_array,
x_t_latent_enc_array} (:112-123), GT-vs-generated figures and the
diffusion GIF from batch 0 (:157-198). The flags, defaults and artifact
paths are the JAX CLI's. A ``--checkpoint_file`` ending in ``.pth`` (a
reference checkpoint) and a ``.pth`` ``--vae_file`` load straight into the
port's modules, whose names are the reference's. Where matplotlib is
absent the figures are skipped with one line; the arrays are written
either way.

    python -m t2ms_tpu_torch.cli.infer --dataset_name ETTh1_24 ...

runs on the card; ``main(argv, device="cpu")`` runs the plain path on the
CPU. Batch b of run r draws its noise from a generator seeded with
(general_seed + r, b). Under ``torchrun`` with WORLD_SIZE > 1 every rank
joins the process group and samples its rows of each batch that the data
axis divides, from the noise drawn for the whole batch, so the arrays are
those of a one-process run; rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.cli._common import (batch_seed, build_denoiser,
                                        build_t2s_vae)
from t2ms_tpu_torch.config import (denoiser_ckpt_dir, generation_dir,
                                   t2s_pretrained_dir)
from t2ms_tpu_torch.data.provider import t2s_loader_provider
from t2ms_tpu_torch.parallel.collectives import all_gather
from t2ms_tpu_torch.parallel.mesh import init_from_env, is_main, shard_batch
from t2ms_tpu_torch.sampling import decode_trajectory, make_cfg_sampler
from t2ms_tpu_torch.training import checkpoints as ckpt
from t2ms_tpu_torch.training.ema import load_ema_for_inference
from t2ms_tpu_torch.training.scaling import parse_dtype, setup_scaling
from t2ms_tpu_torch.utils.prng import torch_seed
from t2ms_tpu_torch.visualize.diagnostics import (plot_generation_figs,
                                                  save_diffusion_gif)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Inference flow matching model")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--data_root", type=str, default="./Data")
    p.add_argument("--save_path", type=str,
                   default="./results/denoiser_results")
    p.add_argument("--usepretrainedvae", default=True)
    p.add_argument("--backbone", type=str, default="flowmatching")
    p.add_argument("--denoiser", type=str, default="DiT")
    p.add_argument("--cfg_scale", type=float, default=7)
    p.add_argument("--total_step", type=int, default=100)
    p.add_argument("--solver", type=str, default="euler",
                   choices=["euler", "heun", "midpoint", "ddim"],
                   help="integrator. euler = reference parity "
                        "(infer.py:84; flow ODE or DDPM ancestral). "
                        "heun/midpoint (flow only) are order 2 (2 model "
                        "evals a step). ddim (ddpm only) samples "
                        "deterministically over --sample_steps of the "
                        "total_step schedule")
    p.add_argument("--sample_steps", type=int, default=0,
                   help="ddim only: sampling steps over the --total_step "
                        "training schedule (0 = total_step)")
    p.add_argument("--checkpoint_id", type=int, default=19999)
    p.add_argument("--use_ema", type=lambda s: s not in ("0", "False"),
                   default=False,
                   help="sample from the EMA shadow weights saved by "
                        "cli.train --ema_decay (model_{id}_ema) instead "
                        "of the live weights; errors if absent")
    p.add_argument("--dataset_name", type=str, default="exchangerate_24")
    p.add_argument("--run_multi", type=lambda s: s not in ("0", "False"),
                   default=False)
    p.add_argument("--general_seed", type=int, default=2025)
    p.add_argument("--max_batches", type=int, default=0,
                   help="0 = all test batches")
    p.add_argument("--checkpoint_file", type=str, default="",
                   help="explicit denoiser checkpoint path; a .pth file "
                        "is a reference torch checkpoint")
    p.add_argument("--latent_grid", type=int, default=30,
                   help="VAE latent grid length (30 = T2S reference; "
                        "use 6 with imported reference MLP checkpoints)")
    p.add_argument("--vae_file", type=str, default="",
                   help="explicit VAE checkpoint path; a .pth file is a "
                        "reference torch checkpoint (whole pickled module "
                        "or state_dict)")
    p.add_argument("--compute_dtype", type=str, default="f32",
                   choices=["f32", "float32", "bf16", "bfloat16"],
                   help="denoiser activation dtype")
    args = p.parse_args(argv)
    args.mix_train = False
    model_root = args.dataset_name.split("_")[0]
    args.checkpoint_path = args.checkpoint_file or os.path.join(
        denoiser_ckpt_dir(args.save_path, args.backbone, args.denoiser,
                          model_root),
        f"model_{args.checkpoint_id}")
    args.pretrained_model_path = args.vae_file or os.path.join(
        t2s_pretrained_dir(model_root), "final_model")
    args.generation_save_path = generation_dir(
        args.save_path, args.backbone, args.denoiser, args.dataset_name,
        args.cfg_scale, args.total_step)
    return args


def load_models(args, device, probe_len: int):
    """The LA-VAE and the denoiser on ``device``, loaded as the JAX CLIs
    load them (cli.infer and cli.serve): a ``.pth`` VAE or denoiser file
    is a reference checkpoint; else ``final_model`` and ``model_{id}``
    (``load_train_ckpt``); a file that is absent leaves the deterministic
    random init with a WARNING. ``probe_len`` is the series length of the
    zero probe whose latent length a reference MLP checkpoint must match.
    Returns (vae, denoiser)."""
    torch.manual_seed(0)      # cli.train's random frozen VAE, if missing
    vae = build_t2s_vae(args, device=device).eval()
    path = args.pretrained_model_path
    if path.endswith(".pth") and os.path.exists(path):
        ckpt.load_reference_state_dict(vae, path)
        print(f"Imported reference VAE from {path}")
    elif os.path.exists(path):
        vae.load_state_dict(ckpt.load_params(path))
    else:
        print(f"WARNING: no pretrained VAE at {path}; using the "
              f"deterministic random init (pass --vae_file for real "
              f"outputs)")

    path = args.checkpoint_path
    imported = path.endswith(".pth") and os.path.exists(path)
    if imported and args.denoiser == "MLP":
        # the reference MLP hard-codes its token count (mlp.py:49-85, 6 at
        # reference scale): the VAE's latent grid must match it, or the
        # first forward would fail deep inside
        with torch.no_grad():
            z, _ = vae.encode(torch.zeros((1, probe_len), device=device))
        sd = ckpt.load_torch_file(path)
        ckpt_len = int(sd["layers.0.mlp2.0.weight"].shape[1])
        if ckpt_len != z.shape[-1]:
            raise ValueError(
                f"imported reference MLP expects latent length {ckpt_len} "
                f"but the VAE produces {z.shape[-1]}; pass a VAE with "
                f"latent_grid={ckpt_len} (--vae_file)")
    torch.manual_seed(1)
    denoiser = build_denoiser(args.denoiser, latent_len=args.latent_grid,
                              latent_dim=64,
                              compute_dtype=parse_dtype(args.compute_dtype),
                              device=device)
    if imported:
        ckpt.load_reference_state_dict(denoiser, path)
        print(f"Imported reference denoiser from {path}")
    elif os.path.exists(path):
        denoiser.load_state_dict(ckpt.load_train_ckpt(path)["params"])
        print(f"Loaded denoiser from {path}")
    else:
        print(f"WARNING: no checkpoint at {path}; sampling from random "
              f"weights")
    return vae, denoiser


def _build_ctx(args, device=None):
    """Everything reused across runs: loader, models, the plan and the
    samplers."""
    dev = init_from_env(resolve_device(device))
    plan = setup_scaling(args, for_training=False)
    if plan.n_data > 1:
        print(f"Serving plan: {plan.describe()}")
    datasets, batcher = t2s_loader_provider(args, "test")
    length = datasets[0].length
    vae, denoiser = load_models(args, dev, length)
    if args.use_ema:
        denoiser.load_state_dict(load_ema_for_inference(
            args.checkpoint_path))
    return dict(batcher=batcher, length=length, vae=vae, denoiser=denoiser,
                device=dev, plan=plan, samplers={})


def infer(args, run_dir: str, seed_offset: int = 0, collect_gif=True,
          ctx=None):
    os.makedirs(run_dir, exist_ok=True)
    print(f"Inference config::Step: {args.total_step}\t"
          f"CFG Scale: {args.cfg_scale}")
    ctx = ctx if ctx is not None else _build_ctx(args)
    batcher, length, vae = ctx["batcher"], ctx["length"], ctx["vae"]
    if collect_gif not in ctx["samplers"]:
        ctx["samplers"][collect_gif] = make_cfg_sampler(
            ctx["denoiser"], vae, args.backbone, args.total_step,
            args.cfg_scale, out_length=length,
            collect_trajectory=collect_gif, solver=args.solver,
            sample_steps=args.sample_steps or None, device=ctx["device"])
    sampler = ctx["samplers"][collect_gif]
    gen = torch.Generator(device=ctx["device"])

    x1s, xts, lat_dec, lat_enc = [], [], [], []
    gif_frames = None
    for b, batch in enumerate(batcher.epoch(0)):
        if args.max_batches and b >= args.max_batches:
            break
        print(f"Generating {b}th Batch TS...")
        gen.manual_seed(
            torch_seed(batch_seed(args.general_seed + seed_offset, b)))
        x_in = np.asarray(batch.x, np.float32)
        e_in = np.asarray(batch.embedding, np.float32)
        mesh = ctx["plan"].mesh
        if mesh is not None and x_in.shape[0] % ctx["plan"].n_data == 0:
            # DP-shard the serving batch; tail batches that don't divide
            # the data axis run replicated. (Deliberate deviation: the
            # reference drops eval tails too — dataloader.py:98,111
            # drop_last=True — but dropping rows silently shrinks the
            # metric set, so our test loaders keep them; every run keeps
            # the same rows, so multi-run metrics stay aligned.)
            out = _sample_sharded(sampler, vae, args, mesh, x_in, e_in, gen,
                                  ctx["device"])
        else:
            out = sampler(x_in, e_in, generator=gen)
        x1s.append(np.asarray(batch.x))
        xts.append(out.series.cpu().numpy())
        lat_dec.append(out.latent.cpu().numpy())
        lat_enc.append(out.latent_enc.cpu().numpy())
        if b == 0 and collect_gif:
            frames = decode_trajectory(vae, out.trajectory, length)
            with torch.no_grad():
                gt, _ = vae.decode(out.latent_enc[:1], length)
            gif_frames = list(frames.cpu().numpy()) + [gt[0].cpu().numpy()]

    x_1 = np.concatenate(x1s)[:, :, None]
    x_t = np.concatenate(xts)[:, :, None]
    if not is_main():
        return x_1, x_t, gif_frames
    np.save(os.path.join(run_dir, "x_1.npy"), x_1)
    np.save(os.path.join(run_dir, "x_t.npy"), x_t)
    np.save(os.path.join(run_dir, "x_t_latent_dec_array.npy"),
            np.concatenate(lat_dec))
    np.save(os.path.join(run_dir, "x_t_latent_enc_array.npy"),
            np.concatenate(lat_enc))
    return x_1, x_t, gif_frames


def _sample_sharded(sampler, vae, args, mesh, x_in, e_in, gen, dev):
    """This rank's rows of one batch, sampled from the global batch's
    draws (x_t0, then each DDPM ancestral step's noise, in the order the
    one-device sampler draws them), and gathered whole over 'data'."""
    x_loc, e_loc = shard_batch(mesh, (x_in, e_in))
    with torch.no_grad():
        z, _ = vae.encode(torch.as_tensor(x_loc, device=dev))
    shape = (x_in.shape[0],) + tuple(z.shape[1:])
    x_t0 = torch.randn(shape, generator=gen, dtype=z.dtype, device=dev)
    step_noise = None
    if args.backbone == "ddpm" and args.solver != "ddim":
        step_noise = torch.stack([
            torch.randn(shape, generator=gen, dtype=z.dtype, device=dev)
            for _ in range(args.total_step)])
        step_noise = shard_batch(mesh, step_noise.transpose(0, 1)
                                 ).transpose(0, 1)
    out = sampler(x_loc, e_loc, x_t0=shard_batch(mesh, x_t0),
                  step_noise=step_noise)
    group = mesh.group("data")
    return out._replace(**{k: all_gather(getattr(out, k), group)
                           for k in ("series", "latent", "latent_enc")})


def _figures(args, x_1, x_t, frames=None) -> None:
    if not is_main():
        return
    if importlib.util.find_spec("matplotlib") is None:
        print("figures skipped: matplotlib is not installed")
        return
    plot_generation_figs(x_1, x_t, args.generation_save_path)
    if frames:
        save_diffusion_gif(frames, args.generation_save_path,
                           f"animation_{args.backbone}.gif", step_stride=1)


def main(argv=None, device=None):
    """Parse ``argv`` and sample on ``device`` (None = CUDA: raises on a
    machine with no card unless ``device="cpu"``)."""
    args = get_args(argv)
    dev = resolve_device(device)
    print("start generate", args.run_multi)
    if args.run_multi:
        ctx = _build_ctx(args, dev)      # one loader and one sampler
        x_1, x_t, _ = infer(args, args.generation_save_path, 0,
                            collect_gif=False, ctx=ctx)
        for run_index in range(10):
            run_dir = os.path.join(args.generation_save_path,
                                   f"run_{run_index}")
            x_1, x_t, _ = infer(args, run_dir, run_index + 1,
                                collect_gif=False, ctx=ctx)
        _figures(args, x_1, x_t)
    else:
        x_1, x_t, frames = infer(args, args.generation_save_path, 0,
                                 ctx=_build_ctx(args, dev))
        _figures(args, x_1, x_t, frames)


if __name__ == "__main__":
    main()
