"""Motion-track (T2MS) denoiser training CLI (counterpart of
t2ms_tpu/cli/mytrain.py).

Reference: mytrain.py — YAML config via get_cfg (:113), sport-specific
loaders (:18-22), DiT(flow_dim) (:23), conv-VAE state load (:29-30),
grouped bucket batches, save every 100 epochs with hard stop at 4000
(:90-97), path scheme {backbone}_{denoiser}_{sport}_{caption}_{epc}. The
flags, defaults and artifacts (``model_{epoch}``, its loss-history
sidecar, ``model_{epoch}_ema``, ``train_log.jsonl``, ``loss_curve.png``)
are the JAX CLI's.

    python -m t2ms_tpu_torch.cli.mytrain --dataset_name benchpress ...

runs on the card, where the DiT over the (embedding_dim, flow_dim) latent
trains through the block kernels (``trainer._training_forward``): 1024
tokens for benchpress (64 x 64 in 2x2 patches), 800 for deadlift (64 x
50); ``main(argv, device="cpu")`` runs the eager DiT on the CPU. Each
step's draws come from a generator seeded with (general_seed, optimizer
step), so a resumed run draws what the uninterrupted one would.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.cli._common import (batch_seed, build_denoiser,
                                        build_motion_vae)
from t2ms_tpu_torch.config import (FrameworkConfig, denoiser_ckpt_dir,
                                   get_cfg, motion_pretrained_dir)
from t2ms_tpu_torch.data.prefetch import prefetch_to_device
from t2ms_tpu_torch.data.provider import motion_loader_provider
from t2ms_tpu_torch.parallel.mesh import init_from_env, is_main
from t2ms_tpu_torch.training import checkpoints as ckpt
from t2ms_tpu_torch.training import scaling
from t2ms_tpu_torch.training.ema import save_cli_ema, setup_cli_ema
from t2ms_tpu_torch.training.optim import onecycle_adamw
from t2ms_tpu_torch.training.trainer import (make_denoiser_train_step,
                                             precompute_latent_buckets)
from t2ms_tpu_torch.utils.logging import (JsonlLogger, StepTimer,
                                          plot_loss_curve, profile_trace)
from t2ms_tpu_torch.visualize.diagnostics import skipped


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train T2MS model")
    p.add_argument("--checkpoint_path", type=str, default="")
    p.add_argument("--dataset_name", type=str,
                   choices=["deadlift", "benchpress"], default="benchpress")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=20000)
    p.add_argument("--save_path", type=str,
                   default="./results/denoiser_results")
    p.add_argument("--general_seed", type=int, default=2025)
    p.add_argument("--usepretrainedvae", default=True)
    p.add_argument("--total_step", type=int, default=100)
    p.add_argument("--latent_cache", type=lambda s: s not in ("0", "False"),
                   default=True,
                   help="encode each sample through the frozen conv VAE "
                        "once at startup and train on cached latents")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA shadow weights (0 = off; 0.999 convention); "
                        "saved as model_{epoch}_ema, sampled with "
                        "cli.myinfer --use_ema")
    p.add_argument("--config", type=str, default="config.yaml")
    p.add_argument("--hard_stop_epoch", type=int, default=4000)
    p.add_argument("--max_ckpts_keep", type=int, default=0,
                   help="retention: keep at most N checkpoints "
                        "(0 = keep all, the reference behavior)")
    p.add_argument("--ckpt_keep_period", type=int, default=0,
                   help="retention: additionally preserve every N-th "
                        "epoch checkpoint forever (0 = off)")
    p.add_argument("--save_every", type=int, default=100)
    scaling.add_scaling_args(p)
    args = p.parse_args(argv)
    args = get_cfg(args)
    args.save_path = denoiser_ckpt_dir(
        args.save_path, args.backbone, args.denoiser, args.dataset_name,
        args.caption, args.pretrained_epc)
    args.pretrained_model_path = os.path.join(
        motion_pretrained_dir(args.split_base_num, args.dataset_name,
                              args.pretrained_epc), "final_model")
    return args


def load_motion_vae(args, device, path: str):
    """The frozen conv VAE on ``device``: ``path`` when it exists, else the
    deterministic random init (seed 0) with a WARNING."""
    torch.manual_seed(0)
    vae = build_motion_vae(args, device=device).eval()
    if os.path.exists(path):
        vae.load_state_dict(ckpt.load_params(path))
        print(f"Loaded pretrained VAE from {path}")
    else:
        print(f"WARNING: no pretrained VAE at {path}; using the "
              f"deterministic random init")
    for p in vae.parameters():
        p.requires_grad_(False)
    return vae


def build_motion_denoiser(args, compute_dtype, device):
    """The denoiser over the VAE's (embedding_dim, flow_dim) latent, from
    the deterministic init (seed 1)."""
    torch.manual_seed(1)
    return build_denoiser(args.denoiser, latent_len=args.flow_dim,
                          latent_dim=args.embedding_dim,
                          compute_dtype=compute_dtype, device=device)


def train(args, device=None):
    """Train on ``device`` (None = CUDA); returns the denoiser. Under
    ``torchrun`` with WORLD_SIZE > 1 every rank joins the process group
    and trains on its rows of each batch; rank 0 writes the files."""
    dev = init_from_env(resolve_device(device))
    print(f"Training config::\tepoch: {args.epochs}\t"
          f"save_path: {args.save_path}")
    os.makedirs(args.save_path, exist_ok=True)
    train_batcher, _ = motion_loader_provider(args, "train")
    if len(train_batcher) == 0:
        raise ValueError(
            f"no motion bucket holds a full batch of {args.batch_size} "
            f"rows (train loaders drop tails like the reference); "
            f"reduce --batch_size")

    plan = scaling.setup_scaling(args)
    args.scaling_plan = plan
    print(f"Scaling plan: {plan.describe()}")

    vae = load_motion_vae(args, dev, args.pretrained_model_path)
    denoiser = build_motion_denoiser(args, plan.compute_dtype, dev)
    print(f"Total learnable parameters: "
          f"{sum(p.numel() for p in denoiser.parameters())}")

    precoded = False
    if args.latent_cache:
        cached = precompute_latent_buckets(vae, train_batcher)
        if cached is not None:
            train_batcher, precoded = cached, True
            print("Latent cache: dataset encoded once through the frozen "
                  "VAE; hot loop trains on latents")

    opt = onecycle_adamw(denoiser.parameters(),
                         total_steps=max(1, len(train_batcher)) * args.epochs)
    step_fn = make_denoiser_train_step(
        denoiser, vae, opt, args.backbone, args.total_step,
        accum_steps=plan.accum_steps, precoded=precoded, device=dev,
        mesh=plan.mesh)

    loss_list, start_epoch, step_no = [], 0, 0
    if args.checkpoint_path:
        restored = ckpt.load_train_ckpt(args.checkpoint_path)
        denoiser.load_state_dict(restored["params"])
        opt.load_state_dict(restored["opt_state"])
        # "step" is the optimizer-step count (it seeds the draws); "epoch"
        # drives the loop
        step_no = int(restored["step"])
        loss_list = list(restored["loss_history"])
        start_epoch = int(restored["epoch"]) + 1
        print(f"Resumed from {args.checkpoint_path} at epoch {start_epoch}")

    ema, ema_update = setup_cli_ema(args.ema_decay, denoiser,
                                    args.checkpoint_path)
    print("training...")
    logger = (JsonlLogger(os.path.join(args.save_path, "train_log.jsonl"))
              if is_main() else None)
    with profile_trace(FrameworkConfig.from_env().profile_dir):
        _run_epochs(args, train_batcher, step_fn, denoiser, opt, dev,
                    logger, StepTimer(), loss_list, start_epoch, step_no,
                    ema, ema_update)
    return denoiser


def _run_epochs(args, batcher, step_fn, denoiser, opt, dev, logger, timer,
                loss_list, start_epoch, step_no, ema, ema_update):
    mgr = ckpt.TrainCheckpointManager(
        args.save_path, max_to_keep=args.max_ckpts_keep or None,
        keep_period=args.ckpt_keep_period or None)
    plots = not skipped("loss curve", "matplotlib")
    gen = torch.Generator(device=dev)
    for epoch in range(start_epoch, args.epochs):
        staged = prefetch_to_device(
            batcher.epoch(epoch), device=dev, mesh=args.scaling_plan.mesh,
            transform=lambda b: (np.asarray(b.x, np.float32),
                                 np.asarray(b.embedding, np.float32)))
        # losses stay on the device until the epoch ends (one transfer)
        losses = []
        for _, (x, emb) in staged:
            gen.manual_seed(batch_seed(args.general_seed, step_no))
            losses.append(step_fn(x, emb, generator=gen))
            if ema_update is not None:
                ema_update(ema, denoiser)
            step_no += 1
            timer.tick()
        # the reference persists a list it never appends to (mytrain.py:46,
        # 93); the epoch means are persisted, as in JAX
        loss_list.append(float(torch.stack(losses).mean()))
        print(f"[Epoch {epoch}] loss: {loss_list[-1]:.5f}")
        if logger is not None:
            logger.log(epoch=epoch, loss=loss_list[-1],
                       steps_per_sec=timer.steps_per_sec)
        if (epoch % args.save_every == 0 or epoch == args.epochs - 1) \
                and is_main():
            print(f"Saving model {epoch} to {args.save_path}...")
            if plots:
                plot_loss_curve(loss_list, args.save_path)
            mgr.save(epoch, denoiser.state_dict(), opt.state_dict(),
                     loss_list, opt_step=step_no)
            if ema is not None:
                save_cli_ema(args.save_path, ema, epoch, mgr.all_steps())
        if epoch == args.hard_stop_epoch:
            break


def main(argv=None, device=None):
    """Parse ``argv`` and train on ``device`` (None = CUDA: raises on a
    machine with no card unless ``device="cpu"``)."""
    args = get_args(argv)
    dev = resolve_device(device)
    stime = time.time()
    train(args, dev)
    print("Training complete.")
    print(time.time() - stime)


if __name__ == "__main__":
    main()
