"""T2S denoiser training CLI (counterpart of t2ms_tpu/cli/train.py).

Reference: train.py — flag surface (:138-158), mix/split training paths
(:52-136), OneCycle AdamW (:37-38), checkpoint-resume (:42-47), save every
N epochs, path scheme checkpoints/{backbone}_{denoiser}_{dataset}. The
flags, defaults and artifacts (``model_{epoch}``, its loss-history
sidecar, ``model_{epoch}_ema``, ``train_log.jsonl``) are the JAX CLI's.

    python -m t2ms_tpu_torch.cli.train --dataset_name ETTh1 ...

runs on the card; ``main(argv, device="cpu")`` runs the plain path on the
CPU. Each step's draws come from a generator seeded with (general_seed,
optimizer step), so a resumed run draws what the uninterrupted one would.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.cli._common import (batch_seed, build_denoiser,
                                        build_t2s_vae)
from t2ms_tpu_torch.config import (FrameworkConfig, denoiser_ckpt_dir,
                                   t2s_pretrained_dir)
from t2ms_tpu_torch.data.prefetch import prefetch_to_device
from t2ms_tpu_torch.data.provider import t2s_loader_provider
from t2ms_tpu_torch.parallel.mesh import init_from_env, is_main
from t2ms_tpu_torch.training import checkpoints as ckpt
from t2ms_tpu_torch.training import scaling
from t2ms_tpu_torch.training.ema import save_cli_ema, setup_cli_ema
from t2ms_tpu_torch.training.optim import onecycle_adamw
from t2ms_tpu_torch.training.trainer import (make_denoiser_train_step,
                                             precompute_latent_buckets)
from t2ms_tpu_torch.utils.logging import (JsonlLogger, StepTimer,
                                          profile_trace)
from t2ms_tpu_torch.utils.prng import torch_seed


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train T2S model")
    p.add_argument("--checkpoint_path", type=str, default="")
    p.add_argument("--dataset_name", type=str, default="ETTh1")
    p.add_argument("--data_root", type=str, default="./Data")
    p.add_argument("--batch_size", type=int, default=9216)
    p.add_argument("--epochs", type=int, default=20000)
    p.add_argument("--save_path", type=str,
                   default="./results/denoiser_results")
    p.add_argument("--mix_train", type=lambda s: s not in ("0", "False"),
                   default=True)
    p.add_argument("--usepretrainedvae", default=True,
                   help="accepted for compatibility; the VAE encoder is "
                        "always frozen (the reference CLI cannot "
                        "unfreeze it either: its flag parses any string "
                        "as True)")
    p.add_argument("--latent_cache", type=lambda s: s not in ("0", "False"),
                   default=True,
                   help="encode each sample through the frozen VAE once "
                        "at startup and train on cached latents (the "
                        "encoder is frozen and deterministic); 0/False "
                        "keeps the in-step encode")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA decay of a shadow copy of the denoiser "
                        "weights (0 = off, the reference behaviour); saved "
                        "as model_{epoch}_ema, sampled with cli.infer "
                        "--use_ema")
    p.add_argument("--total_step", type=int, default=100)
    p.add_argument("--backbone", type=str, default="flowmatching")
    p.add_argument("--denoiser", type=str, default="DiT")
    p.add_argument("--general_seed", type=int, default=2025)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--max_ckpts_keep", type=int, default=0,
                   help="retention: keep at most N checkpoints "
                        "(0 = keep all, the reference behavior)")
    p.add_argument("--ckpt_keep_period", type=int, default=0,
                   help="retention: additionally preserve every N-th "
                        "epoch checkpoint forever (0 = off)")
    scaling.add_scaling_args(p)
    args = p.parse_args(argv)
    root = args.dataset_name.split("_")[0]
    args.pretrained_model_path = os.path.join(
        t2s_pretrained_dir(root), "final_model")
    args.save_path = denoiser_ckpt_dir(args.save_path, args.backbone,
                                       args.denoiser, args.dataset_name)
    return args


def train(args, device=None):
    """Train on ``device`` (None = CUDA); returns the denoiser. Under
    ``torchrun`` with WORLD_SIZE > 1 every rank joins the process group
    and trains on its rows of each batch; rank 0 writes the files."""
    dev = init_from_env(resolve_device(device))
    print(f"Training config::\tepoch: {args.epochs}\t"
          f"save_path: {args.save_path}")
    os.makedirs(args.save_path, exist_ok=True)
    datasets, batcher = t2s_loader_provider(args, "train")
    if len(batcher) == 0:
        raise ValueError(
            f"no length bucket holds a full batch of {args.batch_size} "
            f"rows (train loaders drop tails like the reference, "
            f"dataloader.py:98); reduce --batch_size")

    plan = scaling.setup_scaling(args)
    args.scaling_plan = plan
    print(f"Scaling plan: {plan.describe()}")

    # deterministic random inits (a missing VAE is the same random frozen
    # encoder in cli.infer)
    torch.manual_seed(0)
    vae = build_t2s_vae(device=dev).eval()
    if os.path.exists(args.pretrained_model_path):
        vae.load_state_dict(ckpt.load_params(args.pretrained_model_path))
        print(f"Loaded pretrained VAE from {args.pretrained_model_path}")
    else:
        print(f"WARNING: no pretrained VAE at {args.pretrained_model_path}; "
              "training against a random frozen encoder")
    for p in vae.parameters():
        p.requires_grad_(False)

    torch.manual_seed(1)
    denoiser = build_denoiser(args.denoiser, latent_len=30, latent_dim=64,
                              compute_dtype=plan.compute_dtype, device=dev)
    print(f"Total learnable parameters: "
          f"{sum(p.numel() for p in denoiser.parameters())}")

    precoded = False
    if args.latent_cache:
        cached = precompute_latent_buckets(vae, batcher)
        if cached is not None:
            batcher, precoded = cached, True
            print("Latent cache: dataset encoded once through the frozen "
                  "VAE; hot loop trains on latents")
        else:
            print("Latent cache skipped (store would exceed the host-RAM "
                  "budget); keeping the in-step encode")

    opt = onecycle_adamw(denoiser.parameters(),
                         total_steps=len(batcher) * args.epochs)
    step_fn = make_denoiser_train_step(
        denoiser, vae, opt, args.backbone, args.total_step,
        accum_steps=plan.accum_steps, precoded=precoded, device=dev,
        mesh=plan.mesh)

    loss_list, start_epoch, step_no = [], 0, 0
    if args.checkpoint_path:
        restored = ckpt.load_train_ckpt(args.checkpoint_path)
        denoiser.load_state_dict(restored["params"])
        opt.load_state_dict(restored["opt_state"])
        # "step" is the optimizer-step count (it seeds the draws: the
        # epoch there would replay draws already used); "epoch" drives
        # the loop
        step_no = int(restored["step"])
        loss_list = list(restored["loss_history"])
        start_epoch = int(restored["epoch"]) + 1
        print(f"Resumed from {args.checkpoint_path} at epoch {start_epoch}")

    ema, ema_update = setup_cli_ema(args.ema_decay, denoiser,
                                    args.checkpoint_path)
    logger = (JsonlLogger(os.path.join(args.save_path, "train_log.jsonl"))
              if is_main() else None)
    with profile_trace(FrameworkConfig.from_env().profile_dir):
        _run_epochs(args, batcher, step_fn, denoiser, opt, dev, logger,
                    StepTimer(), loss_list, start_epoch, step_no, ema,
                    ema_update)
    return denoiser


def _run_epochs(args, batcher, step_fn, denoiser, opt, dev, logger, timer,
                loss_list, start_epoch, step_no, ema, ema_update):
    mgr = ckpt.TrainCheckpointManager(
        args.save_path, max_to_keep=args.max_ckpts_keep or None,
        keep_period=args.ckpt_keep_period or None)
    gen = torch.Generator(device=dev)
    for epoch in range(start_epoch, args.epochs):
        staged = prefetch_to_device(
            batcher.epoch(epoch), device=dev, mesh=args.scaling_plan.mesh,
            transform=lambda b: (np.asarray(b.x, np.float32),
                                 np.asarray(b.embedding, np.float32)))
        # losses stay on the device until the epoch ends (one transfer)
        epoch_losses = []
        for i, (_, (x, emb)) in enumerate(staged):
            gen.manual_seed(
                torch_seed(batch_seed(args.general_seed, step_no)))
            loss = step_fn(x, emb, generator=gen)
            if ema_update is not None:
                ema_update(ema, denoiser)
            step_no += 1
            epoch_losses.append(loss)
            timer.tick()
            if i % 100 == 0:
                print(f"[Epoch {epoch}] [batch {i}] loss: {float(loss)}")
        loss_list.extend(torch.stack(epoch_losses).tolist())
        if logger is not None:
            logger.log(epoch=epoch, loss=loss_list[-1],
                       steps_per_sec=timer.steps_per_sec)
        if (epoch % args.save_every == 0 or epoch == args.epochs - 1) \
                and is_main():
            print(f"Saving model {epoch} to {args.save_path}...")
            mgr.save(epoch, denoiser.state_dict(), opt.state_dict(),
                     loss_list, opt_step=step_no)
            if ema is not None:
                save_cli_ema(args.save_path, ema, epoch, mgr.all_steps())


def main(argv=None, device=None):
    """Parse ``argv`` and train on ``device`` (None = CUDA: raises on a
    machine with no card unless ``device="cpu"``)."""
    args = get_args(argv)
    dev = resolve_device(device)
    stime = time.time()
    train(args, dev)
    print(time.time() - stime)


if __name__ == "__main__":
    main()
