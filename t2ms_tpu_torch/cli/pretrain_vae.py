"""T2S LA-VAE pretraining CLI (counterpart of t2ms_tpu/cli/pretrain_vae.py).

Reference: pretrained_lavae_unified.py — argparse surface (:111-127),
mix/plain train paths (:142-174), final_model checkpoint, reconstruction
inference with comparison plots, PCA/t-SNE, MAE/RMSE to metrics.txt
(:55-108). The flags, defaults and artifacts (``model_epoch_{e}``,
``final_model``, ``train_log.jsonl``, ``metrics.txt`` with one
``MAE_{L}``/``RMSE_{L}`` pair per length) are the JAX CLI's, so
``cli.train`` finds ``final_model`` under ``t2s_pretrained_dir`` after a
2000-update run. Where matplotlib or sklearn is absent the figures are
skipped with one line; ``metrics.txt`` is written either way.

    python -m t2ms_tpu_torch.cli.pretrain_vae --dataset_name ETTh1 ...

runs on the card; ``main(argv, device="cpu")`` runs it on the CPU. The
VAE's init is seeded with ``--general_seed``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.cli._common import build_t2s_vae
from t2ms_tpu_torch.data.prefetch import prefetch_to_device
from t2ms_tpu_torch.data.provider import t2s_loader_provider
from t2ms_tpu_torch.training import checkpoints as ckpt
from t2ms_tpu_torch.training.optim import warmup_cosine_adamw
from t2ms_tpu_torch.training.trainer import make_vae_train_step
from t2ms_tpu_torch.utils.logging import JsonlLogger, StepTimer
from t2ms_tpu_torch.visualize.diagnostics import (plot_comparison,
                                                  plot_pca_tsne)


def get_args(argv=None):
    p = argparse.ArgumentParser()
    # --dataset_path is the reference's name for the same flag
    # (pretrained_lavae_unified.py:112)
    p.add_argument("--dataset_name", "--dataset_path", dest="dataset_name",
                   type=str, default="ETTh1")
    p.add_argument("--data_root", type=str, default="./Data")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_training_updates", type=int, default=2000)
    p.add_argument("--save_path", type=str,
                   default="results/saved_pretrained_models/")
    p.add_argument("--general_seed", type=int, default=42)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--block_hidden_size", type=int, default=128)
    p.add_argument("--num_residual_layers", type=int, default=2)
    p.add_argument("--res_hidden_size", type=int, default=256)
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--mix_train", type=lambda s: s not in ("0", "False"),
                   default=True)
    p.add_argument("--inference_samples", type=int, default=8)
    # legacy VQ flags the reference defines but its AE never consumes
    # (pretrained_lavae_unified.py:123-125): accepted so reference sweep
    # scripts run unchanged, ignored
    p.add_argument("--num_embeddings", type=int, default=128,
                   help="ignored (reference legacy)")
    p.add_argument("--compression_factor", type=int, default=4,
                   help="ignored (reference legacy)")
    p.add_argument("--commitment_cost", type=float, default=0.25,
                   help="ignored (reference legacy)")
    return p.parse_args(argv)


def train(args, device=None):
    """Pretrain on ``device`` (None = CUDA); returns (model, test batcher,
    save directory)."""
    dev = resolve_device(device)
    save_dir = os.path.join(
        args.save_path,
        f"dataset{args.dataset_name}_epoch{args.num_training_updates}")
    os.makedirs(save_dir, exist_ok=True)

    torch.manual_seed(args.general_seed)
    model = build_t2s_vae(args, device=dev)
    opt = warmup_cosine_adamw(model.parameters(), args.learning_rate)
    _, train_batcher = t2s_loader_provider(args, "train")
    _, test_batcher = t2s_loader_provider(args, "test")
    step_fn = make_vae_train_step(model, opt, device=dev)

    logger = JsonlLogger(os.path.join(save_dir, "train_log.jsonl"))
    timer = StepTimer()
    updates, epoch = 0, 0
    while updates < args.num_training_updates:
        # losses stay on the device until the epoch ends (one transfer)
        losses = []
        staged = prefetch_to_device(
            train_batcher.epoch(epoch), device=dev,
            transform=lambda b: np.asarray(b.x, np.float32))
        for _, x in staged:
            loss, _ = step_fn(x)
            losses.append(loss)
            timer.tick()
            updates += 1
            if updates >= args.num_training_updates:
                break
        mean = float(torch.stack(losses).mean())
        print(f"Epoch: {epoch}, Loss: {mean:.6f}")
        logger.log(epoch=epoch, loss=mean, steps_per_sec=timer.steps_per_sec)
        if epoch % max(1, args.num_training_updates // 10) == 0:
            ckpt.save_params(save_dir, model.state_dict(),
                             f"model_epoch_{epoch}")
        epoch += 1
    ckpt.save_params(save_dir, model.state_dict(), "final_model")
    print("Training complete.")
    return model, test_batcher, save_dir


def _mae_rmse(rs, gs):
    r = np.concatenate([np.ravel(a) for a in rs])
    g = np.concatenate([np.ravel(a) for a in gs])
    return (float(np.mean(np.abs(r - g))),
            float(np.sqrt(np.mean((r - g) ** 2))))


def _figures(real, recon, save_dir) -> None:
    missing = [m for m in ("matplotlib", "sklearn")
               if importlib.util.find_spec(m) is None]
    if missing:
        print(f"figures skipped: {', '.join(missing)} not installed")
        return
    plot_comparison(real, recon, save_dir)
    plot_pca_tsne(real, recon, save_dir)


@torch.no_grad()
def inference(model, test_batcher, save_dir, num_samples=8):
    """Reconstruction eval: comparison plots, PCA/t-SNE, MAE/RMSE overall
    and per length bucket (reference any_length_evaluation, :97-108,
    groups the samples by length; metrics.txt carries the overall numbers
    and one MAE_{L}/RMSE_{L} pair per length met). A bucket that already
    holds ``num_samples`` rows is skipped; the loop ends once every
    bucket is full."""
    dev = next(model.parameters()).device
    model.eval()
    groups: dict[int, tuple[list, list]] = {}
    for batch in test_batcher.epoch(0):
        x = np.asarray(batch.x, np.float32)
        real_g, recon_g = groups.setdefault(int(x.shape[-1]), ([], []))
        if len(real_g) >= num_samples:
            continue
        out, _, _, _ = model(torch.from_numpy(x).to(dev))
        real_g.extend(x)
        recon_g.extend(out.cpu().numpy())
        if all(len(g[0]) >= num_samples for g in groups.values()) \
                and len(groups) >= test_batcher.num_buckets:
            break
    real = [a for g in groups.values() for a in g[0][:num_samples]]
    recon = [a for g in groups.values() for a in g[1][:num_samples]]
    _figures(real, recon, save_dir)

    mae, rmse = _mae_rmse(real, recon)
    with open(os.path.join(save_dir, "metrics.txt"), "w") as f:
        f.write(f"MAE: {mae}\n")
        f.write(f"RMSE: {rmse}\n")
        for L in sorted(groups):
            gm, gr = _mae_rmse(groups[L][0][:num_samples],
                               groups[L][1][:num_samples])
            f.write(f"MAE_{L}: {gm}\n")
            f.write(f"RMSE_{L}: {gr}\n")
            print(f"len {L}: MAE {gm:.6f} RMSE {gr:.6f}")
    print(f"MAE: {mae:.6f} RMSE: {rmse:.6f}")
    return mae, rmse


def main(argv=None, device=None):
    """Parse ``argv``, pretrain and evaluate on ``device`` (None = CUDA:
    raises on a machine with no card unless ``device="cpu"``)."""
    args = get_args(argv)
    model, test_batcher, save_dir = train(args, resolve_device(device))
    print("Starting inference...")
    return inference(model, test_batcher, save_dir, args.inference_samples)


if __name__ == "__main__":
    main()
