"""Motion-track VAE pretraining CLI (counterpart of
t2ms_tpu/cli/pretrain_mylavae.py).

Reference: pretrained_mylavae.py — trains AttentionSeq2SeqAutoencoder (the
TSae, not the conv VAE; :185) with warmup+cosine (:186), grouped bucket
batches transposed to (B, T, n_f) (:207-210), periodic validation +
checkpoints (:220-231), then autoregressive reconstruction and the PCA/t-SNE
figure (:132-163). ``--vae_kind conv`` pretrains the conv myvqvae instead,
the VAE that ``cli.mytrain`` and ``cli.myinfer`` load.

The flags, defaults and artifacts are the JAX CLI's: ``model_epoch_{e}``
every ``total_epochs // 10`` epochs and ``final_model`` (``params.pt``
state_dicts) under ``{split_base_num}_{sport}_epoch{config epoch}``, where
``cli.mytrain`` looks, and ``train_log.jsonl``. Where matplotlib or sklearn
is absent the figures are skipped with one line.

    python -m t2ms_tpu_torch.cli.pretrain_mylavae --vae_kind conv ...

runs on the card; ``main(argv, device="cpu")`` runs it on the CPU. The
model's init is seeded with ``general_seed``; the TSae's dropout at step s
draws from a generator seeded with (general_seed + 1, s), as JAX folds the
step into its dropout key.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.cli._common import batch_seed, build_motion_vae
from t2ms_tpu_torch.config import get_cfg, motion_pretrained_dir
from t2ms_tpu_torch.data.provider import motion_loader_provider
from t2ms_tpu_torch.models.vae.lavae import lavae_loss
from t2ms_tpu_torch.models.vae.tsae import TSae, tsae_loss
from t2ms_tpu_torch.training import checkpoints as ckpt
from t2ms_tpu_torch.training.optim import warmup_cosine_adamw
from t2ms_tpu_torch.training.trainer import make_vae_train_step
from t2ms_tpu_torch.utils.logging import (JsonlLogger, StepTimer,
                                          plot_loss_curve)
from t2ms_tpu_torch.utils.prng import torch_seed
from t2ms_tpu_torch.visualize.diagnostics import plot_pca_tsne, skipped


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_name", type=str,
                   choices=["deadlift", "benchpress"], default="benchpress")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--save_path", type=str,
                   default="results/saved_pretrained_models/")
    p.add_argument("--only_inference", type=lambda s: s not in ("0", "False"),
                   default=False)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--config", type=str, default="config.yaml")
    p.add_argument("--vae_kind", type=str, default="tsae",
                   choices=["tsae", "conv"])
    p.add_argument("--max_updates", type=int, default=0,
                   help="override pretrained_epc update budget (0=config)")
    args = p.parse_args(argv)
    return get_cfg(args)


def _build(args, device):
    if args.vae_kind == "tsae":
        return TSae(n_features=args.input_dim, flow_dim=args.flow_dim,
                    num_encoder_layers=args.num_encoder_layers,
                    num_decoder_layers=args.num_decoder_layers,
                    d_ff=args.d_ff, num_heads=args.num_heads, device=device)
    return build_motion_vae(args, device=device)


class _TSaeStep:
    """One TSae update on the teacher-forced MSE with the reference's
    p=0.1 dropout (TSae.py:114; train mode in shared_eval); step s draws
    its masks from a generator seeded with (seed, s)."""

    def __init__(self, model, opt, seed, device):
        self.model, self.opt, self.seed = model, opt, seed
        self.gen = torch.Generator(device=device)
        self.steps = 0

    def __call__(self, x):
        self.gen.manual_seed(
            torch_seed(batch_seed(self.seed, self.steps)))
        self.opt.zero_grad(set_to_none=True)
        loss, _ = tsae_loss(self.model, x,
                            self.model.dropout_draws(generator=self.gen))
        loss.backward()
        self.opt.step()
        self.steps += 1
        return loss.detach(), loss.detach()


def _series(batch, vae_kind, device):
    """The batch as the model takes it: (B, T, n_f) for the TSae, (B, n_f,
    T) for the conv VAE."""
    x = np.asarray(batch.x, np.float32)
    if vae_kind == "tsae":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    return torch.from_numpy(x).to(device)


def train(args, device=None):
    """Pretrain on ``device`` (None = CUDA); returns (model, test batcher,
    save directory)."""
    dev = resolve_device(device)
    save_dir = motion_pretrained_dir(args.split_base_num, args.dataset_name,
                                     args.pretrained_epc)
    save_dir = os.path.join(args.save_path, os.path.basename(save_dir)) \
        if not save_dir.startswith(args.save_path) else save_dir
    os.makedirs(save_dir, exist_ok=True)

    train_batcher, test_batcher = motion_loader_provider(args, "train")
    torch.manual_seed(args.general_seed)
    model = _build(args, dev)
    opt = warmup_cosine_adamw(model.parameters(), args.learning_rate)
    if args.vae_kind == "tsae":
        step_fn = _TSaeStep(model, opt, args.general_seed + 1, dev)
    else:
        step_fn = make_vae_train_step(model, opt, device=dev)

    budget = args.max_updates or args.pretrained_epc
    total_epochs = int((budget + args.epoch) / max(1, len(train_batcher))
                       + 0.5)
    print(f"total epoch : {total_epochs}")
    logger = JsonlLogger(os.path.join(save_dir, "train_log.jsonl"))
    timer = StepTimer()
    loss_list = []
    plots = not skipped("loss curve", "matplotlib")
    for epoch in range(total_epochs):
        # losses stay on the device until the epoch ends (one transfer)
        losses = []
        for batch in train_batcher.epoch(epoch):
            loss, _ = step_fn(_series(batch, args.vae_kind, dev))
            losses.append(loss)
            timer.tick()
        mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
        print(f"Epoch: {epoch + 1}, Training Loss: {mean_loss:.6f}")
        loss_list.append(mean_loss)
        logger.log(epoch=epoch, loss=mean_loss,
                   steps_per_sec=timer.steps_per_sec)
        if epoch % max(1, total_epochs // 10) == 0:
            val = _validation_loss(args, model, test_batcher, dev)
            if val is not None:
                print(f"Validation Loss: {val:.6f}")
            if plots:
                plot_loss_curve(loss_list, save_dir, "loss_curve_epoch.png")
            ckpt.save_params(save_dir, model.state_dict(),
                             f"model_epoch_{epoch}")
    ckpt.save_params(save_dir, model.state_dict(), "final_model")
    print("Training complete.")
    return model, test_batcher, save_dir


@torch.no_grad()
def _validation_loss(args, model, test_batcher, device):
    """The eval-mode loss over the test batches: the TSae's teacher-forced
    MSE, the conv VAE's ``lavae_loss``; None without a test batch."""
    losses = []
    for batch in test_batcher.epoch(0):
        x = _series(batch, args.vae_kind, device)
        if args.vae_kind == "tsae":
            r = model.reconstruct_teacher_forced(x)
            losses.append(float(torch.mean(torch.square(r - x))))
        else:
            losses.append(float(lavae_loss(model, x)[0]))
    return float(np.mean(losses)) if losses else None


@torch.no_grad()
def inference(args, model, test_batcher, save_dir, num_samples=None):
    """Reconstruct the test split (the TSae autoregressively) and draw
    the PCA/t-SNE figure; returns (real, reconstructed) lists of (n_f, T)
    arrays."""
    dev = next(model.parameters()).device
    model.eval()
    real, reco = [], []
    for batch in test_batcher.epoch(0):
        x = _series(batch, args.vae_kind, dev)
        if args.vae_kind == "tsae":
            r = model.reconstruct_autoregressive(x)
            real.extend(x.cpu().numpy().transpose(0, 2, 1))
            reco.extend(r.cpu().numpy().transpose(0, 2, 1))
        else:
            out, _, _, _ = model(x)
            real.extend(np.asarray(batch.x))
            reco.extend(out.cpu().numpy())
        if num_samples is not None and len(real) >= num_samples:
            break
    if real and not skipped("figures", "matplotlib", "sklearn"):
        plot_pca_tsne(real, reco, save_dir)
    return real, reco


def main(argv=None, device=None):
    """Parse ``argv``, pretrain and reconstruct on ``device`` (None = CUDA:
    raises on a machine with no card unless ``device="cpu"``)."""
    args = get_args(argv)
    model, test_batcher, save_dir = train(args, resolve_device(device))
    print("Starting inference...")
    return inference(args, model, test_batcher, save_dir)


if __name__ == "__main__":
    main()
