"""Motion-track (T2MS) inference CLI (counterpart of
t2ms_tpu/cli/myinfer.py).

Reference: myinfer.py — per-batch live re-embedding through OpenAI
(:24-46,162; here a pluggable embedder with offline default), conv-VAE +
DiT(flow_dim) CFG loop (one sampler call a batch here), per-sample MSE
(:205-207), per-sample JSON + rear/top skeleton GIFs (save_result
:102-111), stop after batch 10 (:218-219), side-by-side panels +
PCA/t-SNE (:221-222). The flags, defaults and artifact paths are the JAX
CLI's: ``run_{i}/sample_{b}/data.json``, ``run_{i}/sample_{b}/x_t.npy``,
``run_{i}/x_t_sample_{b}.npy`` and ``x_1_sample_{b}.npy`` one directory
up; the figures and GIFs beside them. Where matplotlib (or imageio, for
the GIFs, or sklearn, for the PCA/t-SNE figure) is absent, one line says
so and they are skipped; the arrays and the JSON are written either way.

    python -m t2ms_tpu_torch.cli.myinfer --dataset_name benchpress ...

runs on the card, where the CFG pair of each step runs as one 2B forward
of the fused stack kernel (1024 tokens for benchpress, 800 for deadlift);
``main(argv, device="cpu")`` runs the eager DiT on the CPU. The test split
keeps native lengths, so batches are ragged across length buckets and one
sampler is built per length. Batch b of run r draws its noise from a
generator seeded with (general_seed + r, b).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.cli._common import batch_seed
from t2ms_tpu_torch.cli.mytrain import build_motion_denoiser, load_motion_vae
from t2ms_tpu_torch.config import (denoiser_ckpt_dir, generation_dir,
                                   get_cfg, motion_pretrained_dir)
from t2ms_tpu_torch.data.embedder import get_embedder
from t2ms_tpu_torch.data.provider import motion_loader_provider
from t2ms_tpu_torch.evaluate import calculate_mse, normalize_per_row
from t2ms_tpu_torch.sampling import make_cfg_sampler
from t2ms_tpu_torch.training import checkpoints as ckpt
from t2ms_tpu_torch.training.ema import load_ema_for_inference
from t2ms_tpu_torch.training.scaling import parse_dtype
from t2ms_tpu_torch.utils.prng import torch_seed
from t2ms_tpu_torch.visualize.benchpress import (RearV_BenchpressAnimator,
                                                 TopV_BenchpressAnimator)
from t2ms_tpu_torch.visualize.diagnostics import (plot_pca_tsne,
                                                  plot_side_by_side_comparison,
                                                  skipped)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Inference flow matching model")
    p.add_argument("--config", type=str, default="config.yaml")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--save_path", type=str,
                   default="./results/denoiser_results")
    p.add_argument("--cfg_scale", type=float, default=3)
    p.add_argument("--total_step", type=int, default=100)
    p.add_argument("--solver", type=str, default="euler",
                   choices=["euler", "heun", "midpoint", "ddim"],
                   help="integrator; euler = reference parity, "
                        "heun/midpoint order-2 flow, ddim = few-step "
                        "deterministic DDPM (see cli.infer)")
    p.add_argument("--sample_steps", type=int, default=0,
                   help="ddim only: sampling steps over the --total_step "
                        "schedule (0 = total_step)")
    p.add_argument("--checkpoint_id", type=int, default=2500)
    p.add_argument("--use_ema", type=lambda s: s not in ("0", "False"),
                   default=False,
                   help="sample from the EMA shadow (model_{id}_ema) "
                        "saved by cli.mytrain --ema_decay")
    p.add_argument("--dataset_name", type=str,
                   choices=["deadlift", "benchpress"], default="benchpress")
    p.add_argument("--run_time", type=int, default=1)
    p.add_argument("--embedder", type=str, default="precomputed",
                   choices=["precomputed", "fake", "openai"],
                   help="live text embedding provider (reference uses "
                        "openai; precomputed = offline dataset embeddings)")
    p.add_argument("--max_batches", type=int, default=10,
                   help="LAST batch index processed (inclusive, so N+1 "
                        "batches) — reproduces the reference's "
                        "'if batch == 10: break' AFTER processing "
                        "(myinfer.py:218-219); 0 = no cap. The default "
                        "thus writes sample_0..sample_10 while "
                        "myevaluation's --n_samples default reads only "
                        "sample_0..9, exactly like the reference pair")
    p.add_argument("--render_gifs", type=lambda s: s not in ("0", "False"),
                   default=True)
    p.add_argument("--compute_dtype", type=str, default="f32",
                   choices=["f32", "float32", "bf16", "bfloat16"],
                   help="denoiser activation dtype")
    args = p.parse_args(argv)
    args = get_cfg(args)
    args.pretrainedvae_path = os.path.join(
        motion_pretrained_dir(args.split_base_num, args.dataset_name,
                              args.pretrained_epc), "final_model")
    args.checkpoint_path = os.path.join(
        denoiser_ckpt_dir(args.save_path, args.backbone, args.denoiser,
                          args.dataset_name, args.caption,
                          args.pretrained_epc),
        f"model_{args.checkpoint_id}")
    args.generation_save_path = generation_dir(
        args.save_path, args.backbone, args.denoiser, args.dataset_name,
        args.cfg_scale, args.total_step)
    return args


def _animate(features: dict, rear: str, top: str) -> None:
    RearV_BenchpressAnimator(features).animate(rear)
    TopV_BenchpressAnimator(features).animate(top)


def save_result(root: str, features: dict, render_gifs: bool = True):
    """Per-sample artifact dump (reference save_result :102-111): the
    features as data.json, and the skeleton GIFs when asked."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump(features, f, indent=4)
    if render_gifs:
        try:
            _animate(features, os.path.join(root, "rear.gif"),
                     os.path.join(root, "top.gif"))
        except KeyError as e:
            print(f"skipping skeleton GIFs (missing feature {e})")


def _build_ctx(args, device=None):
    """Everything reused across runs: the test loader, the models and one
    sampler per native length."""
    dev = resolve_device(device)
    _, test_batcher = motion_loader_provider(args, "test")
    vae = load_motion_vae(args, dev, args.pretrainedvae_path)
    denoiser = build_motion_denoiser(args, parse_dtype(args.compute_dtype),
                                     dev)
    if os.path.exists(args.checkpoint_path):
        denoiser.load_state_dict(
            ckpt.load_train_ckpt(args.checkpoint_path)["params"])
        print(f"Loaded denoiser from {args.checkpoint_path}")
    else:
        print(f"WARNING: no checkpoint at {args.checkpoint_path}; "
              "sampling from random weights")
    if args.use_ema:
        denoiser.load_state_dict(load_ema_for_inference(args.checkpoint_path))
    embedder = (get_embedder(args.embedder)
                if args.embedder != "precomputed" else None)
    gifs = (args.render_gifs and args.dataset_name == "benchpress"
            and not skipped("skeleton GIFs", "matplotlib", "imageio"))
    figures = not skipped("figures", "matplotlib", "sklearn")
    return dict(test_batcher=test_batcher, vae=vae, denoiser=denoiser,
                embedder=embedder, device=dev, samplers={}, gifs=gifs,
                figures=figures)


def infer(args, run_dir: str, seed_offset: int = 0, ctx=None):
    os.makedirs(run_dir, exist_ok=True)
    print(f"Inference config::Step: {args.total_step}\t"
          f"CFG Scale: {args.cfg_scale}")
    ctx = ctx if ctx is not None else _build_ctx(args)
    samplers, embedder = ctx["samplers"], ctx["embedder"]
    gen = torch.Generator(device=ctx["device"])

    x1s, xts, mses, subjects = [], [], [], []
    feature_names = args.features[-args.input_dim:]
    for b, batch in enumerate(ctx["test_batcher"].epoch(0)):
        if args.max_batches and b > args.max_batches:
            break
        print(f"Generating {b}th Batch TS...")
        length = batch.x.shape[-1]
        if length not in samplers:
            samplers[length] = make_cfg_sampler(
                ctx["denoiser"], ctx["vae"], args.backbone, args.total_step,
                args.cfg_scale, out_length=length, solver=args.solver,
                sample_steps=args.sample_steps or None,
                device=ctx["device"])
        emb = (embedder.embed(batch.texts) if embedder is not None
               else batch.embedding)
        gen.manual_seed(
            torch_seed(batch_seed(args.general_seed + seed_offset, b)))
        out = samplers[length](np.asarray(batch.x, np.float32),
                               np.asarray(emb, np.float32), generator=gen)
        x1 = np.asarray(batch.x)
        xt = out.series.cpu().numpy()
        for i in range(len(x1)):
            mses.append(calculate_mse(normalize_per_row(x1[i])[None],
                                      normalize_per_row(xt[i])[None]))
            x1s.append(x1[i])
            xts.append(xt[i])
            subjects.append(batch.subjects[i] if batch.subjects else "?")
        print(f"Batch {b} MSE: {mses[-1]}")
        features = {name: xt[0][j].astype(float).tolist()
                    for j, name in enumerate(feature_names)}
        sample_dir = os.path.join(run_dir, f"sample_{b}")
        save_result(sample_dir, features, ctx["gifs"])
        np.save(os.path.join(sample_dir, "x_t.npy"), xt)
        np.save(os.path.join(run_dir, f"x_t_sample_{b}.npy"), xt[0])
        np.save(os.path.join(os.path.dirname(run_dir),
                             f"x_1_sample_{b}.npy"), x1[0])

    if ctx["figures"]:
        plot_side_by_side_comparison(x1s, xts, mses, subjects, run_dir,
                                     feature_names)
        plot_pca_tsne(x1s, xts, run_dir)
    return x1s


def main(argv=None, device=None):
    """Parse ``argv`` and sample ``--run_time`` runs on ``device`` (None =
    CUDA: raises on a machine with no card unless ``device="cpu"``)."""
    args = get_args(argv)
    ctx = _build_ctx(args, resolve_device(device))
    x_1_list = None
    for i in range(args.run_time):
        run_dir = os.path.join(args.generation_save_path, f"run_{i}")
        x_1_list = infer(args, run_dir, i, ctx=ctx)
    if x_1_list and ctx["gifs"]:
        feature_names = args.features[-args.input_dim:]
        last_dir = os.path.join(args.generation_save_path,
                                f"run_{args.run_time - 1}")
        for b, x1 in enumerate(x_1_list[:3]):
            features = {n: x1[j].astype(float).tolist()
                        for j, n in enumerate(feature_names)}
            _animate(features, os.path.join(last_dir, f"rear_{b}.gif"),
                     os.path.join(last_dir, f"top_{b}.gif"))
    return ctx


if __name__ == "__main__":
    main()
