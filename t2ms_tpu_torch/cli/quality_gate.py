"""Quality gate: VAE pretrain -> denoiser train -> CFG sample -> metric
suite (C-FID optional) on a synthetic sine-family corpus (counterpart of
scripts/quality_gate.py).

It checks that the whole stack *learns*: conditional samples must beat
uniform noise on MSE and land near the data manifold on the feature-based
measures. The flags, their defaults and refusals, the corpus, the noise
floor and the JSON keys are the JAX script's, but one gate key:
``mse_under_half_noise_floor`` stands where JAX has ``mse_beats_noise``
(the test is MSE < 0.5 x floor). The JSON summary goes to stdout, the
progress lines (with each stage's wall time) to stderr; the exit code is
0 only when every gate holds.

    python -m t2ms_tpu_torch.cli.quality_gate --steps 8000 --eval_cfid \\
        --cfg_scale 7

runs on the card: the DiT trains through the block kernels and samples
through the stack kernel (``attention_impl`` other than 'auto' opts out
to the eager model); ``main(argv, device="cpu")`` runs eagerly on the CPU.

torch cannot draw threefry's numbers, so each JAX key is a torch seed of
``utils/prng.py``: the VAE's init from ``root_key(0)``, the denoiser's
from ``root_key(1)``, step i's draws from ``root_key(i)``, every
sampler's from ``root_key(42)``, the TSae's dropout at step s from
``step_key(root_key(777), s)``, each through ``torch_seed``. A run
repeats on one device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.evaluate import (calculate_acd, calculate_dtw,
                                     calculate_fid, calculate_kd,
                                     calculate_mse, calculate_sd,
                                     calculate_wape, initialize_ts2vec)
from t2ms_tpu_torch.models.denoisers import DiT, MLPDenoiser
from t2ms_tpu_torch.models.vae import LAVAE
from t2ms_tpu_torch.models.vae.tsae import TSaeDiffusion, tsae_adapter_loss
from t2ms_tpu_torch.sampling import make_cfg_sampler
from t2ms_tpu_torch.training.ema import setup_cli_ema
from t2ms_tpu_torch.training.optim import onecycle_adamw, warmup_cosine_adamw
from t2ms_tpu_torch.training.trainer import (make_denoiser_train_step,
                                             make_vae_train_step)
from t2ms_tpu_torch.utils.prng import root_key, step_key, torch_seed

__all__ = ["build_bucket_schedule", "make_batch", "noise_floor",
           "summarize", "gate", "main"]

METRICS = {"MSE": calculate_mse, "WAPE": calculate_wape,
           "DTW": calculate_dtw, "ACD": calculate_acd,
           "SD": calculate_sd, "KD": calculate_kd}
N_CLASSES, T_SERIES = 8, 96
N_FEATURES = {"t2s": 1, "motion": 10, "deadlift": 7}


def build_bucket_schedule(buckets, ratios_str):
    """Repeating interleave pattern from per-bucket step ratios, e.g.
    (48,96,192) with '1,1,2' -> [48,96,192,192]. Deterministic, keeps the
    buckets mixed, and reallocates (never adds to) the total step budget.
    Empty ratios = even round-robin."""
    if not ratios_str:
        return list(buckets)
    ratios = [int(r) for r in ratios_str.split(",")]
    if len(ratios) != len(buckets) or min(ratios) < 1:
        raise ValueError(f"need {len(buckets)} positive ratios, "
                         f"got {ratios_str!r}")
    return [L for L, r in zip(buckets, ratios) for _ in range(r)]


def make_batch(key_i, n, T=T_SERIES, n_feat=1):
    """Batch ``key_i`` of the corpus: 8 frequency classes (freq 1 +
    0.5 cls, phase 0.7 cls) in [0, 1] plus 0.02 noise, and the class
    one-hot as the 128-d text embedding. ``n_feat`` > 1 gives (n, n_feat,
    T) phase-shifted copies, like joint-angle series. Each call has its
    own generator, so the eval corpus does not depend on how many
    training batches came first. Returns (x, emb, cls)."""
    rng = np.random.default_rng((7, key_i, T))
    tt = np.linspace(0, 1, T)
    cls = rng.integers(0, N_CLASSES, n)
    freqs = 1.0 + cls * 0.5
    # phase fixed per class so the text condition fully determines the
    # series (pointwise MSE is then a meaningful gate)
    phase = (cls * 0.7)[:, None]
    x = np.sin(2 * np.pi * freqs[:, None] * tt[None] + phase)
    x = (x + 1) / 2 + 0.02 * rng.standard_normal((n, T))
    if n_feat > 1:
        shifts = np.linspace(0, np.pi, n_feat)[None, :, None]
        base = np.sin(2 * np.pi * freqs[:, None, None] * tt[None, None]
                      + phase[:, :, None] + shifts)
        x = (base + 1) / 2 + 0.02 * rng.standard_normal((n, n_feat, T))
    emb = np.zeros((n, 128), np.float32)
    emb[np.arange(n), cls] = 1.0
    return x.astype(np.float32), emb, cls


def noise_floor(ntd_gt: np.ndarray, L: int) -> float:
    """What a uniform random sampler scores on MSE at bucket ``L`` (a
    fixed seed, so the floor is the same in every gate configuration)."""
    return calculate_mse(ntd_gt, np.random.default_rng((8, L)).uniform(
        0, 1, ntd_gt.shape))


def summarize(per_bucket: dict, recon_err, train_loss) -> dict:
    """The JSON's top level: the metrics and the floor averaged over the
    buckets (``per_bucket`` maps L to its row), and the rows under
    ``per_bucket`` when there is more than one."""
    res = {"vae_recon_error": float(recon_err),
           "final_train_loss": float(train_loss)}
    for k in list(METRICS) + ["MSE_noise_floor"]:
        res[k] = float(np.mean([row[k] for row in per_bucket.values()]))
    if len(per_bucket) > 1:
        res["per_bucket"] = {str(L): row for L, row in per_bucket.items()}
    return res


def gate(res: dict) -> dict:
    """The gates over the summary (``scripts/quality_gate.py``'s, with
    ``mse_beats_noise`` named for what it tests)."""
    return {
        "mse_under_half_noise_floor":
            res["MSE"] < 0.5 * res["MSE_noise_floor"],
        "finite": all(np.isfinite(v) for v in res.values()
                      if isinstance(v, (int, float))),
        "distribution_close": abs(res["SD"]) < 1.0 and abs(res["KD"]) < 3.0,
    }


def get_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--vae_steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--eval_cfid", action="store_true")
    ap.add_argument("--backbone", default="flowmatching",
                    choices=["flowmatching", "ddpm"])
    ap.add_argument("--denoiser", default="DiT", choices=["DiT", "MLP"])
    ap.add_argument("--cfg_scale", type=float, default=3.0)
    ap.add_argument("--track", default="t2s",
                    choices=["t2s", "motion", "deadlift"],
                    help="t2s: univariate latent 30x64; motion: 10-feature "
                         "multivariate conv VAE with a 64-long latent "
                         "(benchpress geometry); deadlift: 7 features over "
                         "length buckets 48/96/192")
    ap.add_argument("--vae_kind", default="conv", choices=["conv", "tsae"],
                    help="conv: the LA-VAE. tsae: the TSae seq2seq AE; the "
                         "DiT trains on its memory latents (B, 64, T) and "
                         "samples through its autoregressive generator. "
                         "Single-bucket tracks only (the TSae latent length "
                         "equals T)")
    ap.add_argument("--latent_grid", type=int, default=0,
                    help="latent length override; 0 = track default for DiT "
                         "(30/64), 6 for the MLP")
    ap.add_argument("--f32", action="store_true",
                    help="denoiser compute in f32 instead of bf16")
    ap.add_argument("--attention_impl", default="auto",
                    choices=["auto", "einsum", "flash", "packed"],
                    help="the DiT attention path, an A/B of the kernels' "
                         "numerics on trained quality: auto = the block and "
                         "stack kernels; einsum = the eager model")
    ap.add_argument("--cfg_sweep", default="",
                    help="comma list of extra cfg_scales scored (MSE + "
                         "C-FID) from the SAME trained model; requires "
                         "--eval_cfid")
    ap.add_argument("--solver", default="euler",
                    choices=["euler", "heun", "midpoint", "ddim"],
                    help="integrator for the sampling stage (ddim needs "
                         "--backbone ddpm)")
    ap.add_argument("--sample_steps", type=int, default=100,
                    help="sampler total_step for the eval stage")
    ap.add_argument("--solver_ab", default="",
                    help="comma list of solver:steps pairs (e.g. "
                         "'euler:100,heun:25,midpoint:50') scored MSE + "
                         "C-FID from the SAME trained model at --cfg_scale; "
                         "requires --eval_cfid; 'ddim:N' pairs need "
                         "--backbone ddpm")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="train an EMA shadow and EVALUATE it instead of "
                         "the live weights (0 = off); training is unchanged "
                         "step for step")
    ap.add_argument("--bucket_steps", default="",
                    help="per-bucket step-allocation ratios for multi-"
                         "bucket tracks, e.g. '1,1,2' gives the longest "
                         "bucket half the steps; applies to the VAE "
                         "pretrain loop too")
    args = ap.parse_args(argv)
    if args.cfg_sweep and not args.eval_cfid:
        ap.error("--cfg_sweep is scored inside the C-FID evaluation "
                 "block; pass --eval_cfid too")
    if args.solver_ab and not args.eval_cfid:
        ap.error("--solver_ab is scored inside the C-FID evaluation "
                 "block; pass --eval_cfid too")
    buckets = (48, 96, 192) if args.track == "deadlift" else (T_SERIES,)
    try:
        args.schedule = build_bucket_schedule(buckets, args.bucket_steps)
    except ValueError as e:
        ap.error(f"--bucket_steps: {e}")
    if args.vae_kind == "tsae" and len(buckets) > 1:
        ap.error("--vae_kind tsae needs a single-bucket track (the TSae "
                 "latent length equals the series length)")
    args.buckets = buckets
    return args


def _build_models(args, dev):
    """(vae, denoiser) of the track, the VAE seeded from 0 and the
    denoiser from 1."""
    n_feat = N_FEATURES[args.track]
    multivariate = n_feat > 1
    latent_len = args.latent_grid or (
        64 if multivariate else (6 if args.denoiser == "MLP" else 30))
    torch.manual_seed(torch_seed(root_key(0)))
    if args.vae_kind == "tsae":
        vae = TSaeDiffusion(n_features=n_feat, flow_dim=64, device=dev)
        latent_len = T_SERIES            # the memory latent is (B, 64, T)
    elif multivariate:
        vae = LAVAE(in_channels=n_feat, num_residual_layers=3,
                    latent_grid=latent_len, exact_length_output=True,
                    device=dev)
    else:
        vae = LAVAE(in_channels=1, latent_grid=latent_len, device=dev)
    cdt = torch.float32 if args.f32 else torch.bfloat16
    torch.manual_seed(torch_seed(root_key(1)))
    if args.denoiser == "DiT":
        dit = DiT(latent_len=latent_len, latent_dim=64, compute_dtype=cdt,
                  attention_impl=args.attention_impl, device=dev)
    else:
        dit = MLPDenoiser(feat_dim=64, latent_len=latent_len,
                          compute_dtype=cdt, device=dev)
    return vae, dit


def _vae_step(args, vae, dev):
    """``step(i, x) -> (loss, recon_err)``: the LA-VAE step, or the TSae
    teacher-forced with the reference's p=0.1 dropout drawn from
    ``step_key(root_key(777), i)``."""
    opt = warmup_cosine_adamw(vae.parameters(), 1e-3, warmup_steps=100,
                              cosine_period=600)
    if args.vae_kind != "tsae":
        step = make_vae_train_step(vae, opt, device=dev)
        return lambda i, x: step(x)
    gen = torch.Generator(device=dev)

    def tsae_step(i, x):
        gen.manual_seed(torch_seed(step_key(root_key(777), i)))
        opt.zero_grad(set_to_none=True)
        loss, (re, _) = tsae_adapter_loss(
            vae, torch.as_tensor(x, device=dev),
            vae.tsae.dropout_draws(generator=gen))
        loss.backward()
        opt.step()
        return loss.detach(), re.detach()
    return tsae_step


def main(argv=None, device=None) -> int:
    args = get_args(argv)
    dev = resolve_device(device)
    n_feat = N_FEATURES[args.track]
    multivariate = n_feat > 1
    B, buckets, schedule = args.batch, args.buckets, args.schedule
    batch = lambda key_i, n, T=T_SERIES: make_batch(key_i, n, T, n_feat)
    vae, dit = _build_models(args, dev)

    # --- VAE pretrain ---
    vstep = _vae_step(args, vae, dev)
    recon_err = dloss = torch.tensor(float("nan"))   # --*_steps 0 runs
    t0 = time.perf_counter()
    for i in range(args.vae_steps):
        x, _, _ = batch(i, B, schedule[i % len(schedule)])
        _, recon_err = vstep(i, x)
    recon_err = float(recon_err)
    print(f"VAE recon error after {args.vae_steps} steps: {recon_err:.5f} "
          f"({time.perf_counter() - t0:.2f} s)", file=sys.stderr)

    # --- denoiser train ---
    opt_d = onecycle_adamw(dit.parameters(), args.steps)
    dstep = make_denoiser_train_step(dit, vae, opt_d, args.backbone, 100,
                                     device=dev)
    ema, ema_update = setup_cli_ema(args.ema_decay, dit)
    gen = torch.Generator(device=dev)
    t0 = time.perf_counter()
    for i in range(args.steps):
        x, e, _ = batch(1000 + i, B, schedule[i % len(schedule)])
        dloss = dstep(x, e, generator=gen.manual_seed(
            torch_seed(root_key(i))))
        if ema_update is not None:
            ema_update(ema, dit)
        if i % 300 == 0:
            print(f"denoiser step {i}: loss {float(dloss):.4f}",
                  file=sys.stderr)
    dloss = float(dloss)
    print(f"denoiser trained {args.steps} steps in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
    if ema is not None:
        # score the SHADOW: training was identical step for step, so a
        # same-seed gate without --ema_decay is the exact A/B partner
        with torch.no_grad():
            for n, p in dit.named_parameters():
                p.copy_(ema[n])

    # --- sample + evaluate ---
    t0 = time.perf_counter()
    n_eval = 128 // len(buckets) * len(buckets) or len(buckets)
    evals = {L: batch(99999 + L, n_eval // len(buckets), L) for L in buckets}

    def sample_at(cfg_scale, L, solver=None, steps=None):
        solver = solver or args.solver
        steps = steps or args.sample_steps
        ddim = solver == "ddim"   # subsamples the TRAINING schedule, T=100
        sampler = make_cfg_sampler(dit, vae, args.backbone,
                                   100 if ddim else steps, cfg_scale, L,
                                   solver=solver,
                                   sample_steps=steps if ddim else None,
                                   device=dev)
        x_gt, e_gt, _ = evals[L]
        out = sampler(x_gt, e_gt, generator=torch.Generator(
            device=dev).manual_seed(torch_seed(root_key(42))))
        return out.series.float().cpu().numpy()

    def to_ntd(a):
        return np.transpose(a, (0, 2, 1)) if multivariate else a[:, :, None]

    per_bucket, gen_by_bucket = {}, {}
    for L in buckets:
        ntd_gt = to_ntd(evals[L][0])
        ntd_gen = to_ntd(sample_at(args.cfg_scale, L))
        gen_by_bucket[L] = ntd_gen       # reused by the C-FID block
        row = {k: f(ntd_gt, ntd_gen) for k, f in METRICS.items()}
        row["MSE_noise_floor"] = noise_floor(ntd_gt, L)
        per_bucket[L] = row
    res = summarize(per_bucket, recon_err, dloss)
    # the C-FID block scores the middle bucket (the only one on t2s/motion)
    T = buckets[min(1, len(buckets) - 1)]
    if args.eval_cfid:
        ntd_gt = to_ntd(evals[T][0])
        m = initialize_ts2vec(ntd_gt, device=dev)
        encode = lambda a: m.encode(a, encoding_window="full_series")
        r1 = encode(ntd_gt)
        # the per-bucket loop already sampled (args.cfg_scale, T) from the
        # same seed: reuse it
        res["C-FID"] = calculate_fid(r1, encode(gen_by_bucket[T]))

        def score(g):
            g = to_ntd(g)
            return {"MSE": calculate_mse(ntd_gt, g),
                    "C-FID": calculate_fid(r1, encode(g))}
        if args.cfg_sweep:
            res["cfg_sweep"] = {
                str(cs): score(sample_at(cs, T))
                for cs in (float(s) for s in args.cfg_sweep.split(","))}
        if args.solver_ab:
            # one trained model, many integrators
            sab = {}
            for pair in args.solver_ab.split(","):
                sname, ssteps = pair.split(":")
                sab[pair] = score(sample_at(args.cfg_scale, T, solver=sname,
                                            steps=int(ssteps)))
            res["solver_ab"] = sab

    gates = gate(res)
    res["gates"] = gates
    print(f"sampled and scored in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    print(json.dumps(res, indent=2))
    return 0 if all(gates.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
