"""On-card smoke of the PyTorch/CUDA port (``t2ms_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from ``t2ms_tpu_torch/ops/csrc`` and then,
failing with a non-zero exit on any error:

1. prints the card, its power limit, torch / CUDA versions and the TF32
   flags (both set off, so f32 products and convs are full f32);
2. builds every kernel (one nvcc per source, started together) and logs
   ptxas's registers, stack, spills and shared memory of the bf16
   attention forward's kernel (``heads_fwd_kernel``, csrc/attn_heads.cuh,
   at each head width) and of the backward's (``heads_bwd_q_kernel``,
   ``heads_bwd_kv_kernel``, csrc/heads_bwd.cuh, at each head width and
   recipe), as built into csrc/fused_heads.cu, and of the stack's
   tensor-core kernels (csrc/dit_layer.cuh: ``modln_qkv_tc_kernel``,
   ``heads_fwd_kernel`` at each head width, ``proj_mlp_tc_kernel``), as
   built into csrc/dit_stack.cu, and of the bf16 block backward's own
   kernels (csrc/dit_block_bwd.cu: ``mlp_bwd_tc_kernel``,
   ``attn_out_bwd_tc_kernel``, ``qkv_bwd_tc_kernel``, ``wgrad_tc_kernel``
   and the block recipe of ``heads_bwd_q_kernel``/``heads_bwd_kv_kernel``),
   and of the split block's wgmma GEMMs (csrc/wg_gemm.cuh:
   ``wg_gemm_kernel`` on each route, as built into csrc/dit_split.cu),
   checked to spill nothing and to draw no ptxas C7512 ("wgmma
   serialized"), and of the bf16 #8 kernel on 16-byte chunks
   (csrc/mod_ln.cu: ``res_mod_ln_bwd_vec_kernel`` at each lane split);
3. kernel phase: ``fused_dit_stack`` on the card against its plain PyTorch
   twin on the same inputs (random adaLN vectors), at the main path's full
   width in bf16 and again in f32 at a smaller batch, with errors, stated
   tolerances and CUDA-event timings (median of 7 after warm-up); the bf16
   call's device time by part, checked to run on the tensor-core kernels
   and on none of the first ones (``attn_proj_kernel`` and its two
   neighbours), with torch SDPA over its attention and cuBLAS
   (``torch.matmul``) over its four dense products as yardsticks; and its
   ``batch_block=2``, ``attn_impl='folded'`` and combined variants, each
   one launch bit-equal to the plain call;
4. offline path: the flagship CFG sampler (B=256 series, euler/100, cfg 7,
   length 96, bf16 DiT, seeded random weights with adaLN perturbed) with
   the kernel launch count checked against the steps, series/s, the
   kernel path against the eager opt-out path for a few steps, and one
   CFG step's device time by part beside the host time to enqueue it;
5. server: a ``ServingEngine`` (buckets 24 and 96, tiers 1/16/64) answering
   mixed requests, and one seed served alone against the same seed inside
   a full batch;
6. block-kernel phase: ``fused_dit_block`` and its backward
   (``_fused_block_diff_bwd``) at the train step's full width (B=1024,
   N=480, bf16, random adaLN vectors) against the plain twin and autograd
   over it, every one of the 10 gradients with its error, correlation and
   mean error against an f32 truth; again in f32 at a small batch; CUDA-event
   times, the twin's times, the bounds, device time by part (the forward
   and the whole bf16 backward checked to run on the tensor-core kernels
   and on none of the first ones), and torch SDPA forward+backward over the
   block's attention and cuBLAS over the backward's 12 dense products as
   yardsticks;
7. train phase: the flagship denoiser train step (B=1024 series of length
   96, LA-VAE encode inside the step, flow matching over 100 steps, one-cycle
   AdamW at 1e-4) for 2 warm-up and 10 timed steps: steps/s, peak memory,
   device time by part beside the host time to enqueue one step, launch
   counts per step checked, loss finite; and at
   B=128 the kernel path's loss and gradients against the eager bf16 and
   f32 opt-out paths on the same injected draws (three draws);
8. split-kernel phase: ``fused_dit_block_split`` at the scaled DiT's call
   (2B=32, N=1024, d_model 512, 8 heads, hidden 2048, bf16, random adaLN
   vectors) against its twin, with the mean error against the f32 twin,
   again in f32 at a small batch, and against the stack kernel at the
   reference geometry; CUDA-event times, the twin's time, the bound,
   device time by kernel and split into attention and GEMMs (the bf16
   call checked to run on ``wg_gemm_kernel`` and on no bf16
   ``gemm_kernel``), each GEMM stage alone (``dit_split_gemm_bf16``):
   device time, TFLOP/s and share of its bound, and torch SDPA over the
   block's attention and cuBLAS over its four dense products as
   yardsticks; the LayerNorm GEMMs' route at each width;
9. scaled offline path: the 56.7M-param DiT (scripts/bench_scaled.py:
   d_model 512, depth 12, 8 heads, mlp x4, 1024 tokens) and the LA-VAE at
   latent grid 64, seeded random weights, through the CFG sampler (B=16,
   euler/20, cfg 7, length 96): series/s, peak memory, launches checked
   (12 split launches per step, no stack launch), and the kernel path
   against the eager bf16 and f32 opt-out paths for 4 steps;
10. scaled server: a ``ServingEngine`` over the scaled models (buckets 48
   and 96, tiers 1/4/8) answering mixed requests, and one seed served
   alone against the same seed inside a full batch;
11. mod_ln phase: the LayerNorm + modulate kernels ``_mod_ln_call`` and
   ``_mod_ln_diff_bwd`` at the scaled train step's call (B=64, N=1024,
   d_model 512, bf16, random shift/scale) against the twin and autograd
   over it, again in f32 at a small batch; CUDA-event times, the twin's
   times and the bounds, and in bf16 each one's device time by kernel;
12. fused-heads phase: ``fused_heads_attention`` and
   ``fused_heads_attention_bwd`` at the same call (8 heads of 64, q/k/v
   the column slices of one qkv tensor) against their twins, with the mean
   error against the f32 twins, again in f32 at a small batch; times with
   the achieved TFLOP/s and share of the bound, bounds, and torch SDPA
   forward and backward over the head-split views as the library
   yardstick;
13. scaled train phase: the scaled DiT's denoiser train step
   (scripts/bench_scaled.py:80-118: B=64, latents encoded once outside the
   step, flow matching over 100 steps, CFG drop 0.3, AdamW at 1e-4 with
   weight decay 1e-4) through the flax path's kernels with the residual
   fusion, 2 warm-up and 5 timed steps: steps/s (the median of that window
   and four more of 5 steps, ``step_rate``), peak memory, device time
   by part and the host time to enqueue one step (as for every profiled
   call after it), launches per step checked (forward #5 x1, #7 x23, #9 x12;
   backward #6 x1, #8 x23, #11 x12; no #12, stack, block or split launch),
   loss finite and, step by step, within 1e-2 of the eager bf16 path's
   from the same init and draws; and at B=8 the kernel path's loss and
   gradients against the eager bf16 and f32 opt-out paths on the same
   injected draws (three draws);
14. res_mod_ln phase: the gated residual + LayerNorm + modulate kernels
   ``_res_mod_ln_call`` and ``_res_mod_ln_diff_bwd`` at the scaled call
   (B=64, N=1024, d 512) and the long-series call (B=8, N=4096, d 128) in
   bf16, random x, h and gm3, against the twin and autograd over it, again
   in f32 at a small batch; CUDA-event times, the twin's times and the
   bounds; in bf16 each one's device time by kernel (its own, the ordered
   dmod sum, the wrapper's casts), the backward checked to run on the
   16-byte-chunk kernel;
15. two-pass phase: ``fused_heads_attention_bwd_two_pass`` at the
   long-series train step's call (B=8, N=4096, 4 heads of 32, q/k/v the
   column slices of one qkv tensor) against its twin, with the mean error
   against the f32 twin, again in f32 at B=1; times with the achieved
   TFLOP/s and share of the bound, the bound, device
   time by kernel and torch SDPA's backward as the yardstick; and
   ``fused_heads_attention_bwd``'s recompute recipe against its twin where
   JAX takes the ungrouped single pass (B=64, N=480, 4 heads of 32);
16. long-series offline path: the long-series DiT
   (scripts/bench_long_series.py: d_model 128, 4 heads of 32, depth 4,
   mlp x2 over the 256 x 64 latent, 4096 tokens) and the LA-VAE at latent
   grid 256, seeded random weights with adaLN moved off its init, through
   the CFG sampler (B=16, euler/50, cfg 7, length 2048) on the flax path:
   series/s, peak memory, launches per ``sample()`` checked (#5 x50, #7
   x350, #9 x200, no stack or split launch), device time of one CFG
   forward by part, and at B=2 the kernel path against the eager bf16 and
   f32 opt-out paths for 4 steps;
17. long-series train phase: the long-series train step (B=8, length
   2048, LA-VAE encode inside the step, flow matching over 100 steps, CFG
   drop 0.3, AdamW at 1e-4), 2 warm-up and 5 timed steps: steps/s (median
   of five windows, as in 13), peak memory, device time by part, launches per step checked (#5 x1, #7 x7,
   #9 x4, #6 x1, #8 x7, #12 x4; no #11, stack, block or split launch),
   loss finite; and at B=2 the kernel path's loss and gradients against
   the eager bf16 and f32 opt-out paths on the same injected draws (three
   draws);
18. lean kernel phase: ``fused_heads_attention_with_stats`` (#10),
   ``fused_heads_attention_bwd_lean`` (#13) and
   ``fused_heads_attention_bwd_lean_two_pass`` (#14)
   (``csrc/fused_heads.cu``) against their twins at scripts/
   kernel_smoke.py's stats_fwd_1024_hd512 and lean_bwd_g4_bq512 (B=2,
   N=1024, 8 heads of 64) and lean_two_pass_4096 (B=2, N=4096, 4 heads of
   32), bf16 and f32, #10's o bit-equal to #9's; then at the paths' calls
   (#10 and #13 at B=64, N=1024; #14 at B=8, N=4096): times with the
   achieved TFLOP/s and share of the bound, the twins' times, the bounds
   and torch SDPA as the yardstick;
19. lean scaled train phase: the scaled train step with
   ``T2MS_ATTN_LEAN_BWD=1`` (2 warm-up, 5 timed steps): steps/s (median
   of five windows, as in 13, with the switch on and unset), peak memory, device time by part, launches per step checked (#5 x1, #7 x23,
   #10 x12, #6 x1, #8 x23, #13 x12; no #9, #11 or #12), the losses within
   1e-2 of the same steps with the switch unset from the same init and
   draws, and at B=8 the gradients against the eager paths;
20. lean long train phase: the same for the long-series step (#5 x1, #7
   x7, #10 x4, #6 x1, #8 x7, #14 x4 per step; the eager check at B=2);
21. head-split phase: ``flash_attention`` (#15), ``vmem_attention``
   (#16) and ``packed_attention`` (#17) (``csrc/split_heads.cu``) on the
   head-split views of one qkv tensor, against their twins with the mean
   error against the f32 twins, at scripts/kernel_smoke.py's flash_4096
   (B=2, 4 heads, N=4096, d 32), packed_480 and vmem_480 (B=8, N=480) and
   at the calls of the 8192-token sampler (#15, 2B=8, N=8192) and of the
   packed flagship sampler (#17, 2B=512, N=480), in bf16, and in f32 at
   a small batch; times, the twins' times, the bounds and torch SDPA as
   the library yardstick; then #16's direct call, its only path, counted;
22. 8192-token offline path: the long-series widths over the 512 x 64
   latent (8192 tokens, LA-VAE latent grid 512), seeded random weights,
   through the CFG sampler (B=4, euler/20, cfg 7, length 4096; cut from
   scripts/bench_long_series.py's B=16, euler/50 to fit the run's time)
   on the flax path, whose attention is #15 (JAX's route on a TPU: fused
   heads refuse 8192 tokens): series/s, peak memory, launches per
   ``sample()`` checked (#5 x20, #7 x140, #15 x80, no fused-heads, stack
   or split launch), device time of one CFG forward by part, and at B=1
   the kernel path against the eager bf16 and f32 opt-out paths for 4
   steps;
23. 8192-token train phase: the train step (B=8, length 4096, LA-VAE
   encode inside the step, AdamW at 1e-4), #15 forward and the einsum
   recompute backward, 2 warm-up and 5 timed steps: steps/s, peak memory,
   device time by part, launches per step checked (#5 x1, #7 x7, #15 x4,
   #6 x1, #8 x7; no #9, #11, #12, stack, block or split launch), loss
   finite; and at B=1 the kernel path's loss and gradients against the
   eager bf16 and f32 opt-out paths on the same injected draws (three
   draws);
24. packed flagship offline path: the flagship sampler with
   ``attention_impl='packed'`` (scripts/bench_attention_impls.py: B=256,
   cfg 7, length 96; euler/20, cut from euler/100): series/s, #17 x80 per
   ``sample()`` checked and no stack launch, and the kernel path against
   the eager einsum bf16 and f32 paths for 4 steps;
25. explicit-impl phase: the flagship DiT with ``attention_impl`` 'flash',
   'packed' and 'fused', one train step each (B=64), each launching the
   kernel its impl names and nothing else;
26. DDPM offline path: the flagship sampler with the DDPM backbone (B=256,
   cfg 7, length 96, bf16), the ancestral sampler over the T=100
   schedule: series/s, 100 stack launches per ``sample()`` checked, and
   on a 4-step schedule the kernel path against the eager bf16 and f32
   paths with the same injected x_t0 and step noise;
27. DDIM offline path: the same over ``ddim_timesteps(100, 25)``: series/s,
   one stack launch a sub-schedule step checked, 4 DDIM steps over T=100
   against the eager paths;
28. DDPM train phase: the flagship train step with the DDPM loss (B=1024,
   block kernels): steps/s, peak memory, 4 + 4 launches per step checked,
   and at B=128 the kernel path's loss and gradients against the eager
   bf16 and f32 paths on the same injected draws (three draws);
29. DDPM server: a ``ServingEngine`` with the DDPM backbone (bucket 96,
   tiers 1/16/64), each row's step noise from its own seed: p50 latency,
   and one seed served alone against the same seed inside a full batch;
30. CLI phase: a synthetic ETTh1 corpus (lengths 24/48/96, 2100 rows each)
   written by ``write_t2s_csv`` into a temporary directory, then
   ``cli.train.main`` (B=1024, 2 epochs, T=100, bf16, a checkpoint each
   epoch) and ``cli.infer.main`` on ``model_1`` (bf16, run_multi, one
   batch a run), for flowmatching/euler and for ddpm with DDIM over 25
   steps: the JAX CLIs' artifacts (``x_t.npy``, ``run_9/x_1.npy``, ...)
   with their shapes and finite values, the block kernels' launches in
   train and the stack's in infer checked, the train CLI's steps/s from
   ``train_log.jsonl``, its peak memory and each CLI's wall time. Before
   train, ``cli.pretrain_vae.main`` at its defaults (B=8, 2000 updates,
   the reference widths): ``final_model`` where ``cli.train`` looks (each
   train run checked to load it), finite MAE/RMSE overall and per length,
   no DiT kernel launched, steps/s, wall time and peak memory. After
   infer, ``cli.infer`` over a test split of 256 series (one batch of 256
   a run, 11 x 100 stack launches) and ``cli.evaluation`` with MSE, WAPE,
   MRR, CRPS and C-FID (TS2Vec on the card): both JSON files, every value
   finite, MRR in [0, 1]; TS2Vec at ``initialize_ts2vec``'s settings:
   fit iterations/s, encode time, C-FID(real, +0.1 std noise) below
   C-FID(real, +1 std shift); a 20-iteration fit on the card against the
   CPU from the same init, host draws and injected masks (losses and
   encode within 1e-4 relative, TF32 switched on around the call and
   restored, so TS2Vec's own scoping is what keeps it off); the f64
   wavefront DTW on the card against the numpy DP at (64, 96, 1) and
   (64, 24, 7), within 1e-9 relative, timed beside the native kernel;
31. serve phase, over the CLI phase's ``final_model`` and flowmatching
   ``model_1`` in its work directory: ``cli.serve.build_server``
   (buckets 24 and 96, tiers 1/16/64, euler/100, bf16, port 0) served
   from a thread: the warmup's time and launches (6 x 100 stack, nothing
   else), 96 requests from 16 client threads (lengths 24 and 96, cfg 3,
   5 and 7, distinct seeds; every answer finite, of its length, echoing
   seed and cfg, at a tier; 100 stack launches a batch), one seed alone
   against the same seed in a full 64-row batch and one HTTP result
   against ``make_serving_sampler`` on the same weights (each within
   2e-2 of max|ref|), 400 for each bad request, 404, and 503 from an
   engine with ``max_pending=1`` and a tier that cannot fill; requests/s,
   p50 and p95 latency and padding from /stats. Then ``python -m
   t2ms_tpu_torch.cli.serve --port 0`` (bucket 96, tiers 1 and 16) as a
   subprocess: its address from the ``Serving on`` line, /healthz, one
   POST /generate, SIGINT and exit 0 within 60 s; its time to the line
   and to the first answer. Then ``--denoiser MLP``: ``cli.train``
   (B=1024, 2 epochs, bf16), ``cli.infer`` on its ``model_1`` (run_multi,
   one batch of 256 a run) and 16 requests to ``build_server`` serving
   it: the JAX CLIs' files and shapes, finite values, no DiT kernel
   launched, steps/s, series/s and wall times; one MLP forward (B=64,
   f32, TF32 off) on the card against the CPU within 1e-5 relative;
32. motion phase (the T2MS track): ``fused_dit_stack`` at 2B=2 and 64
   (bf16) and 2 (f32), and ``fused_dit_block`` with its backward at B=4
   (bf16 and f32), against their twins at the motion DiTs' 1024 and 800
   tokens; the motion DiT's train step at B=16 through the kernel path
   against the eager bf16 and f32 paths (three draws) at both token
   counts; then, in a temporary directory with the repository's
   config.yaml, synthetic benchpress and deadlift corpora (1800 clips
   each) written by ``write_motion_dataset``: ``cli.pretrain_mylavae``
   with the conv VAE (B=128, 200 updates) and with the TSae (50 updates,
   its own --save_path, its autoregressive inference), the TSae on the
   card against the CPU (``reconstruct_teacher_forced`` and ``generate``
   at B=8, T=144, f32, within 1e-4 relative; ``generate`` timed);
   ``cli.mytrain`` (B=512, bf16, 2 epochs: 4 #2 + 4 #3 launches a step
   at 1024 tokens, nothing else; model_0 and model_1; steps/s, peak
   memory); ``cli.myinfer`` on ``model_1`` (B=1, bf16, 2 runs of 11
   batches: 100 #1 launches a batch; every file with shape (1, 10, T) or
   (10, T), finite; the skip lines without matplotlib; series/s);
   ``cli.myevaluation`` (MSE, WAPE, MRR, CRPS, DTW over the two runs:
   the JSON, finite, MRR in [0, 1]); then deadlift (800 tokens): the
   conv pretrain, ``cli.mytrain`` and ``cli.myinfer`` (2 batches) with
   the same checks. Before the CLIs, on the host: a benchpress corpus
   built by ``t2ms_tpu_torch.pipeline`` (synthetic capture files ->
   ``BenchpressFeatureMerger`` -> ``generate_captions`` with ``FakeChat``
   -> ``enrich_captions`` with ``FakeEmbed`` -> ``rebuild_motion_json``),
   read back by ``data/motion.py``;
33. parallel phase: ``parallel.dryrun.dryrun_multichip`` at full width on
   W = ``torch.cuda.device_count()`` ranks over NCCL through a FileStore
   in a temporary directory (in this process when W = 1, spawned
   processes otherwise): the flagship train step at B=1024 bf16 on a
   (W/2 x 2) mesh with TP (1 x 1 at W = 1: the data-parallel branch of
   the step), again with generator draws, ring attention at 16 tokens a
   rank and at N 2048, 4 heads of 512 (refused by the fused-heads
   kernel), a pipeline of W DiT blocks forward and backward, the sampler
   (B=256, euler/100, bf16) and f32 DiT gradients over 'data', and the
   engine (256 requests at one tier) under the plan; each result against
   the one-rank no-plan path on the card (bit for bit expected at W = 1;
   otherwise the difference beside the tolerance used), the launches of
   #1-#3 with and without the plan, the phase's wall time.

The line before the last is the kernel table as JSON (all 17 TPU kernels'
counterparts with their numbers under "kernels"; "to_port" is empty), the
one before it the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import importlib.util
import json
import os
import queue
import re
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores
H100_BYTES = 3.35e12          # HBM3 bytes/s
# the exponent unit (MUFU.EX2): 16 a clock an SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) on 132
# SMs at the 1.98 GHz boost clock (H100 SXM data sheet)
H100_EX2_RATE = 16 * 132 * 1.98e9

# main-path geometry: the reference-scale T2S DiT over the 64x30 latent
B_SERIES, N_TOK, D_MODEL, HEADS, HIDDEN, DEPTH = 256, 480, 128, 4, 256, 4
STEPS, CFG, OUT_LEN = 100, 7.0, 96
B_TRAIN, TRAIN_STEPS, TRAIN_WARMUP = 1024, 10, 2       # bench.py:124-166
# the scaled DiT (scripts/bench_scaled.py:38-77) over the 64x64 latent
SC_B, SC_N, SC_D, SC_HEADS, SC_HIDDEN, SC_DEPTH = 16, 1024, 512, 8, 2048, 12
SC_STEPS = 20
SC_TRAIN_B, SC_TRAIN_STEPS = 64, 5     # scripts/bench_scaled.py:80-118
# the long-series DiT (scripts/bench_long_series.py): the flagship's widths
# over the 256x64 latent of an LA-VAE with latent grid 256, 4096 tokens
LS_LATENT, LS_N, LS_DEPTH = 256, 4096, 4
LS_B, LS_STEPS, LS_LEN = 16, 50, 2048          # :31-65
LS_TRAIN_B, LS_TRAIN_STEPS = 8, 5              # :68-117
# the 8192-token DiT: the same widths over the 512x64 latent of an LA-VAE
# with latent grid 512 (cli/infer.py --latent_grid 512,
# scripts/bench_long_series.py --latent_len 512), series of length 4096;
# the sampler cut from the bench's B=16, euler/50 to fit the run's time
XL_LATENT, XL_N, XL_LEN = 512, 8192, 4096
XL_B, XL_STEPS, XL_TRAIN_B = 4, 20, 8
# the flagship sampler with attention_impl='packed'
# (scripts/bench_attention_impls.py:39-52), cut from euler/100
PK_B, PK_STEPS = 256, 20


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


RATE_WINDOWS = 5   # host-clock windows a train step's rate is the median of


def step_rate(step, n_steps, first_dt):
    """steps/s of a train step: the median over the main path's timed
    window (``n_steps`` steps in ``first_dt`` s) and RATE_WINDOWS - 1 more
    windows of ``n_steps`` calls of ``step``, each ending in a synchronise
    (a one-chip machine shares its host's cores, so one short window can
    read a host stall); returns (median, every window's rate)."""
    rates = [n_steps / first_dt]
    for _ in range(RATE_WINDOWS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        rates.append(n_steps / (time.perf_counter() - t0))
    return statistics.median(rates), rates


def fmt_rate(rate, rates, n_steps):
    return (f"{rate:.4f} steps/s (median of {len(rates)} windows of "
            f"{n_steps} steps: {', '.join(f'{r:.4f}' for r in rates)})")


def stack_work(B, N, D, H, hidden, L, tensors):
    """(flops, bytes) one fused_dit_stack call must do: every matrix
    product of the L blocks (qkv, QK^T, PV, proj, fc1, fc2) and each input
    read once plus the output written once."""
    rows = B * N
    dense = 2 * rows * (D * 3 * D + D * D + 2 * D * hidden)
    attn = 2 * 2 * B * H * N * N * (D // H)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += tensors[0].numel() * tensors[0].element_size()     # output
    return L * (dense + attn), nbytes


def kernel_phase(gen):
    from t2ms_tpu_torch.ops.dit_block import (fused_dit_stack,
                                              fused_dit_stack_reference)
    dev = torch.device("cuda")

    def inputs(B, dt):
        f = lambda *s: torch.randn(*s, generator=gen, device=dev)
        L, D, hid = DEPTH, D_MODEL, HIDDEN
        x = f(B, N_TOK, D).to(dt)
        mod = (0.3 * f(B, L, 6, D)).to(dt)
        ws = [(0.2 * f(L, D, 3 * D)).to(dt), (0.1 * f(L, 3 * D)).to(dt),
              (0.2 * f(L, D, D)).to(dt), (0.1 * f(L, D)).to(dt),
              (0.2 * f(L, D, hid)).to(dt), (0.1 * f(L, hid)).to(dt),
              (0.2 * f(L, hid, D)).to(dt), (0.1 * f(L, D)).to(dt)]
        return x, mod, ws

    out = {}
    # tolerance: bf16 rounding flips compound over 4 layers; f32 differs
    # only in summation order
    for dt, B, tol in ((torch.bfloat16, 2 * B_SERIES, 3e-2),
                       (torch.float32, 32, 2e-4)):
        x, mod, ws = inputs(B, dt)
        got = fused_dit_stack(x, mod, *ws, HEADS)
        want = fused_dit_stack_reference(x, mod, *ws, HEADS)
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        check(bool(torch.isfinite(g).all()), f"{dt} kernel output finite")
        err = (g - w).abs().max().item()
        ref = w.abs().max().item()
        same = (g == w).float().mean().item()
        corr = torch.corrcoef(torch.stack([g.flatten(), w.flatten()]))[0, 1]
        log(f"kernel {dt} B={B} N={N_TOK} D={D_MODEL} H={HEADS} "
            f"hidden={HIDDEN} L={DEPTH}: max_abs_err={err:.6g} "
            f"max|ref|={ref:.6g} rel={err / ref:.3e} (tol {tol:g}) "
            f"mean_abs_err={(g - w).abs().mean().item():.3e} "
            f"bit_equal={same:.4f} corr={corr.item():.8f}")
        check(err <= tol * ref, f"{dt} kernel vs twin {err} > {tol}*{ref}")
        check(corr.item() >= 0.999, f"{dt} kernel vs twin corr {corr}")
        if dt == torch.bfloat16:
            stack_variants(fused_dit_stack, got, x, mod, ws)
            # both bf16 results against the f32 twin on the same values:
            # the kernel may not round worse than its twin
            truth = fused_dit_stack_reference(
                x.float(), mod.float(), *(w_.float() for w_ in ws), HEADS)
            ek = (g - truth).abs().mean().item()
            et = (w - truth).abs().mean().item()
            del truth
            log(f"kernel bf16 vs f32 twin: mean_abs_err kernel {ek:.4e} "
                f"twin {et:.4e} ratio {ek / et:.4f} (tol 1.5)")
            check(ek <= 1.5 * et, "bf16 kernel rounds worse than its twin")
        ms = cuda_ms(lambda: fused_dit_stack(x, mod, *ws, HEADS))
        plain = cuda_ms(lambda: fused_dit_stack_reference(x, mod, *ws,
                                                          HEADS))
        flops, nbytes = stack_work(B, N_TOK, D_MODEL, HEADS, HIDDEN, DEPTH,
                                   [x, mod, *ws])
        peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_F32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES * 1e3
        log(f"kernel {dt}: {ms:.4f} ms, twin {plain:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms "
            f"({flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB)")
        out[dt] = dict(err=err, ms=ms, plain=plain,
                       bound=max(t_ops, t_bytes),
                       by="operations" if t_ops >= t_bytes else "bytes")
        if dt == torch.bfloat16:
            split = device_split_on_route(
                "kernel bf16", lambda: fused_dit_stack(x, mod, *ws, HEADS),
                STACK_PARTS)
            log("kernel bf16 device time by part (torch.profiler, one call): "
                + fmt_split(split))
            out["sdpa_ms"] = sdpa_attention_ms(gen, B)
            log(f"yardstick: SDPA over the stack's attention alone "
                f"(B={B}, {HEADS} heads, N={N_TOK}, d={D_MODEL // HEADS}, "
                f"x{DEPTH} layers): {out['sdpa_ms']:.4f} ms")
            dense = dense_matmul_ms(gen, B * N_TOK)
            log(f"yardstick: cuBLAS (torch.matmul) over the stack's four "
                f"dense products alone (rows={B * N_TOK}: qkv, proj, fc1, "
                f"fc2, x{DEPTH} layers): {dense:.4f} ms")
    return out


# the first kernels of dit_common.cuh, which the bf16 main path must not run
FIRST_PARTS = ("modln_qkv_kernel", "attn_proj_kernel", "mlp_kernel")


def device_split_on_route(what, fn, parts, absent=FIRST_PARTS):
    """``device_ms_by_kernel`` of one call of ``fn``, checked to show every
    one of ``parts`` and none of ``absent`` (the route's kernels, not the
    first ones); not measured when the profiler records no device time."""
    times = device_ms_all(fn)
    if not times:
        log(f"{what}: route not measured (no device time recorded)")
        return {}
    seen = [n for n in parts if any(_named(k, n) for k in times)]
    off = sorted(k for k in times for n in absent if _named(k, n))
    check(len(seen) == len(parts) and not off,
          f"{what} ran {sorted(times)}: want every one of {parts} and none "
          f"of {absent}")
    split = {n: sum(ms for k, ms in times.items() if _named(k, n))
             for n in parts}
    split["(all device time)"] = sum(times.values())
    return split


def dense_matmul_ms(gen, rows, layers=DEPTH, D=D_MODEL, hidden=HIDDEN):
    """Time of torch.matmul (cuBLAS) on a block's four dense products
    alone, (rows x D) @ wqkv, @ wproj, @ wfc1 and (rows x hidden) @ wfc2 in
    bf16, over ``layers`` layers (yardstick only: no biases, LayerNorm,
    GELU or residuals)."""
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
    a, h = f(rows, D), f(rows, hidden)
    ws = [f(D, 3 * D), f(D, D), f(D, hidden), f(hidden, D)]

    def run():
        for _ in range(layers):
            torch.matmul(a, ws[0])
            torch.matmul(a, ws[1])
            torch.matmul(a, ws[2])
            torch.matmul(h, ws[3])
    return cuda_ms(run)


def stack_variants(fused_dit_stack, plain, x, mod, ws):
    """JAX's opt-in variants of the stack (B3) on the same inputs: each
    one launch counted as the stack, bit for bit the plain call's output."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    for kw in (dict(batch_block=2), dict(attn_impl="folded"),
               dict(batch_block=2, attn_impl="folded")):
        _build.reset_launch_counts()
        got = fused_dit_stack(x, mod, *ws, HEADS, **kw)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        check(launches == {STACK_KERNEL: 1},
              f"stack variant {kw} launches {launches}")
        check(torch.equal(got, plain), f"stack variant {kw} differs from "
              f"the plain call")
        log(f"stack variant {kw} B={x.shape[0]}: bit-equal to the plain "
            f"call, launches {launches}")


# the three CUDA kernels one bf16 fused_dit_stack call launches per layer at
# the main path's head width (csrc/dit_layer.cuh)
STACK_PARTS = ("modln_qkv_tc_kernel", "heads_fwd_kernel",
               "proj_mlp_tc_kernel")


def device_ms_all(fn, reps: int = 3):
    """Device time (ms) of every kernel over one call of ``fn`` (after one
    warm-up call), summed over launches by name, from torch.profiler;
    empty when the profiler records no device time. The window holds
    ``reps`` calls, opened by a short spin kernel (``torch.cuda._sleep``,
    left out), and each name's time is its mean per launch times its
    launches per call (its count over ``reps``, rounded): the profiler
    drops a window's first kernel now and then, so one launch may be
    missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    totals = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if (us <= 0 or getattr(ev, "device_type", None) != DeviceType.CUDA
                or "spin_kernel" in ev.key):
            continue
        t, n = totals.get(ev.key, (0.0, 0))
        totals[ev.key] = (t + us / 1e3, n + ev.count)
    return {key: t / n * max(round(n / reps), 1)
            for key, (t, n) in totals.items()}


def _named(key, name):
    """Whether a profiler kernel key names ``name`` as a whole identifier
    (mod_ln_fwd_kernel does not name res_mod_ln_fwd_kernel)."""
    return re.search(r"(?<![A-Za-z0-9_])" + re.escape(name), key) is not None


def device_ms_by_kernel(fn, names):
    """Device time (ms) of the kernels whose names contain one of
    ``names`` over one call of ``fn`` (``device_ms_all``), and every
    kernel's under "(all device time)"; empty when none was recorded."""
    times = device_ms_all(fn)
    split = {}
    for key, ms in times.items():
        for n in names:
            if _named(key, n):
                split[n] = split.get(n, 0.0) + ms
    if split:
        split["(all device time)"] = sum(times.values())
    return split


def fmt_split(split):
    return (", ".join(f"{k} {v:.4f} ms" for k, v in split.items()) if split
            else "not measured (no device time recorded)")


def sdpa_attention_ms(gen, B, heads=HEADS, N=N_TOK, dh=D_MODEL // HEADS,
                      layers=DEPTH):
    """Time of torch's SDPA on the attention part of ``layers`` blocks
    alone (yardstick only; no single PyTorch call computes a block)."""
    import torch.nn.functional as F
    f = lambda: torch.randn(B, heads, N, dh, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
    q, k, v = f(), f(), f()

    def run():
        for _ in range(layers):
            F.scaled_dot_product_attention(q, k, v)
    return cuda_ms(run)


def build_models(seed: int):
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.models.vae import LAVAE
    torch.manual_seed(seed)
    dit = DiT(latent_len=30, latent_dim=64, d_model=D_MODEL, depth=DEPTH,
              num_heads=HEADS, mlp_ratio=HIDDEN / D_MODEL,
              compute_dtype=torch.bfloat16)
    vae = LAVAE(in_channels=1, latent_grid=30)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        # adaLN-zero init would zero every gate and hide faults: move
        # every parameter off its init
        for p in dit.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
    return dit, vae.eval()


def offline_phase(dit, vae, gen):
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    x1 = torch.randn(B_SERIES, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(B_SERIES, D_MODEL, generator=gen, device="cuda")

    # a few steps: the kernel path against the eager opt-out path on the
    # same injected noise
    few = 4
    plain = DiT(latent_len=30, latent_dim=64, d_model=D_MODEL, depth=DEPTH,
                num_heads=HEADS, mlp_ratio=HIDDEN / D_MODEL,
                compute_dtype=torch.bfloat16, attention_impl="einsum")
    plain.load_state_dict(dit.state_dict())
    truth = DiT(latent_len=30, latent_dim=64, d_model=D_MODEL, depth=DEPTH,
                num_heads=HEADS, mlp_ratio=HIDDEN / D_MODEL,
                compute_dtype=torch.float32, attention_impl="einsum")
    truth.load_state_dict(dit.state_dict())
    x_t0 = torch.randn(B_SERIES, 64, 30, generator=gen, device="cuda")
    run = lambda m: make_cfg_sampler(m, vae, total_step=few, cfg_scale=CFG,
                                     out_length=OUT_LEN)(x1, emb, x_t0=x_t0)
    _build.reset_launch_counts()
    k_out = run(dit)
    check(_build.launch_counts[STACK_KERNEL] == few, "kernel path launches")
    p_out, t_out = run(plain), run(truth)
    check(_build.launch_counts[STACK_KERNEL] == few, "plain path launched")
    # the two bf16 paths round at different points (the fused recipe vs
    # flax's eager one) and cfg 7 amplifies cond - uncond; the f32 eager
    # path is the yardstick both are held to
    tol = 5e-2
    for name in ("latent", "series"):
        a, b, t = (getattr(o, name).float() for o in (k_out, p_out, t_out))
        err = (a - b).abs().max().item()
        ref = b.abs().max().item()
        ek, ep = (a - t).abs().mean().item(), (b - t).abs().mean().item()
        log(f"offline {few} steps, kernel vs eager path, {name}: "
            f"max_abs_err={err:.4g} max|ref|={ref:.4g} rel={err / ref:.3e} "
            f"(tol {tol:g}); mean_abs_err vs f32 eager: kernel path "
            f"{ek:.4e} eager bf16 path {ep:.4e} (kernel <= 1.5x eager)")
        check(err <= tol * ref, f"kernel vs eager path {name}")
        check(ek <= 1.5 * ep, f"kernel path rounds worse than eager {name}")

    sampler = make_cfg_sampler(dit, vae, total_step=STEPS, cfg_scale=CFG,
                               out_length=OUT_LEN)
    gen_noise = torch.Generator(device="cuda")
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(x1, emb, generator=gen_noise.manual_seed(7))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    series = out.series
    check(tuple(series.shape) == (B_SERIES, OUT_LEN), "series shape")
    check(bool(torch.isfinite(series).all()), "series finite")
    check(launches.get(STACK_KERNEL, 0) == STEPS,
          f"stack kernel launched {launches} times, want {STEPS}")
    log(f"offline flagship: B={B_SERIES} euler/{STEPS} cfg {CFG} len "
        f"{OUT_LEN}: {dt:.3f} s, {B_SERIES / dt:.2f} series/s, launches "
        f"{launches}, series mean {series.mean().item():.4g} std "
        f"{series.std().item():.4g}")
    # one sampler step (the 2B CFG forward and the Euler update): whether
    # the stack, the glue around it or the host bounds the flagship
    from t2ms_tpu_torch.sampling.sampler import (_flow_step,
                                                 _fused_cfg_forward,
                                                 _serving_forward)
    fwd = _serving_forward(dit, torch.device("cuda"))
    t_half = torch.full((B_SERIES,), 0.5, device="cuda")
    vel = lambda x_t, _t: _fused_cfg_forward(fwd, x_t, t_half, emb, CFG)
    with torch.no_grad():
        log_device_time(f"offline flagship CFG step (2B={2 * B_SERIES})",
                        lambda: _flow_step("euler", vel, x_t0, STEPS // 2,
                                           STEPS), STACK_PARTS)
    return launches


def server_phase(dit, vae, seed):
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    from t2ms_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((72, D_MODEL)).astype(np.float32)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with ServingEngine(dit, vae, total_step=STEPS, out_lengths=(24, 96),
                       batch_tiers=(1, 16, 64), max_wait_ms=50.0,
                       text_emb_dim=D_MODEL) as eng:
        mixed = [(embs[i], (24, 96)[i % 2], (3.0, 7.0, 5.0)[i % 3],
                  1000 + i) for i in range(8)]
        res = eng.generate(mixed)
        for (e, L, c, s), r in zip(mixed, res):
            check(r.series.shape == (L,) and np.isfinite(r.series).all(),
                  f"engine result for length {L}")
            check(r.seed == s and r.cfg_scale == c, "engine bookkeeping")
        # one seed inside a full 64-row batch, then alone
        futs = [eng.submit(embs[8 + i], 96, CFG, 2000 + i)
                for i in range(64)]
        full = [f.result(timeout=600) for f in futs]
        solo = eng.submit(embs[8 + 5], 96, CFG, 2005).result(timeout=600)
        stats = eng.stats()
    dt = time.perf_counter() - t0
    check(full[5].batch_size == 64 and solo.batch_size == 1,
          f"batch tiers {full[5].batch_size}, {solo.batch_size}")
    err = float(np.abs(full[5].series - solo.series).max())
    ref = float(np.abs(solo.series).max())
    tol = 2e-2   # other batch sizes may pick other library GEMM algorithms
    log(f"server: {stats['requests']} requests in {stats['batches']} "
        f"batches, {dt:.3f} s, p50 {stats['p50_latency_s']:.3f} s, "
        f"padding {stats['padding_fraction']:.3f}; seed alone vs in a full "
        f"batch: max_abs_err={err:.4g} max|ref|={ref:.4g} (tol {tol:g}); "
        f"launches {dict(_build.launch_counts)}")
    check(err <= tol * ref, "seed alone vs in a full batch")
    check(_build.launch_counts.get(STACK_KERNEL, 0) > 0,
          "server path launched the stack kernel")


# --------------------------------------------- the train step's block kernels

# the CUDA kernels of one fused_dit_block call and of one bf16 backward
# call (csrc/dit_block_bwd.cu: the recompute on the stack's kernels, then
# the tensor-core backward, its attention VJP on csrc/heads_bwd.cuh)
BLOCK_PARTS = STACK_PARTS
BWD_PARTS = STACK_PARTS + (
    "transpose4_kernel", "mlp_bwd_tc_kernel", "attn_out_bwd_tc_kernel",
    "heads_bwd_q_kernel", "heads_bwd_kv_kernel", "qkv_bwd_tc_kernel",
    "wgrad_tc_kernel", "sum_splits_kernel", "dmod_reduce_kernel")
# the backward's first kernels, which the f32 entry still runs and the bf16
# backward must not
FIRST_BWD_PARTS = FIRST_PARTS + (
    "mlp_bwd_kernel", "attn_out_bwd_kernel", "attn_dq_kernel",
    "attn_dkdv_kernel", "qkv_bwd_kernel", "wgrad_kernel")
GRAD_NAMES = ("dx", "dmod", "dwqkv", "dbqkv", "dwproj", "dbproj", "dwfc1",
              "dbfc1", "dwfc2", "dbfc2")


def block_work(B, N, D, H, hidden, tensors_fwd, tensors_bwd):
    """(forward flops, backward flops, forward bytes, backward bytes) of one
    block call and one block-VJP call. The VJP (whose residuals are the
    inputs, as in the JAX kernel) recomputes the forward and then does two
    products per dense product and four per attention product (dP, dQ, dK,
    dV). Bytes: each input read once and each output written once."""
    rows = B * N
    dense = 2 * rows * (D * 3 * D + D * D + 2 * D * hidden)
    attn = 2 * 2 * B * H * N * N * (D // H)
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return (dense + attn, (dense + attn) + 2 * dense + 2 * attn,
            nb(tensors_fwd), nb(tensors_bwd))


def _vjp(fn, args, dy):
    ts = [a.detach().requires_grad_() for a in args]
    out = fn(*ts, HEADS)
    return out, torch.autograd.grad(out, ts, dy)


def _err(g, w):
    g, w = g.float(), w.float()
    ref = w.abs().max().item()
    err = (g - w).abs().max().item()
    corr = torch.corrcoef(torch.stack([g.flatten(), w.flatten()]))[0, 1]
    return err, ref, corr.item()


def block_phase(gen):
    """Kernels #2 and #3 against their twins at the train step's width."""
    from t2ms_tpu_torch.ops.dit_block import (_launch_block_bwd,
                                              fused_dit_block,
                                              fused_dit_block_diffable,
                                              fused_dit_block_reference)
    dev = torch.device("cuda")
    f = lambda *s_: torch.randn(*s_, generator=gen, device=dev)

    def inputs(B, dt):
        D, hid = D_MODEL, HIDDEN
        # f32 weights (the params), x and mod in the compute dtype
        ws = [0.2 * f(D, 3 * D), 0.1 * f(3 * D), 0.2 * f(D, D), 0.1 * f(D),
              0.2 * f(D, hid), 0.1 * f(hid), 0.2 * f(hid, D), 0.1 * f(D)]
        return [f(B, N_TOK, D).to(dt), (0.3 * f(B, 6, D)).to(dt), *ws]

    out = {}
    # tolerances: forward as the stack's (bf16 3e-2, f32 2e-4 * max|ref|);
    # backward bf16 5e-2 * max|ref| against a twin that rounds each op of
    # its backward to bf16, f32 5e-4 (summation order over up to B*N rows)
    for dt, B, tol_f, tol_b in ((torch.bfloat16, B_TRAIN, 3e-2, 5e-2),
                                (torch.float32, 8, 2e-4, 5e-4)):
        args = inputs(B, dt)
        dy = f(B, N_TOK, D_MODEL).to(dt)
        got_y, got = _vjp(fused_dit_block_diffable, args, dy)
        want_y, want = _vjp(fused_dit_block_reference, args, dy)
        torch.cuda.synchronize()
        truth = None
        if dt == torch.bfloat16:
            _, truth = _vjp(fused_dit_block_reference,
                            [a.float() for a in args], dy.float())
        errs = {}
        for name, g, w, t in zip(("y",) + GRAD_NAMES, (got_y, *got),
                                 (want_y, *want),
                                 (None,) * 11 if truth is None
                                 else (None, *truth)):
            check(bool(torch.isfinite(g.float()).all()), f"{dt} {name} finite")
            err, ref, corr = _err(g, w)
            tol = tol_f if name == "y" else tol_b
            line = (f"block {dt} B={B} {name}: max_abs_err={err:.6g} "
                    f"max|ref|={ref:.6g} rel={err / ref:.3e} (tol {tol:g}) "
                    f"corr={corr:.8f}")
            if t is not None:
                ek = (g.float() - t).abs().mean().item()
                et = (w.float() - t).abs().mean().item()
                line += (f"; mean_abs_err vs f32 truth kernel {ek:.4e} twin "
                         f"{et:.4e} ratio {ek / et:.4f} (tol 1.5)")
                check(ek <= 1.5 * et, f"{dt} {name} rounds worse than twin")
            log(line)
            check(err <= tol * ref, f"{dt} {name} kernel vs twin")
            check(corr >= 0.999, f"{dt} {name} corr {corr}")
            errs[name] = err
        del truth, got, want
        fwd = lambda: fused_dit_block(*args, HEADS)
        bwd = lambda: _launch_block_bwd(args[0], args[1], args[2:], dy, HEADS,
                                        1e-6)
        with torch.no_grad():
            ms_f = cuda_ms(fwd)
            plain_f = cuda_ms(lambda: fused_dit_block_reference(*args, HEADS))
            ms_b = cuda_ms(bwd)
        ts = [a.detach().requires_grad_() for a in args]
        graph = fused_dit_block_reference(*ts, HEADS)
        plain_b = cuda_ms(lambda: torch.autograd.grad(graph, ts, dy,
                                                      retain_graph=True))
        del graph, ts
        fl_f, fl_b, by_f, by_b = block_work(
            B, N_TOK, D_MODEL, HEADS, HIDDEN, [*args, args[0]],
            [*args, dy, args[0], args[1], *args[2:]])
        peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_F32_FLOPS
        res = {}
        for name, ms, plain, fl, nb in (("fwd", ms_f, plain_f, fl_f, by_f),
                                        ("bwd", ms_b, plain_b, fl_b, by_b)):
            t_ops, t_bytes = fl / peak * 1e3, nb / H100_BYTES * 1e3
            res[name] = dict(ms=ms, plain=plain, bound=max(t_ops, t_bytes),
                             by="operations" if t_ops >= t_bytes else "bytes")
            log(f"block {dt} B={B} {name}: {ms:.4f} ms, twin {plain:.4f} ms, "
                f"bound {max(t_ops, t_bytes):.4f} ms ({fl / 1e12:.4f} TFLOP, "
                f"{nb / 1e9:.4f} GB)")
        res["fwd"]["err"] = errs["y"]
        res["bwd"]["err"] = max(v for k, v in errs.items() if k != "y")
        out[dt] = res
        if dt == torch.bfloat16:
            with torch.no_grad():
                log("block bf16 forward device time by part (torch.profiler, "
                    "one call): " + fmt_split(device_split_on_route(
                        "block bf16 forward", fwd, BLOCK_PARTS)))
                log("block bf16 backward device time by part (torch.profiler,"
                    " one call): " + fmt_split(device_split_on_route(
                        "block bf16 backward", bwd, BWD_PARTS,
                        FIRST_BWD_PARTS)))
            out["sdpa_ms"] = sdpa_fwd_bwd_ms(gen, B)
            log(f"yardstick: SDPA forward+backward over the block's attention "
                f"alone (B={B}, {HEADS} heads, N={N_TOK}, "
                f"d={D_MODEL // HEADS}): {out['sdpa_ms']:.4f} ms")
            out["cublas_bwd_ms"] = bwd_dense_matmul_ms(B * N_TOK)
            log(f"yardstick: cuBLAS (torch.matmul) over the backward's 12 "
                f"dense products alone (rows={B * N_TOK}: the recompute's "
                f"qkv, proj, fc1, fc2, then dX and dW of each): "
                f"{out['cublas_bwd_ms']:.4f} ms")
        del args, dy
        torch.cuda.empty_cache()
    return out


def bwd_dense_matmul_ms(rows):
    """Time of torch.matmul (cuBLAS) on the dense products of one block
    VJP alone, in bf16: the recompute's four (z1 @ wqkv, o @ wproj,
    z2 @ wfc1, h1 @ wfc2), then for each layer dX = dY W^T and dW = X^T dY
    (yardstick only: no biases, LayerNorm, GELU or attention). Its inputs
    come from a generator of its own, so that it leaves the shared one,
    and with it every later phase's data, as it was."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
    D, hid = D_MODEL, HIDDEN
    a, h, g3, gd, gh = (f(rows, D), f(rows, hid), f(rows, 3 * D),
                        f(rows, D), f(rows, hid))
    ws = [f(D, 3 * D), f(D, D), f(D, hid), f(hid, D)]
    pairs = ((a, ws[0], g3), (a, ws[1], gd), (a, ws[2], gh), (h, ws[3], gd))

    def run():
        for x, w, _ in pairs:
            torch.matmul(x, w)
        for x, w, g in pairs:
            torch.matmul(g, w.t())
            torch.matmul(x.t(), g)
    return cuda_ms(run)


def sdpa_fwd_bwd_ms(gen, B):
    """torch SDPA forward and backward on the block's attention part alone
    (yardstick only; no single PyTorch call computes the block or its
    VJP)."""
    import torch.nn.functional as F
    f = lambda: torch.randn(B, HEADS, N_TOK, D_MODEL // HEADS, generator=gen,
                            device="cuda", dtype=torch.bfloat16)
    q, k, v = (f().requires_grad_() for _ in range(3))
    g = f()

    def run():
        o = F.scaled_dot_product_attention(q, k, v)
        torch.autograd.grad(o, (q, k, v), g)
    return cuda_ms(run)


def train_phase(dit, vae, gen):
    """The flagship train step (bench.py:124-166) on a copy of the DiT."""
    from t2ms_tpu_torch.models.denoisers import DiT
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import BLOCK_BWD_KERNEL, BLOCK_KERNEL
    from t2ms_tpu_torch.training import (make_denoiser_train_step,
                                         onecycle_adamw)
    model = copy.deepcopy(dit)
    opt = onecycle_adamw(model.parameters(), TRAIN_WARMUP + TRAIN_STEPS,
                         max_lr=1e-4)
    step = make_denoiser_train_step(model, vae, opt, total_step=STEPS)
    x = torch.randn(B_TRAIN, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(B_TRAIN, D_MODEL, generator=gen, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    losses = [step(x, emb, generator=g) for _ in range(TRAIN_WARMUP)]
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step(x, emb, generator=g) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lv = torch.stack(losses).tolist()
    check(all(np.isfinite(lv)), f"train losses finite {lv}")
    for name in (BLOCK_KERNEL, BLOCK_BWD_KERNEL):
        check(launches.get(name, 0) == DEPTH * TRAIN_STEPS,
              f"{name} launched {launches.get(name, 0)} times in "
              f"{TRAIN_STEPS} steps, want {DEPTH} per step")
    log(f"train flagship: B={B_TRAIN} len {OUT_LEN} depth {DEPTH} bf16, "
        f"{TRAIN_STEPS} steps in {dt:.3f} s: {TRAIN_STEPS / dt:.4f} steps/s, "
        f"peak memory {peak_gb:.3f} GB, launches {launches} "
        f"({launches[BLOCK_KERNEL] // TRAIN_STEPS} forward and "
        f"{launches[BLOCK_BWD_KERNEL] // TRAIN_STEPS} backward per step), "
        f"losses {[round(v, 5) for v in lv]}")
    log_device_time("train flagship step", lambda: step(x, emb, generator=g),
                    tuple(dict.fromkeys(BLOCK_PARTS + BWD_PARTS)))

    # the kernel path against the eager opt-out paths on the same draws
    Bs = 128
    make = lambda dt_, impl: DiT(
        latent_len=30, latent_dim=64, d_model=D_MODEL, depth=DEPTH,
        num_heads=HEADS, mlp_ratio=HIDDEN / D_MODEL, compute_dtype=dt_,
        attention_impl=impl)
    train_paths_vs_eager("train", make, dit, vae, x[:Bs], emb[:Bs],
                         lambda: dict(
                             u=torch.rand(Bs, generator=g, device="cuda"),
                             x_0=torch.randn(Bs, 64, 30, generator=g,
                                             device="cuda"),
                             coin=torch.tensor(0.9, device="cuda")))
    return launches


# ----------------------------------------- the scaled DiT's split kernel

# the CUDA kernels of one bf16 fused_dit_block_split call at 8 heads of
# 64, by their names in the profile (csrc/wg_gemm.cuh's wg_gemm_kernel<PRO,
# EPI, WG, BN>): <0, 0, 2, 128> is modLN+qkv, <0, 1, 2, 128> modLN+fc1+
# GELU, <1, 2, 2, 128> the proj and fc2 products with their gated
# residuals; heads_fwd_kernel the attention. None is the first version's
# WMMA gemm_kernel.
SPLIT_ATTN = "heads_fwd_kernel<64>"
SPLIT_GEMMS = ("wg_gemm_kernel<0, 0, 2, 128>", "wg_gemm_kernel<1, 2, 2, 128>",
               "wg_gemm_kernel<0, 1, 2, 128>")
SPLIT_PARTS = (SPLIT_GEMMS[0], SPLIT_ATTN) + SPLIT_GEMMS[1:]
SPLIT_ABSENT = ("gemm_kernel<__nv_bfloat16",)


def split_inputs(gen, B, N, D, hidden, dt):
    """x and the weights in ``dt``, f32 adaLN vectors (random: adaLN-zero
    would zero every gate); weights of standard deviation 1/sqrt(fan-in),
    so the scores keep unit scale at every width."""
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    w = lambda i, o: f(i, o) / i ** 0.5
    ws = [w(D, 3 * D), 0.1 * f(3 * D), w(D, D), 0.1 * f(D), w(D, hidden),
          0.1 * f(hidden), w(hidden, D), 0.1 * f(D)]
    return f(B, N, D).to(dt), 0.3 * f(B, 6, D), [t.to(dt) for t in ws]


def split_phase(gen):
    """Kernel #4 against its twin at the scaled DiT's call, and against
    the stack kernel at the reference geometry."""
    from t2ms_tpu_torch.ops.dit_block import (fused_dit_block_reference,
                                              fused_dit_block_split,
                                              fused_dit_stack)
    out = {}
    D, H, hid = SC_D, SC_HEADS, SC_HIDDEN
    # tolerances as the stack's: bf16 3e-2 * max|ref| (rounding flips
    # between two f32 summation orders), f32 2e-4 (summation order only)
    for dt, B, tol in ((torch.bfloat16, 2 * SC_B, 3e-2),
                       (torch.float32, 2, 2e-4)):
        x, mod, ws = split_inputs(gen, B, SC_N, D, hid, dt)
        run = lambda: fused_dit_block_split(x, mod, *ws, H)
        twin = lambda: fused_dit_block_reference(x, mod, *ws, H)
        with torch.no_grad():
            got, want = run(), twin()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"split {dt} finite")
            err, ref, corr = _err(got, want)
            line = (f"split {dt} B={B} N={SC_N} D={D} H={H} hidden={hid}: "
                    f"max_abs_err={err:.6g} max|ref|={ref:.6g} "
                    f"rel={err / ref:.3e} (tol {tol:g}) corr={corr:.8f}")
            if dt == torch.bfloat16:
                truth = fused_dit_block_reference(
                    x.float(), mod, *(w_.float() for w_ in ws), H)
                ek = (got.float() - truth).abs().mean().item()
                et = (want.float() - truth).abs().mean().item()
                del truth
                line += (f"; mean_abs_err vs f32 twin kernel {ek:.4e} twin "
                         f"{et:.4e} ratio {ek / et:.4f} (tol 1.5)")
                check(ek <= 1.5 * et, "bf16 split rounds worse than its twin")
            log(line)
            check(err <= tol * ref, f"split {dt} vs twin {err} > {tol}*{ref}")
            check(corr >= 0.999, f"split {dt} vs twin corr {corr}")
            del got, want
            ms, plain = cuda_ms(run), cuda_ms(twin)
        flops, nbytes = stack_work(B, SC_N, D, H, hid, 1, [x, mod, *ws])
        peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_F32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES * 1e3
        log(f"split {dt} B={B}: {ms:.4f} ms, twin {plain:.4f} ms, bound "
            f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)")
        out[dt] = dict(err=err, ms=ms, plain=plain, bound=max(t_ops, t_bytes),
                       by="operations" if t_ops >= t_bytes else "bytes")
        if dt == torch.bfloat16:
            with torch.no_grad():
                split = device_split_on_route("split bf16", run, SPLIT_PARTS,
                                              SPLIT_ABSENT)
            log("split bf16 device time by kernel (torch.profiler, one call; "
                "<0, 0> modLN+qkv, <0, 1> modLN+fc1+GELU, <1, 2> proj and "
                "fc2 with gated residuals): " + fmt_split(split))
            if split:
                attn = split.get(SPLIT_ATTN, 0.0)
                gemm = sum(split.get(k_, 0.0) for k_ in SPLIT_GEMMS)
                log(f"split bf16 device time: attention {attn:.4f} ms "
                    f"({attn / (attn + gemm):.1%}), GEMMs {gemm:.4f} ms "
                    f"({gemm / (attn + gemm):.1%})")
            out["gemms"] = split_gemm_stages(B * SC_N, D, hid)
            out["sdpa_ms"] = sdpa_attention_ms(gen, B, H, SC_N, D // H, 1)
            log(f"yardstick: SDPA over the split block's attention alone "
                f"(B={B}, {H} heads, N={SC_N}, d={D // H}): "
                f"{out['sdpa_ms']:.4f} ms")
            out["cublas_ms"] = dense_matmul_ms(
                torch.Generator(device="cuda").manual_seed(13), B * SC_N, 1,
                D, hid)
            log(f"yardstick: cuBLAS (torch.matmul) over the split block's "
                f"four dense products alone ({B * SC_N} rows, D={D}, "
                f"hidden={hid}; its own generator): "
                f"{out['cublas_ms']:.4f} ms")
        del x, mod, ws
        torch.cuda.empty_cache()

    # the same block through the split and the stack kernels
    x, mod, ws = split_inputs(gen, 2 * B_SERIES, N_TOK, D_MODEL, HIDDEN,
                              torch.bfloat16)
    with torch.no_grad():
        a = fused_dit_block_split(x, mod, *ws, HEADS)
        b = fused_dit_stack(x, mod[:, None], *(w_[None] for w_ in ws), HEADS)
    err, ref, corr = _err(a, b)
    log(f"split vs stack kernel, bf16 B={2 * B_SERIES} N={N_TOK} "
        f"D={D_MODEL} H={HEADS}: max_abs_err={err:.6g} max|ref|={ref:.6g} "
        f"rel={err / ref:.3e} (tol 3e-2) corr={corr:.8f}")
    check(err <= 3e-2 * ref and corr >= 0.999, "split vs stack kernel")
    from t2ms_tpu_torch.ops.dit_block import split_gemm_route
    routes = {d: split_gemm_route(d) for d in (128, 512, 640, 1024, 1536)}
    log(f"split bf16 LayerNorm GEMM route by D (wide: 128-row blocks, "
        f"narrow: 64-row): {routes}")
    check(routes[SC_D] == "wide", f"scaled split route {routes[SC_D]}")
    return out


def split_gemm_stages(rows, D, hidden, reps: int = 3):
    """Each bf16 GEMM stage of the split block alone at ``rows`` rows
    (``dit_split_gemm_bf16``, the block's own kernels): device time
    (torch.profiler), TFLOP/s and share of its bound, the bound the larger
    of its operations at 989 TFLOP/s and its bytes (a, w, bias, mod, res
    and out, each once) at 3.35 TB/s. Inputs from their own generator."""
    from t2ms_tpu_torch.ops.dit_block import (SPLIT_GEMM_STAGES,
                                              _launch_split_gemm)
    g = torch.Generator(device="cuda").manual_seed(17)
    f = lambda *s_: torch.randn(*s_, generator=g, device="cuda")
    bf = lambda t: t.to(torch.bfloat16)
    B = rows // SC_N
    mod = 0.3 * f(B, 6, D)
    out = {}
    for stage in SPLIT_GEMM_STAGES:
        K, cols = {"qkv": (D, 3 * D), "proj": (D, D), "fc1": (D, hidden),
                   "fc2": (hidden, D)}[stage]
        a, w = bf(f(B, SC_N, K)), bf(f(K, cols) / K ** 0.5)
        bias, res = bf(0.1 * f(cols)), bf(f(B, SC_N, cols))
        resid = stage in ("proj", "fc2")
        run = lambda: _launch_split_gemm(a, mod, w, bias,
                                         res if resid else None, stage)
        with torch.no_grad():
            times = device_ms_all(run, reps)
        ms = sum(times.values())
        flops = 2.0 * rows * K * cols
        nbytes = _nbytes(a, w, bias, mod) + rows * cols * 2 * (2 if resid
                                                                else 1)
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        if ms:
            log(f"split bf16 GEMM {stage} ({rows} x {K} @ {K} x {cols}): "
                f"device {ms:.4f} ms ({', '.join(sorted(times))}), "
                f"{flops / ms / 1e9:.2f} TFLOP/s, bound {bound:.4f} ms "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
                f"{bound / ms:.2%} of its bound")
        else:
            log(f"split bf16 GEMM {stage}: not measured (no device time "
                f"recorded)")
        out[stage] = dict(ms=ms, flops=flops, bound=bound)
        del a, w, bias, res
    total = sum(r["ms"] for r in out.values())
    fl = sum(r["flops"] for r in out.values())
    if total:
        log(f"split bf16 GEMMs alone: {total:.4f} ms of device time, "
            f"{fl / total / 1e9:.2f} TFLOP/s over {fl / 1e9:.2f} GFLOP")
    return out


def scaled_dit(dtype, impl="auto"):
    from t2ms_tpu_torch.models.denoisers import DiT
    return DiT(latent_len=64, latent_dim=64, d_model=SC_D, depth=SC_DEPTH,
               num_heads=SC_HEADS, mlp_ratio=SC_HIDDEN / SC_D,
               compute_dtype=dtype, attention_impl=impl)


def build_scaled_models(seed: int):
    from t2ms_tpu_torch.models.vae import LAVAE
    torch.manual_seed(seed + 2)
    dit = scaled_dit(torch.bfloat16)
    vae = LAVAE(in_channels=1, latent_grid=64)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
    return dit, vae.eval()


def scaled_offline_phase(dit, vae, gen):
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import SPLIT_KERNEL, STACK_KERNEL
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    n_par = sum(p.numel() for p in dit.parameters())
    x1 = torch.randn(SC_B, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(SC_B, SC_D, generator=gen, device="cuda")

    # a few steps at full width: the kernel path against the eager opt-out
    # paths on the same injected noise
    x_t0 = torch.randn(SC_B, 64, 64, generator=gen, device="cuda")
    sampler_vs_eager("scaled offline", dit, scaled_dit, vae, x1, emb, x_t0,
                     OUT_LEN, {SPLIT_KERNEL: 4 * SC_DEPTH})

    sampler = make_cfg_sampler(dit, vae, total_step=SC_STEPS, cfg_scale=CFG,
                               out_length=OUT_LEN)
    gen_noise = torch.Generator(device="cuda")
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(x1, emb, generator=gen_noise.manual_seed(8))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    series = out.series
    check(tuple(series.shape) == (SC_B, OUT_LEN), "scaled series shape")
    check(bool(torch.isfinite(series).all()), "scaled series finite")
    check(launches.get(SPLIT_KERNEL, 0) == SC_STEPS * SC_DEPTH
          and launches.get(STACK_KERNEL, 0) == 0,
          f"scaled sample() launches {launches}, want "
          f"{SC_STEPS * SC_DEPTH} split and no stack")
    log(f"scaled offline: DiT {n_par} params (d {SC_D}, depth {SC_DEPTH}, "
        f"{SC_HEADS} heads, {SC_N} tokens) B={SC_B} euler/{SC_STEPS} cfg "
        f"{CFG} len {OUT_LEN}: {dt:.3f} s, {SC_B / dt:.3f} series/s, peak "
        f"memory {peak_gb:.3f} GB, launches {launches}, series mean "
        f"{series.mean().item():.4g} std {series.std().item():.4g}")
    return launches


def scaled_server_phase(dit, vae, seed):
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import SPLIT_KERNEL
    from t2ms_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(seed + 1)
    embs = rng.standard_normal((16, SC_D)).astype(np.float32)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with ServingEngine(dit, vae, total_step=SC_STEPS, out_lengths=(48, 96),
                       batch_tiers=(1, 4, 8), max_wait_ms=50.0,
                       text_emb_dim=SC_D) as eng:
        mixed = [(embs[i], (48, 96)[i % 2], (3.0, 7.0, 5.0)[i % 3],
                  3000 + i) for i in range(6)]
        res = eng.generate(mixed)
        for (e, L, c, s), r in zip(mixed, res):
            check(r.series.shape == (L,) and np.isfinite(r.series).all(),
                  f"scaled engine result for length {L}")
            check(r.seed == s and r.cfg_scale == c, "scaled engine bookkeeping")
        futs = [eng.submit(embs[6 + i], 96, CFG, 4000 + i) for i in range(8)]
        full = [f.result(timeout=600) for f in futs]
        solo = eng.submit(embs[6 + 5], 96, CFG, 4005).result(timeout=600)
        stats = eng.stats()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    check(full[5].batch_size == 8 and solo.batch_size == 1,
          f"scaled batch tiers {full[5].batch_size}, {solo.batch_size}")
    err = float(np.abs(full[5].series - solo.series).max())
    ref = float(np.abs(solo.series).max())
    tol = 2e-2   # other batch sizes may pick other library GEMM algorithms
    log(f"scaled server: {stats['requests']} requests in {stats['batches']} "
        f"batches, {dt:.3f} s, p50 {stats['p50_latency_s']:.3f} s, padding "
        f"{stats['padding_fraction']:.3f}; seed alone vs in a full batch: "
        f"max_abs_err={err:.4g} max|ref|={ref:.4g} (tol {tol:g}); launches "
        f"{launches}")
    check(err <= tol * ref, "scaled seed alone vs in a full batch")
    check(set(launches) == {SPLIT_KERNEL},
          "scaled server path launched the split kernel only")


# ---------------------------- the scaled train step's flax-path kernels

# the CUDA kernels of the flax path, by their names in the profile
MOD_LN_PARTS = ("mod_ln_fwd_kernel", "mod_ln_bwd_kernel",
                "res_mod_ln_fwd_kernel", "res_mod_ln_bwd_vec_kernel",
                "res_mod_ln_bwd_kernel", "dmod_reduce_kernel")
HEADS_PARTS = ("heads_fwd_kernel", "heads_bwd_q_kernel",
               "heads_bwd_kv_kernel")
# the library kernels around them, by name fragments: the dense products
# (cuBLAS's nvjet / gemm kernels), elementwise passes, reductions
OTHER_KINDS = (("library GEMMs", ("nvjet", "gemm", "cutlass", "xmma")),
               ("elementwise", ("elementwise",)),
               ("reductions", ("reduce",)))


def _row(err, ms, plain, fl, nb, peak, library=None):
    """A kernel table row's numbers: the bound is the larger of the
    operations over ``peak`` and the bytes over the memory rate."""
    t_ops, t_bytes = fl / peak * 1e3, nb / H100_BYTES * 1e3
    return dict(err=err, ms=ms, plain=plain, bound=max(t_ops, t_bytes),
                by="operations" if t_ops >= t_bytes else "bytes",
                library=library, flops=fl)


def _rate(r):
    """A row's achieved rate (the operations its bound counts over its
    time) and the share of its bound it reaches."""
    return (f"{r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
            f"{r['bound'] / r['ms']:.2%} of its bound")


RESOURCE_FIELDS = (("registers", r"Used (\d+) registers"),
                   ("stack B", r"(\d+) bytes stack frame"),
                   ("spill stores B", r"(\d+) bytes spill stores"),
                   ("spill loads B", r"(\d+) bytes spill loads"),
                   ("static smem B", r"(\d+) bytes smem"))


def _log_resources(what, chunk, smem):
    got = [(name, re.search(pat, chunk)) for name, pat in RESOURCE_FIELDS]
    log(f"{what}: "
        + ", ".join(f"{name} {m[1] if m else 0}" for name, m in got)
        + f", dynamic smem B {smem}")


def log_stack_resources():
    """ptxas's registers, stack, spills and static shared memory of the
    stack's tensor-core kernels as built into csrc/dit_stack.cu
    (``modln_qkv_tc_kernel``, ``heads_fwd_kernel`` at each head width,
    ``proj_mlp_tc_kernel`` with and without the MLP half), with their
    dynamic shared memory at the main path's widths (``dit_stack_smem``)."""
    from t2ms_tpu_torch.ops import _build
    text = _build.build_logs.get("dit_stack")
    if not text:
        log("stack kernel resources: not measured (dit_stack.cu was not "
            "built in this process)")
        return
    lib = _build.load("dit_stack")
    for chunk in text.split("Compiling entry function")[1:]:
        m = re.search(r"(modln_qkv_tc_kernel|"
                      r"proj_mlp_tc_kernelILi\d+ELb([01])E|"
                      r"heads_fwd_kernelILi(\d+)E)", chunk)
        if m is None:
            continue
        if m.group(3):
            dh = int(m.group(3))
            what, smem = (f"heads_fwd_kernel d={dh}",
                          lib.dit_stack_smem(1, D_MODEL, HIDDEN,
                                             max(D_MODEL // dh, 1)))
        elif m.group(2):
            mlp = m.group(2) == "1"
            what = f"proj_mlp_tc_kernel<{'true' if mlp else 'false'}>"
            smem = lib.dit_stack_smem(2 if mlp else 3, D_MODEL, HIDDEN, HEADS)
        else:
            what = "modln_qkv_tc_kernel"
            smem = lib.dit_stack_smem(0, D_MODEL, HIDDEN, HEADS)
        _log_resources(f"stack kernel resources {what} (D={D_MODEL}, "
                       f"hidden={HIDDEN})", chunk, smem)


def log_block_bwd_resources():
    """ptxas's registers, stack, spills and static shared memory of the bf16
    block backward's own kernels as built into csrc/dit_block_bwd.cu
    (``mlp_bwd_tc_kernel``, ``attn_out_bwd_tc_kernel``,
    ``qkv_bwd_tc_kernel``, ``wgrad_tc_kernel``, and the BLOCK recipe of
    ``heads_bwd_q_kernel`` and ``heads_bwd_kv_kernel`` at each head width),
    with their dynamic shared memory at the main path's widths
    (``dit_block_bwd_smem``)."""
    from t2ms_tpu_torch.ops import _build
    text = _build.build_logs.get("dit_block_bwd")
    if not text:
        log("block backward kernel resources: not measured (dit_block_bwd.cu "
            "was not built in this process)")
        return
    lib = _build.load("dit_block_bwd")
    rows = ("mlp_bwd_tc_kernel", "attn_out_bwd_tc_kernel",
            "qkv_bwd_tc_kernel", "wgrad_tc_kernel")
    for chunk in text.split("Compiling entry function")[1:]:
        m = re.search(r"(mlp_bwd_tc_kernel|attn_out_bwd_tc_kernel|"
                      r"qkv_bwd_tc_kernel|wgrad_tc_kernel|"
                      r"heads_bwd_(q|kv)_kernelILi(\d+)ELi3E)", chunk)
        if m is None:
            continue
        if m.group(2):
            dh = int(m.group(3))
            what = f"heads_bwd_{m.group(2)}_kernel d={dh} block"
            smem = lib.dit_block_bwd_smem(4 if m.group(2) == "q" else 5,
                                          D_MODEL, HIDDEN, D_MODEL // dh)
        else:
            what = m.group(1)
            smem = lib.dit_block_bwd_smem(rows.index(what), D_MODEL, HIDDEN,
                                          HEADS)
        _log_resources(f"block backward kernel resources {what} "
                       f"(D={D_MODEL}, hidden={HIDDEN})", chunk, smem)


def log_split_resources():
    """ptxas's registers, stack, spills and static shared memory of the
    split block's wgmma row GEMM (csrc/wg_gemm.cuh's ``wg_gemm_kernel`` as
    built into csrc/dit_split.cu: the LayerNorm GEMMs on the 128-row and
    64-row routes, the streamed one), with their dynamic shared memory
    (``dit_split_smem``: the 128-row route at D 512, the 64-row one at D
    1024); checked to spill nothing and to draw no ptxas C7512 ("wgmma
    serialized")."""
    from t2ms_tpu_torch.ops import _build
    text = _build.build_logs.get("dit_split")
    if not text:
        log("split kernel resources: not measured (dit_split.cu was not "
            "built in this process)")
        return
    lib = _build.load("dit_split")
    seen = 0
    for chunk in text.split("Compiling entry function")[1:]:
        m = re.search(r"wg_gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      chunk)
        if m is None:
            continue
        pro, epi, wg, bn = (int(v) for v in m.groups())
        stage = 1 if pro else (0 if epi == 0 else 2)
        K = SC_D if wg == 2 else 1024
        smem = lib.dit_split_smem(stage, K)
        _log_resources(f"split kernel resources wg_gemm_kernel<{pro}, {epi}, "
                       f"{wg}, {bn}> (K={K})", chunk, smem)
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", chunk)]
        check(not any(spills), f"wg_gemm_kernel<{pro}, {epi}, {wg}, {bn}> "
              f"spills {spills}")
        seen += 1
    check(seen == 5, f"{seen} wg_gemm_kernel instances in the build log, "
          f"want 5")
    check("C7512" not in text, "ptxas serialized a wgmma in dit_split.cu "
          "(C7512): " + "; ".join(l_ for l_ in text.splitlines()
                                   if "C7512" in l_))
    log("split kernel resources: no spills and no C7512 in the wgmma "
        "GEMMs")


def log_mod_ln_resources():
    """ptxas's registers, stack, spills and static shared memory of the
    bf16 #8 kernel on 16-byte chunks (csrc/mod_ln.cu's
    ``res_mod_ln_bwd_vec_kernel<CPL, G>``, CPL chunks a lane in groups of
    G lanes: D 128 takes <1, 16>, D 512 <2, 32>), with its dynamic shared
    memory at the widest D it serves, 8 CPL G (a 4 x 3 x D f32 buffer)."""
    from t2ms_tpu_torch.ops import _build
    text = _build.build_logs.get("mod_ln")
    if not text:
        log("mod_ln kernel resources: not measured (mod_ln.cu was not "
            "built in this process)")
        return
    for chunk in text.split("Compiling entry function")[1:]:
        m = re.search(r"res_mod_ln_bwd_vec_kernelILi(\d+)ELi(\d+)E", chunk)
        if m:
            cpl, g = int(m[1]), int(m[2])
            _log_resources(f"mod_ln kernel resources res_mod_ln_bwd_vec_"
                           f"kernel<{cpl}, {g}> (D={8 * cpl * g})", chunk,
                           4 * 3 * 4 * 8 * cpl * g)


def log_attention_resources():
    """ptxas's registers, stack, spills and static shared memory of the
    bf16 attention kernels (the -Xptxas=-v lines of this run's builds):
    the fused-heads forward's ``heads_fwd_kernel`` and the backward's
    ``heads_bwd_q_kernel`` and ``heads_bwd_kv_kernel`` (csrc/fused_heads.cu),
    with their dynamic shared memory from ``fused_heads_forward_smem`` and
    ``fused_heads_backward_smem``; and the head-split kernels of
    csrc/split_heads.cu at each head width: ``split_heads_online_kernel``
    (#15), ``split_heads_resident_kernel`` and ``split_heads_exact_kernel``
    (#16, #17: the resident and the streaming route), with
    ``split_heads_smem`` (the resident route's at 480 tokens)."""
    from t2ms_tpu_torch.ops import _build
    for name in ("fused_heads", "split_heads"):
        if not _build.build_logs.get(name):
            log(f"attention kernel resources: not measured ({name}.cu was "
                "not built in this process)")
    text = _build.build_logs.get("fused_heads")
    recipes = ("pipelined", "recompute", "lean")
    for chunk in (text or "").split("Compiling entry function")[1:]:
        fwd = re.search(r"heads_fwd_kernelILi(\d+)E", chunk)
        bwd = re.search(r"(heads_bwd_(?:q|kv)_kernel)ILi(\d+)ELi(\d+)E",
                        chunk)
        lib = _build.load("fused_heads")
        if fwd is not None:
            dh = int(fwd.group(1))
            what = f"fwd kernel resources heads_fwd_kernel d={dh}"
            smem = lib.fused_heads_forward_smem(dh)
        elif bwd is not None:
            kern, dh, rec = bwd.group(1), int(bwd.group(2)), int(bwd.group(3))
            what = f"bwd kernel resources {kern} d={dh} {recipes[rec]}"
            smem = lib.fused_heads_backward_smem(
                dh, rec, int(kern == "heads_bwd_kv_kernel"))
        else:
            continue
        _log_resources(what, chunk, smem)
    text = _build.build_logs.get("split_heads")
    for chunk in (text or "").split("Compiling entry function")[1:]:
        m = re.search(r"(split_heads_(online|resident|exact)_kernel)ILi(\d+)E",
                      chunk)
        if m is None:
            continue
        lib = _build.load("split_heads")
        kern, variant, dh = m.group(1), m.group(2), int(m.group(3))
        smem = lib.split_heads_smem(N_TOK, dh, int(variant != "online"),
                                    int(variant == "resident"))
        _log_resources(f"head-split kernel resources {kern} d={dh} "
                       f"({'online' if variant == 'online' else 'exact'})",
                       chunk, smem)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _check_err(what, g, w, tol, truth=None, truth_twin=None):
    """max-abs error of g against w within tol * max|w|, correlation
    >= 0.999; with an f32 truth, g's mean error against it at most 1.5x
    the twin's (w's)."""
    err, ref, corr = _err(g, w)
    line = (f"{what}: max_abs_err={err:.6g} max|ref|={ref:.6g} "
            f"rel={err / ref:.3e} (tol {tol:g}) corr={corr:.8f}")
    if truth is not None:
        ek = (g.float() - truth).abs().mean().item()
        et = (truth_twin.float() - truth).abs().mean().item()
        line += (f"; mean_abs_err vs f32 twin kernel {ek:.4e} twin {et:.4e} "
                 f"ratio {ek / et:.4f} (tol 1.5)")
        check(ek <= 1.5 * et, f"{what} rounds worse than its twin")
    log(line)
    check(bool(torch.isfinite(g.float()).all()), f"{what} finite")
    check(err <= tol * ref, f"{what} kernel vs twin {err} > {tol}*{ref}")
    check(corr >= 0.999, f"{what} corr {corr}")
    return err


def mod_ln_phase(gen):
    """Kernels #5 and #6 at the scaled train step's call against the twin
    and autograd over it. Tolerances: bf16 1e-2 * max|ref| (one rounding
    flip after f32 sums in another order), f32 1e-4 (summation order)."""
    from t2ms_tpu_torch.ops.dit_block import (_launch_mod_ln,
                                              _launch_mod_ln_bwd,
                                              mod_ln_reference)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    out = {}
    for dt, B, tol in ((torch.bfloat16, SC_TRAIN_B, 1e-2),
                       (torch.float32, 4, 1e-4)):
        x, mod2 = f(B, SC_N, SC_D).to(dt), (0.3 * f(B, 2, SC_D)).to(dt)
        dy = f(B, SC_N, SC_D).to(dt)
        fwd = lambda: _launch_mod_ln(x, mod2, 1e-6)
        bwd = lambda: _launch_mod_ln_bwd(x, mod2, dy, 1e-6)
        got_y, (got_dx, got_dm) = fwd(), bwd()
        ts = [x.detach().requires_grad_(), mod2.detach().requires_grad_()]
        graph = mod_ln_reference(*ts)
        want_dx, want_dm = torch.autograd.grad(graph, ts, dy,
                                               retain_graph=True)
        torch.cuda.synchronize()
        what = f"mod_ln {dt} B={B} N={SC_N} D={SC_D}"
        e_f = _check_err(f"{what} out", got_y, graph.detach(), tol)
        e_b = max(_check_err(f"{what} dx", got_dx, want_dx, tol),
                  _check_err(f"{what} dmod2", got_dm, want_dm, tol))
        check(got_dm.dtype == dt and got_dx.dtype == dt, "mod_ln grad dtypes")
        with torch.no_grad():
            ms_f, plain_f = cuda_ms(fwd), cuda_ms(
                lambda: mod_ln_reference(x, mod2))
            ms_b = cuda_ms(bwd)
        plain_b = cuda_ms(lambda: torch.autograd.grad(graph, ts, dy,
                                                      retain_graph=True))
        del graph, ts
        # f32 operations per element: LN statistics and normalisation
        # about 6, the modulate 3; the backward about twice that
        n = x.numel()
        out[dt] = {
            "fwd": _row(e_f, ms_f, plain_f, 9 * n, _nbytes(x, mod2, got_y),
                        H100_F32_FLOPS),
            "bwd": _row(e_b, ms_b, plain_b, 18 * n,
                        _nbytes(x, mod2, dy, got_dx, got_dm),
                        H100_F32_FLOPS)}
        for k in ("fwd", "bwd"):
            r = out[dt][k]
            log(f"mod_ln {dt} B={B} {k}: {r['ms']:.4f} ms, twin "
                f"{r['plain']:.4f} ms, bound {r['bound']:.4f} ms "
                f"({r['by']})")
        if dt == torch.bfloat16:
            ln_device_time(f"mod_ln {dt} B={B}", (
                ("fwd", fwd, "mod_ln_fwd_kernel", ()),
                ("bwd", bwd, "mod_ln_bwd_kernel", ())), out[dt])
        del x, mod2, dy, got_y, got_dx, got_dm, want_dx, want_dm
        torch.cuda.empty_cache()
    return out


def sdpa_heads_ms(q, k, v, g, heads):
    """torch SDPA over the head-split views of q, k, v (the library
    yardstick of #9 and #11; the port never calls it): (forward ms,
    backward ms read as forward+backward minus forward)."""
    import torch.nn.functional as F
    B, N, HD = q.shape
    split = lambda t: t.view(B, N, heads, HD // heads).transpose(1, 2)
    qh, kh, vh = (split(t).detach().requires_grad_() for t in (q, k, v))
    gh = split(g)
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))

    def both():
        o = F.scaled_dot_product_attention(qh, kh, vh)
        torch.autograd.grad(o, (qh, kh, vh), gh)
    return fwd, cuda_ms(both) - fwd


def _qkv_slices(f, B, N, HD, dt):
    """q, k, v as the column slices of one qkv tensor, and g."""
    qkv = torch.cat([1.5 * f(B, N, HD), 1.5 * f(B, N, HD), f(B, N, HD)],
                    dim=-1).to(dt)
    return (qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:],
            f(B, N, HD).to(dt))


def fused_heads_phase(gen):
    """Kernels #9 and #11 at the scaled train step's call, q/k/v the
    column slices of one qkv tensor, against their twins. Tolerances:
    forward bf16 1e-2 * max|ref|, f32 2e-4; backward bf16 3e-2 (rounding
    flips of e and ds_u feed sums over 1024 rows), f32 5e-4 (summation
    order)."""
    from t2ms_tpu_torch.ops.attention import (fused_heads_attention,
                                              fused_heads_attention_bwd,
                                              fused_heads_bwd_reference,
                                              fused_heads_reference)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    H, D, N = SC_HEADS, SC_D, SC_N
    out = {}
    for dt, B, tol_f, tol_b in ((torch.bfloat16, SC_TRAIN_B, 1e-2, 3e-2),
                                (torch.float32, 2, 2e-4, 5e-4)):
        q, k, v, g = _qkv_slices(f, B, N, D, dt)
        # the scaled geometry's backward: JAX's head-grouped pipelined one
        fwd = lambda: fused_heads_attention(q, k, v, H)
        bwd = lambda: fused_heads_attention_bwd(q, k, v, g, H, pipelined=True)
        with torch.no_grad():
            got_o, got = fwd(), bwd()
            want_o = fused_heads_reference(q, k, v, H)
            want = fused_heads_bwd_reference(q, k, v, g, H)
            torch.cuda.synchronize()
            t_o = t_g = (None,) * 3
            if dt == torch.bfloat16:
                f32 = [t.float() for t in (q, k, v, g)]
                t_o = fused_heads_reference(*f32[:3], H)
                t_g = fused_heads_bwd_reference(*f32, H)
                del f32
            what = f"fused_heads {dt} B={B} N={N} HD={D} H={H}"
            e_f = _check_err(f"{what} out", got_o, want_o, tol_f,
                             t_o if dt == torch.bfloat16 else None, want_o)
            e_b = max(_check_err(f"{what} {n}", a, b, tol_b, t, b)
                      for n, a, b, t in zip(("dq", "dk", "dv"), got, want,
                                            t_g))
            del t_o, t_g, got, want
            ms_f, ms_b = cuda_ms(fwd), cuda_ms(bwd)
            plain_f = cuda_ms(lambda: fused_heads_reference(q, k, v, H))
            plain_b = cuda_ms(lambda: fused_heads_bwd_reference(q, k, v, g,
                                                                H))
        lib_f, lib_b = (sdpa_heads_ms(q, k, v, g, H) if dt == torch.bfloat16
                        else (None, None))
        prod = 2 * B * H * N * N * (D // H)         # one N x N x d product
        peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_F32_FLOPS
        out[dt] = {
            "fwd": _row(e_f, ms_f, plain_f, 2 * prod,
                        _nbytes(q, k, v, got_o), peak, lib_f),
            "bwd": _row(e_b, ms_b, plain_b, 5 * prod,
                        _nbytes(q, k, v, g, q, k, v), peak, lib_b)}
        for n in ("fwd", "bwd"):
            r = out[dt][n]
            lib = (f", SDPA {r['library']:.4f} ms" if r["library"] is not None
                   else "")
            log(f"fused_heads {dt} B={B} {n}: {r['ms']:.4f} ms ({_rate(r)}),"
                f" twin {r['plain']:.4f} ms, bound {r['bound']:.4f} ms "
                f"({r['by']}){lib}")
        if dt == torch.bfloat16:
            with torch.no_grad():
                log("fused_heads bf16 device time by kernel (torch.profiler, "
                    "forward then backward): " + fmt_split(device_ms_by_kernel(
                        lambda: (fwd(), bwd()), HEADS_PARTS)))
        del q, k, v, g, got_o, want_o
        torch.cuda.empty_cache()
    return out


def scaled_train_phase(sc_dit, sc_vae, gen):
    """The scaled DiT's train step (scripts/bench_scaled.py:80-118) on a
    copy of the DiT, through the flax path's kernels."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import (FUSED_HEADS_BWD_KERNEL,
                                              FUSED_HEADS_KERNEL)
    from t2ms_tpu_torch.ops.dit_block import (MOD_LN_BWD_KERNEL,
                                              MOD_LN_KERNEL,
                                              RES_MOD_LN_BWD_KERNEL,
                                              RES_MOD_LN_KERNEL)
    from t2ms_tpu_torch.training import (ScheduledAdamW, encode_with_vae,
                                         make_denoiser_train_step)
    model = copy.deepcopy(sc_dit)
    # optax.adamw(1e-4): constant rate, weight decay 1e-4
    opt = ScheduledAdamW(model.parameters(), lambda _: 1e-4)
    step = make_denoiser_train_step(model, sc_vae, opt, total_step=STEPS,
                                    precoded=True)
    x = torch.randn(SC_TRAIN_B, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(SC_TRAIN_B, SC_D, generator=gen, device="cuda")
    z = encode_with_vae(sc_vae, x)[0]      # once, outside the step
    g = torch.Generator(device="cuda").manual_seed(12)
    losses = [step(z, emb, generator=g) for _ in range(TRAIN_WARMUP)]
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step(z, emb, generator=g) for _ in range(SC_TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lv = torch.stack(losses).tolist()
    check(all(np.isfinite(lv)), f"scaled train losses finite {lv}")
    want = {MOD_LN_KERNEL: 1, RES_MOD_LN_KERNEL: 2 * SC_DEPTH - 1,
            FUSED_HEADS_KERNEL: SC_DEPTH, MOD_LN_BWD_KERNEL: 1,
            RES_MOD_LN_BWD_KERNEL: 2 * SC_DEPTH - 1,
            FUSED_HEADS_BWD_KERNEL: SC_DEPTH}
    check(launches == {n: c * SC_TRAIN_STEPS for n, c in want.items()},
          f"scaled train launches {launches} in {SC_TRAIN_STEPS} steps, want "
          f"{want} per step and no two-pass, stack, block or split launch")
    rate, rates = step_rate(lambda: step(z, emb, generator=g),
                            SC_TRAIN_STEPS, dt)
    n_par = sum(p.numel() for p in model.parameters())
    log(f"scaled train: DiT {n_par} params (d {SC_D}, depth {SC_DEPTH}, "
        f"{SC_HEADS} heads, {SC_N} tokens) B={SC_TRAIN_B} bf16, precoded, "
        f"{SC_TRAIN_STEPS} steps in {dt:.3f} s: "
        f"{fmt_rate(rate, rates, SC_TRAIN_STEPS)}, peak memory "
        f"{peak_gb:.3f} GB, "
        f"launches {launches} ({want} per step), losses "
        f"{[round(v, 5) for v in lv]}")
    log_device_time("scaled train step", lambda: step(z, emb, generator=g))
    del model, opt, step
    torch.cuda.empty_cache()

    # the same steps on the eager bf16 path from the same init and draws:
    # AdamW at a constant 1e-4 from a random init moves the loss by large
    # steps, and the two paths must move together (tolerance 1e-2 of each
    # loss: bf16 rounding differences compound over the steps)
    eager = scaled_dit(torch.bfloat16, "einsum")
    eager.load_state_dict(sc_dit.state_dict())
    s_e = make_denoiser_train_step(
        eager, sc_vae, ScheduledAdamW(eager.parameters(), lambda _: 1e-4),
        total_step=STEPS, precoded=True)
    g_e = torch.Generator(device="cuda").manual_seed(12)
    le = [s_e(z, emb, generator=g_e).item() for _ in lv]
    worst = max(abs(a - b) / abs(b) for a, b in zip(lv, le))
    log(f"scaled train eager bf16 path, same init and draws: losses "
        f"{[round(v, 5) for v in le]}; kernel path within {worst:.3e} of "
        f"each (tol 1e-2)")
    check(worst <= 1e-2, f"scaled train losses {lv} vs eager {le}")
    del eager, s_e
    torch.cuda.empty_cache()

    # the kernel path against the eager opt-out paths on the same draws
    Bs = 8
    train_paths_vs_eager("scaled train", scaled_dit, sc_dit, sc_vae,
                         z[:Bs], emb[:Bs], lambda: dict(
                             u=torch.rand(Bs, generator=g, device="cuda"),
                             x_0=torch.randn(Bs, 64, 64, generator=g,
                                             device="cuda"),
                             coin=torch.tensor(0.9, device="cuda")),
                         precoded=True)
    return launches


def host_ms(fn, reps: int = 3) -> float:
    """Host time (ms) to enqueue one call of ``fn`` on an idle device,
    median of ``reps``: where it exceeds the call's device time, the host
    bounds the call's rate."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def log_device_time(what, fn, parts=MOD_LN_PARTS + HEADS_PARTS):
    """One call of ``fn`` under torch.profiler: the total device time, the
    port's kernels named in ``parts``, and the rest by kind; then the host
    time to enqueue one call (``host_ms``) against that device time."""
    times = device_ms_all(fn)
    if not times:
        log(f"{what} device time: not measured (no device time recorded)")
        return
    total = sum(times.values())
    ours = {n: sum(ms for key, ms in times.items() if _named(key, n))
            for n in parts}
    rest = sorted(((ms, key) for key, ms in times.items()
                   if not any(_named(key, n) for n in parts)), reverse=True)
    kinds = {}
    for ms, key in rest:
        kind = next((k for k, toks in OTHER_KINDS if any(
            t in key for t in toks)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    log(f"{what} device time (torch.profiler, one call): {total:.3f} ms; "
        "the port's kernels "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in ours.items())
        + f" (together {sum(ours.values()):.3f} ms, "
        f"{100 * sum(ours.values()) / total:.1f}%); the rest by kind "
        + ", ".join(f"{k} {ms:.3f}" for k, ms in kinds.items())
        + "; largest others "
        + "; ".join(f"{key[:60]} {ms:.3f}" for ms, key in rest[:6]))
    host = host_ms(fn)
    log(f"{what} host time to enqueue one call on an idle device: "
        f"{host:.3f} ms (median of 3), {host / total:.3f}x its device time")


def train_paths_vs_eager(what, make_dit, dit, vae, x, emb, make_draws,
                         precoded=False, n_draws=3, backbone="flowmatching"):
    """One train step's loss and every parameter's gradient through the
    kernel path, the eager bf16 and the eager f32 opt-out paths on the same
    injected draws (SGD at lr 0, so the step leaves the weights), for
    ``n_draws`` calls of ``make_draws``: each loss, and each parameter's
    mean error against f32 summed over the draws, no further from f32 than
    1.5x the eager bf16 path's. One draw's error on a tensor of a few
    values (the patchify conv's 4 biases) is one sum of rounding noise, so
    the errors are summed over draws before they are compared."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.training import make_denoiser_train_step
    errs = {}                       # parameter -> [kernel, eager bf16]
    for _ in range(n_draws):
        draws, res = make_draws(), {}
        for name, dt_, impl in (("kernel", torch.bfloat16, "auto"),
                                ("eager bf16", torch.bfloat16, "einsum"),
                                ("eager f32", torch.float32, "einsum")):
            m = make_dit(dt_, impl)
            m.load_state_dict(dit.state_dict())
            s_ = make_denoiser_train_step(
                m, vae, torch.optim.SGD(m.parameters(), lr=0.0), backbone,
                total_step=STEPS, precoded=precoded)
            _build.reset_launch_counts()
            loss = s_(x, emb, **draws).item()
            got = dict(_build.launch_counts)
            check((name == "kernel") == bool(got),
                  f"{what} {name} path launches {got}")
            res[name] = (loss, {n: p.grad.float() for n, p in
                                m.named_parameters()})
            del m, s_
            torch.cuda.empty_cache()
        (lk, gk), (lb, gb), (lt, gt) = (
            res[k] for k in ("kernel", "eager bf16", "eager f32"))
        for n in gt:
            e = errs.setdefault(n, [0.0, 0.0])
            e[0] += (gk[n] - gt[n]).abs().mean().item()
            e[1] += (gb[n] - gt[n]).abs().mean().item()
        # a scalar can land near the f32 value by chance: a floor of 1e-3
        check(abs(lk - lt) <= max(1.5 * abs(lb - lt), 1e-3 * abs(lt)),
              f"{what} loss kernel {lk} eager bf16 {lb} f32 {lt}")
        log(f"{what} B={x.shape[0]} same draws: loss kernel {lk:.6f} eager "
            f"bf16 {lb:.6f} eager f32 {lt:.6f}")
        del res, gk, gb, gt
    worst = 0.0
    for n, (ek, eb) in errs.items():
        worst = max(worst, ek / max(eb, 1e-30))
        check(ek <= 1.5 * eb, f"{what} grad {n}: kernel path {ek:.4e} "
              f"vs eager bf16 {eb:.4e} from f32 over {n_draws} draws")
    log(f"{what}: every parameter's grad, mean error vs f32 summed over "
        f"{n_draws} draws: the kernel path's at most {worst:.4f}x the eager "
        f"bf16 path's (tol 1.5)")
    torch.cuda.empty_cache()


def sampler_vs_eager(what, dit, make_dit, vae, x1, emb, x_t0, out_len,
                     want, few=4, step_noise=None, **sampler_kw):
    """``few`` sampler steps of ``dit`` against the eager bf16 and f32
    ``attention_impl='einsum'`` paths on the same noise (``x_t0``, and for
    the DDPM ancestral sampler ``step_noise``): the launches ``want``
    (kernel name -> count) and none on the eager paths, the kernel path
    within 5e-2 * max|ref| of the eager bf16 path and no further from the
    f32 path than 1.5x it. ``sampler_kw`` (backbone, solver, sample_steps,
    total_step) goes to ``make_cfg_sampler``; total_step defaults to
    ``few``."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    sampler_kw.setdefault("total_step", few)
    run = lambda m: make_cfg_sampler(m, vae, cfg_scale=CFG,
                                     out_length=out_len, **sampler_kw)(
        x1, emb, x_t0=x_t0, step_noise=step_noise)
    _build.reset_launch_counts()
    outs = [run(dit)]
    check(dict(_build.launch_counts) == want,
          f"{what} kernel path launches {dict(_build.launch_counts)}, want "
          f"{want}")
    for dt in (torch.bfloat16, torch.float32):
        m = make_dit(dt, "einsum")
        m.load_state_dict(dit.state_dict())
        outs.append(run(m))
        del m
        torch.cuda.empty_cache()
    check(dict(_build.launch_counts) == want,
          f"{what} eager paths launched a kernel")
    tol = 5e-2
    for name in ("latent", "series"):
        a, b, t = (getattr(o, name).float() for o in outs)
        err = (a - b).abs().max().item()
        ref = b.abs().max().item()
        ek, ep = (a - t).abs().mean().item(), (b - t).abs().mean().item()
        log(f"{what} B={x1.shape[0]} {few} steps, kernel vs eager path, "
            f"{name}: max_abs_err={err:.4g} max|ref|={ref:.4g} "
            f"rel={err / ref:.3e} (tol {tol:g}); mean_abs_err vs f32 eager: "
            f"kernel path {ek:.4e} eager bf16 path {ep:.4e} (kernel <= 1.5x "
            f"eager)")
        check(err <= tol * ref, f"{what} kernel vs eager path {name}")
        check(ek <= 1.5 * ep, f"{what} kernel path rounds worse {name}")
    del outs
    torch.cuda.empty_cache()


# ------------------------------ the long-series path's kernels (#7, #8, #12)

def res_mod_ln_phase(gen):
    """Kernels #7 and #8 at the scaled train step's call and at the
    long-series call in bf16, against the twin and autograd over it; again
    in f32 at a small batch. Tolerances: bf16 1e-2 * max|ref| (one rounding
    flip after f32 sums in another order), f32 1e-4 (summation order)."""
    from t2ms_tpu_torch.ops.dit_block import (_launch_res_mod_ln,
                                              _launch_res_mod_ln_bwd,
                                              res_mod_ln_reference)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    out = {}
    for call, dt, B, N, D, tol in (
            ("scaled", torch.bfloat16, SC_TRAIN_B, SC_N, SC_D, 1e-2),
            ("long", torch.bfloat16, LS_TRAIN_B, LS_N, D_MODEL, 1e-2),
            ("f32", torch.float32, 4, SC_N, SC_D, 1e-4)):
        x, h, do, dy = (f(B, N, D).to(dt) for _ in range(4))
        gm3 = (0.3 * f(B, 3, D)).to(dt)
        fwd = lambda: _launch_res_mod_ln(x, h, gm3, 1e-6)
        bwd = lambda: _launch_res_mod_ln_bwd(x, h, gm3, do, dy, 1e-6)
        got_f, got_b = fwd(), bwd()
        ts = [t.detach().requires_grad_() for t in (x, h, gm3)]
        graph = res_mod_ln_reference(*ts)
        want_b = torch.autograd.grad(graph, ts, (do, dy), retain_graph=True)
        torch.cuda.synchronize()
        what = f"res_mod_ln {dt} B={B} N={N} D={D}"
        e_f = max(_check_err(f"{what} {n}", a, b.detach(), tol)
                  for n, a, b in zip(("out", "y"), got_f, graph))
        e_b = max(_check_err(f"{what} {n}", a, b, tol)
                  for n, a, b in zip(("dx", "dh", "dgm3"), got_b, want_b))
        check(all(t.dtype == dt for t in got_f + got_b),
              "res_mod_ln output dtypes")
        with torch.no_grad():
            ms_f = cuda_ms(fwd)
            plain_f = cuda_ms(lambda: res_mod_ln_reference(x, h, gm3))
            ms_b = cuda_ms(bwd)
        plain_b = cuda_ms(lambda: torch.autograd.grad(
            graph, ts, (do, dy), retain_graph=True))
        del graph, ts
        # f32 operations per element: the gated residual 2, the LayerNorm
        # statistics and normalisation about 6, the modulate 3; the
        # backward about twice that. Bytes: x, h in, out, y out (4 B*N*D
        # values); backward x, h, do, dy in, dx, dh out (6 B*N*D)
        n = x.numel()
        out[call] = {
            "fwd": _row(e_f, ms_f, plain_f, 11 * n,
                        _nbytes(x, h, gm3, *got_f), H100_F32_FLOPS),
            "bwd": _row(e_b, ms_b, plain_b, 24 * n,
                        _nbytes(x, h, gm3, do, dy, *got_b), H100_F32_FLOPS)}
        for k in ("fwd", "bwd"):
            r = out[call][k]
            log(f"res_mod_ln {dt} B={B} N={N} D={D} {k}: {r['ms']:.4f} ms, "
                f"twin {r['plain']:.4f} ms, bound {r['bound']:.4f} ms "
                f"({r['by']})")
        if dt == torch.bfloat16:   # #8 on 16-byte chunks (D % 8 == 0)
            ln_device_time(f"res_mod_ln {call} B={B} N={N} D={D}", (
                ("fwd", fwd, "res_mod_ln_fwd_kernel", ()),
                ("bwd", bwd, "res_mod_ln_bwd_vec_kernel",
                 ("res_mod_ln_bwd_kernel",))), out[call])
        del x, h, do, dy, gm3, got_f, got_b, want_b
        torch.cuda.empty_cache()
    return out


def ln_device_time(what, parts, rows):
    """Device time by kernel (torch.profiler, one call) of the LayerNorm
    kernels #5-#8: for each (key, fn, own kernel, kernels that must not
    run) of ``parts``, the own kernel's, ``dmod_reduce_kernel``'s (a
    backward's ordered sum over tiles) and the rest (the wrappers' casts);
    checked to run on the own kernel and none of the others. rows[key]
    gains "device" (the own kernel's ms)."""
    for k, fn, own, absent in parts:
        times = device_ms_all(fn)
        if not times:
            log(f"{what} {k} device time: not measured (no device time "
                f"recorded)")
            continue
        mine = sum(v for n, v in times.items() if _named(n, own))
        red = sum(v for n, v in times.items()
                  if _named(n, "dmod_reduce_kernel"))
        rest = sum(times.values()) - mine - red
        off = sorted(n for n in times for a in absent if _named(n, a))
        check(mine > 0 and not off, f"{what} {k} ran {sorted(times)}: want "
              f"{own} and none of {absent}")
        rows[k]["device"] = mine
        log(f"{what} {k} device time (torch.profiler, one call): {own} "
            f"{mine:.4f} ms ({rows[k]['bound'] / mine:.2%} of its bound "
            f"{rows[k]['bound']:.4f}), dmod_reduce_kernel {red:.4f} ms, the "
            f"wrapper's casts and the rest {rest:.4f} ms")


def two_pass_phase(gen):
    """Kernel #12 at the long-series train step's call against its twin,
    and #11's recompute recipe at a geometry where JAX takes the ungrouped
    single pass. Tolerances: bf16 3e-2 * max|ref| (rounding flips of p and
    ds feed sums over 4096 rows), f32 5e-4 (summation order)."""
    from t2ms_tpu_torch.ops.attention import (
        fused_heads_attention_bwd, fused_heads_attention_bwd_two_pass,
        fused_heads_bwd_route, fused_heads_bwd_two_pass_reference)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    H, D, N = HEADS, D_MODEL, LS_N
    check(fused_heads_bwd_route(N, D, H) == "two_pass",
          "the long-series backward is JAX's two-pass branch")
    out = {}
    for dt, B, tol in ((torch.bfloat16, LS_TRAIN_B, 3e-2),
                       (torch.float32, 1, 5e-4)):
        q, k, v, g = _qkv_slices(f, B, N, D, dt)
        run = lambda: fused_heads_attention_bwd_two_pass(q, k, v, g, H)
        twin = lambda: fused_heads_bwd_two_pass_reference(q, k, v, g, H)
        with torch.no_grad():
            got, want = run(), twin()
            torch.cuda.synchronize()
            truth = (None,) * 3
            if dt == torch.bfloat16:
                truth = fused_heads_bwd_two_pass_reference(
                    *(t.float() for t in (q, k, v, g)), H)
            what = f"two_pass {dt} B={B} N={N} HD={D} H={H}"
            err = max(_check_err(f"{what} {n}", a, b, tol, t, b)
                      for n, a, b, t in zip(("dq", "dk", "dv"), got, want,
                                            truth))
            del got, want, truth
            ms, plain = cuda_ms(run), cuda_ms(twin)
        lib = (sdpa_heads_ms(q, k, v, g, H)[1] if dt == torch.bfloat16
               else None)
        prod = 2 * B * H * N * N * (D // H)         # one N x N x d product
        peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_F32_FLOPS
        out[dt] = _row(err, ms, plain, 5 * prod, _nbytes(q, k, v, g, q, k, v),
                       peak, lib)
        r = out[dt]
        log(f"two_pass {dt} B={B}: {r['ms']:.4f} ms ({_rate(r)}), twin "
            f"{r['plain']:.4f} ms, bound {r['bound']:.4f} ms ({r['by']})"
            + (f", SDPA backward {lib:.4f} ms" if lib is not None else ""))
        if dt == torch.bfloat16:
            with torch.no_grad():
                log("two_pass bf16 device time by kernel (torch.profiler, "
                    "one call): " + fmt_split(device_ms_by_kernel(
                        run, HEADS_PARTS[1:])))
        del q, k, v, g
        torch.cuda.empty_cache()

    # #11 with the recompute recipe, where JAX runs its ungrouped kernels
    check(fused_heads_bwd_route(N_TOK, D, H) == "single",
          "the flagship geometry's backward is JAX's single pass")
    B = 64
    q, k, v, g = _qkv_slices(f, B, N_TOK, D, torch.bfloat16)
    with torch.no_grad():
        got = fused_heads_attention_bwd(q, k, v, g, H, pipelined=False)
        want = fused_heads_bwd_two_pass_reference(q, k, v, g, H)
        truth = fused_heads_bwd_two_pass_reference(
            *(t.float() for t in (q, k, v, g)), H)
        torch.cuda.synchronize()
        for n, a, b, t in zip(("dq", "dk", "dv"), got, want, truth):
            _check_err(f"fused_heads_attention_bwd recompute bf16 B={B} "
                       f"N={N_TOK} HD={D} H={H} {n}", a, b, 3e-2, t, b)
    return out


def long_dit(dtype, impl="auto"):
    from t2ms_tpu_torch.models.denoisers import DiT
    return DiT(latent_len=LS_LATENT, latent_dim=64, d_model=D_MODEL,
               depth=LS_DEPTH, num_heads=HEADS, mlp_ratio=HIDDEN / D_MODEL,
               compute_dtype=dtype, attention_impl=impl)


def build_long_models(seed: int):
    from t2ms_tpu_torch.models.vae import LAVAE
    torch.manual_seed(seed + 4)
    dit = long_dit(torch.bfloat16)
    vae = LAVAE(in_channels=1, latent_grid=LS_LATENT)
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
    return dit, vae.eval()


def long_offline_phase(dit, vae, gen):
    from t2ms_tpu_torch.models.denoisers import dit_fast
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import FUSED_HEADS_KERNEL
    from t2ms_tpu_torch.ops.dit_block import MOD_LN_KERNEL, RES_MOD_LN_KERNEL
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    n_par = sum(p.numel() for p in dit.parameters())
    x1 = torch.randn(LS_B, LS_LEN, generator=gen, device="cuda")
    emb = torch.randn(LS_B, D_MODEL, generator=gen, device="cuda")
    per_fwd = {MOD_LN_KERNEL: 1, RES_MOD_LN_KERNEL: 2 * LS_DEPTH - 1,
               FUSED_HEADS_KERNEL: LS_DEPTH}

    # a few steps at B=2 (the eager paths hold (2B, 4, N, N) scores): the
    # kernel path against the eager opt-out paths on the same noise
    x_t0 = torch.randn(2, 64, LS_LATENT, generator=gen, device="cuda")
    sampler_vs_eager("long offline", dit, long_dit, vae, x1[:2], emb[:2],
                     x_t0, LS_LEN, {n: c * 4 for n, c in per_fwd.items()})

    sampler = make_cfg_sampler(dit, vae, total_step=LS_STEPS, cfg_scale=CFG,
                               out_length=LS_LEN)
    gen_noise = torch.Generator(device="cuda")
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(x1, emb, generator=gen_noise.manual_seed(10))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    series = out.series
    check(tuple(series.shape) == (LS_B, LS_LEN), "long series shape")
    check(bool(torch.isfinite(series).all()), "long series finite")
    want = {n: c * LS_STEPS for n, c in per_fwd.items()}
    check(launches == want, f"long sample() launches {launches}, want "
          f"{want} and no stack or split launch")
    log(f"long offline: DiT {n_par} params (d {D_MODEL}, depth {LS_DEPTH}, "
        f"{HEADS} heads, {LS_N} tokens) B={LS_B} euler/{LS_STEPS} cfg {CFG} "
        f"len {LS_LEN}: {dt:.3f} s, {LS_B / dt:.4f} series/s, peak memory "
        f"{peak_gb:.3f} GB, launches {launches}, series mean "
        f"{series.mean().item():.4g} std {series.std().item():.4g}")
    x2 = torch.randn(2 * LS_B, 64, LS_LATENT, generator=gen, device="cuda")
    t2 = torch.full((2 * LS_B,), 0.5, device="cuda")
    e2, m2 = torch.cat([emb, emb]), torch.ones(2 * LS_B, device="cuda")
    with torch.no_grad():
        log_device_time("long offline CFG forward (2B=32)",
                        lambda: dit_fast.flax_path_forward(dit, x2, t2, e2,
                                                           m2))
    return launches


def long_train_phase(dit, vae, gen):
    """The long-series train step (scripts/bench_long_series.py:68-117) on
    a copy of the DiT, through the flax path's kernels and the two-pass
    attention backward."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import (FUSED_HEADS_KERNEL,
                                              FUSED_HEADS_TWO_PASS_KERNEL)
    from t2ms_tpu_torch.ops.dit_block import (MOD_LN_BWD_KERNEL,
                                              MOD_LN_KERNEL,
                                              RES_MOD_LN_BWD_KERNEL,
                                              RES_MOD_LN_KERNEL)
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    model = copy.deepcopy(dit)
    # optax.adamw(1e-4): constant rate, weight decay 1e-4
    opt = ScheduledAdamW(model.parameters(), lambda _: 1e-4)
    step = make_denoiser_train_step(model, vae, opt, total_step=STEPS)
    x = torch.randn(LS_TRAIN_B, LS_LEN, generator=gen, device="cuda")
    emb = torch.randn(LS_TRAIN_B, D_MODEL, generator=gen, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    losses = [step(x, emb, generator=g) for _ in range(TRAIN_WARMUP)]
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step(x, emb, generator=g) for _ in range(LS_TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lv = torch.stack(losses).tolist()
    check(all(np.isfinite(lv)), f"long train losses finite {lv}")
    edges = 2 * LS_DEPTH - 1
    want = {MOD_LN_KERNEL: 1, RES_MOD_LN_KERNEL: edges,
            FUSED_HEADS_KERNEL: LS_DEPTH, MOD_LN_BWD_KERNEL: 1,
            RES_MOD_LN_BWD_KERNEL: edges,
            FUSED_HEADS_TWO_PASS_KERNEL: LS_DEPTH}
    check(launches == {n: c * LS_TRAIN_STEPS for n, c in want.items()},
          f"long train launches {launches} in {LS_TRAIN_STEPS} steps, want "
          f"{want} per step and no single-pass, stack, block or split "
          f"launch")
    rate, rates = step_rate(lambda: step(x, emb, generator=g),
                            LS_TRAIN_STEPS, dt)
    log(f"long train: DiT (d {D_MODEL}, depth {LS_DEPTH}, {HEADS} heads, "
        f"{LS_N} tokens) B={LS_TRAIN_B} len {LS_LEN} bf16, VAE encode in "
        f"the step, {LS_TRAIN_STEPS} steps in {dt:.3f} s: "
        f"{fmt_rate(rate, rates, LS_TRAIN_STEPS)}, peak memory "
        f"{peak_gb:.3f} GB, "
        f"launches {launches} ({want} per step), losses "
        f"{[round(v, 5) for v in lv]}")
    log_device_time("long train step", lambda: step(x, emb, generator=g))
    del model, opt, step
    torch.cuda.empty_cache()

    # the kernel path against the eager opt-out paths on the same draws,
    # at B=2: the eager paths hold (B, 4, N, N) scores per layer
    Bs = 2
    train_paths_vs_eager("long train", long_dit, dit, vae, x[:Bs], emb[:Bs],
                         lambda: dict(
                             u=torch.rand(Bs, generator=g, device="cuda"),
                             x_0=torch.randn(Bs, 64, LS_LATENT, generator=g,
                                             device="cuda"),
                             coin=torch.tensor(0.9, device="cuda")))
    return launches


# ---------------------- the lse family (#10, #13, #14) and its train paths

def _lean_case(f, B, N, HD, H, dt, two_pass):
    """#10, then #13 or #14 from its o and lse, on the column slices of one
    qkv tensor, against the twins on the same inputs: o bit for bit #9's,
    lse absolute, the gradients as the other attention backwards; in bf16
    also the mean error against the f32 twins. Returns (forward error,
    backward error, tensors)."""
    from t2ms_tpu_torch.ops.attention import (
        fused_heads_attention, fused_heads_attention_bwd_lean,
        fused_heads_attention_bwd_lean_two_pass,
        fused_heads_attention_with_stats, fused_heads_bwd_lean_reference,
        fused_heads_stats_reference)
    bwd = (fused_heads_attention_bwd_lean_two_pass if two_pass
           else fused_heads_attention_bwd_lean)
    bf16 = dt == torch.bfloat16
    tol_f, tol_lse, tol_b = (1e-2, 1e-2, 3e-2) if bf16 else (2e-4, 1e-4, 5e-4)
    q, k, v, g = _qkv_slices(f, B, N, HD, dt)
    what = (f"{'lean_two_pass' if two_pass else 'lean'} {dt} B={B} N={N} "
            f"HD={HD} H={H}")
    with torch.no_grad():
        o, lse = fused_heads_attention_with_stats(q, k, v, H)
        plain = fused_heads_attention(q, k, v, H)
        grads = bwd(q, k, v, g, o, lse, H)
        want_o, want_lse = fused_heads_stats_reference(q, k, v, H)
        want = fused_heads_bwd_lean_reference(q, k, v, g, o, lse, H)
        torch.cuda.synchronize()
        check(torch.equal(o, plain), f"{what}: #10's o is not #9's")
        t_o = t_g = (None,) * 3
        if bf16:
            f32 = [t.float() for t in (q, k, v, g)]
            t_o, t_lse = fused_heads_stats_reference(*f32[:3], H)
            t_g = fused_heads_bwd_lean_reference(*f32, t_o, t_lse, H)
            del f32, t_lse
        e_lse = (lse - want_lse).abs().max().item()
        log(f"{what} o bit-equal to #9's; lse max_abs_err={e_lse:.6g} "
            f"(tol {tol_lse:g} absolute)")
        check(bool(torch.isfinite(lse).all()), f"{what} lse finite")
        check(e_lse <= tol_lse, f"{what} lse {e_lse} > {tol_lse}")
        e_f = _check_err(f"{what} out", o, want_o, tol_f,
                         t_o if bf16 else None, want_o)
        e_b = max(_check_err(f"{what} {n}", a, b, tol_b, t, b)
                  for n, a, b, t in zip(("dq", "dk", "dv"), grads, want,
                                        t_g))
    del t_o, t_g, grads, want, want_o, want_lse, plain
    return e_f, e_b, (q, k, v, g, o, lse)


def lean_kernel_phase(gen):
    """Kernels #10, #13 and #14 against their twins at JAX's smoke
    geometries (scripts/kernel_smoke.py:220-265: stats_fwd_1024_hd512 and
    lean_bwd_g4_bq512 at B=2, N=1024, H*D=512, 8 heads; lean_two_pass_4096
    at B=2, N=4096, H*D=128, 4 heads) in bf16 and f32, then at their
    paths' calls (#10 and #13 at the scaled train step's B=64, N=1024; #14
    at the long-series step's B=8, N=4096) in bf16: checked again, timed,
    with the twins' times, the bounds and torch SDPA as the yardstick.
    Tolerances: o bf16 1e-2 * max|ref|, f32 2e-4; lse absolute, bf16 1e-2
    (a rounding flip of one e moves lse by at most 2^-8 / r, r >= 1), f32
    1e-4; gradients bf16 3e-2 * max|ref|, f32 5e-4; corr >= 0.999; bf16
    mean error against the f32 twins at most 1.5x the bf16 twins'."""
    from t2ms_tpu_torch.ops.attention import (
        fused_heads_attention_bwd_lean,
        fused_heads_attention_bwd_lean_two_pass,
        fused_heads_attention_with_stats, fused_heads_bwd_lean_reference,
        fused_heads_lean_route, fused_heads_stats_reference)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    check(fused_heads_lean_route(SC_N, SC_D, SC_HEADS) == "lean",
          "the scaled geometry's lean route is JAX's single pass (#13)")
    check(fused_heads_lean_route(LS_N, D_MODEL, HEADS) == "lean_two_pass",
          "the long-series geometry's lean route is JAX's two-pass (#14)")
    # the smoke geometries
    for dt, b_long in ((torch.bfloat16, 2), (torch.float32, 1)):
        _lean_case(f, 2, SC_N, SC_D, SC_HEADS, dt, False)
        _lean_case(f, b_long, LS_N, D_MODEL, HEADS, dt, True)
        torch.cuda.empty_cache()
    # the paths' calls, bf16
    out = {}
    for key, B, N, HD, H, two_pass in (
            ("scaled", SC_TRAIN_B, SC_N, SC_D, SC_HEADS, False),
            ("long", LS_TRAIN_B, LS_N, D_MODEL, HEADS, True)):
        e_f, e_b, (q, k, v, g, o, lse) = _lean_case(
            f, B, N, HD, H, torch.bfloat16, two_pass)
        bwd = (fused_heads_attention_bwd_lean_two_pass if two_pass
               else fused_heads_attention_bwd_lean)
        with torch.no_grad():
            ms_f = cuda_ms(lambda: fused_heads_attention_with_stats(q, k, v,
                                                                    H))
            ms_b = cuda_ms(lambda: bwd(q, k, v, g, o, lse, H))
            plain_f = cuda_ms(lambda: fused_heads_stats_reference(q, k, v,
                                                                  H))
            plain_b = cuda_ms(lambda: fused_heads_bwd_lean_reference(
                q, k, v, g, o, lse, H))
        lib_f, lib_b = sdpa_heads_ms(q, k, v, g, H)
        prod = 2 * B * H * N * N * (HD // H)        # one N x N x d product
        out[key] = {
            "fwd": _row(e_f, ms_f, plain_f, 2 * prod,
                        _nbytes(q, k, v, o, lse), H100_BF16_FLOPS, lib_f),
            "bwd": _row(e_b, ms_b, plain_b, 5 * prod,
                        _nbytes(q, k, v, g, o, lse, q, k, v),
                        H100_BF16_FLOPS, lib_b)}
        for n, r in out[key].items():
            log(f"lean {key} B={B} N={N} HD={HD} H={H} {n}: {r['ms']:.4f} "
                f"ms ({_rate(r)}), twin {r['plain']:.4f} ms, bound "
                f"{r['bound']:.4f} ms ({r['by']}), SDPA {r['library']:.4f} "
                f"ms")
        with torch.no_grad():
            log(f"lean {key} bf16 device time by kernel (torch.profiler, "
                "forward then backward): " + fmt_split(device_ms_by_kernel(
                    lambda: (fused_heads_attention_with_stats(q, k, v, H),
                             bwd(q, k, v, g, o, lse, H)), HEADS_PARTS)))
        del q, k, v, g, o, lse
        torch.cuda.empty_cache()
    return out


def _lean_switch(value):
    """Set T2MS_ATTN_LEAN_BWD to ``value`` (None: unset); returns the
    previous value for ``_lean_switch`` to restore."""
    old = os.environ.get("T2MS_ATTN_LEAN_BWD")
    if value is None:
        os.environ.pop("T2MS_ATTN_LEAN_BWD", None)
    else:
        os.environ["T2MS_ATTN_LEAN_BWD"] = value
    return old


def lean_train_phase(what, make_dit, dit, vae, gen, B, x_len, emb_dim,
                     n_steps, precoded, bwd_kernel, n_check, make_draws,
                     seed):
    """A flax-path train step with ``T2MS_ATTN_LEAN_BWD=1`` on a copy of
    ``dit`` (AdamW at a constant 1e-4): 2 warm-up and ``n_steps`` timed
    steps with the launches per step checked (#5 x1, #7 x(2L-1), #10 xL,
    #6 x1, #8 x(2L-1), ``bwd_kernel`` xL; nothing else); steps/s, peak
    memory, device time by part; the losses within 1e-2 of the same steps
    with the switch unset from the same init and draws; and at B =
    ``n_check``, on ``make_draws``, the lean kernel path's loss and
    gradients against the eager bf16 and f32 paths."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import FUSED_HEADS_STATS_KERNEL
    from t2ms_tpu_torch.ops.dit_block import (MOD_LN_BWD_KERNEL,
                                              MOD_LN_KERNEL,
                                              RES_MOD_LN_BWD_KERNEL,
                                              RES_MOD_LN_KERNEL)
    from t2ms_tpu_torch.training import (ScheduledAdamW, encode_with_vae,
                                         make_denoiser_train_step)
    x = torch.randn(B, x_len, generator=gen, device="cuda")
    emb = torch.randn(B, emb_dim, generator=gen, device="cuda")
    if precoded:
        x = encode_with_vae(vae, x)[0]     # once, outside the step
    depth = len(dit.layers)

    def run(lean, timed):
        """2 + n_steps steps from dit's init on fixed draws: their losses,
        the main path's launches, steps/s (``step_rate``) and peak
        memory; with ``timed``, the device time of one more step."""
        old = _lean_switch("1" if lean else None)
        try:
            model = copy.deepcopy(dit)
            step = make_denoiser_train_step(
                model, vae, ScheduledAdamW(model.parameters(),
                                           lambda _: 1e-4),
                total_step=STEPS, precoded=precoded)
            g = torch.Generator(device="cuda").manual_seed(seed)
            losses = [step(x, emb, generator=g) for _ in range(TRAIN_WARMUP)]
            # the main path: counts set to 0 just before it, read just after
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            losses += [step(x, emb, generator=g) for _ in range(n_steps)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            res = (torch.stack(losses).tolist(), dict(_build.launch_counts),
                   torch.cuda.max_memory_allocated() / 1e9)
            res += (step_rate(lambda: step(x, emb, generator=g), n_steps,
                              dt),)
            if timed:
                log_device_time(f"{what} step",
                                lambda: step(x, emb, generator=g))
            del model, step
            torch.cuda.empty_cache()
            return res
        finally:
            _lean_switch(old)

    lv, launches, peak_gb, (rate, rates) = run(True, True)
    check(all(np.isfinite(lv)), f"{what} losses finite {lv}")
    edges = 2 * depth - 1
    want = {MOD_LN_KERNEL: 1, RES_MOD_LN_KERNEL: edges,
            FUSED_HEADS_STATS_KERNEL: depth, MOD_LN_BWD_KERNEL: 1,
            RES_MOD_LN_BWD_KERNEL: edges, bwd_kernel: depth}
    check(launches == {n: c * n_steps for n, c in want.items()},
          f"{what} launches {launches} in {n_steps} steps, want {want} per "
          f"step and no #9, #11, #12, stack, block or split launch")
    log(f"{what}: B={B} bf16, T2MS_ATTN_LEAN_BWD=1: "
        f"{fmt_rate(rate, rates, n_steps)}, peak memory "
        f"{peak_gb:.3f} GB, launches {launches} ({want} per step), losses "
        f"{[round(v, 5) for v in lv]}")
    # the same steps with the switch unset (the default route's kernels),
    # from the same init and draws: the recipes round elsewhere, and the
    # two runs must move together (1e-2 of each loss)
    lu, launches_u, _, (rate_u, rates_u) = run(False, False)
    worst = max(abs(a - b) / abs(b) for a, b in zip(lv, lu))
    log(f"{what}, switch unset, same init and draws: "
        f"{fmt_rate(rate_u, rates_u, n_steps)}, launches {launches_u}, losses "
        f"{[round(v, 5) for v in lu]}; the lean path within {worst:.3e} of "
        f"each (tol 1e-2)")
    check(FUSED_HEADS_STATS_KERNEL not in launches_u,
          f"{what}: the unset switch still ran #10")
    check(worst <= 1e-2, f"{what} losses {lv} vs switch unset {lu}")
    old = _lean_switch("1")
    try:
        train_paths_vs_eager(what, make_dit, dit, vae, x[:n_check],
                             emb[:n_check], make_draws, precoded=precoded)
    finally:
        _lean_switch(old)
    return launches


def lean_scaled_train_phase(sc_dit, sc_vae, gen):
    """The scaled train step (as ``scaled_train_phase``) with the lean
    switch on: #10 forward and #13 backward per layer."""
    from t2ms_tpu_torch.ops.attention import FUSED_HEADS_LEAN_KERNEL
    g = torch.Generator(device="cuda").manual_seed(14)
    Bs = 8
    return lean_train_phase(
        "lean scaled train", scaled_dit, sc_dit, sc_vae, gen, SC_TRAIN_B,
        OUT_LEN, SC_D, SC_TRAIN_STEPS, True, FUSED_HEADS_LEAN_KERNEL, Bs,
        lambda: dict(u=torch.rand(Bs, generator=g, device="cuda"),
                     x_0=torch.randn(Bs, 64, 64, generator=g, device="cuda"),
                     coin=torch.tensor(0.9, device="cuda")), seed=12)


def lean_long_train_phase(ls_dit, ls_vae, gen):
    """The long-series train step (as ``long_train_phase``, the VAE encode
    in the step) with the lean switch on: #10 forward and #14 backward per
    layer."""
    from t2ms_tpu_torch.ops.attention import FUSED_HEADS_LEAN_TWO_PASS_KERNEL
    g = torch.Generator(device="cuda").manual_seed(15)
    Bs = 2
    return lean_train_phase(
        "lean long train", long_dit, ls_dit, ls_vae, gen, LS_TRAIN_B, LS_LEN,
        D_MODEL, LS_TRAIN_STEPS, False, FUSED_HEADS_LEAN_TWO_PASS_KERNEL, Bs,
        lambda: dict(u=torch.rand(Bs, generator=g, device="cuda"),
                     x_0=torch.randn(Bs, 64, LS_LATENT, generator=g,
                                     device="cuda"),
                     coin=torch.tensor(0.9, device="cuda")), seed=13)


# ----------------- the head-split kernels (#15, #16, #17) and their paths

HEAD_SPLIT_PARTS = ("split_heads_online_kernel",
                    "split_heads_resident_kernel",
                    "split_heads_exact_kernel", "split_heads_f32_kernel")


def _split_views(f, B, N, dt, heads=HEADS, dh=D_MODEL // HEADS):
    """q, k, v as the head-split (B, H, N, d) views of one qkv tensor, as
    the DiT hands them to the kernels."""
    qkv = f(B, N, 3 * heads * dh).to(dt)
    return qkv.view(B, N, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)


def split_heads_phase(gen):
    """Kernels #15, #16 and #17 against their twins at the smoke
    geometries (scripts/kernel_smoke.py flash_4096, packed_480, vmem_480)
    and at the calls of the 8192-token DiT's sampler (#15) and of the
    packed flagship sampler (#17), in bf16, and in f32 at a small batch.
    Tolerances: bf16 1e-2 * max|ref| (one output ulp; the exact kernels
    also round p to bf16 after f32 sums in another order), f32 2e-4
    (summation order). The bound is the larger of 4*B*H*N^2*d operations
    over the peak and the bytes of q, k, v and o over the memory rate; the
    library yardstick is torch SDPA forward over the same views. Each bf16
    row also logs its device time by torch.profiler beside the CUDA-event
    time (which holds the wrapper's host path before the launch) and the
    exponent unit's floor: one exponential a score for the online softmax,
    two for the exact one, at H100_EX2_RATE."""
    import torch.nn.functional as F
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import (
        VMEM_KERNEL, flash_attention, flash_reference, packed_attention,
        packed_reference, vmem_attention, vmem_reference)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    dh = D_MODEL // HEADS
    calls = (("flash_4096", flash_attention, flash_reference, 2, 4096, 1),
             ("flash_8192_serve", flash_attention, flash_reference,
              2 * XL_B, XL_N, 0),
             ("packed_480", packed_attention, packed_reference, 8, N_TOK, 2),
             ("packed_480_serve", packed_attention, packed_reference,
              2 * PK_B, N_TOK, 0),
             ("vmem_480", vmem_attention, vmem_reference, 8, N_TOK, 2))
    out = {}
    for key, fn, twin, B, N, b32 in calls:
        runs = [(torch.bfloat16, B, 1e-2)] + (
            [(torch.float32, b32, 2e-4)] if b32 else [])
        for dt, b, tol in runs:
            q, k, v = _split_views(f, b, N, dt)
            what = f"{key} {fn.__name__} {dt} B={b} H={HEADS} N={N} d={dh}"
            with torch.no_grad():
                got, want = fn(q, k, v), twin(q, k, v)
                truth = (twin(*(t.float() for t in (q, k, v)))
                         if dt == torch.bfloat16 else None)
                torch.cuda.synchronize()
                err = _check_err(what, got, want, tol, truth, want)
                check(got.dtype == dt and got.shape == q.shape,
                      f"{what} output")
                del got, want, truth
                torch.cuda.empty_cache()
                ms = cuda_ms(lambda: fn(q, k, v))
                split = (device_ms_by_kernel(lambda: fn(q, k, v),
                                             HEAD_SPLIT_PARTS)
                         if dt == torch.bfloat16 else {})
                plain = cuda_ms(lambda: twin(q, k, v))
                lib = (cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v)) if dt == torch.bfloat16 else None)
            peak = H100_BF16_FLOPS if dt == torch.bfloat16 else H100_F32_FLOPS
            r = _row(err, ms, plain, 4 * b * HEADS * N * N * dh,
                     _nbytes(q, k, v, q), peak, lib)
            out[(key, dt)] = r
            # the exact softmax takes two exponentials of each score
            exps = (1 if fn is flash_attention else 2) * b * HEADS * N * N
            dev = ""
            if dt == torch.bfloat16:
                r["device_ms"] = split.get("(all device time)")
                dev = (", device " + (f"{r['device_ms']:.4f} ms "
                                      "(torch.profiler)" if split
                                      else "not measured"))
            log(f"{what}: {r['ms']:.4f} ms (CUDA events){dev}, twin "
                f"{r['plain']:.4f} ms, bound {r['bound']:.4f} ms "
                f"({r['by']}), exponent-unit floor "
                f"{exps / H100_EX2_RATE * 1e3:.4f} ms ({exps:.3g} ex2 at "
                f"{H100_EX2_RATE:.3g}/s)"
                + (f", SDPA {lib:.4f} ms" if lib is not None else ""))
            del q, k, v
            torch.cuda.empty_cache()
    # path (c): vmem_attention has no attention() impl, in JAX and here;
    # its path is the direct call, counted alone
    q, k, v = _split_views(f, 8, N_TOK, torch.bfloat16)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with torch.no_grad():
        vmem_attention(q, k, v)
    torch.cuda.synchronize()
    out["vmem_launches"] = dict(_build.launch_counts)
    check(out["vmem_launches"] == {VMEM_KERNEL: 1},
          f"vmem direct call launches {out['vmem_launches']}")
    return out


def xl_dit(dtype, impl="auto"):
    from t2ms_tpu_torch.models.denoisers import DiT
    return DiT(latent_len=XL_LATENT, latent_dim=64, d_model=D_MODEL,
               depth=LS_DEPTH, num_heads=HEADS, mlp_ratio=HIDDEN / D_MODEL,
               compute_dtype=dtype, attention_impl=impl)


def build_xl_models(seed: int):
    from t2ms_tpu_torch.models.vae import LAVAE
    torch.manual_seed(seed + 6)
    dit = xl_dit(torch.bfloat16)
    vae = LAVAE(in_channels=1, latent_grid=XL_LATENT)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
    return dit, vae.eval()


def xl_offline_phase(dit, vae, gen):
    """The 8192-token DiT's CFG sampler on the flax path, its attention
    #15 (JAX's route on a TPU: fused heads refuse 8192 tokens)."""
    from t2ms_tpu_torch.models.denoisers import dit_fast
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import FLASH_KERNEL
    from t2ms_tpu_torch.ops.dit_block import MOD_LN_KERNEL, RES_MOD_LN_KERNEL
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    check(dit_fast.flax_attention_route(dit) == "flash",
          "the 8192-token DiT's attention route is flash")
    x1 = torch.randn(XL_B, XL_LEN, generator=gen, device="cuda")
    emb = torch.randn(XL_B, D_MODEL, generator=gen, device="cuda")
    per_fwd = {MOD_LN_KERNEL: 1, RES_MOD_LN_KERNEL: 2 * LS_DEPTH - 1,
               FLASH_KERNEL: LS_DEPTH}
    # B=1: the eager paths hold (2B, 4, N, N) scores
    x_t0 = torch.randn(1, 64, XL_LATENT, generator=gen, device="cuda")
    sampler_vs_eager("xl offline", dit, xl_dit, vae, x1[:1], emb[:1], x_t0,
                     XL_LEN, {n: c * 4 for n, c in per_fwd.items()})

    sampler = make_cfg_sampler(dit, vae, total_step=XL_STEPS, cfg_scale=CFG,
                               out_length=XL_LEN)
    gen_noise = torch.Generator(device="cuda")
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(x1, emb, generator=gen_noise.manual_seed(11))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    series = out.series
    check(tuple(series.shape) == (XL_B, XL_LEN), "xl series shape")
    check(bool(torch.isfinite(series).all()), "xl series finite")
    want = {n: c * XL_STEPS for n, c in per_fwd.items()}
    check(launches == want, f"xl sample() launches {launches}, want {want} "
          f"and no fused-heads, stack or split launch")
    log(f"xl offline: DiT (d {D_MODEL}, depth {LS_DEPTH}, {HEADS} heads, "
        f"{XL_N} tokens) B={XL_B} euler/{XL_STEPS} cfg {CFG} len {XL_LEN}: "
        f"{dt:.3f} s, {XL_B / dt:.4f} series/s, peak memory {peak_gb:.3f} "
        f"GB, launches {launches}, series mean {series.mean().item():.4g} "
        f"std {series.std().item():.4g}")
    x2 = torch.randn(2 * XL_B, 64, XL_LATENT, generator=gen, device="cuda")
    t2 = torch.full((2 * XL_B,), 0.5, device="cuda")
    e2, m2 = torch.cat([emb, emb]), torch.ones(2 * XL_B, device="cuda")
    with torch.no_grad():
        log_device_time(f"xl offline CFG forward (2B={2 * XL_B})",
                        lambda: dit_fast.flax_path_forward(dit, x2, t2, e2,
                                                           m2),
                        MOD_LN_PARTS + HEAD_SPLIT_PARTS)
    return launches


def xl_train_phase(dit, vae, gen):
    """The 8192-token DiT's train step (scripts/bench_long_series.py
    :68-117 at latent 512) on a copy of the DiT: #15 forward, its
    backward the einsum recompute."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import FLASH_KERNEL
    from t2ms_tpu_torch.ops.dit_block import (MOD_LN_BWD_KERNEL,
                                              MOD_LN_KERNEL,
                                              RES_MOD_LN_BWD_KERNEL,
                                              RES_MOD_LN_KERNEL)
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    model = copy.deepcopy(dit)
    # optax.adamw(1e-4): constant rate, weight decay 1e-4
    opt = ScheduledAdamW(model.parameters(), lambda _: 1e-4)
    step = make_denoiser_train_step(model, vae, opt, total_step=STEPS)
    x = torch.randn(XL_TRAIN_B, XL_LEN, generator=gen, device="cuda")
    emb = torch.randn(XL_TRAIN_B, D_MODEL, generator=gen, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(17)
    losses = [step(x, emb, generator=g) for _ in range(TRAIN_WARMUP)]
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step(x, emb, generator=g) for _ in range(LS_TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lv = torch.stack(losses).tolist()
    check(all(np.isfinite(lv)), f"xl train losses finite {lv}")
    edges = 2 * LS_DEPTH - 1
    want = {MOD_LN_KERNEL: 1, RES_MOD_LN_KERNEL: edges,
            FLASH_KERNEL: LS_DEPTH, MOD_LN_BWD_KERNEL: 1,
            RES_MOD_LN_BWD_KERNEL: edges}
    check(launches == {n: c * LS_TRAIN_STEPS for n, c in want.items()},
          f"xl train launches {launches} in {LS_TRAIN_STEPS} steps, want "
          f"{want} per step and no fused-heads (#9, #11, #12), stack, block "
          f"or split launch")
    log(f"xl train: DiT (d {D_MODEL}, depth {LS_DEPTH}, {HEADS} heads, "
        f"{XL_N} tokens) B={XL_TRAIN_B} len {XL_LEN} bf16, VAE encode in "
        f"the step, {LS_TRAIN_STEPS} steps in {dt:.3f} s: "
        f"{LS_TRAIN_STEPS / dt:.4f} steps/s, peak memory {peak_gb:.3f} GB, "
        f"launches {launches} ({want} per step), losses "
        f"{[round(v, 5) for v in lv]}")
    log_device_time("xl train step", lambda: step(x, emb, generator=g),
                    MOD_LN_PARTS + HEAD_SPLIT_PARTS)
    del model, opt, step
    torch.cuda.empty_cache()

    # the kernel path against the eager opt-out paths on the same draws,
    # at B=1: the eager paths hold (B, 4, N, N) scores per layer
    train_paths_vs_eager("xl train", xl_dit, dit, vae, x[:1], emb[:1],
                         lambda: dict(
                             u=torch.rand(1, generator=g, device="cuda"),
                             x_0=torch.randn(1, 64, XL_LATENT, generator=g,
                                             device="cuda"),
                             coin=torch.tensor(0.9, device="cuda")))
    return launches


def flagship_dit(dtype, impl="auto"):
    from t2ms_tpu_torch.models.denoisers import DiT
    return DiT(latent_len=30, latent_dim=64, d_model=D_MODEL, depth=DEPTH,
               num_heads=HEADS, mlp_ratio=HIDDEN / D_MODEL,
               compute_dtype=dtype, attention_impl=impl)


def packed_offline_phase(dit, vae, gen):
    """The flagship sampler with ``attention_impl='packed'``
    (scripts/bench_attention_impls.py:39-52: B=256, cfg 7, length 96,
    bf16): the eager DiT, its attention #17 at 2B=512, 4 heads, N=480."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import PACKED_KERNEL
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    model = flagship_dit(torch.bfloat16, "packed")
    model.load_state_dict(dit.state_dict())
    x1 = torch.randn(PK_B, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(PK_B, D_MODEL, generator=gen, device="cuda")
    x_t0 = torch.randn(PK_B, 64, 30, generator=gen, device="cuda")
    sampler_vs_eager("packed offline", model, flagship_dit, vae, x1, emb,
                     x_t0, OUT_LEN, {PACKED_KERNEL: 4 * DEPTH})
    sampler = make_cfg_sampler(model, vae, total_step=PK_STEPS,
                               cfg_scale=CFG, out_length=OUT_LEN)
    gen_noise = torch.Generator(device="cuda")
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(x1, emb, generator=gen_noise.manual_seed(13))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    series = out.series
    check(tuple(series.shape) == (PK_B, OUT_LEN), "packed series shape")
    check(bool(torch.isfinite(series).all()), "packed series finite")
    want = {PACKED_KERNEL: PK_STEPS * DEPTH}
    check(launches == want, f"packed sample() launches {launches}, want "
          f"{want} and no stack launch")
    log(f"packed offline: flagship DiT, attention_impl='packed', B={PK_B} "
        f"euler/{PK_STEPS} cfg {CFG} len {OUT_LEN}: {dt:.3f} s, "
        f"{PK_B / dt:.2f} series/s, launches {launches}, series mean "
        f"{series.mean().item():.4g} std {series.std().item():.4g}")
    return launches


def explicit_impl_phase(dit, vae, gen):
    """The eager DiT under each explicit ``attention_impl`` (C2) at the
    flagship geometry: one train step each (B=64), launching the kernel
    its impl names and nothing else."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import (FLASH_KERNEL,
                                              FUSED_HEADS_BWD_KERNEL,
                                              FUSED_HEADS_KERNEL,
                                              PACKED_KERNEL)
    from t2ms_tpu_torch.training import make_denoiser_train_step
    B = 64
    x = torch.randn(B, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(B, D_MODEL, generator=gen, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(19)
    for impl, want in (("flash", {FLASH_KERNEL: DEPTH}),
                       ("packed", {PACKED_KERNEL: DEPTH}),
                       ("fused", {FUSED_HEADS_KERNEL: DEPTH,
                                  FUSED_HEADS_BWD_KERNEL: DEPTH})):
        model = flagship_dit(torch.bfloat16, impl)
        model.load_state_dict(dit.state_dict())
        step = make_denoiser_train_step(
            model, vae, torch.optim.SGD(model.parameters(), lr=1e-3),
            total_step=STEPS)
        _build.reset_launch_counts()
        loss = step(x, emb, generator=g).item()
        torch.cuda.synchronize()
        got = dict(_build.launch_counts)
        check(np.isfinite(loss), f"explicit impl {impl} loss {loss}")
        check(got == want, f"explicit impl {impl} launches {got}, want "
              f"{want}")
        log(f"explicit impl {impl}: one train step at B={B}, loss "
            f"{loss:.6f}, launches {got}")
        del model, step
        torch.cuda.empty_cache()


# ------------------------------- the DDPM backbone and the T2S entry points

DDIM_STEPS = 25                        # cli.infer --sample_steps 25 over T=100


def ddpm_offline_phase(dit, vae, gen, solver):
    """The flagship sampler with the DDPM backbone (B=256, cfg 7, length
    96, bf16) over the T=100 schedule: ancestral (``solver='euler'``, one
    stack launch a step, noise added at each) or DDIM over
    ``ddim_timesteps(100, 25)``. Checked first for 4 steps against the
    eager bf16 and f32 paths on the same injected noise."""
    from t2ms_tpu_torch.models.backbones.ddpm import ddim_timesteps
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    what = "ddpm offline" if solver == "euler" else "ddim offline"
    x1 = torch.randn(B_SERIES, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(B_SERIES, D_MODEL, generator=gen, device="cuda")
    x_t0 = torch.randn(B_SERIES, 64, 30, generator=gen, device="cuda")
    few = 4
    if solver == "euler":
        # a 4-step schedule, its step noise injected
        noise = torch.randn(few, B_SERIES, 64, 30, generator=gen,
                            device="cuda")
        sampler_vs_eager(what, dit, flagship_dit, vae, x1, emb, x_t0,
                         OUT_LEN, {STACK_KERNEL: few}, few,
                         step_noise=noise, backbone="ddpm")
        kw, n_steps = {}, STEPS
    else:
        # 4 DDIM steps over the T=100 schedule
        sampler_vs_eager(what, dit, flagship_dit, vae, x1, emb, x_t0,
                         OUT_LEN, {STACK_KERNEL: few}, few, backbone="ddpm",
                         solver="ddim", sample_steps=few, total_step=STEPS)
        kw = dict(solver="ddim", sample_steps=DDIM_STEPS)
        n_steps = len(ddim_timesteps(STEPS, DDIM_STEPS)[0])
    sampler = make_cfg_sampler(dit, vae, "ddpm", total_step=STEPS,
                               cfg_scale=CFG, out_length=OUT_LEN, **kw)
    gen_noise = torch.Generator(device="cuda")
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(x1, emb, generator=gen_noise.manual_seed(23))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    series = out.series
    check(tuple(series.shape) == (B_SERIES, OUT_LEN), f"{what} series shape")
    check(bool(torch.isfinite(series).all()), f"{what} series finite")
    check(launches == {STACK_KERNEL: n_steps},
          f"{what} sample() launches {launches}, want {n_steps} stack "
          f"launches")
    log(f"{what}: B={B_SERIES} {solver}/{n_steps} over T={STEPS}, cfg {CFG} "
        f"len {OUT_LEN}: {dt:.3f} s, {B_SERIES / dt:.2f} series/s, launches "
        f"{launches}, series mean {series.mean().item():.4g} std "
        f"{series.std().item():.4g}")
    return launches


def ddpm_train_phase(dit, vae, gen):
    """The flagship train step with the DDPM loss (B=1024, t = floor(u *
    100) as int32, target eps) on the block kernels: steps/s, peak memory,
    launches per step; then at B=128 the kernel path's loss and gradients
    against the eager bf16 and f32 paths on the same injected draws."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import BLOCK_BWD_KERNEL, BLOCK_KERNEL
    from t2ms_tpu_torch.training import (make_denoiser_train_step,
                                         onecycle_adamw)
    model = copy.deepcopy(dit)
    opt = onecycle_adamw(model.parameters(), TRAIN_WARMUP + TRAIN_STEPS,
                         max_lr=1e-4)
    step = make_denoiser_train_step(model, vae, opt, "ddpm",
                                    total_step=STEPS)
    x = torch.randn(B_TRAIN, OUT_LEN, generator=gen, device="cuda")
    emb = torch.randn(B_TRAIN, D_MODEL, generator=gen, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(29)
    losses = [step(x, emb, generator=g) for _ in range(TRAIN_WARMUP)]
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step(x, emb, generator=g) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lv = torch.stack(losses).tolist()
    check(all(np.isfinite(lv)), f"ddpm train losses finite {lv}")
    want = {BLOCK_KERNEL: DEPTH * TRAIN_STEPS,
            BLOCK_BWD_KERNEL: DEPTH * TRAIN_STEPS}
    check(launches == want, f"ddpm train launches {launches}, want {want}")
    log(f"ddpm train flagship: B={B_TRAIN} len {OUT_LEN} depth {DEPTH} bf16, "
        f"{TRAIN_STEPS} steps in {dt:.3f} s: {TRAIN_STEPS / dt:.4f} "
        f"steps/s, peak memory {peak_gb:.3f} GB, launches {launches}, "
        f"losses {[round(v, 5) for v in lv]}")
    del model, opt, step
    torch.cuda.empty_cache()
    Bs = 128
    train_paths_vs_eager(
        "ddpm train", lambda dt_, impl: flagship_dit(dt_, impl), dit, vae,
        x[:Bs], emb[:Bs],
        lambda: dict(u=torch.rand(Bs, generator=g, device="cuda"),
                     x_0=torch.randn(Bs, 64, 30, generator=g,
                                     device="cuda"),
                     coin=torch.tensor(0.9, device="cuda")),
        backbone="ddpm")
    return launches


def ddpm_server_phase(dit, vae, seed):
    """A ``ServingEngine`` with the DDPM backbone (the ancestral sampler
    over T=100, bucket 96, tiers 1/16/64): each row's noise from its own
    seed, x_t0 then its step noise; one seed alone against the same seed
    inside a full batch."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    from t2ms_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(seed + 3)
    embs = rng.standard_normal((72, D_MODEL)).astype(np.float32)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with ServingEngine(dit, vae, backbone="ddpm", total_step=STEPS,
                       out_lengths=(96,), batch_tiers=(1, 16, 64),
                       max_wait_ms=50.0, text_emb_dim=D_MODEL) as eng:
        res = eng.generate([(embs[i], 96, (3.0, 7.0)[i % 2], 3000 + i)
                            for i in range(8)])
        for r in res:
            check(r.series.shape == (96,) and np.isfinite(r.series).all(),
                  "ddpm engine result")
        futs = [eng.submit(embs[8 + i], 96, CFG, 4000 + i)
                for i in range(64)]
        full = [f.result(timeout=600) for f in futs]
        solo = eng.submit(embs[8 + 5], 96, CFG, 4005).result(timeout=600)
        stats = eng.stats()
    dt = time.perf_counter() - t0
    check(full[5].batch_size == 64 and solo.batch_size == 1,
          f"ddpm batch tiers {full[5].batch_size}, {solo.batch_size}")
    err = float(np.abs(full[5].series - solo.series).max())
    ref = float(np.abs(solo.series).max())
    tol = 2e-2   # other batch sizes may pick other library GEMM algorithms
    log(f"ddpm server: {stats['requests']} requests in {stats['batches']} "
        f"batches, {dt:.3f} s, p50 {stats['p50_latency_s']:.3f} s, padding "
        f"{stats['padding_fraction']:.3f}; seed alone vs in a full batch: "
        f"max_abs_err={err:.4g} max|ref|={ref:.4g} (tol {tol:g}); launches "
        f"{dict(_build.launch_counts)}")
    check(err <= tol * ref, "ddpm seed alone vs in a full batch")
    check(_build.launch_counts.get(STACK_KERNEL, 0) > 0,
          "ddpm server path launched the stack kernel")


# ETTh1 rows a length; the test CSV's 200 rows leave 2 for the test split
CLI_ROWS, CLI_TEST_ROWS = 2100, 200
# the evaluation's test CSV: the 0.99 split leaves 256 series (C-FID's
# 100-dimensional covariance is singular below 100)
CLI_EVAL_ROWS, CLI_EVAL_B = 25600, 256
TS2VEC_CHECK_ITERS = 20      # TS2Vec's card-vs-CPU fit
TS2VEC_TOL = 1e-4            # relative, losses and encode, TF32 off
DTW_TOL = 1e-9               # relative, f64 wavefront vs the numpy DP


class _Tee:
    """stdout that also keeps what it was given."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def cli_pretrain(seed):
    """``cli.pretrain_vae.main`` at its defaults (B=8, 2000 updates, lr
    1e-3, block_hidden 128, res_hidden 256, 2 residual layers, embedding
    64, mix-train over 24/48/96) on the phase's corpus: ``final_model``
    where ``cli.train`` looks (``t2s_pretrained_dir``), finite MAE/RMSE
    overall and per length, no kernel of the DiT launched; steps/s from
    ``train_log.jsonl``, wall time and peak memory."""
    from t2ms_tpu_torch.cli import pretrain_vae as cli_pretrain_vae
    from t2ms_tpu_torch.config import t2s_pretrained_dir
    from t2ms_tpu_torch.ops import _build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    cli_pretrain_vae.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not launches, f"cli pretrain launched DiT kernels: {launches}")
    d = t2s_pretrained_dir("ETTh1")
    for f in ("final_model/params.pt", "model_epoch_0/params.pt",
              "train_log.jsonl", "metrics.txt"):
        check(os.path.exists(os.path.join(d, f)), f"cli pretrain wrote {f}")
    with open(os.path.join(d, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(d, "metrics.txt")) as f:
        metrics = dict(line.strip().split(": ") for line in f)
    want = ["MAE", "RMSE"] + [f"{m}_{L}" for L in (24, 48, 96)
                              for m in ("MAE", "RMSE")]
    check(list(metrics) == want, f"cli pretrain metrics.txt {list(metrics)}")
    check(all(np.isfinite(float(v)) for v in metrics.values()),
          f"cli pretrain metrics finite: {metrics}")
    check(np.isfinite(rows[-1]["loss"]), "cli pretrain loss finite")
    log(f"cli pretrain: B=8, 2000 updates ({len(rows)} epochs) in "
        f"{wall:.3f} s wall (corpus load and reconstruction eval "
        f"included), {rows[-1]['steps_per_sec']:.4f} steps/s by "
        f"train_log.jsonl, peak memory {peak_gb:.3f} GB, last epoch loss "
        f"{rows[-1]['loss']:.6f}; "
        + ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items()))


def cli_phase(seed, smi):
    """The T2S entry points as a user runs them: a synthetic ETTh1 corpus
    (lengths 24/48/96, 2100 rows each: whole batches of 1024) written by
    ``write_t2s_csv`` into a temporary directory, then ``cli.train.main``
    (B=1024, 2 epochs, T=100, bf16, a checkpoint each epoch) and
    ``cli.infer.main`` on ``model_1`` (bf16, run_multi, one batch a run),
    for flowmatching/euler and for ddpm with DDIM over 25 steps: the
    artifacts the JAX CLIs write, their shapes, finite values, and by the
    launch counter that train ran the block kernels and infer the stack."""
    import tempfile

    from t2ms_tpu_torch.cli import infer as cli_infer
    from t2ms_tpu_torch.cli import train as cli_train
    from t2ms_tpu_torch.data.synthetic import write_t2s_csv
    from t2ms_tpu_torch.models.backbones.ddpm import ddim_timesteps
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import (BLOCK_BWD_KERNEL, BLOCK_KERNEL,
                                              STACK_KERNEL)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="t2ms_cli_") as work:
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            for L in (24, 48, 96):
                write_t2s_csv(os.path.join(
                    "Data", "TSFragment-600K",
                    f"embedding_cleaned_ETTh1_{L}.csv"), n=CLI_ROWS, T=L,
                    seed=seed + L)
            write_t2s_csv(os.path.join("Data", "our",
                                       "embedding_cleaned_ETTh1_24.csv"),
                          n=CLI_TEST_ROWS, T=24, seed=seed + 1)
            log(f"cli corpus: 3 x {CLI_ROWS} rows + {CLI_TEST_ROWS} test "
                f"rows written in {time.perf_counter() - t0:.2f} s")
            cli_pretrain(seed)
            # the loaders' 0.99 train split (datafactory/dataset.py:44-69)
            n_test = CLI_TEST_ROWS - int(np.ceil(CLI_TEST_ROWS * 0.99))
            steps_per_epoch = 3 * (int(np.ceil(CLI_ROWS * 0.99)) // 1024)
            for backbone, solver in (("flowmatching", "euler"),
                                     ("ddpm", "ddim")):
                train_args = ["--dataset_name", "ETTh1", "--batch_size",
                              "1024", "--epochs", "2", "--total_step",
                              str(STEPS), "--compute_dtype", "bf16",
                              "--save_every", "1", "--backbone", backbone,
                              "--general_seed", str(seed)]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                tee = _Tee(sys.stdout)
                with contextlib.redirect_stdout(tee):
                    cli_train.main(train_args)
                torch.cuda.synchronize()
                t_train = time.perf_counter() - t0
                check("Loaded pretrained VAE from" in tee.text(),
                      f"cli train {backbone} loaded the pretrained VAE")
                launches = dict(_build.launch_counts)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                n_steps = 2 * steps_per_epoch
                want = {BLOCK_KERNEL: DEPTH * n_steps,
                        BLOCK_BWD_KERNEL: DEPTH * n_steps}
                check(launches == want, f"cli train {backbone} launches "
                      f"{launches}, want {want}")
                ckpt_dir = os.path.join("results", "denoiser_results",
                                        "checkpoints",
                                        f"{backbone}_DiT_ETTh1")
                for f in ("model_0", "model_1", "model_1.loss_history.npy",
                          "train_log.jsonl"):
                    check(os.path.exists(os.path.join(ckpt_dir, f)),
                          f"cli train {backbone} wrote {f}")
                hist = np.load(os.path.join(ckpt_dir,
                                            "model_1.loss_history.npy"))
                check(hist.shape == (n_steps,) and np.isfinite(hist).all(),
                      f"cli train {backbone} loss history {hist}")
                with open(os.path.join(ckpt_dir, "train_log.jsonl")) as f:
                    rate = json.loads(f.readlines()[-1])["steps_per_sec"]
                log(f"cli train {backbone}: B=1024 bf16, 2 epochs of "
                    f"{steps_per_epoch} steps in {t_train:.3f} s wall "
                    f"(corpus load and latent cache included), "
                    f"{rate:.4f} steps/s by train_log.jsonl, peak memory "
                    f"{peak_gb:.3f} GB, launches {launches}, last loss "
                    f"{hist[-1]:.5f}")

                infer_args = ["--dataset_name", "ETTh1_24", "--total_step",
                              str(STEPS), "--checkpoint_id", "1",
                              "--backbone", backbone, "--solver", solver,
                              "--compute_dtype", "bf16", "--run_multi", "1",
                              "--max_batches", "1", "--general_seed",
                              str(seed)]
                n_sample = STEPS
                if solver == "ddim":
                    infer_args += ["--sample_steps", str(DDIM_STEPS)]
                    n_sample = len(ddim_timesteps(STEPS, DDIM_STEPS)[0])
                torch.cuda.synchronize()
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                cli_infer.main(infer_args)
                torch.cuda.synchronize()
                t_infer = time.perf_counter() - t0
                launches = dict(_build.launch_counts)
                want = {STACK_KERNEL: 11 * n_sample}
                check(launches == want, f"cli infer {backbone} launches "
                      f"{launches}, want {want}")
                gen_dir = os.path.join(
                    "results", "denoiser_results", "generation",
                    f"{backbone}_DiT_ETTh1_24_7_{STEPS}")
                b = n_test          # one batch of 2 (--batch_size 2)
                for rel, shape in (("x_t.npy", (b, 24, 1)),
                                   ("x_1.npy", (b, 24, 1)),
                                   ("x_t_latent_dec_array.npy", (b, 64, 30)),
                                   ("x_t_latent_enc_array.npy", (b, 64, 30)),
                                   ("run_9/x_1.npy", (b, 24, 1)),
                                   ("run_9/x_t.npy", (b, 24, 1))):
                    path = os.path.join(gen_dir, rel)
                    check(os.path.exists(path), f"cli infer wrote {rel}")
                    a = np.load(path)
                    check(a.shape == shape and np.isfinite(a).all(),
                          f"cli infer {backbone} {rel} shape {a.shape}, "
                          f"want {shape}, finite")
                log(f"cli infer {backbone}/{solver}: 11 runs of one batch "
                    f"of {b} at {n_sample} steps in {t_infer:.3f} s wall, "
                    f"launches {launches}")
            cli_evaluate(seed)
            serve_phase(seed, smi)
        finally:
            os.chdir(cwd)


# ----------------------------------------------------------- the serve phase

SERVE_ARGS = ["--dataset_name", "ETTh1_24", "--checkpoint_id", "1",
              "--total_step", str(STEPS), "--solver", "euler",
              "--compute_dtype", "bf16", "--port", "0"]
SERVE_CLIENTS, SERVE_PER_CLIENT = 16, 6      # 96 requests
SERVE_TOL = 2e-2             # of max|ref|: other batch sizes may pick
#                              other library GEMM algorithms
SERVE_START_S = 300          # the subprocess's limit to print its address
SERVE_SIGINT_S = 60          # and to exit 0 after SIGINT
MLP_TOL = 1e-5               # relative, the MLP on the card vs the CPU


def _http(url, path, payload=None, timeout=300):
    """(status, JSON body) of one request, an HTTP error's too."""
    import urllib.error
    import urllib.request
    data = (None if payload is None else payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serving(server):
    """Serve ``server`` from a thread; returns its URL."""
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _clients(url, reqs, n_clients):
    """Post every request from ``n_clients`` threads (client k sends
    requests k, k + n_clients, ...); returns [(status, body)] in order and
    the wall time."""
    out = [None] * len(reqs)

    def client(k):
        for i in range(k, len(reqs), n_clients):
            out[i] = _http(url, "/generate", reqs[i])

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, time.perf_counter() - t0


def _check_responses(what, reqs, res, tiers):
    for q, r in zip(reqs, res):
        check(r is not None and r[0] == 200, f"{what}: {r}")
        body = r[1]
        s = np.asarray(body["series"], np.float32)
        check(s.shape == (q["out_length"],) and np.isfinite(s).all(),
              f"{what}: series {s.shape} for length {q['out_length']}")
        check(body["seed"] == q["seed"]
              and body["cfg_scale"] == q["cfg_scale"]
              and body["out_length"] == q["out_length"],
              f"{what}: echo {body['seed']} {body['cfg_scale']}")
        check(body["batch_size"] in tiers
              and 1 <= body["batched_with"] <= body["batch_size"],
              f"{what}: batch {body['batch_size']}/{body['batched_with']}")


def serve_phase(seed, smi):
    """``cli.serve`` over the CLI phase's files, in its work directory:
    the in-process server, the real entry point as a subprocess, and the
    MLP through train, infer and serve."""
    serve_in_process(seed, smi)
    serve_subprocess()
    serve_mlp(seed)


def serve_in_process(seed, smi):
    """``cli.serve.build_server`` (buckets 24 and 96, tiers 1/16/64,
    euler/100, bf16) over the pretrained ``final_model`` and cli.train's
    flowmatching ``model_1``, served from a thread: warmup time and its
    launches (6 x 100 stack, nothing else), 96 requests from 16 client
    threads, one seed alone against the same seed in a full 64-row batch,
    one HTTP result against ``make_serving_sampler`` on the same weights,
    400/404/503, and /stats."""
    from t2ms_tpu_torch.cli import serve as cli_serve
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    from t2ms_tpu_torch.serving import ServingEngine, make_serving_sampler
    tiers = (1, 16, 64)
    argv = SERVE_ARGS + ["--buckets", "24,96", "--tiers", "1,16,64"]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        server, engine = cli_serve.build_server(argv)
    t_build = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    text = tee.text()
    check("Loaded denoiser from" in text and "WARNING" not in text,
          "serve loaded final_model and model_1")
    m = re.search(r"Warmed up (\d+) programs in ([0-9.]+) s", text)
    check(m is not None and int(m.group(1)) == 6, "serve warmup line")
    want = {STACK_KERNEL: 6 * STEPS}
    check(launches == want, f"serve warmup launches {launches}, want {want}")
    url = _serving(server)
    try:
        status, h = _http(url, "/healthz")
        check(status == 200 and h["buckets"] == [24, 96]
              and h["tiers"] == list(tiers), f"serve healthz {h}")
        rng = np.random.default_rng(seed + 16)
        n = SERVE_CLIENTS * SERVE_PER_CLIENT
        embs = rng.standard_normal((n + 65, D_MODEL)).astype(np.float32)
        reqs = [dict(text_embedding=embs[i].tolist(),
                     out_length=(24, 96)[i % 2],
                     cfg_scale=(3.0, 5.0, 7.0)[i % 3], seed=5000 + i)
                for i in range(n)]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        res, wall = _clients(url, reqs, SERVE_CLIENTS)
        load_launches = dict(_build.launch_counts)
        _check_responses("serve load", reqs, res, tiers)
        status, st = _http(url, "/stats")
        check(status == 200 and st["requests"] == n
              and st["served_rows"] == n, f"serve stats {st}")
        check(load_launches == {STACK_KERNEL: STEPS * st["batches"]},
              f"serve load launches {load_launches}, {st['batches']} "
              f"batches")
        sizes = sorted({r[1]["batch_size"] for r in res})

        # one seed inside a full 64-row batch, then alone
        futs = [engine.submit(embs[n + i], 96, CFG, 7000 + i)
                for i in range(64)]
        full = [f.result(timeout=600) for f in futs]
        solo = engine.submit(embs[n + 5], 96, CFG, 7005).result(timeout=600)
        check(full[5].batch_size == 64 and solo.batch_size == 1,
              f"serve batch tiers {full[5].batch_size}, {solo.batch_size}")
        err_b = float(np.abs(full[5].series - solo.series).max())
        ref_b = float(np.abs(solo.series).max())
        check(err_b <= SERVE_TOL * ref_b, "serve seed alone vs in a full "
              f"batch: {err_b:.4g} of {ref_b:.4g}")

        # one HTTP result against the sampler called directly
        status, one = _http(url, "/generate", dict(
            text_embedding=embs[n + 64].tolist(), out_length=96,
            cfg_scale=CFG, seed=4242))
        check(status == 200 and one["batch_size"] == 1,
              f"serve one request: {status}")
        vae, denoiser, _ = cli_serve.load_bundle(cli_serve.get_args(argv))
        direct = make_serving_sampler(denoiser, vae, "flowmatching", STEPS,
                                      engine._latent[96], 96)
        want_s = direct(np.array([4242], np.uint32),
                        np.array([CFG], np.float32),
                        embs[n + 64:n + 65]).float().cpu().numpy()[0]
        err_d = float(np.abs(np.asarray(one["series"]) - want_s).max())
        ref_d = float(np.abs(want_s).max())
        check(err_d <= SERVE_TOL * ref_d, "serve HTTP vs the direct "
              f"sampler: {err_d:.4g} of {ref_d:.4g}")

        # the error codes
        bad = [dict(text_embedding=[0.0] * D_MODEL, out_length=999),
               dict(text_embedding=[0.0] * 5, out_length=96),
               dict(out_length=96), dict(text_embedding=[0.0] * D_MODEL),
               b"{not json"]
        codes = [_http(url, "/generate", p)[0] for p in bad]
        check(codes == [400] * len(bad), f"serve bad requests {codes}")
        codes404 = [_http(url, "/nope")[0],
                    _http(url, "/nope", dict(out_length=96))[0]]
        check(codes404 == [404, 404], f"serve unknown paths {codes404}")
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    # 503: a tier that cannot fill, a far deadline, one pending request
    full_eng = ServingEngine(denoiser, vae, total_step=2, out_lengths=(96,),
                             batch_tiers=(4,), max_wait_ms=600_000.0,
                             text_emb_dim=D_MODEL, max_pending=1)
    server2 = cli_serve.make_server(full_eng, "127.0.0.1", 0)
    url2 = _serving(server2)
    parked = dict(text_embedding=[0.0] * D_MODEL, out_length=96, seed=1,
                  cfg_scale=CFG)
    first = []
    th = threading.Thread(target=lambda: first.append(
        _http(url2, "/generate", parked)), daemon=True)
    try:
        th.start()
        deadline = time.monotonic() + 60
        while full_eng.stats()["requests"] < 1:
            check(time.monotonic() < deadline, "serve: first request parked")
            time.sleep(0.01)
        code503 = _http(url2, "/generate", parked)[0]
    finally:
        server2.shutdown()
        server2.server_close()
        full_eng.close()                 # serves the parked request
        th.join(timeout=120)
    check(code503 == 503, f"serve overload answered {code503}")
    check(first and first[0][0] == 200, f"serve parked request {first}")
    log(f"serve in-process (cli.serve.build_server; buckets 24,96, tiers "
        f"1,16,64, euler/{STEPS}, bf16; {smi}): load and warmup "
        f"{t_build:.3f} s, warmup {float(m.group(2)):.3f} s for 6 programs "
        f"({launches}); {n} requests from {SERVE_CLIENTS} client threads "
        f"in {wall:.3f} s, {n / wall:.3f} requests/s, {st['batches']} "
        f"batches at tiers {sizes}, p50 {st['p50_latency_s']:.4f} s, p95 "
        f"{st['p95_latency_s']:.4f} s, padding "
        f"{st['padding_fraction']:.4f}; seed alone vs in a full batch "
        f"max_abs_err={err_b:.4g} max|ref|={ref_b:.4g}; HTTP vs direct "
        f"sampler max_abs_err={err_d:.4g} max|ref|={ref_d:.4g} (tol "
        f"{SERVE_TOL:g}); 400 x{len(bad)}, 404 x2, 503 x1")


def serve_subprocess():
    """``python -m t2ms_tpu_torch.cli.serve --port 0`` (bucket 96, tiers 1
    and 16) over the same files: the address from its ``Serving on`` line,
    GET /healthz, one POST /generate, then SIGINT: exit 0 within
    SERVE_SIGINT_S. Logs its time to the line and to the first answer."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "t2ms_tpu_torch.cli.serve"] + SERVE_ARGS + [
        "--buckets", "96", "--tiers", "1,16"]
    lines = queue.Queue()
    # a handler, not SIG_IGN, across the exec: the child starts with SIGINT
    # at its default and so turns it into KeyboardInterrupt
    old = signal.signal(signal.SIGINT, signal.default_int_handler)
    t0 = time.perf_counter()
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, env=env)
    finally:
        signal.signal(signal.SIGINT, old)
    out = []

    def reader():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()
    try:
        url = None
        while url is None:
            left = SERVE_START_S - (time.perf_counter() - t0)
            check(left > 0, f"serve subprocess printed no address: {out}")
            try:
                line = lines.get(timeout=left)
            except queue.Empty:
                continue
            check(line is not None, f"serve subprocess ended: {out}")
            out.append(line.rstrip())
            m = re.search(r"Serving on (http://[^ ]+)", line)
            url = m.group(1) if m else None
        t_line = time.perf_counter() - t0
        status, h = _http(url, "/healthz")
        check(status == 200 and h["ok"] and h["tiers"] == [1, 16],
              f"serve subprocess healthz {status} {h}")
        status, r = _http(url, "/generate", dict(
            text_embedding=[0.1] * D_MODEL, out_length=96, seed=3))
        t_first = time.perf_counter() - t0
        s = np.asarray(r.get("series", []), np.float32)
        check(status == 200 and s.shape == (96,) and np.isfinite(s).all(),
              f"serve subprocess answer {status}")
        proc.send_signal(signal.SIGINT)
        t1 = time.perf_counter()
        rc = proc.wait(timeout=SERVE_SIGINT_S)
        t_exit = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    try:
        while (line := lines.get(timeout=10)) is not None:
            out.append(line.rstrip())
    except queue.Empty:
        pass
    check(rc == 0, f"serve subprocess exit {rc} after SIGINT: {out[-5:]}")
    log(f"serve subprocess (python -m t2ms_tpu_torch.cli.serve, bucket 96, "
        f"tiers 1,16): 'Serving on' after {t_line:.3f} s, first answer "
        f"after {t_first:.3f} s, exit {rc} {t_exit:.3f} s after SIGINT "
        f"(limit {SERVE_SIGINT_S} s); its lines: {' | '.join(out)}")


def serve_mlp(seed):
    """``--denoiser MLP`` through the entry points: ``cli.train`` (B=1024,
    2 epochs, bf16) on the CLI corpus, ``cli.infer`` on its ``model_1``
    (run_multi, one batch of 256 a run), then 16 concurrent requests to
    ``cli.serve.build_server`` serving it (bucket 24, tiers 1 and 16): the
    JAX CLIs' files and shapes, finite values, no DiT kernel launched
    anywhere; and one MLP forward on the card against the CPU in f32 with
    TF32 off, within MLP_TOL relative."""
    from t2ms_tpu_torch.cli import infer as cli_infer
    from t2ms_tpu_torch.cli import serve as cli_serve
    from t2ms_tpu_torch.cli import train as cli_train
    from t2ms_tpu_torch.models.denoisers import MLPDenoiser
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.training import checkpoints as ckpt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        cli_train.main(["--dataset_name", "ETTh1", "--batch_size", "1024",
                        "--epochs", "2", "--total_step", str(STEPS),
                        "--compute_dtype", "bf16", "--save_every", "1",
                        "--denoiser", "MLP", "--general_seed", str(seed)])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check("Loaded pretrained VAE from" in tee.text(),
          "cli train MLP loaded the pretrained VAE")
    check(not _build.launch_counts,
          f"cli train MLP launched DiT kernels {dict(_build.launch_counts)}")
    ckpt_dir = os.path.join("results", "denoiser_results", "checkpoints",
                            "flowmatching_MLP_ETTh1")
    steps_per_epoch = 3 * (int(np.ceil(CLI_ROWS * 0.99)) // 1024)
    for f in ("model_0", "model_1", "model_1.loss_history.npy",
              "train_log.jsonl"):
        check(os.path.exists(os.path.join(ckpt_dir, f)),
              f"cli train MLP wrote {f}")
    hist = np.load(os.path.join(ckpt_dir, "model_1.loss_history.npy"))
    check(hist.shape == (2 * steps_per_epoch,) and np.isfinite(hist).all(),
          f"cli train MLP loss history {hist}")
    with open(os.path.join(ckpt_dir, "train_log.jsonl")) as f:
        rate = json.loads(f.readlines()[-1])["steps_per_sec"]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_infer.main(["--dataset_name", "ETTh1_24", "--total_step", str(STEPS),
                    "--checkpoint_id", "1", "--denoiser", "MLP",
                    "--compute_dtype", "bf16", "--run_multi", "1",
                    "--max_batches", "1", "--batch_size", str(CLI_EVAL_B),
                    "--general_seed", str(seed)])
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    check(not _build.launch_counts,
          f"cli infer MLP launched DiT kernels {dict(_build.launch_counts)}")
    gen_dir = os.path.join("results", "denoiser_results", "generation",
                           f"flowmatching_MLP_ETTh1_24_7_{STEPS}")
    b = CLI_EVAL_B
    for rel, shape in (("x_t.npy", (b, 24, 1)), ("x_1.npy", (b, 24, 1)),
                       ("x_t_latent_dec_array.npy", (b, 64, 30)),
                       ("x_t_latent_enc_array.npy", (b, 64, 30)),
                       ("run_9/x_t.npy", (b, 24, 1))):
        a = np.load(os.path.join(gen_dir, rel))
        check(a.shape == shape and np.isfinite(a).all(),
              f"cli infer MLP {rel} shape {a.shape}, want {shape}, finite")

    server, engine = cli_serve.build_server(
        SERVE_ARGS + ["--denoiser", "MLP", "--buckets", "24", "--tiers",
                      "1,16"])
    url = _serving(server)
    rng = np.random.default_rng(seed + 17)
    reqs = [dict(text_embedding=rng.standard_normal(D_MODEL).tolist(),
                 out_length=24, cfg_scale=CFG, seed=9000 + i)
            for i in range(16)]
    try:
        res, wall = _clients(url, reqs, 16)
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    _check_responses("serve MLP", reqs, res, (1, 16))
    check(not _build.launch_counts,
          f"MLP paths launched DiT kernels {dict(_build.launch_counts)}")

    params = ckpt.load_train_ckpt(os.path.join(ckpt_dir, "model_1"))["params"]
    card = MLPDenoiser(64, 30)
    card.load_state_dict(params)
    host = MLPDenoiser(64, 30, device="cpu")
    host.load_state_dict(params)
    g = torch.Generator().manual_seed(seed + 18)
    x, t = torch.randn(64, 64, 30, generator=g), torch.rand(64, generator=g)
    e = torch.randn(64, D_MODEL, generator=g)
    mask = (torch.arange(64) % 2).float()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 off")
    with torch.no_grad():
        want = host(x, t, e, mask)
        got = card(x.cuda(), t.cuda(), e.cuda(), mask.cuda()).cpu()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    check(err <= MLP_TOL * ref, f"MLP card vs CPU {err:.4g} of {ref:.4g}")
    log(f"serve MLP: cli.train --denoiser MLP B=1024 bf16, 2 epochs of "
        f"{steps_per_epoch} steps in {t_train:.3f} s wall, {rate:.4f} "
        f"steps/s by train_log.jsonl, peak memory {peak_gb:.3f} GB, last "
        f"loss {hist[-1]:.5f}; cli.infer --denoiser MLP 11 runs of {b} "
        f"series at {STEPS} steps in {t_infer:.3f} s wall "
        f"({11 * b / t_infer:.2f} series/s); 16 requests to cli.serve in "
        f"{wall:.3f} s ({16 / wall:.3f} series/s); no DiT kernel launched; "
        f"forward f32 card vs CPU max_abs_err={err:.4g} max|ref|={ref:.4g} "
        f"(rel {err / ref:.3e}, tol {MLP_TOL:g})")


def cli_evaluate(seed):
    """``cli.infer`` over a test split of 256 series (flowmatching
    ``model_1``, bf16, run_multi, one batch of 256 a run), then
    ``cli.evaluation`` with MSE, WAPE, MRR, CRPS and C-FID on the card:
    both JSON files, every value finite, MRR in [0, 1], no DiT kernel in
    the evaluation; then TS2Vec, C-FID and DTW held to their plain
    paths (``eval_checks``)."""
    from t2ms_tpu_torch.cli import evaluation as cli_eval
    from t2ms_tpu_torch.cli import infer as cli_infer
    from t2ms_tpu_torch.data.synthetic import write_t2s_csv
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    t0 = time.perf_counter()
    write_t2s_csv(os.path.join("Data", "our",
                               "embedding_cleaned_ETTh1_24.csv"),
                  n=CLI_EVAL_ROWS, T=24, seed=seed + 2)
    log(f"cli eval corpus: {CLI_EVAL_ROWS} rows written in "
        f"{time.perf_counter() - t0:.2f} s")
    common = ["--dataset_name", "ETTh1_24", "--total_step", str(STEPS),
              "--cfg_scale", str(CFG)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    cli_infer.main(common + ["--checkpoint_id", "1", "--compute_dtype",
                             "bf16", "--run_multi", "1", "--max_batches",
                             "1", "--batch_size", str(CLI_EVAL_B),
                             "--general_seed", str(seed)])
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    check(launches == {STACK_KERNEL: 11 * STEPS},
          f"cli infer (256 series) launches {launches}")
    gen_dir = os.path.join("results", "denoiser_results", "generation",
                           f"flowmatching_DiT_ETTh1_24_{CFG}_{STEPS}")
    x_1 = np.load(os.path.join(gen_dir, "run_0", "x_1.npy"))
    x_t = np.load(os.path.join(gen_dir, "x_t.npy"))
    check(x_1.shape == x_t.shape == (CLI_EVAL_B, 24, 1)
          and np.isfinite(x_t).all(), f"cli infer 256 series: {x_t.shape}")
    log(f"cli infer flowmatching/euler: 11 runs of one batch of "
        f"{CLI_EVAL_B} at {STEPS} steps in {t_infer:.3f} s wall, launches "
        f"{launches}")

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    single, multi = cli_eval.main(common + [
        "--method_list", "MSE,WAPE,MRR,CRPS,C-FID"])
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    check(not _build.launch_counts,
          f"cli evaluation launched DiT kernels: {dict(_build.launch_counts)}")
    out = os.path.join("results", "denoiser_results", "evaluation",
                       f"flowmatching_DiT_ETTh1_24_{CFG}_{STEPS}")
    files = sorted(os.listdir(out))
    check(len(files) == 2 and files[1].endswith("_multi.json"),
          f"cli evaluation files {files}")
    with open(os.path.join(out, files[0])) as f:
        on_disk = json.load(f)
    with open(os.path.join(out, files[1])) as f:
        on_disk.update(json.load(f))
    check(sorted(on_disk) == ["C-FID", "CRPS", "MRR", "MSE", "WAPE"]
          and on_disk == {**single, **multi},
          f"cli evaluation JSONs {on_disk}")
    check(all(np.isfinite(v) for v in on_disk.values()),
          f"cli evaluation values finite: {on_disk}")
    check(0.0 <= on_disk["MRR"] <= 1.0, f"MRR {on_disk['MRR']} in [0, 1]")
    log(f"cli evaluation: MSE,WAPE,MRR,CRPS,C-FID over {CLI_EVAL_B} series "
        f"in {t_eval:.3f} s wall (TS2Vec fit on the card included): "
        + ", ".join(f"{k} {v:.6f}" for k, v in sorted(on_disk.items())))
    eval_checks(x_1.astype(np.float32), seed)


def eval_checks(real, seed):
    """TS2Vec at ``initialize_ts2vec``'s settings (hidden 64, depth 10 +
    the final block, output 100, batch 8, lr 1e-3, 200 iterations) on the
    card over ``real`` (N, T, D): fit iterations/s and encode time;
    C-FID(real, real + 0.1 std noise) below C-FID(real, real + 1 std);
    a 20-iteration fit on the card (TF32 switched on outside it, so its
    scoping is tested) against the CPU from the same init, host draws
    and injected masks, losses and encode('full_series') within
    TS2VEC_TOL; the f64 wavefront DTW on the card against the numpy DP at
    (64, 96, 1) and (64, 24, 7), within DTW_TOL, timed."""
    from t2ms_tpu_torch.evaluate import (TS2Vec, calculate_dtw,
                                         calculate_fid, dtw_numpy,
                                         dtw_wavefront_batch,
                                         initialize_ts2vec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = initialize_ts2vec(real)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    check(model.n_iters == 200 and np.isfinite(model.last_losses).all(),
          f"ts2vec fit {model.n_iters} iterations, finite losses")
    model.encode(real, encoding_window="full_series")        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_real = model.encode(real, encoding_window="full_series")
    t_enc = time.perf_counter() - t0
    g = np.random.default_rng(seed)
    std = float(real.std())
    noisy = real + 0.1 * std * g.standard_normal(real.shape)
    fid_noise = calculate_fid(r_real, model.encode(
        noisy.astype(np.float32), encoding_window="full_series"))
    fid_shift = calculate_fid(r_real, model.encode(
        real + std, encoding_window="full_series"))
    log(f"ts2vec on the card: fit 200 iterations (B=8, {real.shape}) in "
        f"{t_fit:.3f} s, {200 / t_fit:.2f} iterations/s; encode "
        f"full_series of {real.shape[0]} series {1e3 * t_enc:.2f} ms; "
        f"C-FID real vs +0.1 std noise {fid_noise:.6f}, vs +1 std shift "
        f"{fid_shift:.6f}; first/last loss {model.last_losses[0]:.5f} "
        f"{model.last_losses[-1]:.5f}")
    check(np.isfinite(fid_noise) and fid_noise < fid_shift,
          f"C-FID discriminates: {fid_noise} < {fid_shift}")

    n, (B, T, co) = TS2VEC_CHECK_ITERS, (8, real.shape[1], 100)
    draws = {"mask1": g.random((n, B, T)) < 0.5,
             "keep1": g.random((n, B, T, co)) < 0.9,
             "mask2": g.random((n, B, T)) < 0.5,
             "keep2": g.random((n, B, T, co)) < 0.9}
    kw = dict(input_dims=real.shape[-1], batch_size=8, lr=1e-3,
              output_dims=100, max_train_length=3000, seed=seed)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = TS2Vec(device=dev, **kw)
        tf32 = torch.backends.cudnn.allow_tf32
        precision = torch.get_float32_matmul_precision()
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            m.fit(real, n_iters=n, draws=draws)
            check(torch.backends.cudnn.allow_tf32
                  and torch.get_float32_matmul_precision() == "high",
                  "ts2vec restored the TF32 settings it was given")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
            torch.set_float32_matmul_precision(precision)
        runs[dev] = (m.last_losses, m.encode(
            real, encoding_window="full_series"))
    (lg, eg), (lc, ec) = runs["cuda"], runs["cpu"]
    loss_rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    enc_rel = float(np.abs(eg - ec).max() / np.abs(ec).max())
    log(f"ts2vec card vs CPU: {n} iterations at full width, same init, "
        f"host draws and injected masks: losses max rel err {loss_rel:.3g}, "
        f"encode full_series max abs err / max|ref| {enc_rel:.3g} (tol "
        f"{TS2VEC_TOL:g}, TF32 off inside TS2Vec)")
    check(loss_rel <= TS2VEC_TOL and enc_rel <= TS2VEC_TOL,
          f"ts2vec card vs CPU: {loss_rel}, {enc_rel}")

    for N, T, D in ((64, 96, 1), (64, 24, 7)):
        a = g.standard_normal((N, T, D))
        b = g.standard_normal((N, T, D))
        ta = torch.from_numpy(a).cuda()
        tb = torch.from_numpy(b).cuda()
        got = dtw_wavefront_batch(ta, tb).cpu().numpy()
        want = np.array([dtw_numpy(x, y) for x, y in zip(a, b)])
        rel = float(np.max(np.abs(got - want) / want))
        ms = cuda_ms(lambda: dtw_wavefront_batch(ta, tb))
        calculate_dtw(a[:1], b[:1])          # builds the native library
        t0 = time.perf_counter()
        native = calculate_dtw(a, b)
        native_ms = 1e3 * (time.perf_counter() - t0)
        log(f"dtw wavefront ({N}, {T}, {D}) f64 on the card: max rel err "
            f"{rel:.3g} vs dtw_numpy (tol {DTW_TOL:g}), {ms:.3f} ms (CUDA "
            f"events, median of 7); native batch on the host "
            f"{native_ms:.3f} ms, mean {native:.6f} vs {want.mean():.6f}")
        check(rel <= DTW_TOL, f"dtw wavefront ({N}, {T}, {D}): {rel}")
        check(abs(native - want.mean()) <= DTW_TOL * want.mean(),
              f"native dtw ({N}, {T}, {D})")

# ------------------------------------------------- the T2MS motion track

# the repository's per-sport config (config.yaml:9-103): benchpress 10
# features over a 64-long latent grid (64 x 64 in 2x2 patches: 1024
# tokens), deadlift 7 over 50 (800 tokens); caption folders as configured
MOTION_SPORTS = {
    "benchpress": dict(caption="Caption_explain_no_barbell_length",
                       split=36, epoch=16000, n_f=10, flow=64, tokens=1024),
    "deadlift": dict(caption="Caption_explain_no_barbell", split=48,
                     epoch=20000, n_f=7, flow=50, tokens=800)}
# the synthetic corpora: 30 subjects x 60 clips, 600 clips a length bucket
# (the capture datasets are not in the repository): about 540 train rows a
# bucket, one whole batch of 512 a bucket an epoch
MOTION_SUBJECTS, MOTION_CLIPS, MOTION_B = 30, 60, 512
MOTION_CONV_UPDATES, MOTION_TSAE_UPDATES = 200, 50   # config epoch: 16000
MOTION_TSAE_TOL = 1e-4         # relative, card vs CPU, f32 with TF32 off
# cli.myinfer's and cli.myevaluation's defaults; the cfg default is the int
# 3 (argparse leaves a default untyped), so the directories say "_3_"
MOTION_STEPS, MOTION_CFG = 100, 3
MOTION_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "config.yaml")


def motion_dit(N_lat, dtype, impl="auto"):
    """The motion track's DiT (``build_denoiser``'s defaults over the
    (64, flow_dim) latent: d 128, 4 heads, depth 4, mlp x2)."""
    from t2ms_tpu_torch.models.denoisers import DiT
    return DiT(latent_len=N_lat, latent_dim=64, compute_dtype=dtype,
               attention_impl=impl)


def motion_kernel_checks(gen):
    """#1 at the CFG pairs of one and of 32 series (2B=2 and 64, bf16; and
    2B=2 in f32) and #2/#3 at B=4 (bf16 and f32) against their twins at
    the motion DiTs' 1024 and 800 tokens (d 128, 4 heads, depth 4),
    random adaLN vectors, the tolerances of the kernel and block phases.
    800 = 6*128 + 32 = 12*64 + 32: the last 128-row block and 64-row tile
    hold 32 live rows."""
    from t2ms_tpu_torch.ops.dit_block import (fused_dit_block_diffable,
                                              fused_dit_block_reference,
                                              fused_dit_stack,
                                              fused_dit_stack_reference)
    dev = torch.device("cuda")
    f = lambda *s_: torch.randn(*s_, generator=gen, device=dev)
    D, hid, L = D_MODEL, HIDDEN, DEPTH
    weights = lambda *lead: [0.2 * f(*lead, D, 3 * D), 0.1 * f(*lead, 3 * D),
                             0.2 * f(*lead, D, D), 0.1 * f(*lead, D),
                             0.2 * f(*lead, D, hid), 0.1 * f(*lead, hid),
                             0.2 * f(*lead, hid, D), 0.1 * f(*lead, D)]
    for N in (1024, 800):
        for dt, B2, tol in ((torch.bfloat16, 2, 3e-2),
                            (torch.bfloat16, 64, 3e-2),
                            (torch.float32, 2, 2e-4)):
            x, mod = f(B2, N, D).to(dt), (0.3 * f(B2, L, 6, D)).to(dt)
            ws = [w.to(dt) for w in weights(L)]
            got = fused_dit_stack(x, mod, *ws, HEADS)
            want = fused_dit_stack_reference(x, mod, *ws, HEADS)
            err, ref, corr = _err(got, want)
            check(bool(torch.isfinite(got.float()).all()),
                  f"motion stack {dt} N={N} finite")
            ms = cuda_ms(lambda: fused_dit_stack(x, mod, *ws, HEADS))
            plain = cuda_ms(lambda: fused_dit_stack_reference(x, mod, *ws,
                                                              HEADS))
            log(f"motion stack {dt} 2B={B2} N={N}: max_abs_err={err:.6g} "
                f"max|ref|={ref:.6g} rel={err / ref:.3e} (tol {tol:g}) "
                f"corr={corr:.8f}; {ms:.4f} ms, twin {plain:.4f} ms")
            check(err <= tol * ref and corr >= 0.999,
                  f"motion stack {dt} 2B={B2} N={N} vs twin")
        for dt, tol_f, tol_b in ((torch.bfloat16, 3e-2, 5e-2),
                                 (torch.float32, 2e-4, 5e-4)):
            args = [f(4, N, D).to(dt), (0.3 * f(4, 6, D)).to(dt),
                    *weights()]
            dy = f(4, N, D).to(dt)
            got_y, got = _vjp(fused_dit_block_diffable, args, dy)
            want_y, want = _vjp(fused_dit_block_reference, args, dy)
            truth = (None if dt == torch.float32 else
                     _vjp(fused_dit_block_reference,
                          [a.float() for a in args], dy.float())[1])
            worst = 0.0
            for i, (name, g, w) in enumerate(zip(("y",) + GRAD_NAMES,
                                                 (got_y, *got),
                                                 (want_y, *want))):
                check(bool(torch.isfinite(g.float()).all()),
                      f"motion block {dt} N={N} {name} finite")
                err, ref, corr = _err(g, w)
                tol = tol_f if name == "y" else tol_b
                check(err <= tol * ref and corr >= 0.999,
                      f"motion block {dt} N={N} {name}: {err} > {tol}*{ref} "
                      f"or corr {corr}")
                worst = max(worst, err / ref)
                if truth is not None and i:
                    ek = (g.float() - truth[i - 1]).abs().mean().item()
                    et = (w.float() - truth[i - 1]).abs().mean().item()
                    check(ek <= 1.5 * et + 1e-12,
                          f"motion block bf16 N={N} {name} rounds worse "
                          f"than its twin: {ek} vs {et}")
            log(f"motion block {dt} B=4 N={N}: y and the 10 gradients "
                f"against the twin and autograd over it, worst rel "
                f"{worst:.3e} (tol fwd {tol_f:g}, bwd {tol_b:g}"
                + (", each mean error vs the f32 truth at most 1.5x the "
                   "twin's)" if truth is not None else ")"))
        torch.cuda.empty_cache()


def _run_cli(main, argv):
    """``main(argv)`` with the launch counts set to 0 just before it and
    read just after: (return value, launches, wall s, stdout text, peak
    GB)."""
    from t2ms_tpu_torch.ops import _build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ret = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (ret, dict(_build.launch_counts), wall, tee.text(),
            torch.cuda.max_memory_allocated() / 1e9)


def _train_rows(sport, B):
    """The optimizer steps of one motion epoch at batch B: whole batches
    of the train split in each bucket (``cli.mytrain``'s own loader)."""
    from t2ms_tpu_torch.data.provider import motion_loader_provider
    from t2ms_tpu_torch.cli import mytrain
    args = mytrain.get_args(["--dataset_name", sport, "--config",
                             MOTION_CONFIG, "--batch_size", str(B)])
    train, _ = motion_loader_provider(args, "train")
    return len(train), {k: v["x"].shape[0] for k, v in train.buckets.items()}


def motion_pretrain(sport):
    """``cli.pretrain_mylavae --vae_kind conv`` (B=128, lr 1e-3) with the
    update budget cut to MOTION_CONV_UPDATES: ``final_model`` where
    ``cli.mytrain`` looks, finite losses, no DiT kernel launched."""
    from t2ms_tpu_torch.cli import pretrain_mylavae
    s = MOTION_SPORTS[sport]
    _, launches, wall, _, peak = _run_cli(
        lambda a: pretrain_mylavae.main(a), [
            "--dataset_name", sport, "--config", MOTION_CONFIG,
            "--vae_kind", "conv", "--max_updates",
            str(MOTION_CONV_UPDATES)])
    check(not launches, f"motion pretrain conv launched {launches}")
    d = os.path.join("results", "saved_pretrained_models",
                     f"{s['split']}_{sport}_epoch{s['epoch']}")
    check(os.path.exists(os.path.join(d, "final_model", "params.pt")),
          f"motion pretrain {sport} final_model in {d}")
    with open(os.path.join(d, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(all(np.isfinite(r["loss"]) for r in rows),
          f"motion pretrain {sport} losses {rows}")
    log(f"motion pretrain conv {sport}: B=128, {MOTION_CONV_UPDATES} "
        f"updates ({len(rows)} epochs) in {wall:.3f} s wall (corpus load, "
        f"validation and reconstruction included), "
        f"{rows[-1]['steps_per_sec']:.4f} steps/s by train_log.jsonl, peak "
        f"memory {peak:.3f} GB, last epoch loss {rows[-1]['loss']:.6f}")


def motion_tsae(seed):
    """``cli.pretrain_mylavae --vae_kind tsae`` (the reference default:
    B=128, 3 + 3 layers, d 64, 8 heads, d_ff 128, dropout 0.1) for
    MOTION_TSAE_UPDATES updates into its own --save_path, then its
    autoregressive inference over the test split; then the trained TSae
    on the card against the same weights on the CPU, f32 with TF32 off:
    ``reconstruct_teacher_forced`` and ``generate`` at B=8, T=144."""
    from t2ms_tpu_torch.cli import pretrain_mylavae
    from t2ms_tpu_torch.models.vae import TSae
    from t2ms_tpu_torch.training import checkpoints as ckpt
    (real, reco), launches, wall, _, peak = _run_cli(
        lambda a: pretrain_mylavae.main(a), [
            "--dataset_name", "benchpress", "--config", MOTION_CONFIG,
            "--vae_kind", "tsae", "--max_updates", str(MOTION_TSAE_UPDATES),
            "--save_path", "tsae_results/"])
    check(not launches, f"motion pretrain tsae launched {launches}")
    d = os.path.join("tsae_results", "36_benchpress_epoch16000")
    with open(os.path.join(d, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(all(np.isfinite(r["loss"]) for r in rows)
          and len(real) == len(reco) > 0
          and all(a.shape == b.shape and np.isfinite(b).all()
                  for a, b in zip(real, reco)),
          f"motion pretrain tsae: losses {rows}, {len(reco)} recons")
    log(f"motion pretrain tsae benchpress: B=128, {MOTION_TSAE_UPDATES} "
        f"updates ({len(rows)} epochs) and the autoregressive "
        f"reconstruction of {len(reco)} test series in {wall:.3f} s wall, "
        f"{rows[-1]['steps_per_sec']:.4f} steps/s by train_log.jsonl, peak "
        f"memory {peak:.3f} GB, last epoch loss {rows[-1]['loss']:.6f}")

    sd = ckpt.load_params(os.path.join(d, "final_model"))
    kw = dict(n_features=10, flow_dim=64, num_encoder_layers=3,
              num_decoder_layers=3, d_ff=128, num_heads=8)
    card, cpu = TSae(**kw), TSae(**kw, device="cpu")
    card.load_state_dict(sd)
    cpu.load_state_dict(sd)
    long = [a for a in real if a.shape[-1] == 144][:8]
    check(len(long) == 8, "motion tsae: 8 test series of length 144")
    x = torch.from_numpy(np.stack(long).transpose(0, 2, 1).copy())
    with torch.no_grad():
        for name, fn in (("reconstruct_teacher_forced",
                          lambda m, s: m.reconstruct_teacher_forced(s)),
                         ("generate", lambda m, s: m.generate(m.encode(s)))):
            want = fn(cpu, x)
            got = fn(card, x.cuda())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(card, x.cuda())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            # each step against its own scale: an autoregressive decoder
            # this briefly trained feeds its growth back, and the later
            # steps' magnitude would hide the earlier steps' errors
            d = (got.cpu() - want).abs().amax(dim=(0, 2))
            ref_t = want.abs().amax(dim=(0, 2))
            rel = (d / ref_t.clamp_min(1e-30)).max().item()
            log(f"motion tsae {name} B=8 T=144 f32, card vs CPU: max_abs_err"
                f"={d.max().item():.4g} max|ref|={ref_t.max().item():.4g} "
                f"(step 0 {ref_t[0].item():.4g}, last "
                f"{ref_t[-1].item():.4g}); worst step's max_abs_err / its "
                f"max|ref| {rel:.3e} (tol {MOTION_TSAE_TOL:g}); card "
                f"{ms:.3f} ms (the second call, eager"
                + (", 144 decoder reruns)" if name == "generate" else ")"))
            check(rel <= MOTION_TSAE_TOL, f"motion tsae {name} card vs CPU")


def motion_train(sport, seed):
    """``cli.mytrain`` (B=512, bf16, 2 epochs, a checkpoint each epoch):
    4 #2 and 4 #3 launches a step and nothing else, model_0 and model_1,
    steps/s by train_log.jsonl and peak memory."""
    from t2ms_tpu_torch.cli import mytrain
    from t2ms_tpu_torch.ops.dit_block import BLOCK_BWD_KERNEL, BLOCK_KERNEL
    s = MOTION_SPORTS[sport]
    per_epoch, rows = _train_rows(sport, MOTION_B)
    _, launches, wall, text, peak = _run_cli(
        lambda a: mytrain.main(a), [
            "--dataset_name", sport, "--config", MOTION_CONFIG,
            "--batch_size", str(MOTION_B), "--epochs", "2",
            "--save_every", "1", "--compute_dtype", "bf16"])
    n_steps = 2 * per_epoch
    want = {BLOCK_KERNEL: DEPTH * n_steps, BLOCK_BWD_KERNEL: DEPTH * n_steps}
    check(n_steps > 0 and launches == want,
          f"motion train {sport} launches {launches}, want {want}")
    check("Loaded pretrained VAE from" in text,
          f"motion train {sport} loaded its pretrained VAE")
    ckpt_dir = os.path.join("results", "denoiser_results", "checkpoints",
                            f"flowmatching_DiT_{sport}_{s['caption']}_"
                            f"{s['epoch']}")
    for f_ in ("model_0", "model_1", "model_1.loss_history.npy",
               "train_log.jsonl"):
        check(os.path.exists(os.path.join(ckpt_dir, f_)),
              f"motion train {sport} wrote {f_}")
    hist = np.load(os.path.join(ckpt_dir, "model_1.loss_history.npy"))
    check(hist.shape == (2,) and np.isfinite(hist).all(),
          f"motion train {sport} loss history {hist}")
    with open(os.path.join(ckpt_dir, "train_log.jsonl")) as f:
        rate = json.loads(f.readlines()[-1])["steps_per_sec"]
    log(f"motion train {sport}: {s['tokens']} tokens, B={MOTION_B} bf16, "
        f"train rows by bucket {rows}, 2 epochs of {per_epoch} steps in "
        f"{wall:.3f} s wall (corpus load and latent cache included), "
        f"{rate:.4f} steps/s by train_log.jsonl, peak memory {peak:.3f} "
        f"GB, launches {launches} ({DEPTH} + {DEPTH} a step), epoch losses "
        f"{hist.tolist()}")


def motion_train_vs_eager(gen):
    """At B=16, three draws: the motion DiT's train step through the
    kernel path against the eager bf16 and f32 paths on the same injected
    draws (precoded latents), at 1024 and 800 tokens; seeded random
    weights moved off the adaLN-zero init."""
    from t2ms_tpu_torch.models.vae import LAVAE
    Bs = 16
    for sport in ("benchpress", "deadlift"):
        s = MOTION_SPORTS[sport]
        vae = LAVAE(in_channels=s["n_f"], num_residual_layers=3,
                    latent_grid=s["flow"], exact_length_output=True).eval()
        dit = motion_dit(s["flow"], torch.bfloat16)
        with torch.no_grad():
            for p in dit.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen,
                                          device="cuda"))
        z = torch.randn(Bs, 64, s["flow"], generator=gen, device="cuda")
        emb = torch.randn(Bs, 128, generator=gen, device="cuda")
        train_paths_vs_eager(
            f"motion train {sport} ({s['tokens']} tokens)",
            lambda dt_, impl, n=s["flow"]: motion_dit(n, dt_, impl), dit,
            vae, z, emb,
            lambda: dict(u=torch.rand(Bs, generator=gen, device="cuda"),
                         x_0=torch.randn(Bs, 64, s["flow"], generator=gen,
                                         device="cuda"),
                         coin=torch.tensor(0.9, device="cuda")),
            precoded=True)
        del vae, dit
        torch.cuda.empty_cache()


def motion_infer(sport, max_batches, run_time):
    """``cli.myinfer`` on ``model_1`` (B=1, bf16, euler/100, cfg 3): 100
    #1 launches a batch and nothing else; every file the JAX CLI writes,
    of shape (1, n_f, T) (``x_t.npy``) or (n_f, T), T the series' native
    length, finite; the JSON's features; the skip lines where matplotlib
    is absent. Returns the generation directory."""
    from t2ms_tpu_torch.cli import myinfer
    from t2ms_tpu_torch.ops.dit_block import STACK_KERNEL
    s = MOTION_SPORTS[sport]
    ctx, launches, wall, text, peak = _run_cli(
        lambda a: myinfer.main(a), [
            "--dataset_name", sport, "--config", MOTION_CONFIG,
            "--checkpoint_id", "1", "--compute_dtype", "bf16",
            "--run_time", str(run_time), "--max_batches", str(max_batches)])
    n_b = min(max_batches + 1, len(ctx["test_batcher"]))
    want = {STACK_KERNEL: MOTION_STEPS * n_b * run_time}
    check(launches == want, f"motion infer {sport} launches {launches}, "
          f"want {want}")
    check("Loaded denoiser from" in text, f"motion infer {sport} loaded "
          f"model_1")
    gen_dir = os.path.join("results", "denoiser_results", "generation",
                           f"flowmatching_DiT_{sport}_{MOTION_CFG}_"
                           f"{MOTION_STEPS}")
    lengths = []
    for b in range(n_b):
        x1 = np.load(os.path.join(gen_dir, f"x_1_sample_{b}.npy"))
        T = x1.shape[-1]
        lengths.append(T)
        check(x1.shape == (s["n_f"], T), f"motion infer x_1_sample_{b} "
              f"{x1.shape}")
        for r in range(run_time):
            run = os.path.join(gen_dir, f"run_{r}")
            for rel, shape in ((f"sample_{b}/x_t.npy", (1, s["n_f"], T)),
                               (f"x_t_sample_{b}.npy", (s["n_f"], T))):
                a = np.load(os.path.join(run, rel))
                check(a.shape == shape and np.isfinite(a).all(),
                      f"motion infer {sport} {rel} {a.shape}, want {shape}")
            with open(os.path.join(run, f"sample_{b}", "data.json")) as f:
                feats = json.load(f)
            check(len(feats) == s["n_f"] and all(
                len(v) == T and np.isfinite(v).all() for v in feats.values()),
                f"motion infer {sport} sample_{b}/data.json")
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        check("figures skipped: matplotlib" in text,
              f"motion infer {sport} says it skips the figures")
        if sport == "benchpress":
            check("skeleton GIFs skipped: matplotlib" in text,
                  "motion infer benchpress says it skips the GIFs")
    n_series = n_b * run_time
    log(f"motion infer {sport}: {s['tokens']} tokens (2B=2), {run_time} runs "
        f"of {n_b} batches of one series (native lengths {lengths}) at "
        f"euler/{MOTION_STEPS} bf16 in {wall:.3f} s wall (loader and "
        f"models included): {n_series / wall:.4f} series/s, peak memory "
        f"{peak:.3f} GB, launches {launches}; figures and GIFs "
        + ("written" if figures else "skipped (no matplotlib), as said"))
    return gen_dir


def motion_evaluate():
    """``cli.myevaluation`` over benchpress's two runs with MSE, WAPE, MRR,
    CRPS and DTW: the JSON written, every value finite, MRR in [0, 1], no
    DiT kernel launched."""
    from t2ms_tpu_torch.cli import myevaluation
    result, launches, wall, _, _ = _run_cli(
        lambda a: myevaluation.main(a), [
            "--dataset_name", "benchpress", "--config", MOTION_CONFIG,
            "--run_time", "2", "--method_list", "MSE,WAPE,MRR,CRPS,DTW"])
    check(not launches, f"motion evaluation launched {launches}")
    out = os.path.join("results", "denoiser_results", "evaluation",
                       f"flowmatching_DiT_benchpress_{MOTION_CFG}_"
                       f"{MOTION_STEPS}")
    files = os.listdir(out)
    check(len(files) == 1, f"motion evaluation files {files}")
    with open(os.path.join(out, files[0])) as f:
        on_disk = json.load(f)
    summary = on_disk["summary"]
    check(sorted(summary) == ["CRPS", "DTW", "MRR", "MSE", "WAPE"]
          and len(on_disk) == 11 and summary == result["summary"],
          f"motion evaluation JSON {sorted(on_disk)}")
    check(all(np.isfinite(v) for r in on_disk.values() for v in r.values()),
          "motion evaluation values finite")
    check(all(0.0 <= r["MRR"] <= 1.0 for r in on_disk.values()),
          "motion evaluation MRR in [0, 1]")
    log(f"motion evaluation benchpress: 10 samples x 2 runs in {wall:.3f} s "
        f"wall, summary " + ", ".join(f"{k} {v:.6f}"
                                      for k, v in sorted(summary.items())))


BP_FEATURES = ["bar_x", "bar_y", "barx/bar_y", "left_shoulder_y",
               "right_shoulder_y", "left_dist", "right_dist", "left_elbow",
               "left_shoulder", "right_elbow", "right_shoulder",
               "left_torso-arm", "right_torso-arm"]


def _write_capture(root, rng, clips):
    """Synthetic benchpress capture files in the recording layout the
    merger reads: ``clips`` maps (class, subject, clip) to a frame count."""
    views = {"rear": BP_FEATURES[7:11], "top": BP_FEATURES[11:]}
    for (cls, subj, clip), n in clips.items():
        base = os.path.join(root, cls, subj)
        for view, names in views.items():
            for name in names:
                d = os.path.join(base, "angle_dataset", view, name)
                os.makedirs(d, exist_ok=True)
                v = 90 + 30 * np.sin(np.linspace(0, 3, n) + rng.random())
                with open(os.path.join(d, f"{clip}.txt"), "w") as f:
                    f.write("\n".join(f"{i},{x:.4f}" for i, x in enumerate(v)))
        coord = os.path.join(base, "coordinate_dataset")
        lines = {"lateral_view": [], "rear_view": [], "top_view": []}
        for i in range(n):
            bx, by = 300 + rng.random() * 20, 200 + 50 * np.sin(i / 9)
            lines["lateral_view"].append(f"{i},{bx:.3f},{by:.3f}")
            lines["rear_view"].append(
                f"Frame {i}: [[(10, {300 + i % 7}), (60, {310 - i % 5}), "
                f"(1, 1)]]")
            w = 0.2 * np.sin(i / 5)
            lines["top_view"].append(
                f"Frame {i}: [[(0, 0), (2, 0), (0, -2), (2, -2), (0, -1), "
                f"(2, -1), ({0.5 + w:.4f}, -1.5), ({1.5 - w:.4f}, -2.5)]]")
        for view, ls in lines.items():
            os.makedirs(os.path.join(coord, view), exist_ok=True)
            with open(os.path.join(coord, view, f"{clip}.txt"), "w") as f:
                f.write("\n".join(ls))


def motion_pipeline_check(seed):
    """Host only: a benchpress corpus built by the port's ``pipeline/``
    (capture files -> ``BenchpressFeatureMerger`` -> ``generate_captions``
    with ``FakeChat`` -> ``enrich_captions`` with ``FakeEmbed`` ->
    ``rebuild_motion_json``), read back by ``data/motion.py``."""
    from t2ms_tpu_torch.data.motion import load_motion_records
    from t2ms_tpu_torch.pipeline import FakeChat, FakeEmbed
    from t2ms_tpu_torch.pipeline.captions import generate_captions
    from t2ms_tpu_torch.pipeline.corpus import rebuild_motion_json
    from t2ms_tpu_torch.pipeline.embeddings import enrich_captions
    from t2ms_tpu_torch.pipeline.mergers import BenchpressFeatureMerger
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    frames = (40, 64, 90)
    clips = {(cls, f"{cls}{s}", f"clip{c}"): frames[(s + c) % 3]
             for cls in ("correct", "tilting") for s in range(2)
             for c in range(3)}
    _write_capture("capture", rng, clips)
    with open("multi_error.csv", "w") as f:
        f.write("subject,err1,err2\ntilting1,tilting_to_the_right,"
                "elbows_flaring\n")
    feature = {f"feature_{i}": n for i, n in enumerate(BP_FEATURES)}
    class_dirs = [os.path.join("capture", c) for c in ("correct", "tilting")]
    merged = BenchpressFeatureMerger(class_dirs, "pipe_merged",
                                     "multi_error.csv", feature).data
    n_cap = generate_captions(FakeChat(), "pipe_merged/data.json",
                              "pipe_captions", {"feature_3": "left shoulder"},
                              make_figures=False)
    n_emb = enrich_captions(FakeEmbed(), "pipe_merged/data.json",
                            "pipe_captions")
    rebuilt = rebuild_motion_json("benchpress", class_dirs, "pipe_rebuilt",
                                  "multi_error.csv", feature).data
    check(rebuilt == merged, "pipeline rebuild_motion_json == the merger's")
    subjects = sorted(merged)
    check(n_cap == len(clips) == n_emb and len(subjects) == 4
          and "tilting1_tilting_to_the_right_elbows_flaring" in subjects,
          f"pipeline captions {n_cap}, embeddings {n_emb}, subjects "
          f"{subjects}")
    recs = load_motion_records("benchpress", "pipe_rebuilt/data.json",
                               "pipe_captions", "test", 36)
    check(len(recs) == len(clips)
          and all(r.x.shape[0] == 10 and len(r.embeddings) == 2
                  and all(e.shape == (128,) for e in r.embeddings)
                  and np.isfinite(r.x).all() for r in recs),
          "pipeline corpus read by data/motion.py")
    buckets = {d: len(load_motion_records("benchpress",
                                          "pipe_rebuilt/data.json",
                                          "pipe_captions", "train", d))
               for d in (36, 72, 144)}
    check(sum(buckets.values()) == len(clips),
          f"pipeline train buckets {buckets}")
    log(f"motion pipeline: {len(clips)} captured clips -> merger, "
        f"{n_cap} captions (FakeChat), {n_emb} embeddings (FakeEmbed), "
        f"rebuild_motion_json equal to the merger; data/motion.py reads "
        f"{len(recs)} test records (10 features, 2 x 128-d embeddings), "
        f"train rows by bucket {buckets}, subjects {subjects}, in "
        f"{time.perf_counter() - t0:.3f} s")


def motion_phase(seed, gen):
    """The motion track through its four entry points on synthetic
    benchpress and deadlift corpora, in a temporary directory with the
    repository's config.yaml; then the kernels at its token counts."""
    import tempfile

    from t2ms_tpu_torch.data.synthetic import write_motion_dataset
    t_phase = time.perf_counter()
    motion_kernel_checks(gen)
    motion_train_vs_eager(gen)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="t2ms_motion_") as work:
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            for i, (sport, s) in enumerate(MOTION_SPORTS.items()):
                write_motion_dataset("Data", sport, MOTION_SUBJECTS,
                                     MOTION_CLIPS, seed=seed + i,
                                     caption_dir=s["caption"])
            log(f"motion corpora: 2 x {MOTION_SUBJECTS * MOTION_CLIPS} "
                f"clips written in {time.perf_counter() - t0:.2f} s")
            motion_pipeline_check(seed)
            motion_pretrain("benchpress")
            motion_tsae(seed)
            motion_train("benchpress", seed)
            motion_infer("benchpress", 10, 2)
            motion_evaluate()
            motion_pretrain("deadlift")
            motion_train("deadlift", seed)
            motion_infer("deadlift", 1, 1)
        finally:
            os.chdir(cwd)
    log(f"motion phase: {time.perf_counter() - t_phase:.2f} s wall")


def _bits(a, b, what, atol=0.0, rtol=0.0, expect_equal=False):
    """Log a result against its no-plan reference: bit-equal, or the max
    difference beside the tolerance used (atol + rtol * max|reference|);
    fail beyond it."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    check(a.shape == b.shape, f"parallel {what}: shapes {a.shape} {b.shape}")
    check(np.isfinite(a).all(), f"parallel {what}: non-finite values")
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    if err == 0.0:
        log(f"parallel {what}: bit-equal to the no-plan path")
        return err
    tol = atol + rtol * float(np.max(np.abs(b)))
    log(f"parallel {what}: max_abs_err={err:.3e} against the no-plan path, "
        f"tol {tol:.3e}" + (" (bit-equality expected at this world size)"
                            if expect_equal else ""))
    check(err <= tol, f"parallel {what}: {err} > {tol}")
    return err


# The W > 1 train steps against the no-plan step, each gradient tensor by
# its relative L2 error: the TP step runs the eager bf16 model where the
# no-plan step runs the block kernels, both rounding to bf16 (8 bits of
# mantissa, 3.9e-3). A wrong scale, a wrong sign or a missing all-reduce
# gives 0.1 to 2.
PARALLEL_GRAD_RTOL = 3e-2


def _rel_bits(a, b, what, rtol, expect_equal=False):
    """Log dicts of tensors against their no-plan references: bit-equal,
    or the worst relative L2 error ||a - b|| / ||b|| of one tensor beside
    the limit; fail beyond it."""
    check(a.keys() == b.keys(), f"parallel {what}: names differ")
    worst, name = 0.0, None
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        check(x.shape == y.shape and np.isfinite(x).all(),
              f"parallel {what}: {k} shape {x.shape} vs {y.shape} or "
              f"non-finite")
        err = float(np.linalg.norm(x - y)) / max(float(np.linalg.norm(y)),
                                                 1e-30)
        if err > worst:
            worst, name = err, k
    if worst == 0.0:
        log(f"parallel {what}: bit-equal to the no-plan path")
        return worst
    log(f"parallel {what}: worst relative L2 error {worst:.3e} ({name}) "
        f"against the no-plan path, limit {rtol:.1e}"
        + (" (bit-equality expected at this world size)"
           if expect_equal else ""))
    check(worst <= rtol, f"parallel {what}: {name} {worst} > {rtol}")
    return worst


def parallel_phase(seed):
    """The parallel layer over NCCL: ``parallel.dryrun.dryrun_multichip``
    at full width on W = torch.cuda.device_count() ranks (in this process
    when W = 1, spawned processes otherwise) over a FileStore in a
    temporary directory, each result held to the one-rank no-plan path on
    this card: bit for bit where W = 1."""
    import tempfile

    from t2ms_tpu_torch.cli._common import batch_seed
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import (BLOCK_BWD_KERNEL, BLOCK_KERNEL,
                                              STACK_KERNEL)
    from t2ms_tpu_torch.parallel.dryrun import (CHECKS, _models, _t,
                                                dryrun_multichip,
                                                flagship_inputs, launch,
                                                save_inputs)
    from t2ms_tpu_torch.sampling import make_cfg_sampler
    from t2ms_tpu_torch.serving import ServingEngine
    from t2ms_tpu_torch.training import (ScheduledAdamW,
                                         make_denoiser_train_step)
    t_phase = time.perf_counter()
    W = torch.cuda.device_count()
    inp = flagship_inputs(seed, W)
    cfg = inp["config"]
    checks = CHECKS + ("train_dp",)
    cfg["train_seed"] = seed + 11
    with tempfile.TemporaryDirectory(prefix="t2ms_parallel_") as work:
        out_dir = os.path.join(work, "out")
        if W == 1:
            rec = dryrun_multichip(0, 1, "cuda", work, inp, out_dir, checks)
        else:
            path = os.path.join(work, "inputs.npz")
            save_inputs(path, inp)
            launch(W, "cuda", path, out_dir, timeout_s=600.0, checks=checks)
            with open(os.path.join(out_dir, "rank0.json")) as f:
                rec = json.load(f)
        got = dict(np.load(os.path.join(out_dir, "rank0.npz")))
    check(rec["backend"] == "nccl", f"parallel backend {rec['backend']}")
    t_dry = time.perf_counter() - t_phase
    log(f"parallel dry run: world {W} over {rec['backend']}, meshes "
        f"{rec['meshes']}, seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in rec["seconds"].items()))
    exact = W == 1
    dev = torch.device("cuda", 0)
    lr = cfg["lr"]

    # the train step without a plan: same init, same draws, same batch
    def plain_step(accum=1, **draws):
        dit, vae = _models(inp, cfg, dev, torch.bfloat16)
        opt = ScheduledAdamW(dit.parameters(), lambda _: lr)
        step = make_denoiser_train_step(dit, vae, opt, "flowmatching",
                                        cfg["train_total_step"],
                                        accum_steps=accum, device=dev)
        _build.reset_launch_counts()
        loss = step(_t(inp["train_x"], dev), _t(inp["train_emb"], dev),
                    **draws)
        torch.cuda.synchronize()
        return (loss, dit.state_dict(),
                {k: p.grad for k, p in dit.named_parameters()},
                dict(_build.launch_counts))

    def held(tag, what, loss, sd, grads):
        """The loss and the applied gradients at every W (AdamW's first
        update is about lr * sign(g), so only the gradients show a wrong
        scale or a missing all-reduce); the parameters where W = 1, bit
        for bit."""
        _bits(got[f"{tag}_loss"], float(loss), f"{what} loss", rtol=1e-2,
              expect_equal=exact)
        _rel_bits({k: got[f"{tag}_grad.{k}"] for k in grads},
                  {k: g.float().cpu().numpy() for k, g in grads.items()},
                  f"{what} gradients", PARALLEL_GRAD_RTOL,
                  expect_equal=exact)
        if exact:
            _bits(np.concatenate([got[f"{tag}_param.{k}"].ravel()
                                  for k in sd]),
                  np.concatenate([v.float().cpu().numpy().ravel()
                                  for v in sd.values()]),
                  f"{what} params after one AdamW step", expect_equal=True)

    loss, sd, grads, n_plain = plain_step(
        u=_t(inp["train_u"], dev), x_0=_t(inp["train_x0"], dev),
        coin=_t(inp["train_coin"], dev))
    held("train", "train step", loss, sd, grads)
    for accum, tag in ((1, "train_dp"), (2, "train_dp_accum2")):
        gen = torch.Generator(device=dev)
        gen.manual_seed(batch_seed(cfg["train_seed"], 0))
        held(tag, f"generator-drawn train step, accum_steps={accum}",
             *plain_step(accum, generator=gen)[:3])
    n_plan = rec["launches"]["train"]
    log(f"parallel train launches under the plan {n_plan}, without "
        f"{n_plain}")
    if exact:
        check(n_plan == n_plain and n_plan.get(BLOCK_KERNEL) == 4
              and n_plan.get(BLOCK_BWD_KERNEL) == 4,
              f"parallel train launches {n_plan} vs {n_plain}")

    # ring attention against full attention (f32, TF32 off)
    for name, key in (("ring", "ring_qkv"), ("ring_big", "ring_big_qkv")):
        q, k, v = (_t(a, dev) for a in inp[key])
        full = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5,
                             dim=-1) @ v
        _bits(got[f"{name}_out"], full.cpu().numpy(),
              f"{name} attention {tuple(q.shape)} vs full", atol=1e-4)
    check(bool(got["ring_big_refused"]),
          "ring_big geometry refused by fused_heads_block_q")

    # the pipeline against its stages in sequence
    from t2ms_tpu_torch.models.denoisers.dit import DiTBlock
    from t2ms_tpu_torch.parallel.dryrun import _sd
    Np = inp["pp_x"].shape[1]
    h = torch.cat([_t(inp["pp_x"], dev), _t(inp["pp_c"], dev)[:, None]],
                  1).requires_grad_(True)
    y, blocks = h, []
    for st in range(W):
        blk = DiTBlock(inp["pp_x"].shape[2], cfg["pp_heads"], 2.0).to(dev)
        blk.load_state_dict({a: b * (1.0 + 0.1 * st)
                             for a, b in _sd(inp, "pp_block.").items()})
        blocks.append(blk)
        y = torch.cat([blk(y[:, :Np], y[:, Np], torch.float32, "einsum"),
                       y[:, Np:]], 1)
    (y[:, :Np] * _t(inp["pp_cot"], dev)).sum().backward()
    _bits(got["pp_out"], y[:, :Np].detach().cpu().numpy(),
          f"pipeline of {W} DiT blocks, forward", atol=1e-4)
    _bits(got["pp_dx"], h.grad.cpu().numpy(), "pipeline input gradient",
          atol=1e-4)
    _bits(np.concatenate([got[f"pp_grad0.{k}"].ravel()
                          for k, _ in blocks[0].named_parameters()]),
          np.concatenate([p.grad.cpu().numpy().ravel()
                          for p in blocks[0].parameters()]),
          "pipeline stage-0 parameter gradients", atol=1e-4)

    # the sampler, the DiT gradients and the engine without a plan
    dit, vae = _models(inp, cfg, dev, torch.bfloat16)
    sampler = make_cfg_sampler(dit, vae, "flowmatching", cfg["samp_steps"],
                               cfg["cfg"], out_length=cfg["T"], device=dev)
    _build.reset_launch_counts()
    series = sampler(inp["samp_x"], inp["samp_emb"],
                     x_t0=_t(inp["samp_x0"], dev)).series
    torch.cuda.synchronize()
    n_plain = dict(_build.launch_counts)
    _bits(got["samp_series"], series.float().cpu().numpy(),
          f"sampler B={len(inp['samp_x'])} {cfg['serve_dtype']} "
          f"euler/{cfg['samp_steps']}",
          rtol=2e-2, expect_equal=exact)
    n_plan = rec["launches"]["sampler"]
    log(f"parallel sampler launches under the plan {n_plan}, without "
        f"{n_plain}")
    if exact:
        check(n_plan == n_plain
              and n_plan.get(STACK_KERNEL) == cfg["samp_steps"],
              f"parallel sampler launches {n_plan} vs {n_plain}")
    d32, _ = _models(inp, cfg, dev, torch.float32)
    x, tt, e = (_t(inp[k], dev) for k in ("grad_x", "grad_t", "grad_e"))
    torch.mean(torch.square(d32(x, tt, e) - x)).backward()
    _bits(np.concatenate([got[f"grad.{k}"].ravel()
                          for k, _ in d32.named_parameters()]),
          np.concatenate([p.grad.cpu().numpy().ravel()
                          for p in d32.parameters()]),
          "data-parallel DiT gradients (f32)", rtol=1e-4)
    emb = inp["eng_emb"]
    reqs = [(emb[i], cfg["T"], float(inp["eng_cfg"][i]),
             int(inp["eng_seed"][i])) for i in range(len(emb))]
    dit, vae = _models(inp, cfg, dev, torch.bfloat16)
    _build.reset_launch_counts()
    with ServingEngine(dit, vae, total_step=cfg["eng_steps"],
                       out_lengths=(cfg["T"],), batch_tiers=(len(emb),),
                       max_wait_ms=500.0, text_emb_dim=emb.shape[1],
                       device=dev) as eng:
        served = np.stack([r.series for r in eng.generate(reqs)])
    n_plain = dict(_build.launch_counts)
    _bits(got["eng_series"], served, f"engine, {len(reqs)} requests at tier "
          f"{len(emb)}, row for row", rtol=2e-2, expect_equal=exact)
    n_plan = rec["launches"]["engine"]
    log(f"parallel engine launches under the plan {n_plan}, without "
        f"{n_plain}")
    if exact:
        check(n_plan == n_plain
              and n_plan.get(STACK_KERNEL) == cfg["eng_steps"],
              f"parallel engine launches {n_plan} vs {n_plain}")
    log(f"parallel phase: world {W}, dry run {t_dry:.2f} s, "
        f"{time.perf_counter() - t_phase:.2f} s wall")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import (
        FLASH_KERNEL, FUSED_HEADS_BWD_KERNEL, FUSED_HEADS_KERNEL,
        FUSED_HEADS_LEAN_KERNEL, FUSED_HEADS_LEAN_TWO_PASS_KERNEL,
        FUSED_HEADS_STATS_KERNEL, FUSED_HEADS_TWO_PASS_KERNEL, PACKED_KERNEL,
        VMEM_KERNEL)
    from t2ms_tpu_torch.ops.dit_block import (BLOCK_BWD_KERNEL, BLOCK_KERNEL,
                                              MOD_LN_BWD_KERNEL,
                                              MOD_LN_KERNEL,
                                              RES_MOD_LN_BWD_KERNEL,
                                              RES_MOD_LN_KERNEL, SPLIT_KERNEL,
                                              STACK_KERNEL)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {secs} ({time.perf_counter() - t0:.2f} s wall)")
    log_attention_resources()
    log_stack_resources()
    log_block_bwd_resources()
    log_split_resources()
    log_mod_ln_resources()

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    k = kernel_phase(gen)
    dit, vae = build_models(args.seed)
    launches = offline_phase(dit, vae, gen)
    server_phase(dit, vae, args.seed)
    blk = block_phase(gen)[torch.bfloat16]
    t_launches = train_phase(dit, vae, gen)
    spl = split_phase(gen)[torch.bfloat16]
    sc_dit, sc_vae = build_scaled_models(args.seed)
    sc_launches = scaled_offline_phase(sc_dit, sc_vae, gen)
    scaled_server_phase(sc_dit, sc_vae, args.seed)
    mln = mod_ln_phase(gen)[torch.bfloat16]
    fh = fused_heads_phase(gen)[torch.bfloat16]
    tr_launches = scaled_train_phase(sc_dit, sc_vae, gen)
    rln = res_mod_ln_phase(gen)["scaled"]
    tp = two_pass_phase(gen)[torch.bfloat16]
    ls_dit, ls_vae = build_long_models(args.seed)
    long_offline_phase(ls_dit, ls_vae, gen)
    ls_launches = long_train_phase(ls_dit, ls_vae, gen)
    ln = lean_kernel_phase(gen)
    lsc_launches = lean_scaled_train_phase(sc_dit, sc_vae, gen)
    lls_launches = lean_long_train_phase(ls_dit, ls_vae, gen)
    del sc_dit, sc_vae, ls_dit, ls_vae
    torch.cuda.empty_cache()
    sh = split_heads_phase(gen)
    xl_dit_, xl_vae = build_xl_models(args.seed)
    xl_launches = xl_offline_phase(xl_dit_, xl_vae, gen)
    xl_train_phase(xl_dit_, xl_vae, gen)
    del xl_dit_, xl_vae
    torch.cuda.empty_cache()
    pk_launches = packed_offline_phase(dit, vae, gen)
    explicit_impl_phase(dit, vae, gen)
    ddpm_offline_phase(dit, vae, gen, "euler")
    ddpm_offline_phase(dit, vae, gen, "ddim")
    ddpm_train_phase(dit, vae, gen)
    ddpm_server_phase(dit, vae, args.seed)
    del dit, vae
    torch.cuda.empty_cache()
    cli_phase(args.seed, smi)
    motion_phase(args.seed, gen)
    parallel_phase(args.seed)

    bf = k[torch.bfloat16]
    entry = lambda name, src, rep, n, r: {
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
        "plain_ms": r["plain"], "bound_ms": r["bound"],
        "bound_by": r["by"], "library_ms": r.get("library")}
    csrc = "t2ms_tpu_torch/ops/csrc/"
    table = {"kernels": [
        entry(STACK_KERNEL, "t2ms_tpu_torch/ops/csrc/dit_stack.cu",
              "t2ms_tpu/ops/dit_block.py:218",
              launches.get(STACK_KERNEL, 0), bf),
        entry(BLOCK_KERNEL, "t2ms_tpu_torch/ops/csrc/dit_stack.cu",
              "t2ms_tpu/ops/dit_block.py:188",
              t_launches.get(BLOCK_KERNEL, 0), blk["fwd"]),
        entry(BLOCK_BWD_KERNEL, "t2ms_tpu_torch/ops/csrc/dit_block_bwd.cu",
              "t2ms_tpu/ops/dit_block.py:348",
              t_launches.get(BLOCK_BWD_KERNEL, 0), blk["bwd"]),
        entry(SPLIT_KERNEL, "t2ms_tpu_torch/ops/csrc/dit_split.cu",
              "t2ms_tpu/ops/dit_block.py:460",
              sc_launches.get(SPLIT_KERNEL, 0), spl),
        entry(MOD_LN_KERNEL, csrc + "mod_ln.cu",
              "t2ms_tpu/ops/dit_block.py:580",
              tr_launches.get(MOD_LN_KERNEL, 0), mln["fwd"]),
        entry(MOD_LN_BWD_KERNEL, csrc + "mod_ln.cu",
              "t2ms_tpu/ops/dit_block.py:624",
              tr_launches.get(MOD_LN_BWD_KERNEL, 0), mln["bwd"]),
        entry(FUSED_HEADS_KERNEL, csrc + "fused_heads.cu",
              "t2ms_tpu/ops/attention.py:373",
              tr_launches.get(FUSED_HEADS_KERNEL, 0), fh["fwd"]),
        entry(FUSED_HEADS_BWD_KERNEL, csrc + "fused_heads.cu",
              "t2ms_tpu/ops/attention.py:1275",
              tr_launches.get(FUSED_HEADS_BWD_KERNEL, 0), fh["bwd"]),
        entry(RES_MOD_LN_KERNEL, csrc + "mod_ln.cu",
              "t2ms_tpu/ops/dit_block.py:721",
              tr_launches.get(RES_MOD_LN_KERNEL, 0), rln["fwd"]),
        entry(RES_MOD_LN_BWD_KERNEL, csrc + "mod_ln.cu",
              "t2ms_tpu/ops/dit_block.py:772",
              tr_launches.get(RES_MOD_LN_BWD_KERNEL, 0), rln["bwd"]),
        entry(FUSED_HEADS_TWO_PASS_KERNEL, csrc + "fused_heads.cu",
              "t2ms_tpu/ops/attention.py:816",
              ls_launches.get(FUSED_HEADS_TWO_PASS_KERNEL, 0), tp),
        entry(FUSED_HEADS_STATS_KERNEL, csrc + "fused_heads.cu",
              "t2ms_tpu/ops/attention.py:454",
              lsc_launches.get(FUSED_HEADS_STATS_KERNEL, 0),
              ln["scaled"]["fwd"]),
        entry(FUSED_HEADS_LEAN_KERNEL, csrc + "fused_heads.cu",
              "t2ms_tpu/ops/attention.py:984",
              lsc_launches.get(FUSED_HEADS_LEAN_KERNEL, 0),
              ln["scaled"]["bwd"]),
        entry(FUSED_HEADS_LEAN_TWO_PASS_KERNEL, csrc + "fused_heads.cu",
              "t2ms_tpu/ops/attention.py:1152",
              lls_launches.get(FUSED_HEADS_LEAN_TWO_PASS_KERNEL, 0),
              ln["long"]["bwd"]),
        entry(FLASH_KERNEL, csrc + "split_heads.cu",
              "t2ms_tpu/ops/attention.py:90",
              xl_launches.get(FLASH_KERNEL, 0),
              sh[("flash_8192_serve", torch.bfloat16)]),
        entry(VMEM_KERNEL, csrc + "split_heads.cu",
              "t2ms_tpu/ops/attention.py:147",
              sh["vmem_launches"].get(VMEM_KERNEL, 0),
              sh[("vmem_480", torch.bfloat16)]),
        entry(PACKED_KERNEL, csrc + "split_heads.cu",
              "t2ms_tpu/ops/attention.py:196",
              pk_launches.get(PACKED_KERNEL, 0),
              sh[("packed_480_serve", torch.bfloat16)])],
        "to_port": []}   # every TPU kernel has its Hopper counterpart
    print(smi, flush=True)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
