"""On-card smoke of the PyTorch/CUDA port (``t2ms_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from ``t2ms_tpu_torch/ops/csrc`` and then,
failing with a non-zero exit on any error:

1. prints the card, its power limit, torch / CUDA versions and the TF32
   flags (both set off, so f32 products and convs are full f32);
2. builds every kernel (one nvcc per source, started together) and logs
   ptxas's registers, stack, spills and shared memory of the bf16
   attention backward's wgmma kernels (``heads_bwd_q_kernel``,
   ``heads_bwd_kv_kernel``, csrc/heads_bwd.cuh, at each head width and
   recipe, as built into csrc/fused_heads.cu and, the block recipe, into
   csrc/dit_block_bwd.cu), checked to spill nothing and to draw no ptxas
   C7512, and of the stack's
   persistent wgmma row kernels (csrc/dit_layer.cuh:
   ``modln_qkv_tc_kernel<D>``, ``proj_mlp_tc_kernel<D, MLP>`` at D 64, 128
   and 192, as built into csrc/dit_stack.cu and csrc/dit_block_bwd.cu),
   checked to spill nothing and to draw no C7512, and of the
   bf16 block backward's own
   kernels (csrc/dit_block_bwd.cu: the wgmma row kernels
   ``mlp_bwd_tc_kernel<D>`` and ``qkv_bwd_tc_kernel<D>`` at D 64 and 128,
   checked the same way, ``attn_out_bwd_tc_kernel``, ``wgrad_tc_kernel``),
   and of the split block's wgmma GEMMs as built into csrc/dit_split.cu
   (csrc/split_tc.cuh: ``split_rows_tc_kernel<D, MODE>`` at D 128, 256
   and 512; csrc/wg_gemm.cuh:
   ``wg_gemm_kernel`` on each route), checked to spill nothing and to draw
   no ptxas C7512 ("wgmma serialized"), and of the bf16 LayerNorm
   kernels on 16-byte chunks (csrc/mod_ln.cu: #8's
   ``res_mod_ln_bwd_vec_kernel``, its spills checked, #7's
   ``res_mod_ln_fwd_vec_kernel``, #6's ``mod_ln_bwd_vec_kernel`` and #5's
   ``mod_ln_fwd_vec_kernel`` at each lane split);
   every ``heads_fwd_kernel`` instance of fused_heads.cu, dit_stack.cu,
   dit_split.cu and dit_block_bwd.cu checked the same way, with its SASS
   instructions by pipe (``cuobjdump -sass``); then the attention
   forward alone at each path's call (``ATTN_FWD_SHAPES``: #1, #2/#3's
   recompute, the motion calls, #4/#9, #10, 4096 tokens, head widths 16
   and 128), o against the twin, with the device time by profiler,
   TFLOP/s, share of its bound, the exponent unit's floor and SDPA's
   device time (``--attention_forward`` runs only this section, and with
   ``--root DIR`` on another checkout's package: the parent and the change
   in one call); then the attention backward alone at each path's call
   (``ATTN_BWD_SHAPES``: #3 at the flagship and motion calls, #11, #12,
   #13, #14, head widths 16 and 128), dq, dk, dv against the twin, with the
   device time of both kernels by profiler, TFLOP/s, share of its bound,
   the exponent floor and SDPA's forward + backward minus forward
   (``--attention_backward [--root DIR]`` runs only this section); then
   the stack's two row kernels at each path's call through the public
   entries (``ROW_SHAPES``: #1 at the CFG call, #2 and #3's recompute at
   the train and motion calls, D 192 with the weights streamed, a ragged
   call of one tile), the forwards' outputs against the twin, each
   kernel's device time by profiler, its operations and bytes, the share
   of its bound and cuBLAS over its products; then the block backward's
   four row kernels at #3's calls (``ROW_BWD_SHAPES``: the flagship and
   motion train calls, hidden 512 with the MLP half's weights streamed, a
   ragged call), the MLP-half and qkv-half kernels alone against their
   twins, each kernel's device time, bytes, share of its bound and cuBLAS
   over its products (``--row_gemms [--root DIR]`` runs these two sections
   only); the split block's GEMM stages alone at #4's calls
   (``SPLIT_SHAPES``: the scaled CFG call, one server request's 2048 rows,
   D 1024 / hidden 4096, a ragged B=3 x N=17): qkv, proj and the MLP half
   against their twins, each stage's device time by kernel, operations,
   bytes, share of its bound and cuBLAS over its products, and the whole
   block's device time by kernel (``--split_gemms [--root DIR]`` runs this
   section only); the LayerNorm kernels #5-#8 alone at the scaled and the
   long-series train steps' calls (``MOD_LN_SHAPES``, bf16, the
   modulation as the flax path's views of one (B, 6, D) tensor, the long
   call's operands rotated past the L2), their outputs against the twins,
   each one's device time by kernel (its own, ``dmod_reduce_kernel``, the
   wrapper's casts), CUDA-event ms of one synchronised call and a launch
   in a run of 50, host us to enqueue a call, bytes, bound, share and
   PyTorch elementwise passes moving as many tensors (``--mod_ln [--root
   DIR]`` runs this section only, after the chunk kernels' ptxas
   lines);
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
   call checked to run on ``split_rows_tc_kernel`` for qkv, proj and fc1,
   ``wg_gemm_kernel`` for fc2, and on neither ``wg_gemm_kernel``'s qkv or
   fc1 instance nor a bf16 ``gemm_kernel``), each stage alone (through
   ``dit_split_gemm_bf16``; the MLP half as fc1 then fc2): device time,
   TFLOP/s and share of its bound, and torch SDPA over the block's
   attention and cuBLAS over its four dense products as yardsticks; the
   route at each width, at the scaled call's rows and at one server
   request's;
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
   d_model 512) and the long-series call (B=8, N=4096, d 128) in bf16,
   mod2 the flax path's view of a random (B, 6, D) modulation, against the
   twin and autograd over it, again in f32 at a small batch; CUDA-event
   times, the twin's times and the bounds, and in bf16 each one's device
   time by kernel, both directions checked to run on the 16-byte-chunk
   kernels with no copy or cast beside them;
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
   bf16, random x and h, gm3 the flax path's view of a random (B, 6, D)
   modulation, against the twin and autograd over it, again in f32 at a
   small batch; CUDA-event times, the twin's times and the bounds; in bf16
   each one's device time by kernel (its own, the ordered dmod sum, the
   wrapper's casts), both checked to run on the 16-byte-chunk kernels;
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
33. quality gate phase: ``cli.quality_gate.main`` in this process on the
   t2s track (B=256, 800 LA-VAE steps, 1500 DiT steps on the block
   kernels, euler/100 at cfg 7 on the stack, C-FID): the JSON's keys
   (JAX's, the MSE gate named ``mse_under_half_noise_floor``), every
   value finite, the noise floor equal to the JAX script's on the CPU
   within 1e-12, the exit code against the gates, 4 + 4 block launches
   a step and 100 stack launches; MSE, C-FID, the VAE and denoiser
   steps/s, the sample-and-score time and the phase's wall time (green
   is not required at 1500 steps);
34. parallel phase: ``parallel.dryrun.dryrun_multichip`` at full width on
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
import shutil
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
    missing, and now and then all of them: a window that recorded no
    kernel is profiled again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    totals = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if (us <= 0 or getattr(ev, "device_type", None) != DeviceType.CUDA
                    or "spin_kernel" in ev.key):
                continue
            t, n = totals.get(ev.key, (0.0, 0))
            totals[ev.key] = (t + us / 1e3, n + ev.count)
        if totals:
            break
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
    "transpose_kernel", "mlp_bwd_tc_kernel", "attn_out_bwd_tc_kernel",
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

# the CUDA kernels of one bf16 fused_dit_block_split call at the scaled DiT's
# width (D 512) and 8 heads of 64, by their names in the profile:
# split_rows_tc_kernel<512, 0> modLN+qkv, <512, 1> proj with its gated
# residual and <512, 2> modLN+fc1+GELU (csrc/split_tc.cuh, persistent),
# wg_gemm_kernel<1, 2, 2, 128> fc2 with its gated residual
# (csrc/wg_gemm.cuh, 128-row blocks), heads_fwd_kernel<64> (attn_heads.cuh)
# the attention. Neither wg_gemm_kernel's qkv <0, 0, 2, 128> or fc1 <0, 1,
# 2, 128> nor the first version's WMMA gemm_kernel.
SPLIT_ATTN = "heads_fwd_kernel<64>"
SPLIT_GEMMS = ("split_rows_tc_kernel<512, 0>", "split_rows_tc_kernel<512, 1>",
               "split_rows_tc_kernel<512, 2>", "wg_gemm_kernel<1, 2, 2, 128>")
SPLIT_PARTS = (SPLIT_GEMMS[0], SPLIT_ATTN) + SPLIT_GEMMS[1:]
SPLIT_ABSENT = ("gemm_kernel<__nv_bfloat16", "wg_gemm_kernel<0, 0, 2, 128>",
                "wg_gemm_kernel<0, 1, 2, 128>")


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
                "split_rows_tc_kernel<512, 0> modLN+qkv, <512, 1> proj "
                "with its gated residual, <512, 2> modLN+fc1+GELU, "
                "wg_gemm_kernel<1, 2> fc2 with its gated residual): "
                + fmt_split(split))
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
    for rows, want in ((2 * SC_B * SC_N, "persistent"), (2 * SC_N, "wide")):
        routes = {d: split_gemm_route(d, rows)
                  for d in (128, 512, 640, 1024, 1536)}
        log(f"split bf16 route by D at {rows} rows (persistent: qkv, proj "
            f"and fc1 on split_tc.cuh; else the LayerNorm GEMMs' wide: "
            f"128-row blocks, narrow: 64-row): {routes}")
        check(routes[SC_D] == want, f"split route at {rows} rows "
              f"{routes[SC_D]}")
    return out


def split_gemm_stages(rows, D, hidden, reps: int = 3):
    """Each bf16 stage of the split block alone at ``rows`` rows (the
    block's own kernels through ``dit_split_gemm_bf16``; the MLP half as
    fc1 then fc2): device time (torch.profiler),
    TFLOP/s and share of its bound (``split_stage_work``: the larger of its
    operations at 989 TFLOP/s and its bytes, each input and the output
    once, at 3.35 TB/s). Inputs from their own generator."""
    from t2ms_tpu_torch.ops import dit_block as db
    g = torch.Generator(device="cuda").manual_seed(17)
    f = lambda *s_: torch.randn(*s_, generator=g, device="cuda")
    bf = lambda t: t.to(torch.bfloat16)
    w = lambda i, o_: bf(f(i, o_) / i ** 0.5)
    B = rows // SC_N
    x, o, mod = bf(f(B, SC_N, D)), bf(f(B, SC_N, D)), 0.3 * f(B, 6, D)
    ws = [w(D, 3 * D), bf(0.1 * f(3 * D)), w(D, D), bf(0.1 * f(D)),
          w(D, hidden), bf(0.1 * f(hidden)), w(hidden, D), bf(0.1 * f(D))]
    out = {}
    for stage, run in split_stage_calls(db, x, o, mod, ws).items():
        with torch.no_grad():
            times = device_ms_all(run, reps)
        ms = sum(times.values())
        flops, nbytes = split_stage_work(stage, B, SC_N, D, hidden)
        t_ops = flops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        if ms:
            log(f"split bf16 stage {stage} ({rows} rows, D={D}, hidden="
                f"{hidden}): device {ms:.4f} ms ({', '.join(sorted(times))}),"
                f" {flops / ms / 1e9:.2f} TFLOP/s, bound {bound:.4f} ms "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
                f"{bound / ms:.2%} of its bound")
        else:
            log(f"split bf16 stage {stage}: not measured (no device time "
                f"recorded)")
        out[stage] = dict(ms=ms, flops=flops, bound=bound)
    total = sum(r["ms"] for r in out.values())
    fl = sum(r["flops"] for r in out.values())
    if total:
        log(f"split bf16 GEMM stages alone: {total:.4f} ms of device time, "
            f"{fl / total / 1e9:.2f} TFLOP/s over {fl / 1e9:.2f} GFLOP")
    return out


# The split block's GEMM stages at #4's calls, for --split_gemms: (what, B,
# N, D, heads, hidden). The scaled sampler's CFG call (2B=32 x 1024
# tokens), one server request's CFG batch (2B=2), D 1024 / hidden 4096 / 16
# heads on whichever route takes it, and a ragged B=3 x N=17.
SPLIT_SHAPES = (
    ("scaled CFG #4 (2B=32)", 32, 1024, 512, 8, 2048),
    ("server request #4 (2B=2)", 2, 1024, 512, 8, 2048),
    ("D 1024 hidden 4096 #4 (B=4)", 4, 1024, 1024, 16, 4096),
    ("ragged #4 (B=3, N=17)", 3, 17, 512, 8, 2048),
)
# of max|twin|: one stage's output a rounding flip after f32 sums in another
# order; the MLP half's flips in h1 feed fc2 (the block-level bf16 bound)
SPLIT_STAGE_TOL = {"qkv": 1e-2, "proj": 1e-2, "mlp": 3e-2}


def split_stage_work(stage, B, N, D, hidden):
    """(operations, bytes) of one stage of the split block as a function:
    its products, each input read once (a, the weights and biases, the f32
    adaLN rows it reads, the residual) and its output written once; the MLP
    half's h1 is internal to it and not counted."""
    rows, bf = B * N, 2
    if stage == "qkv":
        return (2 * rows * D * 3 * D,
                bf * (rows * D + 3 * D * D + 3 * D + rows * 3 * D)
                + 4 * B * 2 * D)
    if stage == "proj":
        return 2 * rows * D * D, bf * (3 * rows * D + D * D + D) + 4 * B * D
    # the MLP half; h1 between fc1 and fc2 is not counted
    return (4 * rows * D * hidden,
            bf * (2 * rows * D + 2 * D * hidden + hidden + D) + 4 * B * 3 * D)


def split_stage_calls(db, x, o, mod, ws):
    """stage -> a function launching that stage of the split block alone
    through the package ``db`` (ops.dit_block of this tree or another):
    qkv on x, proj on o with x as the residual, the MLP half on x as y1 as
    the block runs it (its fc1 and fc2 stages in turn)."""
    wqkv, bqkv, wproj, bproj, w1, b1, w2, b2 = ws
    g = db._launch_split_gemm
    calls = {"qkv": lambda: g(x, mod, wqkv, bqkv, None, "qkv"),
             "proj": lambda: g(o, mod, wproj, bproj, x, "proj"),
             "mlp": lambda: g(g(x, mod, w1, b1, None, "fc1"), mod, w2, b2, x,
                              "fc2")}
    return calls


def split_stage_cublas_ms(stage, rows, D, hidden):
    """Device time of torch.matmul (cuBLAS) over one stage's products alone
    in bf16 (yardstick only: no LayerNorm, bias, GELU or residual): qkv
    a @ wqkv, proj a @ wproj, the MLP half z @ w1 and h @ w2. Its inputs
    come from a generator of its own."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
    a = f(rows, D)
    if stage.startswith("mlp"):
        w1, w2, h = f(D, hidden), f(hidden, D), f(rows, hidden)
        fn = lambda: (torch.matmul(a, w1), torch.matmul(h, w2))
    else:
        w = f(D, 3 * D if stage == "qkv" else D)
        fn = lambda: torch.matmul(a, w)
    times = device_ms_all(fn)
    return sum(times.values()) if times else None


def split_gemm_phase(gen, check_twin=True):
    """The split block's GEMM stages at every call of SPLIT_SHAPES through
    the stage launchers: each stage's output against its twin on this tree
    (SPLIT_STAGE_TOL * max|twin|), its device time by torch.profiler, its
    operations and bytes (split_stage_work), the share of its bound and
    cuBLAS over its products; then the whole block's device time by
    kernel. Returns {what: {stage: row, "block": {kernel: ms}}}."""
    from t2ms_tpu_torch.ops import dit_block as db
    out = {}
    for what, B, N, D, H, hidden in SPLIT_SHAPES:
        f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
        bf = lambda t: t.to(torch.bfloat16)
        w = lambda i, o_: bf(f(i, o_) / i ** 0.5)
        x, o, mod = bf(f(B, N, D)), bf(f(B, N, D)), 0.3 * f(B, 6, D)
        ws = [w(D, 3 * D), bf(0.1 * f(3 * D)), w(D, D), bf(0.1 * f(D)),
              w(D, hidden), bf(0.1 * f(hidden)), w(hidden, D),
              bf(0.1 * f(D))]
        calls = split_stage_calls(db, x, o, mod, ws)
        rows = {}
        with torch.no_grad():
            if check_twin:
                twins = {
                    "qkv": lambda: db.split_gemm_reference(
                        x, mod, ws[0], ws[1], None, "qkv"),
                    "proj": lambda: db.split_gemm_reference(
                        o, mod, ws[2], ws[3], x, "proj"),
                    "mlp": lambda: db.split_gemm_reference(
                        db.split_gemm_reference(x, mod, ws[4], ws[5], None,
                                                "fc1"), mod, ws[6], ws[7], x,
                        "fc2")}
                for stage, call in calls.items():
                    _check_err(f"split stage {what} {stage}", call(),
                               twins[stage](), SPLIT_STAGE_TOL[stage])
                torch.cuda.synchronize()
            for stage, call in calls.items():
                times = device_ms_all(call)
                ms = sum(times.values()) if times else None
                fl, nb = split_stage_work(stage, B, N, D, hidden)
                t_ops = fl / H100_BF16_FLOPS * 1e3
                t_bytes = nb / H100_BYTES * 1e3
                bound = max(t_ops, t_bytes)
                lib = split_stage_cublas_ms(stage, B * N, D, hidden)
                rows[stage] = dict(
                    ms=ms, kernels=times, gflop=fl / 1e9, mb=nb / 1e6,
                    bound=bound,
                    by="operations" if t_ops >= t_bytes else "bytes",
                    share=bound / ms if ms else None, cublas=lib)
                lib_s = "not measured" if lib is None else f"{lib:.4f} ms"
                if ms:
                    log(f"split stage {what} N={N} D={D} hidden={hidden}: "
                        f"{stage} device {ms:.4f} ms ({fmt_split(times)}), "
                        f"{fl / 1e9:.2f} GFLOP, {nb / 1e6:.2f} MB, bound "
                        f"{bound:.4f} ms ({rows[stage]['by']}), "
                        f"{bound / ms:.2%} of it, {fl / ms / 1e9:.2f} "
                        f"TFLOP/s, cuBLAS over its products {lib_s}")
                else:
                    log(f"split stage {what}: {stage} device time not "
                        f"measured (no device time recorded)")
            block = device_ms_all(
                lambda: db.fused_dit_block_split(x, mod, *ws, H))
            ev = cuda_ms(lambda: db.fused_dit_block_split(x, mod, *ws, H))
        rows["block"] = dict(kernels=block, ms=ev,
                             device=sum(block.values()) if block else None)
        log(f"split block {what}: {ev:.4f} ms by events, device by kernel: "
            f"{fmt_split(block)}")
        out[what] = rows
        del x, o, mod, ws
        torch.cuda.empty_cache()
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
MOD_LN_PARTS = ("mod_ln_fwd_vec_kernel", "mod_ln_fwd_kernel",
                "mod_ln_bwd_vec_kernel", "mod_ln_bwd_kernel",
                "res_mod_ln_fwd_vec_kernel", "res_mod_ln_fwd_kernel",
                "res_mod_ln_bwd_vec_kernel", "res_mod_ln_bwd_kernel",
                "dmod_reduce_kernel")
# the lane-strided #5, #6 and #7, which a bf16 step at D % 8 == 0 must not
# run
OLD_LN_KERNELS = ("mod_ln_fwd_kernel", "mod_ln_bwd_kernel",
                  "res_mod_ln_fwd_kernel")
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
    forward row kernels (csrc/dit_layer.cuh: ``modln_qkv_tc_kernel<D>``,
    ``proj_mlp_tc_kernel<D, MLP>`` with and without the MLP half, at D 64,
    128 and 192) as built into csrc/dit_stack.cu and csrc/dit_block_bwd.cu,
    with their dynamic shared memory at hidden 2D (``dit_stack_smem``);
    checked to spill nothing and to draw no ptxas C7512 ("wgmma
    serialized"); their attention, ``check_fwd_resources``."""
    from t2ms_tpu_torch.ops import _build
    seen = 0
    for name in ("dit_stack", "dit_block_bwd"):
        text = _build.build_logs.get(name)
        if not text:
            log(f"row kernel resources: not measured ({name}.cu was not "
                "built in this process)")
            continue
        serial = [l_ for l_ in text.splitlines() if "C7512" in l_ and
                  ("modln_qkv_tc_kernel" in l_ or "proj_mlp_tc_kernel" in l_)]
        check(not serial, f"ptxas serialized a row kernel's wgmma in "
              f"{name}.cu (C7512): " + "; ".join(serial))
        lib = _build.load("dit_stack")
        for chunk in text.split("Compiling entry function")[1:]:
            m = re.search(r"modln_qkv_tc_kernelILi(\d+)E|"
                          r"proj_mlp_tc_kernelILi(\d+)ELb([01])E",
                          chunk.split("\n")[0])
            if m is None:
                continue
            if m.group(1):
                D = int(m.group(1))
                what = f"modln_qkv_tc_kernel<{D}>"
                smem = lib.dit_stack_smem(0, D, 2 * D, D // 32)
            else:
                D, mlp = int(m.group(2)), m.group(3) == "1"
                what = f"proj_mlp_tc_kernel<{D}, {'true' if mlp else 'false'}>"
                smem = lib.dit_stack_smem(2 if mlp else 3, D, 2 * D, D // 32)
            _log_resources(f"row kernel resources {what} in {name}.cu "
                           f"(hidden={2 * D})", chunk, smem)
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill", chunk)]
            check(not any(spills), f"{what} in {name}.cu spills {spills}")
            seen += 1
    log(f"row kernel resources: {seen} instances, no spills and no C7512")


def log_block_bwd_resources():
    """ptxas's registers, stack, spills and static shared memory of the bf16
    block backward's own kernels as built into csrc/dit_block_bwd.cu: the
    wgmma row kernels ``mlp_bwd_tc_kernel<D>`` and ``qkv_bwd_tc_kernel<D>``
    at D 64 and 128, checked to spill nothing and to draw no ptxas C7512
    ("wgmma serialized"), and ``attn_out_bwd_tc_kernel`` and
    ``wgrad_tc_kernel``, with their dynamic shared memory at hidden 2D
    (``dit_block_bwd_smem``); its attention VJP's, ``check_bwd_resources``."""
    from t2ms_tpu_torch.ops import _build
    text = _build.build_logs.get("dit_block_bwd")
    if not text:
        log("block backward kernel resources: not measured (dit_block_bwd.cu "
            "was not built in this process)")
        return
    lib = _build.load("dit_block_bwd")
    rows = ("mlp_bwd_tc_kernel", "attn_out_bwd_tc_kernel",
            "qkv_bwd_tc_kernel", "wgrad_tc_kernel")
    serial = [l_ for l_ in text.splitlines() if "C7512" in l_ and
              ("mlp_bwd_tc_kernel" in l_ or "qkv_bwd_tc_kernel" in l_)]
    check(not serial, "ptxas serialized a backward row kernel's wgmma "
          "(C7512): " + "; ".join(serial))
    seen = 0
    for chunk in text.split("Compiling entry function")[1:]:
        head = chunk.split("\n")[0]
        m = re.search(r"(mlp_bwd_tc_kernel|attn_out_bwd_tc_kernel|"
                      r"qkv_bwd_tc_kernel|wgrad_tc_kernel)(?:ILi(\d+)E)?",
                      head)
        if m is None:
            continue
        what, D = m.group(1), int(m.group(2) or D_MODEL)
        smem = lib.dit_block_bwd_smem(rows.index(what), D, 2 * D,
                                      D // (D_MODEL // HEADS))
        if m.group(2):
            what = f"{what}<{D}>"
        _log_resources(f"block backward kernel resources {what} "
                       f"(D={D}, hidden={2 * D})", chunk, smem)
        if m.group(2):
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill",
                                                 chunk)]
            check(not any(spills), f"{what} in dit_block_bwd.cu spills "
                  f"{spills}")
            seen += 1
    check(seen == 4, f"backward row kernel instances: {seen} of 4")
    log(f"backward row kernel resources: {seen} instances, no spills and no "
        "C7512")


def log_split_resources():
    """ptxas's registers, stack, spills and static shared memory of the
    split block's kernels as built into csrc/dit_split.cu: the persistent
    wgmma kernel of csrc/split_tc.cuh (``split_rows_tc_kernel<D, MODE>`` at
    D 128, 256 and 512) and csrc/wg_gemm.cuh's ``wg_gemm_kernel`` (the
    LayerNorm GEMMs on the 128-row and 64-row routes, the streamed one),
    with their dynamic shared memory (``dit_split_smem``: the persistent
    kernel at its D, wg_gemm_kernel's 128-row route at D 384, its 64-row
    one at D 1024); each checked to spill nothing and to draw no ptxas
    C7512 ("wgmma serialized")."""
    from t2ms_tpu_torch.ops import _build
    text = _build.build_logs.get("dit_split")
    if not text:
        log("split kernel resources: not measured (dit_split.cu was not "
            "built in this process)")
        return
    lib = _build.load("dit_split")
    seen = {"wg_gemm_kernel": 0, "split_rows_tc_kernel": 0}
    for chunk in text.split("Compiling entry function")[1:]:
        m = re.search(r"wg_gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      chunk)
        r = re.search(r"split_rows_tc_kernelILi(\d+)ELi([012])E", chunk)
        if m is not None:
            pro, epi, wg, bn = (int(v) for v in m.groups())
            stage = 1 if pro else (0 if epi == 0 else 2)
            K = 384 if wg == 2 else 1024
            name = f"wg_gemm_kernel<{pro}, {epi}, {wg}, {bn}> (K={K})"
            kind = "wg_gemm_kernel"
        elif r is not None:
            K, stage = (int(v) for v in r.groups())
            name = f"split_rows_tc_kernel<{K}, {stage}>"
            kind = "split_rows_tc_kernel"
        else:
            continue
        _log_resources(f"split kernel resources {name}", chunk,
                       lib.dit_split_smem(stage, K))
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", chunk)]
        check(not any(spills), f"{name} spills {spills}")
        seen[kind] += 1
    check(seen == {"wg_gemm_kernel": 5, "split_rows_tc_kernel": 9},
          f"split kernel instances in the build log: {seen}")
    check("C7512" not in text, "ptxas serialized a wgmma in dit_split.cu "
          "(C7512): " + "; ".join(l_ for l_ in text.splitlines()
                                   if "C7512" in l_))
    log("split kernel resources: no spills and no C7512 in the split "
        "block's wgmma kernels")


def log_mod_ln_resources():
    """ptxas's registers, stack, spills and static shared memory of the
    bf16 kernels on 16-byte chunks (csrc/mod_ln.cu's
    ``mod_ln_fwd_vec_kernel<CPL, G, M>`` (#5), ``mod_ln_bwd_vec_kernel``
    (#6), ``res_mod_ln_fwd_vec_kernel`` (#7) and
    ``res_mod_ln_bwd_vec_kernel`` (#8), CPL chunks a lane in groups of G
    lanes: D 128 takes <1, 16>, D 512 <2, 32>; M the modulation's type),
    with their dynamic shared memory at the widest D each serves, 8 CPL G
    (the backwards' 4 x W x D f32 buffer). #8's spills are checked against
    its line before it read gm3 in place: 40 B at D 512, 20 B at D 1024
    (stores and loads each)."""
    from t2ms_tpu_torch.ops import _build
    text = _build.build_logs.get("mod_ln")
    if not text:
        log("mod_ln kernel resources: not measured (mod_ln.cu was not "
            "built in this process)")
        return
    sums = {"res_mod_ln_bwd_vec_kernel": 3, "res_mod_ln_fwd_vec_kernel": 0,
            "mod_ln_bwd_vec_kernel": 2, "mod_ln_fwd_vec_kernel": 0}
    spill_cap = {512: 40, 1024: 20}   # #8's at those D
    over = []
    for chunk in text.split("Compiling entry function")[1:]:
        m = re.search(r"\d((?:res_)?mod_ln_(?:fwd|bwd)_vec_kernel)ILi(\d+)ELi"
                      r"(\d+)E(f|13__nv_bfloat16)?E", chunk)
        if m:
            kern, cpl, g = m[1], int(m[2]), int(m[3])
            mt = {"f": ", f32", None: ""}.get(m[4], ", bf16")
            _log_resources(f"mod_ln kernel resources {kern}<{cpl}, {g}{mt}> "
                           f"(D={8 * cpl * g})", chunk,
                           4 * sums[kern] * 4 * 8 * cpl * g)
            cap = spill_cap.get(8 * cpl * g)
            if kern == "res_mod_ln_bwd_vec_kernel" and cap is not None:
                spills = [int(v) for v in
                          re.findall(r"(\d+) bytes spill", chunk)]
                if max(spills, default=0) > cap:
                    over.append(f"{kern}<{cpl}, {g}{mt}> {spills} B > {cap}")
    check(not over, f"#8 spills more than before: {over}")


def log_attention_resources():
    """ptxas's registers, stack, spills and static shared memory of the
    head-split kernels of csrc/split_heads.cu (the -Xptxas=-v lines of
    this run's build; the fused-heads forward's and backward's,
    ``check_fwd_resources`` and ``check_bwd_resources``) at each head
    width: ``split_heads_online_kernel``
    (#15), ``split_heads_resident_kernel`` and ``split_heads_exact_kernel``
    (#16, #17: the resident and the streaming route), with
    ``split_heads_smem`` (the resident route's at 480 tokens)."""
    from t2ms_tpu_torch.ops import _build
    if not _build.build_logs.get("split_heads"):
        log("attention kernel resources: not measured (split_heads.cu was "
            "not built in this process)")
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
    """Kernels #5 and #6 at the scaled and the long-series train steps'
    calls in bf16, mod2 the flax path's view of a (B, 6, D) modulation,
    against the twin and autograd over it; again in f32 at a small batch.
    Tolerances: bf16 1e-2 * max|ref| (one rounding flip after f32 sums in
    another order), f32 1e-4 (summation order)."""
    from t2ms_tpu_torch.ops.dit_block import (_launch_mod_ln,
                                              _launch_mod_ln_bwd,
                                              mod_ln_reference)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    out = {}
    for call, dt, B, N, D, tol in (
            ("scaled", torch.bfloat16, SC_TRAIN_B, SC_N, SC_D, 1e-2),
            ("long", torch.bfloat16, LS_TRAIN_B, LS_N, D_MODEL, 1e-2),
            ("f32", torch.float32, 4, SC_N, SC_D, 1e-4)):
        x, dy = f(B, N, D).to(dt), f(B, N, D).to(dt)
        mod2 = (0.3 * f(B, 6, D)).to(dt)[:, 0:2]
        fwd = lambda: _launch_mod_ln(x, mod2, 1e-6)
        bwd = lambda: _launch_mod_ln_bwd(x, mod2, dy, 1e-6)
        got_y, (got_dx, got_dm) = fwd(), bwd()
        ts = [x.detach().requires_grad_(), mod2.detach().requires_grad_()]
        graph = mod_ln_reference(*ts)
        want_dx, want_dm = torch.autograd.grad(graph, ts, dy,
                                               retain_graph=True)
        torch.cuda.synchronize()
        what = f"mod_ln {dt} B={B} N={N} D={D}"
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
        out[call] = {
            "fwd": _row(e_f, ms_f, plain_f, 9 * n, _nbytes(x, mod2, got_y),
                        H100_F32_FLOPS),
            "bwd": _row(e_b, ms_b, plain_b, 18 * n,
                        _nbytes(x, mod2, dy, got_dx, got_dm),
                        H100_F32_FLOPS)}
        for k in ("fwd", "bwd"):
            r = out[call][k]
            log(f"mod_ln {dt} B={B} N={N} D={D} {k}: {r['ms']:.4f} ms, twin "
                f"{r['plain']:.4f} ms, bound {r['bound']:.4f} ms "
                f"({r['by']})")
        if dt == torch.bfloat16:   # #5, #6 on 16-byte chunks (D % 8 == 0)
            ln_device_time(f"mod_ln {call} B={B} N={N} D={D}", (
                ("fwd", fwd, "mod_ln_fwd_vec_kernel", ("mod_ln_fwd_kernel",)),
                ("bwd", bwd, "mod_ln_bwd_vec_kernel",
                 ("mod_ln_bwd_kernel",))), out[call])
        del x, mod2, dy, got_y, got_dx, got_dm, want_dx, want_dm
        torch.cuda.empty_cache()
    return out


# #5-#8 alone at the flax path's calls, for --mod_ln: (what, B, N, D, sets
# of operands a launch rotates through). The long call's tensors are 8.4
# MB and #7 moves four of them: six sets put 168 MB or more between two
# uses of one, past the 50 MB L2.
MOD_LN_SHAPES = (("scaled", SC_TRAIN_B, SC_N, SC_D, 1),
                 ("long", LS_TRAIN_B, LS_N, D_MODEL, 6))
# kernel -> (this tree's kernel, the lane-strided one it replaced)
MOD_LN_OWN = {"#5": ("mod_ln_fwd_vec_kernel", "mod_ln_fwd_kernel"),
              "#6": ("mod_ln_bwd_vec_kernel", "mod_ln_bwd_kernel"),
              "#7": ("res_mod_ln_fwd_vec_kernel", "res_mod_ln_fwd_kernel"),
              "#8": ("res_mod_ln_bwd_vec_kernel", "res_mod_ln_bwd_kernel")}
MOD_LN_RUN = 50   # back-to-back launches a run of the events' second time


def mod_ln_calls(db, sets):
    """#5-#8 through their wrappers, each call on the next set of operands
    (x, h, do, dy, the (B, 6, D) modulation m; mod2 = m[:, 0:2] and gm3 =
    m[:, 2:5], the flax path's views): kernel -> (call, outputs' bytes)."""
    turn = [0]

    def rot(fn):
        def call():
            x, h, do, dy, m = sets[turn[0] % len(sets)]
            turn[0] += 1
            return fn(x, h, do, dy, m)
        return call
    return {
        "#5": rot(lambda x, h, do, dy, m: db._launch_mod_ln(
            x, m[:, 0:2], 1e-6)),
        "#6": rot(lambda x, h, do, dy, m: db._launch_mod_ln_bwd(
            x, m[:, 0:2], dy, 1e-6)),
        "#7": rot(lambda x, h, do, dy, m: db._launch_res_mod_ln(
            x, h, m[:, 2:5], 1e-6)),
        "#8": rot(lambda x, h, do, dy, m: db._launch_res_mod_ln_bwd(
            x, h, m[:, 2:5], do, dy, 1e-6))}


def mod_ln_twin_check(db, what, x, h, do, dy, m):
    """Each of #5-#8's outputs against the twin and autograd over it
    within 1e-2 * max|twin| (one rounding flip after f32 sums in another
    order)."""
    mod2, gm3 = m[:, 0:2], m[:, 2:5]
    ts = [t.detach().requires_grad_() for t in (x, mod2)]
    ref = db.mod_ln_reference(*ts)
    want = [ref.detach(), *torch.autograd.grad(ref, ts, dy)]
    got = [db._launch_mod_ln(x, mod2, 1e-6),
           *db._launch_mod_ln_bwd(x, mod2, dy, 1e-6)]
    ts = [t.detach().requires_grad_() for t in (x, h, gm3)]
    ref = db.res_mod_ln_reference(*ts)
    want += [r.detach() for r in ref] + list(torch.autograd.grad(
        ref, ts, (do, dy)))
    got += [*db._launch_res_mod_ln(x, h, gm3, 1e-6),
            *db._launch_res_mod_ln_bwd(x, h, gm3, do, dy, 1e-6)]
    names = ("#5 out", "#6 dx", "#6 dmod2", "#7 out", "#7 y", "#8 dx",
             "#8 dh", "#8 dgm3")
    for n, g, w in zip(names, got, want):
        _check_err(f"mod_ln section {what} {n}", g, w, 1e-2)


def mod_ln_streams(sets):
    """A yardstick of each of #5-#8 (the port never calls it): elementwise
    PyTorch passes that read and write as many (B, N, D) tensors as the
    kernel (#5 one copy, #6 one add, #7 two copies, #8 two adds), each call
    on the next set of operands."""
    x0 = sets[0][0]
    o1, o2 = torch.empty_like(x0), torch.empty_like(x0)
    turn = [0]

    def rot(fn):
        def call():
            s_ = sets[turn[0] % len(sets)]
            turn[0] += 1
            fn(*s_[:4])
        return call
    return {"#5": rot(lambda x, h, do, dy: o1.copy_(x)),
            "#6": rot(lambda x, h, do, dy: torch.add(x, dy, out=o1)),
            "#7": rot(lambda x, h, do, dy: (o1.copy_(x), o2.copy_(h))),
            "#8": rot(lambda x, h, do, dy: (torch.add(x, h, out=o1),
                                            torch.add(do, dy, out=o2)))}


def enqueue_us(fn, n=20, reps=21):
    """Host time (us) to enqueue one call of ``fn`` in a run of ``n``
    back-to-back calls (the host clock stops before the synchronise), the
    least and the median of ``reps`` runs. The host's path of a call is
    the least: the machine's other work only adds to a run."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return min(times), statistics.median(times)


def mod_ln_section(gen, check_twin=True):
    """#5-#8 at every call of MOD_LN_SHAPES in bf16 through their
    wrappers, the modulation as the flax path's views: the outputs against
    the twins on this tree; for each kernel its device time by
    torch.profiler (its own kernel, dmod_reduce_kernel, the rest: the
    wrapper's casts), CUDA-event ms of one synchronised call (median of 7)
    and per launch over runs of MOD_LN_RUN back to back (median of 3), the
    host time to enqueue a call (``enqueue_us``: the least and the median
    of 21 runs of 20 calls), the bytes it must move
    (inputs once, outputs once), its bound at 3.35 TB/s and the share of
    it, and the device time of PyTorch passes moving as many tensors
    (``mod_ln_streams``). Returns {what: {kernel: row}}."""
    from t2ms_tpu_torch.ops import dit_block as db
    out = {}
    for what, B, N, D, nsets in MOD_LN_SHAPES:
        f = lambda *s_: torch.randn(*s_, generator=gen,
                                    device="cuda").to(torch.bfloat16)
        sets = [(f(B, N, D), f(B, N, D), f(B, N, D), f(B, N, D),
                 0.3 * f(B, 6, D)) for _ in range(nsets)]
        if check_twin:
            mod_ln_twin_check(db, what, *sets[0])
            torch.cuda.synchronize()
        rows = {}
        streams = mod_ln_streams(sets)
        with torch.no_grad():
            for k, call in mod_ln_calls(db, sets).items():
                res = call()
                res = res if isinstance(res, tuple) else (res,)
                x, h, do, dy, m = sets[0]
                ins = {"#5": (x, m[:, 0:2]), "#6": (x, m[:, 0:2], dy),
                       "#7": (x, h, m[:, 2:5]),
                       "#8": (x, h, m[:, 2:5], do, dy)}[k]
                nb = _nbytes(*ins, *res)
                bound = nb / H100_BYTES * 1e3
                times = device_ms_all(call)
                ran = sorted(n for n in MOD_LN_OWN[k]
                             if any(_named(t, n) for t in times))
                own = sum(v for t, v in times.items()
                          if any(_named(t, n) for n in MOD_LN_OWN[k]))
                red = sum(v for t, v in times.items()
                          if _named(t, "dmod_reduce_kernel"))
                rest = sum(times.values()) - own - red
                ev = cuda_ms(call)
                runs = []
                for _ in range(3):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(MOD_LN_RUN):
                        call()
                    e1.record()
                    e1.synchronize()
                    runs.append(e0.elapsed_time(e1) / MOD_LN_RUN)
                run = statistics.median(runs)
                host_us, host_med = enqueue_us(call)
                stream = sum(device_ms_all(streams[k]).values())
                rows[k] = dict(kernel=ran, device_ms=own, reduce_ms=red,
                               rest_ms=rest, event_ms=ev, run_ms=run,
                               host_us=host_us, host_median_us=host_med,
                               mb=nb / 1e6, bound_ms=bound,
                               share=bound / own if own else None,
                               stream_ms=stream)
                log(f"mod_ln section {what} B={B} N={N} D={D} {k} ({ran}): "
                    f"device {own:.4f} ms ({bound / own:.2%} of its bound "
                    f"{bound:.4f} ms, {nb / 1e6:.2f} MB), dmod_reduce_kernel "
                    f"{red:.4f}, the rest (the wrapper's casts) {rest:.4f}; "
                    f"events {ev:.4f} ms one synchronised call, {run:.4f} "
                    f"ms a launch over {MOD_LN_RUN} back to back; host "
                    f"{host_us:.1f} us to enqueue a call (median "
                    f"{host_med:.1f}); PyTorch passes "
                    f"moving as many tensors {stream:.4f} ms "
                    f"({bound / stream:.2%} of the bound)")
        out[what] = rows
        del sets
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


# The bf16 attention forward (attn_heads.cuh's heads_fwd_kernel) at each
# path's call: (what, entry, B, N, heads, head width). "stack" is the stack
# and block kernels' attention stage (dit_stack_attention_bf16 on a qkv of
# row stride 3D; "stack_stats" with each row's m and r, as #3's recompute
# writes them), "heads" #9 and #4's attention stage (q, k, v the column
# slices of one qkv), "heads_stats" #10.
ATTN_FWD_SHAPES = (
    ("flagship stack #1 (2B=512)", "stack", 512, 480, 4, 32),
    ("flagship train #2/#3 (B=1024)", "stack_stats", 1024, 480, 4, 32),
    ("motion train #2/#3 N=1024 (B=512)", "stack_stats", 512, 1024, 4, 32),
    ("motion train #2/#3 N=800 (B=512)", "stack_stats", 512, 800, 4, 32),
    ("motion infer #1 (2B=2)", "stack", 2, 1024, 4, 32),
    ("scaled #4/#9 (B=64)", "heads", 64, 1024, 8, 64),
    ("scaled #10 (B=64)", "heads_stats", 64, 1024, 8, 64),
    ("long series #9 (B=8)", "heads", 8, 4096, 4, 32),
    ("long series #10 (B=8)", "heads_stats", 8, 4096, 4, 32),
    ("head width 16, stack (2B=512)", "stack", 512, 480, 8, 16),
    ("head width 128, #9 (B=64)", "heads", 64, 1024, 4, 128),
)
ATTN_FWD_TOL = 1e-2   # bf16, of max|twin|: rounding flips of e (2^-8)


def attention_forward_call(entry, qkv, heads):
    """The forward at one path's call on a (B, N, 3D) bf16 qkv, through
    the entry that path launches: returns the call (o, and m/r or lse)."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.attention import (
        fused_heads_attention, fused_heads_attention_with_stats)
    B, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    if entry == "heads":
        return lambda: (fused_heads_attention(q, k, v, heads),)
    if entry == "heads_stats":
        return lambda: fused_heads_attention_with_stats(q, k, v, heads)
    lib = _build.load("dit_stack")
    o = torch.empty((B, N, D), device="cuda", dtype=qkv.dtype)
    m, r = (torch.empty((B, N, heads), device="cuda", dtype=torch.float32)
            for _ in range(2))
    stats = entry == "stack_stats"
    qscale = float(torch.tensor((D // heads) ** -0.5, dtype=qkv.dtype))

    def run():
        _build.launch(lib, "dit_stack_attention_bf16", "dit_stack_attention",
                      ValueError("dit_stack_attention refused"), qkv.device,
                      qkv, o, m if stats else None, r if stats else None, B,
                      N, D, heads, qscale)
        return (o, m, r) if stats else (o,)
    return run


def attention_forward_phase(gen, check_twin=True):
    """heads_fwd_kernel at every path shape of ATTN_FWD_SHAPES: o against
    the twin (``fused_heads_reference``, tol ATTN_FWD_TOL * max|twin|),
    the device time per launch by torch.profiler, the achieved TFLOP/s of
    the two N x N x DH products and the share of their bound (operations
    at the bf16 peak, or q, k, v, o bytes), the exponent unit's floor (one
    MUFU.EX2 a score of the second pass, H100_EX2_RATE) and torch SDPA's
    device time over the head-split views (yardstick only). Returns
    {what: row}."""
    import torch.nn.functional as F
    from t2ms_tpu_torch.ops.attention import fused_heads_reference
    out = {}
    for what, entry, B, N, H, dh in ATTN_FWD_SHAPES:
        D = H * dh
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(
            torch.bfloat16)
        call = attention_forward_call(entry, qkv, H)
        with torch.no_grad():
            got = call()
            if check_twin:
                q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
                want = torch.cat([fused_heads_reference(
                    q[i:i + 64], k[i:i + 64], v[i:i + 64], H)
                    for i in range(0, B, 64)])
                _check_err(f"attention forward {what} o", got[0], want,
                           ATTN_FWD_TOL)
                del want
            torch.cuda.synchronize()
            times = device_ms_by_kernel(call, ("heads_fwd_kernel",))
            ms = times.get("heads_fwd_kernel")
            split = lambda t: t.view(B, N, H, dh).transpose(1, 2)
            qh, kh, vh = (split(qkv[..., i * D:(i + 1) * D])
                          for i in range(3))
            lib = device_ms_all(
                lambda: F.scaled_dot_product_attention(qh, kh, vh))
            lib_ms = sum(lib.values()) if lib else None
        fl = 4 * B * H * N * N * dh
        nb = 4 * B * N * D * 2 + (8 * B * N * H if entry == "stack_stats"
                                  else 4 * B * N * H if entry ==
                                  "heads_stats" else 0)
        t_ops, t_bytes = fl / H100_BF16_FLOPS * 1e3, nb / H100_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        exp_floor = B * H * N * N / H100_EX2_RATE * 1e3
        row = dict(ms=ms, tflops=fl / ms / 1e9 if ms else None, bound=bound,
                   exp_floor=exp_floor, sdpa=lib_ms)
        out[what] = row
        if ms:
            log(f"attention forward {what} N={N} {H}x{dh}: device "
                f"{ms:.4f} ms, {fl / ms / 1e9:.2f} TFLOP/s, {bound / ms:.2%}"
                f" of its bound {bound:.4f} ms "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
                f"exponent floor {exp_floor:.4f} ms ({exp_floor / ms:.2%}), "
                f"SDPA device {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                f" ms")
        else:
            log(f"attention forward {what}: device time not measured (no "
                "device time recorded)")
        del qkv, got
        torch.cuda.empty_cache()
    return out


# The bf16 attention backward (heads_bwd.cuh's heads_bwd_q_kernel and
# heads_bwd_kv_kernel) at each path's call: (what, entry, B, N, heads, head
# width). "block" is #3's attention VJP alone (dit_block_attention_bwd_bf16:
# q, k, v read in place from qkv at row stride 3D, dq, dk, dv written into
# the column slices of dqkv, on block_attn_stats), "pipelined" #11 (the
# scaled train step's recipe), "two_pass" #12, "lean" #13 and
# "lean_two_pass" #14 (from #10's o and lse), the last four on the column
# slices of one qkv.
ATTN_BWD_SHAPES = (
    ("flagship train #3 (B=1024)", "block", 1024, 480, 4, 32),
    ("motion train #3 N=1024 (B=512)", "block", 512, 1024, 4, 32),
    ("motion train #3 N=800 (B=512)", "block", 512, 800, 4, 32),
    ("scaled #11 (B=64)", "pipelined", 64, 1024, 8, 64),
    ("long series #12 (B=8)", "two_pass", 8, 4096, 4, 32),
    ("scaled #13 (B=64)", "lean", 64, 1024, 8, 64),
    ("long series #14 (B=8)", "lean_two_pass", 8, 4096, 4, 32),
    ("head width 16, #3 (B=1024)", "block", 1024, 480, 8, 16),
    ("head width 128, #11 (B=64)", "pipelined", 64, 1024, 4, 128),
)
ATTN_BWD_TOL = 3e-2   # bf16, of max|twin|: rounding flips of e, p and ds
BWD_PARTS = ("heads_bwd_q_kernel", "heads_bwd_kv_kernel")


def _chunked(fn, B, step):
    """fn(i, j) over batch slices [i, j) of ``step``, the results of each
    position concatenated along the batch (the twins at full size)."""
    parts = [fn(i, min(i + step, B)) for i in range(0, B, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def attention_backward_call(entry, qkv, g, heads):
    """The backward at one path's call on a (B, N, 3D) bf16 qkv and g (B, N,
    D), through the entry that path launches: (run, twin, stats bytes),
    run() and twin() each returning (dq, dk, dv)."""
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops import attention as ta
    from t2ms_tpu_torch.ops import dit_block as tb
    B, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    step = max(1, (1 << 28) // (heads * N * N))   # twin rows of 1 GiB f32
    if entry == "block":
        qscale = float(torch.tensor((D // heads) ** -0.5, dtype=qkv.dtype))
        m, r, delta = _chunked(lambda i, j: tb.block_attn_stats(
            q[i:j], k[i:j], v[i:j], g[i:j], heads, qscale), B, step)
        st = torch.stack([m, 1.0 / r, delta], dim=-1).contiguous()
        dqkv = torch.empty_like(qkv)

        def run():
            _build.launch(_build.load("dit_block_bwd"),
                          "dit_block_attention_bwd_bf16",
                          "dit_block_attention_bwd",
                          ValueError("dit_block_attention_bwd refused"),
                          qkv.device, qkv, g, st, dqkv, B, N, D, heads,
                          qscale)
            return dqkv[..., :D], dqkv[..., D:2 * D], dqkv[..., 2 * D:]
        return run, lambda: _chunked(lambda i, j: tb.block_attn_bwd_reference(
            q[i:j], k[i:j], v[i:j], g[i:j], m[i:j], r[i:j], delta[i:j],
            qscale), B, step), _nbytes(st)
    if entry.startswith("lean"):
        o, lse = ta.fused_heads_attention_with_stats(q, k, v, heads)
        fn = (ta.fused_heads_attention_bwd_lean_two_pass
              if entry == "lean_two_pass"
              else ta.fused_heads_attention_bwd_lean)
        twin = ta.fused_heads_bwd_lean_reference
        return (lambda: fn(q, k, v, g, o, lse, heads),
                lambda: _chunked(lambda i, j: twin(
                    q[i:j], k[i:j], v[i:j], g[i:j], o[i:j], lse[i:j], heads),
                    B, step), _nbytes(o, lse))
    if entry == "two_pass":
        return (lambda: ta.fused_heads_attention_bwd_two_pass(q, k, v, g,
                                                              heads),
                lambda: _chunked(
                    lambda i, j: ta.fused_heads_bwd_two_pass_reference(
                        q[i:j], k[i:j], v[i:j], g[i:j], heads), B, step), 0)
    return (lambda: ta.fused_heads_attention_bwd(q, k, v, g, heads,
                                                 pipelined=True),
            lambda: _chunked(lambda i, j: ta.fused_heads_bwd_reference(
                q[i:j], k[i:j], v[i:j], g[i:j], heads), B, step), 0)


def attention_backward_phase(gen, check_twin=True):
    """heads_bwd_q_kernel and heads_bwd_kv_kernel at every path shape of
    ATTN_BWD_SHAPES: dq, dk, dv against the twin (tol ATTN_BWD_TOL *
    max|twin|, correlation >= 0.999), the device time per call of both
    kernels by torch.profiler, the achieved TFLOP/s of the five N x N x DH
    products the gradient needs and the share of their bound (operations
    at the bf16 peak, or the bytes of q, k, v, g, dq, dk, dv and the
    statistics), the exponent unit's floor (H100_EX2_RATE; three
    exponentials a score for the pipelined and recompute recipes, two for
    the lean and block ones) and torch SDPA's forward + backward minus its
    forward on the head-split views (yardstick only). Returns {what: row}."""
    import torch.nn.functional as F
    out = {}
    for what, entry, B, N, H, dh in ATTN_BWD_SHAPES:
        D = H * dh
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda").to(
            torch.bfloat16)
        g = torch.randn(B, N, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        run, twin, stat_bytes = attention_backward_call(entry, qkv, g, H)
        with torch.no_grad():
            got = run()
            torch.cuda.synchronize()
            if check_twin:
                for name, a, w in zip(("dq", "dk", "dv"), got, twin()):
                    _check_err(f"attention backward {what} {name}", a, w,
                               ATTN_BWD_TOL)
                torch.cuda.synchronize()
            del got
            times = device_ms_by_kernel(run, BWD_PARTS)
        ms = (times.get(BWD_PARTS[0], 0.0) + times.get(BWD_PARTS[1], 0.0)
              or None)
        split = lambda t: t.view(B, N, H, dh).transpose(1, 2).detach() \
            .requires_grad_()
        qh, kh, vh = (split(qkv[..., i * D:(i + 1) * D]) for i in range(3))
        gh = g.view(B, N, H, dh).transpose(1, 2)
        fwd = device_ms_all(lambda: F.scaled_dot_product_attention(qh, kh,
                                                                   vh))
        both = device_ms_all(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh), (qh, kh, vh), gh))
        lib_ms = (sum(both.values()) - sum(fwd.values())
                  if fwd and both else None)
        fl = 10 * B * H * N * N * dh
        nb = 7 * B * N * D * 2 + stat_bytes
        t_ops, t_bytes = fl / H100_BF16_FLOPS * 1e3, nb / H100_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        n_exp = 3 if entry in ("pipelined", "two_pass") else 2
        exp_floor = n_exp * B * H * N * N / H100_EX2_RATE * 1e3
        row = dict(ms=ms, q_ms=times.get(BWD_PARTS[0]),
                   kv_ms=times.get(BWD_PARTS[1]),
                   tflops=fl / ms / 1e9 if ms else None, bound=bound,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   exp_floor=exp_floor, sdpa=lib_ms)
        out[what] = row
        if ms:
            log(f"attention backward {what} N={N} {H}x{dh}: device "
                f"{ms:.4f} ms (q {row['q_ms']:.4f}, kv {row['kv_ms']:.4f}), "
                f"{fl / ms / 1e9:.2f} TFLOP/s, {bound / ms:.2%} of its bound "
                f"{bound:.4f} ms ({row['bound_by']}), exponent floor "
                f"{exp_floor:.4f} ms ({exp_floor / ms:.2%}), SDPA fwd+bwd-fwd "
                f"device {lib_ms if lib_ms is None else round(lib_ms, 4)} ms")
        else:
            log(f"attention backward {what}: device time not measured (no "
                "device time recorded)")
        del qkv, g, run, twin, qh, kh, vh, gh
        torch.cuda.empty_cache()
    return out


# The stack's forward row kernels (csrc/dit_layer.cuh: modln_qkv_tc_kernel,
# proj_mlp_tc_kernel) at each path's call, through the public entries:
# (what, entry, B, N, D, heads, hidden, L). "stack" is fused_dit_stack (#1),
# "block" fused_dit_block (#2), "block_bwd" the block backward (#3), whose
# recompute runs both kernels (its (c) without the MLP half). D 192 and
# hidden 384 is the widest geometry the route takes with the weights
# streamed through the slots (check_shape refuses D 256 for the first
# kernels' attention tile), and B 3 x N 17 one tile, fewer than the SMs.
ROW_SHAPES = (
    ("flagship CFG #1 (2B=512)", "stack", 512, 480, 128, 4, 256, 4),
    ("train forward #2 (B=1024)", "block", 1024, 480, 128, 4, 256, 1),
    ("train recompute #3 (B=1024)", "block_bwd", 1024, 480, 128, 4, 256, 1),
    ("motion #2 N=1024 (B=512)", "block", 512, 1024, 128, 4, 256, 1),
    ("motion #3 N=1024 (B=512)", "block_bwd", 512, 1024, 128, 4, 256, 1),
    ("motion #2 N=800 (B=512)", "block", 512, 800, 128, 4, 256, 1),
    ("motion #3 N=800 (B=512)", "block_bwd", 512, 800, 128, 4, 256, 1),
    ("streamed D=192 hidden 384 #1 (B=64)", "stack", 64, 480, 192, 6, 384,
     1),
    ("ragged #1 (B=3, N=17)", "stack", 3, 17, 128, 4, 256, 4),
)
ROW_PARTS = ("modln_qkv_tc_kernel", "proj_mlp_tc_kernel")
ROW_TOL = 3e-2   # bf16, of max|twin|: the stack and block bounds


def row_work(entry, B, N, D, hidden, L):
    """(operations, bytes) of each row kernel over one call: its products,
    and each input read once and each output written once per layer ((a):
    x, the weights, bias and mod[0:2] in, qkv and, in the recompute, z out;
    (c): o, x, the weights, biases and mod[2:6] in, y out, or without the
    MLP mod[2], proj and x1 out)."""
    rows, bf = B * N, 2
    recompute = entry == "block_bwd"
    qkv_ops = 2 * rows * D * 3 * D
    qkv_bytes = (rows * D * bf + rows * 3 * D * bf + 3 * D * D * bf
                 + 3 * D * bf + B * 2 * D * 4
                 + (rows * D * bf if recompute else 0))
    if recompute:
        mlp_ops = 2 * rows * D * D
        mlp_bytes = 4 * rows * D * bf + D * D * bf + D * bf + B * D * 4
    else:
        mlp_ops = 2 * rows * (D * D + 2 * D * hidden)
        mlp_bytes = (3 * rows * D * bf + (D * D + 2 * D * hidden) * bf
                     + (2 * D + hidden) * bf + B * 4 * D * 4)
    return {ROW_PARTS[0]: (L * qkv_ops, L * qkv_bytes),
            ROW_PARTS[1]: (L * mlp_ops, L * mlp_bytes)}


def row_cublas_ms(entry, rows, D, hidden, L):
    """Device time of torch.matmul (cuBLAS) over each row kernel's products
    alone at this call, bf16 (yardstick only: no LayerNorm, bias, GELU or
    residual): (a) x @ wqkv; (c) o @ wproj and, with the MLP, z2 @ w1 and
    h @ w2; L times. Its inputs come from a generator of its own."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
    a, wq, wp = f(rows, D), f(D, 3 * D), f(D, D)
    mlp = entry != "block_bwd"
    h, w1, w2 = (f(rows, hidden), f(D, hidden), f(hidden, D)) if mlp else (
        None, None, None)

    def qkv():
        for _ in range(L):
            torch.matmul(a, wq)

    def rest():
        for _ in range(L):
            torch.matmul(a, wp)
            if mlp:
                torch.matmul(a, w1)
                torch.matmul(h, w2)
    out = {}
    for name, fn in zip(ROW_PARTS, (qkv, rest)):
        times = device_ms_all(fn)
        out[name] = sum(times.values()) if times else None
    return out


def row_gemm_phase(gen, check_twin=True):
    """The two row kernels at every call of ROW_SHAPES through the public
    entries: the output against the twin where the entry is a forward
    (tol ROW_TOL * max|twin|), each kernel's device time by torch.profiler,
    its operations and bytes (row_work), the share of its bound and
    cuBLAS over its products (row_cublas_ms). Returns {what: {kernel:
    row}}."""
    from t2ms_tpu_torch.ops.dit_block import (_launch_block_bwd,
                                              fused_dit_block,
                                              fused_dit_block_reference,
                                              fused_dit_stack,
                                              fused_dit_stack_reference)
    out = {}
    for what, entry, B, N, D, H, hidden, L in ROW_SHAPES:
        f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
        x = f(B, N, D).to(torch.bfloat16)
        mod = 0.3 * f(B, L, 6, D)
        ws = [0.2 * f(L, D, 3 * D), 0.1 * f(L, 3 * D), 0.2 * f(L, D, D),
              0.1 * f(L, D), 0.2 * f(L, D, hidden), 0.1 * f(L, hidden),
              0.2 * f(L, hidden, D), 0.1 * f(L, D)]
        if entry == "stack":
            ws = [w_.to(torch.bfloat16) for w_ in ws]
            call = lambda: fused_dit_stack(x, mod, *ws, H)
            twin = lambda: fused_dit_stack_reference(x, mod, *ws, H)
        else:
            mod, ws = mod[:, 0], [w_[0] for w_ in ws]
            if entry == "block":
                call = lambda: fused_dit_block(x, mod, *ws, H)
                twin = lambda: fused_dit_block_reference(x, mod, *ws, H)
            else:
                dy = f(B, N, D).to(torch.bfloat16)
                call = lambda: _launch_block_bwd(x, mod, ws, dy, H, 1e-6)
                twin = None
        with torch.no_grad():
            got = call()
            if check_twin and twin is not None:
                _check_err(f"row kernels {what} y", got, twin(), ROW_TOL)
            torch.cuda.synchronize()
            del got
            times = device_ms_by_kernel(call, ROW_PARTS)
        lib = row_cublas_ms(entry, B * N, D, hidden, L)
        rows = {}
        for name, (fl, nb) in row_work(entry, B, N, D, hidden, L).items():
            t_ops, t_bytes = fl / H100_BF16_FLOPS * 1e3, nb / H100_BYTES * 1e3
            bound, ms = max(t_ops, t_bytes), times.get(name)
            rows[name] = dict(ms=ms, gflop=fl / 1e9, mb=nb / 1e6, bound=bound,
                              by="operations" if t_ops >= t_bytes else
                              "bytes", share=bound / ms if ms else None,
                              cublas=lib[name])
            lib_s = ("not measured" if lib[name] is None
                     else f"{lib[name]:.4f} ms")
            if ms:
                log(f"row kernels {what} N={N} D={D} hidden={hidden} L={L}: "
                    f"{name} device {ms:.4f} ms ({ms / L:.4f} a layer), "
                    f"{fl / 1e9:.2f} GFLOP, {nb / 1e6:.2f} MB, bound "
                    f"{bound:.4f} ms ({rows[name]['by']}), {bound / ms:.2%} "
                    f"of it, cuBLAS over its products {lib_s}")
            else:
                log(f"row kernels {what}: {name} device time not measured (no "
                    "device time recorded)")
        out[what] = rows
        del x, mod, ws
        torch.cuda.empty_cache()
    return out


# The bf16 block backward's four row kernels (csrc/dit_block_bwd.cu:
# mlp_bwd_tc_kernel, attn_out_bwd_tc_kernel, qkv_bwd_tc_kernel,
# wgrad_tc_kernel) at #3's calls, through _launch_block_bwd: (what, B, N,
# D, heads, hidden). The flagship train call; the motion track's at 1024
# and 800 tokens, B=512; D 128 at hidden 512, where the MLP half streams w1
# and w2 through the slots; one ragged tile a batch element.
ROW_BWD_SHAPES = (
    ("flagship #3 (B=1024)", 1024, 480, 128, 4, 256),
    ("motion #3 N=1024 (B=512)", 512, 1024, 128, 4, 256),
    ("motion #3 N=800 (B=512)", 512, 800, 128, 4, 256),
    ("streamed hidden 512 #3 (B=64)", 64, 480, 128, 4, 512),
    ("ragged #3 (B=3, N=17)", 3, 17, 128, 4, 256),
)
ROW_BWD_PARTS = ("mlp_bwd_tc_kernel", "attn_out_bwd_tc_kernel",
                 "qkv_bwd_tc_kernel", "wgrad_tc_kernel")


def row_bwd_work(B, N, D, H, hidden):
    """(operations, bytes) of each backward row kernel over one call: its
    products, and its inputs read and its outputs written once (bf16 but
    dx1, f32; mod's rows and the weights once), except that the MLP half
    reads x1 and dy twice: its LayerNorm VJP reads them again (x1 for its
    statistics and x̂, dy for dx1 = dy + LN-VJP), so both count twice.
    MLP half: x1, dy in; dx1, z2, h1, dh2, da1 out; z2 @ w1, h1 @ w2, dh2 @
    w2^T, da1 @ w1^T. Attention output: dx1, proj, o, the rows' m and r
    in; dpo, do and the (m, 1/r, delta) rows out; dpo @ wproj^T. qkv half:
    dqkv, x, dx1 in; dx out; dqkv @ wqkv^T. Weight grads: the four (A, G)
    pairs read once, dW and db out."""
    rows, bf, f4 = B * N, 2, 4
    act = rows * D * bf
    mlp_ops = 2 * rows * 4 * D * hidden
    mlp_bytes = (4 * act + rows * D * f4 + 2 * act + 2 * rows * hidden * bf
                 + 2 * D * hidden * bf + (hidden + D) * bf + B * 3 * D * f4)
    out_ops = 2 * rows * D * D
    out_bytes = (rows * D * f4 + 2 * act + 2 * rows * H * f4 + D * D * bf
                 + B * D * f4 + 2 * act + 3 * rows * H * f4)
    qkv_ops = 2 * rows * D * 3 * D
    qkv_bytes = (3 * act + act + rows * D * f4 + act + 3 * D * D * bf
                 + B * 2 * D * f4)
    km = ((D, 3 * D), (D, D), (D, hidden), (hidden, D))
    wg_ops = sum(2 * rows * k * m for k, m in km)
    wg_bytes = sum(rows * (k + m) * bf + (k * m + m) * f4 for k, m in km)
    return dict(zip(ROW_BWD_PARTS, ((mlp_ops, mlp_bytes),
                                    (out_ops, out_bytes),
                                    (qkv_ops, qkv_bytes),
                                    (wg_ops, wg_bytes))))


def row_bwd_cublas_ms(rows, D, hidden):
    """Device time of torch.matmul (cuBLAS) over each backward row kernel's
    products alone at this call, bf16 (yardstick only: no LayerNorm, bias,
    GELU or epilogue): the MLP half's four, the attention output's one, the
    qkv half's one and the weight grads' four A^T G. Inputs from a
    generator of its own."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
    a, h, g3 = f(rows, D), f(rows, hidden), f(rows, 3 * D)
    wq, wp, w1, w2 = f(D, 3 * D), f(D, D), f(D, hidden), f(hidden, D)
    runs = {
        ROW_BWD_PARTS[0]: lambda: (torch.matmul(a, w1), torch.matmul(h, w2),
                                   torch.matmul(a, w2.t()),
                                   torch.matmul(h, w1.t())),
        ROW_BWD_PARTS[1]: lambda: torch.matmul(a, wp.t()),
        ROW_BWD_PARTS[2]: lambda: torch.matmul(g3, wq.t()),
        ROW_BWD_PARTS[3]: lambda: (torch.matmul(a.t(), g3),
                                   torch.matmul(a.t(), a),
                                   torch.matmul(a.t(), h),
                                   torch.matmul(h.t(), a)),
    }
    out = {}
    for name, fn in runs.items():
        times = device_ms_all(fn)
        out[name] = sum(times.values()) if times else None
    return out


def row_bwd_twin_check(what, gen, B, N, D, hidden):
    """The MLP-half and qkv-half kernels alone against their twins at this
    call (every output; ROW_TOL * max|twin|, correlation >= 0.999)."""
    from t2ms_tpu_torch.ops import dit_block as tb
    f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
    bf = torch.bfloat16
    x, dy = f(B, N, D).to(bf), f(B, N, D).to(bf)
    mod = 0.3 * f(B, 6, D)
    w1, b1 = (f(D, hidden) / D ** 0.5).to(bf), (0.1 * f(hidden)).to(bf)
    w2, b2 = (f(hidden, D) / hidden ** 0.5).to(bf), (0.1 * f(D)).to(bf)
    names = ("dx1", "z2", "h1", "dh2", "da1", "dshift_m", "dscale_m",
             "dgate_m")
    with torch.no_grad():
        args = (x, mod, w1, b1, w2, b2, dy)
        got = tb._launch_mlp_half_bwd(*args)
        want = tb.mlp_half_bwd_reference(*args)
        for name, g_, w_ in zip(names, got, want):
            _check_err(f"row backward {what} mlp_bwd_tc_kernel {name}", g_,
                       w_, ROW_TOL)
        del got, want, args
        wqkv = (f(D, 3 * D) / D ** 0.5).to(bf)
        args = (x, mod, wqkv, f(B, N, 3 * D).to(bf), f(B, N, D))
        got = tb._launch_qkv_half_bwd(*args)
        want = tb.qkv_half_bwd_reference(*args)
        for name, g_, w_ in zip(("dx", "dshift_a", "dscale_a"), got, want):
            _check_err(f"row backward {what} qkv_bwd_tc_kernel {name}", g_,
                       w_, ROW_TOL)
    torch.cuda.synchronize()


def row_bwd_phase(gen, check_twin=True):
    """The block backward's four row kernels at every call of
    ROW_BWD_SHAPES through _launch_block_bwd: each kernel's device time by
    torch.profiler, its operations and bytes (row_bwd_work), the share of
    its bound and cuBLAS over its products (row_bwd_cublas_ms); with
    check_twin, the MLP-half and qkv-half kernels alone against their
    twins at the call's shapes first. Returns {what: {kernel: row}}."""
    from t2ms_tpu_torch.ops.dit_block import _launch_block_bwd
    out = {}
    for what, B, N, D, H, hidden in ROW_BWD_SHAPES:
        if check_twin:
            row_bwd_twin_check(what, gen, B, N, D, hidden)
        f = lambda *s_: torch.randn(*s_, generator=gen, device="cuda")
        x, dy = f(B, N, D).to(torch.bfloat16), f(B, N, D).to(torch.bfloat16)
        mod = 0.3 * f(B, 6, D)
        ws = [0.2 * f(D, 3 * D), 0.1 * f(3 * D), 0.2 * f(D, D), 0.1 * f(D),
              0.2 * f(D, hidden), 0.1 * f(hidden), 0.2 * f(hidden, D),
              0.1 * f(D)]
        call = lambda: _launch_block_bwd(x, mod, ws, dy, H, 1e-6)
        with torch.no_grad():
            got = call()
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in
                      (got[0], got[1], *got[2])),
                  f"row backward {what}: finite gradients")
            del got
            times = device_ms_by_kernel(call, ROW_BWD_PARTS)
        lib = row_bwd_cublas_ms(B * N, D, hidden)
        rows = {}
        for name, (fl, nb) in row_bwd_work(B, N, D, H, hidden).items():
            t_ops, t_bytes = fl / H100_BF16_FLOPS * 1e3, nb / H100_BYTES * 1e3
            bound, ms = max(t_ops, t_bytes), times.get(name)
            rows[name] = dict(ms=ms, gflop=fl / 1e9, mb=nb / 1e6, bound=bound,
                              by="operations" if t_ops >= t_bytes else
                              "bytes", share=bound / ms if ms else None,
                              cublas=lib[name])
            lib_s = ("not measured" if lib[name] is None
                     else f"{lib[name]:.4f} ms")
            if ms:
                log(f"row backward {what} N={N} D={D} hidden={hidden}: {name} "
                    f"device {ms:.4f} ms, {fl / 1e9:.2f} GFLOP, "
                    f"{nb / 1e6:.2f} MB, bound {bound:.4f} ms "
                    f"({rows[name]['by']}), {bound / ms:.2%} of it, cuBLAS "
                    f"over its products {lib_s}")
            else:
                log(f"row backward {what}: {name} device time not measured "
                    "(no device time recorded)")
        out[what] = rows
        del x, dy, mod, ws
        torch.cuda.empty_cache()
    return out


def check_bwd_resources():
    """Every heads_bwd_q_kernel and heads_bwd_kv_kernel instance of this
    run's builds (fused_heads: the pipelined, recompute and lean recipes at
    head widths 32, 64, 128; dit_block_bwd: the block recipe at 16 to 128):
    ptxas's registers, spills and shared memory, checked to spill nothing
    and to draw no C7512 ("wgmma serialized")."""
    from t2ms_tpu_torch.ops import _build
    recipes = ("pipelined", "recompute", "lean", "block")
    seen = 0
    for name in ("fused_heads", "dit_block_bwd"):
        text = _build.build_logs.get(name)
        if not text:
            log(f"heads_bwd resources: not measured ({name}.cu was not built "
                "in this process)")
            continue
        serial = [l_ for l_ in text.splitlines()
                  if "C7512" in l_ and "heads_bwd_" in l_]
        check(not serial, f"ptxas serialized a heads_bwd kernel's wgmma in "
              f"{name}.cu (C7512): " + "; ".join(serial))
        lib = _build.load(name)
        for chunk in text.split("Compiling entry function")[1:]:
            m = re.search(r"(heads_bwd_(q|kv)_kernel)ILi(\d+)ELi(\d+)E",
                          chunk.split("\n")[0])
            if m is None:
                continue
            dh, rec = int(m.group(3)), int(m.group(4))
            kv = int(m.group(2) == "kv")
            smem = (lib.fused_heads_backward_smem(dh, rec, kv)
                    if name == "fused_heads" else
                    lib.dit_block_bwd_smem(4 + kv, D_MODEL, HIDDEN,
                                           D_MODEL // dh))
            what = f"{m.group(1)}<{dh}, {recipes[rec]}>"
            _log_resources(f"{what} in {name}.cu", chunk, smem)
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill",
                                                 chunk)]
            check(not any(spills), f"{what} in {name}.cu spills {spills}")
            seen += 1
    log(f"heads_bwd resources: {seen} instances, no spills and no C7512")


def log_fwd_sass():
    """Instructions of each heads_fwd_kernel instance in the built
    fused_heads and dit_stack libraries by pipe (cuobjdump -sass where the
    toolkit has it): the exponent unit (MUFU.EX2), the other MUFU ops,
    conversions (F2FP, F2F), f32 arithmetic (FADD, FMUL, FFMA, FMNMX), the
    integer and logic ops (LOP3, SHF, PRMT, IMAD, IADD3), the wgmma
    instructions (HGMMA), each as a static count over the function's
    code."""
    from t2ms_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("heads_fwd_kernel SASS: not measured (no cuobjdump)")
        return
    groups = (("MUFU.EX2", r"MUFU\.EX2"), ("MUFU other", r"MUFU\.(?!EX2)"),
              ("F2FP", r"F2FP"), ("F2F", r"\bF2F\."),
              ("FADD", r"\bFADD"), ("FMUL", r"\bFMUL"), ("FFMA", r"\bFFMA"),
              ("FMNMX", r"\bFMNMX"), ("FSETP/FSEL", r"\bFSETP|\bFSEL"),
              ("LOP3", r"\bLOP3"), ("SHF", r"\bSHF"), ("PRMT", r"\bPRMT"),
              ("IMAD", r"\bIMAD"), ("IADD3", r"\bIADD3"),
              ("HGMMA", r"\bHGMMA"), ("BAR", r"\bBAR\."),
              ("LDGSTS", r"\bLDGSTS"))
    for name in ("fused_heads", "dit_stack"):
        _build.load(name)
        text = subprocess.run([tool, "-sass", _build._target(name)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        for chunk in text.split("Function : ")[1:]:
            fn = chunk.split("\n", 1)[0].strip()
            m = re.search(r"heads_fwd_kernelILi(\d+)E", fn)
            if m is None:
                continue
            lines = [l_ for l_ in chunk.splitlines()
                     if re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", l_)]
            counts = {g: sum(bool(re.search(p, l_)) for l_ in lines)
                      for g, p in groups}
            log(f"heads_fwd_kernel<{m.group(1)}> SASS "
                f"({name}.cu, "
                f"{len(lines)} instructions): "
                + ", ".join(f"{g} {n}" for g, n in counts.items()))


def check_fwd_resources():
    """Every heads_fwd_kernel instance of this run's builds (fused_heads,
    dit_stack, dit_split, dit_block_bwd): ptxas's registers, spills and
    shared memory, checked to spill nothing and to draw no C7512 ("wgmma
    serialized")."""
    from t2ms_tpu_torch.ops import _build
    seen = 0
    for name in ("fused_heads", "dit_stack", "dit_split", "dit_block_bwd"):
        text = _build.build_logs.get(name)
        if not text:
            log(f"heads_fwd_kernel resources: not measured ({name}.cu was not "
                "built in this process)")
            continue
        serial = [l_ for l_ in text.splitlines()
                  if "C7512" in l_ and "heads_fwd_kernel" in l_]
        check(not serial, f"ptxas serialized heads_fwd_kernel's wgmma in "
              f"{name}.cu (C7512): " + "; ".join(serial))
        for chunk in text.split("Compiling entry function")[1:]:
            m = re.search(r"heads_fwd_kernelILi(\d+)E", chunk.split("\n")[0])
            if m is None:
                continue
            what = f"heads_fwd_kernel<{m.group(1)}>"
            _log_resources(f"{what} in {name}.cu",
                           chunk, _build.load("fused_heads")
                           .fused_heads_forward_smem(int(m.group(1))))
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill",
                                                 chunk)]
            check(not any(spills), f"{what} in {name}.cu spills {spills}")
            seen += 1
    log(f"heads_fwd_kernel resources: {seen} instances, no spills and no "
        "C7512")


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
    log_device_time("scaled train step", lambda: step(z, emb, generator=g),
                    absent=OLD_LN_KERNELS)
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


def log_device_time(what, fn, parts=MOD_LN_PARTS + HEADS_PARTS, absent=()):
    """One call of ``fn`` under torch.profiler: the total device time, the
    port's kernels named in ``parts``, and the rest by kind, checked to run
    none of ``absent``; then the host time to enqueue one call
    (``host_ms``) against that device time."""
    times = device_ms_all(fn)
    if not times:
        log(f"{what} device time: not measured (no device time recorded)")
        return
    off = sorted(k for k in times for a in absent if _named(k, a))
    check(not off, f"{what} ran {off}, none of {absent} expected")
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
    long-series call in bf16, gm3 the flax path's view of a (B, 6, D)
    modulation, against the twin and autograd over it; again in f32 at a
    small batch. Tolerances: bf16 1e-2 * max|ref| (one rounding
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
        gm3 = (0.3 * f(B, 6, D)).to(dt)[:, 2:5]    # the flax path's view
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
        if dt == torch.bfloat16:   # #7, #8 on 16-byte chunks (D % 8 == 0)
            ln_device_time(f"res_mod_ln {call} B={B} N={N} D={D}", (
                ("fwd", fwd, "res_mod_ln_fwd_vec_kernel",
                 ("res_mod_ln_fwd_kernel",)),
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
    checked to run on the own kernel, none of the others and nothing but
    it and dmod_reduce_kernel (the modulation's views read in place, no
    copy or cast). rows[key] gains "device" (the own kernel's ms)."""
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
        glue = sorted(n for n in times if not _named(n, own)
                      and not _named(n, "dmod_reduce_kernel"))
        check(not glue, f"{what} {k} ran {glue} beside {own}: a copy or "
              "cast of an operand")
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
    log_device_time("long train step", lambda: step(x, emb, generator=g),
                    absent=OLD_LN_KERNELS)
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


# the quality gate's 1500-step cut of the t2s track at B=256
QG_STEPS, QG_VAE_STEPS = 1500, 800
QG_ARGV = ["--steps", str(QG_STEPS), "--vae_steps", str(QG_VAE_STEPS),
           "--eval_cfid", "--cfg_scale", "7"]
QG_FLOOR = 0.20946913918608598     # scripts/quality_gate.py's t2s floor, CPU
QG_KEYS = {"vae_recon_error", "final_train_loss", "MSE", "WAPE", "DTW",
           "ACD", "SD", "KD", "MSE_noise_floor", "C-FID", "gates"}
QG_GATES = {"mse_under_half_noise_floor", "finite", "distribution_close"}


def quality_gate_phase():
    """``cli.quality_gate.main`` in process on the t2s track (B=256, 800
    VAE and 1500 DiT steps, euler/100 at cfg 7, C-FID): the JSON's keys,
    finite values, the CPU's noise floor, the exit code against the
    gates, and 4 + 4 block launches a step and 100 stack launches in the
    one sample. Green is not required at 1500 steps."""
    import io

    from t2ms_tpu_torch.cli import quality_gate
    from t2ms_tpu_torch.ops import _build
    from t2ms_tpu_torch.ops.dit_block import (BLOCK_BWD_KERNEL,
                                              BLOCK_KERNEL, STACK_KERNEL)
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = quality_gate.main(QG_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for line in err.getvalue().splitlines():
        log(f"quality gate: {line}")
    res = json.loads(out.getvalue())
    check(set(res) == QG_KEYS and set(res["gates"]) == QG_GATES,
          f"quality gate keys {sorted(res)} {sorted(res['gates'])}")
    check(all(np.isfinite(v) for k, v in res.items() if k != "gates"),
          f"quality gate values not finite: {res}")
    check(abs(res["MSE_noise_floor"] - QG_FLOOR) <= 1e-12,
          f"quality gate floor {res['MSE_noise_floor']!r} != {QG_FLOOR!r}")
    check(rc == int(not all(res["gates"].values())),
          f"quality gate exit code {rc} for gates {res['gates']}")
    want = {BLOCK_KERNEL: 4 * QG_STEPS, BLOCK_BWD_KERNEL: 4 * QG_STEPS,
            STACK_KERNEL: 100}
    check(launches == want,
          f"quality gate launches {launches}, want {want}")
    secs = [float(s) for s in re.findall(r"\(?([0-9.]+) s\)?$",
                                         err.getvalue(), re.M)]
    log(f"quality gate (t2s, {QG_STEPS} steps, cfg 7): MSE {res['MSE']!r} "
        f"(floor {res['MSE_noise_floor']!r}), C-FID {res['C-FID']!r}, "
        f"gates {res['gates']}, exit {rc}; VAE {QG_VAE_STEPS / secs[0]:.4f} "
        f"steps/s, denoiser {QG_STEPS / secs[1]:.4f} steps/s, sample and "
        f"score {secs[2]:.2f} s; launches {launches}")
    log(f"quality gate phase: {wall:.2f} s wall")


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
    from t2ms_tpu_torch.utils.prng import torch_seed
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
        gen.manual_seed(torch_seed(batch_seed(cfg["train_seed"], 0)))
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


def log_exp_floors():
    """Each attention kernel's exponent-unit floor at the call the kernel
    table times it at: its exponentials over H100_EX2_RATE. One a score of
    each pass that forms e or p: #1, #2, #4, #9, #10 one (the second
    pass); #3 three (the forward's recompute, the q-tile and the k-tile
    kernel); #11 and #12 three (the q-tile kernel's second and third
    passes, the k-tile kernel); #13 and #14 two; #15 one (the online
    softmax); #16 and #17 two (statistics, then p)."""
    sc = SC_HEADS * SC_N * SC_N
    ls = HEADS * LS_N * LS_N
    fl = HEADS * N_TOK * N_TOK
    counts = (("#1", DEPTH * 2 * B_SERIES * fl), ("#2", B_TRAIN * fl),
              ("#3", 3 * B_TRAIN * fl), ("#4", 2 * SC_B * sc),
              ("#9", SC_TRAIN_B * sc), ("#10", SC_TRAIN_B * sc),
              ("#11", 3 * SC_TRAIN_B * sc), ("#12", 3 * LS_TRAIN_B * ls),
              ("#13", 2 * SC_TRAIN_B * sc), ("#14", 2 * LS_TRAIN_B * ls),
              ("#15", 2 * XL_B * HEADS * XL_N * XL_N), ("#16", 2 * 8 * fl),
              ("#17", 2 * 2 * PK_B * fl))
    log("exponent-unit floors (16 MUFU.EX2 a clock an SM, "
        f"{H100_EX2_RATE:.4g}/s): " + ", ".join(
            f"{k} {n:.4g} exps {n / H100_EX2_RATE * 1e3:.4f} ms"
            for k, n in counts))


def attention_forward_only(seed, root):
    """The attention forward's section alone, on this tree's package or on
    ``root``'s: the card, the build of fused_heads.cu and dit_stack.cu with
    their heads_fwd_kernel resources and SASS counts, then
    attention_forward_phase; the last line is {"attention_forward": {what:
    row}, "root": ...}."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    from t2ms_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {smi}; package {os.path.dirname(_build.__file__)}")
    log(f"build: {_build.build_all(['fused_heads', 'dit_stack'])}")
    check_fwd_resources()
    log_fwd_sass()
    rows = attention_forward_phase(
        torch.Generator(device="cuda").manual_seed(seed + 20))
    print(json.dumps({"attention_forward": rows, "root": root or ".",
                      "card": smi}), flush=True)
    return 0


def row_gemms_only(seed, root):
    """The row kernels' section alone, on this tree's package or on
    ``root``'s: the card, the build of dit_stack.cu and dit_block_bwd.cu
    (this tree's row kernels' resources checked), then row_gemm_phase and
    row_bwd_phase (the twin checks on this tree only); the last line is
    {"row_gemms": {what: {kernel: row}}, "row_bwd": {...}, "root": ...}."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    from t2ms_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {smi}; package {os.path.dirname(_build.__file__)}")
    log(f"build: {_build.build_all(['dit_stack', 'dit_block_bwd'])}")
    if root is None:
        log_stack_resources()
        log_block_bwd_resources()
    rows = row_gemm_phase(
        torch.Generator(device="cuda").manual_seed(seed + 22))
    bwd = row_bwd_phase(torch.Generator(device="cuda").manual_seed(seed + 23),
                        check_twin=root is None)
    print(json.dumps({"row_gemms": rows, "row_bwd": bwd, "root": root or ".",
                      "card": smi}), flush=True)
    return 0


def split_gemms_only(seed, root):
    """The split block's GEMM section alone, on this tree's package or on
    ``root``'s: the card, the build of dit_split.cu (this tree's kernels'
    resources checked), then split_gemm_phase (the twin checks on this tree
    only); the last line is {"split_gemms": {what: {stage: row}}, "root":
    ...}."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    from t2ms_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {smi}; package {os.path.dirname(_build.__file__)}")
    log(f"build: {_build.build_all(['dit_split'])}")
    if root is None:
        log_split_resources()
    rows = split_gemm_phase(
        torch.Generator(device="cuda").manual_seed(seed + 24),
        check_twin=root is None)
    print(json.dumps({"split_gemms": rows, "root": root or ".",
                      "card": smi}), flush=True)
    return 0


def mod_ln_host_ab(gen, root):
    """The host path of #5-#8's wrappers, ``root``'s package (imported
    first) against this tree's in one process: at each call of
    MOD_LN_SHAPES, 21 pairs of runs of 20 back-to-back calls (``enqueue_
    us``'s runs), the order alternating, on the same operands. Returns
    {what: {kernel: {"parent_us", "change_us": [least, median],
    "change_wins": share of pairs}}}."""
    import t2ms_tpu_torch.ops.dit_block as parent
    for k in [k for k in sys.modules
              if k == "t2ms_tpu_torch" or k.startswith("t2ms_tpu_torch.")]:
        del sys.modules[k]    # parent's functions keep their own modules
    sys.path.remove(os.path.abspath(root))
    change = importlib.import_module("t2ms_tpu_torch.ops.dit_block")
    check(change.__file__ != parent.__file__, "two packages to compare")
    out = {}
    for what, B, N, D, nsets in MOD_LN_SHAPES:
        f = lambda *s_: torch.randn(*s_, generator=gen,
                                    device="cuda").to(torch.bfloat16)
        sets = [(f(B, N, D), f(B, N, D), f(B, N, D), f(B, N, D),
                 0.3 * f(B, 6, D)) for _ in range(nsets)]
        pc, cc = mod_ln_calls(parent, sets), mod_ln_calls(change, sets)
        rows = {}
        with torch.no_grad():
            for k in pc:
                pc[k](), cc[k]()
                runs = {"parent": [], "change": []}
                for i in range(21):
                    for side in (("parent", "change") if i % 2 else
                                 ("change", "parent")):
                        fn = pc[k] if side == "parent" else cc[k]
                        runs[side].append(enqueue_us(fn, reps=1)[0])
                wins = sum(c < p_ for p_, c in zip(runs["parent"],
                                                   runs["change"])) / 21
                rows[k] = {f"{side}_us": [min(v), statistics.median(v)]
                           for side, v in runs.items()}
                rows[k]["change_wins"] = wins
                log(f"mod_ln host A/B {what} {k}: parent "
                    f"{min(runs['parent']):.1f} us (median "
                    f"{statistics.median(runs['parent']):.1f}), this tree "
                    f"{min(runs['change']):.1f} us (median "
                    f"{statistics.median(runs['change']):.1f}) to enqueue a "
                    f"call; this tree faster in {wins:.0%} of 21 pairs")
        out[what] = rows
        del sets, pc, cc
        torch.cuda.empty_cache()
    return out


def mod_ln_only(seed, root):
    """The LayerNorm kernels' section alone, on this tree's package or on
    ``root``'s: the card, the build of mod_ln.cu (this tree's chunk
    kernels' resources logged), then mod_ln_section (the twin checks on
    this tree only) and, with ``root``, mod_ln_host_ab; the last line is
    {"mod_ln": {what: {kernel: row}}, "host_ab": ..., "root": ...}."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    from t2ms_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"card: {smi}; package {os.path.dirname(_build.__file__)}")
    log(f"build: {_build.build_all(['mod_ln'])}")
    if root is None:
        log_mod_ln_resources()
    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    rows = mod_ln_section(gen, check_twin=root is None)
    host = mod_ln_host_ab(gen, root) if root is not None else None
    print(json.dumps({"mod_ln": rows, "host_ab": host, "root": root or ".",
                      "card": smi}), flush=True)
    return 0


def attention_backward_only(seed, root):
    """The attention backward's section alone, on this tree's package or
    on ``root``'s: the card, the build of fused_heads.cu and
    dit_block_bwd.cu with their heads_bwd resources, then
    attention_backward_phase; the last line is {"attention_backward":
    {what: row}, "root": ...}."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    from t2ms_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {smi}; package {os.path.dirname(_build.__file__)}")
    log(f"build: {_build.build_all(['fused_heads', 'dit_block_bwd'])}")
    check_bwd_resources()
    rows = attention_backward_phase(
        torch.Generator(device="cuda").manual_seed(seed + 21))
    print(json.dumps({"attention_backward": rows, "root": root or ".",
                      "card": smi}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attention_forward", action="store_true",
                    help="build, then run only the attention forward's "
                    "section, its last line a JSON of each path shape's row")
    ap.add_argument("--attention_backward", action="store_true",
                    help="build, then run only the attention backward's "
                    "section, its last line a JSON of each path shape's row")
    ap.add_argument("--row_gemms", action="store_true",
                    help="build, then run only the row kernels' section, its "
                    "last line a JSON of each call's rows")
    ap.add_argument("--split_gemms", action="store_true",
                    help="build, then run only the split block's GEMM "
                    "section, its last line a JSON of each call's stages")
    ap.add_argument("--mod_ln", action="store_true",
                    help="build, then run only the LayerNorm kernels' (#5-#8)"
                    " section, its last line a JSON of each call's rows")
    ap.add_argument("--root", default=None,
                    help="with --attention_forward, --attention_backward, "
                    "--row_gemms, --split_gemms or --mod_ln: import "
                    "t2ms_tpu_torch from this tree (another checkout, to "
                    "time it beside this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    if args.attention_forward:
        return attention_forward_only(args.seed, args.root)
    if args.attention_backward:
        return attention_backward_only(args.seed, args.root)
    if args.row_gemms:
        return row_gemms_only(args.seed, args.root)
    if args.split_gemms:
        return split_gemms_only(args.seed, args.root)
    if args.mod_ln:
        return mod_ln_only(args.seed, args.root)
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
    check_fwd_resources()
    check_bwd_resources()
    log_fwd_sass()
    log_exp_floors()
    # their own generators, so that the later phases draw what they drew
    # before
    attention_forward_phase(
        torch.Generator(device="cuda").manual_seed(args.seed + 20))
    attention_backward_phase(
        torch.Generator(device="cuda").manual_seed(args.seed + 21))
    row_gemm_phase(torch.Generator(device="cuda").manual_seed(args.seed + 22))
    row_bwd_phase(torch.Generator(device="cuda").manual_seed(args.seed + 23))

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
    mln = mod_ln_phase(gen)["scaled"]
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
    quality_gate_phase()
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
