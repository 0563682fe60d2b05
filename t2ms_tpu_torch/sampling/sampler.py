"""CFG sampling (counterpart of t2ms_tpu/sampling/sampler.py).

Reference loop (infer.py:65-110): ``total_step`` steps with TWO forwards
per step (uncond + cond), ``pred = uncond + cfg_scale * (cond - uncond)``
and an Euler update over forward flow time t = j / total_step, or for the
DDPM backbone an ancestral step over the integer timestep t = T-1-j
(``solver='ddim'``: deterministic DDIM over a ``sample_steps`` subset of
the schedule). As in the JAX package, cond and uncond run as ONE forward
of batch 2B, the uncond half selected by a per-sample ``text_mask`` of
zeros; the trajectory is optionally collected and decoded in one batched
VAE decode afterwards.

On CUDA the DiT forward goes through a fused kernel path, picked once per
sampler build (``_serving_forward``): the stack kernel, else the split
block kernel, else the flax path's kernels; a geometry none takes raises
there. Only an explicit
``attention_impl`` other than 'auto' opts out to the eager model (the plain
path that oracle runs compare against). A Python loop stands in for the
JAX package's ``lax.scan``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.models.backbones import ddpm as ddpm_lib
from t2ms_tpu_torch.models.backbones import rectified_flow as rf

__all__ = ["SamplerOutput", "make_cfg_sampler", "decode_trajectory"]


class SamplerOutput(NamedTuple):
    series: torch.Tensor                 # decoded (B, ...) at output length
    latent: torch.Tensor                 # final latent x_t
    latent_enc: torch.Tensor             # VAE-encoded ground-truth latent
    trajectory: Optional[torch.Tensor]   # (steps, B, ...) latents or None


def _serving_forward(denoiser, device) -> Callable:
    """Pick the DiT forward once, for a sampler that runs on ``device``, in
    the JAX package's order (t2ms_tpu/sampling/sampler.py
    ``_serving_forward``): for a DiT on CUDA, the stack kernel when it takes
    the geometry, else the split block kernel, else the flax path's kernels
    (``dit_fast.flax_path_forward`` under ``no_grad``), else raise; the
    eager module on the CPU or under an explicit ``attention_impl``
    opt-out. Each check asks a kernel library, so it is asked here and not
    per step.

    The stack and split routes take the JAX package's token range
    (128 <= N <= 1024, N % 8 == 0) and, inside it, the port's own kernels'
    limits, not the TPU's VMEM envelopes: a d=256 DiT at N=1024 goes to
    the split in JAX and may take the stack here. Both compute the same
    block. The long-series DiT (4096 tokens) takes the flax path, as in
    JAX; its attention is JAX's on a TPU too (fused heads, or flash at
    8192 tokens). A geometry no route takes raises, naming the kernels the
    flax path would run and their limits: the eager model is not run in
    the kernels' place."""
    from t2ms_tpu_torch.models.denoisers import dit_fast
    if not dit_fast.fused_path_eligible(denoiser, device):
        return denoiser
    if dit_fast.fast_forward_supported(denoiser):
        return functools.partial(dit_fast.fast_dit_forward, denoiser)
    if dit_fast.split_forward_supported(denoiser):
        return functools.partial(dit_fast.split_dit_forward, denoiser)
    if dit_fast.flax_path_supported(denoiser):
        return torch.no_grad()(functools.partial(dit_fast.flax_path_forward,
                                                 denoiser))
    d = denoiser
    raise ValueError(
        f"the port does not take this DiT on CUDA: neither fused_dit_stack "
        f"nor fused_dit_block_split (128 <= tokens <= 1024) nor the flax "
        f"path's kernels ({dit_fast.flax_path_kernels(d)}) take "
        f"d_model={d.d_model} heads={d.num_heads} "
        f"hidden={int(d.d_model * d.mlp_ratio)} tokens={d.num_patches} "
        f"dtype={d.compute_dtype}; the eager model is not run in their "
        f"place (set attention_impl to opt out)")


def _fused_cfg_forward(forward: Callable, x_t, t, text_emb, cfg_scale):
    """One 2B-batch forward for the CFG pair; the uncond half carries a
    ``text_mask`` of zeros (the reference's text=None, infer.py:79-88)."""
    B = x_t.shape[0]
    x2 = torch.cat([x_t, x_t], dim=0)
    t2 = torch.cat([t, t], dim=0)
    e2 = torch.cat([text_emb, text_emb], dim=0)
    m2 = torch.cat([torch.zeros((B,), dtype=x_t.dtype, device=x_t.device),
                    torch.ones((B,), dtype=x_t.dtype, device=x_t.device)])
    pred2 = forward(x2, t2, e2, m2)
    uncond, cond = pred2[:B], pred2[B:]
    return uncond + cfg_scale * (cond - uncond)


def _validate_solver(backbone: str, solver: str,
                     sample_steps: Optional[int]) -> None:
    """Backbone/solver pairing rules of the JAX package."""
    if backbone not in ("flowmatching", "ddpm"):
        raise ValueError(f"Unsupported backbone type: {backbone}")
    if solver not in ("euler", "heun", "midpoint", "ddim"):
        raise ValueError(f"Unsupported solver: {solver}")
    if solver in ("heun", "midpoint") and backbone != "flowmatching":
        raise ValueError("higher-order solvers integrate the flow ODE; "
                         "ddpm sampling is ancestral (euler) or ddim")
    if solver == "ddim" and backbone != "ddpm":
        raise ValueError("ddim subsamples the DDPM schedule; flow "
                         "sampling takes solver=euler|heun|midpoint")
    if sample_steps is not None and solver != "ddim":
        raise ValueError("sample_steps only applies to solver='ddim' "
                         "(other solvers run total_step steps)")


def _flow_step(solver: str, vel: Callable, x_t, j: int, total_step: int):
    """One flow-ODE integrator step; ``vel(x, t_scalar)`` is the CFG
    velocity. Shared by the offline and serving samplers."""
    dt = 1.0 / total_step
    t0 = j / total_step
    if solver == "euler":
        return rf.euler(x_t, vel(x_t, t0), dt)
    v1 = vel(x_t, t0)
    if solver == "heun":                 # explicit trapezoid, order 2
        v2 = vel(rf.euler(x_t, v1, dt), t0 + dt)
        return x_t + (0.5 * dt) * (v1 + v2)
    v2 = vel(rf.euler(x_t, v1, 0.5 * dt), t0 + 0.5 * dt)   # midpoint
    return x_t + dt * v2


def _run_flow(forward, solver, total_step, x_t0, text_emb, cfg_scale,
              collect: bool):
    """The sampling loop from x_t0; returns (x_T, trajectory or None)."""
    B = x_t0.shape[0]

    def vel(x_t, t_scalar):
        t = torch.full((B,), t_scalar, dtype=x_t0.dtype, device=x_t0.device)
        return _fused_cfg_forward(forward, x_t, t, text_emb, cfg_scale)

    x_t, traj = x_t0, []
    for j in range(total_step):
        x_t = _flow_step(solver, vel, x_t, j, total_step)
        if collect:
            traj.append(x_t)
    return x_t, (torch.stack(traj) if collect else None)


def _run_ddpm(forward, sched, solver, sample_steps, x_t0, text_emb,
              cfg_scale, collect: bool, step_noise=None, generator=None):
    """The DDPM loop from x_t0: ancestral over t = T-1-j with
    ``step_noise[j]`` (else drawn from ``generator``) added at every step,
    t = 0 included; or DDIM over ``ddim_timesteps(T, sample_steps)``.
    The timestep is int32, never the latent's dtype: the DiT scales it by
    100 in f32. Returns (x_0, trajectory or None)."""
    B, dev = x_t0.shape[0], x_t0.device
    T = sched.total_steps
    full = lambda v: torch.full((B,), int(v), dtype=torch.int32, device=dev)
    if step_noise is not None:
        step_noise = torch.as_tensor(step_noise, dtype=x_t0.dtype, device=dev)
    x_t, traj = x_t0, []
    if solver == "ddim":
        ts, prev = ddpm_lib.ddim_timesteps(T, sample_steps or T)
        for t_cur, t_prev in zip(ts.tolist(), prev.tolist()):
            t = full(t_cur)
            eps = _fused_cfg_forward(forward, x_t, t, text_emb, cfg_scale)
            x_t = ddpm_lib.ddim_step(sched, x_t, eps, t, full(t_prev))
            if collect:
                traj.append(x_t)
    else:
        for j in range(T):
            t = full(T - 1 - j)
            eps = _fused_cfg_forward(forward, x_t, t, text_emb, cfg_scale)
            x_t = ddpm_lib.p_sample(
                sched, x_t, eps, t, generator=generator,
                noise=None if step_noise is None else step_noise[j])
            if collect:
                traj.append(x_t)
    return x_t, (torch.stack(traj) if collect else None)


def make_cfg_sampler(
    denoiser,
    vae_model,
    backbone: str = "flowmatching",
    total_step: int = 100,
    cfg_scale: float = 7.0,
    out_length: int = 96,
    collect_trajectory: bool = False,
    solver: str = "euler",
    sample_steps: Optional[int] = None,
    device=None,
) -> Callable:
    """Build the offline sampler; moves both models to ``device`` (None =
    CUDA).

    Returned signature: ``sample(x_1, text_emb, x_t0=None, generator=None,
    step_noise=None) -> SamplerOutput``. ``x_1`` is the conditioning
    ground-truth batch (its encoded latent gives the noise shape and the
    diagnostic ``latent_enc``, infer.py:73-75). ``x_t0`` injects the
    initial noise; otherwise it is drawn from ``generator``. The DDPM
    ancestral sampler adds ``step_noise[j]`` ((total_step, B, C, L)) at
    step j; otherwise each step's noise is drawn from ``generator`` after
    ``x_t0``. ``solver='ddim'`` (DDPM only) runs ``sample_steps`` of the
    ``total_step`` schedule.
    """
    _validate_solver(backbone, solver, sample_steps)
    dev = resolve_device(device)
    denoiser.to(dev)
    vae_model.to(dev)
    forward = _serving_forward(denoiser, dev)
    sched = (ddpm_lib.make_schedule(total_step, dev)
             if backbone == "ddpm" else None)

    @torch.no_grad()
    def sample(x_1, text_emb, x_t0=None, generator=None,
               step_noise=None) -> SamplerOutput:
        x_1 = torch.as_tensor(x_1, dtype=torch.float32, device=dev)
        text_emb = torch.as_tensor(text_emb, dtype=torch.float32, device=dev)
        z_enc, _ = vae_model.encode(x_1)
        if x_t0 is None:
            x_t0 = torch.randn(z_enc.shape, generator=generator,
                               dtype=z_enc.dtype, device=dev)
        x_t0 = torch.as_tensor(x_t0, dtype=z_enc.dtype, device=dev)
        if sched is not None:
            x_t, traj = _run_ddpm(forward, sched, solver, sample_steps,
                                  x_t0, text_emb, cfg_scale,
                                  collect_trajectory, step_noise, generator)
        else:
            x_t, traj = _run_flow(forward, solver, total_step, x_t0,
                                  text_emb, cfg_scale, collect_trajectory)
        series, _ = vae_model.decode(x_t, out_length)
        return SamplerOutput(series=series, latent=x_t, latent_enc=z_enc,
                             trajectory=traj)

    return sample


@torch.no_grad()
def decode_trajectory(vae_model, trajectory: torch.Tensor, out_length: int,
                      sample_index: int = 0) -> torch.Tensor:
    """Decode one sample's whole latent trajectory in a single batched VAE
    decode (the reference decodes per step, infer.py:90-93).
    trajectory: (steps, B, C, L) -> (steps, ...)."""
    series, _ = vae_model.decode(trajectory[:, sample_index], out_length)
    return series
