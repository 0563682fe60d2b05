"""DDPM backbone as plain tensor functions (counterpart of
t2ms_tpu/models/backbones/ddpm.py).

  make_schedule:  linear beta 1e-4 -> 0.02 over T steps (f32),
                  alpha_bar = cumprod(1 - beta)
  q_sample:       x_t = sqrt(a_bar) x0 + sqrt(1 - a_bar) eps
  p_sample:       one ancestral reverse step, sigma^2 = beta, noise added
                  at every step (t = 0 included)
  ddim_step:      one deterministic DDIM step (eta = 0) t -> t_prev
  loss:           MSE(eps_pred, eps)

Sampling runs backwards, t = T-1-j. The timestep ``t`` is an integer
tensor (B,): the DiT scales it by 100 in f32, so it must never be built in
a bf16 latent's dtype. torch cannot reproduce the JAX package's threefry
bits, so ``p_sample`` takes its noise as an argument (or a ``generator``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["DDPMSchedule", "make_schedule", "q_sample", "p_sample",
           "p_sample_mean_var", "ddim_step", "ddim_timesteps", "loss"]


class DDPMSchedule(NamedTuple):
    beta: torch.Tensor        # (T,) f32
    alpha: torch.Tensor       # (T,)
    alpha_bar: torch.Tensor   # (T,)
    total_steps: int


def _linspace_f32(start: float, stop: float, n: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, n, dtype=float32)``'s formula: s = i /
    (n-1), then start * (1 - s) + stop * s in f32, the last point exactly
    ``stop``. XLA folds and contracts it into FMAs, so the two agree to an
    ulp (torch.linspace uses another formula)."""
    a = torch.tensor(start, dtype=torch.float32)
    b = torch.tensor(stop, dtype=torch.float32)
    if n == 1:
        return a[None]
    s = torch.arange(n - 1, dtype=torch.float32) / float(n - 1)
    return torch.cat([a * (1 - s) + b * s, b[None]])


def make_schedule(total_steps: int, device=None) -> DDPMSchedule:
    beta = _linspace_f32(1e-4, 0.02, total_steps)
    alpha = 1.0 - beta
    alpha_bar = torch.cumprod(alpha, dim=0)
    to = lambda a: a.to(device) if device is not None else a
    return DDPMSchedule(to(beta), to(alpha), to(alpha_bar), total_steps)


def _gather(consts: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """consts[t] shaped (B, 1, 1, ...) for broadcasting."""
    c = consts[t.long()]
    return c.reshape(c.shape[0], *((1,) * (ndim - 1)))


def q_sample(sched: DDPMSchedule, x0: torch.Tensor, t: torch.Tensor,
             eps: torch.Tensor):
    """Forward noising: returns (x_t, eps)."""
    a_bar = _gather(sched.alpha_bar, t, x0.ndim)
    return torch.sqrt(a_bar) * x0 + torch.sqrt(1.0 - a_bar) * eps, eps


def p_sample_mean_var(sched: DDPMSchedule, xt: torch.Tensor,
                      eps_pred: torch.Tensor, t: torch.Tensor):
    """Posterior mean and variance of one ancestral reverse step; the
    serving engine adds each row's own noise to the same mean."""
    a_bar = _gather(sched.alpha_bar, t, xt.ndim)
    a = _gather(sched.alpha, t, xt.ndim)
    eps_coef = (1.0 - a) / torch.sqrt(1.0 - a_bar)
    mean = (xt - eps_coef * eps_pred) / torch.sqrt(a)
    return mean, _gather(sched.beta, t, xt.ndim)


def p_sample(sched: DDPMSchedule, xt: torch.Tensor, eps_pred: torch.Tensor,
             t: torch.Tensor, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One ancestral reverse step; ``noise`` (xt's shape) is drawn from
    ``generator`` when not given. Noise is added at t = 0 too."""
    mean, var = p_sample_mean_var(sched, xt, eps_pred, t)
    if noise is None:
        noise = torch.randn(xt.shape, generator=generator, dtype=xt.dtype,
                            device=xt.device)
    return mean + torch.sqrt(var) * noise


def ddim_step(sched: DDPMSchedule, xt: torch.Tensor, eps_pred: torch.Tensor,
              t: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM update t -> t_prev (eta = 0); ``t_prev < 0``
    is the terminal step (alpha_bar_prev = 1), which returns the
    predicted x0."""
    a_bar = _gather(sched.alpha_bar, t, xt.ndim)
    a_prev = torch.where(t_prev >= 0,
                         sched.alpha_bar[torch.clamp(t_prev, min=0).long()],
                         torch.ones((), dtype=a_bar.dtype,
                                    device=a_bar.device))
    a_prev = a_prev.reshape(a_bar.shape)
    x0 = (xt - torch.sqrt(1.0 - a_bar) * eps_pred) / torch.sqrt(a_bar)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps_pred


def ddim_timesteps(total_steps: int, sample_steps: int):
    """Evenly spaced sub-schedule (descending): (t_cur, t_prev) int32 numpy
    arrays of length <= ``sample_steps`` with t_prev[-1] = -1 (rounding
    duplicates collapse, so the count can be lower when sample_steps
    approaches total_steps)."""
    if not 1 <= sample_steps <= total_steps:
        raise ValueError(f"sample_steps {sample_steps} must be in "
                         f"[1, {total_steps}]")
    # descending from T-1 so the first step denoises from the max noise
    ts = np.round(np.linspace(total_steps - 1, 0,
                              sample_steps)).astype(np.int64)
    ts = np.unique(ts)[::-1]
    prev = np.concatenate([ts[1:], [-1]])
    return ts.astype("int32"), prev.astype("int32")


def loss(eps_pred: torch.Tensor, eps_gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(eps_pred - eps_gt))
