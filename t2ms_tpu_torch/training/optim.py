"""Optimizers and LR schedules (counterpart of t2ms_tpu/training/optim.py).

The JAX package builds ``optax.adamw`` over the reference trainers'
schedules; the port uses ``torch.optim.AdamW`` with optax's semantics:

* b1 0.9, b2 0.999, eps 1e-8, and optax's default weight decay 1e-4
  (torch's default is 1e-2) where the JAX caller takes that default;
* the learning rate of an update is the schedule evaluated at the count of
  updates applied BEFORE it (optax's ``scale_by_schedule`` count): step i
  uses sched(i). ``ScheduledAdamW`` reads that count from its own state,
  so an update skipped by the trainer's ``nan_guard`` (which restores the
  state) does not advance the schedule, as optax's restored count does not.

The one-cycle schedule is ``optax.cosine_onecycle_schedule``'s formula
(with the JAX wrapper's floor of 4 steps), not
``torch.optim.lr_scheduler.OneCycleLR``, which agrees with it only to
about 2e-2. The recipes and their documented deviations from the
reference are described in the JAX module.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["ScheduledAdamW", "onecycle_schedule", "onecycle_adamw",
           "vae_schedule", "warmup_cosine_adamw"]


class ScheduledAdamW(torch.optim.AdamW):
    """``optax.adamw(schedule, weight_decay)`` in torch: AdamW with
    optax's constants, the learning rate set from ``schedule(count)`` before
    each update, count = updates applied so far."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4):
        super().__init__(params, lr=float(schedule(0)), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule

    def applied_updates(self) -> int:
        """The count of applied updates (AdamW's per-parameter ``step``,
        kept on the host, so reading it does not wait for the device)."""
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p)
                if st and "step" in st:
                    return int(st["step"])
        return 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = float(self.schedule(self.applied_updates()))
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def onecycle_schedule(total_steps: int, max_lr: float = 1e-4,
                      pct_start: float = 0.3, div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule(max(total_steps, 4), ...)``: cosine
    from max_lr/div_factor up to max_lr over int(pct_start*T) steps, then
    down to max_lr/(div_factor*final_div_factor) at T, flat after. The
    floor of 4 keeps every interval nonzero (optax divides by
    int(pct_start*T), which is 0 for T <= 3)."""
    T = max(total_steps, 4)
    bounds = (0, int(pct_start * T), int(T))
    init = max_lr / div_factor
    values = (init, init * div_factor,
              init * div_factor * (1.0 / (div_factor * final_div_factor)))

    def sched(count: int) -> float:
        for i in (0, 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                    math.cos(math.pi * pct) + 1)
        return values[-1]
    return sched


def onecycle_adamw(params, total_steps: int, max_lr: float = 1e-4,
                   weight_decay: float = 0.0) -> ScheduledAdamW:
    """The denoiser recipe: AdamW (weight decay 0, the reference's) under
    the one-cycle schedule."""
    return ScheduledAdamW(params, onecycle_schedule(total_steps, max_lr),
                          weight_decay)


def vae_schedule(base_lr: float, warmup_steps: int = 1000,
                 cosine_period: int = 600, start_factor: float = 0.1,
                 eta_min: float = 1e-6) -> Callable[[int], float]:
    """LinearLR warmup then *periodic* CosineAnnealingLR, matching torch's
    SequentialLR([LinearLR, CosineAnnealingLR], milestones=[1000])."""
    def sched(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (start_factor + (1 - start_factor)
                              * min(step, warmup_steps) / warmup_steps)
        t = step - warmup_steps
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1 + math.cos(math.pi * t / cosine_period))
    return sched


def warmup_cosine_adamw(params, base_lr: float = 1e-3,
                        weight_decay: float = 1e-2, warmup_steps: int = 1000,
                        cosine_period: int = 600) -> ScheduledAdamW:
    """The LA-VAE recipe: AdamW under ``vae_schedule``."""
    return ScheduledAdamW(params, vae_schedule(base_lr, warmup_steps,
                                               cosine_period), weight_decay)
