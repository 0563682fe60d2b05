"""Dynamic-batching serving engine (counterpart of
t2ms_tpu/serving/engine.py).

The engine quantizes every request onto a fixed grid of (out_length
bucket, batch tier) shapes, groups concurrent requests by bucket, pads the
group up to the smallest admitted tier, runs ONE sampler call and slices
the results back out per request. Results do not depend on batch
composition: each row's initial noise, and for the DDPM ancestral sampler
each step's noise, comes from its own seeded ``torch.Generator`` (or an
injected tensor) and ``cfg_scale`` is a per-row vector, so request i's
series depends only on (seed_i, cfg_i, text_emb_i, out_length_i).

Two threads form a pipeline: a dispatcher forms batches (deadline flush:
a batch launches when it fills the largest tier or its oldest request has
waited ``max_wait_ms``) and enqueues the device work, which CUDA runs
asynchronously; a completer copies each result to the host and fulfils the
futures, so the host copy of batch N overlaps the device work of batch N+1.

``make_serving_sampler`` is the shape-static analogue of
``sampling.make_cfg_sampler`` without the ground-truth input: serving never
touches the VAE encoder.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from t2ms_tpu_torch import resolve_device
from t2ms_tpu_torch.models.backbones import ddpm as ddpm_lib
from t2ms_tpu_torch.sampling.sampler import (_run_ddpm, _run_flow,
                                             _serving_forward,
                                             _validate_solver)

__all__ = ["make_serving_sampler", "ServingEngine", "GenerationResult",
           "EngineOverloaded", "row_noise", "row_draws"]


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the pending-request cap is reached."""


def row_draws(seeds, latent_shape: Tuple[int, int], steps: int,
              device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Row i's draws from its own generator seeded with seeds[i]: the
    (C, H) initial noise, then (when ``steps`` > 0) the row's (steps, C, H)
    DDPM step noise in one call. Returns x_t0 (B, C, H) and the step noise
    (steps, B, C, H) or None. The JAX engine folds the step into each
    row's key; here each row's generator continues after x_t0, so a row's
    draws depend on its seed alone either way."""
    x_t0, noise = [], []
    for s in np.asarray(seeds).reshape(-1):
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        x_t0.append(torch.randn(latent_shape, generator=g, device=device))
        if steps:
            noise.append(torch.randn((steps,) + tuple(latent_shape),
                                     generator=g, device=device))
    return (torch.stack(x_t0),
            torch.stack(noise, dim=1) if steps else None)


def row_noise(seeds, latent_shape: Tuple[int, int],
              device) -> torch.Tensor:
    """(B, C, H) standard-normal initial noise, row i drawn from its own
    generator seeded with seeds[i] (batch-composition independent)."""
    return row_draws(seeds, latent_shape, 0, device)[0]


def make_serving_sampler(
    denoiser,
    vae_model,
    backbone: str = "flowmatching",
    total_step: int = 100,
    latent_shape: Tuple[int, int] = (64, 30),
    out_length: int = 96,
    solver: str = "euler",
    sample_steps: Optional[int] = None,
    device=None,
) -> Callable:
    """Build the online-serving sampler; moves both models to ``device``
    (None = CUDA).

    Returned signature::

        sample(seeds, cfg_scale, text_emb, x_t0=None, step_noise=None)
            -> series

    with ``seeds`` (B,) per-row noise seeds, ``cfg_scale`` (B,) per-row
    guidance weights, ``text_emb`` (B, E); ``x_t0`` (B, C, H) injects the
    initial noise and ``step_noise`` (total_step, B, C, H) the DDPM
    ancestral noise instead of drawing them from the seeds (``row_draws``).
    DDIM is deterministic and draws no step noise."""
    _validate_solver(backbone, solver, sample_steps)
    dev = resolve_device(device)
    denoiser.to(dev)
    vae_model.to(dev)
    forward = _serving_forward(denoiser, dev)
    sched = (ddpm_lib.make_schedule(total_step, dev)
             if backbone == "ddpm" else None)
    steps = total_step if backbone == "ddpm" and solver != "ddim" else 0

    @torch.no_grad()
    def sample(seeds, cfg_scale, text_emb, x_t0=None,
               step_noise=None) -> torch.Tensor:
        if x_t0 is None:
            x_t0, drawn = row_draws(seeds, latent_shape, steps, dev)
            step_noise = drawn if step_noise is None else step_noise
        elif steps and step_noise is None:
            raise ValueError("an injected x_t0 needs its step_noise too "
                             "(DDPM ancestral sampling)")
        x_t0 = torch.as_tensor(x_t0, dtype=torch.float32, device=dev)
        scale = torch.as_tensor(cfg_scale, dtype=torch.float32,
                                device=dev)[:, None, None]
        text_emb = torch.as_tensor(text_emb, dtype=torch.float32, device=dev)
        if sched is None:
            x_t, _ = _run_flow(forward, solver, total_step, x_t0, text_emb,
                               scale, collect=False)
        else:
            x_t, _ = _run_ddpm(forward, sched, solver, sample_steps, x_t0,
                               text_emb, scale, False, step_noise)
        series, _ = vae_model.decode(x_t, out_length)
        return series

    return sample


@dataclass
class GenerationResult:
    """One fulfilled request."""
    series: np.ndarray
    seed: int
    out_length: int
    cfg_scale: float
    latency_s: float          # submit -> result ready
    batch_size: int           # tier the request was served at
    batched_with: int         # real (non-padding) rows in that batch


@dataclass
class _Pending:
    emb: np.ndarray
    seed: int
    cfg: float
    submit_t: float
    future: Future = field(default_factory=Future)


class ServingEngine:
    """Online generation service with per-bucket dynamic batching.

    Parameters
    ----------
    denoiser, vae_model
        The serving bundle (modules holding their weights).
    out_lengths
        Admitted output-length buckets; each bucket's latent shape comes
        from one encoder pass over a zero probe.
    batch_tiers
        Ascending fixed batch sizes; a request group is padded up to the
        smallest tier that fits.
    max_wait_ms
        Deadline-based flush: a non-full batch launches once its oldest
        request has waited this long.
    probe_shape
        Encoder input shape sans batch for ONE series (the trailing time
        dim is substituted per bucket); defaults to univariate ``(T,)``.
    max_pending
        Admission-control cap on queued requests; ``submit`` raises
        EngineOverloaded beyond it (None = unbounded).
    scaling_plan
        A one-device ``training.scaling.ScalingPlan`` (``n_data == 1``),
        as ``cli.serve`` passes, or None; data-parallel serving over
        several devices is not ported.
    device
        Where the models run (None = CUDA).
    """

    def __init__(self, denoiser, vae_model, *,
                 backbone: str = "flowmatching", total_step: int = 100,
                 solver: str = "euler", sample_steps: Optional[int] = None,
                 out_lengths: Sequence[int] = (96,),
                 batch_tiers: Sequence[int] = (1, 4, 16),
                 max_wait_ms: float = 20.0,
                 probe_shape: Optional[Tuple[int, ...]] = None,
                 default_cfg_scale: float = 7.0,
                 text_emb_dim: int = 128,
                 scaling_plan=None,
                 max_pending: Optional[int] = None,
                 device=None):
        n_data = getattr(scaling_plan, "n_data", None)
        if scaling_plan is not None and n_data != 1:
            raise NotImplementedError(
                f"scaling_plan with n_data={n_data}: data-parallel serving "
                f"across devices is not ported to t2ms_tpu_torch yet")
        if not out_lengths:
            raise ValueError("need at least one out_length bucket")
        tiers = sorted(set(int(b) for b in batch_tiers))
        if not tiers or tiers[0] < 1:
            raise ValueError(f"bad batch_tiers {batch_tiers}")
        self._device = resolve_device(device)
        self._tiers = tiers
        self._max_wait = max_wait_ms / 1e3
        self._default_cfg = float(default_cfg_scale)
        self._emb_dim = int(text_emb_dim)
        self._max_pending = max_pending
        vae_model.to(self._device)
        self._samplers: Dict[int, Callable] = {}
        self._latent: Dict[int, Tuple[int, int]] = {}
        for L in out_lengths:
            probe = ((int(L),) if probe_shape is None
                     else tuple(probe_shape[:-1]) + (int(L),))
            with torch.no_grad():
                z, _ = vae_model.encode(torch.zeros((1,) + probe,
                                                    device=self._device))
            self._latent[int(L)] = (int(z.shape[1]), int(z.shape[2]))
            # one sampler per bucket serves every tier (eager torch has no
            # per-shape compile)
            self._samplers[int(L)] = make_serving_sampler(
                denoiser, vae_model, backbone, total_step,
                self._latent[int(L)], int(L), solver, sample_steps,
                self._device)

        # serializes the device work of the dispatcher and of warmup()
        self._dispatch_lock = threading.Lock()
        self._lock = threading.Condition()
        self._queues: Dict[int, collections.deque] = {
            int(L): collections.deque() for L in out_lengths}
        self._stop = False
        self._seed_counter = 0
        self._stats = dict(requests=0, batches=0, padded_rows=0,
                           served_rows=0, latencies=[])
        self._bucket_stats = {
            int(L): dict(batches=0, padded_rows=0, served_rows=0,
                         latencies=[]) for L in out_lengths}
        # maxsize bounds the batches queued on the device
        self._inflight = _queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="t2ms-torch-serving-dispatch")
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True,
            name="t2ms-torch-serving-complete")
        self._worker.start()
        self._completer.start()

    # ------------------------------------------------------------- API

    def submit(self, text_emb: np.ndarray, out_length: int,
               cfg_scale: Optional[float] = None,
               seed: Optional[int] = None) -> Future:
        """Queue one generation; returns a Future of GenerationResult."""
        out_length = int(out_length)
        if out_length not in self._queues:
            raise ValueError(f"out_length {out_length} is not an admitted "
                             f"bucket {sorted(self._queues)}")
        emb = np.asarray(text_emb, dtype=np.float32)
        if emb.shape != (self._emb_dim,):
            raise ValueError(f"text_emb must be ({self._emb_dim},) per "
                             f"request, got {emb.shape}")
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            if self._max_pending is not None and \
                    sum(len(q) for q in self._queues.values()) \
                    >= self._max_pending:
                raise EngineOverloaded(
                    f"{self._max_pending} requests already pending")
            if seed is None:
                seed = self._seed_counter
                self._seed_counter += 1
            req = _Pending(emb, int(seed) & 0xFFFFFFFF,
                           float(self._default_cfg if cfg_scale is None
                                 else cfg_scale), time.monotonic())
            self._queues[out_length].append(req)
            self._stats["requests"] += 1
            self._lock.notify_all()
        return req.future

    def generate(self, requests) -> list:
        """Submit many [(text_emb, out_length[, cfg[, seed]]), ...] and
        block for all results (order preserved)."""
        futs = [self.submit(*r) for r in requests]
        return [f.result() for f in futs]

    def warmup(self) -> None:
        """Run every (bucket, tier) once with zero embeddings and the
        default cfg, through the launch path of a real batch: on the card
        that builds the kernels on first use and lets the library GEMMs
        pick their algorithms for each shape. Leaves ``stats()`` and the
        seed counter alone and returns when the device work is done."""
        for L in self._samplers:
            for tier in self._tiers:
                out = self._sample(L, np.zeros((tier,), np.uint32),
                                   np.full((tier,), self._default_cfg,
                                           np.float32),
                                   np.zeros((tier, self._emb_dim),
                                            np.float32))
        if out.is_cuda:
            torch.cuda.synchronize(out.device)

    @staticmethod
    def _summarize(s: dict) -> dict:
        lat = sorted(s["latencies"])
        served = s["served_rows"]
        return dict(
            batches=s["batches"],
            served_rows=served,
            padding_fraction=(s["padded_rows"] /
                              max(1, served + s["padded_rows"])),
            p50_latency_s=lat[len(lat) // 2] if lat else None,
            p95_latency_s=lat[int(len(lat) * 0.95)] if lat else None,
        )

    def stats(self) -> dict:
        with self._lock:
            out = self._summarize(self._stats)
            out["requests"] = self._stats["requests"]
            if len(self._bucket_stats) > 1:
                out["per_bucket"] = {
                    str(L): self._summarize(s)
                    for L, s in self._bucket_stats.items()}
            return out

    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher. ``drain=True`` serves everything already
        queued first; ``drain=False`` fails pending futures."""
        with self._lock:
            self._stop = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        q.popleft().future.set_exception(
                            RuntimeError("engine shut down"))
            self._lock.notify_all()
        self._worker.join(timeout=600.0)
        self._completer.join(timeout=600.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------ dispatcher

    def _run(self):
        while True:
            batch = None
            with self._lock:
                while True:
                    batch = self._pick_batch()
                    if batch is not None or self._stop:
                        break
                    self._lock.wait(timeout=self._wait_budget())
                if batch is None and self._stop:
                    self._inflight.put(None)       # completer sentinel
                    return
            L, reqs = batch
            try:
                self._launch(L, reqs)
            except Exception as e:  # noqa: BLE001 - fulfil futures
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _wait_budget(self) -> Optional[float]:
        """Sleep until the oldest pending request's deadline, or (when that
        deadline has passed but the batch is held on a full pipeline) until
        the completer frees a slot and notifies."""
        oldest = None
        for q in self._queues.values():
            if q and (oldest is None or q[0].submit_t < oldest):
                oldest = q[0].submit_t
        if oldest is None:
            return None
        rem = oldest + self._max_wait - time.monotonic()
        return rem if rem > 0 else None

    def _pick_batch(self):
        """Under the lock: the bucket whose batch should launch — any full
        tier immediately, else the oldest expired deadline (held while the
        in-flight pipeline is full, so it keeps aggregating toward a full
        tier), else (when draining) anything left."""
        now = time.monotonic()
        pipeline_full = self._inflight.full()
        best = None
        for L, q in self._queues.items():
            if not q:
                continue
            full = len(q) >= self._tiers[-1]
            expired = ((now - q[0].submit_t) >= self._max_wait
                       and not pipeline_full)
            if full or expired or self._stop:
                age = now - q[0].submit_t
                if best is None or age > best[1]:
                    best = (L, age)
        if best is None:
            return None
        L = best[0]
        q = self._queues[L]
        n = min(len(q), self._tiers[-1])
        return L, [q.popleft() for _ in range(n)]

    def _launch(self, L: int, reqs):
        """Pad to the tier, enqueue the device work, hand the (still
        running) result to the completer; blocks when the pipeline is
        full."""
        tier = next(t for t in self._tiers if t >= len(reqs))
        n = len(reqs)
        emb = np.stack([r.emb for r in reqs] +
                       [reqs[-1].emb] * (tier - n))
        seeds = np.array([r.seed for r in reqs] + [0] * (tier - n),
                         dtype=np.uint32)
        cfg = np.array([r.cfg for r in reqs] +
                       [self._default_cfg] * (tier - n), dtype=np.float32)
        out = self._sample(L, seeds, cfg, emb)
        done = None
        if out.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
        self._inflight.put((L, tier, reqs, out, done))

    def _sample(self, L: int, seeds, cfg, emb) -> torch.Tensor:
        """Enqueue one batch's device work; returns the (still running)
        series."""
        with self._dispatch_lock:
            return self._samplers[L](seeds, cfg, emb)

    def _complete_loop(self):
        """Copy each in-flight batch to the host, account stats, fulfil
        futures. Runs until the dispatcher's shutdown sentinel."""
        while True:
            item = self._inflight.get()
            with self._lock:
                # a pipeline slot just freed: wake a held dispatcher
                self._lock.notify_all()
            if item is None:
                return
            L, tier, reqs, out, done = item
            try:
                if done is not None:
                    done.synchronize()
                series = out.cpu().numpy()
            except Exception as e:  # noqa: BLE001 - surface to futures
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            n = len(reqs)
            t_done = time.monotonic()
            with self._lock:
                self._stats["batches"] += 1
                self._stats["served_rows"] += n
                self._stats["padded_rows"] += tier - n
                bs = self._bucket_stats[L]
                bs["batches"] += 1
                bs["served_rows"] += n
                bs["padded_rows"] += tier - n
                for r in reqs:
                    self._stats["latencies"].append(t_done - r.submit_t)
                    bs["latencies"].append(t_done - r.submit_t)
                # bound the window: a long-running server must not leak
                if len(self._stats["latencies"]) > 20_000:
                    del self._stats["latencies"][:10_000]
                if len(bs["latencies"]) > 20_000:
                    del bs["latencies"][:10_000]
            for i, r in enumerate(reqs):
                r.future.set_result(GenerationResult(
                    series=series[i], seed=r.seed, out_length=L,
                    cfg_scale=r.cfg, latency_s=t_done - r.submit_t,
                    batch_size=tier, batched_with=n))
