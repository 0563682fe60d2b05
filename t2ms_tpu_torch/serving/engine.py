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

Data parallelism (a ``scaling_plan`` whose mesh spans a process group, one
process per device): the engine runs on rank 0 and every other rank runs
``serve_worker``. A dispatch of a tier that ``n_data`` divides broadcasts
a fixed-size header (stop flag, length, tier) and the rows' seeds, cfg and
embeddings over 'data'; every rank samples its own rows, and
``dist.gather`` brings the series back to rank 0. A tier that ``n_data``
does not divide runs whole on rank 0, as in JAX. Per-row seeds and cfg
keep a row's series independent of the batch it is in, which is what
makes the split exact. All of rank 0's collectives go from the
dispatcher thread; ``close()`` sends the workers the stop header.
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
from t2ms_tpu_torch.parallel.mesh import shard_batch
from t2ms_tpu_torch.sampling.sampler import (_run_ddpm, _run_flow,
                                             _serving_forward,
                                             _validate_solver)

__all__ = ["make_serving_sampler", "ServingEngine", "GenerationResult",
           "EngineOverloaded", "row_noise", "row_draws", "serve_worker"]


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


def _dp_mesh(plan):
    """The mesh a plan's dispatches split over, or None. A plan with
    n_data > 1 and no process group is refused: it never runs
    undistributed."""
    if plan is None:
        return None
    mesh = getattr(plan, "mesh", None)
    if mesh is not None and getattr(mesh, "distributed", False):
        return mesh
    n_data = getattr(plan, "n_data", None)
    if n_data != 1:
        raise ValueError(
            f"scaling_plan with n_data={n_data} and no process group: a "
            f"data-parallel plan needs the mesh of its ranks "
            f"(training.scaling.setup_scaling in every rank's process)")
    return None


def _bucket_samplers(denoiser, vae_model, backbone, total_step, solver,
                     sample_steps, out_lengths, probe_shape, device):
    """One serving sampler per output-length bucket (every tier shares it:
    eager torch has no per-shape compile), and each bucket's latent shape
    from one encoder pass over a zero probe."""
    vae_model.to(device)
    samplers: Dict[int, Callable] = {}
    latent: Dict[int, Tuple[int, int]] = {}
    for L in out_lengths:
        probe = ((int(L),) if probe_shape is None
                 else tuple(probe_shape[:-1]) + (int(L),))
        with torch.no_grad():
            z, _ = vae_model.encode(torch.zeros((1,) + probe, device=device))
        latent[int(L)] = (int(z.shape[1]), int(z.shape[2]))
        samplers[int(L)] = make_serving_sampler(
            denoiser, vae_model, backbone, total_step, latent[int(L)],
            int(L), solver, sample_steps, device)
    return samplers, latent


# header of a data-parallel dispatch: (stop, out_length, tier); tier 0 is
# a no-op that keeps the other ranks' pending broadcast inside the group's
# timeout while rank 0 has no batch
_HEADER = 3


def _root(mesh) -> int:
    """The global rank of data coordinate 0 in this rank's data group."""
    return torch.distributed.get_global_rank(mesh.group("data"), 0)


def _send_header(mesh, device, stop, L, tier):
    h = torch.tensor([stop, L, tier], dtype=torch.int64, device=device)
    torch.distributed.broadcast(h, _root(mesh), group=mesh.group("data"))


def _dp_sample(mesh, device, sampler, L, seeds, cfg, emb):
    """Rank 0's side of one dispatch: the header and the rows, then its
    own rows, then the series of every rank's rows."""
    _send_header(mesh, device, 0, L, len(seeds))
    rows = _broadcast_rows(mesh, device, len(seeds), emb.shape[1],
                           (seeds, cfg, emb))
    return _sample_rows(mesh, sampler, *rows)


def _broadcast_rows(mesh, device, tier, emb_dim, arrays=None):
    """Broadcast a dispatch's seeds (int64), cfg and embeddings from rank
    0 of 'data'; ``arrays`` on rank 0, None on the others."""
    src, group = _root(mesh), mesh.group("data")
    out = []
    for i, (shape, dt) in enumerate((((tier,), torch.int64),
                                     ((tier,), torch.float32),
                                     ((tier, emb_dim), torch.float32))):
        t = (torch.as_tensor(np.asarray(arrays[i]).astype(
                 np.int64 if dt == torch.int64 else np.float32),
                 device=device) if arrays is not None
             else torch.empty(shape, dtype=dt, device=device))
        torch.distributed.broadcast(t, src, group=group)
        out.append(t)
    return out


def _sample_rows(mesh, sampler, seeds, cfg, emb):
    """Sample this rank's rows of a dispatch; rank 0 gets every rank's
    series back (in rank order), the others None."""
    seeds, cfg, emb = shard_batch(mesh, (seeds, cfg, emb))
    series = sampler(seeds.cpu().numpy().astype(np.uint32), cfg, emb)
    parts = None
    if mesh.index("data") == 0:
        parts = [torch.empty_like(series)
                 for _ in range(mesh.shape["data"])]
    torch.distributed.gather(series.contiguous(), parts, _root(mesh),
                             group=mesh.group("data"))
    return None if parts is None else torch.cat(parts)


def serve_worker(plan, denoiser, vae_model, *,
                 backbone: str = "flowmatching", total_step: int = 100,
                 solver: str = "euler", sample_steps: Optional[int] = None,
                 out_lengths: Sequence[int] = (96,),
                 probe_shape: Optional[Tuple[int, ...]] = None,
                 text_emb_dim: int = 128, device=None, **_engine_kw) -> int:
    """The loop of a data-parallel engine's other ranks: take each
    dispatch's header and rows from rank 0, sample this rank's rows and
    send their series back, until the engine's ``close()`` sends the stop
    header; a no-op header (tier 0) only restarts the wait. Takes the
    engine's keyword arguments (the batching ones are ignored). Returns the
    number of dispatches served."""
    mesh = _dp_mesh(plan)
    if mesh is None or mesh.index("data") == 0:
        raise ValueError("serve_worker runs on the data ranks other than "
                         "0 of a data-parallel plan")
    dev = resolve_device(device)
    samplers, _ = _bucket_samplers(denoiser, vae_model, backbone,
                                   total_step, solver, sample_steps,
                                   out_lengths, probe_shape, dev)
    n = 0
    while True:
        h = torch.empty((_HEADER,), dtype=torch.int64, device=dev)
        torch.distributed.broadcast(h, _root(mesh), group=mesh.group("data"))
        stop, L, tier = (int(v) for v in h.tolist())
        if stop:
            return n
        if not tier:
            continue
        _sample_rows(mesh, samplers[L],
                     *_broadcast_rows(mesh, dev, tier, text_emb_dim))
        n += 1


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
        A ``training.scaling.ScalingPlan`` or None. A plan whose mesh runs
        over a process group makes the engine data parallel (this rank
        must be rank 0, the others run ``serve_worker``); a plan with
        ``n_data > 1`` and no such mesh is refused, as it never runs
        undistributed. While it has no batch, a data-parallel engine sends
        the other ranks a no-op header every quarter of the group's
        timeout, so that an idle server outlives it.
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
        self._mesh = _dp_mesh(scaling_plan)
        if self._mesh is not None and self._mesh.index("data") != 0:
            raise ValueError("the data-parallel engine runs on rank 0; "
                             "the other ranks run serve_worker")
        if not out_lengths:
            raise ValueError("need at least one out_length bucket")
        tiers = sorted(set(int(b) for b in batch_tiers))
        if not tiers or tiers[0] < 1:
            raise ValueError(f"bad batch_tiers {batch_tiers}")
        self._device = resolve_device(device)
        self._emb_dim = int(text_emb_dim)
        self._samplers, self._latent = _bucket_samplers(
            denoiser, vae_model, backbone, total_step, solver, sample_steps,
            out_lengths, probe_shape, self._device)
        self._tiers = tiers
        self._max_wait = max_wait_ms / 1e3
        self._default_cfg = float(default_cfg_scale)
        self._max_pending = max_pending
        self._tasks: collections.deque = collections.deque()
        self._last_header = time.monotonic()

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
        seed counter alone and returns when the device work is done. It
        runs on the dispatcher thread, which makes every device call (and
        every collective of rank 0)."""
        fut = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._tasks.append((self._warmup, fut))
            self._lock.notify_all()
        fut.result()

    def _warmup(self) -> None:
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
            task = None
            ping = False
            with self._lock:
                while True:
                    if self._tasks:
                        task = self._tasks.popleft()
                        break
                    batch = self._pick_batch()
                    if batch is not None or self._stop:
                        break
                    wait = self._wait_budget()
                    if self._mesh is not None:
                        left = (self._last_header - time.monotonic()
                                + self._mesh.timeout_s / 4)
                        if left <= 0:
                            ping = True
                            break
                        wait = left if wait is None else min(wait, left)
                    self._lock.wait(timeout=wait)
            if ping:
                try:
                    self._header(0, 0, 0)
                except Exception as e:  # noqa: BLE001 - a rank is gone
                    # the group is broken: shut down and fail what waits
                    with self._lock:
                        self._stop = True
                        for q in self._queues.values():
                            while q:
                                q.popleft().future.set_exception(e)
                    self._inflight.put(None)       # completer sentinel
                    return
                continue
            if task is not None:
                fn, fut = task
                try:
                    fut.set_result(self._on_device(fn))
                except Exception as e:  # noqa: BLE001 - to the caller
                    fut.set_exception(e)
                continue
            if batch is None:
                if self._mesh is not None:
                    self._header(1, 0, 0)
                self._inflight.put(None)           # completer sentinel
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
        series. A tier that the data axis divides is split over it."""
        mesh = self._mesh
        if mesh is None or len(seeds) % mesh.shape["data"]:
            return self._samplers[L](seeds, cfg, emb)
        self._last_header = time.monotonic()
        return self._on_device(lambda: _dp_sample(
            mesh, self._device, self._samplers[L], L, seeds, cfg, emb))

    def _header(self, stop, L, tier):
        """Send the other ranks a header with no rows: the stop header, or
        a no-op (tier 0)."""
        self._last_header = time.monotonic()
        self._on_device(lambda: _send_header(self._mesh, self._device, stop,
                                             L, tier))

    def _on_device(self, fn):
        """Run fn with this engine's card current (collectives of a
        thread go to the thread's current card)."""
        if self._device.type != "cuda":
            return fn()
        with torch.cuda.device(self._device):
            return fn()

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
