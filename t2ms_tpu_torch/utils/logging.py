"""Structured step logs, a step timer and the profiler hook (counterpart of
t2ms_tpu/utils/logging.py's ``JsonlLogger``, ``StepTimer`` and
``profile_trace``; the trace goes through torch.profiler in place of
jax.profiler)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

__all__ = ["JsonlLogger", "StepTimer", "profile_trace"]


class JsonlLogger:
    """Append-only structured step log (one JSON object per line)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def log(self, **fields) -> None:
        fields.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over a region (CPU, and CUDA where a card is
    present), its Chrome trace written into ``trace_dir``
    (T2MS_PROFILE_DIR) at the end; a no-op without a directory."""
    if not trace_dir:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))


class StepTimer:
    """Rolling steps/sec with warmup exclusion. Ticks count enqueued
    steps: read the rate after a host sync (the train CLI reads it after
    pulling the epoch's losses to the host)."""

    def __init__(self, skip_first: int = 1):
        self.skip = skip_first
        self.count = 0
        # skip_first=0 measures every step, so the clock starts now
        self.start = time.perf_counter() if skip_first == 0 else None

    def tick(self) -> None:
        self.count += 1
        if self.count == self.skip:
            self.start = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self.start is None or self.count <= self.skip:
            return float("nan")
        return (self.count - self.skip) / (time.perf_counter() - self.start)
