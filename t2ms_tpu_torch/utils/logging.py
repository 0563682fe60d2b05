"""Loss curves, JSON artifacts, divider banners, structured step logs, a
step timer and the profiler hook (counterpart of t2ms_tpu/utils/logging.py;
the trace goes through torch.profiler in place of jax.profiler).

Reference artifacts preserved: loss-curve PNGs (utils.py:8-24), JSON
results (evaluate/utils.py:22-33), print-with-divider banners
(evaluate/utils.py:10-19). matplotlib is imported inside
``plot_loss_curve``: the port's paths do not need it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator, Optional

__all__ = ["plot_loss_curve", "write_json_data", "JsonlLogger",
           "show_with_start_divider", "show_with_end_divider",
           "profile_trace", "StepTimer"]


def plot_loss_curve(loss_list, save_path: str,
                    filename: str = "loss_curve.png") -> Optional[str]:
    """Training-loss PNG (reference utils.py:8-24)."""
    if len(loss_list) == 0:
        print("loss_list is empty, skipping plotting.")
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure(figsize=(10, 6))
    plt.plot(list(loss_list), label="Training Loss")
    plt.xlabel("epochs")
    plt.ylabel("Loss")
    plt.title("Training Loss Curve")
    plt.legend()
    plt.grid(True)
    os.makedirs(save_path, exist_ok=True)
    full_path = os.path.join(save_path, filename)
    plt.savefig(full_path)
    plt.close()
    print(f"Loss curve saved to {full_path}")
    return full_path


def write_json_data(content: Any, path: str) -> None:
    """JSON artifact writer that creates the directory."""
    d = path if os.path.isdir(path) else os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(content, f, indent=4)


def show_with_start_divider(content) -> None:
    print("=" * 20)
    print(content)


def show_with_end_divider(content) -> None:
    print(content)
    print("=" * 20)
    print()


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
