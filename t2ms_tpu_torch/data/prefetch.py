"""Host -> device prefetch: overlap the next batch's copy with the current
step (counterpart of t2ms_tpu/data/prefetch.py).

With a mesh, each rank places only its own rows of the global batch
(``parallel.mesh.shard_batch``), as JAX shards the batch over 'data'.

A background thread turns each host batch into tensors and, for a CUDA
device, pins them and copies them with ``non_blocking=True`` on a side
stream, recording an event after the copy. The consumer's stream waits on
that event before the batch is handed out, and each tensor is marked as
used on the consumer's stream (``record_stream``), so no step reads a
half-copied batch and the allocator does not reuse its memory while the
step runs. On the CPU the tensors pass through as they are.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

__all__ = ["prefetch_to_device"]

_SENTINEL = object()


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def prefetch_to_device(batch_iter: Iterator, size: int = 2, device=None,
                       transform: Optional[Callable] = None,
                       mesh=None) -> Iterator:
    """Wrap a host batch iterator with a staging thread; yields
    ``(batch, payload)``. ``transform(batch)`` gives the arrays to place
    (a tuple, list or dict of them; default the batch itself); numpy
    arrays and tensors in it move to ``device`` (None = the CPU). With a
    ``mesh`` each array keeps this rank's rows only."""
    dev = torch.device("cpu" if device is None else device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def _to_dev(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if not torch.is_tensor(a) or side is None:
            return a
        return a.pin_memory().to(dev, non_blocking=True)

    def _place(batch):
        payload = transform(batch) if transform is not None else batch
        if mesh is not None:
            from t2ms_tpu_torch.parallel.mesh import shard_batch
            payload = shard_batch(mesh, payload)
        if side is None:
            return batch, _map(_to_dev, payload), None
        with torch.cuda.stream(side):
            payload = _map(_to_dev, payload)
            done = torch.cuda.Event()
            done.record(side)
        return batch, payload, done

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone, so an
        abandoned generator does not pin this thread and its batches."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batch_iter:
                if not _put(_place(batch)):
                    return
        except Exception as e:  # noqa: BLE001 - re-raised by the consumer
            _put(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True,
                         name="t2ms-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, Exception):
                raise item
            batch, payload, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                _map(lambda a: a.record_stream(consumer)
                     if torch.is_tensor(a) else None, payload)
            yield batch, payload
    finally:
        # release the worker and whatever it staged; it can finish one
        # more put inside its timeout, so drain, join, drain again
        stop.set()
        for _ in range(2):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=1.0)
            if not t.is_alive():
                break
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
