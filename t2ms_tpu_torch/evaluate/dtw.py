"""Dynamic Time Warping (counterpart of t2ms_tpu/evaluate/dtw.py).

The reference's only native-accelerated call is
``dtaidistance.dtw_ndim.distance(..., use_c=True)`` (evaluation.py:156).
The port's equivalents:

  * ``dtw_native`` / ``calculate_dtw``: the C++ kernel in native/dtw.cpp
    (two-row DP, batch entry point), built and bound by
    ``t2ms_tpu_torch.utils.native``; a failed build raises.
  * ``dtw_wavefront`` / ``dtw_wavefront_batch``: the anti-diagonal
    wavefront of the JAX package's ``dtw_jax`` on torch tensors, on their
    device: one step per diagonal (T1 + T2 - 1 of them), each diagonal of
    every pair in a few vector ops.
  * ``dtw_numpy``: the two-row numpy DP (evaluate/metrics.py:139-170), the
    reference the others are held to.

All return sqrt(accumulated squared-Euclidean frame cost), dtaidistance's
definition. A univariate (T,) series is T scalar frames, (T, 1). The
optional Sakoe-Chiba band ``window`` (<= 0: unconstrained) is centred at
row i (1-based) on column int(i * (T2 / T1)), as native/dtw.cpp does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from t2ms_tpu_torch.utils.native import load_native

__all__ = ["calculate_dtw", "dtw_native", "dtw_numpy", "dtw_wavefront",
           "dtw_wavefront_batch"]


def _as_frames(x) -> np.ndarray:
    """(T,) -> (T, 1): a univariate series is T scalar frames, not one
    T-dimensional frame (np.atleast_2d's (1, T) would compute the plain
    Euclidean distance)."""
    x = np.asarray(x, np.float64)
    return x[:, None] if x.ndim == 1 else x


def _band(i: int, T1: int, T2: int, window: int):
    """Columns [lo, hi] (1-based) of row i (1-based) inside the band."""
    center = int(i * (T2 / T1))
    return max(center - window, 1), min(center + window, T2)


def dtw_numpy(a: np.ndarray, b: np.ndarray, window: int = 0) -> float:
    """Two-row numpy DP with the same band as native/dtw.cpp."""
    a = _as_frames(a)
    b = _as_frames(b)
    if a.shape[1] != b.shape[1]:
        raise ValueError("dim mismatch")
    T1, T2 = a.shape[0], b.shape[0]
    prev = np.full(T2 + 1, np.inf)
    prev[0] = 0.0
    for i in range(1, T1 + 1):
        cost = np.sum((a[i - 1][None, :] - b) ** 2, axis=1)
        curr = np.full(T2 + 1, np.inf)
        j_lo, j_hi = _band(i, T1, T2, window) if window > 0 else (1, T2)
        for j in range(j_lo, j_hi + 1):
            curr[j] = cost[j - 1] + min(prev[j], curr[j - 1], prev[j - 1])
        prev = curr
    return float(np.sqrt(prev[T2]))


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dtw_native(a: np.ndarray, b: np.ndarray, window: int = 0) -> float:
    """Single-pair DTW on the C++ kernel."""
    lib = load_native()
    a = np.ascontiguousarray(_as_frames(a))
    b = np.ascontiguousarray(_as_frames(b))
    if a.shape[-1] != b.shape[-1]:
        raise ValueError("dim mismatch")
    return float(lib.t2ms_dtw_ndim(_dp(a), a.shape[0], _dp(b), b.shape[0],
                                   a.shape[1], window))


def calculate_dtw(ori_data: np.ndarray, comp_data: np.ndarray,
                  window: int = 0) -> float:
    """Mean DTW over the batch (reference calculate_dtw,
    myevaluation.py:174-183) on the C++ batch kernel: inputs (N, T, D)
    frames x dims, or (N, T) univariate."""
    ori = np.ascontiguousarray(ori_data, np.float64)
    gen = np.ascontiguousarray(comp_data, np.float64)
    if ori.shape[0] != gen.shape[0]:
        raise ValueError(f"batch mismatch: {ori.shape[0]} vs "
                         f"{gen.shape[0]}")
    if ori.ndim == 2:
        ori, gen = ori[..., None], gen[..., None]
    if ori.ndim != 3 or gen.ndim != 3 or ori.shape[2] != gen.shape[2]:
        raise ValueError(f"want (N, T, D) pairs, got {ori.shape} and "
                         f"{gen.shape}")
    lib = load_native()
    N, T1, D = ori.shape
    out = np.empty(N, np.float64)
    lib.t2ms_dtw_batch(_dp(ori), _dp(gen), N, T1, gen.shape[1], D, window,
                       _dp(out))
    return float(out.mean())


def dtw_wavefront_batch(a: torch.Tensor, b: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    """Batched DTW (N, T1, D) x (N, T2, D) -> (N,) on the tensors' device
    and in their dtype, one step per anti-diagonal k = i + j (0-based).
    Diagonal k-1 holds D[i-1, j] (up) and D[i, j-1] (left), diagonal k-2
    holds D[i-1, j-1]; cells off the grid or outside the band are inf."""
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    N, T1, _ = a.shape
    T2 = b.shape[1]
    dev = a.device
    cost = torch.sum((a[:, :, None, :] - b[:, None, :, :]) ** 2, dim=-1)
    # per diagonal k and row i: the flat index of cell (i, k - i) and
    # whether it lies on the grid and inside the band
    k = np.arange(T1 + T2 - 1)[:, None]
    i = np.arange(T1)[None, :]
    j = k - i
    valid = (j >= 0) & (j < T2)
    if window > 0:
        lo, hi = np.array([_band(r, T1, T2, window)
                           for r in range(1, T1 + 1)]).T
        valid &= (j + 1 >= lo[None, :]) & (j + 1 <= hi[None, :])
    flat = torch.as_tensor(i * T2 + np.clip(j, 0, T2 - 1), device=dev)
    diag_cost = cost.reshape(N, T1 * T2)[:, flat]            # (N, K, T1)
    diag_cost = diag_cost.masked_fill(
        ~torch.as_tensor(valid, device=dev), float("inf"))
    inf_col = torch.full((N, 1), float("inf"), dtype=cost.dtype, device=dev)
    d2 = torch.full((N, T1), float("inf"), dtype=cost.dtype, device=dev)
    d1 = d2
    for step in range(T1 + T2 - 1):
        up = torch.cat([inf_col, d1[:, :-1]], dim=1)
        diag = torch.cat([inf_col, d2[:, :-1]], dim=1)
        best = torch.minimum(torch.minimum(up, d1), diag)
        if step == 0:
            best[:, 0] = 0.0
        d2, d1 = d1, diag_cost[:, step] + best
    return torch.sqrt(d1[:, T1 - 1])


def dtw_wavefront(a: torch.Tensor, b: torch.Tensor,
                  window: int = 0) -> torch.Tensor:
    """DTW of one pair (T1, D) x (T2, D), or (T1,) x (T2,), as a 0-d
    tensor."""
    if a.ndim == 1:
        a, b = a[:, None], b[:, None]
    return dtw_wavefront_batch(a[None], b[None], window)[0]
