"""Length resampling as a matmul with a precomputed band matrix
(counterpart of t2ms_tpu/ops/resize.py). ``y = x @ R`` with ``R`` of shape
(in_len, out_len) reproduces ``F.interpolate(mode='linear',
align_corners=True)`` (reference vqvae.py:70) or ``F.adaptive_avg_pool1d``
(reference benchpress/dataset.py:83); ``resize_time_axis`` is the motion
datasets' rule: pool down, interpolate up."""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["linear_resize_matrix", "adaptive_avg_pool_matrix",
           "linear_resize", "adaptive_avg_pool1d", "resize_time_axis"]


@functools.lru_cache(maxsize=None)
def _linear_resize_matrix_np(in_len: int, out_len: int) -> np.ndarray:
    """Row-stochastic (in_len, out_len) matrix for align_corners=True linear
    interpolation (own copy of the JAX package's function of the same
    name)."""
    if in_len < 1 or out_len < 1:
        raise ValueError(f"invalid resize {in_len}->{out_len}")
    mat = np.zeros((in_len, out_len), dtype=np.float64)
    if out_len == 1:
        # torch samples position 0 when out_len == 1 under align_corners.
        mat[0, 0] = 1.0
        return mat.astype(np.float32)
    if in_len == 1:
        mat[0, :] = 1.0
        return mat.astype(np.float32)
    # torch computes source positions in float32 on f32 inputs
    # (aten upsample_linear1d: scale and src_idx are scalar_t); match it so
    # the fracs agree bitwise at large indices.
    scale = np.float32(in_len - 1) / np.float32(out_len - 1)
    pos = np.float32(np.arange(out_len, dtype=np.float32) * scale)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = (pos - lo.astype(np.float32)).astype(np.float64)
    for j in range(out_len):
        mat[lo[j], j] += 1.0 - frac[j]
        mat[hi[j], j] += frac[j]
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _adaptive_avg_pool_matrix_np(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) matrix with ``F.adaptive_avg_pool1d``'s semantics:
    output j averages input[floor(j*in/out) : ceil((j+1)*in/out)] (own
    copy of the JAX package's function of the same name)."""
    if in_len < 1 or out_len < 1:
        raise ValueError(f"invalid pool {in_len}->{out_len}")
    mat = np.zeros((in_len, out_len), dtype=np.float64)
    for j in range(out_len):
        start = (j * in_len) // out_len
        end = -((-(j + 1) * in_len) // out_len)  # ceil((j+1)*in/out)
        mat[start:end, j] = 1.0 / (end - start)
    return mat.astype(np.float32)


def linear_resize_matrix(in_len: int, out_len: int, device=None,
                         dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(_linear_resize_matrix_np(in_len, out_len)).to(
        device=device, dtype=dtype)


def adaptive_avg_pool_matrix(in_len: int, out_len: int, device=None,
                             dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(_adaptive_avg_pool_matrix_np(in_len, out_len)).to(
        device=device, dtype=dtype)


def linear_resize(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resample the last axis of ``x`` to ``out_len`` (align-corners
    linear); any leading shape, one matmul."""
    in_len = x.shape[-1]
    if in_len == out_len:
        return x
    return torch.matmul(x, linear_resize_matrix(in_len, out_len, x.device,
                                                x.dtype))


def adaptive_avg_pool1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Adaptive average pooling over the last axis; one matmul."""
    in_len = x.shape[-1]
    if in_len == out_len:
        return x
    return torch.matmul(x, adaptive_avg_pool_matrix(in_len, out_len,
                                                    x.device, x.dtype))


def resize_time_axis(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """The reference dataset's resize rule (benchpress/dataset.py:79-87):
    adaptive average pooling when shrinking, linear interpolation when
    growing."""
    in_len = x.shape[-1]
    if in_len > out_len:
        return adaptive_avg_pool1d(x, out_len)
    return linear_resize(x, out_len)
