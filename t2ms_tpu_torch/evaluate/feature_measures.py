"""Feature-based distribution measures: MDD, ACD, SD, KD (counterpart of
t2ms_tpu/evaluate/feature_measures.py, copied: numpy only).

Reference: evaluate/feature_based_measures.py — torch Loss classes; here
pure vectorized numpy with identical numerics:

  * MDD  (HistoLoss :30-94): per (series, timestep) 50-bin density of the
    real data; fake density estimated by counting |x - bin_center| <
    delta/2; score = mean abs density difference.
  * ACD  (ACFLoss :98-161): stationary autocorrelation per lag (up to 64),
    lag-0 included as variance ratio; score = mean over series of
    sqrt(sum_lags (acf_fake - acf_real)^2).
  * SD   (SkewnessLoss :165-191): skew over (sample, time) with unbiased
    std; score = mean |skew diff|.
  * KD   (KurtosisLoss :195-223): excess kurtosis with biased variance;
    score = mean |kurtosis diff|.

Data layout: (n_samples, n_timesteps, n_series).
"""

from __future__ import annotations

import numpy as np

__all__ = ["calculate_mdd", "calculate_acd", "calculate_sd", "calculate_kd",
           "acf_stationary", "skewness", "kurtosis_excess"]


def _hist_density(x: np.ndarray, n_bins: int):
    """torch.histc-equivalent density + bin geometry for a 1-D sample set."""
    a, b = float(x.min()), float(x.max())
    if b == a:
        b = b + 1e-5
    edges = np.linspace(a, b, n_bins + 1)
    delta = edges[1] - edges[0]
    count, _ = np.histogram(x, bins=n_bins, range=(a, b))
    density = count.astype(np.float64) / delta / x.shape[0]
    locs = 0.5 * (edges[1:] + edges[:-1])
    return density, locs, delta


def calculate_mdd(ori_data: np.ndarray, gen_data: np.ndarray,
                  n_bins: int = 50) -> float:
    ori = np.asarray(ori_data, np.float64)
    gen = np.asarray(gen_data, np.float64)
    N, T, D = ori.shape
    losses = []
    for i in range(D):
        for t in range(T):
            density_r, locs, delta = _hist_density(ori[:, t, i], n_bins)
            dist = np.abs(gen[:, t, i][:, None] - locs[None, :])
            counter = (np.maximum(delta / 2.0 - dist, 0) > 0).astype(
                np.float64)
            density_f = counter.mean(axis=0) / delta
            losses.append(np.abs(density_f - density_r).mean())
    return float(np.mean(losses))


def acf_stationary(x: np.ndarray, max_lag: int) -> np.ndarray:
    """(max_lag, D) autocorrelation; lag 0 = E[x^2]/var after centering."""
    x = x - x.mean(axis=(0, 1))
    var = x.var(axis=(0, 1))               # biased, matching unbiased=False
    out = np.empty((max_lag, x.shape[2]))
    for lag in range(max_lag):
        y = x[:, lag:] * x[:, :x.shape[1] - lag] if lag > 0 else x ** 2
        out[lag] = y.mean(axis=(0, 1)) / var
    return out


def calculate_acd(ori_data: np.ndarray, gen_data: np.ndarray,
                  max_lag: int = 64) -> float:
    ori = np.asarray(ori_data, np.float64)
    gen = np.asarray(gen_data, np.float64)
    L = min(max_lag, ori.shape[1])
    diff = acf_stationary(gen, L) - acf_stationary(ori, L)
    per_series = np.sqrt((diff ** 2).sum(axis=0))
    return float(per_series.mean())


def skewness(x: np.ndarray) -> np.ndarray:
    """(D,) skew over (sample, time), unbiased std (torch std default)."""
    mu = x.mean(axis=(0, 1), keepdims=True)
    c = x - mu
    m3 = (c ** 3).mean(axis=(0, 1))
    n = x.shape[0] * x.shape[1]
    std_unbiased = np.sqrt((c ** 2).sum(axis=(0, 1)) / (n - 1))
    return m3 / std_unbiased ** 3


def kurtosis_excess(x: np.ndarray) -> np.ndarray:
    """(D,) excess kurtosis with biased variance."""
    mu = x.mean(axis=(0, 1), keepdims=True)
    c = x - mu
    m4 = (c ** 4).mean(axis=(0, 1))
    var = (c ** 2).mean(axis=(0, 1))
    return m4 / var ** 2 - 3.0


def calculate_sd(ori_data: np.ndarray, gen_data: np.ndarray) -> float:
    diff = np.abs(skewness(np.asarray(gen_data, np.float64))
                  - skewness(np.asarray(ori_data, np.float64)))
    return float(diff.mean())


def calculate_kd(ori_data: np.ndarray, gen_data: np.ndarray) -> float:
    diff = np.abs(kurtosis_excess(np.asarray(gen_data, np.float64))
                  - kurtosis_excess(np.asarray(ori_data, np.float64)))
    return float(diff.mean())
