"""Evaluation metrics on the host (counterpart of
t2ms_tpu/evaluate/metrics.py, copied: numpy and scipy only).

Reference semantics preserved exactly (evaluation.py / myevaluation.py /
evaluate/metrics.py), but loops over samples/series are replaced with
vectorized reductions. Data conventions follow the reference:
  ori_data/gen_data: (n_samples, n_timesteps, n_series)  ['NTD']
  multi-run gen:     (n_samples, n_timesteps, n_series, n_generations)

Metric inventory (myevaluation.py:287-288): MSE, WAPE, MRR, CRPS, C-FID
(see fid.py/ts2vec.py), ED, ACD/SD/KD/MDD (feature_measures.py), DTW
(dtw.py: the native C++ kernel, and the wavefront on the card).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm

__all__ = ["calculate_mse", "calculate_wape", "calculate_crps",
           "calculate_mrr", "calculate_ed", "mrr_at_10", "wape",
           "calculate_correlational_score", "sequence_correlation",
           "calculate_sequence_correlation", "normalize_per_row",
           "min_max_normalize_columns", "zscore_normalize_columns",
           "MinMaxScaler"]


def calculate_mse(ori_data: np.ndarray, gen_data: np.ndarray) -> float:
    """Mean over samples of per-series MSE (evaluation.py:166-180)."""
    per_series = np.mean((ori_data - gen_data) ** 2, axis=1)   # (N, D)
    return float(per_series.mean(axis=1).mean())


def calculate_wape(ori_data: np.ndarray, gen_data: np.ndarray) -> float:
    """Per-sample total |err| / total |actual|, nan-mean over samples
    (evaluation.py:183-206)."""
    abs_err = np.abs(ori_data - gen_data).sum(axis=(1, 2))
    actual = np.abs(ori_data).sum(axis=(1, 2))
    vals = np.where(actual != 0, abs_err / np.where(actual == 0, 1, actual),
                    np.nan)
    return float(np.nanmean(vals))


def calculate_ed(ori_data: np.ndarray, gen_data: np.ndarray) -> float:
    """Mean per-series Euclidean distance (myevaluation.py:159-172)."""
    d = np.linalg.norm(ori_data - gen_data, axis=1)     # (N, D)
    return float(d.mean(axis=1).mean())


def calculate_crps(ori_data: np.ndarray, gen_data: np.ndarray) -> float:
    """Gaussian-surrogate CRPS over generations (evaluation.py:51-84):
    per (sample, series, generation): fit N(mean, std) to the generation,
    compare its CDF at observed values against a step CDF at the mean."""
    N, T, D = ori_data.shape
    G = gen_data.shape[3]
    mean = gen_data.mean(axis=1)                         # (N, D, G)
    std = gen_data.std(axis=1)
    std = np.where(std == 0, 1e-8, std)
    obs = ori_data[:, :, :, None]                        # (N, T, D, 1)
    mu = mean[:, None, :, :]                             # (N, 1, D, G)
    sd = std[:, None, :, :]
    cdf_obs = np.where(obs < mu, 0.0, 1.0)
    cdf_pred = norm.cdf(obs, loc=mu, scale=sd)
    crps = np.mean((cdf_obs - cdf_pred) ** 2, axis=1)    # (N, D, G)
    return float(crps.mean(axis=2).mean(axis=1).mean())


def _pairwise_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sklearn-style cosine_similarity between row sets: (T1,D)x(T2,D)->
    (T1,T2)."""
    an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return an @ bn.T


def _flat_cosine(a: np.ndarray, b: np.ndarray) -> float:
    """The reference's cosine: ravel both (T, D) sequences into flat
    vectors, one scalar a.b/(|a||b|), nan-to-num on 0/0
    (Dataset_Construction_Pipeline/Evaluate_Datasets.py:6-15)."""
    a, b = a.ravel(), b.ravel()
    den = np.linalg.norm(a) * np.linalg.norm(b)
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = np.sum(a * b) / den
    return float(np.nan_to_num(sim))


def calculate_mrr(ori_data: np.ndarray, gen_data: np.ndarray,
                  k: int | None = None, threshold: float = 0.5) -> float:
    """Reciprocal rank over generations by flattened cosine similarity
    (myevaluation.py:42-67, evaluation.py:21-45): per sample, score each
    generation with the scalar ravel-cosine against the observation; if
    the best score beats the threshold, the reciprocal of that
    generation's ORIGINAL index + 1 (a reference quirk: rank is the
    argmax's position in generation order, not its sorted rank) is the
    sample's score, else 0."""
    N = ori_data.shape[0]
    G = gen_data.shape[3]
    k = G if k is None else k
    scores = np.zeros(N)
    for i in range(N):
        sims = [_flat_cosine(ori_data[i], gen_data[i, :, :, g])
                for g in range(k)]
        order = np.argsort(sims)[::-1]
        rank = None
        for idx in order:
            if sims[idx] > threshold:
                rank = idx + 1
                break
        scores[i] = 1.0 / rank if rank is not None else 0.0
    return float(scores.mean())


def mrr_at_10(y_true: np.ndarray, y_gen: np.ndarray,
              threshold: float = 0.9) -> float:
    """MRR@10 over flat feature vectors (evaluate/metrics.py:84-104):
    y_true (N, D), y_gen (N, 10, D); rank = first candidate (in generation
    order) whose cosine similarity beats the threshold."""
    N = y_true.shape[0]
    rr = []
    for i in range(N):
        sims = _pairwise_cosine(y_gen[i], y_true[i][None, :]).ravel()
        hits = np.where(sims > threshold)[0]
        rr.append(1.0 / (hits[0] + 1) if len(hits) else 0.0)
    return float(np.mean(rr))


def wape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    den = np.sum(np.abs(y_true))
    if den == 0:
        return float("inf")
    return float(np.sum(np.abs(y_true - y_pred)) / den)


def calculate_correlational_score(real_data: np.ndarray,
                                  gen_data: np.ndarray) -> float:
    """Correlational score (Ni et al. 2020; evaluate/metrics.py:122-137):
    1 - ||C_real - C_gen||_1 / ||C_real||_1 over (D,D) Pearson matrices."""
    def corr(d):
        N, T, D = d.shape
        return np.corrcoef(d.reshape(N * T, D), rowvar=False)
    c_r, c_g = corr(real_data), corr(gen_data)
    den = np.sum(np.abs(c_r))
    if den == 0:
        return float("nan")
    return float(1 - np.sum(np.abs(c_r - c_g)) / den)


def sequence_correlation(seq_a: np.ndarray, seq_b: np.ndarray,
                         max_shift: int | None = None):
    """Best shift alignment by mean Euclidean distance
    (evaluate/metrics.py:219-266). Returns (best_shift, min_distance)."""
    m, n = len(seq_a), len(seq_b)
    if max_shift is None:
        max_shift = min(m, n) - 1
    best_shift, best = None, np.inf
    for shift in range(-max_shift, max_shift + 1):
        if shift >= 0:
            L = min(m, n - shift)
            if L <= 0:
                continue
            a, b = seq_a[:L], seq_b[shift:shift + L]
        else:
            L = min(m + shift, n)
            if L <= 0:
                continue
            a, b = seq_a[-shift:-shift + L], seq_b[:L]
        d = float(np.mean(np.linalg.norm(a - b, axis=1)))
        if d < best:
            best, best_shift = d, shift
    return best_shift, best


def calculate_sequence_correlation(ori_batch: np.ndarray,
                                   gen_batch: np.ndarray):
    """Batch wrapper; returns the last batch element's result, matching the
    reference's (documented) behavior (evaluate/metrics.py:197-217)."""
    result = (None, np.inf)
    for b in range(ori_batch.shape[0]):
        result = sequence_correlation(ori_batch[b], gen_batch[b])
    return result


def normalize_per_row(x: np.ndarray) -> np.ndarray:
    """Per-row min-max to [0,1] with eps (myevaluation.py:29-35)."""
    mn = x.min(axis=1, keepdims=True)
    mx = x.max(axis=1, keepdims=True)
    return (x - mn) / (mx - mn + 1e-8)


class MinMaxScaler:
    """Columnwise min-max scaler with the reference's 1e-7 denominator
    guard (evaluate/utils.py:46-76): fit stores per-column min/range;
    transform maps to ~[0,1]; inverse_transform undoes it in place."""

    def fit(self, data):
        self.mini = np.min(data, 0)
        self.range = np.max(data, 0) - self.mini
        return self

    def transform(self, data):
        return (data - self.mini) / (self.range + 1e-7)

    def fit_transform(self, data):
        return self.fit(data).transform(data)

    def inverse_transform(self, data):
        data = data * self.range
        data = data + self.mini
        return data


def min_max_normalize_columns(data: np.ndarray) -> np.ndarray:
    mn, mx = data.min(axis=0), data.max(axis=0)
    rng = mx - mn
    rng[rng == 0] = 1
    return (data - mn) / rng


def zscore_normalize_columns(data: np.ndarray) -> np.ndarray:
    mu, sd = data.mean(axis=0), data.std(axis=0)
    sd[sd == 0] = 1
    return (data - mu) / sd
