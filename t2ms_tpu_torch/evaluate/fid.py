"""Frechet distance over TS2Vec representations (C-FID; counterpart of
t2ms_tpu/evaluate/fid.py, copied: numpy and scipy on the host).

Reference: calculate_fid (evaluation.py:127-135): Frechet distance between
Gaussians fit to the two activation sets, with scipy's matrix sqrt and the
real-part fix for numerical complex drift.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import sqrtm

__all__ = ["calculate_fid"]


def calculate_fid(act1: np.ndarray, act2: np.ndarray) -> float:
    mu1, mu2 = act1.mean(axis=0), act2.mean(axis=0)
    sigma1 = np.cov(act1, rowvar=False)
    sigma2 = np.cov(act2, rowvar=False)
    ssdiff = float(np.sum((mu1 - mu2) ** 2))
    covmean = sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return ssdiff + float(np.trace(sigma1 + sigma2 - 2.0 * covmean))
