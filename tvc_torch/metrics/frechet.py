"""Fréchet distance between feature distributions (counterpart of
``tvc/metrics/frechet.py``, the core of FVD and FID).

fd = |mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)), in float64 on the host;
the matrix square root is scipy's (400 x 400 once per video batch), called
without the ``disp`` argument that newer scipy deprecates; the root is the
same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.linalg import sqrtm


def compute_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(feats_fake: np.ndarray, feats_real: np.ndarray) -> float:
    mu_gen, sigma_gen = compute_stats(np.asarray(feats_fake, np.float64))
    mu_real, sigma_real = compute_stats(np.asarray(feats_real, np.float64))
    m = np.square(mu_gen - mu_real).sum()
    s = sqrtm(np.dot(sigma_gen, sigma_real))
    return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))
