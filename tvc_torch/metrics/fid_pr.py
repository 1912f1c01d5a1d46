"""FID and improved precision/recall over feature sets (counterpart of
``tvc/metrics/fid_pr.py``, copied: host numpy and scipy).

The Fréchet distance with the epsilon repair of an ill-conditioned product,
and k-NN manifold precision/recall. Features are any (N, D) arrays, such as
``tvc_torch.models.inception.FIDInceptionFeatures``'s 2048-d pool features.
``sqrtm`` is called without the ``disp`` argument newer scipy deprecates;
the root is the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import linalg


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Stable FID: an eps on the diagonals where the root is not finite."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, s1 = feats1.mean(0), np.cov(feats1, rowvar=False)
    mu2, s2 = feats2.mean(0), np.cov(feats2, rowvar=False)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def _cdist(a: np.ndarray, b: np.ndarray, batch: int = 10000) -> np.ndarray:
    out = []
    for i in range(0, len(b), batch):
        bb = b[i : i + batch]
        d2 = (np.sum(a * a, 1)[:, None] + np.sum(bb * bb, 1)[None, :]
              - 2.0 * a @ bb.T)
        out.append(np.sqrt(np.maximum(d2, 0.0)))
    return np.concatenate(out, axis=1)


def calculate_precision_recall(
    feat_r: np.ndarray, feat_g: np.ndarray, k: int = 3, batch_size: int = 10000
) -> Tuple[float, float]:
    """k-NN manifold precision/recall: a generated sample is precise if it
    lands within the k-NN radius of any real sample, and vice versa for recall."""
    feat_r = np.asarray(feat_r, np.float64)
    feat_g = np.asarray(feat_g, np.float64)
    d_rr = _cdist(feat_r, feat_r, batch_size)
    nnk_r = np.sort(d_rr, axis=1)[:, k]  # the k+1-th smallest, self included
    d_gg = _cdist(feat_g, feat_g, batch_size)
    nnk_g = np.sort(d_gg, axis=1)[:, k]
    d_gr = _cdist(feat_g, feat_r, batch_size)
    precision = float(np.mean(np.any(d_gr <= nnk_r[None, :], axis=1)))
    recall = float(np.mean(np.any(d_gr.T <= nnk_g[None, :], axis=1)))
    return precision, recall


def get_fid_pr(
    feats_real: np.ndarray, feats_fake: np.ndarray, k: int = 3
) -> Tuple[float, float, float]:
    """(fid, precision, recall) of precomputed features."""
    fid = fid_from_features(feats_real, feats_fake)
    precision, recall = calculate_precision_recall(feats_real, feats_fake, k=k)
    return fid, precision, recall


def nearest_neighbor_indices(
    feat_samples: np.ndarray,
    feat_data: np.ndarray,
    k: int = 9,
    feat_samples_flipped: Optional[np.ndarray] = None,
    batch_size: int = 10000,
) -> np.ndarray:
    """Top-k nearest dataset indices per sample in feature space. Where
    features of horizontally flipped samples are given, a dataset image's
    distance is the smaller over the original and flipped queries. Returns
    (n_samples, k) int indices into feat_data, nearest first."""
    d = _cdist(feat_samples, feat_data, batch_size)
    if feat_samples_flipped is not None:
        d = np.minimum(d, _cdist(feat_samples_flipped, feat_data, batch_size))
    return np.argsort(d, axis=1)[:, :k]


def save_nearest_neighbor_grid(
    samples: np.ndarray,
    data: np.ndarray,
    indices: np.ndarray,
    out_png: str,
) -> None:
    """(n, H, W, C) samples + dataset + (n, k) indices -> grid PNG, one row
    per sample: [sample | k nearest dataset images]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n, k = indices.shape
    rows = [np.concatenate([samples[i]] + [data[j] for j in indices[i]], axis=1)
            for i in range(n)]
    grid = np.concatenate(rows, axis=0)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    plt.imsave(out_png, np.clip(grid, 0.0, 1.0))
