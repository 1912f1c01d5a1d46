"""Pixel-space metrics (counterpart of ``tvc/metrics/pixel.py``).

PSNR is the float64 host computation over the whole array, as the sender's
PSNR mode uses it.
"""

from __future__ import annotations

from typing import List

import numpy as np


def psnr(img1: np.ndarray, img2: np.ndarray, maxvalue: float = 1.0) -> float:
    a = np.asarray(img1, dtype=np.float64)
    b = np.asarray(img2, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10((maxvalue ** 2) / mse))


def per_frame_psnr(video1: np.ndarray, video2: np.ndarray) -> List[float]:
    """(T, ...) videos -> per-frame PSNR list."""
    return [psnr(video1[t], video2[t]) for t in range(video1.shape[0])]
