"""Pixel-space metrics (counterpart of ``tvc/metrics/pixel.py``).

``psnr`` is the float64 host computation over the whole array, which
``run_gop``'s PSNR mode uses; ``psnr_torch`` is the float32 tensor version,
which the device-resident runners (``DeviceGOPRunner``, ``FusedGOPSender``)
use, as the JAX package's use ``psnr_jax``. The two can disagree on a frame
whose PSNR lies within float32 rounding of the threshold.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def psnr(img1: np.ndarray, img2: np.ndarray, maxvalue: float = 1.0) -> float:
    a = np.asarray(img1, dtype=np.float64)
    b = np.asarray(img2, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10((maxvalue ** 2) / mse))


def psnr_torch(a: torch.Tensor, b: torch.Tensor, maxvalue: float = 1.0,
               dim: Optional[Sequence[int]] = None) -> torch.Tensor:
    """float32 PSNR on tensors; reduces over ``dim`` (default: all)."""
    diff = (a.float() - b.float()) ** 2
    mse = diff.mean() if dim is None else diff.mean(dim=tuple(dim))
    return 10.0 * torch.log10((maxvalue ** 2) / mse)


def per_frame_psnr(video1: np.ndarray, video2: np.ndarray) -> List[float]:
    """(T, ...) videos -> per-frame PSNR list."""
    return [psnr(video1[t], video2[t]) for t in range(video1.shape[0])]
