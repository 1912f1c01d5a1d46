"""Pixel-space metrics (counterpart of ``tvc/metrics/pixel.py``).

``psnr`` is the float64 host computation over the whole array, which
``run_gop``'s PSNR mode uses; ``psnr_torch`` is the float32 tensor version,
which the device-resident runners (``DeviceGOPRunner``, ``FusedGOPSender``)
use, as the JAX package's use ``psnr_jax``. The two can disagree on a frame
whose PSNR lies within float32 rounding of the threshold.

SSIM: an 11x11 Gaussian window (sigma 1.5), valid region only, the mean over
channels, C1 = 0.01^2 and C2 = 0.03^2 on [0, 1] data. ``ssim`` is float64 on
the host (scipy), ``ssim_torch`` the batched float32 version for NHWC tensors
on any device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


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


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    half = (size - 1) / 2.0
    x = np.arange(size, dtype=np.float64) - half
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of two 2-D single-channel images, float64, valid window."""
    from scipy.signal import convolve2d

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    w = _gaussian_kernel()

    def filt(x):  # the window is symmetric: convolution is correlation
        return convolve2d(x, w, mode="valid")

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img1 ** 2) - mu1_sq
    s2 = filt(img2 ** 2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(m.mean())


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of channel-first (C, H, W) or 2-D images in [0, 1]."""
    img1, img2 = np.asarray(img1), np.asarray(img2)
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[0] == 1:
            return ssim_single(img1[0], img2[0])
        return float(np.mean([ssim_single(img1[c], img2[c]) for c in range(img1.shape[0])]))
    raise ValueError("Wrong input image dimensions.")


def ssim_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched float32 SSIM of NHWC tensors in [0, 1]; returns (B,)."""
    c = a.shape[-1]
    w = torch.tensor(_gaussian_kernel(), dtype=torch.float32, device=a.device)
    w = w.expand(c, 1, *w.shape)
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)

    def filt(x):
        return F.conv2d(x, w, groups=c)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = filt(a), filt(b)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(a * a) - mu1_sq
    s2 = filt(b * b) - mu2_sq
    s12 = filt(a * b) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))
