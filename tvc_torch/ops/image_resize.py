"""``jax.image.resize`` for the port: linear (triangle) and Keys cubic
kernels with half-pixel centres, antialiased on an axis that shrinks, the
weights renormalised over the taps inside the image.

The resize along an axis is a product with an (n_in, n_out) float32 weight
matrix built as JAX builds it (``resize_weights``; within 1e-7 of JAX's,
whose compiled arithmetic may fuse a multiply-add), for the port's FVD and
FID inputs and the anchors' chroma planes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, kernel: str = "bilinear") -> np.ndarray:
    """(n_in, n_out) float32 weights of one axis, as ``jax.image.resize``
    computes them (``compute_weight_mat``)."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = KERNELS[kernel](x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(x: torch.Tensor, size: Sequence[int], kernel: str = "bilinear") -> torch.Tensor:
    """Resize the last two dims of ``x`` (float32, any device) to ``size``,
    antialiased where an axis shrinks; an axis of unchanged size is left as is."""
    h, w = size
    if x.shape[-2] != h:
        wh = torch.from_numpy(resize_weights(x.shape[-2], h, kernel)).to(x.device)
        x = torch.matmul(wh.t(), x)
    if x.shape[-1] != w:
        ww = torch.from_numpy(resize_weights(x.shape[-1], w, kernel)).to(x.device)
        x = torch.matmul(x, ww)
    return x
