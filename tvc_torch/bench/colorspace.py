"""Colorspace transforms for the anchor benchmark (counterpart of
``tvc/bench/colorspace.py``).

RGB <-> YCbCr with ITU-R BT.709 coefficients, and chroma 4:4:4 <-> 4:2:0: a
2x2 average down, and up by the resize of ``jax.image.resize``
(``tvc_torch/ops/image_resize.py``: Keys cubic (a = -0.5) or triangle
weights), as two float32 weight-matrix products on the host. NHWC numpy;
ffmpeg does the heavy lifting.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tvc_torch.ops.image_resize import resize_weights

# Kr, Kg, Kb for ITU-R BT.709
KR, KG, KB = 0.2126, 0.7152, 0.0722


def rgb2ycbcr(rgb: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) float RGB -> YCbCr."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    cb = 0.5 * (b - y) / (1 - KB) + 0.5
    cr = 0.5 * (r - y) / (1 - KR) + 0.5
    return np.stack([y, cb, cr], axis=-1)


def ycbcr2rgb(ycbcr: np.ndarray) -> np.ndarray:
    y, cb, cr = ycbcr[..., 0], ycbcr[..., 1], ycbcr[..., 2]
    r = y + (2 - 2 * KR) * (cr - 0.5)
    b = y + (2 - 2 * KB) * (cb - 0.5)
    g = (y - KR * r - KB * b) / KG
    return np.stack([r, g, b], axis=-1)


def yuv_444_to_420(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Chroma average-pooled 2x2. Planes are (H, W)."""

    def down(p):
        h, w = p.shape
        return p.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    return y, down(u), down(v)


def upsample_plane(p: np.ndarray, h: int, w: int, mode: str = "bicubic") -> np.ndarray:
    """A float32 (h0, w0) plane resized up to (h, w)."""
    p = np.asarray(p, np.float32)
    if mode == "nearest":
        rows = np.floor((np.arange(h, dtype=np.float32) + 0.5) * p.shape[0] / h).astype(int)
        cols = np.floor((np.arange(w, dtype=np.float32) + 0.5) * p.shape[1] / w).astype(int)
        return p[rows][:, cols]
    kernel = {"bilinear": "bilinear", "bicubic": "cubic"}[mode]

    def rows(q):
        return resize_weights(q.shape[0], h, kernel).T @ q if q.shape[0] != h else q

    def cols(q):
        return q @ resize_weights(q.shape[1], w, kernel) if q.shape[1] != w else q

    # the order in which jnp.einsum contracts a 2x chroma upscale: the same
    # float32 sums, so the planes equal the JAX package's bit for bit
    return rows(cols(p)) if w > h else cols(rows(p))


def yuv_420_to_444(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                   mode: str = "bicubic") -> np.ndarray:
    """Chroma upsampled to the luma's size; returns (H, W, 3) float32."""
    h, w = y.shape
    return np.stack([y.astype(np.float32), upsample_plane(u, h, w, mode),
                     upsample_plane(v, h, w, mode)], axis=-1)
