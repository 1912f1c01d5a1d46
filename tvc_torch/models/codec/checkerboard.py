"""Checkerboard anchor/non-anchor arithmetic on NCHW tensors (counterpart of
``tvc/models/codec/checkerboard.py``).

Anchor positions: (h + w) even, i.e. (0::2, 0::2) and (1::2, 1::2).
Non-anchor:       (h + w) odd,  i.e. (0::2, 1::2) and (1::2, 0::2).
Packed layout: (B, C, H, W) -> (B, C, H, W/2); even rows carry their even
(anchor) or odd (non-anchor) columns, odd rows the complement. Packing and
unpacking move values only, so they are exact.
"""

from __future__ import annotations

import numpy as np
import torch


def anchor_mask(h: int, w: int) -> np.ndarray:
    """(h, w) float32 mask, 1 at anchor positions."""
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (((ii + jj) % 2) == 0).astype(np.float32)


def _mask(y: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(anchor_mask(y.shape[2], y.shape[3]), dtype=y.dtype, device=y.device)


def keep_anchor(y: torch.Tensor) -> torch.Tensor:
    return y * _mask(y)


def keep_nonanchor(y: torch.Tensor) -> torch.Tensor:
    return y * (1.0 - _mask(y))


def _interleave_rows(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(B,C,H/2,W), (B,C,H/2,W) -> (B,C,H,W), alternating rows."""
    b, c, h2, w = even.shape
    return torch.stack([even, odd], dim=3).reshape(b, c, h2 * 2, w)


def _interleave_cols(a: torch.Tensor, b_: torch.Tensor) -> torch.Tensor:
    """(B,C,H,W/2), (B,C,H,W/2) -> (B,C,H,W), alternating columns."""
    b, c, h, w2 = a.shape
    return torch.stack([a, b_], dim=4).reshape(b, c, h, w2 * 2)


def pack_anchor(y: torch.Tensor) -> torch.Tensor:
    """(B,C,H,W) -> (B,C,H,W/2): even rows keep even columns, odd rows odd columns."""
    return _interleave_rows(y[:, :, 0::2, 0::2], y[:, :, 1::2, 1::2])


def pack_nonanchor(y: torch.Tensor) -> torch.Tensor:
    """Even rows keep odd columns, odd rows even columns."""
    return _interleave_rows(y[:, :, 0::2, 1::2], y[:, :, 1::2, 0::2])


def unpack_anchor(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_anchor``; zeros at non-anchor positions."""
    even, odd = p[:, :, 0::2], p[:, :, 1::2]
    z = torch.zeros_like(even)
    return _interleave_rows(_interleave_cols(even, z), _interleave_cols(z, odd))


def unpack_nonanchor(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_nonanchor``; zeros at anchor positions."""
    even, odd = p[:, :, 0::2], p[:, :, 1::2]
    z = torch.zeros_like(even)
    return _interleave_rows(_interleave_cols(z, even), _interleave_cols(odd, z))
