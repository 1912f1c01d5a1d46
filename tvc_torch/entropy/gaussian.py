"""Conditional Gaussian entropy model (counterpart of ``tvc/entropy/gaussian.py``).

compressai's ``GaussianConditional``: per-element Gaussian (mean, scale)
likelihoods, a 64-entry log-spaced scale table that indexes frozen quantized
CDFs, and rANS coding of the quantized residuals. The tables and the scale
indexes are float64 numpy on the host, as in the JAX package: a float32
table would move the bin boundaries.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import scipy.special
import torch
from scipy.stats import norm as _norm

from tvc_torch.entropy.cdf import build_cdf_table
from tvc_torch.entropy.rans import RansDecoder, RansEncoder, finite_latents

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64
LIKELIHOOD_BOUND = 1e-9


def get_scale_table(smin: float = SCALES_MIN, smax: float = SCALES_MAX,
                    levels: int = SCALES_LEVELS) -> np.ndarray:
    """64 log-spaced scales, float64."""
    return np.exp(np.linspace(math.log(smin), math.log(smax), levels))


def _std_cdf_np(x: np.ndarray) -> np.ndarray:
    """Standard normal CDF via erfc (compressai's formulation)."""
    return 0.5 * scipy.special.erfc(-x / np.sqrt(2.0))


def gaussian_likelihood(x: torch.Tensor, scales: torch.Tensor, means: torch.Tensor,
                        scale_bound: float = SCALES_MIN) -> torch.Tensor:
    """P(round(x) | N(means, scales^2)) with folded tails."""
    scales = torch.clamp(scales, min=scale_bound)
    v = torch.abs(x - means)
    inv = 1.0 / scales
    upper = 0.5 * torch.erfc(-((0.5 - v) * inv) / math.sqrt(2.0))
    lower = 0.5 * torch.erfc(-((-0.5 - v) * inv) / math.sqrt(2.0))
    return torch.clamp(upper - lower, min=LIKELIHOOD_BOUND)


def build_indexes_np(scales: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Scale-bin index per element (compressai ``build_indexes``): the smallest
    i with scale <= table[i], capped at len(table) - 1. Compared in float64."""
    s = np.maximum(scales, table[0])
    idx = np.full(s.shape, len(table) - 1, dtype=np.int32)
    for t in table[:-1]:
        idx -= (s <= t).astype(np.int32)
    return idx


class GaussianCoder:
    """Frozen CDF tables over the scale table, and the rANS calls
    (``GaussianConditional.update/compress/decompress``)."""

    def __init__(self, scale_table: np.ndarray | None = None, tail_mass: float = 1e-9):
        self.scale_table = np.asarray(scale_table if scale_table is not None else get_scale_table(),
                                      dtype=np.float64)
        self.tail_mass = float(tail_mass)
        self._enc = RansEncoder()
        self._dec = RansDecoder()
        self.update()

    def update(self) -> None:
        multiplier = -_norm.ppf(self.tail_mass / 2.0)
        pmf_center = np.ceil(self.scale_table * multiplier).astype(np.int64)
        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())

        samples = np.abs(np.arange(max_length, dtype=np.float64)[None, :] - pmf_center[:, None])
        scales = self.scale_table[:, None]
        upper = _std_cdf_np((0.5 - samples) / scales)
        lower = _std_cdf_np((-0.5 - samples) / scales)
        pmf = upper - lower
        tail = 2.0 * lower[:, :1]

        self.cdf = build_cdf_table(pmf, tail[:, 0], pmf_length, max_length)
        self.cdf_length = (pmf_length + 2).astype(np.int32)
        self.offset = (-pmf_center).astype(np.int32)

    def build_indexes(self, scales: np.ndarray) -> np.ndarray:
        return build_indexes_np(scales, self.scale_table)

    def compress(self, y: np.ndarray, indexes: np.ndarray, means: np.ndarray) -> List[bytes]:
        """y/means/indexes: (B, ...), flattened in C order. One string per batch element."""
        b = y.shape[0]
        sym = np.round(finite_latents(y - means)).astype(np.int32).reshape(b, -1)
        idx = indexes.reshape(b, -1)
        return self._enc.encode_batch(sym, idx, [sym.shape[1]] * b, self.cdf, self.cdf_length,
                                      self.offset)

    def decompress(self, strings: Sequence[bytes], indexes: np.ndarray,
                   means: np.ndarray) -> np.ndarray:
        """The decoded values, symbol + mean in float32, shaped like ``means``."""
        b = len(strings)
        idx = indexes.reshape(b, -1)
        vals = self._dec.decode_batch(strings, idx, [idx.shape[1]] * b, self.cdf,
                                      self.cdf_length, self.offset)
        return vals.reshape(means.shape).astype(np.float32) + np.asarray(means, np.float32)
