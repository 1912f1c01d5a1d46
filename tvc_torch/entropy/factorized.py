"""Factorized-prior entropy model (counterpart of ``tvc/entropy/factorized.py``).

compressai's ``EntropyBottleneck`` as

- ``FactorizedEntropy``, an ``nn.Module`` holding the learnable univariate
  CDF network (the matrices/biases/factors cascade of Balle et al. 2018,
  appendix 6.1) and the quantiles, under compressai's parameter names
  (``_matrices.{k}``, ``_biases.{k}``, ``_factors.{k}``, ``quantiles``), whose
  forward gives the likelihoods of the quantized latents;
- ``FactorizedCoder``, which freezes quantized CDF tables from the same
  parameters in float64 numpy on the host and drives the rANS coder.

Tensors are channel-first (NCHW); a stream is one batch element's symbols in
(C, H, W) order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.entropy.cdf import build_cdf_table
from tvc_torch.entropy.rans import RansDecoder, RansEncoder, finite_latents
from tvc_torch.ops.quantize import quantize

LIKELIHOOD_BOUND = 1e-9


class FactorizedEntropy(nn.Module):
    """Learnable factorized prior over ``channels`` channels."""

    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9, device=None):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        self.init_scale = float(init_scale)
        self.tail_mass = float(tail_mass)
        f = (1,) + self.filters + (1,)
        self._matrices = nn.ParameterList(
            [nn.Parameter(torch.empty(channels, f[i + 1], f[i], device=device))
             for i in range(len(self.filters) + 1)])
        self._biases = nn.ParameterList(
            [nn.Parameter(torch.empty(channels, f[i + 1], 1, device=device))
             for i in range(len(self.filters) + 1)])
        self._factors = nn.ParameterList(
            [nn.Parameter(torch.empty(channels, f[i + 1], 1, device=device))
             for i in range(len(self.filters))])
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3, device=device))
        self.init_weights()

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's init: constant matrices, biases uniform in
        [-0.5, 0.5), zero factors, quantiles (-init_scale, 0, init_scale)."""
        f = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (len(self.filters) + 1))
        with torch.no_grad():
            for i, m in enumerate(self._matrices):
                m.fill_(math.log(math.expm1(1.0 / scale / f[i + 1])))
            for b in self._biases:
                b.uniform_(-0.5, 0.5, generator=generator)
            for fac in self._factors:
                fac.zero_()
            self.quantiles.copy_(torch.tensor([-self.init_scale, 0.0, self.init_scale])
                                 .expand_as(self.quantiles))

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1].detach()

    def _logits_cumulative(self, x: torch.Tensor) -> torch.Tensor:
        """x: (C, 1, N) -> logits of the CDF network, (C, 1, N)."""
        logits = x
        for i, m in enumerate(self._matrices):
            logits = torch.matmul(F.softplus(m), logits) + self._biases[i]
            if i < len(self._factors):
                logits = logits + torch.tanh(self._factors[i]) * torch.tanh(logits)
        return logits

    def _likelihood(self, x: torch.Tensor) -> torch.Tensor:
        """x: (C, 1, N) -> the mass of the integer bin around each x."""
        lower = self._logits_cumulative(x - 0.5)
        upper = self._logits_cumulative(x + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def forward(self, z: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """z: (B, C, H, W). Returns (z_hat, likelihoods) as compressai's forward
        does: z_hat is z plus U(-0.5, 0.5) noise from ``generator`` when
        training, else round(z - median) + median."""
        b, c, h, w = z.shape
        med = self.medians().to(z.dtype)[None, :, None, None]
        if training:
            z_hat = quantize(z, "noise", generator)
        else:
            z_hat = torch.round(z - med) + med
        lk = self._likelihood(z_hat.permute(1, 0, 2, 3).reshape(c, 1, -1))
        lk = torch.clamp(lk, min=LIKELIHOOD_BOUND)
        return z_hat, lk.reshape(c, b, h, w).permute(1, 0, 2, 3)

    def host_params(self) -> Dict[str, np.ndarray]:
        """The parameters as host numpy arrays, keyed as the JAX package keys them."""
        out = {"quantiles": self.quantiles.detach().cpu().numpy()}
        for k, m in enumerate(self._matrices):
            out[f"matrix_{k}"] = m.detach().cpu().numpy()
            out[f"bias_{k}"] = self._biases[k].detach().cpu().numpy()
            if k < len(self._factors):
                out[f"factor_{k}"] = self._factors[k].detach().cpu().numpy()
        return out


def _softplus_np(x):
    return np.logaddexp(0.0, x)


def _sigmoid_np(x):
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def _logits_cumulative_np(params: dict, x: np.ndarray) -> np.ndarray:
    """float64 logits of the CDF network. x: (C, 1, N)."""
    logits = x
    k = 0
    while f"matrix_{k}" in params:
        m = np.asarray(params[f"matrix_{k}"], dtype=np.float64)
        logits = np.einsum("cij,cjn->cin", _softplus_np(m), logits)
        logits = logits + np.asarray(params[f"bias_{k}"], dtype=np.float64)
        if f"factor_{k}" in params:
            f = np.asarray(params[f"factor_{k}"], dtype=np.float64)
            logits = logits + np.tanh(f) * np.tanh(logits)
        k += 1
    return logits


class FactorizedCoder:
    """Host-side freeze of a ``FactorizedEntropy``: CDF tables and rANS calls
    (``EntropyBottleneck.update/compress/decompress``)."""

    def __init__(self, params: Dict[str, np.ndarray], tail_mass: float = 1e-9):
        """``params``: ``matrix_{k}``, ``bias_{k}``, ``factor_{k}``, ``quantiles``
        (see ``FactorizedEntropy.host_params``)."""
        self.params = {k: np.asarray(v) for k, v in params.items()}
        self.tail_mass = tail_mass
        self.channels = self.params["quantiles"].shape[0]
        self._enc = RansEncoder()
        self._dec = RansDecoder()
        self.update()

    @classmethod
    def from_module(cls, module: FactorizedEntropy) -> "FactorizedCoder":
        return cls(module.host_params(), module.tail_mass)

    def update(self) -> None:
        q = np.asarray(self.params["quantiles"], dtype=np.float64)  # (C,1,3)
        medians = q[:, 0, 1]
        minima = np.maximum(np.ceil(medians - q[:, 0, 0]).astype(np.int64), 0)
        maxima = np.maximum(np.ceil(q[:, 0, 2] - medians).astype(np.int64), 0)
        pmf_start = medians - minima
        pmf_length = (maxima + minima + 1).astype(np.int64)
        max_length = int(pmf_length.max())

        samples = np.arange(max_length, dtype=np.float64)[None, :] + pmf_start[:, None]
        s = samples[:, None, :]  # (C,1,N)
        lower = _logits_cumulative_np(self.params, s - 0.5)
        upper = _logits_cumulative_np(self.params, s + 0.5)
        sign = -np.sign(lower + upper)
        pmf = np.abs(_sigmoid_np(sign * upper) - _sigmoid_np(sign * lower))[:, 0, :]

        lower_start = _logits_cumulative_np(self.params, (pmf_start - 0.5)[:, None, None])
        upper_end = _logits_cumulative_np(
            self.params, (pmf_start + pmf_length.astype(np.float64) - 0.5)[:, None, None])
        tail = _sigmoid_np(lower_start)[:, 0, 0] + _sigmoid_np(-upper_end)[:, 0, 0]

        self.medians = medians
        self.cdf = build_cdf_table(pmf, tail, pmf_length, max_length)
        self.cdf_length = (pmf_length + 2).astype(np.int32)
        self.offset = (-minima).astype(np.int32)

    def _indexes(self, h: int, w: int) -> np.ndarray:
        return np.broadcast_to(np.arange(self.channels, dtype=np.int32)[:, None, None],
                               (self.channels, h, w)).reshape(-1)

    def quantize(self, z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(z_hat, symbols) of a float32 (B, C, H, W) z without the coder:
        symbols = round(z - median) with the float64 median, z_hat = symbols +
        median in float32, which is what ``decompress`` returns."""
        med = self.medians[None, :, None, None]
        sym = np.round(finite_latents(np.asarray(z) - med)).astype(np.int32)
        return sym.astype(np.float32) + med.astype(np.float32), sym

    def compress_symbols(self, sym: np.ndarray) -> List[bytes]:
        """Encode (B, C, H, W) integer symbols; one string per batch element."""
        b, c, h, w = sym.shape
        if c != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {c}")
        idx = self._indexes(h, w)
        return self._enc.encode_batch(np.asarray(sym, np.int32).reshape(b, -1),
                                      np.tile(idx, (b, 1)), [idx.size] * b,
                                      self.cdf, self.cdf_length, self.offset)

    def decompress(self, strings: Sequence[bytes], hw: Tuple[int, int]) -> np.ndarray:
        """(B, C, H, W) float32 z_hat."""
        h, w = hw
        b = len(strings)
        idx = self._indexes(h, w)
        vals = self._dec.decode_batch(strings, np.tile(idx, (b, 1)), [idx.size] * b,
                                      self.cdf, self.cdf_length, self.offset)
        vals = vals.reshape(b, self.channels, h, w).astype(np.float32)
        return vals + self.medians[None, :, None, None].astype(np.float32)
