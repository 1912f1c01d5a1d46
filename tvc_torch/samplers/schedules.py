"""Noise-schedule construction and subsampling (counterpart of ``tvc/samplers/schedules.py``).

- ``get_sigmas``: the linear / geometric / cosine profiles;
- ``Schedule``: alphas[i] = prod_{m>=i}(1 - betas[m]) (flip-cumprod-flip);
- ``Schedule.subsample``: steps = range(0, T, T // subsample),
  betas = 1 - alphas / alphas_prev;
- ``Schedule.frac``: the last fraction of the full-resolution steps.

All arrays are host-side numpy float64; samplers cast them as they need.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tvc_torch.core.config import Config


def get_sigmas(cfg: Config) -> np.ndarray:
    """The raw sigma/beta profile."""
    T = cfg.model.num_classes
    if cfg.model.sigma_dist == "geometric":
        return np.logspace(np.log10(cfg.model.sigma_begin), np.log10(cfg.model.sigma_end), T)
    if cfg.model.sigma_dist == "linear":
        return np.linspace(cfg.model.sigma_begin, cfg.model.sigma_end, T)
    if cfg.model.sigma_dist == "cosine":
        t = np.linspace(T, 0, T + 1) / T
        s = 0.008
        f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
        return f[:-1] / f[-1]
    raise NotImplementedError(cfg.model.sigma_dist)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Full-resolution diffusion schedule buffers."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    # gamma-noise auxiliaries; None unless model.gamma
    k_cum: Optional[np.ndarray] = None
    theta_t: Optional[np.ndarray] = None

    @classmethod
    def from_config(cls, cfg: Config) -> "Schedule":
        if cfg.model.sigma_dist in ("linear", "geometric"):
            betas = get_sigmas(cfg).astype(np.float64)
            alphas = np.cumprod(1.0 - betas[::-1])[::-1].copy()
            alphas_prev = np.concatenate([alphas[1:], [1.0]])
        elif cfg.model.sigma_dist == "cosine":
            alphas = get_sigmas(cfg).astype(np.float64)
            alphas_prev = np.concatenate([alphas[1:], [1.0]])
            betas = 1.0 - alphas / alphas_prev
        else:
            raise NotImplementedError(cfg.model.sigma_dist)

        k_cum = theta_t = None
        if cfg.model.gamma:
            theta_0 = 0.001
            k = betas / (alphas * theta_0 ** 2)
            k_cum = np.cumsum(k[::-1])[::-1].copy()
            theta_t = np.sqrt(alphas) * theta_0
        return cls(betas=betas, alphas=alphas, alphas_prev=alphas_prev, k_cum=k_cum,
                   theta_t=theta_t)

    def subsample(self, subsample_steps: Optional[int]) -> "SubSchedule":
        """DDPM/DDIM-style step subsampling."""
        T = len(self.alphas)
        if subsample_steps is None or subsample_steps >= T:
            return SubSchedule(steps=np.arange(T), alphas=self.alphas,
                               alphas_prev=self.alphas_prev, betas=self.betas,
                               k_cum=self.k_cum, theta_t=self.theta_t)
        steps = np.arange(0, T, T // subsample_steps)
        alphas = self.alphas[steps]
        alphas_prev = np.concatenate([alphas[1:], [1.0]])
        return SubSchedule(
            steps=steps, alphas=alphas, alphas_prev=alphas_prev,
            betas=1.0 - alphas / alphas_prev,
            k_cum=self.k_cum[steps] if self.k_cum is not None else None,
            theta_t=self.theta_t[steps] if self.theta_t is not None else None)

    def frac(self, frac_steps: float) -> "SubSchedule":
        """Keep only the last fraction of steps, with the gamma auxiliaries."""
        sub = self.subsample(None)
        keep = slice(int((1 - frac_steps) * len(sub.steps)), None)
        return SubSchedule(
            steps=sub.steps[keep], alphas=sub.alphas[keep], alphas_prev=sub.alphas_prev[keep],
            betas=sub.betas[keep],
            k_cum=sub.k_cum[keep] if sub.k_cum is not None else None,
            theta_t=sub.theta_t[keep] if sub.theta_t is not None else None)


@dataclasses.dataclass(frozen=True)
class SubSchedule:
    steps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    betas: np.ndarray
    k_cum: Optional[np.ndarray] = None
    theta_t: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.steps)
