"""Denoising score matching loss (counterpart of ``tvc/losses/dsm.py``).

Draw a step label per example, perturb x with the forward process (Gaussian
or centred Gamma noise on the DDPM alpha path, or x + sigma z on the SMLD
sigma ladder), predict the noise with the conditional UNet, and take half the
squared (or the absolute) error per example, summed, then the batch mean.

The draws are explicit: ``labels`` and ``noise`` tensors, or both drawn by
``draw_dsm`` from a ``torch.Generator``. The JAX package splits a key; its
parity tests hand the port the numbers ``jax.random`` drew.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tvc_torch.samplers.schedules import Schedule


def _is_smld(version: str) -> bool:
    return version.upper() == "SMLD"


def draw_dsm(shape, schedule: Schedule, generator: torch.Generator, gamma: bool = False,
             version: str = "DDPM", sigmas=None,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, noise) for a batch of ``shape`` (with the conditioning frames
    when ``all_frames`` folds them into x): labels uniform over the steps (or
    the sigma ladder for SMLD), noise standard normal or, with ``gamma``, a
    standard Gamma(k_cum[label]) draw. Drawn on the generator's device and
    moved to ``device``."""
    gen_dev = generator.device
    n = len(sigmas) if _is_smld(version) else len(schedule.alphas)
    labels = torch.randint(0, n, (shape[0],), generator=generator, device=gen_dev)
    if gamma and not _is_smld(version):
        k_cum = torch.as_tensor(np.asarray(schedule.k_cum, np.float32), device=gen_dev)
        conc = k_cum[labels].reshape((-1,) + (1,) * (len(shape) - 1)).expand(shape)
        noise = torch._standard_gamma(conc.contiguous(), generator=generator)
    else:
        noise = torch.randn(shape, generator=generator, device=gen_dev)
    device = gen_dev if device is None else device
    return labels.to(device), noise.to(device)


def anneal_dsm_score_estimation(
    eps_fn: Callable,
    x: torch.Tensor,
    schedule: Schedule,
    cond: Optional[torch.Tensor] = None,
    cond_mask: Optional[torch.Tensor] = None,
    l1: bool = False,
    gamma: bool = False,
    all_frames: bool = False,
    version: str = "DDPM",  # DDPM/DDIM/FPNDM (alpha path) | SMLD (sigma path)
    sigmas=None,  # required for SMLD: the noise-level ladder
    labels: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """eps_fn(x_t, labels, cond, cond_mask) -> eps-hat. Returns the scalar loss.

    ``labels`` (B,) and ``noise`` (x's shape after ``all_frames``) are the
    draws; without them both come from ``generator`` (``draw_dsm``)."""
    b = x.shape[0]
    if all_frames and cond is not None:
        x = torch.cat([x, cond], dim=-1)
        cond = None
    if labels is None or noise is None:
        if generator is None:
            raise ValueError("anneal_dsm_score_estimation needs labels and noise, or a generator")
        labels, noise = draw_dsm(x.shape, schedule, generator, gamma=gamma, version=version,
                                 sigmas=sigmas, device=x.device)
    bshape = (b,) + (1,) * (x.ndim - 1)

    def per_label(values):
        return torch.as_tensor(np.asarray(values, np.float32), device=x.device)[labels]

    if _is_smld(version):
        if sigmas is None:
            raise ValueError("version SMLD needs the sigma ladder")
        z = noise
        x_t = x + per_label(sigmas).reshape(bshape) * z
    else:
        used = per_label(schedule.alphas).reshape(bshape)
        if gamma:
            k_cum = per_label(schedule.k_cum).reshape(bshape)
            theta = per_label(schedule.theta_t).reshape(bshape)
            z = noise * theta
            z = (z - k_cum * theta) / torch.sqrt(1.0 - used)
        else:
            z = noise
        x_t = torch.sqrt(used) * x + torch.sqrt(1.0 - used) * z
    pred = eps_fn(x_t, labels, cond, cond_mask)

    if l1:
        per = torch.sum(torch.abs(z - pred).reshape(b, -1), dim=-1)
    else:
        per = 0.5 * torch.sum(torch.square(z - pred).reshape(b, -1), dim=-1)
    return torch.mean(per)
