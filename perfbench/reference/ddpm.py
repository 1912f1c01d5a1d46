"""Plain DDPM sampler: the reference of a frame prediction, over any plain net.

MCVD's DDPM sampler with the settings every configuration of the benchmark
keeps (``perfbench/harness.py``'s shared settings): the linear schedule
sub-sampled to ``sampling.subsample`` steps, then the denoise step,
``clip_before``, no warm start, the conditioning frames rescaled to
[-1, 1] and handed to the net as they are. The net is a configuration's
plain ``Net`` (``perfbench/reference/<name>.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def ddpm_constants(cfg: dict) -> dict:
    """Labels and float32 coefficients of each executed step: the sub-sampled
    linear schedule's regular steps, then the denoise step."""
    m, s = cfg["model"], cfg["sampling"]
    T = m["num_classes"]
    betas = np.linspace(m["sigma_begin"], m["sigma_end"], T, dtype=np.float64)
    alphas_full = np.cumprod(1.0 - betas[::-1])[::-1]
    steps = np.arange(0, T, T // s["subsample"])
    a = alphas_full[steps]
    a_prev = np.concatenate([a[1:], [1.0]])
    beta = 1.0 - a / a_prev
    L = len(steps)
    sigma = np.sqrt((1.0 - a_prev) / (1.0 - a) * beta)
    sigma[L - 1] = 0.0
    c0 = np.sqrt(a_prev) * beta / (1.0 - a)
    c1 = np.sqrt(1.0 - beta) * (1.0 - a_prev) / (1.0 - a)
    c2 = np.zeros(L)
    labels = steps.astype(np.int64)
    # the denoise step: label L - 1, x <- x - sqrt(1 - a_last) eps
    labels = np.concatenate([labels, [L - 1]])
    a = np.concatenate([a, [a[-1]]])
    c0, c1 = np.concatenate([c0, [0.0]]), np.concatenate([c1, [1.0]])
    c2 = np.concatenate([c2, [-np.sqrt(1.0 - a[-1])]])
    sigma = np.concatenate([sigma, [0.0]])
    a32 = a.astype(np.float32)
    f32 = {k: v.astype(np.float32) for k, v in dict(c0=c0, c1=c1, c2=c2, sigma=sigma).items()}
    return dict(labels=labels, sqrt_a=np.sqrt(a32), sqrt_1ma=np.sqrt(np.float32(1.0) - a32), **f32)


def draws(cfg: dict, generator: torch.Generator, batch: int):
    """(x_init, step noise) drawn from ``generator`` in the sampler's order:
    x_init, then one draw per executed step that adds noise."""
    d = cfg["data"]
    shape = (batch, d["image_size"], d["image_size"], d["channels"] * d["num_frames"])
    x_init = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    sigma = ddpm_constants(cfg)["sigma"]
    noise = [torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
             if s != 0 else None for s in sigma]
    return x_init, noise


def update_seed(seed: int, update: int) -> int:
    """The generator seed of update ``update`` of a GOP or sweep coded with ``seed``."""
    return (seed * 1_000_003 + update) % (1 << 63)


def predict(cfg: dict, unet: Callable, cond_frames: torch.Tensor, gen_seed: int) -> torch.Tensor:
    """One prediction: cond_frames (B, H, W, C*F_cond) in [0, 1] -> frames
    (B, F, H, W, C) in [0, 1] by ``unet(x, labels, cond) -> eps`` (a
    configuration's plain ``Net``), the noise drawn from a generator on
    ``cond_frames``' device seeded ``gen_seed``."""
    dev = cond_frames.device
    b = cond_frames.shape[0]
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    x, noise = draws(cfg, gen, b)
    k = ddpm_constants(cfg)
    cond = 2.0 * cond_frames.float() - 1.0
    for i in range(len(k["labels"])):
        labels = torch.full((b,), int(k["labels"][i]), dtype=torch.long, device=dev)
        eps = unet(x, labels, cond)
        x0 = torch.clamp((x - float(k["sqrt_1ma"][i]) * eps) / float(k["sqrt_a"][i]), -1.0, 1.0)
        x = float(k["c0"][i]) * x0 + float(k["c1"][i]) * x + float(k["c2"][i]) * eps
        if noise[i] is not None:
            x = x + float(k["sigma"][i]) * noise[i]
    d = cfg["data"]
    out = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
    size, c = d["image_size"], d["channels"]
    return out.reshape(b, size, size, d["num_frames"], c).permute(0, 3, 1, 2, 4)
