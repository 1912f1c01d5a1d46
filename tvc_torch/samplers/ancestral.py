"""Ancestral DDPM sampling (counterpart of ``ddpm_sampler``, ``tvc/samplers/ancestral.py:37-179``).

A Python loop over the sub-schedule, one UNet call per step, with the JAX
package's per-step combine

    x_new = c0 * clip(x0) + c1 * x + c2 * eps + sigma * z

  regular step: c0 = sqrt(a_prev) beta / (1 - a), c1 = sqrt(1 - beta)(1 - a_prev)/(1 - a), c2 = 0
  denoise step: c0 = 0, c1 = 1, c2 = -sqrt(1 - alphas[-1])

and its behaviours: the x0 estimate clipped to [-1, 1] before the update
(``clip_before``), no noise at the last regular step, and the extra denoise
step labelled L - 1 (a reference quirk: the regular steps pass the raw step
values 0, 10, ..., 990, the denoise step passes L - 1 = 99).

Noise comes from a ``torch.Generator`` or, for parity with the JAX package
(whose ``jax.random`` bits torch cannot reproduce), from an explicit tensor
``noise`` of shape (L + 1, B, H, W, C*F): row ``i`` is step ``i``'s draw.
The per-step coefficients are rounded to float32 as the JAX package rounds
them, and the update runs in float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tvc_torch.samplers.schedules import SubSchedule

# eps_fn(x, labels, cond) -> predicted noise epsilon-hat
EpsFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def step_constants(sub: SubSchedule, denoise: bool = True) -> dict:
    """Per-step labels and float32 coefficients, one row per executed step."""
    L = len(sub)
    sigma = np.sqrt((1.0 - sub.alphas_prev) / (1.0 - sub.alphas) * sub.betas)
    sigma[L - 1] = 0.0  # no noise at the last regular step
    c0 = np.sqrt(sub.alphas_prev) * sub.betas / (1.0 - sub.alphas)
    c1 = np.sqrt(1.0 - sub.betas) * (1.0 - sub.alphas_prev) / (1.0 - sub.alphas)
    c2 = np.zeros(L)
    labels = np.asarray(sub.steps, np.int64)
    a = np.asarray(sub.alphas, np.float64)
    if denoise:
        # reference quirk: the denoise label is L-1, not steps[-1]
        labels = np.concatenate([labels, [L - 1]])
        a = np.concatenate([a, [sub.alphas[-1]]])  # x0 estimate unused (c0 = 0)
        c0 = np.concatenate([c0, [0.0]])
        c1 = np.concatenate([c1, [1.0]])
        c2 = np.concatenate([c2, [-np.sqrt(1.0 - sub.alphas[-1])]])
        sigma = np.concatenate([sigma, [0.0]])
    a32 = a.astype(np.float32)
    return {
        "labels": labels,
        "sqrt_a": np.sqrt(a32),
        "sqrt_1ma": np.sqrt(np.float32(1.0) - a32),
        "c0": c0.astype(np.float32),
        "c1": c1.astype(np.float32),
        "c2": c2.astype(np.float32),
        "sigma": sigma.astype(np.float32),
    }


@torch.no_grad()
def ddpm_sampler(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sub: SubSchedule,
    cond: Optional[torch.Tensor] = None,
    denoise: bool = True,
    clip_before: bool = True,
    final_only: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    gamma: bool = False,
    t_min: float = -1.0,
) -> torch.Tensor:
    """Ancestral DDPM sampling. Returns the final sample with a leading axis of 1
    (``final_only``) or the (n_steps, B, ...) trajectory of pre-noise states."""
    if gamma or t_min > 0:
        raise NotImplementedError(
            "gamma noise and the t_min warm start are not ported yet "
            "(ROADMAP.md, left out of slice 1)")
    consts = step_constants(sub, denoise=denoise)
    n_steps = len(consts["labels"])
    if noise is None and generator is None and (consts["sigma"] != 0).any():
        raise ValueError("ddpm_sampler needs a generator or an explicit noise tensor")
    if noise is not None and (noise.shape[0] < n_steps or noise.shape[1:] != x_init.shape):
        raise ValueError(f"noise must be ({n_steps}, *{tuple(x_init.shape)}), "
                         f"got {tuple(noise.shape)}")
    dtype = x_init.dtype
    b = x_init.shape[0]
    x = x_init
    traj = []
    for i in range(n_steps):
        label = torch.full((b,), int(consts["labels"][i]), dtype=torch.long, device=x.device)
        eps = eps_fn(x, label, cond).float()
        xf = x.float()
        x0 = (xf - float(consts["sqrt_1ma"][i]) * eps) / float(consts["sqrt_a"][i])
        if clip_before:
            x0 = torch.clamp(x0, -1.0, 1.0)
        x_new = (float(consts["c0"][i]) * x0 + float(consts["c1"][i]) * xf
                 + float(consts["c2"][i]) * eps)
        if not final_only:
            traj.append(x_new.to(dtype))
        sigma = float(consts["sigma"][i])
        if sigma != 0.0:
            if noise is not None:
                z = noise[i].to(device=x.device, dtype=torch.float32)
            else:
                z = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                                device=generator.device).to(x.device)
            x_new = x_new + sigma * z
        x = x_new.to(dtype)
    if final_only:
        return x[None]
    return torch.stack(traj)
