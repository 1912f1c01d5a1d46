"""F-PNDM sampling, pseudo-numerical methods (counterpart of ``tvc/samplers/pndm.py``).

A Runge-Kutta bootstrap for the first 3 steps (4 UNet calls each), then
4th-order Adams-Bashforth over the last four epsilons,
``(55 e1 - 59 e2 + 37 e3 - 9 e4) / 24`` (one call each): 109 UNet calls at
``subsample = 100``. The bootstrap/Adams-Bashforth choice, a ``lax.cond`` in
the JAX package, is a Python branch on the step index.

Reference quirks kept: the alphas are indexed flipped, at ``int(t) + 1``
(truncation toward zero); the labels are float32 and may be fractional
midpoints, the first one ``(0 + -1) / 2 = -0.5``; ``steps_next = [-1] +
steps[:-1]``. The sampler is deterministic: it draws nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tvc_torch.samplers.ancestral import EpsFn
from tvc_torch.samplers.schedules import Schedule


def transfer_coefficients(t: float, t_next: float, alphas_cump: np.ndarray):
    """(d, A, B) of ``x + d * (A * x - B * et)``, in float32 as the JAX
    package computes them (``_transfer``, tvc/samplers/pndm.py:29-43)."""
    at = alphas_cump[int(np.float32(t)) + 1]
    at_next = alphas_cump[int(np.float32(t_next)) + 1]
    one = np.float32(1.0)
    sat, satn = np.sqrt(at), np.sqrt(at_next)
    a = one / (sat * (sat + satn))
    b = one / (sat * (np.sqrt((one - at_next) * at) + np.sqrt((one - at) * at_next)))
    return float(at_next - at), float(a), float(b)


def _transfer(x, t, t_next, et, alphas_cump, clip_before):
    d, a, b = transfer_coefficients(t, t_next, alphas_cump)
    x_next = x + d * (a * x - b * et)
    if clip_before:
        x_next = torch.clamp(x_next, -1.0, 1.0)
    return x_next


def fpndm_steps(schedule: Schedule, subsample_steps: int):
    """(steps, steps_next) as float32 labels."""
    T = len(schedule.alphas)
    steps = np.arange(0, T, T // subsample_steps)
    steps_next = np.concatenate([[-1], steps[:-1]])
    return steps.astype(np.float32), steps_next.astype(np.float32)


def fpndm_unet_calls(schedule: Schedule, subsample_steps: int) -> int:
    L = len(fpndm_steps(schedule, subsample_steps)[0])
    return 4 * min(L, 3) + max(L - 3, 0)


@torch.no_grad()
def fpndm_sampler(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    schedule: Schedule,
    subsample_steps: int,
    cond: Optional[torch.Tensor] = None,
    clip_before: bool = True,
    final_only: bool = True,
    denoise: bool = True,  # accepted as the JAX package accepts it; F-PNDM ignores it
) -> torch.Tensor:
    """F-PNDM sampling. Returns the final sample with a leading axis of 1
    (``final_only``) or the (L, B, ...) trajectory."""
    del denoise
    steps, steps_next = fpndm_steps(schedule, subsample_steps)
    alphas_cump = np.asarray(schedule.alphas[::-1], np.float32)
    b = x_init.shape[0]
    dtype = x_init.dtype

    def model(x, t):
        label = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        return eps_fn(x, label, cond).float()

    x = x_init
    ets = []
    traj = []
    for n, (t, t_next) in enumerate(zip(steps, steps_next)):
        t_mid = (t + t_next) / np.float32(2.0)
        xf = x.float()
        if n > 2:
            ets.append(model(xf, t))
            noise = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24.0
        else:
            e1 = model(xf, t)
            x2 = _transfer(xf, t, t_mid, e1, alphas_cump, clip_before)
            e2 = model(x2, t_mid)
            x3 = _transfer(xf, t, t_mid, e2, alphas_cump, clip_before)
            e3 = model(x3, t_mid)
            x4 = _transfer(xf, t, t_next, e3, alphas_cump, clip_before)
            e4 = model(x4, t_next)
            noise = (e1 + 2 * e2 + 2 * e3 + e4) / 6.0
            ets.append(e1)
        ets = ets[-4:]
        x = _transfer(xf, t, t_next, noise, alphas_cump, clip_before).to(dtype)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)
