"""Ancestral DDPM and deterministic DDIM sampling (counterpart of
``tvc/samplers/ancestral.py``).

A Python loop over the sub-schedule, one UNet call per step. DDPM's per-step
combine is

    x_new = c0 * clip(x0) + c1 * x + c2 * eps + sigma * z

  regular step: c0 = sqrt(a_prev) beta / (1 - a), c1 = sqrt(1 - beta)(1 - a_prev)/(1 - a), c2 = 0
  denoise step: c0 = 0, c1 = 1, c2 = -sqrt(1 - alphas[-1])

and DDIM's ``x_new = d0 * clip(x0) + d1 * x + d2 * eps`` (regular: d0 =
sqrt(a_prev), d1 = 0, d2 = sqrt(1 - a_prev); denoise as DDPM's). Both keep the
JAX package's behaviours: the x0 estimate clipped to [-1, 1] before the
update (``clip_before``), no noise at the last regular step, and the extra
denoise step labelled L - 1 (a reference quirk: the regular steps pass the raw
step values 0, 10, ..., 990, the denoise step passes L - 1 = 99).

Options: ``gamma`` (centred Gamma noise in place of Gaussian), ``just_beta``
(sigma = sqrt(beta)), ``same_noise`` (x_init as every step's noise) and the
``t_min`` warm start: steps whose raw value is below ``t_min * L`` are
inactive and leave x as it is, and the first active step first replaces x by
sqrt(a) x + sqrt(1 - a) z. The JAX package runs the UNet on an inactive step
and discards its output; here an inactive step makes no UNet call.

Noise comes from a ``torch.Generator`` (drawn up front by ``NoisePlan.draw``,
in a fixed order) or, for parity with the JAX package (whose ``jax.random``
bits torch cannot reproduce), from explicit tensors: ``noise`` of shape
(n_steps, B, ...), row ``i`` step ``i``'s draw (already the centred Gamma
noise in gamma mode), and ``warm_noise`` (B, ...), the warm start's draw. The
per-step coefficients are rounded to float32 as the JAX package rounds them,
and the update runs in float32.

The carry keeps ``x_init``'s dtype: a bfloat16 predictor carries bfloat16
between steps, while eps, the update and the noise are float32. The ``f32:K``
precision schedule (``eps_fn_hi``, ``hi_steps``) runs DDPM's first
``hi_steps`` executed steps through ``eps_fn_hi``, a float32 UNet, and the
rest through ``eps_fn``; the draws are the same, in the same order, so
``hi_steps >= n_steps`` is the all-``eps_fn_hi`` run exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tvc_torch.samplers.schedules import SubSchedule

# eps_fn(x, labels, cond) -> predicted noise epsilon-hat
EpsFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def gamma_noise(shape, k: float, theta: float, alpha: float,
                generator: torch.Generator) -> torch.Tensor:
    """Centred Gamma noise, (Gamma(k) * theta - k * theta) / sqrt(1 - alpha),
    in float32 (``_gamma_noise``, tvc/samplers/ancestral.py:31-34)."""
    k, theta, alpha = np.float32(k), np.float32(theta), np.float32(alpha)
    conc = torch.full(shape, float(k), dtype=torch.float32, device=generator.device)
    z = torch._standard_gamma(conc, generator=generator) * float(theta)
    return (z - float(k * theta)) / float(np.sqrt(np.float32(1.0) - alpha))


def step_constants(sub: SubSchedule, denoise: bool = True, just_beta: bool = False) -> dict:
    """DDPM's per-step labels and float32 coefficients, one row per executed step."""
    L = len(sub)
    sigma = np.sqrt(sub.betas) if just_beta else np.sqrt(
        (1.0 - sub.alphas_prev) / (1.0 - sub.alphas) * sub.betas)
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
    return _with_alphas(labels, a, c0=c0, c1=c1, c2=c2, sigma=sigma)


def ddim_constants(sub: SubSchedule, denoise: bool = True) -> dict:
    """DDIM's per-step labels and float32 coefficients (c0, c1, c2 = d0, d1, d2)."""
    L = len(sub)
    labels = np.asarray(sub.steps, np.int64)
    a = np.asarray(sub.alphas, np.float64)
    d0 = np.sqrt(np.asarray(sub.alphas_prev, np.float64))
    d1 = np.zeros(L)
    d2 = np.sqrt(1.0 - np.asarray(sub.alphas_prev, np.float64))
    if denoise:
        labels = np.concatenate([labels, [L - 1]])
        a = np.concatenate([a, [sub.alphas[-1]]])  # x0 estimate unused (d0 = 0)
        d0 = np.concatenate([d0, [0.0]])
        d1 = np.concatenate([d1, [1.0]])
        d2 = np.concatenate([d2, [-np.sqrt(1.0 - sub.alphas[-1])]])
    return _with_alphas(labels, a, c0=d0, c1=d1, c2=d2, sigma=np.zeros(len(labels)))


def _with_alphas(labels, a, **coeffs) -> dict:
    a32 = a.astype(np.float32)
    out = {"labels": labels, "a": a32, "sqrt_a": np.sqrt(a32),
           "sqrt_1ma": np.sqrt(np.float32(1.0) - a32)}
    out.update({k: np.asarray(v).astype(np.float32) for k, v in coeffs.items()})
    return out


def active_steps(sub: SubSchedule, n_steps: int, t_min: float) -> Tuple[np.ndarray, Optional[int]]:
    """(active, warm): which executed steps update x, and the step that takes
    the warm start (None without one). Without ``t_min`` every step is active;
    with it, the regular steps whose raw value is at least ``t_min * L`` (a
    reference quirk: raw values against the sub-schedule's length) and the
    denoise step."""
    if t_min <= 0:
        return np.ones(n_steps, bool), None
    start = np.asarray(sub.steps) >= t_min * len(sub.alphas)
    active = np.concatenate([start, [True]])[:n_steps]
    first = np.flatnonzero(start)
    return active, (int(first[0]) if len(first) else None)


@dataclasses.dataclass(frozen=True)
class NoisePlan:
    """What a sampler call draws: a row per executed step that adds noise
    (``rows``), and the warm start's draw (``warm``: its step, or None). In
    gamma mode ``gamma`` holds each step's (k, theta, alpha)."""

    rows: np.ndarray                       # bool, one per executed step
    warm: Optional[int]
    gamma: Optional[np.ndarray] = None     # (n_steps, 3) float32

    @property
    def n_steps(self) -> int:
        return len(self.rows)

    def _draw(self, i: int, shape, generator) -> torch.Tensor:
        if self.gamma is not None:
            return gamma_noise(shape, *self.gamma[i], generator)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device)

    def draw(self, shape, generator: torch.Generator, step_rows: bool = True):
        """(noise, warm_noise) for one call at x shape ``shape``: the step rows
        in step order (zeros where a step adds none; None without step rows),
        then the warm draw (None without a warm start)."""
        noise = None
        if step_rows:
            noise = torch.stack([
                self._draw(i, shape, generator) if used else
                torch.zeros(shape, device=generator.device) for i, used in enumerate(self.rows)])
        warm = self._draw(self.warm, shape, generator) if self.warm is not None else None
        return noise, warm


def ddpm_noise_plan(sub: SubSchedule, denoise: bool = True, just_beta: bool = False,
                    gamma: bool = False, t_min: float = -1.0,
                    same_noise: bool = False) -> NoisePlan:
    consts = step_constants(sub, denoise=denoise, just_beta=just_beta)
    active, warm = active_steps(sub, len(consts["labels"]), t_min)
    rows = (consts["sigma"] != 0) & active & (not same_noise)
    return NoisePlan(rows, warm, _gamma_table(sub, consts) if gamma else None)


def ddim_noise_plan(sub: SubSchedule, denoise: bool = True, gamma: bool = False,
                    t_min: float = -1.0) -> NoisePlan:
    consts = ddim_constants(sub, denoise=denoise)
    _, warm = active_steps(sub, len(consts["labels"]), t_min)
    return NoisePlan(np.zeros(len(consts["labels"]), bool), warm,
                     _gamma_table(sub, consts) if gamma else None)


def _gamma_table(sub: SubSchedule, consts: dict) -> np.ndarray:
    if sub.k_cum is None or sub.theta_t is None:
        raise ValueError("gamma noise needs a schedule built with model.gamma")
    L = len(sub)
    gi = np.minimum(np.arange(len(consts["labels"])), L - 1)  # no denoise row
    return np.stack([np.asarray(sub.k_cum, np.float32)[gi],
                     np.asarray(sub.theta_t, np.float32)[gi], consts["a"]], axis=1)


def _check_noise(noise, warm_noise, plan: NoisePlan, x_init: torch.Tensor, generator):
    """The explicit draws, or the generator's; raises where they do not fit."""
    if noise is None and warm_noise is None and generator is not None:
        return plan.draw(tuple(x_init.shape), generator, step_rows=bool(plan.rows.any()))
    n = plan.n_steps
    if plan.rows.any():
        if noise is None:
            raise ValueError("the sampler needs a generator or an explicit noise tensor")
        if noise.shape[0] < n or noise.shape[1:] != x_init.shape:
            raise ValueError(f"noise must be ({n}, *{tuple(x_init.shape)}), "
                             f"got {tuple(noise.shape)}")
    if plan.warm is not None:
        if warm_noise is None:
            raise ValueError("the t_min warm start needs a generator or explicit warm_noise")
        if warm_noise.shape != x_init.shape:
            raise ValueError(f"warm_noise must be {tuple(x_init.shape)}, "
                             f"got {tuple(warm_noise.shape)}")
    return noise, warm_noise


def _loop(x_init, eps_fn, sub, consts, plan: NoisePlan, cond, clip_before, final_only,
          noise, warm_noise, same_noise, t_min, pre_noise_traj, eps_fn_hi=None, hi_steps=0):
    """The shared step loop of DDPM and DDIM; steps below ``hi_steps`` call
    ``eps_fn_hi``."""
    n_steps = plan.n_steps
    active, _ = active_steps(sub, n_steps, t_min)
    dtype = x_init.dtype
    b = x_init.shape[0]
    x = x_init
    traj = []
    for i in range(n_steps):
        if not active[i]:  # t_min mode: the step leaves x as it is
            if not final_only:
                traj.append(x)
            continue
        if i == plan.warm:
            z = warm_noise.to(device=x.device, dtype=dtype)
            x = (float(consts["sqrt_a"][i]) * x + float(consts["sqrt_1ma"][i]) * z).to(dtype)
        label = torch.full((b,), int(consts["labels"][i]), dtype=torch.long, device=x.device)
        fn = eps_fn_hi if i < hi_steps else eps_fn
        eps = fn(x, label, cond).float()
        xf = x.float()
        x0 = (xf - float(consts["sqrt_1ma"][i]) * eps) / float(consts["sqrt_a"][i])
        if clip_before:
            x0 = torch.clamp(x0, -1.0, 1.0)
        x_new = (float(consts["c0"][i]) * x0 + float(consts["c1"][i]) * xf
                 + float(consts["c2"][i]) * eps)
        if pre_noise_traj and not final_only:
            traj.append(x_new.to(dtype))
        sigma = float(consts["sigma"][i])
        if sigma != 0.0:
            if same_noise:
                z = x_init.float()
            else:
                z = noise[i].to(device=x.device, dtype=torch.float32)
            x_new = x_new + sigma * z
        x = x_new.to(dtype)
        if not pre_noise_traj and not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)


@torch.no_grad()
def ddpm_sampler(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sub: SubSchedule,
    cond: Optional[torch.Tensor] = None,
    denoise: bool = True,
    clip_before: bool = True,
    just_beta: bool = False,
    gamma: bool = False,
    final_only: bool = True,
    t_min: float = -1.0,
    same_noise: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    warm_noise: Optional[torch.Tensor] = None,
    eps_fn_hi: Optional[EpsFn] = None,
    hi_steps: int = 0,
) -> torch.Tensor:
    """Ancestral DDPM sampling. Returns the final sample with a leading axis of 1
    (``final_only``) or the (n_steps, B, ...) trajectory of pre-noise states.
    With ``eps_fn_hi`` the first ``hi_steps`` executed steps call it (the
    ``f32:K`` precision schedule, ``final_only`` only, as in the JAX package)."""
    consts = step_constants(sub, denoise=denoise, just_beta=just_beta)
    plan = ddpm_noise_plan(sub, denoise=denoise, just_beta=just_beta, gamma=gamma, t_min=t_min,
                           same_noise=same_noise)
    noise, warm_noise = _check_noise(noise, warm_noise, plan, x_init, generator)
    if eps_fn_hi is None:
        hi_steps = 0
    elif hi_steps > 0 and not final_only:
        raise ValueError("the f32:K precision schedule returns the final sample only")
    return _loop(x_init, eps_fn, sub, consts, plan, cond, clip_before, final_only, noise,
                 warm_noise, same_noise, t_min, pre_noise_traj=True, eps_fn_hi=eps_fn_hi,
                 hi_steps=hi_steps)


@torch.no_grad()
def ddim_sampler(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sub: SubSchedule,
    cond: Optional[torch.Tensor] = None,
    denoise: bool = True,
    clip_before: bool = True,
    gamma: bool = False,
    final_only: bool = True,
    t_min: float = -1.0,
    generator: Optional[torch.Generator] = None,
    warm_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deterministic DDIM sampling (tvc/samplers/ancestral.py:182-267); it
    draws only the warm start's noise. Returns the final sample with a leading
    axis of 1 or the (n_steps, B, ...) trajectory."""
    consts = ddim_constants(sub, denoise=denoise)
    plan = ddim_noise_plan(sub, denoise=denoise, gamma=gamma, t_min=t_min)
    _, warm_noise = _check_noise(None, warm_noise, plan, x_init, generator)
    return _loop(x_init, eps_fn, sub, consts, plan, cond, clip_before, final_only, None,
                 warm_noise, False, t_min, pre_noise_traj=False)
