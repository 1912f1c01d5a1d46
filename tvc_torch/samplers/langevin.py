"""Annealed Langevin dynamics (counterpart of ``tvc/samplers/langevin.py``).

The NCSN/SMLD samplers: a loop over noise levels x inner steps, flattened
into one loop of ``L * n_steps_each`` steps. They are a library here: the
frame predictor does not run them (``FramePredictor`` says why).

torch cannot reproduce ``jax.random``, so every sampler takes its noise as
an explicit tensor with one row per flattened (level, inner step), drawn by
the caller (``torch.randn`` from a generator on the card, or the JAX
package's draws for parity). Step sizes and scales are rounded to float32 as
the JAX package rounds them, and the updates run in float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tvc_torch.samplers.ancestral import EpsFn


def _hmean(x: np.ndarray) -> float:
    return len(x) / np.sum(1.0 / x)


def _f32(v) -> float:
    return float(np.float32(v))


def _check_rows(noise: torch.Tensor, n: int, shape, name: str = "noise") -> None:
    if noise.shape[0] < n or tuple(noise.shape[1:]) != tuple(shape):
        raise ValueError(f"{name} must be ({n}, *{tuple(shape)}), got {tuple(noise.shape)}")


def _ladder(sigmas: np.ndarray, n_steps_each: int, step_lr: float):
    """(level of each flattened step, float32 sigmas, float32 step sizes)."""
    L = len(sigmas)
    sig = sigmas.astype(np.float32)
    step_sizes = (step_lr * (sigmas / sigmas[-1]) ** 2).astype(np.float32)
    return np.repeat(np.arange(L), n_steps_each), sig, step_sizes


def _labels(b: int, c, device, dtype=torch.long) -> torch.Tensor:
    return torch.full((b,), c, dtype=dtype, device=device)


@torch.no_grad()
def anneal_langevin_dynamics(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sigmas: np.ndarray,
    cond: Optional[torch.Tensor] = None,
    n_steps_each: int = 200,
    step_lr: float = 8e-6,
    denoise: bool = True,
    harm_mean: bool = False,
    same_noise: bool = False,
    frac_steps: Optional[float] = None,
    final_only: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tvc/samplers/langevin.py:25-85. ``eps_fn`` returns z (score = -z/sigma),
    labelled by the level's index; ``noise`` is (L * n_steps_each, B, ...)
    (unused with ``same_noise``, which adds x_init at every step)."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    if frac_steps is not None:
        sigmas = sigmas[int((1 - frac_steps) * len(sigmas)):]
    L = len(sigmas)
    lvl, sig, step_sizes = _ladder(sigmas, n_steps_each, step_lr)
    if not same_noise:
        _check_rows(noise, len(lvl), x_init.shape)
    hm = np.float32(_hmean(sigmas)) if harm_mean else None
    b, dtype = x_init.shape[0], x_init.dtype
    x = x_init
    traj = []
    for i, c in enumerate(lvl):
        sigma, step = sig[c], step_sizes[c]
        grad = eps_fn(x, _labels(b, int(c), x.device), cond).float()
        if harm_mean:
            grad = grad * float(hm / sigma)
        z = x_init.float() if same_noise else noise[i].to(device=x.device, dtype=torch.float32)
        x = (x.float() - float(step / sigma) * grad
             + float(np.sqrt(step * np.float32(2.0))) * z).to(dtype)
        if not final_only:
            traj.append(x)
    if denoise:
        eps = eps_fn(x, _labels(b, L - 1, x.device), cond).float()
        x = (x.float() - float(sig[-1]) * eps).to(dtype)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)


@torch.no_grad()
def sparse_anneal_langevin_dynamics(
    x_sparse: torch.Tensor,
    sparsity: float,
    eps_fn: EpsFn,
    sigmas: np.ndarray,
    cond: Optional[torch.Tensor] = None,
    n_steps_each: int = 200,
    step_lr: float = 8e-6,
    harm_mean: bool = False,
    frac_steps: Optional[float] = None,
    final_only: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tvc/samplers/langevin.py:88-136: a chain and its sparsity-scaled twin,
    which is returned; ``eps_fn`` sees the chain."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    if frac_steps is not None:
        sigmas = sigmas[int((1 - frac_steps) * len(sigmas)):]
    lvl, sig, step_sizes = _ladder(sigmas, n_steps_each, step_lr)
    _check_rows(noise, len(lvl), x_sparse.shape)
    hm = np.float32(_hmean(sigmas)) if harm_mean else None
    b, dtype = x_sparse.shape[0], x_sparse.dtype
    s = _f32(sparsity)
    x = xs = x_sparse
    traj = []
    for i, c in enumerate(lvl):
        sigma, step = sig[c], step_sizes[c]
        grad = eps_fn(x, _labels(b, int(c), x.device), cond).float()
        if harm_mean:
            grad = grad * float(hm / sigma)
        z = noise[i].to(device=x.device, dtype=torch.float32)
        k_grad, k_noise = float(step / sigma), float(np.sqrt(step * np.float32(2.0)))
        x = (x.float() - k_grad * grad + k_noise * z).to(dtype)
        xs = (xs.float() - k_grad * (grad / s) + k_noise * (s * z)).to(dtype)
        if not final_only:
            traj.append(xs)
    if final_only:
        return xs[None]
    return torch.stack(traj)


def consistent_sigmas(sigmas: np.ndarray, n_steps_each: int, step_lr: float,
                      frac_steps: Optional[float] = None):
    """(the geometric ladder, eta, its harmonic mean): consistent annealed
    sampling's schedule (tvc/samplers/langevin.py:157-172)."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    L = len(sigmas)
    consistent = np.geomspace(sigmas[0], sigmas[-1], (L - 1) * n_steps_each + 1)
    inv_gamma = consistent[-1] / consistent[-2]
    lower = sigmas[-1] ** 2 * (1 - inv_gamma)
    upper = sigmas[-1] ** 2 * (1 + inv_gamma)
    if not lower < step_lr < upper:
        raise ValueError(f"Could not satisfy {lower} < {step_lr} < {upper}")
    eta = step_lr / (sigmas[-1] ** 2)
    hm = _hmean(consistent)
    if frac_steps is not None:
        keep = slice(int((1 - frac_steps) * L), None)
        consistent = consistent[np.arange(L)[keep]]
    return consistent, eta, hm


@torch.no_grad()
def anneal_langevin_dynamics_consistent(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sigmas: np.ndarray,
    cond: Optional[torch.Tensor] = None,
    n_steps_each: int = 200,
    step_lr: float = 8e-6,
    denoise: bool = True,
    harm_mean: bool = False,
    frac_steps: Optional[float] = None,
    final_only: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Consistent annealed sampling (tvc/samplers/langevin.py:139-203): a
    geometric sigma ladder, eta = step_lr / sigma_L^2 and beta-scaled noise.
    ``eps_fn`` takes sigma VALUES (float32), not labels, except in the final
    denoise step, which passes the label L - 1 as a float. ``noise`` has a row
    per ladder step (the last one unused)."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    L = len(sigmas)
    consistent, eta, hm = consistent_sigmas(sigmas, n_steps_each, step_lr, frac_steps)
    sig = consistent.astype(np.float32)
    sig_next = np.concatenate([sig[1:], sig[-1:]])
    cl = len(sig)
    _check_rows(noise, cl, x_init.shape)
    # 1 - eta is a host double before it meets a float32, as in the JAX package
    eta32, one_m_eta, hm32 = np.float32(eta), np.float32(1.0 - eta), np.float32(hm)
    b, dtype = x_init.shape[0], x_init.dtype
    x = x_init
    traj = []
    for i in range(cl):
        c_sigma = sig[i]
        grad = eps_fn(x, _labels(b, float(c_sigma), x.device, torch.float32), cond).float()
        if harm_mean:
            grad = grad * float(hm32 / c_sigma)
        x_new = x.float() - float(eta32 * c_sigma) * grad
        if i < cl - 1:
            nxt = sig_next[i]
            gamma = c_sigma / nxt
            beta = np.sqrt(np.float32(1.0) - (gamma * one_m_eta) ** 2)
            x_new = x_new + float(beta * nxt) * noise[i].to(device=x.device,
                                                              dtype=torch.float32)
        x = x_new.to(dtype)
        if not final_only:
            traj.append(x)
    if denoise:
        eps = eps_fn(x, _labels(b, float(L - 1), x.device, torch.float32), cond).float()
        x = (x.float() - _f32(sigmas[-1]) * eps).to(dtype)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)


@torch.no_grad()
def anneal_langevin_dynamics_inpainting(
    x_init: torch.Tensor,
    refer_image: torch.Tensor,
    eps_fn: EpsFn,
    sigmas: np.ndarray,
    cond: Optional[torch.Tensor] = None,
    n_steps_each: int = 100,
    step_lr: float = 8e-6,
    noise: Optional[torch.Tensor] = None,
    corrupt_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Half-image inpainting (tvc/samplers/langevin.py:206-246): the left half
    (the first W/2 columns, NHWC) is re-noised from ``refer_image`` at every
    step; score convention, x += step * grad. ``corrupt_noise`` (one row a
    step, of the left half's shape) re-noises it, ``noise`` drives the step.
    Returns the whole trajectory."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    lvl, sig, step_sizes = _ladder(sigmas, n_steps_each, step_lr)
    cols = x_init.shape[2] // 2
    half_ref = refer_image[:, :, :cols, :].float()
    _check_rows(noise, len(lvl), x_init.shape)
    _check_rows(corrupt_noise, len(lvl), half_ref.shape, "corrupt_noise")
    b, dtype = x_init.shape[0], x_init.dtype
    x = x_init.clone()
    traj = []
    for i, c in enumerate(lvl):
        sigma, step = sig[c], step_sizes[c]
        corrupted = half_ref + corrupt_noise[i].to(device=x.device,
                                                   dtype=torch.float32) * float(sigma)
        x = x.clone()
        x[:, :, :cols, :] = corrupted.to(dtype)
        z = noise[i].to(device=x.device, dtype=torch.float32) * float(
            np.sqrt(step * np.float32(2.0)))
        grad = eps_fn(x, _labels(b, int(c), x.device), cond).float()
        x = (x.float() + float(step) * grad + z).to(dtype)
        traj.append(x)
    return torch.stack(traj)


@torch.no_grad()
def anneal_langevin_dynamics_interpolation(
    x_init: torch.Tensor,
    eps_fn: EpsFn,
    sigmas: np.ndarray,
    n_interpolations: int,
    cond: Optional[torch.Tensor] = None,
    n_steps_each: int = 200,
    step_lr: float = 8e-6,
    final_only: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Spherical noise interpolation (tvc/samplers/langevin.py:249-287): each
    row becomes ``n_interpolations`` chains whose noise is
    p cos(angle) + q sin(angle) for angles from 0 to pi/2. ``noise`` is
    (L * n_steps_each, 2, rows, ...): p and q of each step."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    lvl, _, step_sizes = _ladder(sigmas, n_steps_each, step_lr)
    n_rows = x_init.shape[0]
    _check_rows(noise, len(lvl), (2,) + tuple(x_init.shape))
    x = x_init[:, None].expand((n_rows, n_interpolations) + tuple(x_init.shape[1:]))
    x = x.reshape((-1,) + tuple(x_init.shape[1:]))
    b, dtype = x.shape[0], x.dtype
    angles = torch.linspace(0.0, np.pi / 2.0, n_interpolations, dtype=torch.float32,
                            device=x.device).reshape(1, n_interpolations, 1, 1, 1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    traj = []
    for i, c in enumerate(lvl):
        step = step_sizes[c]
        grad = eps_fn(x, _labels(b, int(c), x.device), cond).float()
        pq = noise[i].to(device=x.device, dtype=torch.float32)
        z = (pq[0][:, None] * cos + pq[1][:, None] * sin).reshape(x.shape)
        x = (x.float() + float(step) * grad
             + z * float(np.sqrt(step * np.float32(2.0)))).to(dtype)
        if not final_only:
            traj.append(x)
    if final_only:
        return x[None]
    return torch.stack(traj)
