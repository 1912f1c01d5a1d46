"""Optimizers with optax's semantics (counterpart of ``tvc/losses/optimizers.py``).

``get_optimizer(cfg)`` returns what ``optax.chain(clip_by_global_norm,
adam | adamw | rmsprop | sgd)`` computes, written out, because
``torch.optim`` differs from optax where it matters:

- Adam: ``eps = max(optim.eps, 1e-8)`` outside the root, bias-corrected
  moments; ``optim.amsgrad`` is ignored, as ``optax.adam`` ignores it. With
  ``weight_decay > 0`` it is AdamW: ``adam_update + wd * p`` before the
  learning rate (decoupled, every parameter).
- RMSprop: ``g / sqrt(nu + eps)``, eps inside the root (torch puts it outside),
  decay 0.9, nu starting at 0.
- SGD: momentum 0.9, ``trace = g + 0.9 * trace``.
- Clipping: ``g * max / |g|`` only where ``|g| >= max`` (torch's
  ``clip_grad_norm_`` divides by ``|g| + 1e-6`` always), as ``g / |g| * max``.
- The learning rate is read at the update count before it is incremented, so
  with ``warmup > 0`` the first update has lr 0.

State is a flat dict of tensors: ``count`` (the schedule's count),
``adam_count``, and per parameter ``mu/<name>``, ``nu/<name>`` (Adam),
``nu/<name>`` (RMSprop) or ``trace/<name>`` (SGD).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from tvc_torch.core.config import Config

Tensors = Dict[str, torch.Tensor]
B2 = 0.999           # optax.adam's b2 in the JAX package
RMS_DECAY = 0.9
SGD_MOMENTUM = 0.9


def warmup_schedule(base_lr: float, warmup: int) -> Callable[[int], np.float32]:
    """Linear warmup then constant: the float32 lr at update count ``step``."""
    if warmup <= 0:
        return lambda step: np.float32(base_lr)

    def sched(step: int) -> np.float32:
        frac = np.minimum(np.float32(step) / np.float32(warmup), np.float32(1.0))
        return np.float32(base_lr) * frac

    return sched


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """One of optax's four optimizers of the JAX package, with optional
    global-norm clipping; ``step_`` updates parameters and state in place."""

    def __init__(self, name: str, lr: Callable[[int], np.float32], beta1: float = 0.9,
                 eps: float = 1e-8, weight_decay: float = 0.0, grad_clip: float = 0.0):
        if name.lower() not in ("adam", "rmsprop", "sgd"):
            raise NotImplementedError(f"optimizer {name}")
        name = name.lower()
        self.name, self.lr, self.beta1, self.eps = name, lr, beta1, eps
        self.weight_decay = weight_decay if name == "adam" else 0.0
        self.grad_clip = grad_clip

    def init(self, params: Tensors) -> Tensors:
        """The zero state of ``params``' shapes (count 0)."""
        state = {"count": torch.zeros((), dtype=torch.int64)}
        slots = {"adam": ("mu", "nu"), "rmsprop": ("nu",), "sgd": ("trace",)}[self.name]
        if self.name == "adam":
            state["adam_count"] = torch.zeros((), dtype=torch.int64)
        for slot in slots:
            for n, p in params.items():
                state[f"{slot}/{n}"] = torch.zeros_like(p, memory_format=torch.contiguous_format)
        return state

    def clip_(self, grads: list) -> None:
        """optax.clip_by_global_norm, in place."""
        if not self.grad_clip or self.grad_clip <= 0:
            return
        norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
        # g / 1 * 1 where the norm is below max, else g / norm * max; no host read
        keep = norm < self.grad_clip
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, self.grad_clip)))

    @torch.no_grad()
    def step_(self, params: Tensors, grads: Tensors, state: Tensors) -> None:
        """One update: clip, transform, scale by -lr(count), add to the
        parameters; ``grads`` are overwritten."""
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        self.clip_(g)
        count = int(state["count"])
        if self.name == "adam":
            mu = [state[f"mu/{n}"] for n in names]
            nu = [state[f"nu/{n}"] for n in names]
            c = int(state["adam_count"]) + 1
            torch._foreach_mul_(mu, self.beta1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.beta1))
            torch._foreach_mul_(nu, B2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2))
            mu_hat = torch._foreach_div(mu, _bias_correction(self.beta1, c))
            nu_hat = torch._foreach_div(nu, _bias_correction(B2, c))
            den = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu_hat, den)
            if self.weight_decay > 0:
                torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            state["adam_count"].fill_(c)
        elif self.name == "rmsprop":
            nu = [state[f"nu/{n}"] for n in names]
            torch._foreach_mul_(nu, RMS_DECAY)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - RMS_DECAY))
            scaling = torch._foreach_add(nu, self.eps)
            torch._foreach_rsqrt_(scaling)
            u = torch._foreach_mul(scaling, g)
        else:
            tr = [state[f"trace/{n}"] for n in names]
            torch._foreach_mul_(tr, SGD_MOMENTUM)
            torch._foreach_add_(tr, g)
            u = [t.clone() for t in tr]
        torch._foreach_mul_(u, float(np.float32(-1) * self.lr(count)))
        torch._foreach_add_(p, u)
        state["count"].fill_(count + 1)


def get_optimizer(cfg: Config) -> Optimizer:
    """Adam / RMSprop / SGD per ``cfg.optim``, with warmup and clipping."""
    o = cfg.optim
    return Optimizer(o.optimizer, warmup_schedule(o.lr, o.warmup), beta1=o.beta1,
                     eps=max(o.eps, 1e-8), weight_decay=o.weight_decay, grad_clip=o.grad_clip)
