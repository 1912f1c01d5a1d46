"""Exponential moving average of parameters (counterpart of ``tvc/losses/ema.py``).

The shadow is a dict of tensors of its own, never aliasing the parameters;
each update is ``(1 - mu) * p + mu * s`` over every parameter, in place.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


def ema_update(shadow: Tensors, params: Tensors, mu: float = 0.999) -> Tensors:
    """shadow <- (1 - mu) * params + mu * shadow, in place; returns shadow."""
    names = list(shadow)
    with torch.no_grad():
        s = [shadow[n] for n in names]
        new = torch._foreach_mul([params[n].detach() for n in names], 1.0 - mu)
        torch._foreach_mul_(s, mu)
        torch._foreach_add_(s, new)
    return shadow


class EMAHelper:
    """register / update / ema / state_dict / load_state_dict over a dict of
    tensors (``dict(module.named_parameters())``)."""

    def __init__(self, mu: float = 0.999):
        self.mu = mu
        self.shadow = None

    def register(self, params: Tensors) -> None:
        self.shadow = {n: p.detach().clone() for n, p in params.items()}

    def update(self, params: Tensors) -> None:
        ema_update(self.shadow, params, self.mu)

    def ema(self, params: Tensors) -> Tensors:
        """The EMA weights."""
        return self.shadow

    def ema_copy(self, params: Tensors) -> Tensors:
        return {n: s.clone() for n, s in self.shadow.items()}

    def state_dict(self) -> Tensors:
        return self.shadow

    def load_state_dict(self, shadow: Tensors) -> None:
        self.shadow = shadow
