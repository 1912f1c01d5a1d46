"""Quantization ops (counterpart of ``tvc/ops/quantize.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient (identity backward)."""
    return x + (torch.round(x) - x).detach()


def quantize(x: torch.Tensor, mode: str = "noise",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """noise: additive U(-0.5, 0.5) drawn from ``generator``; ste: straight-through
    round; round: hard round."""
    if mode == "noise":
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=generator.device if generator is not None else x.device)
        return x + (u.to(x.device) - 0.5)
    if mode == "ste":
        return ste_round(x)
    if mode == "round":
        return torch.round(x)
    raise ValueError(f"unknown quantize mode: {mode}")
