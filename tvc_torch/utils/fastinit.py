"""Fill a module's weights in place for benchmarks (counterpart of
``tvc/utils/fastinit.py``).

A benchmark's weights need not mean anything, only cost what real ones cost.
These helpers fill every floating-point parameter and buffer on the module's
own device: no init program, no host draws and no copy from the host. The
quality paths and the receiver keep their seeded host draws
(``FramePredictor.create``, ``make_elic``), which the bitstream ties to both
ends. A fill reaches the state dict (parameters and persistent buffers)
only: a module built on ``meta`` and moved with ``to_empty`` must hold no
other buffer (the UNet holds none; the ELIC's checkerboard masks are
non-persistent).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Tuple

import torch
from torch import nn


def _floating(module: nn.Module) -> Iterable[Tuple[str, torch.Tensor]]:
    for name, t in module.state_dict(keep_vars=True).items():
        if t.is_floating_point():
            yield name, t


def zeros_like(module: nn.Module, fill: float = 0.01) -> nn.Module:
    """Every floating-point weight set to ``fill`` (the JAX package's
    ``zeros_like_tree``, 0.01 as ``FramePredictor.create(fast_init=True)`` uses)."""
    with torch.no_grad():
        for _, t in _floating(module):
            t.fill_(fill)
    return module


def leaf_seed(name: str, seed: int) -> int:
    """The seed of one weight: sha256 of its state-dict name and ``seed``, as
    the JAX package keys each leaf by its path."""
    return int.from_bytes(hashlib.sha256((name + str(seed)).encode()).digest()[:8], "little")


def random_like(module: nn.Module, scale: float = 0.02, seed: int = 0) -> nn.Module:
    """Every floating-point weight drawn N(0, scale^2) on its own device, from a
    generator keyed by ``leaf_seed`` (the JAX package's ``random_like_tree``;
    torch's draws, not numpy's)."""
    with torch.no_grad():
        for name, t in _floating(module):
            gen = torch.Generator(device=t.device).manual_seed(leaf_seed(name, seed))
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * scale)
    return module


def force_fetch(x: torch.Tensor) -> float:
    """Wait for the device, then read one element of ``x`` to the host: the
    end of a timed region that never fetches a whole output."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[0])
