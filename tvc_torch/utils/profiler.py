"""Parameter and FLOP counts, phase timers and device traces (counterpart of
``tvc/utils/profiler.py``).

The JAX package counts FLOPs with XLA's cost analysis of a compiled program;
the port counts them on the host with ``torch.utils.flop_counter.FlopCounterMode``
while the function runs once (matrix products and convolutions, the ops that
mode counts). A ``PhaseTimer`` given a CUDA device waits for the card at each
phase's start and end, so a phase's seconds are the device's work and not the
time to enqueue it. ``device_trace`` records a ``torch.profiler`` trace of the
CPU and the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch import nn


def count_params(params: Union[nn.Module, Iterable[torch.Tensor], Dict[str, torch.Tensor]]) -> int:
    """Elements of a module's parameters, or of a collection of tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return int(sum(p.numel() for p in params))


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode``; ``{"flops": total}``
    with one entry per counted op (``"flops:<op>"``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    out = {"flops": float(counter.get_total_flops())}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out[f"flops:{op}"] = float(n)
    return out


def flops(fn: Callable, *args, **kwargs) -> float:
    return cost_analysis(fn, *args, **kwargs)["flops"]


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating wall-clock phase timer producing a reference-style
    ``{'y_enc': ..., 'z_enc': ...}`` dict; with a CUDA ``device`` each phase
    starts and ends with a ``synchronize``."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self.times)


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the card,
    written to ``logdir/trace.json`` (Chrome trace format) on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
