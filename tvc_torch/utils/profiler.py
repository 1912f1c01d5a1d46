"""Parameter counts, the port's span-and-counter recorder and its device trace
(counterpart of ``tvc/utils/profiler.py``).

The recorder marks what the host is doing at each layer boundary of the GOP
paths:

- ``span(name, gop=None)``: a context manager around one piece of work;
- ``count(name, n=1)``: adds to a counter;
- ``fetch(t, layer)`` and ``upload(a, device)``: the paths' device-to-host
  reads and host-to-device copies, counted as ``reads.<layer>`` and
  ``uploads`` (with their bytes under ``<counter>.bytes``).

Recording is off by default: each site then costs one check of a module flag,
with no allocation, no clock read and no profiler call. ``enable()`` /
``disable()`` or the ``tracing()`` context turn it on for a stretch of the
program (``enable`` starts a fresh record); ``record()`` returns what was
recorded, also after ``disable()``.

A span holds its name, its start and end as ``time.perf_counter_ns()``, the
index of the span open when it began (its parent; -1 at the top) and the GOP
it serves: a GOP's seed in ``DeviceGOPRunner``, the job's index in a lockstep
run, or a list of them for a span over a batch (``gop`` may be a callable
returning it, evaluated only while recording). While a ``torch.profiler``
session records, a span is also a ``record_function`` range ``tvc.<name>``:
it sits on the profiler's clock and nests around the runtime calls that
launch its kernels, a replayed UNet call's ``cudaGraphLaunch`` included (the
kernels inside one graph cannot be split by host ranges). A span never waits
for the device: it measures the host, and the device side comes from the
profile. Spans are recorded from one thread.

``timed(name, gop=None)`` is a span that reads the clock whether or not
recording is on, for the sites whose seconds the program reports
(``GOPResult.update_s`` and ``keyframe_s``, ``DeviceGOPRunner.run``'s
``timings``, ``ELICCoder``'s ``out["time"]``, ``GraphedEps.stats()``'s
``capture_s``): its ``seconds`` come from the same two clock reads as the
recorded span.

``device_trace(logdir)`` records a ``torch.profiler`` trace of the CPU and,
where there is one, the card, with the recorder on: ``logdir/trace.json``
(Chrome trace format, with the ``tvc.*`` ranges) and ``logdir/counters.json``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
from typing import Any, Dict, Iterable, List, Union

import numpy as np
import torch
from torch import nn

_on = False
_generation = 0             # bumped by enable(): a span opened before it is not closed into it
_spans: List[list] = []     # [name, start_ns, end_ns, parent, gop]
_open: List[int] = []       # indices of the open spans, innermost last
_counters: Dict[str, int] = {}
_ranges_warm = False
_NULL = contextlib.nullcontext()


def count_params(params: Union[nn.Module, Iterable[torch.Tensor], Dict[str, torch.Tensor]]) -> int:
    """Elements of a module's parameters, or of a collection of tensors."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return int(sum(p.numel() for p in params))


@contextlib.contextmanager
def _gc_paused():
    """No garbage collection inside: a collection between a profiler range's
    clock read and its span's would lengthen the one and not the other."""
    on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if on:
            gc.enable()


class _Span:
    __slots__ = ("name", "gop", "t0", "t1", "_index", "_generation", "_range")

    def __init__(self, name: str, gop: Any = None):
        self.name, self.gop = name, gop
        self.t0 = self.t1 = 0
        self._index = self._range = None

    def __enter__(self) -> "_Span":
        if _on:
            gop = self.gop() if callable(self.gop) else self.gop
            self._index, self._generation = len(_spans), _generation
            _spans.append([self.name, None, None, _open[-1] if _open else -1, gop])
            _open.append(self._index)
            if torch.autograd._profiler_enabled():
                self._range = torch.profiler.record_function("tvc." + self.name)
        with _gc_paused() if self._range is not None else _NULL:
            if self._range is not None:
                self._range.__enter__()
            self.t0 = time.perf_counter_ns()
        if self._index is not None:
            _spans[self._index][1] = self.t0
        return self

    def __exit__(self, *exc) -> bool:
        with _gc_paused() if self._range is not None else _NULL:
            self.t1 = time.perf_counter_ns()
            if self._index is not None:
                if self._generation == _generation:
                    _spans[self._index][2] = self.t1
                    if _open and _open[-1] == self._index:
                        _open.pop()
                if self._range is not None:
                    self._range.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def span(name: str, gop: Any = None):
    """A span of the host's work while recording; otherwise a shared no-op context."""
    if not _on:
        return _NULL
    return _Span(name, gop)


def timed(name: str, gop: Any = None) -> _Span:
    """A span whose ``seconds`` are read whether or not recording is on."""
    return _Span(name, gop)


def count(name: str, n: int = 1) -> None:
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def fetch(t: torch.Tensor, layer: str) -> torch.Tensor:
    """``t`` on the host (``.cpu()``), counted as a read of ``layer``."""
    out = t.detach().cpu()
    if _on:
        count("reads." + layer)
        count(f"reads.{layer}.bytes", out.numel() * out.element_size())
    return out


def upload(a, device, dtype=None) -> torch.Tensor:
    """Host data ``a`` on ``device``, counted as an upload: an array is copied
    (``torch.tensor``), a host tensor moved (``.to``)."""
    if torch.is_tensor(a):
        nbytes, out = a.numel() * a.element_size(), a.to(device=device, dtype=dtype)
    else:
        a = np.asarray(a)
        nbytes, out = a.nbytes, torch.tensor(a, dtype=dtype, device=device)
    if _on:
        count("uploads")
        count("uploads.bytes", nbytes)
    return out


def enable() -> None:
    """Start a fresh record (a no-op while recording)."""
    global _on, _generation, _ranges_warm
    if _on:
        return
    if not _ranges_warm and not torch.autograd._profiler_enabled():
        # a process's first profiler range costs about a millisecond more
        # than the rest: pay it here, where no profiler records it
        with torch.profiler.record_function("tvc"):
            _ranges_warm = True
    _generation += 1
    _spans.clear()
    _open.clear()
    _counters.clear()
    _on = True


def disable() -> None:
    global _on
    _on = False


@contextlib.contextmanager
def tracing():
    """Recording on for the body (left on if it was on already)."""
    was = _on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def record() -> Dict[str, Any]:
    """``{"spans": [...], "counters": {...}}`` of the current or last record.
    A span is ``{"name", "start_ns", "end_ns", "parent", "gop"}`` (``end_ns``
    None while it is open); the counters include the attention kernels'
    launch counts as ``ops/attention.py`` keeps them (``attention.kernel_launches``)
    and the GroupNorm kernel's as ``ops/groupnorm.py`` does
    (``groupnorm.kernel_launches``, ``groupnorm.spade_launches``,
    ``groupnorm.channels_last_writes``) and the FIR resampling kernel's as
    ``ops/resample.py`` does (``resample.fir_launches``)."""
    from tvc_torch.ops import attention, groupnorm, resample

    counters: Dict[str, Any] = dict(_counters)
    counters["attention.kernel_launches"] = dict(attention.kernel_launches)
    counters["groupnorm.kernel_launches"] = groupnorm.launches
    counters["groupnorm.spade_launches"] = groupnorm.spade_launches
    counters["groupnorm.channels_last_writes"] = groupnorm.channels_last_writes
    counters["resample.fir_launches"] = resample.launches
    return {"spans": [{"name": n, "start_ns": a, "end_ns": b, "parent": p, "gop": g}
                      for n, a, b, p, g in _spans],
            "counters": counters}


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the card,
    with the recorder on, written to ``logdir/trace.json`` (Chrome trace
    format) and ``logdir/counters.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(record()["counters"], f, indent=1, sort_keys=True)
