"""Reduction of a profiled interval to device intervals and host ranges.

The profiler records the card's kernels, copies and sets (``kernels``: name,
start, end, in the profiler's microseconds) and the harness's ranges
``perfbench.<span>`` (``ranges``). From them:

- ``busy_us``: the length of the union of the device intervals;
- ``gaps``: the device's idle gaps between them, each labelled with the span
  the host was in at the gap's middle (``runner`` outside every span);
- ``by_name``: device time summed by operation name.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

PREFIX = "perfbench."

Interval = Tuple[str, float, float]


def collect(prof) -> Dict[str, List[Interval]]:
    from torch.autograd import DeviceType

    kernels, ranges = [], []
    for e in prof.events():
        name = e.name
        start, end = float(e.time_range.start), float(e.time_range.end)
        if name.startswith(PREFIX):
            if e.device_type == DeviceType.CPU:
                ranges.append((name[len(PREFIX):], start, end))
        elif e.device_type == DeviceType.CUDA and end > start:
            kernels.append((name, start, end))
    kernels.sort(key=lambda k: k[1])
    ranges.sort(key=lambda r: r[1])
    return {"kernels": kernels, "ranges": ranges}


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda k: k[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(kernels: List[Interval]) -> float:
    return sum(b - a for a, b in union(kernels))


def label(ranges: List[Interval], t: float) -> str:
    for span, a, b in ranges:
        if a <= t <= b:
            return span
    return "runner"


def gaps(kernels: List[Interval], ranges: List[Interval]) -> List[Tuple[str, float]]:
    """Idle gaps between device intervals, longest first: (label, microseconds)."""
    merged = union(kernels)
    out = [(label(ranges, (b0 + a1) / 2.0), a1 - b0)
           for (_, b0), (a1, _) in zip(merged, merged[1:]) if a1 > b0]
    return sorted(out, key=lambda g: -g[1])


def by_name(kernels: List[Interval]) -> List[Tuple[str, float]]:
    acc = defaultdict(float)
    for name, a, b in kernels:
        acc[name] += b - a
    return sorted(acc.items(), key=lambda kv: -kv[1])


def within(kernels: List[Interval], ranges: List[Interval], span: str) -> List[Interval]:
    """Device intervals that start inside a host range of ``span``."""
    spans = [(a, b) for s, a, b in ranges if s == span]
    return [k for k in kernels if any(a <= k[1] <= b for a, b in spans)]


def host_spans(run, name: str) -> List[Tuple[float, float]]:
    """Host spans ``name`` of the traced run that lie inside the measured window."""
    a, b = run.window
    return [(t0, t1) for s, t0, t1 in run.recorder.spans if s == name and t0 >= a and t1 <= b]


def host_seconds(run, name: str) -> float:
    return sum(t1 - t0 for t0, t1 in host_spans(run, name))
