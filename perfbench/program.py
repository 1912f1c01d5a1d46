"""The program's own spans and counters, reduced to per-layer numbers.

``tvc_torch/utils/profiler.py`` records, while it is on, a span for each
layer's work (name, start and end in ``time.perf_counter_ns()``, parent) and
counters (host reads, UNet calls, frames coded); under ``torch.profiler``
each span is also a host range ``tvc.<name>`` on the device trace's clock.
From the record of the measured window and the profiled interval's device
intervals and ``tvc.*`` ranges:

- ``self_ms_per_frame``: a span's self time (its length less its children's)
  summed over the record, over the frames the keyframe coder coded;
- ``host_reads_per_update``: the runners' and the scorers' host reads over
  the predictions made;
- ``unet_rebuilds``: UNet calls that did not replay a captured graph, and
  kernel builds;
- ``idle_by_span``: the profiled interval's idle time (no device interval
  running) split, instant by instant, by the innermost span the host was in;
  ``idle_shares`` groups it by layer as a share of the interval, and
  ``idle_line`` is the top ten by span, for standard error.

Under a profiler that records the card, each ``tvc.*`` range also appears on
the device's timeline (an annotation from its first kernel to its last):
those are not device work, and ``device_intervals`` drops them.

The spans are placed on the trace's clock by the ``tvc.*`` ranges: the
spans that began while the profiler ran are those ranges, in order, so the
median gap between a range's start and its span's gives the offset. Spans
opened before the profiler started (a GOP, an update) have no range but are
placed all the same. Every function returns None where there is nothing to
read: an untraced run, or a program that records no spans.
"""

from __future__ import annotations

from bisect import bisect_left
from statistics import median
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "tvc."
# idle shares: a span's layer by the first part of its name
LAYERS = {"codec": "keyframe", "runner": "runner", "score": "score", "predictor": "sampler"}

Interval = Tuple[str, float, float]


def ranges_of(prof) -> List[Interval]:
    """The profile's ``tvc.*`` host ranges: (span name, start, end) in the
    profiler's microseconds, by start."""
    from torch.autograd import DeviceType

    out = [(e.name[len(PREFIX):], float(e.time_range.start), float(e.time_range.end))
           for e in prof.events()
           if e.name.startswith(PREFIX) and e.device_type == DeviceType.CPU]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def device_intervals(kernels: Sequence[Interval]) -> List[Interval]:
    """The profile's device intervals less the ``tvc.*`` annotations."""
    return [k for k in kernels if not k[0].startswith(PREFIX)]


def _closed(record: Optional[dict]) -> List[dict]:
    if not record:
        return []
    return [s for s in record["spans"] if s["end_ns"] is not None]


def _counter(record: dict, name: str) -> int:
    return int(record["counters"].get(name, 0))


def self_ms_per_frame(record: Optional[dict], name: str) -> Optional[float]:
    """Self time of the spans ``name`` over ``codec.frames``, ms a frame."""
    spans = _closed(record)
    frames = _counter(record, "codec.frames") if record else 0
    if not spans or not frames:
        return None
    child_ns: Dict[int, int] = {}
    for s in spans:
        if s["parent"] >= 0:
            child_ns[s["parent"]] = child_ns.get(s["parent"], 0) + s["end_ns"] - s["start_ns"]
    total = sum(s["end_ns"] - s["start_ns"] - child_ns.get(i, 0)
                for i, s in enumerate(record["spans"])
                if s["name"] == name and s["end_ns"] is not None)
    return total / 1e6 / frames


def host_reads_per_update(record: Optional[dict]) -> Optional[float]:
    """``reads.runner`` + ``reads.score`` over the ``predictor.generate`` spans."""
    updates = sum(1 for s in _closed(record) if s["name"] == "predictor.generate")
    if not updates:
        return None
    return (_counter(record, "reads.runner") + _counter(record, "reads.score")) / updates


def unet_rebuilds(record: Optional[dict]) -> Optional[int]:
    """``graph.captures`` + ``unet.eager_calls`` + ``kernels.builds``."""
    if not _closed(record):
        return None
    return sum(_counter(record, k) for k in ("graph.captures", "unet.eager_calls",
                                             "kernels.builds"))


def clock_offset_us(record: Optional[dict], ranges: Sequence[Interval],
                    window_s: Tuple[float, float]) -> Optional[float]:
    """The trace's clock less the spans' (microseconds): the spans that began
    inside ``window_s`` (the profiler's run, in ``time.perf_counter()``
    seconds) are matched in order, by name, to the ``tvc.*`` ranges."""
    lo, hi = window_s[0] * 1e9, window_s[1] * 1e9
    spans = [s for s in _closed(record) if lo <= s["start_ns"] <= hi]
    gaps, k = [], 0
    for name, start, _ in ranges:
        while k < len(spans) and spans[k]["name"] != name:
            k += 1  # a span the trace lacks (still open at the profiler's stop)
        if k == len(spans):
            break
        gaps.append(start - spans[k]["start_ns"] / 1e3)
        k += 1
    return median(gaps) if gaps else None


def _idle(kernels: Sequence[Interval], a: float, b: float) -> List[Tuple[float, float]]:
    """The stretches of [a, b] that no device interval covers."""
    out, t = [], a
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if e <= t:
            continue
        if s >= b:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


def _innermost(spans: Sequence[Tuple[str, float, float]]) -> List[Tuple[float, float, str]]:
    """Stretches of time with the innermost open span's name ("" for none),
    from spans that nest (one thread), sorted by start."""
    bounds = sorted({t for _, a, b in spans for t in (a, b)})
    out = []
    for t0, t1 in zip(bounds, bounds[1:]):
        mid = (t0 + t1) / 2.0
        name = ""
        for n, a, b in spans:  # the latest-starting span that holds mid
            if a > mid:
                break
            if b >= mid:
                name = n
        out.append((t0, t1, name))
    return out


def idle_by_span(record: Optional[dict], ranges: Sequence[Interval],
                 kernels: Sequence[Interval],
                 window_s: Tuple[float, float]) -> Optional[Dict[str, float]]:
    """Idle seconds of the profiled interval ``window_s`` by the innermost
    span open at each instant ("" where none is): an idle stretch across two
    spans is split by its overlap with each. ``kernels`` are the profile's
    device intervals, ``tvc.*`` annotations and all."""
    off = clock_offset_us(record, ranges, window_s)
    if off is None:
        return None
    a, b = window_s[0] * 1e6 + off, window_s[1] * 1e6 + off
    spans = sorted(((s["name"], s["start_ns"] / 1e3 + off, s["end_ns"] / 1e3 + off)
                    for s in _closed(record) if s["end_ns"] / 1e3 + off > a
                    and s["start_ns"] / 1e3 + off < b), key=lambda s: (s[1], -s[2]))
    segments = _innermost(spans)
    starts = [s[0] for s in segments]
    out: Dict[str, float] = {}
    for i0, i1 in _idle(device_intervals(kernels), a, b):
        covered = i0
        k = max(bisect_left(starts, i0) - 1, 0)
        while k < len(segments) and segments[k][0] < i1:
            s0, s1, name = segments[k]
            lap = min(i1, s1) - max(i0, s0)
            if lap > 0:
                out[name] = out.get(name, 0.0) + lap / 1e6
                covered += lap
            k += 1
        if i1 - covered > 0:  # before the first span or after the last
            out[""] = out.get("", 0.0) + (i1 - covered) / 1e6
    return out


def idle_shares(idle: Optional[Dict[str, float]], window_s: float) -> Optional[Dict[str, float]]:
    """``idle_by_span`` as shares of the interval (%) by layer: ``keyframe``,
    ``runner``, ``score``, ``sampler``, and ``none`` where no span was open."""
    if idle is None or window_s <= 0:
        return None
    out = dict.fromkeys(list(LAYERS.values()) + ["none"], 0.0)
    for name, s in idle.items():
        layer = LAYERS.get(name.split(".")[0], "none") if name else "none"
        out[layer] += 100.0 * s / window_s
    return out


def idle_line(idle: Optional[Dict[str, float]]) -> Optional[str]:
    """The top ten spans by idle seconds, for a line of standard error."""
    if not idle:
        return None
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return " ".join(f"{name or '(none)'}={s:.6f}s" for name, s in top)
