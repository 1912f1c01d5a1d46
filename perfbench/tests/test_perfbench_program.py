"""The reduction of the program's spans and counters (``perfbench/program.py``)
on a canned record, profile and interval, and on a real CPU profile."""

from __future__ import annotations

import types

import pytest

from conftest import REPO
from perfbench import program
from perfbench.manifest import Manifest

WINDOW = (10.0, 10.001)  # the profiler's run, perf_counter seconds: 1000 us
OFFSET = 4.6 - 10.0e6    # the trace's clock less the spans', microseconds
T0 = 10_000_000_000      # the window's start in perf_counter_ns


def span(name, a_us, b_us, parent=-1):
    return {"name": name, "start_ns": T0 + int(a_us * 1e3), "end_ns": T0 + int(b_us * 1e3),
            "parent": parent, "gop": None}


def canned():
    """An update opened before the profiler started (so no range), a
    prediction, then a keyframe with a rANS stretch inside; device intervals
    leave the card idle in a prediction, across the keyframe's two spans,
    and after every span has closed."""
    record = {"spans": [span("runner.update", -100, 900), span("predictor.generate", 100, 400, 0),
                        span("codec.compress", 500, 800, 0), span("codec.chain.rans", 600, 700, 2)],
              "counters": {"codec.frames": 2, "reads.runner": 1, "reads.score": 7,
                           "graph.captures": 1, "kernels.builds": 2}}
    # the ranges begin and end a little outside their spans, as record_function's do
    ranges = [("predictor.generate", 104.6, 405.2), ("codec.compress", 504.6, 805.2),
              ("codec.chain.rans", 604.6, 705.2)]
    kernels = [("k", 5.0, 150.0), ("k", 300.0, 550.0), ("k", 650.0, 660.0),
               ("tvc.predictor.generate", 120.0, 350.0)]  # an annotation, not device work
    return record, ranges, kernels


def test_idle_time_split_by_innermost_span_by_overlap():
    record, ranges, kernels = canned()
    assert program.clock_offset_us(record, ranges, WINDOW) == pytest.approx(OFFSET)
    idle = program.idle_by_span(record, ranges, kernels, WINDOW)
    us = {k: round(v * 1e6, 1) for k, v in idle.items()}
    # on the trace's clock the interval is [4.6, 1004.6]: idle [4.6, 5] in the
    # update, [150, 300] in the prediction, [550, 650] and [660, 1004.6]
    # across the keyframe, its rANS stretch, the update and no span at all
    assert us == {"predictor.generate": 150.0, "codec.compress": 54.6 + 100.0,
                  "codec.chain.rans": 45.4 + 44.6, "runner.update": 0.4 + 100.0, "": 100.0}
    assert program.idle_line(idle).startswith("codec.compress=0.000155s ")


def test_idle_shares_add_up_to_the_device_idle_share():
    record, ranges, kernels = canned()
    window_s = WINDOW[1] - WINDOW[0]
    shares = program.idle_shares(program.idle_by_span(record, ranges, kernels, WINDOW),
                                 window_s)
    assert shares["sampler"] == pytest.approx(15.0)
    assert shares["keyframe"] == pytest.approx(24.46)
    assert shares["runner"] == pytest.approx(10.04) and shares["score"] == 0.0
    busy_s = (145.0 + 250.0 + 10.0) / 1e6
    run = types.SimpleNamespace(profile={"window_s": window_s, "busy_s": busy_s})
    idle_pct = Manifest(REPO).module("metrics", "device_idle_pct").read(run)
    assert sum(shares.values()) == pytest.approx(idle_pct)


def test_per_frame_self_times_and_counters():
    record = canned()[0]
    # the keyframe's 300 us less its rANS child, over 2 frames
    assert program.self_ms_per_frame(record, "codec.compress") == pytest.approx(0.1)
    assert program.self_ms_per_frame(record, "codec.chain.rans") == pytest.approx(0.05)
    assert program.host_reads_per_update(record) == 8.0
    assert program.unet_rebuilds(record) == 3
    bare = dict(record, counters={})
    assert program.unet_rebuilds(bare) == 0 and program.host_reads_per_update(bare) == 0.0


def test_silent_without_a_record_or_a_trace():
    record, ranges, kernels = canned()
    for rec in (None, {"spans": [], "counters": {}}):
        assert program.self_ms_per_frame(rec, "codec.compress") is None
        assert program.host_reads_per_update(rec) is None
        assert program.unet_rebuilds(rec) is None
        assert program.idle_by_span(rec, ranges, kernels, WINDOW) is None
    assert program.idle_by_span(record, [], kernels, WINDOW) is None
    assert program.idle_shares(None, 1.0) is None and program.idle_line(None) is None


def test_ranges_of_a_cpu_profile_place_the_spans():
    """The program's spans under torch.profiler: ``ranges_of`` finds their
    ranges, and the offset puts each span inside its range."""
    import time

    from torch.profiler import ProfilerActivity, profile

    profiler = pytest.importorskip("tvc_torch.utils.profiler")
    if not hasattr(profiler, "tracing"):
        pytest.skip("a program without the recorder")
    with profiler.tracing():
        with profiler.span("runner.gop"):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                with profiler.span("predictor.generate"):
                    time.sleep(0.002)
                with profiler.span("score"):
                    time.sleep(0.001)
                t1 = time.perf_counter()
        record = profiler.record()
    ranges = program.ranges_of(prof)
    assert [r[0] for r in ranges] == ["predictor.generate", "score"]
    off = program.clock_offset_us(record, ranges, (t0, t1))
    for (_, a, b), s in zip(ranges, record["spans"][1:]):
        assert a <= s["start_ns"] / 1e3 + off + 50 and s["end_ns"] / 1e3 + off <= b + 50
    # no device: the whole interval is idle, most of it in the two spans
    idle = program.idle_by_span(record, ranges, [], (t0, t1))
    assert sum(idle.values()) == pytest.approx(t1 - t0)
    assert idle["predictor.generate"] > 0.0015 and idle["score"] > 0.0007
