"""Metric arithmetic on canned profiler intervals and host spans."""

from __future__ import annotations

import types

import pytest

from conftest import REPO
from perfbench import timeline as tl
from perfbench.flops import unet_attention_bound_s
from perfbench.manifest import Manifest
from perfbench.reference.unet import attention_launches, unet_flops

KERNELS = [("conv", 0.0, 10.0), ("gn", 5.0, 15.0), ("attention_fwd<1>", 20.0, 30.0),
           ("conv", 40.0, 45.0), ("attention_fwd<1>", 50.0, 60.0)]
RANGES = [("generate", 0.0, 32.0), ("keyframe", 33.0, 48.0)]


def metric(name):
    return Manifest(REPO).module("metrics", name).read


def test_union_busy_and_gaps():
    assert tl.union(KERNELS) == [(0.0, 15.0), (20.0, 30.0), (40.0, 45.0), (50.0, 60.0)]
    assert tl.busy_us(KERNELS) == 40.0
    assert tl.gaps(KERNELS, RANGES) == [("keyframe", 10.0), ("generate", 5.0),
                                        ("keyframe", 5.0)]
    assert tl.by_name(KERNELS)[0] == ("attention_fwd<1>", 20.0)
    assert [k[1] for k in tl.within(KERNELS, RANGES, "generate")] == [0.0, 5.0, 20.0]


def fake_run(**kw):
    cfg = __import__("json").loads((REPO / "perfbench/configs/ncsnpp-city-f32.json").read_text())
    run = types.SimpleNamespace(trace=True, window=(100.0, 110.0), window_s=10.0,
                                traced_window_s=10.0, frames=30,
                                config=cfg, batch=1, peaks={"float32": 67e12, "bfloat16": 989e12,
                                                            "hbm_bytes_s": 3.35e12},
                                predictor=types.SimpleNamespace(n_steps=101), unet_calls=707,
                                peak_bytes=3 * 2 ** 30, setup_s=12.5,
                                reference=Manifest(REPO).reference(cfg))
    spans = [("generate", 100.0, 102.0), ("score", 102.0, 102.1), ("keyframe", 102.2, 102.4),
             ("generate", 102.5, 104.5), ("generate", 90.0, 92.0)]  # the last: warm-up
    run.recorder = types.SimpleNamespace(spans=spans)
    run.profile = {"kernels": KERNELS, "ranges": RANGES, "window_s": 80e-6, "busy_s": 40e-6}
    run.__dict__.update(kw)
    return run


def test_span_metrics():
    run = fake_run()
    assert metric("update_s")(run) == pytest.approx(2.0)
    assert metric("keyframe_pct")(run) == pytest.approx(2.0)
    assert metric("runner_host_pct")(run) == pytest.approx(100 * (1 - 4.2 / 10))
    assert metric("frames_per_s")(run) == pytest.approx(3.0)
    assert metric("peak_mem_gib")(run) == pytest.approx(3.0)
    assert metric("setup_s")(run) == 12.5
    assert metric("update_s")(fake_run(trace=False)) is None
    # the profiler's own start and stop leave the window the span shares are taken over
    slow = fake_run(traced_window_s=8.0)
    assert metric("keyframe_pct")(slow) == pytest.approx(2.5)
    assert metric("runner_host_pct")(slow) == pytest.approx(100 * (1 - 4.2 / 8))


def test_device_metrics():
    run = fake_run()
    assert metric("device_idle_pct")(run) == pytest.approx(50.0)
    # kernels starting inside the one generate range: 10 + 10 + 10 us over 101 calls
    assert metric("unet_device_ms")(run) == pytest.approx(30.0 / 1e3 / 101)
    cfg = run.config["config"]
    launches = attention_launches(cfg)
    calls = 2 / len(launches)
    bound = calls * unet_attention_bound_s(launches, 1, 4, 67e12, 3.35e12)
    assert metric("attn_roofline_pct")(run) == pytest.approx(100 * bound / 20e-6)
    assert metric("unet_mfu_pct")(run) == pytest.approx(
        100 * unet_flops(cfg, 1) * 707 / 10.0 / 67e12)


def test_readers_are_silent_without_a_trace():
    run = fake_run(profile=None, peaks=None)
    for name in ("device_idle_pct", "unet_device_ms", "attn_roofline_pct", "unet_mfu_pct"):
        assert metric(name)(run) is None
    idle = fake_run()
    idle.profile = dict(idle.profile, busy_s=0.0, kernels=[])
    assert metric("device_idle_pct")(idle) is None
    assert metric("attn_roofline_pct")(idle) is None
