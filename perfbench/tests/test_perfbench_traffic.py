"""The traffic is a function of the seed: same seed, same clips and samples."""

from __future__ import annotations

import json

import numpy as np

from conftest import REPO
from perfbench import video
from perfbench.weights import subseed

BIG = 2 ** 31 + 12345


def traffic(name):
    return json.loads((REPO / f"perfbench/traffic/{name}.json").read_text())


def test_clips_are_deterministic_from_the_seed():
    spec = dict(traffic("gop-worst")["video"], size=32)
    a = video.moving_pattern(BIG, 1, 2, 6, spec)
    b = video.moving_pattern(BIG, 1, 2, 6, spec)
    c = video.moving_pattern(BIG + 1, 1, 2, 6, spec)
    d = video.moving_pattern(BIG, 1, 3, 6, spec)
    assert a.tobytes() == b.tobytes()
    assert a.shape == c.shape == d.shape == (6, 32, 32, 3) and a.dtype == np.float32
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    assert 0.0 <= a.min() and a.max() <= 1.0


def test_pool_shape_is_the_same_for_every_seed():
    t = dict(traffic("lockstep8"), frames=4, pool_units=2)
    t["video"] = dict(t["video"], size=16)
    for seed in (0, 7, BIG, 2 ** 63 + 5):
        p = video.pool(seed, t)
        assert len(p) == 2 and all(len(u) == t["chains"] for u in p)
        assert all(c.shape == (4, 16, 16, 3) for u in p for c in u)


def test_subseeds_are_stable_and_distinct():
    assert subseed(BIG, "unit", 0) == subseed(BIG, "unit", 0)
    seeds = {subseed(BIG, "unit", k) for k in range(50)} | {subseed(BIG, "unet")}
    assert len(seeds) == 51 and all(0 <= s < 2 ** 63 for s in seeds)


def test_forced_trajectory_and_scored_lengths():
    from perfbench.runners.device_gop import trajectory
    from perfbench.runners.lockstep import score_sizes as lock_sizes

    t = traffic("gop-worst")
    sizes, d = trajectory(t["frames"], 2, 5, t["forced_accepts"])
    assert sizes == [5, 5, 5, 5, 5, 5, 4]
    assert d == [1, 1] + [0] * 5 + [1, 1] + [0] * 5 + [1, 1] + [0] * 14
    assert len(t["forced_accepts"]) == t["calls_per_unit"]["generate"]
    assert lock_sizes(30, 2, 5) == [5, 5, 5, 5, 5, 3]
    assert len(lock_sizes(30, 2, 5)) == traffic("lockstep8")["calls_per_unit"]["generate"]


def test_sample_plan_is_drawn_from_the_seed(tiny_root):
    from perfbench.harness import Run

    def plan(seed):
        return Run("city-f32.gop-worst", seed, 1.0, False, "cpu", tiny_root, 0.0).sample_plan()

    a, b = plan(BIG), plan(BIG)
    assert a == b and len(a["generate"]) == 2 and a["keyframe"] == {0, 1, 2}
    assert any(plan(s)["generate"] != a["generate"] for s in range(1, 20))
