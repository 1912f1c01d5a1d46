"""Whole runs on the CPU at tiny sizes: the result line, the data-driven
layout, and the refusals."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, copy_benchmark
from perfbench.harness import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny.gop", "tiny.lock"])
def test_a_cell_added_by_files_alone_runs(tiny_root, cell):
    res = run_cell(cell, 2 ** 31 + 99, 0.5, False, device="cpu", root=tiny_root)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}  # no card: no peak memory
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 1
    assert set(res["checks"]) == {"pred_rms", "lpips_gap", "recon_med", "gops_wrong"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_run_reports_span_metrics(tiny_root):
    res = run_cell("tiny.gop", 5, 0.5, True, device="cpu", root=tiny_root)
    assert res["correct"] is True
    # on the CPU the profiler sees no device: the device's readers stay silent
    assert {"runner_host_pct", "keyframe_pct", "update_s"} <= set(res["metrics"])
    assert "device_idle_pct" not in res["metrics"] and "busy_s" not in res["device"]
    assert 0 < res["metrics"]["keyframe_pct"]["value"] < 100


def test_same_seed_same_outputs(tiny_root):
    a = run_cell("tiny.gop", 17, 0.01, False, device="cpu", root=tiny_root)
    b = run_cell("tiny.gop", 17, 0.01, False, device="cpu", root=tiny_root)
    assert a["checks"] == b["checks"] and a["attempted"] == b["attempted"] == 1


def run_py(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "city-f32.gop-worst", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=str(cwd), env=env, timeout=300)


def test_no_card_no_result():
    out = run_py(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    root = copy_benchmark(tmp_path)
    assert sorted(p.name for p in root.iterdir()) == ["BENCHMARK.json", "perfbench"]
    probe = ("import sys; sys.path[:] = [p for p in sys.path if 'repo' not in p]; "
             "sys.path.insert(0, '.'); from perfbench.harness import run_cell; "
             "run_cell('city-f32.gop-worst', 3, 1.0, False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=str(root), timeout=300)
    assert out.returncode != 0 and "tvc_torch" in out.stderr
    assert run_py(root).returncode != 0
