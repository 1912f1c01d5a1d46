"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny cells.

``tiny_root`` is a checkout-shaped directory holding ``BENCHMARK.json`` and a
copy of ``perfbench/`` with one more configuration (``tiny-f32``: the flagship
settings at 64x64 frames, ngf 8, two levels, 4 sampling steps, ELIC at N 16,
M 40; 65,167 UNet parameters; the reference ``unet``) and two more cells, added by files and entries only, as a later change
adds a cell: ``tiny.gop`` (the GOP runner, 12 frames forced 5, 0, 5) and
``tiny.lock`` (the lockstep runner at B = 2). Their limits are the float32
cell's.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
F32_CELL = "city-f32.gop-worst"
TINY_PARAMS_MILLIONS = 0.065167


def add_tiny_cells(root: Path) -> None:
    b = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    c = json.loads((pb / "configs/ncsnpp-city-f32.json").read_text())
    c["name"] = "tiny-f32"
    c["params_millions"] = TINY_PARAMS_MILLIONS
    cc = c["config"]
    cc["data"]["image_size"] = 64
    cc["model"].update(ngf=8, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[32],
                       n_head_channels=8)
    cc["sampling"]["subsample"] = 4
    cc["codec"].update(N=16, M=40, groups=[4, 4, 8, 8, 16])
    (pb / "configs/tiny-f32.json").write_text(json.dumps(c))
    t = json.loads((pb / "traffic/gop-worst.json").read_text())
    t.update(frames=12, forced_accepts=[5, 0, 5],
             calls_per_unit={"generate": 3, "score": 3, "keyframe": 2},
             check={"generate": 1, "score": 3, "keyframe": 2})
    t["video"]["size"] = 64
    (pb / "traffic/tiny-gop.json").write_text(json.dumps(t))
    lk = json.loads((pb / "traffic/lockstep8.json").read_text())
    lk.update(frames=12, batch=2, chains=2, calls_per_unit={"generate": 2, "score": 4, "keyframe": 1},
              check={"generate": 1, "score": 4, "keyframe": 1})
    lk["video"]["size"] = 64
    (pb / "traffic/tiny-lock.json").write_text(json.dumps(lk))
    b["configs"].append({"name": "tiny-f32", "source": "a test configuration",
                         "file": "perfbench/configs/tiny-f32.json", "reduced": [],
                         "why": "the CPU tests"})
    for name, traffic in (("tiny.gop", "tiny-gop"), ("tiny.lock", "tiny-lock")):
        b["workloads"].append({"name": name, "config": "tiny-f32", "traffic": traffic,
                               "chips": 1, "why": "the CPU tests"})
        shutil.copy(pb / f"limits/{F32_CELL}.json", pb / f"limits/{name}.json")
    for m in b["per_layer"]:
        m["workloads"] += ["tiny.gop", "tiny.lock"]
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def copy_benchmark(dest: Path) -> Path:
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    add_tiny_cells(root)
    return root


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
