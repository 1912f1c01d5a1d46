"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its ``configs`` entry; the
traffic mix is ``perfbench/traffic/<traffic>.json``, whose ``runner`` names
the runner module ``perfbench/runners/<runner>.py``; the cell's limits are
``perfbench/limits/<cell>.json``; each metric is read by
``perfbench/metrics/<name>.py``. A later change adds a cell, a
configuration or a metric by adding files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "perfbench"
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return load_json(self.bench_dir / "traffic" / f"{cell['traffic']}.json")

    def limits_path(self, cell: dict) -> Path:
        return self.bench_dir / "limits" / f"{cell['name']}.json"

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        without tracing, its per-layer metrics with it."""
        group = self.data["per_layer"] if trace else self.data["end_to_end"]
        return [m for m in group if "workloads" not in m or cell["name"] in m["workloads"]]

    def module(self, kind: str, name: str) -> ModuleType:
        """``perfbench/<kind>/<name>.py``, loaded by its path."""
        path = self.bench_dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}".replace("-", "_")
                                                      .replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
