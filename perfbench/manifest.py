"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its ``configs`` entry, whose
``reference`` names its plain reference module
``perfbench/reference/<reference>.py``; the traffic mix is
``perfbench/traffic/<traffic>.json``, whose ``runner`` names the runner
module ``perfbench/runners/<runner>.py``; the cell's limits are
``perfbench/limits/<cell>.json``; each metric is read by
``perfbench/metrics/<name>.py``. A later change adds a cell, a
configuration (of another architecture too) or a metric by adding files and
entries only.

A reference module is plain PyTorch: it imports nothing of the program
(``tvc_torch``) and nothing of JAX or of the JAX package, and provides

- ``SETTINGS``: the ``model`` keys of the configuration, with their values,
  that its plain net implements (``perfbench/harness.py`` refuses a
  configuration that sets another value, and checks the settings every
  configuration shares itself);
- ``Net(cfg, state, precision)``: the plain net over the UNet's state dict,
  called as ``(x, labels, cond) -> eps`` on NHWC tensors, computed in each
  precision of ``perfbench/reference/precision.py`` (the control runs it one
  precision lower); the shared DDPM sampler (``perfbench/reference/ddpm.py``)
  drives it;
- ``unet_flops(cfg, batch)``: the operations of one call at ``batch``,
  counted as the plain net computes them, by ``perfbench/flops.py``'s rules;
- ``attention_launches(cfg)``: (heads, tokens, head dim) of each attention
  call of one call, in order.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REFERENCE_API = ("SETTINGS", "Net", "unet_flops", "attention_launches")
MODULE_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_\-]{0,63}")


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

    def reference(self, config: dict) -> ModuleType:
        """The configuration's plain reference module, ``perfbench/reference/<reference>.py``."""
        name = config.get("reference")
        if not isinstance(name, str) or not MODULE_NAME.fullmatch(name):
            raise ValueError(f"configuration {config.get('name')!r} names no reference module "
                             f"(its \"reference\" is {name!r})")
        if not (self.bench_dir / "reference" / f"{name}.py").is_file():
            raise ValueError(f"configuration {config.get('name')!r} names the reference {name!r}, "
                             f"and perfbench/reference/{name}.py does not exist")
        mod = self.module("reference", name)
        missing = [a for a in REFERENCE_API if not hasattr(mod, a)]
        if missing:
            raise ValueError(f"perfbench/reference/{name}.py lacks {', '.join(missing)}")
        return mod

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
