"""``BENCHMARK.json`` against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import re

import pytest

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == KEYS
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(bench["workloads"]) <= 24
    pairs, four = set(), 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
        traffic = json.loads((REPO / f"perfbench/traffic/{w['traffic']}.json").read_text())
        assert (REPO / f"perfbench/runners/{traffic['runner']}.py").exists()
        limits = json.loads((REPO / f"perfbench/limits/{w['name']}.json").read_text())["limits"]
        assert limits["gops_wrong"]["limit"] == 0
    assert four <= max(1, len(bench["workloads"]) // 4)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        assert set(m.get("workloads", cells)) <= cells
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / f"perfbench/metrics/{m['name']}.py").exists()
    # every cell reports setup_s, another end-to-end metric and a per-layer metric
    for w in cells:
        assert sum(1 for m in e2e if w in m.get("workloads", cells)) >= 2
        assert any(w in m.get("workloads", cells) for m in layer)
    # a roofline's or an mfu's metric is a share
    for m in layer:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_names(bench):
    for p in (REPO / "perfbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert PATH.match(p.relative_to(REPO).as_posix())


def test_layers_are_named_in_perf_md(bench):
    perf = (REPO / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert m["layer"] in perf
