"""Each configuration brings its plain reference and its count by name
(``"reference"``: ``perfbench/reference/<name>.py``): a net added by files
alone is checked, compared and counted through its own module; a setting no
reference implements, a missing module and other widths are refused."""

from __future__ import annotations

import hashlib
import json
import shutil
import time
import types
from pathlib import Path

import pytest
import torch

from conftest import REPO, TINY_PARAMS_MILLIONS, add_tiny_cells, copy_benchmark
from perfbench.check import judge
from perfbench.harness import Run, RunError, check_params, check_settings, run_cell
from perfbench.manifest import Manifest
from perfbench.peaks import PEAKS
from tvc_torch.core.config import config_from_dict
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM

# a net of another architecture, as a later change would add it: its own
# settings, its own count, and a record of the calls the comparison makes
NEW_NET = '''"""A test net: the plain NCSN++ pinned to one res block a level, counted
as three times its operations and twice its heads."""

from perfbench.reference import unet

SETTINGS = dict(unet.SETTINGS, num_res_blocks=1)
CALLS = []


class Net(unet.Net):
    def __call__(self, x, labels, cond):
        CALLS.append(tuple(x.shape))
        return super().__call__(x, labels, cond)


def unet_flops(cfg, batch=1):
    return 3.0 * unet.unet_flops(cfg, batch)


def attention_launches(cfg):
    return [(2 * h, t, d) for h, t, d in unet.attention_launches(cfg)]
'''
NEW_FILES = {"perfbench/reference/tiny_net.py", "perfbench/configs/tiny-net.json",
             "perfbench/limits/tiny-net.gop.json"}


def snapshot(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def tiny_copy(tmp_path: Path, edit) -> Path:
    """A tiny root whose ``tiny-f32`` configuration file ``edit`` changed."""
    root = copy_benchmark(tmp_path)
    add_tiny_cells(root)
    path = root / "perfbench/configs/tiny-f32.json"
    c = json.loads(path.read_text())
    edit(c)
    path.write_text(json.dumps(c))
    return root


@pytest.fixture(scope="module")
def new_net_root(tmp_path_factory) -> Path:
    root = copy_benchmark(tmp_path_factory.mktemp("newnet"))
    add_tiny_cells(root)
    before = snapshot(root)
    pb = root / "perfbench"
    (pb / "reference/tiny_net.py").write_text(NEW_NET)
    c = json.loads((pb / "configs/tiny-f32.json").read_text())
    c.update(name="tiny-net", reference="tiny_net")
    (pb / "configs/tiny-net.json").write_text(json.dumps(c))
    shutil.copy(pb / "limits/tiny.gop.json", pb / "limits/tiny-net.gop.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-net", "source": "a test configuration",
                         "file": "perfbench/configs/tiny-net.json", "reduced": [],
                         "why": "a net added by files alone"})
    b["workloads"].append({"name": "tiny-net.gop", "config": "tiny-net", "traffic": "tiny-gop",
                           "chips": 1, "why": "a net added by files alone"})
    for m in b["per_layer"]:
        m["workloads"].append("tiny-net.gop")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    after = snapshot(root)
    assert set(after) - set(before) == NEW_FILES
    assert {k for k in before if after[k] != before[k]} == {"BENCHMARK.json"}
    return root


def test_a_net_added_by_files_alone_is_checked_compared_and_counted(new_net_root):
    run = Run("tiny-net.gop", 2 ** 31 + 5, 0.01, False, "cpu", new_net_root, time.perf_counter())
    net = run.reference
    assert Path(net.__file__) == new_net_root / "perfbench/reference/tiny_net.py"
    run.setup()
    run.measure()
    run.decode_streams()
    run.free_program()
    correct, checks = judge(run.compare(), run.limits)
    assert correct is True and set(checks) == {"pred_rms", "lpips_gap", "recon_med", "gops_wrong"}
    # one sampled prediction of 4 steps and the denoise step, through the new net
    assert net.CALLS == [(1, 64, 64, 15)] * 5

    manifest = Manifest(new_net_root)
    unet = manifest.reference(dict(run.config, reference="unet"))
    fake = dict(trace=True, peaks=PEAKS["H100"], traced_window_s=2.0, unet_calls=10,
                config=run.config, batch=1,
                profile={"kernels": [("attention_fwd<1>", 0.0, 10.0)] * 6})
    for metric, ratio in (("unet_mfu_pct", 3.0), ("attn_roofline_pct", 2.0)):
        read = manifest.module("metrics", metric).read
        new = read(types.SimpleNamespace(reference=net, **fake))
        plain = read(types.SimpleNamespace(reference=unet, **fake))
        assert plain > 0 and new == pytest.approx(ratio * plain, rel=1e-12)


def test_the_settings_checked_are_the_named_modules(new_net_root):
    manifest = Manifest(new_net_root)
    c = manifest.config({"config": "tiny-net"})
    net, unet = manifest.reference(c), manifest.reference(dict(c, reference="unet"))
    c["config"]["model"]["num_res_blocks"] = 2
    with pytest.raises(RunError, match=r"model\.num_res_blocks=2"):
        check_settings(c["config"], net)
    check_settings(c["config"], unet)


def _drop(section, key):
    return lambda c: c["config"][section].pop(key)


def _set(section, key, value):
    return lambda c: c["config"][section].__setitem__(key, value)


@pytest.mark.parametrize("edit,message", [
    (_set("model", "spade", True), r"model\.spade=True"),
    (_set("model", "arch", "unetmore3d"), r"model\.arch='unetmore3d'"),
    (_set("model", "embedding_type", "fourier"), r"model\.embedding_type='fourier'"),
    (_set("model", "version", "SMLD"), r"model\.version='SMLD'"),
    (_set("sampling", "denoise", False), r"sampling\.denoise=False"),
    (_set("codec", "exact_streams", False), r"codec\.exact_streams=False"),
    (_drop("model", "cond_emb"), r"does not set model\.cond_emb")])
def test_a_setting_its_reference_lacks_is_refused_before_set_up(tmp_path, monkeypatch, edit,
                                                                message):
    root = tiny_copy(tmp_path, edit)
    monkeypatch.setattr(Run, "setup", lambda self: pytest.fail("the run was set up"))
    with pytest.raises(RunError, match=message):
        run_cell("tiny.gop", 3, 0.01, False, device="cpu", root=root)


@pytest.mark.parametrize("reference,message", [
    (None, "names no reference"), ("../reference/unet", "names no reference"),
    ("spade", r"perfbench/reference/spade\.py does not exist"),
    ("ddpm", "lacks SETTINGS, Net, unet_flops, attention_launches")])
def test_a_configuration_names_a_reference_module(reference, message):
    manifest = Manifest(REPO)
    c = manifest.config({"config": "ncsnpp-city-f32"})
    assert manifest.reference(c).__file__ == str(REPO / "perfbench/reference/unet.py")
    c.pop("reference")
    if reference is not None:
        c["reference"] = reference
    with pytest.raises(ValueError, match=message):
        manifest.reference(c)


@pytest.mark.parametrize("config", ["ncsnpp-city-f32", "ncsnpp-city-bf16"])
def test_the_configurations_hold_their_published_parameters(config):
    c = Manifest(REPO).config({"config": config})
    assert c["params_millions"] == 262.1
    unet = UNetMoreDDPM(config_from_dict(c["config"]), device="meta")
    assert sum(p.numel() for p in unet.parameters()) == 262_133_775
    check_params(unet, c["params_millions"])
    check_params(unet.to(torch.bfloat16), c["params_millions"])  # every dtype counts
    check_params(unet, 262.18)  # 262.133775 against 0.05M either way
    for stated in (262.08, 262.19):
        with pytest.raises(RunError, match="params_millions"):
            check_params(unet, stated)


def test_a_run_refuses_other_widths(tmp_path):
    root = tiny_copy(tmp_path, lambda c: c.update(params_millions=TINY_PARAMS_MILLIONS + 0.06))
    with pytest.raises(RunError, match=r"holds 0\.0652M parameters"):
        run_cell("tiny.gop", 3, 0.01, False, device="cpu", root=root)
