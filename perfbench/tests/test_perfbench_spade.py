"""The SPADE configuration (``spade-city-f32``, the reference
``spade_ncsnpp``): its counts frozen and against ``FlopCounterMode``, its
published parameters, the refusals of a net its settings do not match, its
norm kernel's roofline reader, and a tiny SPADE cell run on the CPU through
its own plain reference."""

from __future__ import annotations

import copy
import json
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO, add_tiny_cells, copy_benchmark
from perfbench.check import judge
from perfbench.harness import Run, RunError, check_params, check_settings, run_cell
from perfbench.manifest import Manifest
from perfbench.peaks import PEAKS
from test_perfbench_flops import FROZEN_LAUNCHES
from tvc_torch.core.config import config_from_dict
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM

CONFIG = "spade-city-f32"
# one call of the 347.2M SPADE NCSN++ at 128x128: its operations at B = 1 and
# B = 8 (the trunk's 345,285,623,808 and the SPADE branch's 350,136,041,472
# at B = 1), its 71 modulated norms' elements at B = 1, and their least time
# in float32 at B = 1 on an H100 (x, gamma, beta and y at 3.35 TB/s)
FROZEN_FLOPS = {1: 695421665280.0, 8: 5563373322240.0}
FROZEN_NORM_ELEMENTS = 75_116_544
FROZEN_NORM_BOUND_S = 0.00035876558328358206
FROZEN_PARAMS = 347_188_495


@pytest.fixture(scope="module")
def spade():
    m = Manifest(REPO)
    c = m.config({"config": CONFIG})
    return c, m.reference(c)


def test_the_configuration_names_its_reference(spade):
    c, ref = spade
    assert c["reference"] == "spade_ncsnpp" and c["reduced"] == []
    assert ref.__file__ == str(REPO / "perfbench/reference/spade_ncsnpp.py")
    assert c["config"]["model"]["spade"] is True and c["config"]["model"]["spade_dim"] == 128
    # the concat configuration's settings but the SPADE ones
    flat = json.loads((REPO / "perfbench/configs/ncsnpp-city-f32.json").read_text())["config"]
    ours = copy.deepcopy(c["config"])
    ours["model"].pop("spade_dim")
    ours["model"]["spade"] = False
    assert ours == flat


def test_counts_are_frozen(spade):
    c, ref = spade
    cfg = c["config"]
    for batch, flops in FROZEN_FLOPS.items():
        assert ref.unet_flops(cfg, batch) == flops
    norms = ref.spade_norm_launches(cfg)
    assert len(norms) == 71 and sum(ch * h * w for ch, h, w in norms) == FROZEN_NORM_ELEMENTS
    assert norms[0] == (192, 128, 128) and norms[-1] == (192, 128, 128)
    assert ref.attention_launches(cfg) == FROZEN_LAUNCHES
    reader = Manifest(REPO).module("metrics", "spade_norm_roofline_pct")
    assert reader.bound_s(norms, 1, 4, 3.35e12) == FROZEN_NORM_BOUND_S


def tiny_spade_cfg(spade, size, mult, attn):
    cfg = copy.deepcopy(spade[0]["config"])
    cfg["data"].update(image_size=size, num_frames=1, num_frames_cond=2, channels=1)
    cfg["model"].update(ngf=4, ch_mult=mult, num_res_blocks=1, attn_resolutions=attn,
                        n_head_channels=4, spade_dim=8)
    return cfg


@pytest.mark.parametrize("size,mult,attn", [(8, [1, 2], [4]), (16, [1, 1, 2], [8, 4])])
def test_counts_equal_flop_counter_on_the_plain_net(spade, size, mult, attn):
    _, ref = spade
    cfg = tiny_spade_cfg(spade, size, mult, attn)
    model = UNetMoreDDPM(config_from_dict(cfg), device="cpu")
    g = torch.Generator().manual_seed(0)
    state = {k: torch.randn(v.shape, generator=g) * 0.1 for k, v in model.state_dict().items()}
    b = 2
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.Net(cfg, state)(torch.randn(b, size, size, 1), torch.tensor([3, 7]),
                            torch.randn(b, size, size, 2))
    assert fc.get_total_flops() == ref.unet_flops(cfg, b)


def test_the_configuration_holds_its_published_parameters(spade):
    c, _ = spade
    assert c["params_millions"] == 347.2
    unet = UNetMoreDDPM(config_from_dict(c["config"]), device="meta")
    assert sum(p.numel() for p in unet.parameters()) == FROZEN_PARAMS
    check_params(unet, c["params_millions"])
    for stated in (347.13, 347.24):
        with pytest.raises(RunError, match="params_millions"):
            check_params(unet, stated)


@pytest.fixture
def tiny_spade_root(tmp_path):
    """A tiny root with the cell ``tiny-spade.gop``: the SPADE configuration
    at ``tiny-f32``'s sizes, through the reference ``spade_ncsnpp``."""
    root = copy_benchmark(tmp_path)
    add_tiny_cells(root)
    pb = root / "perfbench"
    tiny = json.loads((pb / "configs/tiny-f32.json").read_text())
    c = json.loads((pb / f"configs/{CONFIG}.json").read_text())
    c.update(name="tiny-spade")
    c["config"] = tiny["config"]
    c["config"]["model"].update(spade=True, spade_dim=128)
    model = UNetMoreDDPM(config_from_dict(c["config"]), device="meta")
    c["params_millions"] = round(sum(p.numel() for p in model.parameters()) / 1e6, 6)
    (pb / "configs/tiny-spade.json").write_text(json.dumps(c))
    (pb / "limits/tiny-spade.gop.json").write_text(
        (pb / "limits/spade-f32.gop-worst.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-spade", "source": "a test configuration",
                         "file": "perfbench/configs/tiny-spade.json", "reduced": [],
                         "why": "the CPU tests"})
    b["workloads"].append({"name": "tiny-spade.gop", "config": "tiny-spade",
                           "traffic": "tiny-gop", "chips": 1, "why": "the CPU tests"})
    for m in b["per_layer"]:
        m["workloads"].append("tiny-spade.gop")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def test_a_tiny_spade_cell_is_correct_through_its_reference(tiny_spade_root):
    run = Run("tiny-spade.gop", 2 ** 33 + 7, 0.01, False, "cpu", tiny_spade_root,
              time.perf_counter())
    assert run.reference.SETTINGS["spade"] is True
    run.setup()
    run.measure()
    run.decode_streams()
    run.free_program()
    correct, checks = judge(run.compare(), run.limits)
    assert correct is True and set(checks) == {"pred_rms", "lpips_gap", "recon_med", "gops_wrong"}
    assert checks["pred_rms"]["value"] < 1e-5


def _edit(root, name, **model):
    path = root / f"perfbench/configs/{name}.json"
    c = json.loads(path.read_text())
    c["config"]["model"].update(model)
    path.write_text(json.dumps(c))
    return c


@pytest.mark.parametrize("config,cell,reference,spade_on,message", [
    ("tiny-f32", "tiny.gop", "unet", True, r"model\.spade=True"),
    ("tiny-spade", "tiny-spade.gop", "spade_ncsnpp", False, r"model\.spade=False")])
def test_a_net_its_reference_does_not_implement_is_refused_before_set_up(
        tiny_spade_root, monkeypatch, config, cell, reference, spade_on, message):
    c = _edit(tiny_spade_root, config, spade=spade_on)
    assert c["reference"] == reference
    monkeypatch.setattr(Run, "setup", lambda self: pytest.fail("the run was set up"))
    with pytest.raises(RunError, match=message):
        run_cell(cell, 3, 0.01, False, device="cpu", root=tiny_spade_root)


def test_the_concat_configuration_refuses_the_spade_reference():
    manifest = Manifest(REPO)
    c = manifest.config({"config": "ncsnpp-city-f32"})
    with pytest.raises(RunError, match=r"model\.spade=False"):
        check_settings(c["config"], manifest.reference(dict(c, reference="spade_ncsnpp")))


def test_the_norm_roofline_reads_the_spade_kernels_alone(spade):
    c, ref = spade
    read = Manifest(REPO).module("metrics", "spade_norm_roofline_pct").read
    # two calls' launches of 0.5 ms each, and other kernels it must not read
    kernels = ([("void groupnorm_spade_fwd<float, 4, true, false>(Params)", 0.0, 500.0)] * 142
               + [("void groupnorm_fwd<float, 4, true, false>(Params)", 0.0, 900.0)] * 20
               + [("attention_fwd", 0.0, 50.0)])
    run = types.SimpleNamespace(reference=ref, config=c, batch=1, peaks=PEAKS["H100"],
                                profile={"kernels": kernels})
    assert read(run) == pytest.approx(100.0 * 2 * FROZEN_NORM_BOUND_S / (142 * 500e-6),
                                      rel=1e-12)
    # a program without the kernel (the parent of the change that added it)
    run.profile = {"kernels": kernels[142:]}
    assert read(run) is None
    # a configuration whose reference lists no modulated norms
    run.profile = {"kernels": kernels}
    run.reference = Manifest(REPO).reference(dict(c, reference="unet"))
    assert read(run) is None
    run.profile = None
    assert read(run) is None
