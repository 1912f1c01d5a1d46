"""The port's SPADE NCSN++ against the benchmark's plain reference, on the CPU.

``perfbench/reference/spade_ncsnpp.py`` is written from the published net
(MCVD's ``SPADE_NCSNpp``) in plain PyTorch, independent of ``tvc_torch``; it
is loaded here by its path, as the benchmark loads it. At the tiny
configuration of ``tests/conftest.py`` with ``model.spade`` on and every
parameter drawn at random: one UNet call, and one DDPM update through
``FramePredictor`` against the reference sampler on the same draws. Then
``group_norm_act`` with ``gamma`` and ``beta`` on CPU tensors against the
composition the SPADE layers ran before the kernel, bit for bit, and the
SPADE launches a CUDA graph counts at each replay (a CPU stand-in for the
graph). Torch runs on one thread (the file is timed alone at a few seconds).
"""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from tvc_torch.core.config import config_from_dict
from tvc_torch.models.diffusion import spade
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.ops import groupnorm
from tvc_torch.pipeline.predictor import FramePredictor

REPO = Path(__file__).resolve().parents[1]
# float32 sums in other orders (the FIR resampling as one depthwise
# convolution against the port's own resampling, attention by plain
# products) carried through the net's layers: max |port - plain| over
# max |plain| (6.3e-7 here on a CPU); the 2-D concat net's card
# comparisons hold 1e-4 too
NET_REL_TOL = 1e-4
# the same differences through 5 DDPM steps and the denoise step, on frames
# in [0, 1] (7.7e-7 here)
FRAMES_TOL = 1e-5


def load_reference():
    path = REPO / "perfbench/reference/spade_ncsnpp.py"
    spec = importlib.util.spec_from_file_location("plain_spade_ncsnpp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_sampler():
    path = REPO / "perfbench/reference/ddpm.py"
    spec = importlib.util.spec_from_file_location("plain_ddpm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(config dict, port UNet, its state): the benchmark's SPADE
    configuration at ``tests/conftest.py``'s tiny sizes, every parameter
    N(0, 0.15^2)."""
    cfg = json.loads((REPO / "perfbench/configs/spade-city-f32.json").read_text())["config"]
    cfg = copy.deepcopy(cfg)
    cfg["data"].update(image_size=64, num_frames=3, num_frames_cond=2)
    cfg["model"].update(ngf=16, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[32],
                        n_head_channels=8, num_classes=20, spade_dim=16)
    cfg["sampling"]["subsample"] = 5
    model = UNetMoreDDPM(config_from_dict(cfg), device="cpu").eval()
    g = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.15)
    return cfg, model, dict(model.state_dict())


def test_spade_call_matches_the_plain_reference(tiny):
    cfg, model, state = tiny
    ref = load_reference()
    assert ref.SETTINGS["spade"] is True
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 64, 9, generator=g)
    cond = torch.rand(2, 64, 64, 6, generator=g) * 2 - 1
    labels = torch.tensor([3, 17])
    with torch.no_grad():
        got = model(x, labels, cond)
        want = ref.Net(cfg, state)(x, labels, cond)
    scale = want.abs().max().item()
    assert got.shape == want.shape and scale > 1e-2
    assert (got - want).abs().max().item() <= NET_REL_TOL * scale


def test_spade_update_matches_the_plain_sampler(tiny):
    cfg, model, state = tiny
    ref, ddpm = load_reference(), load_sampler()
    pred = FramePredictor(config_from_dict(cfg), model)
    cond = torch.rand(1, 64, 64, 6, generator=torch.Generator().manual_seed(2))
    seed = 123456789
    with torch.no_grad():
        got = pred.generate(cond, generator=torch.Generator().manual_seed(seed))
        want = ddpm.predict(cfg, ref.Net(cfg, state), cond, seed)
    assert got.shape == want.shape == (1, 3, 64, 64, 3)
    assert float(want.std()) > 1e-2
    assert (got - want).abs().max().item() <= FRAMES_TOL


def composition_before_the_kernel(norm, x, gamma, beta, scale, shift):
    """What ``GetActNormSPADE`` computed before it called ``group_norm_act``
    with gamma and beta: the param-free norm, the modulation, the time
    embedding's scale and shift as (N, C, 1, 1) halves, SiLU."""
    y = F.group_norm(x.float(), norm.num_groups, None, None, norm.eps).to(norm.dtype)
    y = y * (1 + gamma) + beta
    if scale is not None:
        y = y * (1 + scale[:, :, None, None]) + shift[:, :, None, None]
    return F.silu(y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("emb", [True, False], ids=["emb", "no_emb"])
def test_cpu_path_is_the_old_composition_bit_for_bit(dtype, emb):
    mod = spade.GetActNormSPADE(32, 6, 64 if emb else None, 8, dtype=dtype)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    x = (torch.randn(2, 32, 16, 16, generator=g) * 2 + 0.3).to(dtype)
    seg = torch.rand(2, 6, 32, 32, generator=g) * 2 - 1
    emb_in = torch.randn(2, 64, generator=g).to(dtype) if emb else None
    launches = groupnorm.spade_launches
    with torch.no_grad():
        got = mod(x, emb_in, seg)
        gamma, beta = mod.Norm_0.modulation(x, seg)
        scale = shift = None
        if emb:
            scale, shift = mod.Dense_0(F.silu(emb_in)).chunk(2, dim=1)
        want = composition_before_the_kernel(mod.Norm_0.param_free_norm, x, gamma, beta, scale,
                                             shift)
    assert got.dtype == want.dtype == dtype
    assert got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).equal(
        want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert groupnorm.spade_launches == launches  # the CPU path launches nothing


def test_gamma_and_beta_are_checked_as_the_card_checks_them():
    x = torch.randn(2, 64, 8, 8)
    with pytest.raises(ValueError, match="pairs"):
        groupnorm.group_norm_act(x, 32, 1e-6, gamma=x)
    with pytest.raises(ValueError, match="gamma must be"):
        groupnorm.group_norm_act(x, 32, 1e-6, gamma=x[:1], beta=x[:1])
    with pytest.raises(ValueError, match="no affine"):
        groupnorm.group_norm_act(x, 32, 1e-6, torch.ones(64), torch.zeros(64), gamma=x, beta=x)


def test_graph_replays_count_the_spade_launches(monkeypatch):
    """``GraphedEps`` adds a graph's captured SPADE launches at each replay,
    apart from the plain entry's (a capture counting 71 and 10)."""
    from tvc_torch.samplers import graph as graph_mod

    class Replayer:
        def __init__(self, fn, inputs, out):
            self.fn, self.inputs, self.out = fn, inputs, out

        def replay(self):
            self.out.copy_(self.fn(**self.inputs))

    def capture(fn, inputs):
        out = fn(**inputs)
        groupnorm.spade_captured += 71
        groupnorm.captured += 10
        return Replayer(fn, inputs, out), out, 0, 0

    monkeypatch.setattr(graph_mod, "capture", capture)
    g = graph_mod.GraphedEps(lambda x, labels, cond=None: x + labels.float()[:, None])
    x, labels = torch.zeros(2, 3), torch.tensor([1, 2])
    groupnorm.reset_launches()
    g(x, labels)  # the eager warm-up (on the CPU: no launch)
    for k in (1, 2, 3):
        g(x, labels)
        assert (groupnorm.spade_launches, groupnorm.launches) == (71 * k, 10 * k)
    (st,) = g.stats().values()
    assert st["spade_launches"] == 71 and st["groupnorm_launches"] == 10
    groupnorm.reset_launches()
    assert groupnorm.spade_launches == groupnorm.launches == 0
