"""The configurations' counts (their reference modules' ``unet_flops`` and
``attention_launches`` over ``perfbench/flops.py``'s arithmetic) against a
hand count, against ``FlopCounterMode``, and frozen."""

from __future__ import annotations

import copy
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO
from perfbench.flops import attention_bytes, attention_flops, unet_attention_bound_s
from perfbench.manifest import Manifest
from perfbench.reference.unet import PlainUNet, module_plan, unet_flops

# one call of the 262.1M concat NCSN++ at 128x128: its operations at B = 1 and
# B = 8, its attention launches (heads, tokens, head dim), and their least time
# in float32 (B = 1) and bf16 (B = 8) on an H100's peaks
FROZEN_FLOPS = {1: 345625362432.0, 8: 2765002899456.0}
FROZEN_LAUNCHES = ([(2, 1024, 192)] * 2 + [(3, 256, 192)] * 2 + [(4, 64, 192)] * 4
                   + [(3, 256, 192), (2, 1024, 192)])
FROZEN_BOUND_S = {(1, 4, 67e12): 7.981697910447761e-05, (8, 2, 989e12): 5.129193935390791e-05}


def tiny_cfg():
    cfg = json.loads((REPO / "perfbench/configs/ncsnpp-city-f32.json").read_text())["config"]
    cfg = copy.deepcopy(cfg)
    cfg["data"].update(image_size=8, num_frames=1, num_frames_cond=1, channels=1)
    cfg["model"].update(ngf=4, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[4],
                        n_head_channels=4)
    return cfg


def test_hand_count_at_a_tiny_config():
    # ngf 4, levels (8x8: 4 ch, 4x4: 8 ch), one res block a level, attention at 4x4
    # with two heads of 4; one frame predicted from one, one channel
    cfg = tiny_cfg()
    dense = 2 * 4 * 16 + 2 * 16 * 16

    def conv(ci, co, k, r):
        return 2 * ci * co * k * k * r * r

    def res(ci, co, r_out, resample=False, r_in=None):
        f = 2 * 16 * 2 * ci + 2 * 16 * 2 * co + conv(ci, co, 3, r_out) + conv(co, co, 3, r_out)
        if ci != co or resample:
            f += conv(ci, co, 1, r_out)
        if resample:
            f += 2 * 2 * 16 * ci * r_out * r_out
        return f

    def attn(c, t, heads):
        return 4 * 2 * t * c * c + 4 * heads * t * t * (c // heads)

    hand = (dense + conv(2, 4, 3, 8)
            + res(4, 4, 8) + res(4, 4, 4, resample=True)        # level 0 and the down block
            + res(4, 8, 4) + attn(8, 16, 2)                      # level 1 with attention
            + res(8, 8, 4) + attn(8, 16, 2) + res(8, 8, 4)       # the middle
            + res(16, 8, 4) + res(12, 8, 4) + attn(8, 16, 2)     # up, level 1 (skips 8, 4)
            + res(8, 8, 8, resample=True)                        # the up block
            + res(12, 4, 8) + res(8, 4, 8)                       # up, level 0 (skips 4, 4)
            + conv(4, 1, 3, 8))
    assert [p["kind"] for p in module_plan(cfg)].count("attn") == 3
    assert unet_flops(cfg, 1) == hand
    assert unet_flops(cfg, 3) == 3 * hand


def random_state(cfg):
    g = torch.Generator().manual_seed(0)
    from tvc_torch.core.config import config_from_dict
    from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM

    model = UNetMoreDDPM(config_from_dict(cfg), device="cpu")
    return {k: torch.randn(v.shape, generator=g) * 0.1 for k, v in model.state_dict().items()}


@pytest.mark.parametrize("size,mult,attn", [(8, [1, 2], [4]), (16, [1, 1, 2], [8, 4])])
def test_counts_equal_flop_counter_on_the_plain_modules(size, mult, attn):
    cfg = tiny_cfg()
    cfg["data"]["image_size"] = size
    cfg["model"].update(ch_mult=mult, attn_resolutions=attn)
    unet = PlainUNet(cfg, random_state(cfg))
    b = 2
    x = torch.randn(b, size, size, 1)
    cond = torch.randn(b, size, size, 1)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        unet(x, torch.tensor([3, 7]), cond)
    assert fc.get_total_flops() == unet_flops(cfg, b)


def test_attention_counts():
    assert attention_flops(8, 2, 1024, 192) == 4 * 8 * 2 * 1024 * 1024 * 192
    assert attention_bytes(1, 3, 256, 192, 2) == 4 * 3 * 256 * 192 * 2


@pytest.mark.parametrize("config", ["ncsnpp-city-f32", "ncsnpp-city-bf16"])
def test_counts_of_the_configurations_are_frozen(config):
    m = Manifest(REPO)
    c = m.config({"config": config})
    ref = m.reference(c)
    cfg = c["config"]
    for batch, flops in FROZEN_FLOPS.items():
        assert ref.unet_flops(cfg, batch) == flops
    launches = ref.attention_launches(cfg)
    assert launches == FROZEN_LAUNCHES
    for (batch, itemsize, peak), bound in FROZEN_BOUND_S.items():
        assert unet_attention_bound_s(launches, batch, itemsize, peak, 3.35e12) == bound
