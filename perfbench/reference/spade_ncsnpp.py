"""Plain SPADE NCSN++: the reference net of the SPADE configurations.

MCVD's "SPATIN" predictor (Voleti et al., *MCVD: Masked Conditional Video
Diffusion*, NeurIPS 2022, arXiv:2205.09853; ``SPADE_NCSNpp`` in the
reference's ``models/better/ncsnpp_more.py``, its norm ``MySPADE`` in
``layerspp.py``), written as plain ``torch`` operations on NCHW tensors in
float32. The trunk is the NCSN++ of ``perfbench/reference/unet.py`` (its
module plan, FIR resampling, attention and time embedding are reused), with
two differences the paper states: the net's input is the noisy frames alone,
and the conditioning frames enter through every residual block's norms
instead. Each of those norms (two a residual block, and the final one) is

    SiLU( GN(x) * (1 + gamma(seg)) + beta(seg)  [* (1 + scale(t)) + shift(t)] )

with ``GN`` a GroupNorm without affine weights, ``seg`` the conditioning
frames resized to the feature map by nearest neighbour, ``gamma`` and
``beta`` 3x3 convolutions (``spade_dim`` -> C) over a shared 3x3
convolution with SiLU (frames' channels -> ``spade_dim``), and ``scale`` and
``shift`` the time embedding's dense projection (none in the final norm).
Like the published net it computes gamma and beta again in every call. It
reads the weights from a state dict under the reference's keys
(``unet.all_modules.{i}.actnorm0.Norm_0.mlp_gamma.weight``, ...) and builds
nothing of its own.

Where it departs from the published code, or fixes what that code leaves to
its defaults (as the benchmarked program does too):

- the norm's eps is 1e-6, and its group count is min(C // 4, 32) lowered
  until it divides C;
- the resize takes source pixel floor(dst * in / out) along each axis,
  PyTorch's rule for ``F.interpolate(mode="nearest")``, written here as an
  index gather;
- the shared convolution's activation is SiLU, the activation the SPADE net
  hands its norms;
- the time embedding is the positional one, and no cond-mask embedding is
  joined to it (``SETTINGS``);
- the conditioning frames are handed to the norms as the shared sampler
  (``perfbench/reference/ddpm.py``) rescales them, to [-1, 1].

A reference module as ``perfbench/manifest.py`` states the contract:
``SETTINGS``, ``Net``, ``unet_flops``, ``attention_launches``; besides,
``spade_norm_launches`` lists the modulated norms of a call, which the
benchmark's ``spade_norm_roofline_pct`` bounds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.flops import conv_flops
from perfbench.reference import unet as plain

SETTINGS = {"arch": "unetmore", "spade": True, "time_conditional": True,
            "embedding_type": "positional", "cond_emb": False, "spade_dim": 128}
EPS = 1e-6


def module_plan(cfg: dict) -> List[dict]:
    """The NCSN++ module list, its first convolution reading the noisy frames alone."""
    d = cfg["data"]
    plan = plain.module_plan(cfg)
    first = next(i for i, p in enumerate(plan) if p["kind"] == "conv")
    plan[first] = dict(plan[first], **{"in": d["channels"] * d["num_frames"]})
    return plan


def nearest(seg: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """seg (B, C, H, W) resized to (h, w): source pixel floor(dst * in / out)."""
    hh, ww = seg.shape[-2:]
    if (hh, ww) == (h, w):
        return seg
    iy = torch.arange(h, device=seg.device) * hh // h
    ix = torch.arange(w, device=seg.device) * ww // w
    return seg[:, :, iy][:, :, :, ix]


class PlainSPADEUNet(plain.PlainUNet):
    """``eps(x, labels, cond)`` of the SPADE NCSN++ over the weights of ``state``."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], precision: str = "f32"):
        super().__init__(cfg, state, precision)
        self.plan = module_plan(cfg)
        self.seg = None

    def spade(self, i, prefix, x, temb):
        """The modulated norm ``prefix`` of module ``i`` on x, over ``self.seg``."""
        y = F.group_norm(x, plain.num_groups(x.shape[1]), eps=EPS)
        s = nearest(self.seg, *x.shape[-2:])
        actv = F.silu(self.conv(i, s, prefix + "Norm_0.mlp_shared.0."))
        gamma = self.conv(i, actv, prefix + "Norm_0.mlp_gamma.")
        beta = self.conv(i, actv, prefix + "Norm_0.mlp_beta.")
        y = y * (1 + gamma) + beta
        if temb is not None:
            scale, shift = self.dense(i, F.silu(temb), prefix + "Dense_0.").chunk(2, dim=1)
            y = y * (1 + scale[:, :, None, None]) + shift[:, :, None, None]
        return F.silu(y)

    # the residual blocks of ``PlainUNet.res`` call their norms through this
    def actnorm(self, i, prefix, x, temb):
        return self.spade(i, prefix, x, temb)

    def __call__(self, x: torch.Tensor, labels: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C*F), labels (B,), cond (B, H, W, C*F_cond) -> eps (B, H, W, C*F)."""
        m = self.cfg["model"]
        depth, nrb, attn_res = len(m["ch_mult"]), m["num_res_blocks"], m["attn_resolutions"]
        plan = self.plan
        self.seg = cond.float().permute(0, 3, 1, 2)
        temb = self.dense(0, plain.timestep_embedding(labels, m["ngf"]))
        temb = self.dense(1, F.silu(temb))
        hs, i = [self.conv(2, x.float().permute(0, 3, 1, 2))], 3
        for lv in range(depth):
            for _ in range(nrb):
                h = self.res(i, plan[i], hs[-1], temb)
                i += 1
                if h.shape[-1] in attn_res:
                    h = self.attn(i, h)
                    i += 1
                hs.append(h)
            if lv != depth - 1:
                hs.append(self.res(i, plan[i], hs[-1], temb))
                i += 1
        h = self.res(i, plan[i], hs[-1], temb)
        h = self.attn(i + 1, h)
        h = self.res(i + 2, plan[i + 2], h, temb)
        i += 3
        for lv in reversed(range(depth)):
            for _ in range(nrb + 1):
                h = self.res(i, plan[i], torch.cat([h, hs.pop()], dim=1), temb)
                i += 1
            if h.shape[-1] in attn_res:
                h = self.attn(i, h)
                i += 1
            if lv:
                h = self.res(i, plan[i], h, temb)
                i += 1
        h = self.spade(i, "", h, None)
        h = self.conv(i + 1, h)
        self.seg = None
        if hs or i + 2 != len(plan):
            raise AssertionError("the plain SPADE UNet did not follow its module plan")
        return h.permute(0, 2, 3, 1)


Net = PlainSPADEUNet


def attention_launches(cfg: dict) -> List[Tuple[int, int, int]]:
    """(heads, tokens, head dim) of each attention call of one UNet call, in
    order: the concat net's, whose trunk this is."""
    return plain.attention_launches(cfg)


def spade_norm_launches(cfg: dict) -> List[Tuple[int, int, int]]:
    """(channels, height, width) of each modulated norm of one UNet call, in
    order: a residual block's two (the second after its resampling), then
    the final norm."""
    out = []
    for p in module_plan(cfg):
        if p["kind"] == "res":
            r_in = p["res"]
            r_out = r_in * 2 if p.get("up") else r_in // 2 if p.get("down") else r_in
            out += [(p["in"], r_in, r_in), (p["out"], r_out, r_out)]
        elif p["kind"] == "actnorm":
            r = cfg["data"]["image_size"]
            out.append((p["ch"], r, r))
    return out


def unet_flops(cfg: dict, batch: int = 1) -> float:
    """Operations of one UNet call at ``batch``, as ``PlainSPADEUNet``
    computes them (``perfbench/flops.py`` says what is counted): the trunk as
    the concat net counts it, its first convolution reading the noisy frames
    alone, and each modulated norm's three convolutions."""
    d, m = cfg["data"], cfg["model"]
    r0, label_nc, sd = d["image_size"], d["channels"] * d["num_frames_cond"], m["spade_dim"]
    trunk = plain.unet_flops(cfg, 1) - conv_flops(label_nc, m["ngf"], 3, r0, r0)
    branch = sum(conv_flops(label_nc, sd, 3, h, w) + 2 * conv_flops(sd, c, 3, h, w)
                 for c, h, w in spade_norm_launches(cfg))
    return (trunk + branch) * batch
