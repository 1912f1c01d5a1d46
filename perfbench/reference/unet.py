"""Plain NCSN++ UNet: the reference net of the concat NCSN++ configurations.

Written from the architecture of MCVD's ``ncsnpp_more.py`` (the channel-
stacked conditional NCSN++ of Voleti et al., 2022) as plain ``torch``
operations on NCHW tensors in float32: convolutions, GroupNorm, SiLU, FIR
resampling as one depthwise ``upfirdn2d`` convolution, and attention as
``softmax(q k^T / sqrt(d)) v`` by matrix products. It reads the weights from
a state dict under the reference's keys (``unet.all_modules.{i}.*``) and
builds nothing of its own.

A reference module as ``perfbench/manifest.py`` states the contract:
``SETTINGS`` (the ``model`` keys it implements: the positional time
embedding, no cond-mask embedding, frames stacked on the channels), ``Net``,
``unet_flops`` and ``attention_launches``. The sampler is shared
(``perfbench/reference/ddpm.py``); its names stay importable from here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.flops import attention_flops, conv_flops
from perfbench.reference.ddpm import ddpm_constants, draws, predict, update_seed  # noqa: F401
from perfbench.reference.precision import Precision

SETTINGS = {"arch": "unetmore", "spade": False, "time_conditional": True,
            "embedding_type": "positional", "cond_emb": False}
SQRT2 = math.sqrt(2.0)
FIR = (1.0, 3.0, 3.0, 1.0)
FIR_TAPS = len(FIR) ** 2  # the 4x4 (outer product of a 4-tap) FIR kernel


def num_groups(ch: int) -> int:
    """min(ch // 4, 32), lowered until it divides ch."""
    g = max(min(ch // 4, 32), 1)
    while ch % g:
        g -= 1
    return g


def module_plan(cfg: dict) -> List[dict]:
    """The NCSN++ module list in the order of ``all_modules``."""
    m, d = cfg["model"], cfg["data"]
    nf, mult, nrb = m["ngf"], tuple(m["ch_mult"]), m["num_res_blocks"]
    res = [d["image_size"] // 2 ** i for i in range(len(mult))]
    attn = tuple(m["attn_resolutions"])
    plan = [{"kind": "dense", "in": nf, "out": 4 * nf}, {"kind": "dense", "in": 4 * nf, "out": 4 * nf},
            {"kind": "conv", "in": d["channels"] * (d["num_frames"] + d["num_frames_cond"]),
             "out": nf, "res": res[0]}]
    skips, ch = [nf], nf
    for lv in range(len(mult)):
        for _ in range(nrb):
            plan.append({"kind": "res", "in": ch, "out": nf * mult[lv], "res": res[lv]})
            ch = nf * mult[lv]
            if res[lv] in attn:
                plan.append({"kind": "attn", "ch": ch, "res": res[lv]})
            skips.append(ch)
        if lv != len(mult) - 1:
            plan.append({"kind": "res", "in": ch, "out": ch, "res": res[lv], "down": True})
            skips.append(ch)
    last = res[-1]
    plan += [{"kind": "res", "in": ch, "out": ch, "res": last},
             {"kind": "attn", "ch": ch, "res": last},
             {"kind": "res", "in": ch, "out": ch, "res": last}]
    for lv in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            plan.append({"kind": "res", "in": ch + skips.pop(), "out": nf * mult[lv],
                         "res": res[lv]})
            ch = nf * mult[lv]
        if res[lv] in attn:
            plan.append({"kind": "attn", "ch": ch, "res": res[lv]})
        if lv:
            plan.append({"kind": "res", "in": ch, "out": ch, "res": res[lv], "up": True})
    plan += [{"kind": "actnorm", "ch": ch},
             {"kind": "conv", "in": ch, "out": d["channels"] * d["num_frames"], "res": res[0]}]
    return plan


def attention_heads(ch: int, head_channels: int) -> int:
    return 1 if ch < head_channels else ch // head_channels


def fir_kernel(gain: float) -> torch.Tensor:
    k = torch.tensor(FIR, dtype=torch.float64)
    k2 = torch.outer(k, k)
    return (k2 / k2.sum() * gain).float()


def upfirdn2d(x: torch.Tensor, k: torch.Tensor, up: int, down: int, pad0: int, pad1: int):
    """Insert up - 1 zeros after each sample, pad, convolve with ``k`` per
    channel, keep every down-th sample."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    kern = torch.flip(k, (0, 1)).to(x.device).reshape(1, 1, *k.shape).expand(c, 1, *k.shape)
    return F.conv2d(x, kern, stride=down, groups=c)


def upsample(x):
    return upfirdn2d(x, fir_kernel(4.0), 2, 1, 2, 1)


def downsample(x):
    return upfirdn2d(x, fir_kernel(1.0), 1, 2, 1, 1)


def timestep_embedding(labels: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=labels.device)
                     * -(math.log(10000) / (half - 1)))
    arg = labels.float()[:, None] * freq[None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)


class PlainUNet:
    """``eps(x, labels, cond)`` of NCSN++ over the weights of ``state``."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], precision: str = "f32"):
        self.cfg = cfg
        self.plan = module_plan(cfg)
        self.state = state
        self.p = Precision(precision)

    def w(self, i: int, name: str) -> torch.Tensor:
        return self.state[f"unet.all_modules.{i}.{name}"].float()

    def conv(self, i, x, name="", pad=None):
        wt = self.w(i, name + "weight")
        pad = wt.shape[-1] // 2 if pad is None else pad
        return self.p.conv2d(x, wt, self.w(i, name + "bias"), padding=pad)

    def dense(self, i, x, name=""):
        return self.p.linear(x, self.w(i, name + "weight"), self.w(i, name + "bias"))

    def actnorm(self, i, prefix, x, temb):
        ch = x.shape[1]
        y = F.group_norm(x, num_groups(ch), eps=1e-5)
        scale, shift = self.dense(i, F.silu(temb), prefix + "Dense_0.").chunk(2, dim=1)
        return F.silu(y * (1 + scale[:, :, None, None]) + shift[:, :, None, None])

    def res(self, i, p, x, temb):
        h = self.actnorm(i, "actnorm0.", x, temb)
        if p.get("up"):
            h, x = upsample(h), upsample(x)
        elif p.get("down"):
            h, x = downsample(h), downsample(x)
        h = self.conv(i, h, "Conv_0.")
        h = self.actnorm(i, "actnorm1.", h, temb)
        h = self.conv(i, h, "Conv_1.")
        if f"unet.all_modules.{i}.Conv_2.weight" in self.state:
            x = self.conv(i, x, "Conv_2.")
        return (x + h) / SQRT2

    def attn(self, i, x):
        b, c, hh, ww = x.shape
        t = hh * ww
        heads = attention_heads(c, self.cfg["model"]["n_head_channels"])
        d = c // heads
        tok = F.group_norm(x, num_groups(c), self.w(i, "GroupNorm_0.weight"),
                           self.w(i, "GroupNorm_0.bias"), eps=1e-6).flatten(2).transpose(1, 2)

        def nin(k, y):
            return self.p.matmul(y, self.w(i, f"NIN_{k}.W")) + self.w(i, f"NIN_{k}.b")

        q, k, v = (nin(j, tok).view(b, t, heads, d).transpose(1, 2) for j in range(3))
        s = self.p.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        o = self.p.matmul(torch.softmax(s, dim=-1), v)
        o = nin(3, o.transpose(1, 2).reshape(b, t, c))
        return (x + o.transpose(1, 2).reshape(b, c, hh, ww)) / SQRT2

    def __call__(self, x: torch.Tensor, labels: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C*F), labels (B,), cond (B, H, W, C*F_cond) -> eps (B, H, W, C*F)."""
        m = self.cfg["model"]
        depth, nrb, attn_res = len(m["ch_mult"]), m["num_res_blocks"], m["attn_resolutions"]
        plan = self.plan
        h = torch.cat([x.float(), cond.float()], dim=-1).permute(0, 3, 1, 2)
        temb = self.dense(0, timestep_embedding(labels, m["ngf"]))
        temb = self.dense(1, F.silu(temb))
        hs, i = [self.conv(2, h)], 3
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
        h = F.silu(F.group_norm(h, num_groups(h.shape[1]), self.w(i, "Norm_0.weight"),
                                self.w(i, "Norm_0.bias"), eps=1e-5))
        h = self.conv(i + 1, h)
        if hs or i + 2 != len(plan):
            raise AssertionError("the plain UNet did not follow its module plan")
        return h.permute(0, 2, 3, 1)


Net = PlainUNet


def attention_launches(cfg: dict) -> List[Tuple[int, int, int]]:
    """(heads, tokens, head dim) of each attention call of one UNet call, in order."""
    hc = cfg["model"]["n_head_channels"]
    out = []
    for p in module_plan(cfg):
        if p["kind"] == "attn":
            heads = attention_heads(p["ch"], hc)
            out.append((heads, p["res"] ** 2, p["ch"] // heads))
    return out


def unet_flops(cfg: dict, batch: int = 1) -> float:
    """Operations of one UNet call at ``batch``, as ``PlainUNet`` computes
    them (``perfbench/flops.py`` says what is counted)."""
    nf = cfg["model"]["ngf"]
    hc = cfg["model"]["n_head_channels"]
    total = 2.0 * nf * 4 * nf + 2.0 * 4 * nf * 4 * nf       # the two time-embedding denses
    for p in module_plan(cfg):
        kind = p["kind"]
        if kind == "conv":
            total += conv_flops(p["in"], p["out"], 3, p["res"], p["res"])
        elif kind == "res":
            r_in = p["res"]
            r_out = r_in * 2 if p.get("up") else r_in // 2 if p.get("down") else r_in
            # the two adaptive norms' dense projections of the embedding
            total += 2.0 * 4 * nf * 2 * p["in"] + 2.0 * 4 * nf * 2 * p["out"]
            if p.get("up") or p.get("down"):
                # FIR on the block's input and on its skip, each per channel
                total += 2 * 2.0 * FIR_TAPS * p["in"] * r_out * r_out
            total += conv_flops(p["in"], p["out"], 3, r_out, r_out)
            total += conv_flops(p["out"], p["out"], 3, r_out, r_out)
            if p["in"] != p["out"] or p.get("up") or p.get("down"):
                total += conv_flops(p["in"], p["out"], 1, r_out, r_out)
        elif kind == "attn":
            t, c = p["res"] ** 2, p["ch"]
            heads = attention_heads(c, hc)
            total += 4 * 2.0 * t * c * c + attention_flops(1, heads, t, c // heads)
    return total * batch
