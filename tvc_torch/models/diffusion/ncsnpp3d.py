"""3-D and pseudo-3-D NCSN++ (counterpart of ``tvc/models/diffusion/ncsnpp3d.py``;
``model.arch = unetmore3d | unetmorepseudo3d``).

The conditioning frames join the noisy frames, and all n_frames ride the
conv's frame axis; widths scale with the frame count (nf = ngf * n_frames on
the way down, ngf * num_frames on the way up). A 1x1 frame converter brings
n_frames back to num_frames after the middle attention and on every skip.
Activations are (B, C, N, H, W) volumes between the network's edges, which
convert the public NHWC frame-major stacks (``frame_major_to_channel_major``
of the JAX package) to volumes and back. Module ``i`` is ``all_modules.{i}``
of the reference's is3d net.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.layers import Dense, GroupNormRef, get_timestep_embedding
from tvc_torch.models.diffusion.layers3d import (AttnBlockpp3d, Conv3dDDPM, FrameConverter1x1,
                                                 PseudoConv3d)
from tvc_torch.ops.resample import NCHW, downsample_2d, upsample_2d

_SQRT2 = math.sqrt(2.0)


def frame_major_to_volume(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, H, W, N*C) frame-major stacks -> the (B, C, N, H, W) volume."""
    b, h, w, nc = x.shape
    return x.reshape(b, h, w, n_frames, nc // n_frames).permute(0, 4, 3, 1, 2)


def volume_to_frame_major(v: torch.Tensor) -> torch.Tensor:
    """(B, C, N, H, W) -> (B, H, W, N*C) frame-major stacks."""
    b, c, n, h, w = v.shape
    return v.permute(0, 3, 4, 2, 1).reshape(b, h, w, n * c)


def frame_major_to_channel_major(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, H, W, N*C) frame-major -> (B, H, W, C*N) channel-major."""
    b, h, w, nc = x.shape
    return x.reshape(b, h, w, n_frames, nc // n_frames).transpose(3, 4).reshape(b, h, w, nc)


def channel_major_to_frame_major(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Inverse of ``frame_major_to_channel_major``."""
    b, h, w, cn = x.shape
    return x.reshape(b, h, w, cn // n_frames, n_frames).transpose(3, 4).reshape(b, h, w, cn)


class GetActNorm3D(nn.Module):
    """GroupNorm over the per-frame channels C = ch / N, its statistics over
    the whole (N, H, W) volume of each group; the time embedding's scale and
    shift broadcast over the frames; SiLU."""

    def __init__(self, ch: int, n_frames: int, emb_dim: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        c = ch // n_frames
        if emb_dim is not None:
            self.Dense_0 = Dense(emb_dim, 2 * c, dtype=dtype, device=device)
        self.Norm_0 = GroupNormRef(c, eps=1e-5, affine=emb_dim is None, dtype=dtype,
                                   device=device)
        self.has_emb = emb_dim is not None

    def forward(self, v: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale = shift = None
        if self.has_emb:
            scale, shift = self.Dense_0(F.silu(emb)).chunk(2, dim=1)
        return self.Norm_0.act(v, scale, shift, silu=True)


def _resample(v: torch.Tensor, op) -> torch.Tensor:
    """A 2-D FIR resampling of every frame of a (B, C, N, H, W) volume."""
    b, c, n, h, w = v.shape
    y = op(v.reshape(b, c * n, h, w), (1, 3, 3, 1), factor=2, spatial_axes=NCHW)
    return y.reshape(b, c, n, y.shape[-2], y.shape[-1])


class ResnetBlockBigGAN3D(nn.Module):
    """The BigGAN residual block on volumes, with 3-D or pseudo-3-D convs;
    the skip sum is always scaled by 1/sqrt(2)."""

    def __init__(self, in_ch: int, n_frames: int, out_ch: Optional[int] = None,
                 pseudo3d: bool = False, temb_dim: Optional[int] = None, up: bool = False,
                 down: bool = False, init_scale: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        conv = PseudoConv3d if pseudo3d else Conv3dDDPM
        cin, cout = in_ch // n_frames, out_ch // n_frames
        self.actnorm0 = GetActNorm3D(in_ch, n_frames, temb_dim, dtype=dtype, device=device)
        self.Conv_0 = conv(cin, cout, 3, dtype=dtype, device=device)
        self.actnorm1 = GetActNorm3D(out_ch, n_frames, temb_dim, dtype=dtype, device=device)
        self.Conv_1 = conv(cout, cout, 3, init_scale=init_scale, dtype=dtype, device=device)
        self.Conv_2 = (conv(cin, cout, 1, dtype=dtype, device=device)
                       if in_ch != out_ch or up or down else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.actnorm0(x, temb)
        if self.up:
            h, x = _resample(h, upsample_2d), _resample(x, upsample_2d)
        elif self.down:
            h, x = _resample(h, downsample_2d), _resample(x, downsample_2d)
        h = self.Conv_0(h)
        h = self.actnorm1(h, temb)
        h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return (x + h) / _SQRT2


def build_plan_3d(cfg: Config) -> List[dict]:
    """The ordered module list of the is3d archs (ncsnpp_more.py:130-250); the
    channel counts are totals over the frames, as the JAX package's
    converter lists them (``tvc/utils/convert.py`` ``_build_plan_3d``)."""
    num_frames = cfg.data.num_frames
    n_frames = num_frames + cfg.data.num_frames_cond + cfg.data.num_frames_future
    nf = cfg.model.ngf * n_frames
    numf = cfg.model.ngf * num_frames
    ch_mult = cfg.model.ch_mult
    num_res = len(ch_mult)
    all_res = [cfg.data.image_size // (2 ** i) for i in range(num_res)]

    plan: List[dict] = []
    if cfg.model.time_conditional:
        plan.append({"kind": "dense", "in": nf, "out": nf * 4})
        plan.append({"kind": "dense", "in": nf * 4, "out": nf * 4})
    plan.append({"kind": "conv3", "in": cfg.data.channels * n_frames, "out": nf,
                 "frames": n_frames})
    hs_c = [nf]
    in_ch = nf
    for i_level in range(num_res):
        for _ in range(cfg.model.num_res_blocks):
            out_ch = nf * ch_mult[i_level]
            plan.append({"kind": "res", "in": in_ch, "out": out_ch, "frames": n_frames})
            in_ch = out_ch
            if all_res[i_level] in cfg.model.attn_resolutions:
                plan.append({"kind": "attn", "ch": in_ch, "frames": n_frames})
            hs_c.append(in_ch)
        if i_level != num_res - 1:
            plan.append({"kind": "res", "in": in_ch, "out": in_ch, "down": True,
                         "frames": n_frames})
            hs_c.append(in_ch)

    plan.append({"kind": "res", "in": in_ch, "out": in_ch, "frames": n_frames})
    plan.append({"kind": "attn", "ch": in_ch, "frames": n_frames})
    plan.append({"kind": "converter", "in": n_frames, "out": num_frames})
    in_ch = in_ch // n_frames * num_frames
    plan.append({"kind": "res", "in": in_ch, "out": in_ch, "frames": num_frames})

    for i_level in reversed(range(num_res)):
        for _ in range(cfg.model.num_res_blocks + 1):
            out_ch = numf * ch_mult[i_level]
            plan.append({"kind": "converter", "in": n_frames, "out": num_frames})
            in_ch_old = hs_c.pop() // n_frames * num_frames
            plan.append({"kind": "res", "in": in_ch + in_ch_old, "out": out_ch,
                         "frames": num_frames})
            in_ch = out_ch
        if all_res[i_level] in cfg.model.attn_resolutions:
            plan.append({"kind": "attn", "ch": in_ch, "frames": num_frames})
        if i_level != 0:
            plan.append({"kind": "res", "in": in_ch, "out": in_ch, "up": True,
                         "frames": num_frames})

    if hs_c:
        raise AssertionError("unbalanced skip connections in the 3-D NCSN++ plan")
    plan.append({"kind": "actnorm", "ch": in_ch, "frames": num_frames})
    plan.append({"kind": "conv3", "in": in_ch, "out": cfg.data.channels * num_frames,
                 "frames": num_frames, "init_scale": 0.0})
    return plan


class NCSNpp3D(nn.Module):
    """The 3-D / pseudo-3-D NCSN++. x: (B, H, W, C*num_frames) and cond
    (B, H, W, C*num_frames_cond), frame-major; returns (B, H, W,
    C*num_frames), frame-major."""

    def __init__(self, cfg: Config, pseudo3d: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.pseudo3d = pseudo3d
        self.plan = build_plan_3d(cfg)
        self.num_frames = cfg.data.num_frames
        self.n_frames = self.num_frames + cfg.data.num_frames_cond + cfg.data.num_frames_future
        nf = cfg.model.ngf * self.n_frames
        temb_dim = 4 * nf if cfg.model.time_conditional else None
        conv = PseudoConv3d if pseudo3d else Conv3dDDPM
        mods = []
        for p in self.plan:
            kind = p["kind"]
            if kind == "dense":
                mods.append(Dense(p["in"], p["out"], dtype=dtype, device=device))
            elif kind == "conv3":
                fr = p["frames"]
                mods.append(conv(p["in"] // fr, p["out"] // fr, 3,
                                 init_scale=p.get("init_scale", 1.0), dtype=dtype,
                                 device=device))
            elif kind == "res":
                mods.append(ResnetBlockBigGAN3D(p["in"], p["frames"], p["out"], pseudo3d,
                                                temb_dim, up=p.get("up", False),
                                                down=p.get("down", False), dtype=dtype,
                                                device=device))
            elif kind == "attn":
                mods.append(AttnBlockpp3d(p["ch"] // p["frames"],
                                          n_head_channels=cfg.model.n_head_channels,
                                          dtype=dtype, device=device))
            elif kind == "converter":
                mods.append(FrameConverter1x1(p["in"], p["out"], dtype=dtype, device=device))
            elif kind == "actnorm":
                mods.append(GetActNorm3D(p["ch"], p["frames"], None, dtype=dtype,
                                         device=device))
            else:
                raise ValueError(kind)
        self.all_modules = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is None:
            raise ValueError("the 3-D NCSN++ is built for the conditioning frames (cond): its "
                             "widths scale with the frame count they bring")
        cfg, mods = self.cfg, self.all_modules
        num_res = len(cfg.model.ch_mult)
        all_res = [cfg.data.image_size // (2 ** i) for i in range(num_res)]
        nf = cfg.model.ngf * self.n_frames
        v = frame_major_to_volume(torch.cat([x, cond], dim=-1).to(self.dtype), self.n_frames)

        m_idx = 0
        temb = None
        if cfg.model.time_conditional:
            temb = mods[0](get_timestep_embedding(time_cond, nf).to(self.dtype))
            temb = mods[1](F.silu(temb))
            m_idx = 2

        hs = [mods[m_idx](v)]
        m_idx += 1
        for i_level in range(num_res):
            for _ in range(cfg.model.num_res_blocks):
                h = mods[m_idx](hs[-1], temb)
                m_idx += 1
                if all_res[i_level] in cfg.model.attn_resolutions:
                    h = mods[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != num_res - 1:
                hs.append(mods[m_idx](hs[-1], temb))
                m_idx += 1

        h = mods[m_idx](hs[-1], temb)
        h = mods[m_idx + 1](h)
        h = mods[m_idx + 2](h)  # frame converter: n_frames -> num_frames
        h = mods[m_idx + 3](h, temb)
        m_idx += 4

        for i_level in reversed(range(num_res)):
            for _ in range(cfg.model.num_res_blocks + 1):
                prev = mods[m_idx](hs.pop())  # skip converter
                h = mods[m_idx + 1](torch.cat([h, prev], dim=1), temb)
                m_idx += 2
            if all_res[i_level] in cfg.model.attn_resolutions:
                h = mods[m_idx](h)
                m_idx += 1
            if i_level != 0:
                h = mods[m_idx](h, temb)
                m_idx += 1

        h = mods[m_idx](h)
        h = mods[m_idx + 1](h)
        m_idx += 2
        if hs or m_idx != len(mods):
            raise AssertionError("3-D NCSN++ forward did not consume the module plan")
        return volume_to_frame_major(h)
