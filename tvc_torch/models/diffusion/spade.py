"""SPADE-conditioned NCSN++ (counterpart of ``tvc/models/diffusion/spade.py``).

The conditioning frames enter through spatially adaptive group norms in
every residual block instead of being joined to the input: ``MySPADE``
normalizes without an affine map and modulates by ``(1 + gamma)`` and
``beta`` that a small conv net computes from the conditioning frames,
resized (nearest, PyTorch's rule ``src = floor(dst * in / out)``) to each
feature map. Module order and names follow the reference ``SPADE_NCSNpp``,
so module ``i`` is ``all_modules.{i}`` and the SPADE net is
``Norm_0.mlp_shared.0`` / ``mlp_gamma`` / ``mlp_beta``. NCHW inside, in the
memory format ``ops/layout.activation_layout`` chooses at the entry, as the
concat NCSN++ (``ncsnpp.py``); the public forward takes and returns NHWC, as
the JAX package's does.

Each of the 71 modulated norms of a call (two a residual block and the final
``actnorm``; the attention blocks keep their affine GroupNorm) is one call of
``ops/groupnorm.group_norm_act`` with ``gamma`` and ``beta``: the norm, the
modulation, the time embedding's scale and shift and SiLU in one launch of
the GroupNorm kernel's SPADE entry on the card, the plain composition on the
CPU. The conditioning frames enter the SPADE branch in the activations'
layout (on the CPU contiguous, as before), so that its convolutions write
gamma and beta in the layout the kernel reads them in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.layers import (AttnBlockpp, DDPMConv, Dense, GroupNormRef,
                                               get_timestep_embedding)
from tvc_torch.ops.groupnorm import group_norm_act
from tvc_torch.ops.layout import activation_layout
from tvc_torch.ops.resample import NCHW, downsample_2d, upsample_2d

_SQRT2 = math.sqrt(2.0)


class MySPADE(nn.Module):
    """Affine-free GroupNorm (eps 1e-6) modulated by a conv net over the
    conditioning frames: ``norm(x) * (1 + gamma(seg)) + beta(seg)``."""

    def __init__(self, norm_nc: int, label_nc: int, spade_dim: int = 128,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.param_free_norm = GroupNormRef(norm_nc, eps=1e-6, affine=False, dtype=dtype,
                                            device=device)
        self.mlp_shared = nn.Sequential(DDPMConv(label_nc, spade_dim, 3, dtype=dtype,
                                                 device=device), nn.SiLU())
        self.mlp_gamma = DDPMConv(spade_dim, norm_nc, 3, dtype=dtype, device=device)
        self.mlp_beta = DDPMConv(spade_dim, norm_nc, 3, dtype=dtype, device=device)

    def modulation(self, x: torch.Tensor, segmap: torch.Tensor):
        """(gamma, beta) of x's shape from the conditioning frames."""
        if segmap.shape[-2:] != x.shape[-2:]:
            segmap = F.interpolate(segmap, size=tuple(x.shape[-2:]), mode="nearest")
        actv = self.mlp_shared(segmap)
        return self.mlp_gamma(actv), self.mlp_beta(actv)

    def act(self, x: torch.Tensor, segmap: torch.Tensor, scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None, silu: bool = False) -> torch.Tensor:
        """The modulated norm, then ``* (1 + scale) + shift`` with (N, C)
        ``scale`` and ``shift``, then SiLU: one ``group_norm_act``."""
        gamma, beta = self.modulation(x, segmap)
        norm = self.param_free_norm
        return group_norm_act(x, norm.num_groups, norm.eps, None, None, scale, shift, silu,
                              norm.dtype, gamma=gamma, beta=beta)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        return self.act(x, segmap)


class GetActNormSPADE(nn.Module):
    """SPADE, then the time embedding's ``(1 + scale)`` and ``shift`` (with
    ``emb_dim``), then SiLU."""

    def __init__(self, ch: int, label_nc: int, emb_dim: Optional[int] = None,
                 spade_dim: int = 128, dtype=torch.float32, device=None):
        super().__init__()
        self.Norm_0 = MySPADE(ch, label_nc, spade_dim, dtype=dtype, device=device)
        if emb_dim is not None:
            self.Dense_0 = Dense(emb_dim, 2 * ch, dtype=dtype, device=device)
        self.has_emb = emb_dim is not None

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor],
                cond: torch.Tensor) -> torch.Tensor:
        scale = shift = None
        if self.has_emb:
            scale, shift = self.Dense_0(F.silu(emb)).chunk(2, dim=1)
        return self.Norm_0.act(x, cond, scale, shift, silu=True)


class ResnetBlockBigGANSPADE(nn.Module):
    """The BigGAN residual block with SPADE norms (layerspp.py:628-705)."""

    def __init__(self, in_ch: int, out_ch: Optional[int], label_nc: int,
                 temb_dim: Optional[int] = None, up: bool = False, down: bool = False,
                 spade_dim: int = 128, init_scale: float = 0.0, dtype=torch.float32,
                 device=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.fir_kernel = (1, 3, 3, 1)
        self.actnorm0 = GetActNormSPADE(in_ch, label_nc, temb_dim, spade_dim, dtype=dtype,
                                        device=device)
        self.Conv_0 = DDPMConv(in_ch, out_ch, 3, dtype=dtype, device=device)
        self.actnorm1 = GetActNormSPADE(out_ch, label_nc, temb_dim, spade_dim, dtype=dtype,
                                        device=device)
        self.Conv_1 = DDPMConv(out_ch, out_ch, 3, init_scale=init_scale, dtype=dtype,
                               device=device)
        self.Conv_2 = (DDPMConv(in_ch, out_ch, 1, dtype=dtype, device=device)
                       if in_ch != out_ch or up or down else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                cond: torch.Tensor) -> torch.Tensor:
        h = self.actnorm0(x, temb, cond)
        if self.up:
            h = upsample_2d(h, self.fir_kernel, factor=2, spatial_axes=NCHW)
            x = upsample_2d(x, self.fir_kernel, factor=2, spatial_axes=NCHW)
        elif self.down:
            h = downsample_2d(h, self.fir_kernel, factor=2, spatial_axes=NCHW)
            x = downsample_2d(x, self.fir_kernel, factor=2, spatial_axes=NCHW)
        h = self.Conv_0(h)
        h = self.actnorm1(h, temb, cond)
        h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return (x + h) / _SQRT2


class SPADENCSNpp(nn.Module):
    """The SPADE NCSN++ (ncsnpp_more.py:396-718). The module list follows the
    2-D NCSN++ plan with the positional time embedding (the JAX package's
    SPADE net reads neither the Fourier nor the cond-mask option); its input
    is the noisy frames alone."""

    def __init__(self, cfg: Config, dtype=torch.float32, device=None):
        super().__init__()
        from tvc_torch.models.diffusion.ncsnpp import NCSNppSpec, _build_plan

        self.spec = dataclasses.replace(NCSNppSpec.from_config(cfg), embedding_type="positional",
                                        cond_emb=False)
        self.dtype = dtype
        spec = self.spec
        self.plan = _build_plan(spec)
        first = next(i for i, p in enumerate(self.plan) if p["kind"] == "conv3")
        self.plan[first] = {**self.plan[first], "in": spec.channels * spec.num_frames}
        label_nc = spec.channels * spec.num_frames_cond
        temb_dim = 4 * spec.ngf if spec.time_conditional else None
        spade_dim = cfg.model.spade_dim
        mods = []
        for p in self.plan:
            kind = p["kind"]
            if kind == "dense":
                mods.append(Dense(p["in"], p["out"], dtype=dtype, device=device))
            elif kind == "conv3":
                mods.append(DDPMConv(p["in"], p["out"], 3, init_scale=p.get("init_scale", 1.0),
                                     dtype=dtype, device=device))
            elif kind == "res":
                mods.append(ResnetBlockBigGANSPADE(
                    p["in"], p["out"], label_nc, temb_dim, up=p.get("up", False),
                    down=p.get("down", False), spade_dim=spade_dim, dtype=dtype, device=device))
            elif kind == "attn":
                mods.append(AttnBlockpp(p["ch"], skip_rescale=True, init_scale=0.0,
                                        n_head_channels=spec.n_head_channels, dtype=dtype,
                                        device=device))
            elif kind == "actnorm":
                mods.append(GetActNormSPADE(p["ch"], label_nc, None, spade_dim, dtype=dtype,
                                            device=device))
            else:
                raise ValueError(kind)
        self.all_modules = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C*num_frames); cond: (B, H, W, C*num_frames_cond), the
        SPADE maps; time_cond: (B,) integer step labels."""
        if cond is None:
            raise ValueError("the SPADE NCSN++ needs the conditioning frames (cond)")
        spec, mods = self.spec, self.all_modules
        num_resolutions = len(spec.ch_mult)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        seg = cond.permute(0, 3, 1, 2)
        fmt = activation_layout(x.device.type, self.dtype)
        if fmt is None:
            seg = seg.contiguous()
        else:  # one activation layout through the call, the SPADE branch's included
            x, seg = x.contiguous(memory_format=fmt), seg.contiguous(memory_format=fmt)
        m_idx = 0
        temb = None
        if spec.time_conditional:
            temb = mods[0](get_timestep_embedding(time_cond, spec.ngf).to(self.dtype))
            temb = mods[1](F.silu(temb))
            m_idx = 2

        hs = [mods[m_idx](x)]
        m_idx += 1
        for i_level in range(num_resolutions):
            for _ in range(spec.num_res_blocks):
                h = mods[m_idx](hs[-1], temb, seg)
                m_idx += 1
                if h.shape[-1] in spec.attn_resolutions:
                    h = mods[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != num_resolutions - 1:
                hs.append(mods[m_idx](hs[-1], temb, seg))
                m_idx += 1

        h = mods[m_idx](hs[-1], temb, seg)
        h = mods[m_idx + 1](h)
        h = mods[m_idx + 2](h, temb, seg)
        m_idx += 3

        for i_level in reversed(range(num_resolutions)):
            for _ in range(spec.num_res_blocks + 1):
                h = mods[m_idx](torch.cat([h, hs.pop()], dim=1), temb, seg)
                m_idx += 1
            if h.shape[-1] in spec.attn_resolutions:
                h = mods[m_idx](h)
                m_idx += 1
            if i_level != 0:
                h = mods[m_idx](h, temb, seg)
                m_idx += 1

        h = mods[m_idx](h, None, seg)
        h = mods[m_idx + 1](h)
        m_idx += 2
        if hs or m_idx != len(mods):
            raise AssertionError("SPADE NCSN++ forward did not consume the module plan")
        return h.permute(0, 2, 3, 1)
