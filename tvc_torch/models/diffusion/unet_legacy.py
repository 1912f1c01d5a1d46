"""The legacy DDPM UNet, ``arch: unet`` (counterpart of
``tvc/models/diffusion/unet_legacy.py``; the reference's ``models/unet.py``).

Names follow the reference's state dict: flat ``downblocks`` /
``middleblocks`` / ``upblocks`` lists, residual blocks with ``normalize0``,
``conv0``, ``dense``, ``normalize1``, ``conv1`` and a ``nin`` skip, attention
blocks with ``normalize``, ``Q``, ``K``, ``V``, ``OUT``, ``temb_dense`` and
the output ``normalize`` and ``out``; ``tvc.utils.convert.convert_legacy_unet_state_dict``
reads this layout. NCHW inside; the public forward takes and returns NHWC.

``LegacyAttnBlock`` is one head whose dimension is the block's whole width
(up to 4 x ngf), which can exceed the attention kernel's largest head; the
JAX package computes it with plain einsums, and so does this one with torch
products.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.layers import get_timestep_embedding, num_groups_for
from tvc_torch.models.diffusion.ncsnpp import cond_noise, level

DEPTH_MULTS = {"deep": (1, 2, 2, 2), "deeper": (1, 2, 2, 4, 4), "deepest": (1, 2, 2, 2, 4, 4)}


class LegacyGroupNorm(nn.GroupNorm):
    """``Normalize``: 32 groups, eps 1e-6, statistics in float32; a width not
    divisible by 32 (tiny test nets) takes the NCSN++ group rule, as the JAX
    package's does."""

    def __init__(self, ch: int, device=None):
        super().__init__(32 if ch % 32 == 0 else num_groups_for(ch), ch, eps=1e-6,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class Nin(nn.Module):
    """The reference's ``Nin``: ``weights`` (out, in) and ``bias`` over the
    channel axis of an NCHW tensor."""

    def __init__(self, dim_in: int, dim_out: int, device=None):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(dim_out, dim_in, device=device))
        self.bias = nn.Parameter(torch.zeros(dim_out, device=device))
        with torch.no_grad():
            nn.init.kaiming_uniform_(self.weights, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.permute(0, 2, 3, 1), self.weights.t()) + self.bias
        return y.permute(0, 3, 1, 2)


def _conv3(in_ch: int, out_ch: int, stride: int = 1, device=None) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, device=device)


class LegacyResnetBlock(nn.Module):
    """Norm-SiLU-conv twice, the projected time embedding added raw between
    (the embedding already ends in SiLU), a ``nin`` skip where the width
    changes; the sum is not rescaled."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int] = None, device=None):
        super().__init__()
        self.normalize0 = LegacyGroupNorm(in_ch, device=device)
        self.conv0 = _conv3(in_ch, out_ch, device=device)
        if temb_dim is not None:
            self.dense = nn.Linear(temb_dim, out_ch, device=device)
        self.normalize1 = LegacyGroupNorm(out_ch, device=device)
        self.conv1 = _conv3(out_ch, out_ch, device=device)
        if in_ch != out_ch:
            self.nin = Nin(in_ch, out_ch, device=device)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv0(F.silu(self.normalize0(x)))
        if hasattr(self, "dense") and temb is not None:
            h = h + self.dense(temb)[:, :, None, None]
        h = self.conv1(F.silu(self.normalize1(h)))
        if hasattr(self, "nin"):
            x = self.nin(x)
        return x + h


class LegacyAttnBlock(nn.Module):
    """Single-head spatial self-attention, softmax(q k^T / sqrt(C)) v, by torch
    products; the sum is not rescaled."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.normalize = LegacyGroupNorm(ch, device=device)
        self.Q = Nin(ch, ch, device=device)
        self.K = Nin(ch, ch, device=device)
        self.V = Nin(ch, ch, device=device)
        self.OUT = Nin(ch, ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hx = self.normalize(x)
        q, k, v = (m(hx).flatten(2).transpose(1, 2) for m in (self.Q, self.K, self.V))
        wts = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * (c ** -0.5), dim=-1)
        out = torch.matmul(wts, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.OUT(out)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (the reference's ``Upsample`` with ``.conv``)."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv = _conv3(ch, ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class LegacyUNet(nn.Module):
    """The legacy UNet (models/unet.py:175-299); ``model.depth`` deep,
    deeper or deepest; attention at the second level and in the middle."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.model.ngf
        n_ch = cfg.data.channels
        num_frames = cfg.data.num_frames
        self.num_frames_cond = cfg.data.num_frames_cond + cfg.data.num_frames_future
        self.ch_mult = [ch * m for m in DEPTH_MULTS[cfg.model.depth]]
        temb_dim = ch * 4 if cfg.model.time_conditional else None
        if temb_dim is not None:
            self.temb_dense = nn.Sequential(nn.Linear(ch, temb_dim, device=device), nn.SiLU(),
                                            nn.Linear(temb_dim, temb_dim, device=device),
                                            nn.SiLU())
        down = [_conv3(n_ch * (num_frames + self.num_frames_cond), ch, device=device)]
        chans = [ch]
        cur = ch
        for i, ich in enumerate(self.ch_mult):
            for _ in range(2):
                down.append(LegacyResnetBlock(cur, ich, temb_dim, device=device))
                cur = ich
                if i == 1:
                    down.append(LegacyAttnBlock(cur, device=device))
                chans.append(cur)
            if i != len(self.ch_mult) - 1:
                down.append(_conv3(cur, cur, stride=2, device=device))
                chans.append(cur)
        self.downblocks = nn.ModuleList(down)
        self.middleblocks = nn.ModuleList([
            LegacyResnetBlock(cur, cur, temb_dim, device=device),
            LegacyAttnBlock(cur, device=device),
            LegacyResnetBlock(cur, cur, temb_dim, device=device)])
        up = []
        for i, ich in reversed(list(enumerate(self.ch_mult))):
            for _ in range(3):
                up.append(LegacyResnetBlock(cur + chans.pop(), ich, temb_dim, device=device))
                cur = ich
                if i == 1:
                    up.append(LegacyAttnBlock(cur, device=device))
            if i != 0:
                up.append(Upsample(cur, device=device))
        self.upblocks = nn.ModuleList(up)
        self.normalize = LegacyGroupNorm(cur, device=device)
        out_frames = num_frames + (self.num_frames_cond if cfg.model.output_all_frames else 0)
        self.out = _conv3(cur, n_ch * out_frames, device=device)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        temb = None
        if y is not None and cfg.model.time_conditional:
            temb = self.temb_dense(get_timestep_embedding(y, cfg.model.ngf))
        if cond is not None:
            x = torch.cat([x, cond], dim=-1)
        if not cfg.data.logit_transform and not cfg.data.rescaled:
            x = 2 * x - 1.0
        h = x.permute(0, 3, 1, 2)
        blocks = iter(self.downblocks)
        h = next(blocks)(h)
        hs = [h]
        for i in range(len(self.ch_mult)):
            for _ in range(2):
                h = next(blocks)(h, temb)
                if i == 1:
                    h = next(blocks)(h)
                hs.append(h)
            if i != len(self.ch_mult) - 1:
                h = next(blocks)(h)
                hs.append(h)
        mid = self.middleblocks
        h = mid[2](mid[1](mid[0](h, temb)), temb)
        blocks = iter(self.upblocks)
        for i in reversed(range(len(self.ch_mult))):
            for _ in range(3):
                h = next(blocks)(torch.cat([h, hs.pop()], dim=1), temb)
                if i == 1:
                    h = next(blocks)(h)
            if i != 0:
                h = next(blocks)(h)
        if hs:
            raise AssertionError("legacy UNet forward left skips unused")
        out = self.out(F.silu(self.normalize(h))).permute(0, 2, 3, 1)
        if cfg.model.output_all_frames and cond is not None:
            out = out[..., self.num_frames_cond * cfg.data.channels:]
        return out


class UNetSMLD(nn.Module):
    """Sigma-conditioned wrapper (models/unet.py:301-320): with
    ``noise_in_cond``, ``cond + sigma_y z``."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        from tvc_torch.samplers.schedules import get_sigmas

        self.cfg = cfg
        self.unet = LegacyUNet(cfg, device=device)
        self.sigmas = np.asarray(get_sigmas(cfg), np.float32)

    def forward(self, x, y, cond=None, noise=None):
        if self.cfg.model.noise_in_cond and cond is not None:
            cond = cond + level(self.sigmas, y, cond) * cond_noise(cond, noise)
        return self.unet(x, y, cond)


class UNetDDPM(nn.Module):
    """Alpha-conditioned wrapper (models/unet.py:323-371): with
    ``noise_in_cond``, ``sqrt(a_y) cond + sqrt(1 - a_y) z``."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        from tvc_torch.samplers.schedules import Schedule

        self.cfg = cfg
        self.unet = LegacyUNet(cfg, device=device)
        self.alphas = np.asarray(Schedule.from_config(cfg).alphas, np.float32)

    def forward(self, x, y, cond=None, cond_mask=None, noise=None):
        if self.cfg.model.noise_in_cond and cond is not None:
            used = level(self.alphas, y, cond)
            cond = torch.sqrt(used) * cond + torch.sqrt(1.0 - used) * cond_noise(cond, noise)
        return self.unet(x, y, cond)
