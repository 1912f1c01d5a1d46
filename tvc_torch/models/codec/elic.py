"""The ELIC learned image codec on NCHW tensors (counterpart of ``tvc/models/codec/elic.py``).

Analysis/synthesis transforms with residual-bottleneck groups and attention
blocks, a hyperprior, channel-conditional (cc) transforms over the uneven
groups (16, 16, 32, 64, 192), a checkerboard spatial context and a parameter
aggregation per slice. Submodules carry the reference's state-dict names
(``g_a``, ``g_s``, ``h_a``, ``h_s``, ``cc_transforms``, ``context_prediction``,
``ParamAggregation``, ``entropy_bottleneck``), so a reference checkpoint loads
with no converter (``tvc_torch.utils.convert.load_codec_checkpoint``).

The per-slice methods are what the host coder (``coding.py``) calls, one
phase at a time, between rANS calls. The training forward, the entropy
estimation path and the fused simulation compress are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tvc_torch.core.config import CodecConfig
from tvc_torch.core.runtime import resolve_device
from tvc_torch.entropy.factorized import FactorizedEntropy
from tvc_torch.models.codec.layers import (
    AttentionBlock,
    CheckboardMaskedConv,
    Conv,
    Conv1x1,
    Conv3x3,
    Deconv,
    ResidualBottleneckBlock,
    lecun_init_,
)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} (training, entropy estimation and the fused simulation compress) is not "
        "ported yet; the port codes keyframes through ELICCoder's exact path (ROADMAP.md)")


class ELICModel(nn.Module):
    """ELIC (the reference's ``TestModel``)."""

    def __init__(self, N: int = 192, M: int = 320,
                 groups: Tuple[int, ...] = (16, 16, 32, 64, 192), device=None):
        super().__init__()
        if sum(groups) != M:
            raise ValueError(f"groups {groups} must sum to M={M}")
        self.N, self.M, self.groups = N, M, tuple(groups)

        def rbb():
            return ResidualBottleneckBlock(N, device=device)

        self.g_a = nn.Sequential(
            Conv(3, N, device=device), rbb(), rbb(), rbb(),
            Conv(N, N, device=device), rbb(), rbb(), rbb(), AttentionBlock(N, device=device),
            Conv(N, N, device=device), rbb(), rbb(), rbb(),
            Conv(N, M, device=device), AttentionBlock(M, device=device))
        self.g_s = nn.Sequential(
            AttentionBlock(M, device=device), Deconv(M, N, device=device), rbb(), rbb(), rbb(),
            Deconv(N, N, device=device), AttentionBlock(N, device=device), rbb(), rbb(), rbb(),
            Deconv(N, N, device=device), rbb(), rbb(), rbb(), Deconv(N, 3, device=device))
        self.h_a = nn.Sequential(Conv3x3(M, N, device=device), nn.ReLU(),
                                 Conv(N, N, device=device), nn.ReLU(), Conv(N, N, device=device))
        self.h_s = nn.Sequential(Deconv(N, N, device=device), nn.ReLU(),
                                 Deconv(N, N * 3 // 2, device=device), nn.ReLU(),
                                 Conv3x3(N * 3 // 2, 2 * M, device=device))
        g = self.groups
        # slice i >= 1 sees the first slice, and from slice 2 on also the previous one
        self.cc_transforms = nn.ModuleList([
            nn.Sequential(Conv(g[0] + (g[i - 1] if i > 1 else 0), 224, 5, 1, device=device),
                          nn.ReLU(), Conv(224, 128, 5, 1, device=device), nn.ReLU(),
                          Conv(128, 2 * g[i], 5, 1, device=device))
            for i in range(1, len(g))])
        self.context_prediction = nn.ModuleList([
            CheckboardMaskedConv(g[i], 2 * g[i], 5, device=device) for i in range(len(g))])
        # context (2 g_i) + support: hyper means/scales (2 M), and from slice 1
        # on the cc means/scales (2 g_i)
        self.ParamAggregation = nn.ModuleList([
            nn.Sequential(Conv1x1(2 * g[i] + 2 * M + (2 * g[i] if i else 0), 640, device=device),
                          nn.ReLU(), Conv1x1(640, 512, device=device), nn.ReLU(),
                          Conv1x1(512, 2 * g[i], device=device))
            for i in range(len(g))])
        self.entropy_bottleneck = FactorizedEntropy(N, device=device)

    @property
    def num_slices(self) -> int:
        return len(self.groups)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ELICModel":
        """Seeded random weights, drawn as the JAX package draws its init."""
        lecun_init_(self, generator)
        self.entropy_bottleneck.init_weights(generator)
        return self

    # ------------- transforms -------------

    def encode_transforms(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, 3, H, W) -> (y (B, M, H/16, W/16), z (B, N, H/64, W/64))."""
        y = self.g_a(x)
        return y, self.h_a(y)

    def hyper_params(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The hyper means and scales, each (B, M, H/16, W/16)."""
        return torch.chunk(self.h_s(z_hat), 2, dim=1)

    def cc_transform(self, slice_index: int, support: torch.Tensor) -> torch.Tensor:
        return self.cc_transforms[slice_index - 1](support)

    def context(self, slice_index: int, y_half: torch.Tensor) -> torch.Tensor:
        return self.context_prediction[slice_index](y_half)

    def aggregate(self, slice_index: int, ctx_and_support: torch.Tensor) -> torch.Tensor:
        return self.ParamAggregation[slice_index](ctx_and_support)

    def slice_support(self, slice_index: int, y_hat_first: Optional[torch.Tensor],
                      y_hat_prev: Optional[torch.Tensor], latent_means: torch.Tensor,
                      latent_scales: torch.Tensor) -> torch.Tensor:
        """The support of a slice: [cc means, cc scales,] hyper means, hyper scales."""
        if slice_index == 0:
            return torch.cat([latent_means, latent_scales], dim=1)
        sup = y_hat_first if slice_index == 1 else torch.cat([y_hat_first, y_hat_prev], dim=1)
        ch_mean, ch_scale = torch.chunk(self.cc_transform(slice_index, sup), 2, dim=1)
        return torch.cat([ch_mean, ch_scale, latent_means, latent_scales], dim=1)

    def anchor_params(self, slice_index: int,
                      support: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Phase 1: means and scales of the anchors, aggregated with zero context."""
        b, _, h, w = support.shape
        ctx = support.new_zeros((b, 2 * self.groups[slice_index], h, w))
        return torch.chunk(self.aggregate(slice_index, torch.cat([ctx, support], dim=1)), 2, dim=1)

    def nonanchor_params(self, slice_index: int, y_anchor_decoded: torch.Tensor,
                         support: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Phase 2: the masked-conv context of the decoded anchors."""
        ctx = self.context(slice_index, y_anchor_decoded)
        return torch.chunk(self.aggregate(slice_index, torch.cat([ctx, support], dim=1)), 2, dim=1)

    def synthesize(self, y_hat: torch.Tensor, clamp: bool = True) -> torch.Tensor:
        x = self.g_s(y_hat)
        return torch.clamp(x, 0.0, 1.0) if clamp else x

    # ------------- not ported -------------

    def forward(self, x, noisequant: bool = False, rng=None):
        _not_ported("ELICModel.__call__")

    def inference(self, x):
        _not_ported("ELICModel.inference")

    def compress_forward(self, x, return_recon: bool = False):
        _not_ported("ELICModel.compress_forward")


def make_elic(cfg: Optional[CodecConfig] = None, seed: int = 0, device="cuda") -> ELICModel:
    """An ELIC of ``cfg``'s widths with random weights drawn from ``seed`` on
    the host, so that every device gets the same weights from one seed."""
    cfg = cfg or CodecConfig()
    dev = resolve_device(device)
    if cfg.num_slices != len(cfg.groups):
        raise ValueError(f"codec.num_slices={cfg.num_slices} but {len(cfg.groups)} groups")
    model = ELICModel(cfg.N, cfg.M, tuple(cfg.groups), device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
