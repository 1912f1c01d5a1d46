"""ELIC codec layers on NCHW tensors (counterpart of ``tvc/models/codec/layers.py``).

The compressai helpers (``conv``, ``deconv``, ``conv1x1``, ``conv3x3``) are
``nn.Conv2d`` / ``nn.ConvTranspose2d`` subclasses, so that parameter names
are the reference's state-dict keys with nothing in between (``g_a.0.weight``,
``g_a.1.conv1.weight``, ``g_a.8.conv_a.0.conv.0.weight``, ...). Weights keep
PyTorch's layouts: (O, I, kh, kw) for convolutions, (I, O, kh, kw) for the
transposed ones.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    """compressai ``conv``: k5 s2 p2 by default."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2,
                 device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=kernel_size // 2,
                         device=device)


class Deconv(nn.ConvTranspose2d):
    """compressai ``deconv``: transposed conv k5 s2, padding k//2, output_padding
    s-1, so the output is s times the input. The JAX package computes the same
    function by a sub-pixel decomposition; the weight is the same (I, O, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2,
                 device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=kernel_size // 2,
                         output_padding=stride - 1, device=device)


class Conv1x1(nn.Conv2d):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, device=None):
        super().__init__(in_ch, out_ch, 1, stride=stride, device=device)


class Conv3x3(nn.Conv2d):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, device=None):
        super().__init__(in_ch, out_ch, 3, stride=stride, padding=1, device=device)


class ResidualBottleneckBlock(nn.Module):
    """1x1 -> relu -> 3x3 -> relu -> 1x1, plus the input."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv1 = Conv1x1(ch, ch // 2, device=device)
        self.conv2 = Conv3x3(ch // 2, ch // 2, device=device)
        self.conv3 = Conv1x1(ch // 2, ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        return x + self.conv3(h)


class ResidualUnit(nn.Module):
    """The trunk unit of the attention block: relu(x + 1x1(relu(3x3(relu(1x1(x))))))."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(Conv1x1(ch, ch // 2, device=device), nn.ReLU(),
                                  Conv3x3(ch // 2, ch // 2, device=device), nn.ReLU(),
                                  Conv1x1(ch // 2, ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x + self.conv(x))


class AttentionBlock(nn.Module):
    """x + trunk(x) * sigmoid(gate(x)) (the Cheng2020 attention block)."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv_a = nn.Sequential(*[ResidualUnit(ch, device=device) for _ in range(3)])
        self.conv_b = nn.Sequential(*[ResidualUnit(ch, device=device) for _ in range(3)],
                                    Conv1x1(ch, ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_a(x) * torch.sigmoid(self.conv_b(x))


def checkerboard_mask(kh: int, kw: int) -> np.ndarray:
    """The context conv's mask: 1 at (0::2, 1::2) and (1::2, 0::2), the anchor
    neighbours of a non-anchor position."""
    m = np.zeros((kh, kw), np.float32)
    m[0::2, 1::2] = 1
    m[1::2, 0::2] = 1
    return m


class CheckboardMaskedConv(nn.Conv2d):
    """k5 conv whose weight is masked to the checkerboard at every call; the
    parameter is the raw weight, so a checkpoint loads as stored."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, device=None):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2, device=device)
        self.register_buffer("mask", torch.tensor(checkerboard_mask(kernel_size, kernel_size),
                                                  device=device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.mask, self.bias, padding=self.padding)


def lecun_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The JAX package's random init for every conv of ``module``: LeCun normal
    (truncated at two standard deviations; fan-in from the weight's last three
    axes, as flax counts it for both conv layouts), zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                m.bias.zero_()
    return module


class MaskedConv2d(nn.Conv2d):
    """PixelCNN mask-A / mask-B conv (compressai's ``MaskedConv2d``); the
    parameter is the raw weight, masked at every call. The mask is a constant
    made in the forward, not a buffer, so a module moved with ``to_empty``
    holds nothing uninitialized."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, mask_type: str = "A",
                 device=None):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2, device=device)
        if mask_type not in ("A", "B"):
            raise ValueError(f"mask_type must be A or B, got {mask_type!r}")
        k = kernel_size
        self.mask_np = np.ones((k, k), np.float32)
        self.mask_np[k // 2, k // 2 + (mask_type == "B"):] = 0
        self.mask_np[k // 2 + 1:, :] = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = torch.from_numpy(self.mask_np).to(self.weight.device, self.weight.dtype)
        return F.conv2d(x, self.weight * mask, self.bias, padding=self.padding)


class SubpelConv3x3(nn.Sequential):
    """3x3 conv to ``out_ch * r^2`` channels, then a pixel shuffle by ``r``
    (compressai's ``subpel_conv3x3``: ``0.weight``)."""

    def __init__(self, in_ch: int, out_ch: int, r: int = 1, device=None):
        super().__init__(nn.Conv2d(in_ch, out_ch * r ** 2, 3, padding=1, device=device),
                         nn.PixelShuffle(r))


class GDN(nn.Module):
    """Generalized divisive normalization: y = x / sqrt(beta + gamma-weighted
    x^2) (times, if ``inverse``), in float32. ``beta`` and ``gamma`` are
    stored through compressai's non-negative reparametrization (offset
    2^-18), so converted weights load as they are. The contraction follows
    the JAX package: ``norm_i = beta_i + sum_j gamma[j, i] x_j^2``."""

    def __init__(self, ch: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1, device=None):
        super().__init__()
        self.inverse = inverse
        self.offset = 2 ** -18
        self.beta_bound = (beta_min + self.offset ** 2) ** 0.5
        self.gamma_bound = self.offset
        self.beta = nn.Parameter(torch.sqrt(torch.ones(ch, device=device) + self.offset ** 2))
        self.gamma = nn.Parameter(torch.sqrt(gamma_init * torch.eye(ch, device=device)
                                             + self.offset ** 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        off2 = self.offset ** 2
        beta = torch.clamp_min(self.beta, self.beta_bound) ** 2 - off2
        gamma = torch.clamp_min(self.gamma, self.gamma_bound) ** 2 - off2
        norm = torch.einsum("bjhw,ji->bihw", x.float() ** 2, gamma) + beta[:, None, None]
        norm = torch.sqrt(norm)
        return (x * norm if self.inverse else x / norm).to(x.dtype)


class ResidualBlockWithStride(nn.Module):
    """conv3x3 (stride) -> leaky ReLU -> conv3x3 -> GDN, plus a strided 1x1 skip."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2, device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, out_ch, stride=stride, device=device)
        self.conv2 = Conv3x3(out_ch, out_ch, device=device)
        self.gdn = GDN(out_ch, device=device)
        self.skip = (Conv1x1(in_ch, out_ch, stride=stride, device=device)
                     if stride != 1 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.gdn(self.conv2(F.leaky_relu(self.conv1(x), 0.01)))
        return h + (x if self.skip is None else self.skip(x))


class ResidualBlockUpsample(nn.Module):
    """Sub-pixel upsample -> leaky ReLU -> conv3x3 -> inverse GDN, plus a
    sub-pixel skip."""

    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2, device=None):
        super().__init__()
        self.subpel_conv = SubpelConv3x3(in_ch, out_ch, upsample, device=device)
        self.conv = Conv3x3(out_ch, out_ch, device=device)
        self.igdn = GDN(out_ch, inverse=True, device=device)
        self.upsample = SubpelConv3x3(in_ch, out_ch, upsample, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.igdn(self.conv(F.leaky_relu(self.subpel_conv(x), 0.01)))
        return h + self.upsample(x)


class ResidualBlock(nn.Module):
    """Two conv3x3 with leaky ReLUs, plus the input (a 1x1 skip where the width changes)."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, out_ch, device=device)
        self.conv2 = Conv3x3(out_ch, out_ch, device=device)
        self.skip = Conv1x1(in_ch, out_ch, device=device) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv2(F.leaky_relu(self.conv1(x), 0.01)), 0.01)
        return h + (x if self.skip is None else self.skip(x))
