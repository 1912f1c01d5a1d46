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


def _not_ported(name: str):
    class NotPorted(nn.Module):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is a library-only layer of tvc/models/codec/layers.py that the ELIC "
                "codec does not use; it is not ported yet (ROADMAP.md)")

    NotPorted.__name__ = NotPorted.__qualname__ = name
    return NotPorted


GDN = _not_ported("GDN")
SubpelConv3x3 = _not_ported("SubpelConv3x3")
MaskedConv2d = _not_ported("MaskedConv2d")
ResidualBlockWithStride = _not_ported("ResidualBlockWithStride")
ResidualBlockUpsample = _not_ported("ResidualBlockUpsample")
ResidualBlock = _not_ported("ResidualBlock")
