"""NCSNv2 refinement blocks (counterpart of ``tvc/models/diffusion/ncsnv2_blocks.py``;
reference ``models/better/layers.py:122-338``).

Chained residual pooling (CRP), residual conv units (RCU), multi-scale
fusion (MSF) and the RefineNet block, each with a label-conditional twin
that takes a normalizer (``normalization.get_normalization``). NCHW. Names
follow the reference's state dict, which ``tvc.utils.convert``'s
``convert_{crp,rcu,msf,refine}_state_dict`` read: ``convs.{i}``,
``{i+1}_{j+1}_conv`` and ``{i+1}_{j+1}_norm``, ``norms.{i}``,
``adapt_convs.{i}``, ``msf``, ``crp``, ``output_convs``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class NCSNConv3x3(nn.Conv2d):
    """``ncsn_conv3x3``: a 3x3 'same' conv with PyTorch's default init scaled
    by ``init_scale``."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True, init_scale: float = 1.0,
                 device=None):
        super().__init__(in_ch, out_ch, 3, padding=1, bias=bias, device=device)
        scale = 1e-10 if init_scale == 0 else init_scale
        with torch.no_grad():
            self.weight.mul_(scale)
            if self.bias is not None:
                self.bias.mul_(scale)


def _pool5(x: torch.Tensor, mode: str) -> torch.Tensor:
    """5x5 stride-1 pooling with padding 2; the average counts the padding (/25)."""
    if mode == "max":
        return F.max_pool2d(x, 5, stride=1, padding=2)
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


def interpolate_bilinear_align_corners(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with corners aligned (src = dst * (in - 1) / (out - 1))."""
    if tuple(x.shape[-2:]) == tuple(shape):
        return x
    return F.interpolate(x, size=tuple(shape), mode="bilinear", align_corners=True)


class CRPBlock(nn.Module):
    """Chained residual pooling: act, then ``n_stages`` of pool -> conv, each added."""

    def __init__(self, features: int, n_stages: int, act: Callable = F.relu,
                 maxpool: bool = True, device=None):
        super().__init__()
        self.convs = nn.ModuleList([NCSNConv3x3(features, features, bias=False, device=device)
                                    for _ in range(n_stages)])
        self.act, self.mode = act, "max" if maxpool else "avg"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(_pool5(path, self.mode))
            x = path + x
        return x


class CondCRPBlock(nn.Module):
    """Conditional CRP: a label-conditional norm before each average pool."""

    def __init__(self, features: int, n_stages: int, normalizer: Callable,
                 act: Callable = F.relu, device=None):
        super().__init__()
        self.norms = nn.ModuleList([normalizer(features, device=device) for _ in range(n_stages)])
        self.convs = nn.ModuleList([NCSNConv3x3(features, features, bias=False, device=device)
                                    for _ in range(n_stages)])
        self.act = act

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for norm, conv in zip(self.norms, self.convs):
            path = conv(_pool5(norm(path, y), "avg"))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units: ``n_blocks`` of (act -> conv) x ``n_stages`` plus the input."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable = F.relu,
                 device=None):
        super().__init__()
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"{i + 1}_{j + 1}_conv",
                                NCSNConv3x3(features, features, bias=False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class CondRCUBlock(nn.Module):
    """Conditional RCU: a label-conditional norm before each act."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, normalizer: Callable,
                 act: Callable = F.relu, device=None):
        super().__init__()
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"{i + 1}_{j + 1}_norm", normalizer(features, device=device))
                self.add_module(f"{i + 1}_{j + 1}_conv",
                                NCSNConv3x3(features, features, bias=False, device=device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: a conv per input, resized to ``shape``, summed."""

    def __init__(self, in_planes: Sequence[int], features: int, device=None):
        super().__init__()
        self.convs = nn.ModuleList([NCSNConv3x3(c, features, bias=True, device=device)
                                    for c in in_planes])

    def forward(self, xs: Sequence[torch.Tensor], shape: Tuple[int, int]) -> torch.Tensor:
        if len(xs) != len(self.convs):
            raise ValueError(f"MSFBlock takes {len(self.convs)} inputs, got {len(xs)}")
        total = None
        for conv, xi in zip(self.convs, xs):
            h = interpolate_bilinear_align_corners(conv(xi), shape)
            total = h if total is None else total + h
        return total


class CondMSFBlock(nn.Module):
    """Conditional MSF: norm, then conv, resize, sum."""

    def __init__(self, in_planes: Sequence[int], features: int, normalizer: Callable,
                 device=None):
        super().__init__()
        self.norms = nn.ModuleList([normalizer(c, device=device) for c in in_planes])
        self.convs = nn.ModuleList([NCSNConv3x3(c, features, bias=True, device=device)
                                    for c in in_planes])

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
                shape: Tuple[int, int]) -> torch.Tensor:
        if len(xs) != len(self.convs):
            raise ValueError(f"CondMSFBlock takes {len(self.convs)} inputs, got {len(xs)}")
        total = None
        for norm, conv, xi in zip(self.norms, self.convs, xs):
            h = interpolate_bilinear_align_corners(conv(norm(xi, y)), shape)
            total = h if total is None else total + h
        return total


class RefineBlock(nn.Module):
    """RefineNet block: an RCU adapter per input, MSF (more than one input),
    CRP, and an output RCU (3 units at the ``end``, else 1)."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True, device=None):
        super().__init__()
        self.n_inputs = len(in_planes)
        self.adapt_convs = nn.ModuleList([RCUBlock(c, 2, 2, act, device=device)
                                          for c in in_planes])
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act, device=device)
        if self.n_inputs > 1:
            self.msf = MSFBlock(in_planes, features, device=device)
        self.crp = CRPBlock(features, 2, act, maxpool=maxpool, device=device)

    def forward(self, xs: Sequence[torch.Tensor], output_shape: Tuple[int, int]) -> torch.Tensor:
        if len(xs) != self.n_inputs:
            raise ValueError(f"RefineBlock takes {self.n_inputs} inputs, got {len(xs)}")
        hs = [adapt(xi) for adapt, xi in zip(self.adapt_convs, xs)]
        h = self.msf(hs, output_shape) if self.n_inputs > 1 else hs[0]
        return self.output_convs(self.crp(h))


class CondRefineBlock(nn.Module):
    """Conditional RefineNet block."""

    def __init__(self, in_planes: Sequence[int], features: int, normalizer: Callable,
                 act: Callable = F.relu, start: bool = False, end: bool = False, device=None):
        super().__init__()
        self.n_inputs = len(in_planes)
        self.adapt_convs = nn.ModuleList([CondRCUBlock(c, 2, 2, normalizer, act, device=device)
                                          for c in in_planes])
        self.output_convs = CondRCUBlock(features, 3 if end else 1, 2, normalizer, act,
                                         device=device)
        if self.n_inputs > 1:
            self.msf = CondMSFBlock(in_planes, features, normalizer, device=device)
        self.crp = CondCRPBlock(features, 2, normalizer, act, device=device)

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
                output_shape: Tuple[int, int]) -> torch.Tensor:
        if len(xs) != self.n_inputs:
            raise ValueError(f"CondRefineBlock takes {self.n_inputs} inputs, got {len(xs)}")
        hs = [adapt(xi, y) for adapt, xi in zip(self.adapt_convs, xs)]
        h = self.msf(hs, y, output_shape) if self.n_inputs > 1 else hs[0]
        return self.output_convs(self.crp(h, y), y)
