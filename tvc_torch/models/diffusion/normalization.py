"""The normalization zoo of the NCSN family (counterpart of
``tvc/models/diffusion/normalization.py``; reference
``models/better/normalization.py``).

Instance and variance norms, plain and conditioned on an integer
noise-level label, on NCHW tensors; ``get_normalization`` picks one by
``config.model.normalization``. Statistics are over (H, W) with the
population variance. Parameter names follow the reference
(``instance_norm.weight``, ``alpha``, ``gamma``, ``beta``, ``embed.weight``).
``ConditionalInstanceNorm2dPlus`` follows the JAX package, which adds the
normalized means without the label's ``alpha`` (its third of the embedding
is carried but unused).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _spatial_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _means_norm(x: torch.Tensor) -> torch.Tensor:
    """Each channel's mean, standardized across the channels: (B, C, 1, 1)."""
    means = x.mean(dim=(2, 3))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, unbiased=False, keepdim=True)
    return ((means - m) / torch.sqrt(v + 1e-5))[:, :, None, None]


def _normal_(p: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        p.normal_(1.0, 0.02, generator=generator)


class InstanceNorm2d(nn.Module):
    """Instance norm (eps 1e-5), optionally affine."""

    def __init__(self, num_features: int, affine: bool = True, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.instance_norm = nn.InstanceNorm2d(num_features, eps=eps, affine=affine,
                                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _spatial_norm(x, self.eps)
        if self.instance_norm.affine:
            h = h * self.instance_norm.weight[:, None, None] \
                + self.instance_norm.bias[:, None, None]
        return h


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++: the instance norm plus each channel's mean, standardized
    across the channels and scaled by ``alpha``, times ``gamma`` (+ ``beta``)."""

    def __init__(self, num_features: int, bias: bool = True, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features, device=device))
        self.gamma = nn.Parameter(torch.empty(num_features, device=device))
        if bias:
            self.beta = nn.Parameter(torch.zeros(num_features, device=device))
        self.init_weights()

    def init_weights(self, generator=None):
        _normal_(self.alpha, generator)
        _normal_(self.gamma, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _spatial_norm(x, 1e-5) + _means_norm(x) * self.alpha[:, None, None]
        out = self.gamma[:, None, None] * h
        if hasattr(self, "beta"):
            out = out + self.beta[:, None, None]
        return out


class VarianceNorm2d(nn.Module):
    """x / sqrt(var + 1e-5) over (H, W), times ``alpha``."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features, device=device))
        self.init_weights()

    def init_weights(self, generator=None):
        _normal_(self.alpha, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
        return x * torch.rsqrt(var + 1e-5) * self.alpha[:, None, None]


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Label-conditional InstanceNorm++: ``embed`` (classes, 3 x C) holds
    gamma, alpha and beta (2 x C, gamma and alpha, without ``bias``)."""

    def __init__(self, num_features: int, num_classes: int, bias: bool = True, device=None):
        super().__init__()
        self.num_features = num_features
        self.parts = 3 if bias else 2
        self.embed = nn.Embedding(num_classes, self.parts * num_features, device=device)
        self.init_weights()

    def init_weights(self, generator=None):
        nf = self.num_features
        with torch.no_grad():
            self.embed.weight.zero_()
            self.embed.weight[:, :nf * (self.parts - 1)].normal_(1.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = _spatial_norm(x, 1e-5) + _means_norm(x)
        e = self.embed(y.long())[:, :, None, None]
        if self.parts == 3:
            gamma, _, beta = e.chunk(3, dim=1)
            return gamma * h + beta
        gamma, _ = e.chunk(2, dim=1)
        return gamma * h


class ConditionalVarianceNorm2d(nn.Module):
    """x / sqrt(var + 1e-5) times the label's ``embed`` row."""

    def __init__(self, num_features: int, num_classes: int, device=None):
        super().__init__()
        self.embed = nn.Embedding(num_classes, num_features, device=device)
        self.init_weights()

    def init_weights(self, generator=None):
        _normal_(self.embed.weight, generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
        return self.embed(y.long())[:, :, None, None] * (x * torch.rsqrt(var + 1e-5))


def get_normalization(name: str, conditional: bool = False, num_classes: int = 1000):
    """A factory ``nf -> module`` chosen by name (normalization.py:22-40)."""
    if conditional:
        if name == "InstanceNorm++":
            return lambda nf, device=None: ConditionalInstanceNorm2dPlus(nf, num_classes,
                                                                         device=device)
        raise NotImplementedError(name)
    if name == "InstanceNorm":
        return lambda nf, device=None: InstanceNorm2d(nf, device=device)
    if name == "InstanceNorm++":
        return lambda nf, device=None: InstanceNorm2dPlus(nf, device=device)
    if name == "VarianceNorm":
        return lambda nf, device=None: VarianceNorm2d(nf, device=device)
    raise ValueError(f"Unknown normalization: {name}")
