"""Transforms between [0, 1] pixel space and model space
(counterpart of ``tvc/pipeline/transforms.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from tvc_torch.core.config import Config


def logit_transform(image: torch.Tensor, lam: float = 1e-6) -> torch.Tensor:
    image = lam + (1 - 2 * lam) * image
    return torch.log(image) - torch.log1p(-image)


def data_transform(cfg: Config, x: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if cfg.data.uniform_dequantization or cfg.data.gaussian_dequantization:
        if generator is None:
            raise ValueError("dequantization needs a generator")
        z_dev = generator.device
        if cfg.data.uniform_dequantization:
            u = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=z_dev)
            x = x / 256.0 * 255.0 + u.to(x.device) / 256.0
        if cfg.data.gaussian_dequantization:
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=z_dev)
            x = x + z.to(x.device) * 0.01
    if cfg.data.rescaled:
        x = 2.0 * x - 1.0
    elif cfg.data.logit_transform:
        x = logit_transform(x)
    return x


def inverse_data_transform(cfg: Config, x: torch.Tensor) -> torch.Tensor:
    if cfg.data.logit_transform:
        x = torch.sigmoid(x)
    elif cfg.data.rescaled:
        x = (x + 1.0) / 2.0
    return torch.clamp(x, 0.0, 1.0)
