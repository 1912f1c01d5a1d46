"""Fused bias + leaky-ReLU x scale (counterpart of ``tvc/ops/fused_act.py``).

The reference's ``fused_bias_act`` CUDA extension computes
``leaky_relu(x + bias) * scale``; the JAX package writes it as one
elementwise expression, which XLA fuses. It is a plain torch expression here
too: no TPU kernel stands behind it. The bias broadcasts over the last
(channel) axis, as in the JAX package's NHWC layout.
"""

from __future__ import annotations

import torch


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5) -> torch.Tensor:
    """y = leaky_relu(x + bias) * scale, ``bias`` broadcast over the last axis."""
    y = x + bias.reshape((1,) * (x.dim() - 1) + (-1,))
    return torch.where(y >= 0, y, y * negative_slope) * scale


class FusedLeakyReLU:
    """Module-style shim holding the bias, as the JAX package's class does."""

    def __init__(self, bias: torch.Tensor, negative_slope: float = 0.2,
                 scale: float = 2 ** 0.5):
        self.bias = bias
        self.negative_slope = negative_slope
        self.scale = scale

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
