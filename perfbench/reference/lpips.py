"""Plain LPIPS(alex): the reference of the accept decision's scores.

The net-lin LPIPS of Zhang et al. (CVPR 2018) over AlexNet's five ReLU taps:
ImageNet shift and scale, each tap unit-normalised over its channels
(``x / (||x|| + 1e-10)``), the squared difference weighted by the linear
heads clamped at zero, averaged over space and summed over taps. Frames go
in as they are given, in [0, 1] (the sender's convention). Weights come from
a state dict under the keys ``net.conv{0..4}.{weight,bias}`` and
``lin{0..4}``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# AlexNet features: (stride, padding, max-pool before the conv)
ALEX = ((4, 2, False), (1, 2, True), (1, 1, True), (1, 1, False), (1, 1, False))


def lpips(state: Dict[str, torch.Tensor], x0: torch.Tensor, x1: torch.Tensor,
          precision: str = "f32") -> torch.Tensor:
    """Distances (B,) between two (B, H, W, 3) batches."""
    p = Precision(precision)
    dev = x0.device
    shift = torch.tensor(SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=dev).view(1, 3, 1, 1)

    def taps(x):
        h = (x.float().permute(0, 3, 1, 2) - shift) / scale
        out = []
        for k, (stride, pad, pool) in enumerate(ALEX):
            if pool:
                h = F.max_pool2d(h, 3, 2)
            h = F.relu(p.conv2d(h, state[f"net.conv{k}.weight"].float(),
                                state[f"net.conv{k}.bias"].float(), stride=stride, padding=pad))
            out.append(h)
        return out

    total = 0.0
    for k, (a, b) in enumerate(zip(taps(x0), taps(x1))):
        a = a / (torch.sqrt((a * a).sum(1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt((b * b).sum(1, keepdim=True)) + 1e-10)
        w = torch.clamp(state[f"lin{k}"].float(), min=0.0).view(1, -1, 1, 1)
        total = total + ((a - b) ** 2 * w).sum(1).mean(dim=(1, 2))
    return total
