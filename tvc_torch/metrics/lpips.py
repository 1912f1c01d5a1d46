"""LPIPS perceptual distance (counterpart of ``tvc/metrics/lpips.py``).

The net-lin LPIPS over one of three trunks: torchvision's AlexNet
``features`` (five ReLU taps, VALID 3x3/2 max pooling; the sender's
decision runs on it), VGG16 or SqueezeNet 1.1 (``tvc_torch/metrics/
backbones.py``), and the learned linear heads. The public functions take
NHWC tensors, as the JAX package does. The numerics follow it: ImageNet
shift/scale, unit-normalising each tap with the eps outside the square root
(``x / (||x||_2 + 1e-10)``), heads clamped at zero, spatial mean.

The sender feeds [0, 1] frames straight in, without rescaling to [-1, 1]
(a reference quirk the JAX package keeps). Weights come from local ``.pth``
files only; without them the metric runs on seeded random weights and says
so (``calibrated=False``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.core.runtime import resolve_device, to_tensor
from tvc_torch.metrics.backbones import (
    SQUEEZE_TAPS,
    VGG_TAPS,
    SqueezeNetFeatures,
    VGG16Features,
)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_TAPS = (64, 192, 384, 256, 256)
# torchvision alexnet `features.{i}` index of each conv
_ALEX_CONV_IDS = (0, 3, 6, 8, 10)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet ``features``; NCHW in, the five ReLU taps out."""

    def __init__(self, device=None):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 11, stride=4, padding=2, device=device)
        self.conv1 = nn.Conv2d(64, 192, 5, padding=2, device=device)
        self.conv2 = nn.Conv2d(192, 384, 3, padding=1, device=device)
        self.conv3 = nn.Conv2d(384, 256, 3, padding=1, device=device)
        self.conv4 = nn.Conv2d(256, 256, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        x = F.relu(self.conv0(x))
        taps.append(x)
        x = F.relu(self.conv1(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv2(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = F.relu(self.conv3(x))
        taps.append(x)
        x = F.relu(self.conv4(x))
        taps.append(x)
        return taps


def _make_backbone(net_type: str, device):
    if net_type == "alex":
        return AlexNetFeatures(device=device), ALEX_TAPS
    if net_type == "vgg":
        return VGG16Features(device=device), VGG_TAPS
    if net_type == "squeeze":
        return SqueezeNetFeatures(device=device), SQUEEZE_TAPS
    raise ValueError(f"unknown LPIPS net: {net_type}")


class LPIPS(nn.Module):
    """net-lin LPIPS distance between two NHWC batches; returns (B,).
    ``net_type``: alex | vgg | squeeze."""

    def __init__(self, device=None, net_type: str = "alex"):
        super().__init__()
        self.net_type = net_type
        self.net, self.taps = _make_backbone(net_type, device)
        for k, c in enumerate(self.taps):
            self.register_parameter(f"lin{k}", nn.Parameter(torch.full((1, c, 1, 1), 0.1,
                                                                       device=device)))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device).view(1, 3, 1, 1),
                             persistent=False)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights as the JAX package draws them: LeCun-normal convs,
        zero biases, heads at 0.1."""
        with torch.no_grad():
            for conv in [m for m in self.net.modules() if isinstance(m, nn.Conv2d)]:
                fan_in = conv.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                conv.bias.zero_()
            for k in range(len(self.taps)):
                getattr(self, f"lin{k}").fill_(0.1)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        f0 = self.net((x0.permute(0, 3, 1, 2) - self.shift) / self.scale)
        f1 = self.net((x1.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = None
        for k, (a, b) in enumerate(zip(f0, f1)):
            a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
            d = F.conv2d((a - b) ** 2, torch.clamp(getattr(self, f"lin{k}"), min=0.0))
            d = d.mean(dim=(2, 3))
            total = d if total is None else total + d
        return total[:, 0]


class LPIPSMetric:
    """An LPIPS model on a device. ``calibrated`` is False on random weights."""

    def __init__(self, model: LPIPS, calibrated: bool):
        self.model = model.eval()
        self.calibrated = calibrated
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, a, b) -> torch.Tensor:
        """a, b: (B, H, W, 3) arrays or tensors; returns (B,) on the metric's device."""
        return self.model(to_tensor(a, self.device), to_tensor(b, self.device))

    @classmethod
    def create(cls, alex_pth: Optional[str] = None, lin_pth: Optional[str] = None,
               seed: int = 0, device="cuda", net_type: str = "alex") -> "LPIPSMetric":
        dev = resolve_device(device)
        model = LPIPS(device="cpu", net_type=net_type)
        model.init_weights(torch.Generator().manual_seed(seed))
        calibrated = False
        if alex_pth is not None or lin_pth is not None:
            calibrated = load_lpips_weights(model, alex_pth, lin_pth)
        return cls(model.to(dev), calibrated)


def load_lpips_weights(model: LPIPS, alex_pth: Optional[str],
                       lin_pth: Optional[str]) -> bool:
    """Load a torchvision backbone state dict (alexnet, vgg16 or
    squeezenet1_1, as ``model.net_type`` says; its ``features.*`` entries) and
    the LPIPS heads (``lin{k}.model.1.weight``) from local files into
    ``model``. Returns whether the metric is calibrated (both files given)."""
    with torch.no_grad():
        if alex_pth is not None:
            sd = torch.load(alex_pth, map_location="cpu", weights_only=True)
            if model.net_type == "alex":
                for i, cid in enumerate(_ALEX_CONV_IDS):
                    conv = getattr(model.net, f"conv{i}")
                    conv.weight.copy_(sd[f"features.{cid}.weight"])
                    conv.bias.copy_(sd[f"features.{cid}.bias"])
            else:
                model.net.load_state_dict({k: v for k, v in sd.items()
                                           if k.startswith("features.")}, strict=True)
        if lin_pth is not None:
            sd = torch.load(lin_pth, map_location="cpu", weights_only=True)
            for k in range(len(model.taps)):
                key = f"lin{k}.model.1.weight"
                if key not in sd:  # older layouts
                    key = f"lin{k}.weight"
                getattr(model, f"lin{k}").copy_(sd[key])
    return alex_pth is not None and lin_pth is not None


def lpips_video(metric: LPIPSMetric, video1, video2) -> List[float]:
    """Per-frame LPIPS of two (T, H, W, C) videos in [0, 1], fed in unscaled
    as the sender feeds its frames."""
    return [float(v) for v in metric(video1, video2).cpu().numpy()]
