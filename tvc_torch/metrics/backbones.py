"""VGG16 and SqueezeNet feature trunks for LPIPS (counterpart of
``tvc/metrics/backbones.py``).

Both are ``features`` Sequentials laid out as torchvision's ``vgg16`` and
``squeezenet1_1`` lay theirs out, so a torchvision state dict's ``features.*``
entries load with ``load_state_dict`` and no converter. NCHW in, the LPIPS
taps out (VGG: relu1_2 .. relu5_3; SqueezeNet: seven taps).

The numerics follow the JAX package where it differs from torchvision:
SqueezeNet's first conv pads SAME (flax's default; (0, 1) at stride 2 on an
even size), and its max pools are VALID with the floor, where torchvision
takes the ceiling.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

VGG_TAPS = (64, 128, 256, 512, 512)
SQUEEZE_TAPS = (64, 128, 256, 384, 384, 512, 512)

# torchvision vgg16 `features` indices of the convs, and of the ReLUs that end a stage
VGG_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_TAP_IDS = (3, 8, 15, 22, 29)
# torchvision squeezenet1_1 `features` indices of the Fire modules and their widths
SQUEEZE_FIRE = {3: (64, 16, 64, 64), 4: (128, 16, 64, 64), 6: (128, 32, 128, 128),
                7: (256, 32, 128, 128), 9: (256, 48, 192, 192), 10: (384, 48, 192, 192),
                11: (384, 64, 256, 256), 12: (512, 64, 256, 256)}
_SQUEEZE_TAP_IDS = (1, 4, 7, 9, 10, 11, 12)


class VGG16Features(nn.Module):
    """torchvision vgg16 ``features[:30]``; taps relu1_2 .. relu5_3."""

    def __init__(self, device=None):
        super().__init__()
        layers: List[nn.Module] = []
        in_ch = 3
        for stage, (ch, n) in enumerate([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]):
            if stage:
                layers.append(nn.MaxPool2d(2, 2))
            for _ in range(n):
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1, device=device), nn.ReLU()]
                in_ch = ch
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _VGG_TAP_IDS:
                taps.append(x)
        return taps


class Fire(nn.Module):
    def __init__(self, in_ch: int, squeeze_ch: int, e1: int, e3: int, device=None):
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze_ch, 1, device=device)
        self.expand1x1 = nn.Conv2d(squeeze_ch, e1, 1, device=device)
        self.expand3x3 = nn.Conv2d(squeeze_ch, e3, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class SqueezeNetFeatures(nn.Module):
    """torchvision squeezenet1_1 ``features``; seven LPIPS taps."""

    def __init__(self, device=None):
        super().__init__()
        layers: List[nn.Module] = [nn.Conv2d(3, 64, 3, stride=2, device=device), nn.ReLU()]
        for i in range(2, 13):
            if i in SQUEEZE_FIRE:
                layers.append(Fire(*SQUEEZE_FIRE[i], device=device))
            else:
                layers.append(nn.MaxPool2d(3, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        h, w = x.shape[2:]
        # SAME for a 3x3 kernel at stride 2: total (ceil(n/2) - 1) * 2 + 3 - n, larger half after
        ph, pw = max((-(-h // 2) - 1) * 2 + 3 - h, 0), max((-(-w // 2) - 1) * 2 + 3 - w, 0)
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _SQUEEZE_TAP_IDS:
                taps.append(x)
        return taps
