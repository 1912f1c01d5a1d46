"""InceptionV3 feature network, the FID backbone (counterpart of
``tvc/models/inception.py``).

torchvision's ``inception_v3`` trunk without the auxiliary head, NCHW, with
torchvision's module names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_7c.branch_pool.bn.running_var``), so a torchvision state dict loads
with ``load_inception_weights`` (which drops ``fc`` and ``AuxLogits``) and no
converter. 299 x 299 x 3 in [-1, 1] -> 2048-d pooled features.

The numerics follow the JAX package: inference BatchNorm with eps 1e-3, and
the padded 3x3 average pools count their padding (``count_include_pad``, as
flax's ``avg_pool`` does; pytorch-fid's variant does not).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.core.runtime import resolve_device, to_tensor
from tvc_torch.models.i3d import init_conv_bn_
from tvc_torch.ops.image_resize import resize


class BasicConv2d(nn.Module):
    """conv (no bias) + inference BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False, device=device)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.batch_norm(self.conv(x), self.bn.running_mean, self.bn.running_var,
                         self.bn.weight, self.bn.bias, training=False, eps=self.bn.eps)
        return F.relu(x)


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, device=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1, device=device)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1, device=device)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, device=device)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, device=device)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, device=device)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, device=device)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1, device=device)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int, device=None):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2, device=device)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1, device=device)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, device=device)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, device=device)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


def _row(in_ch, out_ch, device):  # 1x7
    return BasicConv2d(in_ch, out_ch, (1, 7), padding=(0, 3), device=device)


def _col(in_ch, out_ch, device):  # 7x1
    return BasicConv2d(in_ch, out_ch, (7, 1), padding=(3, 0), device=device)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int, device=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1, device=device)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1, device=device)
        self.branch7x7_2 = _row(c7, c7, device)
        self.branch7x7_3 = _col(c7, 192, device)
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1, device=device)
        self.branch7x7dbl_2 = _col(c7, c7, device)
        self.branch7x7dbl_3 = _row(c7, c7, device)
        self.branch7x7dbl_4 = _col(c7, c7, device)
        self.branch7x7dbl_5 = _row(c7, 192, device)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, device=device)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int, device=None):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1, device=device)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, device=device)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1, device=device)
        self.branch7x7x3_2 = _row(192, 192, device)
        self.branch7x7x3_3 = _col(192, 192, device)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, device=device)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, device=None):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1, device=device)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1, device=device)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1, device=device)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, device=device)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch_pool = BasicConv2d(in_ch, 192, 1, device=device)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionV3Features(nn.Module):
    """(B, 3, 299, 299) in [-1, 1] -> (B, 2048) pooled features (FID pool3)."""

    def __init__(self, device=None):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, device=device)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, device=device)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, device=device)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, device=device)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, device=device)
        self.Mixed_5b = InceptionA(192, 32, device=device)
        self.Mixed_5c = InceptionA(256, 64, device=device)
        self.Mixed_5d = InceptionA(288, 64, device=device)
        self.Mixed_6a = InceptionB(288, device=device)
        self.Mixed_6b = InceptionC(768, 128, device=device)
        self.Mixed_6c = InceptionC(768, 160, device=device)
        self.Mixed_6d = InceptionC(768, 160, device=device)
        self.Mixed_6e = InceptionC(768, 192, device=device)
        self.Mixed_7a = InceptionD(768, device=device)
        self.Mixed_7b = InceptionE(1280, device=device)
        self.Mixed_7c = InceptionE(2048, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded random weights, every conv and BatchNorm tensor drawn."""
        init_conv_bn_(self, generator)


def load_inception_weights(model: InceptionV3Features, sd: dict) -> None:
    """Load a torchvision ``inception_v3`` state dict into ``model``; its
    ``fc`` and ``AuxLogits`` entries are not part of the trunk."""
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith(("fc.", "AuxLogits."))}, strict=True)


class FIDInceptionFeatures:
    """InceptionV3 features of image batches on ``device`` (for ``fid_pr``).
    ``calibrated`` is False on seeded random weights."""

    def __init__(self, state_dict: Optional[dict] = None, batch_size: int = 32,
                 device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        model = InceptionV3Features(device="cpu")
        self.calibrated = state_dict is not None
        if self.calibrated:
            load_inception_weights(model, state_dict)
        else:
            model.init_weights(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size

    @torch.no_grad()
    def __call__(self, images: Sequence) -> np.ndarray:
        """(B, H, W, 3) in [0, 1] -> (B, 2048) float32 on the host; resized
        to 299 x 299 (``jax.image.resize``'s bilinear) and rescaled to [-1, 1]."""
        x = to_tensor(images, self.device).permute(0, 3, 1, 2)
        out = []
        for i in range(0, x.shape[0], self.batch_size):
            batch = x[i:i + self.batch_size]
            if batch.shape[2:] != (299, 299):
                batch = resize(batch, (299, 299))
            out.append(self.model((batch * 2.0 - 1.0).contiguous()).cpu().numpy())
        return np.concatenate(out, 0)
