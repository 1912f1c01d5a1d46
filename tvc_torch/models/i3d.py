"""InceptionI3d video feature network (counterpart of ``tvc/models/i3d.py``).

The network of pytorch_i3d up to ``Logits``, in NCDHW, with the submodules
named after pytorch_i3d's state-dict keys (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_3b.b1b.bn.running_var``, ``logits.conv3d.bias``), so a pytorch_i3d
checkpoint loads with ``load_state_dict`` and no converter, with or without
the ``end_points.`` prefix some checkpoints carry.

The numerics follow the JAX package, not pytorch_i3d, where the two differ:

- TF-style SAME padding, asymmetric for stride 2 (the larger half after):
  total = max((ceil(n / s) - 1) * s + k - n, 0). Convolutions pad with zeros,
  max pools with -inf (pytorch_i3d pads its pools with 0; the two agree on the
  non-negative inputs every pool here gets after a ReLU);
- inference BatchNorm with eps 1e-3;
- a (2, 7, 7) VALID average pool, the 1x1x1 logits conv with bias, then the
  mean over the remaining time steps: (B, 400).

``convert_tf_name`` and ``tf_vars_to_state_dict`` are the JAX package's pure
numpy converters from TF I3D variables, copied.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Triple = Tuple[int, int, int]

# pytorch_i3d's Mixed blocks: (name, in channels, (b0, b1a, b1b, b2a, b2b, b3b) widths)
MIXED = [
    ("Mixed_3b", 192, (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", 256, (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", 480, (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", 512, (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", 512, (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", 512, (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", 528, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", 832, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", 832, (384, 192, 384, 48, 128, 128)),
]
_PREFIX = "end_points."


def same_pads(sizes: Sequence[int], kernel: Sequence[int], stride: Sequence[int]) -> List[int]:
    """``F.pad``'s argument (last dim first) for TF-style SAME padding."""
    pads: List[int] = []
    for n, k, s in reversed(list(zip(sizes, kernel, stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def max_pool_same(x: torch.Tensor, kernel: Triple, stride: Triple) -> torch.Tensor:
    """Max pool with SAME padding by -inf, as flax's ``nn.max_pool``."""
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


class Unit3D(nn.Module):
    """conv3d (bias only for the logits) + inference BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Triple = (1, 1, 1),
                 stride: Triple = (1, 1, 1), use_bn: bool = True, relu: bool = True,
                 use_bias: bool = False, device=None):
        super().__init__()
        self.kernel, self.stride, self.relu = kernel, stride, relu
        # stride 1 with odd kernels pads symmetrically: the conv's own padding
        self.pad_in_conv = all(s == 1 for s in stride) and all(k % 2 for k in kernel)
        self.conv3d = nn.Conv3d(in_ch, out_ch, kernel, stride,
                                padding=tuple(k // 2 for k in kernel) if self.pad_in_conv else 0,
                                bias=use_bias, device=device)
        self.bn = nn.BatchNorm3d(out_ch, eps=1e-3, device=device) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.pad_in_conv:
            x = F.pad(x, same_pads(x.shape[2:], self.kernel, self.stride))
        x = self.conv3d(x)
        if self.bn is not None:
            x = F.batch_norm(x, self.bn.running_mean, self.bn.running_var, self.bn.weight,
                             self.bn.bias, training=False, eps=self.bn.eps)
        return F.relu(x) if self.relu else x


class InceptionModule(nn.Module):
    """The four-branch inception block; the pool branch pads with -inf."""

    def __init__(self, in_ch: int, out: Sequence[int], device=None):
        super().__init__()
        self.b0 = Unit3D(in_ch, out[0], device=device)
        self.b1a = Unit3D(in_ch, out[1], device=device)
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3), device=device)
        self.b2a = Unit3D(in_ch, out[3], device=device)
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3), device=device)
        self.b3b = Unit3D(in_ch, out[5], device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


class InceptionI3d(nn.Module):
    """I3D up to ``Logits``. Input (B, 3, T, H, W) in [-1, 1], T >= 9 and
    H, W >= 193 (the (2, 7, 7) VALID pool); output (B, num_classes)."""

    def __init__(self, num_classes: int = 400, device=None):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), device=device)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, device=device)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), device=device)
        for name, in_ch, out in MIXED:
            setattr(self, name, InceptionModule(in_ch, out, device=device))
        self.logits = Unit3D(1024, num_classes, use_bn=False, relu=False, use_bias=True,
                             device=device)
        self._register_load_state_dict_pre_hook(_strip_end_points)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_2a_3x3
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))  # MaxPool3d_3a_3x3
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))  # MaxPool3d_4a_3x3
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))  # MaxPool3d_5a_2x2
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = self.logits(F.avg_pool3d(x, (2, 7, 7), stride=1))
        return x[:, :, :, 0, 0].mean(dim=2)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded random weights, every tensor drawn: He-normal convs (so the
        activations keep their scale through the 57 ReLU units), a small
        logits bias, and BatchNorm scale, shift, mean and positive variance."""
        init_conv_bn_(self, generator)


def init_conv_bn_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every conv and BatchNorm tensor of ``module`` from ``generator``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.modules.conv._ConvNd):
                std = math.sqrt(2.0 / m.weight[0].numel())
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=generator)
                m.bias.normal_(0.0, 0.1, generator=generator)
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)


def _strip_end_points(state_dict, prefix, *args) -> None:
    """Accept pytorch_i3d checkpoints saved with the ``end_points.`` prefix."""
    for key in [k for k in state_dict if k.startswith(prefix + _PREFIX)]:
        state_dict[prefix + key[len(prefix + _PREFIX):]] = state_dict.pop(key)


def convert_tf_name(name: str) -> str:
    """TF I3D variable name -> torch-style dotted key (with the Mixed_5b
    branch-2 special case of the reference's converter)."""
    mapping = {
        "conv_3d": "conv3d",
        "batch_norm": "bn",
        "w:0": "weight",
        "b:0": "bias",
        "moving_mean:0": "running_mean",
        "moving_variance:0": "running_var",
        "beta:0": "bias",
    }
    segs = name.split("/")
    out: List[str] = []
    i = 0
    while i < len(segs):
        seg = segs[i]
        if "Mixed" in seg:
            out.append(seg)
        elif "Conv" in seg and "Mixed" not in name:
            out.append(seg)
        elif "Branch" in seg:
            branch_i = int(seg.split("_")[-1])
            i += 1
            seg = segs[i]
            if "Mixed_5b" in name and branch_i == 2:
                out.append(f"b{branch_i}a" if "1x1" in seg else f"b{branch_i}b")
            elif "a" in seg:
                out.append("b0" if branch_i == 0 else f"b{branch_i}a")
            elif "b" in seg:
                out.append(f"b{branch_i}b")
            else:
                raise ValueError(seg)
        elif seg == "Logits":
            out.append("logits")
            i += 1
        elif seg in mapping:
            out.append(mapping[seg])
        else:
            raise ValueError(f"no match for {seg} in {name}")
        i += 1
    return ".".join(out)


def tf_vars_to_state_dict(tf_vars: dict) -> dict:
    """{tf_name: np.ndarray} -> torch-style state dict of numpy arrays (conv
    (O, I, T, H, W)). TF conv weights are (T, H, W, I, O); 5-D tensors whose
    leading dims are all 1 squeeze to 1-D."""
    sd = {}
    for name, arr in tf_vars.items():
        arr = np.asarray(arr)
        key = convert_tf_name(name)
        if arr.ndim == 5:
            if all(s == 1 for s in arr.shape[:-1]):
                arr = arr.reshape(arr.shape[-1])
            else:
                arr = arr.transpose(4, 3, 0, 1, 2)
        sd[key] = arr
    return sd
