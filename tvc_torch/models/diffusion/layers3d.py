"""3-D and pseudo-3-D layers (counterpart of ``tvc/models/diffusion/layers3d.py``).

The JAX package carries a video's activations as channel-major stacks in
NHWC, (B, H, W, C*N) with channel c of frame n at ``c*N + n``, and reshapes
them to volumes inside each layer. Here the activations are volumes in the
reference's layout, (B, C, N, H, W), which ``nn.Conv3d`` and a 5-D GroupNorm
take as they are; ``stacked_to_volume``/``volume_to_stacked`` convert at the
network's edges. Names follow the reference's state-dict keys
(``conv.weight`` of ``MyConv3d``, ``space_conv``/``time_conv`` of
``PseudoConv3d``, ``space_att``/``time_att``).

``TimeAttnBlock`` attends over the N frames of each pixel with torch
products: N is 5 or 7 tokens, and the JAX package runs it as a plain einsum
(no Pallas kernel stands behind it). The space half of ``AttnBlockpp3d`` is
the 2-D ``AttnBlockpp``, which launches the attention kernel on the card.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.models.diffusion.layers import NIN, AttnBlockpp, GroupNormRef, default_init_

_SQRT2 = math.sqrt(2.0)


def stacked_to_volume(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, H, W, C*N) channel-major frames -> the (B, C, N, H, W) volume."""
    b, h, w, cn = x.shape
    return x.reshape(b, h, w, cn // n_frames, n_frames).permute(0, 3, 4, 1, 2)


def volume_to_stacked(v: torch.Tensor) -> torch.Tensor:
    """(B, C, N, H, W) -> (B, H, W, C*N) channel-major frames."""
    b, c, n, h, w = v.shape
    return v.permute(0, 3, 4, 1, 2).reshape(b, h, w, c * n)


class _Conv(nn.Module):
    """Shared init and compute-dtype handling of the 3-D convs."""

    def init_weights(self, generator=None):
        for w in self.scaled_weights():
            default_init_(w, self.init_scale, generator)
        with torch.no_grad():
            for m in self.children():
                m.bias.zero_()

    def scaled_weights(self):
        return [m.weight for m in self.children()]


class Conv3dDDPM(_Conv):
    """k x k x k 'same' conv over the (N, H, W) volume (``ddpm_conv3x3_3d``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, init_scale: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel_size, padding=kernel_size // 2,
                              device=device)
        self.init_scale = init_scale
        self.dtype = dtype

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv3d(v.to(dt), self.conv.weight.to(dt), self.conv.bias.to(dt),
                        padding=self.conv.padding)


class PseudoConv3d(_Conv):
    """A 2-D conv per frame, SiLU, then a 1-D conv over the frames per pixel
    (``ddpm_conv3x3_pseudo3d``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, init_scale: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.space_conv = nn.Conv2d(in_ch, out_ch, kernel_size, padding=kernel_size // 2,
                                    device=device)
        self.time_conv = nn.Conv1d(out_ch, out_ch, kernel_size, padding=kernel_size // 2,
                                   device=device)
        self.init_scale = init_scale
        self.dtype = dtype

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        # both convs as 3-D convs on the volume, views of the 2-D and 1-D
        # weights: a 1 x k x k conv per frame, then a k x 1 x 1 conv over the
        # frames of each pixel. Folding the frames into a 2-D conv's batch
        # (b = 7) makes cuDNN's heuristic pick an FFT algorithm with a
        # workspace of tens of GB that fails a CUDA graph's capture
        # (python -m tvc_torch.tools.pseudo3d_convs).
        dt = self.dtype
        s, t = self.space_conv, self.time_conv
        p = s.padding[0]
        y = F.conv3d(v.to(dt), s.weight.to(dt)[:, :, None], s.bias.to(dt), padding=(0, p, p))
        y = F.silu(y)
        return F.conv3d(y, t.weight.to(dt)[..., None, None], t.bias.to(dt), padding=(p, 0, 0))


class TimeAttnBlock(nn.Module):
    """Per-pixel attention over the frame axis (``AttnBlockpp1d``): GroupNorm
    statistics over (C / group, N) of each pixel, ``max(1, C //
    n_head_channels)`` heads, softmax in float32."""

    def __init__(self, channels: int, n_head_channels: int = -1, skip_rescale: bool = True,
                 init_scale: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        c = channels
        if n_head_channels == -1 or c < n_head_channels:
            self.heads = 1
        else:
            self.heads = max(1, c // n_head_channels)
        self.skip_rescale = skip_rescale
        self.dtype = dtype
        self.GroupNorm_0 = GroupNormRef(c, eps=1e-6, dtype=dtype, device=device)
        self.NIN_0 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_1 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_2 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_3 = NIN(c, c, init_scale=init_scale, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B', C, N), pixels folded into B'. Returns the same shape."""
        bp, c, n = x.shape
        heads = self.heads
        ch = c // heads
        tok = self.GroupNorm_0(x).transpose(1, 2)  # (B', N, C)

        def split(y):  # (B', N, C) -> (B', heads, N, ch)
            return y.reshape(bp, n, heads, ch).transpose(1, 2)

        q, k, v = split(self.NIN_0(tok)), split(self.NIN_1(tok)), split(self.NIN_2(tok))
        logits = torch.matmul(q, k.transpose(-1, -2)) * (ch ** -0.5)
        wts = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        out = torch.matmul(wts, v).transpose(1, 2).reshape(bp, n, c)
        out = self.NIN_3(out).transpose(1, 2)
        res = x + out
        return res / _SQRT2 if self.skip_rescale else res


class AttnBlockpp3d(nn.Module):
    """Factorized space-then-time attention: ``AttnBlockpp`` on every frame
    (frames folded into the batch), then ``TimeAttnBlock`` on every pixel,
    each with its own skip; no activation between (the reference passes
    ``act=None``)."""

    def __init__(self, channels: int, n_head_channels: int = -1, skip_rescale: bool = True,
                 init_scale: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.space_att = AttnBlockpp(channels, skip_rescale=skip_rescale,
                                     init_scale=init_scale, n_head_channels=n_head_channels,
                                     dtype=dtype, device=device)
        self.time_att = TimeAttnBlock(channels, n_head_channels=n_head_channels,
                                      skip_rescale=skip_rescale, init_scale=init_scale,
                                      dtype=dtype, device=device)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        b, c, n, h, w = v.shape
        s = self.space_att(v.transpose(1, 2).reshape(b * n, c, h, w))
        s = s.reshape(b, n, c, h, w)
        t = s.permute(0, 3, 4, 2, 1).reshape(b * h * w, c, n)
        t = self.time_att(t)
        return t.reshape(b, h, w, c, n).permute(0, 3, 4, 1, 2)


class FrameConverter1x1(nn.Module):
    """A 1x1 map over the frame axis, n_in -> n_out frames (the reference's
    ``conv1x1`` converters: weight (n_out, n_in, 1, 1))."""

    def __init__(self, n_frames_in: int, n_frames_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_frames_out, n_frames_in, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(n_frames_out, device=device))
        self.dtype = dtype
        self.init_weights()

    def init_weights(self, generator=None):
        default_init_(self.weight, 1.0, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.weight[:, :, 0, 0].to(dt)
        out = torch.einsum("bcnhw,mn->bcmhw", v.to(dt), w)
        return out + self.bias.to(dt)[:, None, None]
