"""NCSN++ layer library in PyTorch (counterpart of ``tvc/models/diffusion/layers.py``).

Modules take and return NCHW tensors; the UNet's public forward converts from
and to the JAX package's NHWC. Parameter names follow the reference PyTorch
state dict (``Conv_0.weight``, ``GroupNorm_0.weight``, ``NIN_0.W``,
``actnorm0.Dense_0.weight`` ...), so a reference checkpoint loads as it is.
Numerics follow the JAX package: GroupNorm eps 1e-6 in the attention block
and 1e-5 in ``GetActNorm``, statistics in f32, skip sums scaled by 1/sqrt(2).

Every module takes a compute ``dtype`` (float32 by default), as the Flax
modules do: a layer casts its input, weight and bias to it (Flax's
``promote_dtype``), so the stored weights may stay float32 masters or be
stored in the compute dtype, with the same bytes either way. GroupNorm takes
its statistics in float32 and returns the compute dtype; its scale and shift
are rounded to the compute dtype first (Flax keeps float32 masters there at
float32), which is what makes bf16-stored weights and float32 masters give the
same bytes. ``TVC_GN_BF16_IO=1`` keeps GroupNorm's input and output in a
non-float32 compute dtype (``gn_bf16_io``).

Construction leaves PyTorch's default initialisation (``NIN``, which has
none, draws the DDPM init from the global generator); ``init_params``
re-initialises every module with the DDPM ``default_init`` from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.ops.attention import attention
from tvc_torch.ops.resample import NCHW, downsample_2d, upsample_2d

_SQRT2 = math.sqrt(2.0)


def default_init_(w: torch.Tensor, scale: float = 1.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDPM default initializer, in place: variance scaling, fan_avg, uniform."""
    scale = 1e-10 if scale == 0 else scale
    if w.dim() == 4:  # OIHW
        receptive = w.shape[2] * w.shape[3]
        fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    elif w.dim() == 2:
        fan_in, fan_out = w.shape[1], w.shape[0]
    else:
        fan_in = fan_out = w.numel()
    variance = scale / ((fan_in + fan_out) / 2)
    with torch.no_grad():
        return w.uniform_(-1.0, 1.0, generator=generator).mul_(math.sqrt(3 * variance))


def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialise every parameter of ``module`` the way the JAX package does,
    drawing from ``generator``."""
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
    return module


def redraw_zero_scaled_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw the layers that the DDPM init scales to ~0 (each attention
    block's output NIN and the final conv) at unit scale, drawn on the host
    from ``generator``, so that a run on random weights carries signal
    through the attention and the output."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (NIN, DDPMConv)) and m.init_scale == 0.0:
                w = m.W if isinstance(m, NIN) else m.weight
                w.copy_(default_init_(torch.empty(w.shape), 1.0, generator))
    return module


def num_groups_for(ch: int) -> int:
    """Reference group-count rule: min(ch // 4, 32), lowered until it divides ch."""
    ng = max(min(ch // 4, 32), 1)
    while ch % ng != 0:
        ng -= 1
    return ng


def gn_bf16_io() -> bool:
    """``TVC_GN_BF16_IO=1``: GroupNorm of a non-float32 compute dtype reads and
    writes that dtype and takes only its statistics in float32 (the JAX
    package's ``_gn_bf16_io``); off by default. Read at each call, as the JAX
    package reads it at each trace, and stamped into a GOP payload."""
    return os.environ.get("TVC_GN_BF16_IO", "0") == "1"


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding of (B,) step labels, f32 (the caller casts it)."""
    if timesteps.dim() != 1:
        raise ValueError("timesteps must be 1-D")
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Dense(nn.Linear):
    """Linear layer with the DDPM ``default_init`` and a zero bias, computing
    in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype = dtype

    def init_weights(self, generator=None):
        default_init_(self.weight, 1.0, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class DDPMConv(nn.Conv2d):
    """3x3 / 1x1 'same' conv with the DDPM ``default_init(init_scale)``,
    computing in ``dtype`` (cuDNN adds the bias in its float32 epilogue,
    where Flax rounds the product to the compute dtype before the add)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 init_scale: float = 1.0, bias: bool = True, dtype=torch.float32, device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=kernel_size // 2,
                         bias=bias, device=device)
        self.init_scale = init_scale
        self.dtype = dtype

    def init_weights(self, generator=None):
        default_init_(self.weight, self.init_scale, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class NIN(nn.Module):
    """Network-in-network: a dense map over the last (channel) axis."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_dim, num_units, device=device))
        self.b = nn.Parameter(torch.zeros(num_units, device=device))
        self.init_scale = init_scale
        self.dtype = dtype
        self.init_weights()

    def init_weights(self, generator=None):
        default_init_(self.W, self.init_scale, generator)
        with torch.no_grad():
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(x.to(dt), self.W.to(dt)) + self.b.to(dt)


class GroupNormRef(nn.GroupNorm):
    """GroupNorm with the reference's group-count rule; f32 statistics, the
    result in the compute ``dtype``."""

    def __init__(self, ch: int, eps: float = 1e-6, affine: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__(num_groups_for(ch), ch, eps=eps, affine=affine, device=device)
        self.dtype = dtype

    def init_weights(self, generator=None):
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.weight.to(dt) if self.affine else None
        b = self.bias.to(dt) if self.affine else None
        if dt != torch.float32 and gn_bf16_io():
            # PyTorch's GroupNorm takes a half-precision input's statistics in float32
            return F.group_norm(x.to(dt), self.num_groups, w, b, self.eps)
        w = None if w is None else w.float()
        b = None if b is None else b.float()
        return F.group_norm(x.float(), self.num_groups, w, b, self.eps).to(dt)


class AttnBlockpp(nn.Module):
    """Multi-head spatial self-attention; the heads run ``tvc_torch.ops.attention``."""

    def __init__(self, channels: int, skip_rescale: bool = True, init_scale: float = 0.0,
                 n_heads: int = 1, n_head_channels: int = -1, dtype=torch.float32, device=None):
        super().__init__()
        c = channels
        if n_head_channels == -1:
            self.heads = n_heads
        elif c < n_head_channels:
            self.heads = 1
        else:
            if c % n_head_channels != 0:
                raise ValueError(f"channels {c} not a multiple of n_head_channels {n_head_channels}")
            self.heads = c // n_head_channels
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNormRef(c, eps=1e-6, dtype=dtype, device=device)
        self.NIN_0 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_1 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_2 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_3 = NIN(c, c, init_scale=init_scale, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t, heads = h * w, self.heads
        tok = self.GroupNorm_0(x).flatten(2).transpose(1, 2)  # (B, T, C)

        def split_heads(y):  # (B, T, C) -> a (B, heads, T, C / heads) view
            return y.view(b, t, heads, c // heads).transpose(1, 2)

        out = attention(split_heads(self.NIN_0(tok)), split_heads(self.NIN_1(tok)),
                        split_heads(self.NIN_2(tok)))
        # on the card the kernel's output lies as (B, T, heads, d): a view, no copy
        out = self.NIN_3(out.transpose(1, 2).reshape(b, t, c))
        out = out.transpose(1, 2).reshape(b, c, h, w)
        if not self.skip_rescale:
            return x + out
        return (x + out) / _SQRT2


class GetActNorm(nn.Module):
    """GroupNorm (eps 1e-5) -> optional (1 + scale) / shift from the time
    embedding -> SiLU. With ``emb_dim`` the norm is affine-free and
    ``Dense_0`` projects the activated embedding to scale and shift."""

    def __init__(self, ch: int, emb_dim: Optional[int] = None, dtype=torch.float32, device=None):
        super().__init__()
        if emb_dim is not None:
            self.Dense_0 = Dense(emb_dim, 2 * ch, dtype=dtype, device=device)
        self.Norm_0 = GroupNormRef(ch, eps=1e-5, affine=emb_dim is None, dtype=dtype,
                                   device=device)
        self.has_emb = emb_dim is not None

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.Norm_0(x)
        if self.has_emb:
            if emb is None:
                raise ValueError("GetActNorm built with emb_dim needs an embedding")
            scale, shift = self.Dense_0(F.silu(emb))[:, :, None, None].chunk(2, dim=1)
            y = y * (1 + scale) + shift
        return F.silu(y)


class ResnetBlockBigGAN(nn.Module):
    """BigGAN-style residual block with FIR up/down resampling."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, temb_dim: Optional[int] = None,
                 up: bool = False, down: bool = False,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.actnorm0 = GetActNorm(in_ch, temb_dim, dtype=dtype, device=device)
        self.Conv_0 = DDPMConv(in_ch, out_ch, 3, dtype=dtype, device=device)
        self.actnorm1 = GetActNorm(out_ch, temb_dim, dtype=dtype, device=device)
        self.Conv_1 = DDPMConv(out_ch, out_ch, 3, init_scale=init_scale, dtype=dtype,
                               device=device)
        if in_ch != out_ch or up or down:
            self.Conv_2 = DDPMConv(in_ch, out_ch, 1, dtype=dtype, device=device)
        else:
            self.Conv_2 = None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.actnorm0(x, temb)
        if self.up:
            h = upsample_2d(h, self.fir_kernel, factor=2, spatial_axes=NCHW)
            x = upsample_2d(x, self.fir_kernel, factor=2, spatial_axes=NCHW)
        elif self.down:
            h = downsample_2d(h, self.fir_kernel, factor=2, spatial_axes=NCHW)
            x = downsample_2d(x, self.fir_kernel, factor=2, spatial_axes=NCHW)
        h = self.Conv_0(h)
        h = self.actnorm1(h, temb)
        h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        if not self.skip_rescale:
            return x + h
        return (x + h) / _SQRT2
