"""FIR up/down-sampling (counterpart of ``tvc/ops/resample.py``).

StyleGAN2-style ``upfirdn2d``: insert ``up - 1`` zeros after every sample,
zero-pad by ``pad`` (negative crops), convolve with the FIR filter ``k``, keep
every ``down``-th sample. ``upsample_2d``/``downsample_2d`` with the NCSN++
default separable 4-tap kernel take the polyphase shift-and-add form, the JAX
package's default numerics (``TVC_POLYPHASE=1``, ``TVC_FUSED_FIR=0``): the
same coefficients, applied in the same order, one spatial axis at a time.

Layout: NHWC, as in the JAX package, by default. ``spatial_axes=(2, 3)`` runs
the same ops on the NCHW tensors inside the port's UNet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NHWC = (1, 2)
NCHW = (2, 3)


def setup_kernel(k: Sequence[float]) -> np.ndarray:
    """Normalize a 1-D (separable) or 2-D FIR kernel; sum = 1."""
    k = np.asarray(k, dtype=np.float64)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    if not (k.ndim == 2 and k.shape[0] == k.shape[1]):
        raise ValueError(f"FIR kernel must be 1-D or square 2-D, got shape {k.shape}")
    return k


def _upfirdn2d_nchw(x: torch.Tensor, k: np.ndarray, up: int, down: int,
                    pad: Tuple[int, int]) -> torch.Tensor:
    n, c, h, w = x.shape
    kh, kw = k.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    pad0, pad1 = int(pad[0]), int(pad[1])
    x = F.pad(x, (pad0, pad1, pad0, pad1))  # negative pads crop
    # conv2d is a correlation: flip k for a true convolution; depthwise
    kern = torch.as_tensor(np.ascontiguousarray(k[::-1, ::-1]), dtype=x.dtype, device=x.device)
    kern = kern.reshape(1, 1, kh, kw).expand(c, 1, kh, kw)
    return F.conv2d(x, kern, stride=down, groups=c)


def upfirdn2d(x: torch.Tensor, k, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Pad / upsample / FIR-filter / downsample a batch of NHWC images.

    Output spatial size: ``(H*up + pad0 + pad1 - kh) // down + 1``."""
    k = np.asarray(k, dtype=np.float64)
    y = _upfirdn2d_nchw(x.permute(0, 3, 1, 2), k, up, down, pad)
    return y.permute(0, 2, 3, 1)


def _separable_4tap(k: Sequence[float]) -> Optional[np.ndarray]:
    """The normalized 1-D kernel if ``k`` is a separable 4-tap FIR."""
    ka = np.asarray(k, dtype=np.float64)
    if ka.ndim == 1 and ka.shape[0] == 4:
        return ka / np.sum(ka)
    return None


def _taps(k4: np.ndarray, dtype: torch.dtype):
    # the coefficients as the JAX package multiplies by them: cast to the
    # activation's dtype (float32, or the UNet's compute dtype)
    return [torch.tensor(float(c), dtype=dtype).item() for c in k4]


def _pad_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    pad = [0, 0] * (x.dim() - axis)
    pad[-2:] = [1, 1]  # F.pad lists the last dim first
    return F.pad(x, pad)


def _slice_axis(x: torch.Tensor, axis: int, start: int, stop: int, step: int = 1):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _upsample2x_axis(x: torch.Tensor, k: list, axis: int) -> torch.Tensor:
    """Polyphase 2x upsample along one axis with a 4-tap FIR:
    out[2m] = k3 x[m-1] + k1 x[m];  out[2m+1] = k2 x[m] + k0 x[m+1]."""
    xp = _pad_axis(x, axis)
    n = x.shape[axis]
    even = k[3] * _slice_axis(xp, axis, 0, n) + k[1] * _slice_axis(xp, axis, 1, n + 1)
    odd = k[2] * _slice_axis(xp, axis, 1, n + 1) + k[0] * _slice_axis(xp, axis, 2, n + 2)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def _downsample2x_axis(x: torch.Tensor, k: list, axis: int) -> torch.Tensor:
    """Polyphase 2x downsample along one axis with a 4-tap FIR:
    out[m] = k3 x[2m-1] + k2 x[2m] + k1 x[2m+1] + k0 x[2m+2]."""
    xp = _pad_axis(x, axis)
    m = x.shape[axis] // 2

    def sl(start):
        return _slice_axis(xp, axis, start, start + 2 * m, 2)

    return k[3] * sl(0) + k[2] * sl(1) + k[1] * sl(2) + k[0] * sl(3)


def _to_nchw(x, spatial_axes):
    return x.permute(0, 3, 1, 2) if tuple(spatial_axes) == NHWC else x


def _from_nchw(x, spatial_axes):
    return x.permute(0, 2, 3, 1) if tuple(spatial_axes) == NHWC else x


def upsample_2d(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1), factor: int = 2,
                gain: float = 1.0, spatial_axes: Tuple[int, int] = NHWC) -> torch.Tensor:
    """FIR upsample by ``factor``; polyphase for factor 2 with a separable 4-tap ``k``."""
    k4 = _separable_4tap(k)
    if factor == 2 and k4 is not None:
        taps = _taps(k4 * np.sqrt(np.float64(gain * factor ** 2)), x.dtype)
        y = _upsample2x_axis(x, taps, spatial_axes[0])
        return _upsample2x_axis(y, taps, spatial_axes[1])
    kk = setup_kernel(k) * (gain * (factor ** 2))
    p = kk.shape[0] - factor
    y = _upfirdn2d_nchw(_to_nchw(x, spatial_axes), kk, factor, 1,
                        ((p + 1) // 2 + factor - 1, p // 2))
    return _from_nchw(y, spatial_axes)


def downsample_2d(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1), factor: int = 2,
                  gain: float = 1.0, spatial_axes: Tuple[int, int] = NHWC) -> torch.Tensor:
    """FIR downsample by ``factor``; polyphase for factor 2 with a separable 4-tap ``k``."""
    k4 = _separable_4tap(k)
    if factor == 2 and k4 is not None:
        taps = _taps(k4 * np.sqrt(np.float64(gain)), x.dtype)
        y = _downsample2x_axis(x, taps, spatial_axes[0])
        return _downsample2x_axis(y, taps, spatial_axes[1])
    kk = setup_kernel(k) * gain
    p = kk.shape[0] - factor
    y = _upfirdn2d_nchw(_to_nchw(x, spatial_axes), kk, 1, factor, ((p + 1) // 2, p // 2))
    return _from_nchw(y, spatial_axes)
