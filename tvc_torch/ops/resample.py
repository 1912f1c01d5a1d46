"""FIR up/down-sampling (counterpart of ``tvc/ops/resample.py``).

StyleGAN2-style ``upfirdn2d``: insert ``up - 1`` zeros after every sample,
zero-pad by ``pad`` (negative crops), convolve with the FIR filter ``k``, keep
every ``down``-th sample. ``upsample_2d``/``downsample_2d`` with the NCSN++
default separable 4-tap kernel take the polyphase shift-and-add form, the JAX
package's default numerics (``TVC_POLYPHASE=1``, ``TVC_FUSED_FIR=0``): the
same coefficients, applied in the same order, one spatial axis at a time.
The two variables are read at each call, as the JAX package reads them at
each trace: ``TVC_POLYPHASE=0`` takes the generic ``upfirdn2d`` convolution,
``TVC_FUSED_FIR=1`` the one-pass 2-D polyphase form (``resample_env`` names
the settings that change bytes; a GOP payload's stamp carries them). On the
card the polyphase form, either of them, always runs as one launch of
``csrc/fir.cu`` (``_fir_card``; under autograd through ``KernelFIR``, whose
backward differentiates the ops), which rounds where the ops round: the same
bytes. It reads the tensor as it lies, NHWC or channels-last, or NCHW as the
NHWC tensor of its planes, and lays the result out as its input; it raises
for any other layout or dtype. Its launches are counted (``launches``). The
ops are the CPU's path and the kernel's oracle.

Layout: NHWC, as in the JAX package, by default. ``spatial_axes=(2, 3)`` runs
the same ops on the NCHW tensors inside the port's UNet. On the CPU the ops
leave their results as before; where ``layout.keeps_layout`` holds (on the
card), the generic form's NCHW result is laid out as its input.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tvc_torch.ops import layout

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
    ref = x
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    pad0, pad1 = int(pad[0]), int(pad[1])
    x = F.pad(x, (pad0, pad1, pad0, pad1))  # negative pads crop
    # conv2d is a correlation: flip k for a true convolution; depthwise
    kern = torch.as_tensor(np.ascontiguousarray(k[::-1, ::-1]), dtype=x.dtype, device=x.device)
    kern = kern.reshape(1, 1, kh, kw).expand(c, 1, kh, kw)
    return _as_input(F.conv2d(x, kern, stride=down, groups=c), ref)


def upfirdn2d(x: torch.Tensor, k, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Pad / upsample / FIR-filter / downsample a batch of NHWC images.

    Output spatial size: ``(H*up + pad0 + pad1 - kh) // down + 1``."""
    k = np.asarray(k, dtype=np.float64)
    y = _upfirdn2d_nchw(x.permute(0, 3, 1, 2), k, up, down, pad)
    return y.permute(0, 2, 3, 1)


def polyphase_enabled() -> bool:
    """``TVC_POLYPHASE`` (default on): the 4-tap shift-and-add form."""
    return os.environ.get("TVC_POLYPHASE", "1") != "0"


def fused_fir_enabled() -> bool:
    """``TVC_FUSED_FIR=1`` (default off): both axes of the polyphase form in one pass."""
    return os.environ.get("TVC_FUSED_FIR", "0") == "1"


def resample_env() -> Dict[str, str]:
    """The resampling settings as a numerics stamp records them: the fused
    form changes bytes only where the polyphase form runs."""
    poly = polyphase_enabled()
    return {"env_polyphase": str(int(poly)),
            "env_fused_fir": str(int(poly and fused_fir_enabled()))}


def _separable_4tap(k: Sequence[float]) -> Optional[np.ndarray]:
    """The normalized 1-D kernel if ``k`` is a separable 4-tap FIR and the
    polyphase form is on."""
    if not polyphase_enabled():
        return None
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


# Launches of ``csrc/fir.cu`` since the last ``reset_launches()``, counted
# where the kernel is launched; one recorded into a CUDA graph adds to
# ``captured`` instead, and the graph's owner counts its launches at each
# replay (``count_launches``).
launches = 0
captured = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches
    launches = 0


def count_launches(n: int) -> None:
    """Count ``n`` launches of the kernel made by replaying a CUDA graph."""
    global launches
    launches += n


def _card(x: torch.Tensor) -> bool:
    """Whether the polyphase form runs as ``csrc/fir.cu``'s kernel: on the card."""
    return x.is_cuda


def _launch(src: torch.Tensor, y: torch.Tensor, taps: list, up: bool, fused: bool) -> None:
    """One launch of the kernel from the contiguous (N, H, W, C) ``src`` into
    the contiguous ``y`` of the resampled shape, counted as one launch, or
    one capture while the stream records a CUDA graph."""
    global launches, captured
    from tvc_torch.ops import _build

    fn = _build.load("fir").tvc_fir2x
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    n, h, w, c = src.shape
    vw = 16 // src.element_size()
    vec = vw if c % vw == 0 and src.data_ptr() % 16 == 0 else 1
    err = fn(src.data_ptr(), y.data_ptr(), n, h, w, c, int(up), int(fused), *taps,
             DTYPES[src.dtype], vec, src.device.index,
             torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fir kernel launch failed with CUDA error {err} at shape "
                           f"{tuple(src.shape)} {src.dtype}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1


def _fir_card(x: torch.Tensor, taps: list, up: bool, spatial_axes=NHWC,
              fused: Optional[bool] = None) -> torch.Tensor:
    """The 2x polyphase resample (both axes; ``fused``, default
    ``fused_fir_enabled()``, the one-pass form) of ``x`` on the card, in one
    launch of ``csrc/fir.cu``, which rounds where the ops round: the same
    bytes. ``x`` is read as it lies and the result laid out as ``x``: its
    (N, H, W, C) view contiguous (NHWC, or channels-last NCHW), or its
    (N, C, H, W) view contiguous (NCHW, read as the NHWC tensor of its N * C
    planes). Raises for another layout or dtype."""
    if x.dtype not in DTYPES or x.dim() != 4:
        raise TypeError(f"the fir kernel takes a 4-D float32 or bfloat16 tensor, got "
                        f"{tuple(x.shape)} {x.dtype}")
    fused = fused_fir_enabled() if fused is None else fused
    x4 = x if tuple(spatial_axes) == NHWC else x.permute(0, 2, 3, 1)
    n, h, w, c = x4.shape
    ho, wo = (2 * h, 2 * w) if up else (h // 2, w // 2)
    if x4.is_contiguous():
        src, y4 = x4, x.new_empty((n, ho, wo, c))
        dst = y4
    elif x4.permute(0, 3, 1, 2).is_contiguous():
        planes = x4.permute(0, 3, 1, 2)
        src = planes.reshape(n * c, h, w, 1)
        y = x.new_empty((n, c, ho, wo))
        dst, y4 = y.view(n * c, ho, wo, 1), y.permute(0, 2, 3, 1)
    else:
        raise ValueError(f"the fir kernel reads a contiguous NHWC or NCHW tensor, got "
                         f"strides {x.stride()} for spatial axes {tuple(spatial_axes)}")
    if y4.numel():
        _launch(src, dst, taps, up, fused)
    return y4 if tuple(spatial_axes) == NHWC else y4.permute(0, 3, 1, 2)


def _polyphase(x: torch.Tensor, taps: list, up: bool, axes: Tuple[int, int],
               fused: bool) -> torch.Tensor:
    """The 2x polyphase resample of both ``axes`` as ops: the two axis
    passes, or the one-pass form where ``fused``."""
    if fused:
        return (_upsample2x_fused if up else _downsample2x_fused)(x, taps, axes)
    one = _upsample2x_axis if up else _downsample2x_axis
    return one(one(x, taps, axes[0]), taps, axes[1])


class KernelFIR(torch.autograd.Function):
    """The kernel's forward with the ops' gradient: the backward recomputes
    ``_polyphase`` and differentiates it."""

    @staticmethod
    def forward(ctx, x, taps, up, axes, fused):
        ctx.save_for_backward(x)
        ctx.args = (taps, up, axes, fused)
        return _fir_card(x, taps, up, axes, fused)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            leaf = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(_polyphase(leaf, *ctx.args), leaf, dy)
        return layout.like(dx, x), None, None, None, None


def _resample2x(x: torch.Tensor, taps: list, up: bool, axes: Tuple[int, int]) -> torch.Tensor:
    """The 2x polyphase resample: the kernel on the card (through
    ``KernelFIR`` where autograd records), the ops elsewhere."""
    fused = fused_fir_enabled()
    if not _card(x):
        return _polyphase(x, taps, up, tuple(axes), fused)
    if torch.is_grad_enabled() and x.requires_grad:
        return KernelFIR.apply(x, taps, up, tuple(axes), fused)
    return _fir_card(x, taps, up, axes, fused)


def _product(a: float, b: float, dtype: torch.dtype) -> float:
    # a tap product as the JAX package forms it: in the activation's dtype
    return (torch.tensor(a, dtype=dtype) * torch.tensor(b, dtype=dtype)).item()


def _upsample2x_fused(x: torch.Tensor, k: list, axes: Tuple[int, int]) -> torch.Tensor:
    """One-pass 2-D polyphase 2x upsample: phase (a, b) is the outer product of
    the per-axis taps (even: k3 x[m-1] + k1 x[m]; odd: k2 x[m] + k0 x[m+1])."""
    a0, a1 = axes
    xp = _pad_axis(_pad_axis(x, a0), a1)
    n0, n1 = x.shape[a0], x.shape[a1]

    def sl(i, j):
        return _slice_axis(_slice_axis(xp, a0, i, i + n0), a1, j, j + n1)

    even, odd = ((k[3], 0), (k[1], 1)), ((k[2], 1), (k[0], 2))
    rows = []
    for ta in (even, odd):
        row = []
        for tb in (even, odd):
            p = None
            for ca, ia in ta:
                for cb, ib in tb:
                    t = _product(ca, cb, x.dtype) * sl(ia, ib)
                    p = t if p is None else p + t
            row.append(p)
        rows.append(torch.stack(row, dim=a1 + 1))
    shape = list(x.shape)
    shape[a0], shape[a1] = 2 * n0, 2 * n1
    return torch.stack(rows, dim=a0 + 1).reshape(shape)


def _downsample2x_fused(x: torch.Tensor, k: list, axes: Tuple[int, int]) -> torch.Tensor:
    """One-pass 2-D polyphase 2x downsample: the 4x4 separable window on
    strided slices (out[m] = k3 x[2m-1] + k2 x[2m] + k1 x[2m+1] + k0 x[2m+2]
    along each axis)."""
    a0, a1 = axes
    xp = _pad_axis(_pad_axis(x, a0), a1)
    m0, m1 = x.shape[a0] // 2, x.shape[a1] // 2
    taps = ((k[3], 0), (k[2], 1), (k[1], 2), (k[0], 3))
    out = None
    for ca, ia in taps:
        for cb, ib in taps:
            s = _slice_axis(_slice_axis(xp, a0, ia, ia + 2 * m0, 2), a1, ib, ib + 2 * m1, 2)
            t = _product(ca, cb, x.dtype) * s
            out = t if out is None else out + t
    return out


def _to_nchw(x, spatial_axes):
    return x.permute(0, 3, 1, 2) if tuple(spatial_axes) == NHWC else x


def _from_nchw(x, spatial_axes):
    return x.permute(0, 2, 3, 1) if tuple(spatial_axes) == NHWC else x


def _as_input(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An NCHW result ``y`` laid out as the input ``x`` where the layout is kept."""
    return layout.like(y, x) if layout.keeps_layout(x) else y


def upsample_2d(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1), factor: int = 2,
                gain: float = 1.0, spatial_axes: Tuple[int, int] = NHWC) -> torch.Tensor:
    """FIR upsample by ``factor``; polyphase for factor 2 with a separable 4-tap ``k``."""
    k4 = _separable_4tap(k)
    if factor == 2 and k4 is not None:
        taps = _taps(k4 * np.sqrt(np.float64(gain * factor ** 2)), x.dtype)
        return _resample2x(x, taps, True, spatial_axes)
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
        return _resample2x(x, taps, False, spatial_axes)
    kk = setup_kernel(k) * gain
    p = kk.shape[0] - factor
    y = _upfirdn2d_nchw(_to_nchw(x, spatial_axes), kk, 1, factor, ((p + 1) // 2, p // 2))
    return _from_nchw(y, spatial_axes)


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1),
                     factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """Transposed-conv upsample fused with the FIR, on NCHW tensors; ``w`` is
    (O, I, kh, kw). The reference feeds a pre-flipped kernel to
    ``conv_transpose2d``, so the net effect is a zero-stuffed correlation
    with ``w``, then ``upfirdn2d`` (``tvc/ops/resample.py`` ``upsample_conv_2d``)."""
    n, c, h, wd = x.shape
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"upsample_conv_2d needs a square kernel, got {kh}x{kw}")
    kk = setup_kernel(k) * (gain * (factor ** 2))
    p = (kk.shape[0] - factor) - (kw - 1)
    z = x.new_zeros((n, c, (h - 1) * factor + 1, (wd - 1) * factor + 1))
    z[:, :, ::factor, ::factor] = x
    y = F.conv2d(z, w, padding=kh - 1)
    return _as_input(_upfirdn2d_nchw(y, kk, 1, 1, ((p + 1) // 2 + factor - 1, p // 2 + 1)), x)


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1),
                       factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR, then a strided VALID conv with ``w`` (O, I, kh, kw), on NCHW tensors."""
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"conv_downsample_2d needs a square kernel, got {kh}x{kw}")
    kk = setup_kernel(k) * gain
    p = (kk.shape[0] - factor) + (kw - 1)
    y = _upfirdn2d_nchw(x, kk, 1, 1, ((p + 1) // 2, p // 2))
    return _as_input(F.conv2d(y, w, stride=factor), x)


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC batch."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, 1, w, 1, c).expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Mean-pool downsample of an NHWC batch."""
    n, h, w, c = x.shape
    return x.reshape(n, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))
