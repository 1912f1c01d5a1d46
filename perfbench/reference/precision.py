"""The arithmetic precision of the plain reference.

The reference computes in float32 with TF32 off. The control of a cell puts
the same reference in the program's place one precision lower: TF32 under a
float32 configuration, fp8 (e4m3, one scale per tensor) under a bfloat16
one. Both lower precisions are emulated by rounding the operands of every
convolution and matrix product and then computing in float32, which is what
the hardware does with them (the products are exact in float32 and the sums
accumulate in float32), and which runs alike on the CPU and the card.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
# the control of each configuration dtype: the nearest precision below it
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 stored mantissa bits (to nearest, ties away)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to e4m3 under one scale that maps the tensor's largest
    magnitude to the format's largest finite value."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """Convolutions and products whose operands are rounded to ``mode``."""

    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return round_tf32(t)
        if self.mode == "fp8":
            return round_fp8(t)
        return t.float()

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(), **kw)

    def conv_transpose2d(self, x, w, b=None, **kw):
        return F.conv_transpose2d(self.q(x), self.q(w), None if b is None else b.float(), **kw)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


@contextlib.contextmanager
def plain_numerics():
    """float32 as float32: TF32 off for convolutions and products while the
    reference runs, the flags restored after. cuDNN times its algorithms
    (all of them exact float32 with TF32 off): its heuristic takes FFT
    algorithms for some of the UNet's convolutions at B > 1, which would make
    the reference slower than the window it checks."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                                         deterministic=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
