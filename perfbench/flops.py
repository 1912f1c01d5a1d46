"""The arithmetic of operations and bytes that every configuration shares.

A configuration's own count of one call of its net is its reference module's
``unet_flops`` and ``attention_launches`` (``perfbench/manifest.py``),
counted from the architecture, never from a run of the program, so that the
counts stay what the work needs however a later change computes it. One
multiply-add is 2 operations. Counted: every convolution (the FIR
resampling as the 4x4 depthwise convolution it is), every dense and NIN
product, and the two products of each attention head (q k^T and p v).
Normalisations, activations, the softmax and the sampler's per-step
arithmetic are not counted: they are a small share of the operations, and
elementwise.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def conv_flops(c_in: int, c_out: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * c_in * c_out * k * k * h_out * w_out


def attention_flops(batch: int, heads: int, tokens: int, d: int) -> float:
    return 4.0 * batch * heads * tokens * tokens * d


def attention_bytes(batch: int, heads: int, tokens: int, d: int, itemsize: int) -> float:
    """q, k and v read once, the output written once."""
    return 4.0 * batch * heads * tokens * d * itemsize


def unet_attention_bound_s(launches: Sequence[Tuple[int, int, int]], batch: int, itemsize: int,
                           peak_flops: float, peak_bytes_s: float) -> float:
    """The least time the attention calls of one UNet call (``launches``:
    (heads, tokens, head dim) of each) can take on the chip: per call the
    larger of operations over the peak and bytes over the memory's rate,
    summed."""
    return sum(max(attention_flops(batch, h, t, dd) / peak_flops,
                   attention_bytes(batch, h, t, dd, itemsize) / peak_bytes_s)
               for h, t, dd in launches)
