"""The memory format of the UNet's activations.

A UNet call runs one activation layout from its entry to its output, chosen
once, at the net's entry, by ``activation_layout`` from what the input shows:
its device type and the compute dtype. Every layer then keeps the layout it
receives (``like``): the GroupNorm kernel and, on the card, the FIR
resampling kernel write the layout they read, the attention block's tokens
follow their input, and the residual adds, rescales and skip ``cat``s meet
operands of one layout.
"""

from __future__ import annotations

from typing import Optional

import torch


def activation_layout(device_type: str, dtype: torch.dtype) -> Optional[torch.memory_format]:
    """The memory format of a UNet call's activations: channels-last for bf16
    on the card (cuDNN's bf16 tensor-core convolutions are NHWC kernels, so no
    layout conversion runs around them), contiguous NCHW for float32 on the
    card (its float32 convolutions with TF32 off are NCHW kernels), and None on
    the CPU: the layout the input arrives in, as before (CPU convolutions
    change bits with the memory format)."""
    if device_type != "cuda":
        return None
    return torch.channels_last if dtype == torch.bfloat16 else torch.contiguous_format


def keeps_layout(x: torch.Tensor) -> bool:
    """Whether an op that would lose a channels-last input's layout (the
    generic FIR resampling's zero-stuffed copy and convolution) gives its
    result the input's layout: on the card, where the UNet chooses its
    activations' layout at its entry. On the CPU the ops leave their results
    as before, so that the CPU nets' convolutions, whose bits change with the
    memory format, see the layouts they saw."""
    return x.is_cuda


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` (N, C, *spatial) lies channels-last and not contiguous."""
    return x.dim() > 2 and not x.is_contiguous() and x.movedim(1, -1).is_contiguous()


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """``x``'s memory format: channels-last or contiguous."""
    return torch.channels_last if channels_last(x) else torch.contiguous_format


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` laid out as ``ref``, a dense tensor of its shape (channels-last,
    contiguous, or channels innermost in any rank), with the same values:
    ``t`` itself where its strides are ``ref``'s already."""
    if t.stride() == ref.stride():
        return t
    if ref.dim() == 4:
        return t.contiguous(memory_format=memory_format(ref))
    return torch.empty_like(ref, dtype=t.dtype).copy_(t)
