"""Fused multi-head attention (counterpart of ``tvc/ops/pallas_attention.py``).

``attention(q, k, v)`` computes, per (batch, head), ``softmax(q k^T d^-1/2) v``
on (B, H, T, d) tensors with f32 softmax and f32 accumulation, and returns the
input dtype. On a CUDA tensor it launches the hand-written Hopper kernel of
``tvc_torch/csrc/attention.cu`` (built on first use) or raises; on a CPU
tensor it runs ``attention_plain``, the plain PyTorch version of the same
function, which is also the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes

import torch

from tvc_torch.ops import _build

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(). Counted only where the
# CUDA kernel is launched, never on the CPU path.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) einsum attention with an f32 softmax; the function of
    ``attention_reference`` (tvc/ops/pallas_attention.py:25-31), weights cast
    to the input dtype before the second product as there."""
    d = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"attention expects (B, H, T, d) tensors, got shape {tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: {tuple(x.shape)} {x.dtype} "
                f"{x.device} vs {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention supports float32 and bfloat16, got {q.dtype}")
    if not 0 < q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in 1..{MAX_HEAD_DIM}, got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention expects contiguous q, k and v")


def _kernel():
    lib = _build.load("attention")
    fn = lib.tvc_attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) fused attention: the CUDA kernel on the card, the plain
    version for CPU tensors."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu tensors, got {q.device}")
    b, h, t, d = q.shape
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t, d,
                 d ** -0.5, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {err} "
                           f"at shape {(b, h, t, d)} {q.dtype}")
    launches += 1
    return out
