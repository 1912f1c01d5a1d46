"""Fused multi-head attention (counterpart of ``tvc/ops/pallas_attention.py``).

``attention(q, k, v)`` computes, per (batch, head), ``softmax(q k^T d^-1/2) v``
on (B, H, T, d) tensors with f32 softmax and f32 accumulation, and returns the
input dtype. The inputs may be strided views (the attention block passes the
heads of its (B, T, C) projections) as long as the last dim has unit stride;
on the card the output is a (B, H, T, d) view of a (B, T, H, d) tensor, so
folding the heads back into channels is free. On a CUDA tensor it launches the
hand-written Hopper kernel of ``tvc_torch/csrc/attention.cu`` (built on first
use) or raises; on a CPU tensor it runs ``attention_plain``, the plain PyTorch
version of the same function, which is also the kernel's oracle on the card.

Where autograd records (grad mode on and an input that requires grad), the
kernel runs inside ``KernelAttention``, whose backward is
``attention_backward``: torch matrix products that recompute the softmax, as
the JAX package differentiates ``attention_reference`` with XLA einsums
outside any kernel. Under ``no_grad`` the kernel is launched bare and nothing
is saved.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from tvc_torch.ops import _build

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

QUERY_TILE = 64     # query rows per block of the kernel: 8 a warp
KEY_TILE = 32       # keys per shared-memory tile of the kernel
MAX_SPLITS = 8      # the portable thread-block cluster size
# Split the keys while a launch stays within this many blocks. A block takes
# 155 KB of shared memory at d = 192, so it holds an SM alone, and a cluster is
# placed whole inside one GPC: an H100 SXM holds 30 clusters of 4 or 15 of 8
# at once (cudaOccupancyMaxActiveClusters), not 132 blocks, and a launch past
# that runs a second wave. 96 blocks fit in one wave at every cluster size.
MAX_BLOCKS = 96

# Kernel launches since the last reset_launches(). Counted only where the
# CUDA kernel is launched, never on the CPU path. A launch recorded into a
# CUDA graph is not one: it adds to ``captured``, and the graph's owner
# counts its launches at each replay (``count_launches``).
launches = 0
captured = 0


def reset_launches() -> None:
    global launches
    launches = 0


def count_launches(n: int) -> None:
    """Count ``n`` launches made by replaying a CUDA graph."""
    global launches
    launches += n


class AttentionPlan(NamedTuple):
    splits: int          # blocks along the keys, one thread-block cluster
    keys_per_split: int  # a multiple of KEY_TILE; the last split may be shorter
    blocks: int          # blocks of the launch


@functools.lru_cache(maxsize=1024)
def attention_plan(b: int, h: int, t: int, d: int, dtype: torch.dtype) -> AttentionPlan:
    """How the kernel cuts a (b, h, t, d) launch into blocks of
    ``QUERY_TILE`` queries: a function of the shape and dtype alone, never of
    the card, so that a sender and a receiver on different parts sum in the
    same order and get the same bytes.

    The keys of each query tile are split into as many ranges as keep the
    launch within ``MAX_BLOCKS`` blocks, at most ``MAX_SPLITS`` and one key
    tile a range; the ranges are whole key tiles and none is empty."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"attention supports float32 and bfloat16, got {dtype}")
    if not 0 < d <= MAX_HEAD_DIM or b < 1 or h < 1 or t < 1:
        raise ValueError(f"no attention plan for shape {(b, h, t, d)}")
    ntiles = math.ceil(t / KEY_TILE)
    groups = b * h * math.ceil(t / QUERY_TILE)
    splits = max(1, min(MAX_SPLITS, ntiles, MAX_BLOCKS // groups))
    per = math.ceil(ntiles / splits)
    splits = math.ceil(ntiles / per)
    return AttentionPlan(splits, per * KEY_TILE, groups * splits)


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
    if q.shape[-1] > 1 and (q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1):
        raise ValueError("attention expects q, k and v with unit stride along the head dim")


_Strides = ctypes.c_longlong * 12


def _kernel():
    lib = _build.load("attention")
    fn = lib.tvc_attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [
            ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: AttentionPlan) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that ``_check`` accepts, with a given
    plan (the kernel refuses one that leaves a key out); ``attention`` passes
    ``attention_plan``'s, ``chip_smoke.py --sweep`` others. Counts one launch,
    or one capture while the stream records a CUDA graph."""
    global launches, captured
    b, h, t, d = q.shape
    fn = _kernel()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = _Strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, t, d,
             d ** -0.5, _DTYPE_CODES[q.dtype], plan.splits, plan.keys_per_split, q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {err} "
                           f"at shape {(b, h, t, d)} {q.dtype} with {plan}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       dout: torch.Tensor):
    """(dq, dk, dv) of attention at (q, k, v) given its output ``out`` and the
    output's gradient ``dout``; any strides. Recomputes P = softmax(q k^T d^-1/2)
    in float32, then dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O)),
    dQ = dS K d^-1/2 and dK = dS^T Q d^-1/2; each gradient in its input's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class KernelAttention(torch.autograd.Function):
    """The kernel's forward (``launch`` at ``attention_plan``'s plan) with
    ``attention_backward`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        out = launch(q, k, v, attention_plan(*q.shape, q.dtype))
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        return attention_backward(*ctx.saved_tensors, dout)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) fused attention: the CUDA kernel on the card, through
    ``KernelAttention`` (which saves nothing where autograd does not record),
    the plain version for CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu tensors, got {q.device}")
    return KernelAttention.apply(q, k, v)


def kernel_info(dtype: torch.dtype, d: int, splits: int) -> dict:
    """What a launch at head dim ``d`` takes on the current card: shared
    memory a block, and how many clusters of ``splits`` blocks fit at once."""
    fn = _build.load("attention").tvc_attention_kernel_info
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * 2)()
    err = fn(_DTYPE_CODES[dtype], d, splits, info)
    if err != 0:
        raise RuntimeError(f"attention kernel info failed with CUDA error {err}")
    return {"smem_bytes": info[0], "max_active_clusters": info[1]}
