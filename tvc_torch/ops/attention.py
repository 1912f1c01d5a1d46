"""Fused multi-head attention (counterpart of ``tvc/ops/pallas_attention.py``).

``attention(q, k, v)`` computes, per (batch, head), ``softmax(q k^T d^-1/2) v``
on (B, H, T, d) tensors with f32 softmax and f32 accumulation, and returns the
input dtype. The inputs may be strided views (the attention block passes the
heads of its (B, T, C) projections) as long as the last dim has unit stride;
on the card the output is a (B, H, T, d) view of a (B, T, H, d) tensor, so
folding the heads back into channels is free. On a CUDA tensor it launches a
hand-written Hopper kernel (built on first use) or raises: float32 takes
``tvc_torch/csrc/attention.cu`` (CUDA cores), bfloat16
``tvc_torch/csrc/attention_tc.cu`` (tensor cores, ``wgmma``). On a CPU tensor
it runs ``attention_plain``, the plain PyTorch version of the same function,
which is also the kernels' oracle on the card.

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

QUERY_TILE = 64     # query rows per block of either kernel
KEY_TILE = 32       # keys per shared-memory tile of the float32 kernel
TC_KEY_TILE = 64    # keys per shared-memory tile of the bf16 kernel
MAX_SPLITS = 8      # the portable thread-block cluster size
# Split the keys while a launch stays within this many blocks. A block takes
# 155 KB of shared memory at d = 192, so it holds an SM alone, and a cluster is
# placed whole inside one GPC: an H100 SXM holds 30 clusters of 4 or 15 of 8
# at once (cudaOccupancyMaxActiveClusters), not 132 blocks, and a launch past
# that runs a second wave. 96 blocks fit in one wave at every cluster size.
MAX_BLOCKS = 96
# The same for the bf16 kernel, two of whose blocks (100 KB each at d = 192)
# share an SM: cudaOccupancyMaxActiveClusters on an H100 SXM gives 264, 132,
# 79, 62, 47, 39, 32 and 30 clusters of 1 to 8 blocks, so 204 blocks fit in
# one wave at every cluster size.
TC_MAX_BLOCKS = 204

# the kernels by their names in ``_build.SOURCES``: float32, bf16
KERNELS = {torch.float32: "attention", torch.bfloat16: "attention_tc"}

# Kernel launches since the last reset_launches(), of both kernels and of
# each. Counted only where a CUDA kernel is launched, never on the CPU path.
# A launch recorded into a CUDA graph is not one: it adds to ``captured``,
# and the graph's owner counts its launches at each replay
# (``count_launches``).
launches = 0
captured = 0
kernel_launches = dict.fromkeys(KERNELS.values(), 0)
kernel_captured = dict.fromkeys(KERNELS.values(), 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for name in kernel_launches:
        kernel_launches[name] = 0


def count_launches(n: int, by_kernel: dict | None = None) -> None:
    """Count ``n`` launches made by replaying a CUDA graph, ``by_kernel``
    of them by kernel name."""
    global launches
    launches += n
    for name, m in (by_kernel or {}).items():
        kernel_launches[name] += m


class AttentionPlan(NamedTuple):
    splits: int          # blocks along the keys, one thread-block cluster
    keys_per_split: int  # a multiple of KEY_TILE; the last split may be shorter
    blocks: int          # blocks of the launch


@functools.lru_cache(maxsize=1024)
def attention_plan(b: int, h: int, t: int, d: int, dtype: torch.dtype) -> AttentionPlan:
    """How the dtype's kernel cuts a (b, h, t, d) launch into blocks of
    ``QUERY_TILE`` queries: a function of the shape and dtype alone, never of
    the card, so that a sender and a receiver on different parts sum in the
    same order and get the same bytes.

    The keys of each query tile are split into as many ranges as keep the
    launch within the kernel's block cap (``MAX_BLOCKS``, ``TC_MAX_BLOCKS``),
    at most ``MAX_SPLITS`` and one key tile a range; the ranges are whole key
    tiles of the kernel (``KEY_TILE``, ``TC_KEY_TILE``) and none is empty."""
    if dtype not in KERNELS:
        raise TypeError(f"attention supports float32 and bfloat16, got {dtype}")
    if not 0 < d <= MAX_HEAD_DIM or b < 1 or h < 1 or t < 1:
        raise ValueError(f"no attention plan for shape {(b, h, t, d)}")
    tile, cap = (KEY_TILE, MAX_BLOCKS) if dtype == torch.float32 else (TC_KEY_TILE, TC_MAX_BLOCKS)
    ntiles = math.ceil(t / tile)
    groups = b * h * math.ceil(t / QUERY_TILE)
    splits = max(1, min(MAX_SPLITS, ntiles, cap // groups))
    per = math.ceil(ntiles / splits)
    splits = math.ceil(ntiles / per)
    return AttentionPlan(splits, per * tile, groups * splits)


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
    if q.dtype not in KERNELS:
        raise TypeError(f"attention supports float32 and bfloat16, got {q.dtype}")
    if not 0 < q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in 1..{MAX_HEAD_DIM}, got {q.shape[-1]}")
    if q.shape[-1] > 1 and (q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1):
        raise ValueError("attention expects q, k and v with unit stride along the head dim")


_Strides = ctypes.c_longlong * 12


def _kernel(name: str):
    """The C entry point of kernel ``name`` (``KERNELS``), built on first use."""
    fn = getattr(_build.load(name), f"tvc_{name}_forward")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [
            ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * (
                4 if name == "attention_tc" else 3) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _tc_operand(x: torch.Tensor, dq: int) -> torch.Tensor:
    """``x`` as the bf16 kernel reads it: ``dq`` (a multiple of 8) columns a
    row, zero past d, a 16-byte-aligned base and batch, head and row strides
    in whole 16-byte chunks; a copy where ``x`` is not so already."""
    if x.shape[-1] != dq:
        return torch.nn.functional.pad(x, (0, dq - x.shape[-1]))
    if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: AttentionPlan,
           p_terms: int = 2) -> torch.Tensor:
    """Launch the dtype's kernel on CUDA tensors that ``_check`` accepts, with
    a given plan (the kernel refuses one that leaves a key out); ``attention``
    passes ``attention_plan``'s, ``chip_smoke.py --sweep`` others, and there
    ``p_terms=1``: the bf16 kernel with P rounded to bf16 once (d = 192 only;
    the path always keeps hi + lo). Counts one launch, or one capture while
    the stream records a CUDA graph."""
    global launches, captured
    b, h, t, d = q.shape
    name = KERNELS[q.dtype]
    fn = _kernel(name)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    args = [b, h, t, d, d ** -0.5, plan.splits, plan.keys_per_split]
    if name == "attention_tc":
        dq = -(-d // 8) * 8
        q, k, v = (_tc_operand(x, dq) for x in (q, k, v))
        args.append(p_terms)
    elif p_terms != 2:
        raise ValueError("p_terms applies to the bf16 kernel only")
    strides = _Strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, *args,
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err} "
                           f"at shape {(b, h, t, d)} {q.dtype} with {plan}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
        kernel_captured[name] += 1
    else:
        launches += 1
        kernel_launches[name] += 1
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
    """What a launch of the dtype's kernel at head dim ``d`` takes on the
    current card: shared memory a block, and how many clusters of ``splits``
    blocks fit at once."""
    name = KERNELS[dtype]
    fn = getattr(_build.load(name), f"tvc_{name}_kernel_info")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * 2)()
    err = fn(d, splits, info)
    if err != 0:
        raise RuntimeError(f"{name} kernel info failed with CUDA error {err}")
    return {"smem_bytes": info[0], "max_active_clusters": info[1]}
