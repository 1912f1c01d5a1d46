"""GroupNorm, the time embedding's scale and shift, and SiLU in one kernel.

``group_norm_act(x, num_groups, eps, weight, bias, scale, shift, silu, dtype)``
computes, on an (N, C, *spatial) input,

    y = GroupNorm(x) [* w + b]  ->  [* (1 + scale) + shift]  ->  [SiLU]

with float32 statistics and the result in the compute ``dtype``: the chain of
``GroupNormRef``, ``GetActNorm`` and ``GetActNorm3D``
(``models/diffusion/layers.py``, ``ncsnpp3d.py``); ``scale`` and ``shift`` are
(N, C), one value a sample and channel. With ``gamma`` and ``beta`` (keywords,
of x's shape, no affine weights) it is the SPADE net's modulated norm
(``GetActNormSPADE``, ``models/diffusion/spade.py``):

    y = GroupNorm(x) * (1 + gamma) + beta  ->  [* (1 + scale) + shift]  ->  [SiLU]

launched on the card as the kernel's own entry ``groupnorm_spade_fwd``. The
result is laid out as ``x``: contiguous, or channels-last (the bf16 UNet's
activations on the card), which the kernel writes as it lies; gamma and beta
are read in that layout too. On a
CPU tensor it runs ``group_norm_plain``, the PyTorch composition the layers
ran before the kernel, op for op, which is also the kernel's oracle on the
card. On a CUDA tensor it
launches ``tvc_torch/csrc/groupnorm.cu`` (built on first use) or raises: the
kernel rounds where the composition rounds, so the two differ only in the
order of the statistics' sums. The JAX package leaves this chain to XLA's
fusion; no Pallas kernel stands behind it.

Where autograd records, the kernel runs inside ``KernelGroupNorm``, whose
backward recomputes the plain composition and differentiates it.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tvc_torch.ops import _build
from tvc_torch.ops.layout import channels_last, like

MAX_SPLITS = 16     # the largest thread-block cluster an H100 schedules (8 is portable)
# A block keeps its part of a slice in shared memory: at most SPLIT_BYTES where
# a slice is split for its size, and a slice larger than MAX_SPLITS * SMEM_MAX
# is read again from device memory.
SPLIT_BYTES = 48 * 1024
SMEM_MAX = 196 * 1024
MIN_PART = 8 * 1024     # a slice split to fill the card keeps parts of at least this many bytes
# Blocks that fill an H100 SXM (132 SMs) about twice over: a launch of fewer
# slices splits them. A constant of the plan, never read from the card, so
# that a sender and a receiver on other parts get the same plan and the same
# bytes. The rule's constants come from timing every split at the flagship's
# shapes (PERF.md).
FILL_BLOCKS = 256

THREADS = 256  # a block's threads; a channels-last launch takes at most this many runs a pixel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_AFFINE, _EMB, _SILU, _IO, _PARAMS_BF16, _OUT_CL = 1, 2, 4, 8, 16, 64

# Kernel launches since the last reset_launches(), of the plain entry
# (``launches``) and of the SPADE entry (``spade_launches``), and of either
# writing a channels-last y (``channels_last_writes``); counted only where the
# kernel is launched, never on the CPU path. A launch recorded into a CUDA
# graph adds to ``captured``, ``spade_captured`` and ``channels_last_captured``
# instead, and the graph's owner counts its launches at each replay
# (``count_launches``).
launches = 0
captured = 0
spade_launches = 0
spade_captured = 0
channels_last_writes = 0
channels_last_captured = 0


def reset_launches() -> None:
    global launches, spade_launches, channels_last_writes
    launches = spade_launches = channels_last_writes = 0


def count_launches(n: int, spade: int = 0, cl_writes: int = 0) -> None:
    """Count ``n`` launches of the plain entry and ``spade`` of the SPADE
    entry, ``cl_writes`` of them writing a channels-last y, made by
    replaying a CUDA graph."""
    global launches, spade_launches, channels_last_writes
    launches += n
    spade_launches += spade
    channels_last_writes += cl_writes


def gn_bf16_io() -> bool:
    """``TVC_GN_BF16_IO=1``: GroupNorm of a non-float32 compute dtype reads and
    writes that dtype and takes only its statistics in float32 (the JAX
    package's ``_gn_bf16_io``); off by default. Read at each call, as the JAX
    package reads it at each trace, and stamped into a GOP payload."""
    return os.environ.get("TVC_GN_BF16_IO", "0") == "1"


class GroupNormPlan(NamedTuple):
    # a contiguous x:
    splits: int     # blocks a slice (n, group), one thread-block cluster
    pix: int        # pixels of every channel of the group a split takes; the last may take fewer
    vec: int        # elements a load: 16 bytes' worth, or 1 where the runs are not whole vectors
    resident: bool  # the part stays in shared memory between the passes
    blocks: int     # blocks of the launch
    smem: int       # dynamic shared memory a block, bytes: the part and 16 bytes a channel
    # a channels-last x (0 otherwise):
    run: int        # a pixel's channels a load and store: 16 bytes' worth, halved until it
                    # divides the channels (the group's, with chunk 0)
    chunk: int      # pixels a block of each of its two kernels; 0: one block a slice


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, v))))


def _pow2_floor(v: int) -> int:
    return 1 << max(0, int(math.log2(max(1, v))))


@functools.lru_cache(maxsize=1024)
def groupnorm_plan(n: int, c: int, hw: int, groups: int, dtype: torch.dtype,
                   channels_last: bool = False) -> GroupNormPlan:
    """How the kernel cuts an (n, c, hw) launch with ``groups`` groups: a
    function of the shape, dtype and layout alone, never of the card, so that
    a sender and a receiver sum in the same order and get the same bytes.

    A slice (n, group) is split along its pixels into a power of two of parts
    (a cluster of blocks): enough that a part keeps at most ``SPLIT_BYTES``,
    and where the launch has fewer than ``FILL_BLOCKS`` slices, enough to
    reach it while a part keeps ``MIN_PART`` bytes; at most ``MAX_SPLITS``.
    A channels-last input of small slices (under ``SPLIT_BYTES``) in a
    launch of at least ``FILL_BLOCKS / 2`` of them, or of more runs a pixel
    than a block has threads (float32 beyond 1,024 channels), takes one block
    a slice (``chunk`` 0), ``run`` channels of a group a load; any other
    streams through two kernels in chunks of ``chunk`` pixels a block, enough
    chunks to reach ``FILL_BLOCKS`` blocks, a whole number of the block's
    rows of pixels, ``run`` channels a load, at most ``THREADS`` runs a pixel
    (a wider pixel of larger slices is refused). Both set the order of the
    statistics' sums."""
    if dtype not in DTYPES:
        raise TypeError(f"group_norm_act supports float32 and bfloat16, got {dtype}")
    if n < 1 or c < 1 or hw < 1 or groups < 1 or c % groups:
        raise ValueError(f"no group norm plan for n={n} c={c} hw={hw} groups={groups}")
    esize = torch.finfo(dtype).bits // 8
    cg, slices = c // groups, n * groups
    run = chunk = 0
    if channels_last:
        run = 16 // esize
        while run > 1 and c % run:
            run //= 2
        wide = c // run > THREADS  # more runs a pixel than a streaming block has threads
        one_block = cg * hw * esize < SPLIT_BYTES and (slices >= FILL_BLOCKS // 2 or wide)
        if one_block:
            run = 16 // esize
            while run > 1 and cg % run:
                run //= 2
        elif wide:
            raise ValueError(f"no channels-last plan for {c} channels of {hw} pixels in "
                             f"{groups} groups: more than {THREADS} runs of {run} channels a "
                             f"pixel, and a slice too large for one block")
        else:
            rows = THREADS // (c // run)  # pixels a block's threads take at a time
            chunk = max(rows, math.ceil(hw / math.ceil(FILL_BLOCKS / n)))
            chunk = min(hw, math.ceil(chunk / rows) * rows)
    vec = 16 // esize if hw % (16 // esize) == 0 else 1
    slice_bytes = cg * hw * esize
    fill = min(_pow2_ceil(math.ceil(FILL_BLOCKS / slices)), _pow2_floor(slice_bytes // MIN_PART))
    splits = min(MAX_SPLITS, hw // vec,
                 max(_pow2_ceil(math.ceil(slice_bytes / SPLIT_BYTES)), fill))
    pix = math.ceil(math.ceil(hw / splits) / vec) * vec
    splits = math.ceil(hw / pix)
    part = cg * pix * esize
    resident = part <= SMEM_MAX
    data = -(-part // 16) * 16 if resident else 0
    return GroupNormPlan(splits, pix, vec, resident, splits * slices, data + 16 * cg, run, chunk)


def _rows(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (N, C) scale or shift shaped to broadcast over ``x``'s spatial dims."""
    return t.reshape(t.shape + (1,) * (x.dim() - 2))


def group_norm_plain(x: torch.Tensor, num_groups: int, eps: float,
                     weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
                     silu: bool = False, dtype: torch.dtype = torch.float32,
                     io: Optional[bool] = None, gamma: Optional[torch.Tensor] = None,
                     beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain as plain PyTorch ops: ``GroupNormRef`` (float32 statistics,
    the affine weights rounded to ``dtype`` first; with ``io``, default
    ``gn_bf16_io()``, a non-float32 dtype's input and output stay in it),
    then SPADE's ``y * (1 + gamma) + beta``, ``y * (1 + scale) + shift`` and
    ``silu`` in ``dtype``."""
    dt = dtype
    io = gn_bf16_io() if io is None else io
    w = weight.to(dt) if weight is not None else None
    b = bias.to(dt) if bias is not None else None
    if dt != torch.float32 and io:
        # PyTorch's GroupNorm takes a half-precision input's statistics in float32
        y = F.group_norm(x.to(dt), num_groups, w, b, eps)
    else:
        w = None if w is None else w.float()
        b = None if b is None else b.float()
        y = F.group_norm(x.float(), num_groups, w, b, eps).to(dt)
    if gamma is not None:
        y = y * (1 + gamma) + beta
    if scale is not None:
        y = y * (1 + _rows(scale, x)) + _rows(shift, x)
    return F.silu(y) if silu else y


def _check(x, num_groups, weight, bias, scale, shift, dtype, gamma=None, beta=None) -> None:
    if x.dim() < 2:
        raise ValueError(f"group_norm_act expects an (N, C, *spatial) tensor, got {tuple(x.shape)}")
    if dtype not in DTYPES or x.dtype != dtype:
        raise TypeError(f"group_norm_act runs float32 or bfloat16 with x in the compute dtype, "
                        f"got x {x.dtype} and dtype {dtype}")
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if ((weight is None) != (bias is None) or (scale is None) != (shift is None)
            or (gamma is None) != (beta is None)):
        raise ValueError("weight and bias, scale and shift, and gamma and beta come in pairs")
    if gamma is not None:
        if weight is not None:
            raise ValueError("the SPADE norm (gamma and beta) takes no affine weights")
        for name, t in (("gamma", gamma), ("beta", beta)):
            if t.shape != x.shape or t.device != x.device or t.dtype != dtype:
                raise ValueError(f"{name} must be {tuple(x.shape)} {dtype} on {x.device}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t, shape in (("weight", weight, (c,)), ("bias", bias, (c,)),
                           ("scale", scale, (n, c)), ("shift", shift, (n, c))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        if name in ("scale", "shift") and (t.dtype != dtype or (c > 1 and t.stride(1) != 1)):
            raise ValueError(f"{name} must be {dtype} with unit column stride")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if weight is not None and weight.dtype != bias.dtype:
        raise TypeError("weight and bias must share a dtype")


def _kernel(spade: bool = False):
    """A C entry point of ``csrc/groupnorm.cu`` (the plain one, or the SPADE
    one, which takes gamma and beta where the plain one takes the affine
    weights), built on first use."""
    lib = _build.load("groupnorm")
    fn = lib.tvc_groupnorm_spade_forward if spade else lib.tvc_groupnorm_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(x: torch.Tensor, num_groups: int, eps: float, weight=None, bias=None, scale=None,
           shift=None, silu: bool = False, io: bool = False, gamma=None, beta=None,
           out_channels_last: Optional[bool] = None) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor that ``_check`` accepts (its dtype
    is the compute dtype), contiguous or channels-last, into a new tensor
    laid out as ``x``, with ``groupnorm_plan``'s plan; with ``gamma`` and
    ``beta`` (brought to the result's layout and aligned here) its SPADE
    entry. Counts one launch, or one capture while the stream records a CUDA
    graph, of the entry it runs, and of a channels-last write.
    ``out_channels_last=False`` asks a channels-last ``x`` for a contiguous
    result: no program path takes it; it is the oracle of the card tests and
    ``chip_smoke.py``, which hold the channels-last result to it bit for bit.
    ``groupnorm_plan`` refuses a channels-last x it cannot read."""
    global launches, captured, spade_launches, spade_captured
    global channels_last_writes, channels_last_captured
    cl = channels_last(x)
    if not (cl or x.is_contiguous()):
        raise ValueError("group_norm_act's kernel expects a contiguous or channels-last "
                         f"(N, C, *spatial) tensor, got strides {x.stride()}")
    out_cl = cl if out_channels_last is None else out_channels_last
    if out_cl and not cl:
        raise ValueError("the kernel writes a channels-last result from a channels-last input "
                         "only")
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    plan = groupnorm_plan(n, c, hw, num_groups, x.dtype, cl)
    if x.data_ptr() % (16 if not cl else plan.run * x.element_size()):
        x = x.clone()  # a fresh allocation, aligned, in x's layout
    y = torch.empty_like(x) if cl and out_cl else torch.empty(x.shape, dtype=x.dtype,
                                                              device=x.device)
    work = None
    if cl and plan.chunk:  # each chunk's sums of each group, joined by the second kernel
        work = torch.empty(2 * n * -(-hw // plan.chunk) * num_groups, dtype=torch.float32,
                           device=x.device)
    spade = gamma is not None
    if spade:  # read at y's offsets, 16 bytes a load
        gamma, beta = (t if t.stride() == y.stride() and t.data_ptr() % 16 == 0
                       else torch.empty_like(y).copy_(t) for t in (gamma, beta))
    io = io and x.dtype != torch.float32
    if io:  # ATen's bf16 group norm takes eps in the input's dtype
        eps = float(torch.tensor(eps, dtype=x.dtype))
    flags = ((_AFFINE if weight is not None else 0) | (_EMB if scale is not None else 0)
             | (_SILU if silu else 0) | (_IO if io else 0)
             | (_PARAMS_BF16 if weight is not None and weight.dtype == torch.bfloat16 else 0)
             | (_OUT_CL if cl and out_cl else 0))
    ss = (scale.stride(0), shift.stride(0)) if scale is not None else (0, 0)
    err = _kernel(spade)(x.data_ptr(), y.data_ptr(),
                         *((_ptr(gamma), _ptr(beta)) if spade else (_ptr(weight), _ptr(bias))),
                         _ptr(scale), _ptr(shift), *ss, n, c, hw, num_groups, eps,
                         DTYPES[x.dtype], flags, int(cl), plan.run, plan.chunk, plan.splits,
                         plan.pix, plan.vec, int(plan.resident), _ptr(work), x.device.index,
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm{' spade' if spade else ''} kernel launch failed with CUDA "
                           f"error {err} at shape {tuple(x.shape)} {x.dtype} (channels-last {cl}, "
                           f"written channels-last {out_cl}) with {plan}")
    capturing = torch.cuda.is_current_stream_capturing()
    if spade and capturing:
        spade_captured += 1
    elif spade:
        spade_launches += 1
    elif capturing:
        captured += 1
    else:
        launches += 1
    if out_cl and capturing:
        channels_last_captured += 1
    elif out_cl:
        channels_last_writes += 1
    return y


class KernelGroupNorm(torch.autograd.Function):
    """The kernel's forward with the plain composition's gradient: the
    backward recomputes ``group_norm_plain`` and differentiates it."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, gamma, beta, num_groups, eps, silu, io):
        ctx.save_for_backward(x, weight, bias, scale, shift, gamma, beta)
        ctx.args = (num_groups, eps, silu, io)
        return launch(x, num_groups, eps, weight, bias, scale, shift, silu, io, gamma, beta)

    @staticmethod
    def backward(ctx, dy):
        num_groups, eps, silu, io = ctx.args
        needs = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            x, weight, bias, scale, shift, gamma, beta = leaves
            y = group_norm_plain(x, num_groups, eps, weight, bias, scale, shift, silu,
                                 x.dtype, io, gamma, beta)
            wanted = [t for t, need in zip(leaves, needs) if t is not None and need]
            grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        # x's, gamma's and beta's gradients in their own layout (ATen's group
        # norm on the card computes in NCHW)
        return tuple((like(next(grads), t) if i in (0, 5, 6) else next(grads))
                     if t is not None and need else None
                     for i, (t, need) in enumerate(zip(leaves, needs))) + (None,) * 4


def group_norm_act(x: torch.Tensor, num_groups: int, eps: float,
                   weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
                   silu: bool = False, dtype: torch.dtype = torch.float32, *,
                   gamma: Optional[torch.Tensor] = None,
                   beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain of the module's docstring: the CUDA kernel on the card
    (through ``KernelGroupNorm``, which saves nothing where autograd does not
    record), ``group_norm_plain`` for CPU tensors. ``TVC_GN_BF16_IO`` is read
    at each call. ``x`` is in ``dtype`` on either device (``_check``), so
    the CPU accepts what the card accepts; the kernel reads it contiguous or
    channels-last and writes the layout it reads, any other layout (the 3-D
    nets' volumes, frames innermost) is made contiguous first, as ATen's group
    norm makes its input on the card."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_norm_act runs on cuda or cpu tensors, got {x.device}")
    _check(x, num_groups, weight, bias, scale, shift, dtype, gamma, beta)
    if x.device.type == "cpu":
        return group_norm_plain(x, num_groups, eps, weight, bias, scale, shift, silu, dtype,
                                gamma=gamma, beta=beta)
    if not (x.is_contiguous() or channels_last(x)):
        x = x.contiguous()
    return KernelGroupNorm.apply(x, weight, bias, scale, shift, gamma, beta, num_groups, eps,
                                 silu, gn_bf16_io())
