"""UNet calls replayed as CUDA graphs (the port's counterpart of ``jax.jit``
over the JAX package's ``lax.scan`` sampler programs).

A ``GraphedEps`` wraps a sampler's ``eps_fn(x, labels, cond)`` and keeps one
captured CUDA graph per signature of its inputs (the shapes and dtypes of
``x``, ``labels`` and ``cond``). The graph reads its inputs from static
buffers, the labels included, so one graph serves every step of every
sampler: a DDPM update replays it 101 times, an F-PNDM update 109. The key
names no sampler setting, and the samplers' per-step combines run eagerly
between replays (a few elementwise launches against a UNet call's
thousand).

The first call of a signature runs ``eps_fn`` eagerly: that is its warm-up
(it builds the attention kernel and loads every other kernel, and at a
batch above one lets cuDNN time its algorithms, see
``core/runtime.batched_conv_algorithms``), and its output is the call's
result. The second call captures the graph under the caller's cuDNN flags,
so it records the algorithms the warm-up chose, and replays it; every later
call copies its inputs into the static buffers, replays the graph and
clones the output (a sampler may keep earlier outputs, as F-PNDM keeps four).
A graph replays the kernels that the eager call launched, on the same
inputs, so its output is the eager output byte for byte (the card-only
tests and ``chip_smoke.py`` hold it to that). The attention and GroupNorm
kernels' launch counters (the GroupNorm kernel's SPADE entry's too) count a
replay's launches at each replay.

A failed capture or replay raises; nothing falls back to the eager call.
The caller decides the device: a frame predictor on the CPU passes
``graphs=False``, and every call runs ``eps_fn`` eagerly.

Each call is a ``predictor.unet`` span of ``utils/profiler.py`` (the copy-in
and the replay, or the eager call, or the capture with its replay; the
capture alone is a ``predictor.capture`` span inside it), and counts
``graph.replays``, ``graph.captures`` or ``unet.eager_calls``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, Optional, Set

import torch

from tvc_torch.ops import attention, groupnorm, resample
from tvc_torch.utils import profiler


@dataclasses.dataclass
class _Entry:
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]
    output: torch.Tensor
    attention_launches: int   # attention kernels the graph launches a replay
    kernel_launches: Dict[str, int]  # of them, by kernel name
    groupnorm_launches: int   # GroupNorm kernels the graph launches a replay
    spade_launches: int       # of the GroupNorm kernel's SPADE entry, a replay
    channels_last_writes: int  # GroupNorm launches (either entry) writing channels-last
    fir_launches: int         # of the FIR resampling kernel, a replay
    capture_s: float          # host seconds of the capture
    pool_bytes: int           # device memory the capture reserved (its pool)
    replays: int = 0


def capture(fn: Callable[..., torch.Tensor], inputs: Dict[str, Optional[torch.Tensor]]):
    """(graph, output, attention launches a replay, device bytes the capture
    reserved) of ``fn(**inputs)`` captured on the current device."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    c0 = attention.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(**inputs)
    torch.cuda.synchronize()
    return graph, out, attention.captured - c0, torch.cuda.memory_reserved() - reserved


def _signature(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype)


class GraphedEps:
    """``eps_fn`` with one CUDA graph per input signature; see the module's docstring."""

    def __init__(self, eps_fn: Callable[..., torch.Tensor], graphs: bool = True):
        self.eps_fn = eps_fn
        self.graphs = graphs
        self.entries: Dict[Hashable, _Entry] = {}
        self.warm: Set[Hashable] = set()

    def __call__(self, x: torch.Tensor, labels: torch.Tensor,
                 cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        with profiler.span("predictor.unet"):
            if not self.graphs:
                profiler.count("unet.eager_calls")
                return self.eps_fn(x, labels, cond)
            inputs = {"x": x, "labels": labels, "cond": cond}
            key = tuple(_signature(t) for t in inputs.values())
            if key not in self.warm:
                profiler.count("unet.eager_calls")
                out = self.eps_fn(x, labels, cond)
                self.warm.add(key)
                return out
            entry = self.entries.get(key)
            if entry is None:
                entry = self._capture(key, inputs)
            for name, buf in entry.inputs.items():
                buf.copy_(inputs[name])
            entry.graph.replay()  # raises on a failed replay
            profiler.count("graph.replays")
            attention.count_launches(entry.attention_launches, entry.kernel_launches)
            groupnorm.count_launches(entry.groupnorm_launches, entry.spade_launches,
                                     entry.channels_last_writes)
            resample.count_launches(entry.fir_launches)
            entry.replays += 1
            return entry.output.clone()

    def _capture(self, key, inputs) -> _Entry:
        static = {k: torch.empty_like(v) for k, v in inputs.items() if v is not None}
        c0 = dict(attention.kernel_captured)
        g0, s0, w0 = (groupnorm.captured, groupnorm.spade_captured,
                      groupnorm.channels_last_captured)
        f0 = resample.captured
        with profiler.timed("predictor.capture") as timer:
            profiler.count("graph.captures")
            try:
                graph, out, launches, pool = capture(
                    lambda x, labels, cond=None: self.eps_fn(x, labels, cond), static)
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture of the UNet call {key} failed") from e
        by_kernel = {k: n - c0[k] for k, n in attention.kernel_captured.items()}
        entry = _Entry(graph, static, out, launches, by_kernel, groupnorm.captured - g0,
                       groupnorm.spade_captured - s0, groupnorm.channels_last_captured - w0,
                       resample.captured - f0, timer.seconds, pool)
        self.entries[key] = entry
        return entry

    def stats(self) -> Dict[str, dict]:
        """Per signature: capture seconds, pool bytes, attention, GroupNorm
        and SPADE norm launches a replay, the GroupNorm launches of them that
        write channels-last, the FIR resampling kernel's launches a replay,
        and replays so far."""
        return {str(k): {"capture_s": e.capture_s, "pool_bytes": e.pool_bytes,
                         "attention_launches": e.attention_launches,
                         "groupnorm_launches": e.groupnorm_launches,
                         "spade_launches": e.spade_launches,
                         "channels_last_writes": e.channels_last_writes,
                         "fir_launches": e.fir_launches, "replays": e.replays}
                for k, e in self.entries.items()}

