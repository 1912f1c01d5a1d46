"""Process layout over ``torch.distributed`` (counterpart of ``tvc/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D (data, model) mesh. Here each
process drives one device: NCCL between cards, gloo between CPU processes. The
data axis is the processes of the group, and each takes its slice of the
global batch (``data_sharding``); the model axis (tensor parallel) is item
A10 of ROADMAP.md, so a layout that needs it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tvc_torch.core.config import MeshConfig

PartitionSpec = Tuple[Optional[str], ...]  # a jax PartitionSpec as a tuple; () replicates
TP_REFUSAL = ("a model axis of {tp}: tensor-parallel sharding over the model axis is not "
              "ported yet (ROADMAP.md, queue A, A10)")


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda") -> None:
    """Join a process group of ``num_processes`` at ``coordinator``
    (``host:port``; NCCL for a CUDA ``device``, gloo otherwise). No-op when
    single-process."""
    if num_processes is None or num_processes <= 1:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) layout of the processes; this process's rank."""

    shape: Dict[str, int]
    axis_names: Tuple[str, str]
    rank: int = 0


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The (data, model) layout of the default group's processes."""
    cfg = cfg or MeshConfig()
    n, rank = world()
    tp = max(1, cfg.model_parallel)
    if n % tp != 0:
        tp = 1
    dp = n // tp if cfg.data_parallel in (-1, 0) else cfg.data_parallel
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} processes")
    if tp > 1:
        raise NotImplementedError(TP_REFUSAL.format(tp=tp))
    return Mesh({cfg.data_axis: dp, cfg.model_axis: tp}, (cfg.data_axis, cfg.model_axis), rank)


def data_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This process's slice of the leading (batch) axis of a global batch."""
    dp = mesh.shape[mesh.axis_names[0]]
    if x.shape[0] % dp != 0:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the data axis {dp}")
    per = x.shape[0] // dp
    return x[mesh.rank * per: (mesh.rank + 1) * per]


def replicated(mesh: Mesh) -> PartitionSpec:
    """The spec of a tensor every process holds whole."""
    return ()


def param_partition_spec(shape, tp_axis: str, tp_size: int,
                         min_size: int = 2 ** 16) -> PartitionSpec:
    """Tensor-parallel rule: shard the output-channel (last, in the JAX
    layout) dim of large kernels when divisible by the model-axis size;
    replicate everything else."""
    if (tp_size > 1 and len(shape) >= 2 and shape[-1] % tp_size == 0
            and int(np.prod(shape)) >= min_size):
        return (None,) * (len(shape) - 1) + (tp_axis,)
    return ()


def _jax_shape(name: str, p: torch.Tensor) -> Tuple[int, ...]:
    """A port parameter's shape in the JAX layout: conv (O, I, kh, kw) ->
    (kh, kw, I, O), ``nn.Linear`` (out, in) -> (in, out); NIN's ``W`` and
    vectors as they are."""
    if p.dim() == 4:
        return tuple(p.shape[2:]) + (p.shape[1], p.shape[0])
    if p.dim() == 2 and not name.endswith(".W"):
        return tuple(p.shape[::-1])
    return tuple(p.shape)


def shard_params(module: torch.nn.Module, mesh: Mesh) -> Dict[str, PartitionSpec]:
    """The rule over a module's parameters, as specs of the JAX layout."""
    tp_axis = mesh.axis_names[1]
    return {name: param_partition_spec(_jax_shape(name, p), tp_axis, mesh.shape[tp_axis])
            for name, p in module.named_parameters()}


def partition_work(items: List, num_shards: int, shard_id: int) -> List:
    """Static round-robin share of the work items (videos, walks) that process
    ``shard_id`` of ``num_shards`` runs."""
    return [it for i, it in enumerate(items) if i % num_shards == shard_id]
