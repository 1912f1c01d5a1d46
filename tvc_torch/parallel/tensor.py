"""Tensor parallelism over the model axis: the layout that the JAX package
gets from GSPMD, written out.

The JAX package shards the last (output-channel) dimension of every kernel
with at least 2**16 elements that the model-axis size divides
(``param_partition_spec``) and lets XLA insert the collectives. Here
``TensorParallel`` applies the same rule to a module's parameters: each
process of a model group keeps its slice of the output channels of each
sharded weight (biases, norms and small kernels stay whole), and the layer
that uses the weight computes its slice of the output channels and
reassembles the whole output:

- the layer's input, which every process of the group holds whole, passes
  through an identity whose backward sums the input's gradient over the
  group (each slice of the output contributes its part of it);
- the slices of the output are all-gathered along the channel dimension; the
  backward keeps this process's slice of the output's gradient, which every
  process of the group computed alike from the whole output;
- the bias is added to the whole output, so its gradient is whole too.

Every gradient of a parameter is then either whole and equal on each
process of the group, or the gradient of this process's slice, so averaging
over the data group (DDP) is all the training step adds. The global norm for
clipping sums the squares of the slices over the group.

The layers sharded so are those of the UNets of the zoo: ``Dense``,
``DDPMConv`` and ``NIN`` (the 2-D and SPADE nets), and the 3-D nets'
``Conv3dDDPM`` and ``PseudoConv3d``.
"""

from __future__ import annotations

import types
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tvc_torch.models.diffusion.layers import NIN, DDPMConv, Dense
from tvc_torch.models.diffusion.layers3d import Conv3dDDPM, PseudoConv3d
from tvc_torch.parallel.mesh import Mesh, shard_params

Tensors = Dict[str, torch.Tensor]


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the slices along ``dim``; the backward keeps this
    process's slice of the (group-wide equal) gradient."""

    @staticmethod
    def forward(ctx, y, dim, group):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.rank, ctx.size = dim, rank, y.shape[dim]
        parts = [torch.empty_like(y.contiguous()) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


def _channel_bias(bias: torch.Tensor, dim: int, ndim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[dim] = -1
    return bias.view(shape)


class TensorParallel:
    """The model axis's layout of ``module`` on this process: its sharded
    parameters (name -> the dimension of their output channels) and the
    forwards that compute with the slices. Building it slices the sharded
    parameters in place; every process of the model group must build it
    from the same whole parameters."""

    def __init__(self, module: nn.Module, mesh: Mesh):
        self.group = mesh.model_group
        self.size, self.index = mesh.tp, mesh.model_index
        specs = shard_params(module, mesh)
        # the output channels: dim 0 of a conv or nn.Linear weight, the last of NIN's W
        self.sharded: Dict[str, int] = {
            name: p.dim() - 1 if name.endswith(".W") else 0
            for name, p in module.named_parameters() if specs[name]}
        self._ids = set()  # the local slices' parameters
        covered = set()
        for mname, m in module.named_modules():
            forward = self._forward_for(m)
            if forward is None:
                continue
            names = {f"{mname}.{n}" if mname else n for n, _ in m.named_parameters()}
            if names & set(self.sharded):
                m.forward = types.MethodType(forward, m)
                covered |= names
        missing = set(self.sharded) - covered
        if missing:
            raise TypeError(f"no tensor-parallel forward for the layers of {sorted(missing)}")
        with torch.no_grad():
            for mname, m in module.named_modules():
                for pname, p in list(m.named_parameters(recurse=False)):
                    full = f"{mname}.{pname}" if mname else pname
                    if full in self.sharded:
                        local = nn.Parameter(self.local(full, p.detach()).clone(),
                                             requires_grad=p.requires_grad)
                        setattr(m, pname, local)
                        self._ids.add(id(local))

    # ---------------------------------------------------------- forwards

    def _column(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                op: Callable, dim: int, owner: nn.Parameter) -> torch.Tensor:
        """``op(x, weight) + bias`` with the output channels on ``dim``; a
        sharded ``owner`` computes its slice and gathers the rest."""
        if id(owner) not in self._ids:
            y = op(x, weight)
        else:
            y = op(_CopyToModel.apply(x, self.group), weight)
            y = _GatherFromModel.apply(y, dim % y.dim(), self.group)
        return y if bias is None else y + _channel_bias(bias, dim % y.dim(), y.dim())

    def _forward_for(self, m: nn.Module):
        col = self._column
        if isinstance(m, DDPMConv):
            def forward(self_, x):
                dt = self_.dtype
                bias = None if self_.bias is None else self_.bias.to(dt)
                return col(x.to(dt), self_.weight.to(dt), bias,
                           lambda a, w: self_._conv_forward(a, w, None), 1, self_.weight)
            return forward
        if isinstance(m, Dense):
            def forward(self_, x):
                dt = self_.dtype
                return col(x.to(dt), self_.weight.to(dt), self_.bias.to(dt), F.linear, -1,
                           self_.weight)
            return forward
        if isinstance(m, NIN):
            def forward(self_, x):
                dt = self_.dtype
                return col(x.to(dt), self_.W.to(dt), self_.b.to(dt), torch.matmul, -1, self_.W)
            return forward
        if isinstance(m, Conv3dDDPM):
            def forward(self_, v):
                dt, c = self_.dtype, self_.conv
                return col(v.to(dt), c.weight.to(dt), c.bias.to(dt),
                           lambda a, w: F.conv3d(a, w, None, padding=c.padding), 1, c.weight)
            return forward
        if isinstance(m, PseudoConv3d):
            def forward(self_, v):
                dt, s, t = self_.dtype, self_.space_conv, self_.time_conv
                p = s.padding[0]
                y = col(v.to(dt), s.weight.to(dt)[:, :, None], s.bias.to(dt),
                        lambda a, w: F.conv3d(a, w, None, padding=(0, p, p)), 1, s.weight)
                return col(F.silu(y), t.weight.to(dt)[..., None, None], t.bias.to(dt),
                           lambda a, w: F.conv3d(a, w, None, padding=(p, 0, 0)), 1, t.weight)
            return forward
        return None

    # ---------------------------------------------------------- state

    def _dim(self, key: str) -> Optional[int]:
        """The sharded dimension of a parameter or of its optimizer slot
        (``mu/<name>``), or None."""
        return self.sharded.get(key.split("/", 1)[-1])

    def local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This process's slice of a whole tensor (itself where replicated)."""
        dim = self._dim(key)
        if dim is None:
            return full
        size = full.shape[dim] // self.size
        return full.narrow(dim, self.index * size, size)

    def gather(self, tensors: Tensors) -> Tensors:
        """Whole tensors from this process's slices (a collective of the
        model group: every process calls it with the same keys)."""
        out = {}
        for k, t in tensors.items():
            dim = self._dim(k)
            if dim is None:
                out[k] = t
                continue
            parts = [torch.empty_like(t.contiguous()) for _ in range(self.size)]
            dist.all_gather(parts, t.detach().contiguous(), group=self.group)
            out[k] = torch.cat(parts, dim=dim)
        return out

    def sq_norm(self, params, grads) -> torch.Tensor:
        """The squared global norm of the whole gradients: the replicated
        ones once, the slices summed over the model group."""
        rep = [torch.sum(g * g) for p, g in zip(params, grads) if id(p) not in self._ids]
        shard = [torch.sum(g * g) for p, g in zip(params, grads) if id(p) in self._ids]
        ref = grads[0]
        part = torch.stack(shard).sum() if shard else ref.new_zeros(())
        dist.all_reduce(part, group=self.group)
        return (torch.stack(rep).sum() if rep else ref.new_zeros(())) + part
