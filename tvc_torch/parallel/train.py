"""The DSM train step, data-parallel over processes (counterpart of
``tvc/parallel/train.py``).

``make_train_step`` returns ``(init_fn, step_fn)``. Whenever a process group
exists the UNet is wrapped in ``DistributedDataParallel``: each process
takes its slice of the global batch and of the draws, and the backward
averages the gradients over the data axis, as the JAX package's psum does;
clipping, the optimizer and the EMA then run on the averaged gradients. The
EMA is a copy of the parameters of its own.

Training is float32 without TF32 (the package's numerics), on cuDNN's
timed deterministic algorithms where a process's batch is more than one
(``batched_conv_algorithms``: a batch of one keeps the heuristic choice that
a receiver's B = 1 predictions repeat); ``dtype=torch.bfloat16`` raises, as
the predictor does. The model has no dropout layer, and the JAX
package's step runs its UNet with dropout off.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from tvc_torch.core.config import Config
from tvc_torch.core.runtime import batched_conv_algorithms, resolve_device
from tvc_torch.losses.dsm import anneal_dsm_score_estimation, draw_dsm
from tvc_torch.losses.ema import ema_update
from tvc_torch.losses.optimizers import get_optimizer
from tvc_torch.models.diffusion.layers import init_params
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.parallel.mesh import Mesh, data_sharding, make_mesh
from tvc_torch.samplers.schedules import Schedule

Tensors = Dict[str, torch.Tensor]
SERVING_REFUSAL = ("the sharded serving dry run needs FusedGOPSender.run_sharded, which is "
                   "not ported yet (ROADMAP.md, queue A, A10)")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # what the step runs: the UNet, or DDP around it
    opt_state: Tensors
    ema: Tensors
    step: int

    @property
    def module(self) -> UNetMoreDDPM:
        if isinstance(self.model, DistributedDataParallel):
            return self.model.module
        return self.model

    @property
    def params(self) -> Tensors:
        return dict(self.module.named_parameters())


def make_train_step(cfg: Config, mesh: Optional[Mesh] = None, dtype=torch.float32,
                    device="cuda"):
    """(init_fn, step_fn). ``init_fn(seed)`` draws the JAX package's DDPM
    init from ``seed`` on the host; ``step_fn(state, batch, labels, noise)``
    takes this process's batch ``dict(x=(B,H,W,C*F), cond=(B,H,W,C*Fc))`` and
    its draws (``draw_dsm``), updates the state in place and returns
    ``(state, loss)``, the loss averaged over the data axis."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"dtype={dtype}: the port trains the UNet in float32 only (bf16 params are on "
            "ROADMAP.md)")
    dev = resolve_device(device)
    mesh = mesh or make_mesh(cfg.mesh)
    tx = get_optimizer(cfg)
    schedule = Schedule.from_config(cfg)

    def init_fn(seed: int) -> TrainState:
        model = UNetMoreDDPM(cfg, device="cpu")
        init_params(model, torch.Generator().manual_seed(seed))
        model = model.to(dev)
        params = dict(model.named_parameters())
        opt_state = {k: v if v.dim() == 0 else v.to(dev) for k, v in tx.init(params).items()}
        ema = {n: p.detach().clone() for n, p in params.items()}
        if dist.is_available() and dist.is_initialized():
            ids = None
            if dev.type == "cuda":
                ids = [torch.cuda.current_device() if dev.index is None else dev.index]
            model = DistributedDataParallel(model, device_ids=ids)
        return TrainState(model=model, opt_state=opt_state, ema=ema, step=0)

    def step_fn(state: TrainState, batch: Tensors, labels: torch.Tensor,
                noise: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        params = state.params
        for p in params.values():
            p.grad = None
        with batched_conv_algorithms(batch["x"].shape[0], dev):
            loss = anneal_dsm_score_estimation(
                lambda x, y, c, _mask: state.model(x, y, c), batch["x"], schedule,
                cond=batch["cond"], gamma=cfg.model.gamma, labels=labels, noise=noise)
            loss.backward()
        tx.step_(params, {n: p.grad for n, p in params.items()}, state.opt_state)
        ema_update(state.ema, params, cfg.model.ema_rate)
        state.step += 1
        loss = loss.detach()
        n = mesh.shape[mesh.axis_names[0]]
        if n > 1:
            dist.all_reduce(loss)
            loss = loss / n
        return state, loss

    return init_fn, step_fn


def global_draws(cfg: Config, shape, generator: torch.Generator, mesh: Mesh, device):
    """This process's slice of the draws for the global batch of ``shape``:
    every process draws the same global draws from a generator seeded alike,
    so a step over n processes takes the draws of one process's full batch."""
    labels, noise = draw_dsm(shape, Schedule.from_config(cfg), generator, gamma=cfg.model.gamma)
    return (data_sharding(mesh, labels).to(device), data_sharding(mesh, noise).to(device))


def tiny_train_config() -> Config:
    """Small flagship-shaped config for multi-process dry runs."""
    cfg = Config()
    cfg.data.image_size = 8
    cfg.data.num_frames = 2
    cfg.data.num_frames_cond = 1
    cfg.model.ngf = 16
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (4,)
    cfg.model.n_head_channels = 8
    cfg.model.num_classes = 20
    cfg.optim.warmup = 0
    return cfg


def dryrun_multichip(device="cuda") -> Dict[str, float]:
    """One train step over the processes of the default group (or this one)
    on tiny shapes, then a 3-step DDPM sample with the EMA weights: the train
    and sampler legs of the JAX package's dry run. Its serving leg is
    ``dryrun_serving`` (item A10 of ROADMAP.md)."""
    from tvc_torch.samplers.ancestral import ddpm_sampler

    dev = resolve_device(device)
    cfg = tiny_train_config()
    mesh = make_mesh(cfg.mesh)
    init_fn, step_fn = make_train_step(cfg, mesh, device=dev)
    b = max(mesh.shape[mesh.axis_names[0]] * 2, 2)
    size, c = cfg.data.image_size, cfg.data.channels
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn((b, size, size, c * cfg.data.num_frames), generator=g),
             "cond": torch.randn((b, size, size, c * cfg.data.num_frames_cond), generator=g)}
    batch = {k: data_sharding(mesh, v).to(dev) for k, v in batch.items()}
    state = init_fn(0)
    labels, noise = global_draws(cfg, (b,) + tuple(batch["x"].shape[1:]),
                                 torch.Generator().manual_seed(1), mesh, dev)
    state, loss = step_fn(state, batch, labels, noise)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    model = UNetMoreDDPM(cfg, device=dev)
    model.load_state_dict(state.ema)
    sub = Schedule.from_config(cfg).subsample(3)
    with torch.no_grad():
        out = ddpm_sampler(torch.randn(batch["x"].shape, generator=g).to(dev), model, sub,
                           cond=batch["cond"], generator=torch.Generator(dev).manual_seed(2))
    if not torch.isfinite(out).all():
        raise RuntimeError("non-finite sample from the EMA weights")
    return {"loss": loss, "sample_abs_max": float(out.abs().max())}


def dryrun_serving(mesh: Mesh) -> None:
    """The sharded whole-GOP encode of the JAX package's dry run."""
    raise NotImplementedError(SERVING_REFUSAL)
