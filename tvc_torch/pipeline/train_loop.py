"""The DSM training loop (counterpart of ``tvc/pipeline/train_loop.py``).

DSM loss, optax-exact optimizer with warmup and clipping, EMA, periodic npz
snapshots, over the train step of ``tvc_torch/parallel/train.py``, so the
same loop runs in one process or in each process of a group (each takes its
slice of every global batch).

Data: a (B, T, H, W, C) [0, 1] array (``load_dataset`` of a (B, T, C, H, W)
npy); each step samples random clips of num_frames_cond + num_frames
consecutive frames from a ``np.random.RandomState``, the same clips as the
JAX package's loop. The DSM draws come from a ``torch.Generator`` on the
device, seeded from ``cfg.seed`` (``cfg.seed + start_step`` on resume),
where the JAX package splits a key: every process draws the global batch's
draws alike (cards of one kind give the same draws) and keeps its slice.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.core.runtime import resolve_device
from tvc_torch.parallel.mesh import data_sharding, make_mesh
from tvc_torch.parallel.train import global_draws, make_train_step
from tvc_torch.pipeline.sender import stack_frames
from tvc_torch.pipeline.transforms import data_transform
from tvc_torch.utils.checkpoint_io import load_train_state, save_train_state


def clip_batches(data: np.ndarray, cfg: Config, batch_size: int,
                 rng: np.random.RandomState) -> Iterator[Dict[str, np.ndarray]]:
    """Random (cond, target) clip batches from (B,T,H,W,C) [0,1] videos."""
    nc = cfg.data.num_frames_cond
    nf = cfg.data.num_frames
    span = nc + nf
    n_videos, t = data.shape[:2]
    if t < span:
        raise ValueError(f"videos of {t} frames are shorter than a clip of {span}")
    while True:
        vid = rng.randint(0, n_videos, batch_size)
        start = rng.randint(0, t - span + 1, batch_size)
        clips = np.stack([data[v, s: s + span] for v, s in zip(vid, start)])
        cond = stack_frames(clips[:, :nc])
        x = stack_frames(clips[:, nc:])
        yield {"x": x.astype(np.float32), "cond": cond.astype(np.float32)}


def train(
    cfg: Config,
    data: np.ndarray,
    num_steps: int = 1000,
    batch_size: int = 8,
    snapshot_freq: int = 500,
    log_freq: int = 50,
    out_dir: Optional[str] = None,
    dtype=torch.float32,
    resume_from: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    """Run DSM training on ``device``; returns final metrics. data: (B,T,H,W,C) in [0,1].

    resume_from: a snapshot path prefix written by a previous run of this
    loop or of the JAX package's (e.g. ``out/ckpt_500``); restores
    params/EMA/optimizer/step and continues until ``num_steps`` total."""
    dev = resolve_device(device)
    mesh = make_mesh(cfg.mesh)
    dp = mesh.shape[cfg.mesh.data_axis]
    if batch_size % dp != 0:
        batch_size = max((batch_size // dp), 1) * dp if batch_size >= dp else dp
        print(f"[train] batch_size rounded to {batch_size} (data axis = {dp})")
    init_fn, step_fn = make_train_step(cfg, mesh, dtype=dtype, device=dev)
    batches = clip_batches(data, cfg, batch_size, np.random.RandomState(cfg.seed))
    next(batches)  # the JAX package's init traces the first batch; it is not trained on
    state = init_fn(cfg.seed)
    start_step = 0
    if resume_from:
        # older snapshots may lack the .opt.npz member; resume with a fresh
        # optimizer state in that case (params/EMA still restored)
        has_opt = os.path.exists(resume_from + ".opt.npz")
        params, ema, start_step, opt = load_train_state(
            resume_from, state.params, state.ema, state.opt_state if has_opt else None, cfg)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(params[n])
        state.ema = ema
        if has_opt:
            state.opt_state = opt
        state.step = start_step
        # decorrelate the clip stream and the noise from the first run
        batches = clip_batches(data, cfg, batch_size,
                               np.random.RandomState(cfg.seed + start_step))
        print(f"[train] resumed from {resume_from} at step {start_step}")
    generator = torch.Generator(dev).manual_seed(cfg.seed + start_step)

    def snapshot(name: str, step: int) -> None:
        if mesh.rank == 0:
            t = time.time()
            save_train_state(os.path.join(out_dir, name), state.params, state.ema, step,
                             opt_state=state.opt_state)
            print(f"[train] snapshot {name} written in {time.time() - t:.3f} s", flush=True)

    loss = torch.tensor(float("nan"))
    t0 = time.time()
    for step in range(start_step, num_steps):
        batch = {k: data_transform(cfg, data_sharding(mesh, torch.from_numpy(v)).to(dev))
                 for k, v in next(batches).items()}
        labels, noise = global_draws(cfg, (batch_size,) + tuple(batch["x"].shape[1:]),
                                     generator, mesh, dev)
        state, loss = step_fn(state, batch, labels, noise)
        if (step + 1) % log_freq == 0 or step == 0:
            print(f"step {step + 1}/{num_steps} loss {float(loss):.4f} "
                  f"({(time.time() - t0) / (step + 1 - start_step):.3f}"
                  "s/step)", flush=True)
        if out_dir and (step + 1) % snapshot_freq == 0:
            snapshot(f"ckpt_{step + 1}", step + 1)
    final_loss = float(loss)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        snapshot("ckpt_final", num_steps)
    return {"final_loss": final_loss, "steps": num_steps, "wall_time": time.time() - t0}
