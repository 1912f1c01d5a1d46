"""One GOP at a time through ``DeviceGOPRunner``, as ``gop send --device-gop`` codes it.

A unit is one GOP of the traffic's ``frames`` frames at B = 1, a new clip
each unit, with the accept decisions forced to the traffic's
``forced_accepts`` (each prediction is still scored), the streams kept and
the payload written as ``gop send`` writes it (into a temporary directory).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from tvc_torch.cli import write_payload
from tvc_torch.core.runtime import numerics_stamp
from tvc_torch.pipeline.sender import DeviceGOPRunner


def trajectory(frames: int, cond: int, pred: int, forced):
    """(the frame count each update scores, the decisions d) along the forced
    trajectory: an update accepts min(a, k) of its k frames, or for a = 0
    the next pair is coded."""
    count, sizes, d = cond, [], [1] * cond
    for a in forced:
        if count >= frames:
            break
        k = min(pred, frames - count)
        sizes.append(k)
        n = min(a, k) if a > 0 else min(cond, frames - count)
        d += [0 if a > 0 else 1] * n
        count += n
    return sizes, d


class Workload:
    def __init__(self, run):
        self.run = run
        cfg, tr = run.tcfg, run.traffic
        self.frames = int(tr["frames"])
        self.forced = list(tr["forced_accepts"])
        self.runner = DeviceGOPRunner(cfg, run.predictor, lpips=run.lpips,
                                      num_frames_total=self.frames)
        self.stamp = numerics_stamp(run.device, cfg, compute_dtype=run.predictor.dtype)
        self.tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
        self.payload = os.path.join(self.tmp.name, "gop.tvcg")
        self.sizes, self.expected_d = trajectory(self.frames, cfg.data.num_frames_cond,
                                                 cfg.data.num_frames, self.forced)

    def warm(self):
        """The shapes of a unit: one prediction at B = 1 (its first UNet call
        runs eagerly, the second is captured as a CUDA graph, the rest
        replay it), each scored length and one keyframe pair."""
        import torch

        from tvc_torch.pipeline.keyframe import code_frames_device

        run, cfg = self.run, self.run.tcfg
        nc, n_pred = cfg.data.num_frames_cond, cfg.data.num_frames
        clip = run.videos[0][0]
        cond = torch.as_tensor(np.concatenate(list(clip[:nc]), axis=-1)[None], device=run.device)
        gen = torch.Generator(device=run.device).manual_seed(run.unit_seed(-1))
        pred = run.predictor.generate(cond, generator=gen)
        gt = torch.as_tensor(clip[nc: nc + n_pred], device=run.device)
        for k in sorted(set(self.sizes)):
            run.lpips(pred[0, :k].contiguous(), gt[:k]).cpu()
        code_frames_device(run.coder, clip[:nc], cfg.codec.patch, True, return_enc=True)

    def unit(self, k: int) -> dict:
        run, cfg = self.run, self.run.tcfg
        clip = run.videos[k][0]
        gop = self.runner.run(run.coder, clip, run.unit_seed(k), float(run.traffic["threshold"]),
                              patch=cfg.codec.patch, forced_accepts=self.forced,
                              keep_streams=True)
        write_payload(self.payload, gop, run.unit_seed(k), False, self.stamp)
        wrong = int(gop.x_ge.shape[1] != self.frames
                    or [int(v) for v in gop.d[0]] != self.expected_d
                    or gop.n_updates != len(self.forced))
        return {"frames": int(gop.x_ge.shape[1]), "gops": 1, "wrong": wrong}
