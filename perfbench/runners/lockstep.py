"""Lockstep batches of GOP chains through ``BatchedGOPRunner``, as ``sweep --batched`` runs them.

A unit is one ``run_walks`` call over ``chains`` single-job walks (a new
clip each, one quality, the traffic's LPIPS threshold, no bpp stop) at the
runner's ``batch``: every chain's first pair coded in one keyframe batch,
then lockstep sweeps, each one batched prediction, each chain's frames
scored and decided on the host, fallbacks coded per quality.
"""

from __future__ import annotations

import numpy as np

from tvc_torch.pipeline.batched import BatchedGOPRunner, GOPJob


def score_sizes(frames: int, cond: int, pred: int):
    """The frame counts each sweep scores when every prediction is accepted."""
    count, sizes = cond, []
    while count < frames:
        k = min(pred, frames - count)
        sizes.append(k)
        count += k
    return sizes


class Workload:
    def __init__(self, run):
        self.run = run
        tr = run.traffic
        self.frames = int(tr["frames"])
        self.quality = int(tr["quality"])
        self.batch = int(tr["batch"])
        self.runner = BatchedGOPRunner(run.tcfg, run.predictor, {self.quality: run.coder},
                                       lpips=run.lpips, batch_size=self.batch)

    def jobs(self, k: int):
        return [[GOPJob(video=clip, threshold=float(self.run.traffic["threshold"]),
                        quality=self.quality, num_frames_total=self.frames)]
                for clip in self.run.videos[k]]

    def warm(self):
        """The shapes of a unit: one prediction at the batch (its first UNet
        call runs eagerly and lets cuDNN time its algorithms, the second is
        captured), each scored length and one keyframe batch of every
        chain's first pair."""
        from tvc_torch.pipeline.keyframe import code_frames
        from tvc_torch.pipeline.sender import stack_frames

        run, cfg = self.run, self.run.tcfg
        nc, n_pred = cfg.data.num_frames_cond, cfg.data.num_frames
        clips = run.videos[0]
        conds = np.concatenate([stack_frames(c[None, :nc]) for c in clips], axis=0)
        import torch

        gen = torch.Generator(device=run.device).manual_seed(run.unit_seed(-1))
        preds = run.predictor.generate(conds, generator=gen).cpu().numpy()
        for k in sorted(set(score_sizes(self.frames, nc, n_pred))):
            run.lpips(preds[0, :k], clips[0][nc: nc + k]).cpu()
        code_frames(run.coder, np.concatenate([c[:nc] for c in clips], axis=0),
                    cfg.codec.patch, exact=True)

    def unit(self, k: int) -> dict:
        run = self.run
        results, stats = self.runner.run_walks(self.jobs(k), run.unit_seed(k),
                                               patch=run.tcfg.codec.patch, bpp_stop=None)
        gops = [w[0] for w in results]
        wrong = sum(int(g is None or g.x_ge.shape[1] != self.frames
                        or int(np.sum(g.d[0])) != run.tcfg.data.num_frames_cond) for g in gops)
        return {"frames": sum(0 if g is None else int(g.x_ge.shape[1]) for g in gops),
                "gops": len(gops), "wrong": wrong}
