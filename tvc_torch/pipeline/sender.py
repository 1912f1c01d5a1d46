"""The sender's predict-and-decide step (counterpart of ``tvc/pipeline/sender.py:37-90``).

The diffusion predictor proposes ``num_frames`` frames from the last
``num_frames_cond`` decoded frames; the longest prefix whose perceptual error
clears the threshold rho (LPIPS <= rho, or PSNR >= rho) is accepted. The
candidate frames are scored in one batched metric call; the prefix walk runs
on the host. The keyframe codec and the GOP loop (``run_gop``) are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.metrics.pixel import psnr
from tvc_torch.pipeline.predictor import FramePredictor


def stack_frames(frames: np.ndarray) -> np.ndarray:
    """(B,F,H,W,C) -> (B,H,W,F*C) frame-major channel stacking (the layout the
    channel-stacked UNet expects)."""
    b, f, h, w, c = frames.shape
    return np.transpose(frames, (0, 2, 3, 1, 4)).reshape(b, h, w, f * c)


@dataclasses.dataclass
class Sender:
    """One (video, quality, threshold) encoding session."""

    threshold: float
    cfg: Config
    predictor: FramePredictor
    lpips: Optional[LPIPSMetric] = None
    use_psnr: bool = False  # PSNR >= rho instead of LPIPS <= rho

    def decide(self, pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Accept the longest prefix of predicted frames within the threshold.
        pred/gt: (1, F, H, W, C) in [0, 1]. Returns the new decision entries
        (zeros: generated) and the accepted frames."""
        b, f = pred.shape[:2]
        if b != 1:
            raise ValueError(f"the accept decision is per video (B=1), got B={b}")
        if self.use_psnr:
            ok = np.asarray([psnr(pred[0, j], gt[0, j]) >= self.threshold for j in range(f)])
        else:
            # the reference feeds [0,1] frames to LPIPS un-rescaled
            d = self.lpips(pred[0], gt[0]).cpu().numpy()
            ok = d <= self.threshold
        n_acc = int(np.argmin(ok)) if not ok.all() else f
        if f > 0 and not ok[0]:
            n_acc = 0
        new_d = np.zeros((1, n_acc), dtype=np.int64)
        new_ge = pred[:, :n_acc] if n_acc else np.zeros((1, 0) + pred.shape[2:])
        return new_d, new_ge

    def update(self, generator: Optional[torch.Generator], x_gt: np.ndarray, x_ge: np.ndarray,
               d: np.ndarray, x_init: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One predict/decide step. x_gt: (1, T, H, W, C) ground truth;
        x_ge: (1, t, H, W, C) decoded so far; d: (1, t) decisions so far.
        ``x_init``/``noise`` replace the generator's draws (see ``FramePredictor.generate``)."""
        idx = x_ge.shape[1]
        frames_gt = x_gt[:, idx: idx + self.cfg.data.num_frames]
        cond = stack_frames(x_ge[:, -self.cfg.data.num_frames_cond:])
        pred = self.predictor.generate(cond, generator=generator, x_init=x_init, noise=noise)
        pred = pred.cpu().numpy()[:, : frames_gt.shape[1]]
        new_d, new_ge = self.decide(pred, frames_gt)
        return np.concatenate([d, new_d], axis=1), np.concatenate([x_ge, new_ge], axis=1)
