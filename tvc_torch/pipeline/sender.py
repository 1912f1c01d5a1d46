"""The sender: predict, accept a prefix, or fall back to a coded pair
(counterpart of ``tvc/pipeline/sender.py:37-178``).

A GOP starts with ``num_frames_cond`` frames coded by the ELIC keyframe codec.
Then the diffusion predictor proposes ``num_frames`` frames from the last
``num_frames_cond`` decoded frames, and the longest prefix whose perceptual
error clears the threshold rho (LPIPS <= rho, or PSNR >= rho) is accepted; if
none is, the next ``num_frames_cond`` ground-truth frames are coded. The
candidate frames are scored in one batched metric call; the prefix walk runs
on the host.

Each update's noise comes from a ``torch.Generator`` seeded by
``update_seed(seed, update)``, which the receiver uses too; or, for parity
with the JAX package, from explicit ``(x_init, noise)`` per update. The
device-resident GOP runner and the rate sweep are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.metrics.pixel import psnr
from tvc_torch.models.codec import container
from tvc_torch.pipeline.keyframe import code_frames_enc
from tvc_torch.pipeline.predictor import FramePredictor

# update index -> (x_init, noise) of that update's prediction (see FramePredictor.generate)
NoiseSource = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


def update_seed(seed: int, update: int) -> int:
    """The generator seed of update ``update`` of a GOP coded with ``seed``;
    the sender and the receiver both draw from it."""
    return (seed * 1_000_003 + update) % (1 << 63)


def update_draws(seed: int, update: int, device, noise: Optional[NoiseSource]):
    """(generator, x_init, noise) for one update's ``FramePredictor.generate``."""
    if noise is not None:
        x_init, eps = noise(update)
        return None, x_init, eps
    gen = torch.Generator(device=device).manual_seed(update_seed(seed, update))
    return gen, None, None


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
        new_ge = pred[:, :n_acc] if n_acc else np.zeros((1, 0) + pred.shape[2:], pred.dtype)
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


@dataclasses.dataclass
class GOPResult:
    d: np.ndarray            # (1, T) decisions: 1 = transmitted, 0 = generated
    x_ge: np.ndarray         # (1, T, H, W, C) decoded frames
    bits: int                # total transmitted bits
    bpp: float
    n_updates: int
    wall_time: float
    # one serialized TVC2 container per keyframe coding event (keep_streams=True),
    # in order: the first pair, then each fallback pair
    containers: Optional[List[bytes]] = None
    # frames accepted by each update (0: a fallback pair followed); with the
    # containers and the seed this determines the receiver's frames (d alone
    # does not: consecutive zeros in d can span several updates)
    accepts: Optional[List[int]] = None
    keyframe_s: Optional[List[float]] = None  # host wall time of each coding event
    update_s: Optional[List[float]] = None    # host wall time of each update


def run_gop(sender: Sender, coder, video_gt: np.ndarray, seed: int, num_frames_total: int = 30,
            patch: int = 64, keep_streams: bool = False,
            noise: Optional[NoiseSource] = None) -> GOPResult:
    """Code one video's GOP. ``video_gt``: (T', H, W, C) in [0, 1]; frames
    past ``num_frames_total`` are dropped first, so they bill no bits and are
    never scored. ``keep_streams`` also returns each coding event's container,
    which with ``accepts`` and ``seed`` is all a receiver needs."""
    if not keep_streams and not sender.cfg.codec.exact_streams:
        raise NotImplementedError("codec.exact_streams=False (the fused simulation path of the "
                                  "rate sweep) is not ported yet (ROADMAP.md)")
    t0 = time.perf_counter()
    video_gt = video_gt[:num_frames_total]
    h, w = video_gt.shape[1], video_gt.shape[2]
    nc = sender.cfg.data.num_frames_cond
    containers: List[bytes] = []
    keyframe_s: List[float] = []

    def code(frames):
        tk = time.perf_counter()
        dec, bits, enc = code_frames_enc(coder, frames, patch)
        if keep_streams:
            containers.append(container.serialize(enc, entropy_backend=coder.entropy_backend))
        keyframe_s.append(time.perf_counter() - tk)
        return dec, bits

    dec0, bits0 = code(video_gt[:nc])
    x_ge = dec0[None]
    x_gt = video_gt[None]
    d = np.ones((1, nc), dtype=np.int64)
    bits_list: List[int] = list(bits0)
    accepts: List[int] = []
    update_s: List[float] = []

    while x_ge.shape[1] < num_frames_total:
        tu = time.perf_counter()
        gen, x_init, eps = update_draws(seed, len(accepts), sender.predictor.device, noise)
        prev_len = x_ge.shape[1]
        d, x_ge = sender.update(gen, x_gt, x_ge, d, x_init=x_init, noise=eps)
        accepts.append(int(x_ge.shape[1] - prev_len))
        update_s.append(time.perf_counter() - tu)
        if x_ge.shape[1] == prev_len:  # prediction rejected: code the next pair
            dec, bits = code(video_gt[prev_len: prev_len + nc])
            bits_list.extend(bits)
            x_ge = np.concatenate([x_ge, dec[None]], axis=1)
            d = np.concatenate([d, np.ones((1, dec.shape[0]), dtype=np.int64)], axis=1)

    bits = int(sum(bits_list))
    return GOPResult(d=d[:, :num_frames_total], x_ge=x_ge[:, :num_frames_total], bits=bits,
                     bpp=bits / h / w / num_frames_total, n_updates=len(accepts),
                     wall_time=time.perf_counter() - t0,
                     containers=containers if keep_streams else None, accepts=accepts,
                     keyframe_s=keyframe_s, update_s=update_s)


def rate_sweep(*args, **kwargs):
    raise NotImplementedError("rate_sweep is not ported yet (ROADMAP.md)")


class DeviceGOPRunner:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("DeviceGOPRunner is not ported yet (ROADMAP.md)")
