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
with the JAX package, from explicit ``(x_init, noise)`` per update.

Three GOP runners share these semantics: ``run_gop`` (numpy state, the
reference loop), ``DeviceGOPRunner`` (the state stays on the device; one
host read per update) and the whole-GOP sender of ``fused_gop.py``.
``rate_sweep`` walks (quality x threshold) points through any of them.

``run_gop`` and ``DeviceGOPRunner`` record spans of ``utils/profiler.py``
(GOP id: the GOP's seed): ``runner.gop``, each ``runner.update`` and
``runner.keyframe`` (a coding event), and ``DeviceGOPRunner``'s
``runner.assemble`` (the final fetch); their seconds are ``GOPResult``'s
``wall_time``, ``update_s`` and ``keyframe_s``. Score reads count as
``reads.score``, the runners' other fetches as ``reads.runner``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.metrics.pixel import psnr, psnr_torch
from tvc_torch.models.codec import container
from tvc_torch.pipeline.keyframe import code_frames_device, code_frames_enc
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.utils import profiler

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
            d = profiler.fetch(self.lpips(pred[0], gt[0]), "score").numpy()
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
        pred = profiler.fetch(pred, "runner").numpy()[:, : frames_gt.shape[1]]
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


def _refuse_simulated_streams(keep_streams: bool, exact: bool) -> None:
    if keep_streams and not exact:
        raise ValueError("keep_streams needs codec.exact_streams: the simulation coder's "
                         "streams are not decodable by a receiver")


def run_gop(sender: Sender, coder, video_gt: np.ndarray, seed: int, num_frames_total: int = 30,
            patch: int = 64, keep_streams: bool = False,
            noise: Optional[NoiseSource] = None) -> GOPResult:
    """Code one video's GOP. ``video_gt``: (T', H, W, C) in [0, 1]; frames
    past ``num_frames_total`` are dropped first, so they bill no bits and are
    never scored. ``keep_streams`` also returns each coding event's container,
    which with ``accepts`` and ``seed`` is all a receiver needs; it needs the
    exact coder (``codec.exact_streams``), whose streams a receiver decodes.
    Without it, ``exact_streams=False`` codes keyframes with the simulation
    coder."""
    exact = sender.cfg.codec.exact_streams
    _refuse_simulated_streams(keep_streams, exact)
    with profiler.timed("runner.gop", gop=seed) as gop_span:
        video_gt = video_gt[:num_frames_total]
        h, w = video_gt.shape[1], video_gt.shape[2]
        nc = sender.cfg.data.num_frames_cond
        containers: List[bytes] = []
        keyframe_s: List[float] = []

        def code(frames):
            with profiler.timed("runner.keyframe", gop=seed) as span:
                dec, bits, enc = code_frames_enc(coder, frames, patch, exact)
                if keep_streams:
                    containers.append(container.serialize(
                        enc, entropy_backend=coder.entropy_backend))
            keyframe_s.append(span.seconds)
            return dec, bits

        dec0, bits0 = code(video_gt[:nc])
        x_ge = dec0[None]
        x_gt = video_gt[None]
        d = np.ones((1, nc), dtype=np.int64)
        bits_list: List[int] = list(bits0)
        accepts: List[int] = []
        update_s: List[float] = []

        while x_ge.shape[1] < num_frames_total:
            with profiler.timed("runner.update", gop=seed) as span:
                gen, x_init, eps = update_draws(seed, len(accepts), sender.predictor.device,
                                                noise)
                prev_len = x_ge.shape[1]
                d, x_ge = sender.update(gen, x_gt, x_ge, d, x_init=x_init, noise=eps)
                accepts.append(int(x_ge.shape[1] - prev_len))
            update_s.append(span.seconds)
            if x_ge.shape[1] == prev_len:  # prediction rejected: code the next pair
                dec, bits = code(video_gt[prev_len: prev_len + nc])
                bits_list.extend(bits)
                x_ge = np.concatenate([x_ge, dec[None]], axis=1)
                d = np.concatenate([d, np.ones((1, dec.shape[0]), dtype=np.int64)], axis=1)

    bits = int(sum(bits_list))
    return GOPResult(d=d[:, :num_frames_total], x_ge=x_ge[:, :num_frames_total], bits=bits,
                     bpp=bits / h / w / num_frames_total, n_updates=len(accepts),
                     wall_time=gop_span.seconds,
                     containers=containers if keep_streams else None, accepts=accepts,
                     keyframe_s=keyframe_s, update_s=update_s)


@dataclasses.dataclass
class RatePoint:
    quality: int
    threshold: float
    bpp: float
    psnr_list: List[float]
    lpips_list: List[float]
    fvd: float
    d: List[int]


def default_thresholds() -> List[float]:
    """The reference's threshold walk: rho = 0.30 down to 0.03 in steps of 0.01."""
    return [round(t, 2) for t in np.arange(0.30, 0.02, -0.01)]


def rate_sweep(cfg: Config, video_gt: np.ndarray, coders: Dict[int, object],
               predictor: FramePredictor, lpips_metric: LPIPSMetric,
               fvd_metric: Optional[Callable] = None, qualities: Sequence[int] = (4, 5),
               thresholds: Optional[Sequence[float]] = None, seed: Optional[int] = None,
               num_frames_total: int = 30, bpp_stop: float = 1.0,
               artifact_cb: Optional[Callable] = None, verbose: bool = True,
               fused=None, device_runner: Optional["DeviceGOPRunner"] = None,
               use_psnr: bool = False,
               noise: Optional[Callable[[int], NoiseSource]] = None) -> List[RatePoint]:
    """The (quality x threshold) sweep over one video. A threshold walk stops
    at its first point with bpp >= ``bpp_stop``.

    Point k of the sweep (counted over every point tried, in order) codes its
    GOP with seed ``update_seed(seed, k)`` (``seed`` defaults to ``cfg.seed``),
    so it equals a ``run_gop`` with that seed; ``noise(k)``, where given,
    replaces the point's draws. The GOP runs through ``fused`` (a
    ``FusedGOPSender``: likelihood bits, one host read per update), through
    ``device_runner`` (a ``DeviceGOPRunner``), or else through ``run_gop``;
    ``use_psnr`` is ``run_gop``'s decision rule, the others carry their own.
    ``artifact_cb(quality, threshold, x_ge)`` is called for every point kept."""
    if thresholds is None:
        thresholds = default_thresholds()
    seed = cfg.seed if seed is None else seed
    points: List[RatePoint] = []
    h, w = video_gt.shape[1], video_gt.shape[2]
    k = 0
    for q in qualities:
        coder = coders[q]
        for rho in thresholds:
            point_seed, src = update_seed(seed, k), noise(k) if noise is not None else None
            k += 1
            if fused is not None:
                t0 = time.perf_counter()
                fo = fused.run(video_gt, point_seed, float(rho), coder=coder, noise=src)
                bits = float(fo["bits"])
                gop = GOPResult(d=fo["d"].cpu().numpy()[None], x_ge=fo["x_ge"].cpu().numpy()[None],
                                bits=int(bits), bpp=bits / h / w / num_frames_total,
                                n_updates=int(fo["n_updates"]),
                                wall_time=time.perf_counter() - t0)
            elif device_runner is not None:
                gop = device_runner.run(coder, video_gt, point_seed, float(rho),
                                        patch=cfg.codec.patch, noise=src)
            else:
                sender = Sender(threshold=rho, cfg=cfg, predictor=predictor, lpips=lpips_metric,
                                use_psnr=use_psnr)
                gop = run_gop(sender, coder, video_gt, point_seed, num_frames_total,
                              cfg.codec.patch, noise=src)
            if gop.bpp >= bpp_stop:
                if verbose:
                    print(f"q={q} rho={rho:.2f}: bpp {gop.bpp:.4f} >= {bpp_stop} "
                          "- stopping threshold walk")
                break
            psnr_list = [psnr(gop.x_ge[0, i], video_gt[i]) for i in range(num_frames_total)]
            lpips_list = [float(v) for v in
                          lpips_metric(gop.x_ge[0], video_gt[:num_frames_total]).cpu().numpy()]
            if fvd_metric is not None:
                # videos repeated twice for a batch of at least 2, as the reference does
                fvd_val = float(fvd_metric(np.repeat(gop.x_ge, 2, axis=0),
                                           np.repeat(video_gt[None, :num_frames_total], 2,
                                                     axis=0)))
            else:
                fvd_val = float("nan")
            d_list = [int(v) for v in gop.d[0]]
            points.append(RatePoint(quality=int(q), threshold=float(rho), bpp=gop.bpp,
                                    psnr_list=psnr_list, lpips_list=lpips_list, fvd=fvd_val,
                                    d=d_list))
            if artifact_cb is not None:
                artifact_cb(int(q), float(rho), gop.x_ge[0])
            if verbose:
                print(f"q={q} rho={rho:.2f}  d: {d_list}")
                print(f"  BPP: {gop.bpp:.5f}  FVD: {fvd_val:.2f}  PSNR: {np.mean(psnr_list):.3f}  "
                      f"LPIPS: {np.mean(lpips_list):.5f}  ({sum(d_list)} transmitted, "
                      f"{gop.n_updates} updates, {gop.wall_time:.1f}s)")
    return points


class DeviceGOPRunner:
    """``run_gop`` with the GOP's state on the predictor's device.

    Predictions stay on the device and feed the next update's conditioning;
    keyframes go through the coder (``code_frames_device``), whose
    reconstruction stays on the device too; the ground truth is uploaded
    once. Per update exactly one value crosses to the host: the scores of
    the candidate frames. The frames are fetched once, at the end.

    Same seed, same trajectory: the runner draws each update's noise as
    ``run_gop`` does and hands ``FramePredictor.generate`` and the metric
    contiguous tensors of the same shapes as ``run_gop``'s, so in LPIPS mode
    its ``d``, accepts, bits, containers and frames are ``run_gop``'s, byte
    for byte, and its payload decodes with ``run_gop_receiver``. In PSNR mode
    it scores with the float32 ``psnr_torch``, as the JAX package's runner
    does, where ``run_gop`` uses the float64 host ``psnr``: a frame within
    float32 rounding of the threshold can be decided differently."""

    def __init__(self, cfg: Config, predictor: FramePredictor,
                 lpips: Optional[LPIPSMetric] = None, use_psnr: bool = False,
                 num_frames_total: int = 30):
        self.cfg = cfg
        self.predictor = predictor
        self.lpips = lpips
        self.use_psnr = use_psnr
        self.T = num_frames_total

    def _scores(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        if self.use_psnr:
            return psnr_torch(pred, gt, dim=(1, 2, 3))
        return self.lpips(pred, gt)

    @torch.no_grad()
    def run(self, coder, video_gt: np.ndarray, seed: int, threshold: float, patch: int = 64,
            forced_accepts: Optional[Sequence[int]] = None, timings: Optional[dict] = None,
            keep_streams: bool = False, noise: Optional[NoiseSource] = None) -> GOPResult:
        """Code one GOP with ``run_gop``'s semantics. ``video_gt``: (T', H, W, C)
        float in [0, 1] or uint8 (converted on the device, a quarter of the
        bytes to upload). ``forced_accepts[u]``, where >= 0, replaces update
        u's decision (clamped to the frames left). ``timings`` collects host
        seconds: ``cycle_fetch`` (update start to scores on the host, per
        update), ``keyframes`` (per coding event), ``assemble`` (the final
        fetch). ``keep_streams`` serializes each coding event's container."""
        cfg, T = self.cfg, self.T
        exact = cfg.codec.exact_streams
        _refuse_simulated_streams(keep_streams, exact)
        nc, n_pred = cfg.data.num_frames_cond, cfg.data.num_frames
        h, w, c = video_gt.shape[1:4]
        dev = self.predictor.device
        containers: List[bytes] = []
        keyframe_s: List[float] = []
        fetch_s: List[float] = []
        uint8 = video_gt.dtype == np.uint8

        def gt_slice(a, b):
            """Host float frames [a, b) for the coder, clamped to the GOP."""
            frames = video_gt[a: min(b, T)]
            return frames.astype(np.float32) / 255.0 if uint8 else np.asarray(frames, np.float32)

        def code(a, b):
            with profiler.timed("runner.keyframe", gop=seed) as span:
                dec, bits, enc = code_frames_device(coder, gt_slice(a, b), patch, exact,
                                                    return_enc=True)
                if keep_streams:
                    containers.append(container.serialize(
                        enc, entropy_backend=coder.entropy_backend))
            keyframe_s.append(span.seconds)
            return dec[None].to(dev), bits

        with profiler.timed("runner.gop", gop=seed) as gop_span:
            chunk, bits0 = code(0, nc)  # dispatched before the ground truth's upload
            if uint8:
                # a 0-dim device divisor: an exact division, as numpy's on the host
                gt_dev = (profiler.upload(video_gt[:T], dev).float()
                          / torch.full((), 255.0, device=dev))
            else:
                gt_dev = profiler.upload(np.asarray(video_gt[:T], np.float32), dev)
            chunks = [chunk]
            cond2 = chunk[:, -nc:]
            d: List[int] = [1] * nc
            bits_list: List[int] = list(bits0)
            accepts: List[int] = []
            update_s: List[float] = []
            count = nc
            while count < T:
                with profiler.timed("runner.update", gop=seed) as span:
                    gen, x_init, eps = update_draws(seed, len(accepts), dev, noise)
                    k = min(n_pred, T - count)
                    cond = cond2.permute(0, 2, 3, 1, 4).reshape(1, h, w, nc * c).contiguous()
                    pred = self.predictor.generate(cond, generator=gen, x_init=x_init,
                                                   noise=eps)
                    scores = self._scores(pred[0, :k].contiguous(), gt_dev[count: count + k])
                    s = profiler.fetch(scores, "score").numpy()  # the update's one read
                    fetch_s.append((time.perf_counter_ns() - span.t0) / 1e9)
                    ok = (s >= threshold) if self.use_psnr else (s <= threshold)
                    n_acc = k if ok.all() else int(np.argmin(ok))
                    u = len(accepts)
                    if (forced_accepts is not None and u < len(forced_accepts)
                            and forced_accepts[u] >= 0):
                        n_acc = min(int(forced_accepts[u]), k)
                    accepts.append(n_acc)
                    if n_acc == 0:
                        chunk, bits = code(count, count + nc)
                        bits_list.extend(bits)
                        d.extend([1] * chunk.shape[1])
                    else:
                        chunk = pred[:, :n_acc]
                        d.extend([0] * n_acc)
                    chunks.append(chunk)
                    count += chunk.shape[1]
                    cond2 = torch.cat([cond2, chunk], dim=1)[:, -nc:]
                update_s.append(span.seconds)

            with profiler.timed("runner.assemble", gop=seed) as asm:
                x_ge = profiler.fetch(torch.cat(chunks, dim=1)[:, :T], "runner").numpy()
        if timings is not None:
            timings.setdefault("keyframes", []).extend(keyframe_s)
            timings.setdefault("cycle_fetch", []).extend(fetch_s)
            timings["assemble"] = asm.seconds
        bits = int(sum(bits_list))
        return GOPResult(d=np.asarray(d, np.int64)[None][:, :T], x_ge=x_ge, bits=bits,
                         bpp=bits / h / w / T, n_updates=len(accepts),
                         wall_time=gop_span.seconds,
                         containers=containers if keep_streams else None, accepts=accepts,
                         keyframe_s=keyframe_s, update_s=update_s)
