"""Lockstep-batched GOP chains: many (video, quality, threshold) jobs per card
(counterpart of ``tvc/pipeline/batched.py``).

A GOP chain is serial, but chains are independent, so the runner steps up to
``batch_size`` of them together: one batched prediction for every active
chain, the accept decision per chain, and each quality's fallback keyframes
coded in one batch through that quality's coder. The prediction batch is
always padded to ``batch_size``, which fixes the attention kernel's launch
plan and the noise's shape. Finished chains leave the batch and their slots
are backfilled.

Sweep s of a run draws its noise from a generator seeded by
``update_seed(seed, s)`` (the padded slots draw too), or from ``noise(s)``.
A chain's frames depend on the batch it ran in (the UNet's kernels differ
with the batch size), so they are not ``run_gop``'s frames; a rerun of the
same jobs gives the same frames.

``run_walks`` records spans of ``utils/profiler.py``: ``runner.walks`` (the
call), ``runner.backfill`` (new chains and their first pairs' coding),
``runner.sweep`` (the conditioning, the draws, the prediction and its
fetch), ``runner.decide`` (one chain's scoring and decision) and
``runner.fallback`` (a quality's fallback pairs). A span's GOP is the job's
index counted over the walks in order, a list of them for a span over
several chains. The prediction's fetch counts as ``reads.runner``, each
chain's score read as ``reads.score``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.metrics.pixel import psnr
from tvc_torch.pipeline.keyframe import code_frames
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.sender import GOPResult, NoiseSource, stack_frames, update_draws
from tvc_torch.utils import profiler


@dataclasses.dataclass
class GOPJob:
    video: np.ndarray          # (T, H, W, C) ground truth in [0, 1]
    threshold: float
    quality: int
    use_psnr: bool = False
    num_frames_total: int = 30


@dataclasses.dataclass
class _ChainState:
    job: GOPJob
    x_ge: np.ndarray           # (t, H, W, C) decoded so far
    d: List[int]
    bits: int
    n_updates: int = 0
    done: bool = False


class BatchedGOPRunner:
    """Runs lists of ``GOPJob`` with batched predictions."""

    def __init__(self, cfg: Config, predictor: FramePredictor, coders: Dict[int, object],
                 lpips: Optional[LPIPSMetric] = None, batch_size: int = 8):
        self.cfg = cfg
        self.predictor = predictor
        self.coders = coders
        self.lpips = lpips
        self.batch_size = batch_size

    def _decide(self, st: _ChainState, pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
        """The longest acceptable prefix of ``pred``, scored in one metric call."""
        f = gt.shape[0]
        if f == 0:
            return np.zeros((0,) + pred.shape[1:], pred.dtype)
        if st.job.use_psnr:
            ok = np.asarray([psnr(pred[j], gt[j]) >= st.job.threshold for j in range(f)])
        else:
            ok = profiler.fetch(self.lpips(pred[:f], gt), "score").numpy() <= st.job.threshold
        n_acc = f if ok.all() else int(np.argmin(ok))
        return pred[:n_acc] if n_acc else np.zeros((0,) + pred.shape[1:], pred.dtype)

    def run(self, jobs: Sequence[GOPJob], seed: int, patch: int = 64,
            noise: Optional[NoiseSource] = None) -> List[GOPResult]:
        """Independent jobs, each its own one-point walk."""
        results, _ = self.run_walks([[j] for j in jobs], seed, patch=patch, bpp_stop=None,
                                    noise=noise)
        return [w[0] for w in results]

    def run_walks(self, walks: Sequence[Sequence[GOPJob]], seed: int, patch: int = 64,
                  bpp_stop: Optional[float] = 1.0, noise: Optional[NoiseSource] = None):
        """Threshold walks with the reference's early stop: each walk is a list
        of jobs sharing (video, quality), least-transmitting threshold first.
        A walk's next job starts when the previous one finishes, and a job
        that ends at bpp >= ``bpp_stop`` retires the rest of its walk (a
        stricter threshold only transmits more). Freed slots are backfilled
        from the walks that are ready.

        Returns (results, stats): results[w][j] is a ``GOPResult``, or None
        where walk w retired before job j; stats counts the lockstep sweeps
        and the jobs run and skipped."""
        cfg = self.cfg
        nc, n_pred = cfg.data.num_frames_cond, cfg.data.num_frames
        for walk in walks:
            for job in walk:
                if job.video.shape[0] < job.num_frames_total:
                    raise ValueError("video shorter than num_frames_total: the chain "
                                     "cannot end")
            if bpp_stop is not None and len(walk) > 1:
                # the stop is sound only if transmission never falls along the
                # walk: LPIPS accepts d <= rho (walk rho down), PSNR psnr >= rho (up)
                thr = [j.threshold for j in walk]
                pairs = list(zip(thr, thr[1:]))
                ordered = (all(a >= b for a, b in pairs) if not walk[0].use_psnr
                           else all(a <= b for a, b in pairs))
                if not ordered:
                    raise ValueError(
                        "walk thresholds must be ordered least-transmitting first (LPIPS: "
                        f"descending; PSNR: ascending) for the bpp early stop to be sound; "
                        f"got {thr} (use_psnr={walk[0].use_psnr})")
        t0 = time.perf_counter()
        B = self.batch_size
        size, c = cfg.data.image_size, cfg.data.channels
        # a job's GOP id in the spans: its index counted over the walks in order
        ids, n_jobs = [], 0
        for walk in walks:
            ids.append(list(range(n_jobs, n_jobs + len(walk))))
            n_jobs += len(walk)

        results: List[List[Optional[GOPResult]]] = [[None] * len(w) for w in walks]
        ready = [(w, 0) for w in range(len(walks)) if walks[w]]
        active: List[tuple] = []  # (w, j, _ChainState)
        sweeps = started = skipped = 0

        # the GOP ids of a span over several chains, read only while recording
        def starting():
            return [ids[w][j] for w, j in starts]

        def stepping():
            return [ids[w][j] for w, j, _ in active]

        def falling():
            return [ids[active[s][0]][active[s][1]] for s in slots]

        def finish(w: int, j: int, st: _ChainState):
            nonlocal skipped
            n = st.job.num_frames_total
            h, wd = st.job.video.shape[1:3]
            bpp = st.bits / h / wd / n
            results[w][j] = GOPResult(d=np.asarray(st.d[:n])[None], x_ge=st.x_ge[:n][None],
                                      bits=st.bits, bpp=bpp, n_updates=st.n_updates,
                                      wall_time=time.perf_counter() - t0)
            if bpp_stop is not None and bpp >= bpp_stop:
                skipped += len(walks[w]) - (j + 1)  # retire the walk
            elif j + 1 < len(walks[w]):
                ready.append((w, j + 1))

        with profiler.span("runner.walks"):
            while ready or active:
                # backfill free slots; code the new chains' first pairs per quality
                starts = []
                while len(active) + len(starts) < B and ready:
                    starts.append(ready.pop(0))
                if starts:
                    with profiler.span("runner.backfill", gop=starting):
                        started += len(starts)
                        by_q: Dict[int, List[int]] = {}
                        for k, (w, j) in enumerate(starts):
                            by_q.setdefault(walks[w][j].quality, []).append(k)
                        for q, ks in by_q.items():
                            frames = np.concatenate([walks[starts[k][0]][starts[k][1]].video[:nc]
                                                     for k in ks], axis=0)
                            dec, bits = code_frames(self.coders[q], frames, patch,
                                                    exact=cfg.codec.exact_streams)
                            for slot, k in enumerate(ks):
                                w, j = starts[k]
                                st = _ChainState(job=walks[w][j],
                                                 x_ge=dec[slot * nc: (slot + 1) * nc],
                                                 d=[1] * nc,
                                                 bits=sum(bits[slot * nc: (slot + 1) * nc]))
                                if st.x_ge.shape[0] >= st.job.num_frames_total:
                                    finish(w, j, st)
                                else:
                                    active.append((w, j, st))
                if not active:
                    continue  # every fresh start finished on its keyframes

                # one prediction for every active chain, padded to B
                with profiler.span("runner.sweep", gop=stepping):
                    conds = np.zeros((B, size, size, c * nc), np.float32)
                    for slot, (_, _, st) in enumerate(active):
                        conds[slot] = stack_frames(st.x_ge[None, -nc:])[0]
                    gen, x_init, eps = update_draws(seed, sweeps, self.predictor.device, noise)
                    preds = profiler.fetch(self.predictor.generate(
                        conds, generator=gen, x_init=x_init, noise=eps), "runner").numpy()
                sweeps += 1

                fallback: Dict[int, List[int]] = {}
                for slot, (w, j, st) in enumerate(active):
                    with profiler.span("runner.decide", gop=ids[w][j]):
                        idx = st.x_ge.shape[0]
                        # only frames inside the GOP are scored
                        gt = st.job.video[idx: min(idx + n_pred, st.job.num_frames_total)]
                        acc = self._decide(st, preds[slot, : gt.shape[0]], gt)
                        st.n_updates += 1
                        if acc.shape[0] > 0:
                            st.x_ge = np.concatenate([st.x_ge, acc], axis=0)
                            st.d.extend([0] * acc.shape[0])
                        else:
                            fallback.setdefault(st.job.quality, []).append(slot)
                        if st.x_ge.shape[0] >= st.job.num_frames_total:
                            st.done = True

                # Fallback pairs, batched per quality. A chain at its video's end
                # codes fewer than nc frames (the slice is clamped to the GOP), so
                # each chain's offsets follow the lengths of the chunks.
                for q, slots in fallback.items():
                    with profiler.span("runner.fallback", gop=falling):
                        chunks = []
                        for s in slots:
                            st = active[s][2]
                            n = st.x_ge.shape[0]
                            chunks.append(st.job.video[n: min(n + nc, st.job.num_frames_total)])
                        offs = np.concatenate([[0], np.cumsum([ch.shape[0] for ch in chunks])])
                        dec, bits = code_frames(self.coders[q], np.concatenate(chunks, axis=0),
                                                patch, exact=cfg.codec.exact_streams)
                        for k, s in enumerate(slots):
                            st = active[s][2]
                            lo, hi = offs[k], offs[k + 1]
                            st.x_ge = np.concatenate([st.x_ge, dec[lo:hi]], axis=0)
                            st.d.extend([1] * (hi - lo))
                            st.bits += sum(bits[lo:hi])
                            if st.x_ge.shape[0] >= st.job.num_frames_total:
                                st.done = True

                still = []
                for (w, j, st) in active:
                    if st.done:
                        finish(w, j, st)
                    else:
                        still.append((w, j, st))
                active = still

        stats = {"sweeps": sweeps, "jobs_run": started, "jobs_skipped": skipped}
        return results, stats
