"""The sweep driver (counterpart of ``tvc/pipeline/driver.py``).

Load a dataset npy ((B, T, C, H, W) in [0, 255]); for each video run the
(quality x threshold) rate sweep; convex-hull its RD points; write the points,
the envelopes as npy files and the plots under ``output_{vid}``, and the run's
config (with its provenance) as ``config.yml``.

With ``with_fvd`` (the default) each point's FVD is computed on the
predictor's device by an ``FVDMetric`` (built on seeded random I3D weights
where none is given), between the decoded GOP and the ground truth, each
repeated to a batch of two.

Several processes split the work statically with ``partition_work``
(``run_sweep_batched``), or pull (video, quality) units from a work queue on
a shared filesystem (``run_sweep_queued``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from tvc_torch.core.config import Config, save_config
from tvc_torch.metrics.fvd import FVDMetric
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.metrics.pixel import psnr
from tvc_torch.metrics.rd import process_data_and_save
from tvc_torch.parallel.mesh import partition_work
from tvc_torch.parallel.queue import WorkQueue
from tvc_torch.pipeline.batched import BatchedGOPRunner, GOPJob
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.sender import RatePoint, default_thresholds, rate_sweep
from tvc_torch.utils.plotting import plot

HEARTBEAT_S = 60.0  # the claim's renewal period while a unit runs


def load_dataset(path: str) -> np.ndarray:
    """A (B, T, C, H, W) npy in [0, 255] -> (B, T, H, W, C) float32 in [0, 1]."""
    arr = np.load(path) / 255.0
    return np.transpose(arr, (0, 1, 3, 4, 2)).astype(np.float32)


def save_output_strip(gt: np.ndarray, xge: np.ndarray, q: int, thr: float, idx: int,
                      output_dir: str) -> None:
    """The ground truth over the decoded frames as one strip: an npy, and a
    PNG where matplotlib is installed."""
    os.makedirs(output_dir, exist_ok=True)
    strip = np.concatenate([np.concatenate(list(v), axis=1) for v in (gt, xge)], axis=0)
    np.save(os.path.join(output_dir, f"city_output_npy_idx{idx}_q{q}_thr{thr:.2f}.npy"), strip)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(os.path.join(output_dir, f"city_idx{idx}_q{q}_thr{thr:.2f}.png"),
                   np.clip(strip, 0, 1))
    except ImportError:
        pass


def _gop_frames(data: np.ndarray) -> int:
    return min(30, data.shape[1])


def _fvd(with_fvd: bool, fvd_metric: Optional[Callable],
         predictor: FramePredictor) -> Optional[Callable]:
    """The sweep's FVD metric: the one given, else a seeded random-weight
    ``FVDMetric`` on the predictor's device; None without ``with_fvd``."""
    if not with_fvd:
        return None
    return fvd_metric if fvd_metric is not None else FVDMetric(device=predictor.device)


def run_sweep_batched(cfg: Config, data: np.ndarray, coders: Dict[int, object],
                      predictor: FramePredictor, output_path: str, start_idx: int = 0,
                      end_idx: int = 0, qualities: Sequence[int] = (4, 5),
                      thresholds: Optional[Sequence[float]] = None, batch_size: int = 8,
                      with_fvd: bool = True, lpips_metric: Optional[LPIPSMetric] = None,
                      fvd_metric: Optional[Callable] = None, bpp_stop: float = 1.0,
                      num_processes: int = 1, process_id: int = 0,
                      provenance: Optional[dict] = None,
                      use_psnr: bool = False) -> Dict[int, List[RatePoint]]:
    """Every (video, quality, threshold) job as a lockstep-batched GOP chain,
    organised as threshold walks per (video, quality), least-transmitting
    threshold first, that retire at their first point with bpp >= ``bpp_stop``.
    The walks (a walk's jobs depend on each other) are split across processes."""
    thresholds = sorted(default_thresholds() if thresholds is None else thresholds,
                        reverse=not use_psnr)
    lpips_metric = lpips_metric or LPIPSMetric.create(device=predictor.device)
    fvd_metric = _fvd(with_fvd, fvd_metric, predictor)
    walks_meta = partition_work([(vid, int(q)) for vid in range(start_idx, end_idx + 1)
                                 for q in qualities], num_processes, process_id)
    n_frames = _gop_frames(data)
    walks = [[GOPJob(video=data[vid], threshold=float(rho), quality=q,
                     num_frames_total=n_frames, use_psnr=use_psnr) for rho in thresholds]
             for vid, q in walks_meta]
    runner = BatchedGOPRunner(cfg, predictor, coders, lpips=lpips_metric, batch_size=batch_size)
    results, stats = runner.run_walks(walks, cfg.seed, patch=cfg.codec.patch, bpp_stop=bpp_stop)
    print(f"[batched] {stats['sweeps']} sampler sweeps for {stats['jobs_run']} rate points "
          f"({stats['jobs_skipped']} retired early at bpp>={bpp_stop})")

    per_video: Dict[int, List[RatePoint]] = {}
    for w, (vid, q) in enumerate(walks_meta):
        for j, gop in enumerate(results[w]):
            if gop is None or gop.bpp >= bpp_stop:
                continue
            video_gt = data[vid]
            psnr_list = [float(np.round(psnr(gop.x_ge[0, i], video_gt[i]), 10))
                         for i in range(n_frames)]
            lpips_list = [float(v) for v in
                          lpips_metric(gop.x_ge[0], video_gt[:n_frames]).cpu().numpy()]
            fvd_val = (float(fvd_metric(np.repeat(gop.x_ge, 2, 0),
                                        np.repeat(video_gt[None, :n_frames], 2, 0)))
                       if fvd_metric is not None else float("nan"))
            per_video.setdefault(vid, []).append(RatePoint(
                quality=q, threshold=walks[w][j].threshold, bpp=gop.bpp, psnr_list=psnr_list,
                lpips_list=lpips_list, fvd=fvd_val, d=[int(v) for v in gop.d[0]]))

    os.makedirs(output_path, exist_ok=True)
    save_config(cfg, os.path.join(output_path, "config.yml"),
                extra={"provenance": provenance} if provenance else None)
    for vid, points in per_video.items():
        persist_rd_results(vid, points, os.path.join(output_path, f"output_{vid}"))
    return per_video


def run_sweep(cfg: Config, data: np.ndarray, coders: Dict[int, object],
              predictor: FramePredictor, output_path: str, start_idx: int = 0, end_idx: int = 0,
              qualities: Sequence[int] = (4, 5), thresholds: Optional[Sequence[float]] = None,
              with_fvd: bool = True, lpips_metric: Optional[LPIPSMetric] = None,
              fvd_metric: Optional[Callable] = None,
              save_artifacts: bool = True, bench_264: Optional[str] = None,
              bench_265: Optional[str] = None, fused_gop: bool = False,
              device_gop: bool = False, provenance: Optional[dict] = None,
              use_psnr: bool = False) -> Dict[int, List[RatePoint]]:
    """Sweep videos [start_idx, end_idx] one GOP at a time; returns each
    video's rate points. Video v's sweep is seeded with ``cfg.seed + v``.
    ``fused_gop`` runs every GOP through the whole-GOP sender (likelihood
    bits), ``device_gop`` through ``DeviceGOPRunner`` (exact streams), and
    otherwise through ``run_gop``."""
    os.makedirs(output_path, exist_ok=True)
    save_config(cfg, os.path.join(output_path, "config.yml"),
                extra={"provenance": provenance} if provenance else None)
    lpips_metric = lpips_metric or LPIPSMetric.create(device=predictor.device)
    fvd_metric = _fvd(with_fvd, fvd_metric, predictor)
    n_frames = _gop_frames(data)
    fused = device_runner = None
    if fused_gop:
        from tvc_torch.pipeline.fused_gop import FusedGOPSender

        fused = FusedGOPSender(cfg=cfg, predictor=predictor, coder=coders[list(qualities)[0]],
                               lpips=lpips_metric, num_frames_total=n_frames, use_psnr=use_psnr)
    elif device_gop:
        from tvc_torch.pipeline.sender import DeviceGOPRunner

        device_runner = DeviceGOPRunner(cfg, predictor, lpips=lpips_metric, use_psnr=use_psnr,
                                        num_frames_total=n_frames)

    results: Dict[int, List[RatePoint]] = {}
    for vid in range(start_idx, end_idx + 1):
        t0 = time.perf_counter()
        out_root = os.path.join(output_path, f"output_{vid}")
        os.makedirs(out_root, exist_ok=True)
        video = data[vid]
        writers: List[threading.Thread] = []

        def artifact_cb(q, thr, x_ge, _vid=vid, _root=out_root, _video=video):
            if save_artifacts:  # written in the background, as the reference does
                t = threading.Thread(target=save_output_strip,
                                     args=(_video[: x_ge.shape[0]].copy(), x_ge.copy(), q, thr,
                                           _vid, _root))
                t.start()
                writers.append(t)

        points = rate_sweep(cfg, video, coders, predictor, lpips_metric, fvd_metric=fvd_metric,
                            qualities=qualities, thresholds=thresholds, seed=cfg.seed + vid,
                            num_frames_total=min(30, video.shape[0]), artifact_cb=artifact_cb,
                            fused=fused, device_runner=device_runner, use_psnr=use_psnr)
        for t in writers:
            t.join()
        results[vid] = points
        if points:
            persist_rd_results(vid, points, out_root, bench_264, bench_265)
            print(f"video {vid}: {len(points)} rate points in {time.perf_counter() - t0:.1f}s")
    return results


def run_sweep_queued(cfg: Config, data: np.ndarray, coders: Dict[int, object],
                     predictor: FramePredictor, output_path: str, queue_dir: str,
                     start_idx: int = 0, end_idx: int = 0, qualities: Sequence[int] = (4, 5),
                     thresholds: Optional[Sequence[float]] = None, with_fvd: bool = True,
                     lpips_metric: Optional[LPIPSMetric] = None,
                     fvd_metric: Optional[Callable] = None, bench_264: Optional[str] = None,
                     bench_265: Optional[str] = None, owner: Optional[str] = None,
                     stale_after: float = 900.0, provenance: Optional[dict] = None,
                     device_gop: bool = False, use_psnr: bool = False) -> int:
    """The sweep over processes that pull (video, quality) units from the
    ``WorkQueue`` at ``queue_dir``, in place of a static partition: a unit's
    work varies (early bpp stops, fallback counts), so pulling keeps every
    process busy until the queue drains, and a unit whose process died is
    run again elsewhere once its claim is ``stale_after`` seconds old.

    Unit (v, q) is ``rate_sweep`` over video v at quality q, seeded with
    ``cfg.seed + v``; a background thread renews its claim every
    ``HEARTBEAT_S`` seconds while it runs. ``device_gop`` runs the GOPs
    through one ``DeviceGOPRunner`` per process. The first process to find
    the queue drained and win ``mark_done("__merged__")`` merges the points
    per video and writes ``config.yml`` and each video's RD outputs; the
    others write nothing. Returns the number of units this process ran."""
    units = [{"id": f"v{vid}_q{q}", "video": vid, "quality": int(q)}
             for vid in range(start_idx, end_idx + 1) for q in qualities]
    wq = WorkQueue.create_or_open(queue_dir, units, stale_after=stale_after)
    owner = owner or f"{socket.gethostname()}:{os.getpid()}"
    lpips_metric = lpips_metric or LPIPSMetric.create(device=predictor.device)
    fvd_metric = _fvd(with_fvd, fvd_metric, predictor)
    n_frames = _gop_frames(data)
    device_runner = None
    if device_gop:
        from tvc_torch.pipeline.sender import DeviceGOPRunner

        device_runner = DeviceGOPRunner(cfg, predictor, lpips=lpips_metric, use_psnr=use_psnr,
                                        num_frames_total=n_frames)

    def run_unit(job):
        vid, q = job["video"], job["quality"]
        stop = threading.Event()

        def beat():  # a unit may outlast the lease between two points
            while not stop.wait(HEARTBEAT_S):
                wq.heartbeat(job["id"])

        beater = threading.Thread(target=beat, daemon=True)
        beater.start()
        try:
            points = rate_sweep(cfg, data[vid], coders, predictor, lpips_metric,
                                fvd_metric=fvd_metric, qualities=[q], thresholds=thresholds,
                                seed=cfg.seed + vid, num_frames_total=min(30, data[vid].shape[0]),
                                verbose=False, device_runner=device_runner, use_psnr=use_psnr)
        finally:
            stop.set()
            beater.join()
        return {"video": vid, "points": [dataclasses.asdict(p) for p in points]}

    n = wq.drain(owner, run_unit)
    if wq.all_done() and wq.mark_done("__merged__", {"owner": owner}):
        per_video: Dict[int, List[RatePoint]] = {}
        for res in wq.results().values():
            for p in res["points"]:
                per_video.setdefault(res["video"], []).append(RatePoint(**p))
        os.makedirs(output_path, exist_ok=True)
        save_config(cfg, os.path.join(output_path, "config.yml"),
                    extra={"provenance": provenance} if provenance else None)
        for vid, points in sorted(per_video.items()):
            persist_rd_results(vid, points, os.path.join(output_path, f"output_{vid}"),
                               bench_264, bench_265)
        print(f"[queue] merged {len(per_video)} videos -> {output_path}", flush=True)
    return n


def persist_rd_results(vid: int, points: Sequence[RatePoint], out_root: str,
                       bench_264: Optional[str] = None, bench_265: Optional[str] = None) -> None:
    """``points.json``, the convex-hull envelopes and the plots of one video.
    Fewer than 3 points (or collinear ones) make no hull: the envelopes are
    then the raw points in bpp order."""
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, "points.json"), "w") as f:
        json.dump([dataclasses.asdict(p) for p in points], f, indent=1)

    fvds = [0.0 if np.isnan(p.fvd) else p.fvd for p in points]
    try:
        psnr_arr, lpips_arr, fvd_arr = process_data_and_save(
            vid, [p.bpp for p in points], [p.psnr_list for p in points],
            [p.lpips_list for p in points], fvds, out_root)
    except Exception:  # scipy's QhullError, or too few points for a hull
        bpps = np.asarray([p.bpp for p in points])
        order = np.argsort(bpps)
        psnr_arr = np.vstack([bpps[order],
                              np.asarray([np.mean(p.psnr_list) for p in points])[order]])
        lpips_arr = np.vstack([bpps[order],
                               np.asarray([np.mean(p.lpips_list) for p in points])[order]])
        fvd_arr = np.vstack([bpps[order], np.asarray(fvds)[order]])
        for name, arr in (("psnr", psnr_arr), ("lpips", lpips_arr), ("fvd", fvd_arr)):
            np.save(os.path.join(out_root, f"{name}_{vid}.npy"), arr)
    try:
        plot(vid, psnr_arr, lpips_arr, fvd_arr, out_root, bench_264=bench_264,
             bench_265=bench_265)
    except ImportError:
        print(f"video {vid}: skipped the plots (matplotlib is not installed)")
    except Exception as e:  # a plot must not end a sweep
        print(f"plotting failed for video {vid}: {e}")
