"""Throughput harness: frames/s for the end-to-end pipeline on one card
(counterpart of ``tvc/bench/throughput.py`` and of the root ``bench.py``'s
driver).

    python -m tvc_torch.bench.throughput [--quick] [--dtype {bf16,f32}] ...

Measures the sender's cost centres at the flagship ``Config()``:
1. one prediction cycle, a full subsampled-DDPM sweep of the 262M UNet
   making 5 frames (``FramePredictor.generate``, every UNet call after the
   first replayed as a CUDA graph), at B = ``batch``;
2. one keyframe pair through the ELIC codec, ``exact`` (rANS streams a
   receiver decodes; the GOP headline) and the simulation coder;
3. the lockstep batch: ``throughput_batch`` GOP chains sharing each sweep;
4. ``FusedGOPSender.run`` and ``DeviceGOPRunner.run`` on the forced
   worst-case trajectory [5, 0, 5, 0, 5, 5, 5] (7 sweeps, 3 keyframe pairs,
   30 frames), the latter also on the accept-all trajectory (6 sweeps, 1
   pair), with the sampler-serial bound of its cycle timed in the same window
   and the band of its repetitions.

The predictor runs at ``dtype`` (bf16 by default, with bf16-stored weights;
``precision_schedule="f32:K"`` keeps float32 masters) on weights filled with
0.01 on the card (``FramePredictor.create(fast_init=True)``); the codec on
the CLI's seeded random weights. Neither has meaning: the accept decisions
are forced.

Timing: host clock around work that ends in ``torch.cuda.synchronize``, never
a fetch of an output; every timed section runs once before it is timed. The
first ``generate`` at a batch (its eager call, which builds the attention
kernel, and its graph capture) is reported as ``compile_time``: the JAX
package's compile has no other counterpart. A subsampled run (``--quick``)
is scaled to the 100-step budget without scaling the per-call dispatch.

The reference's worst case is ~240 s per 30-frame video (~0.125 frames/s),
the baseline of ``vs_baseline``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.core.runtime import resolve_device

BASELINE_FPS = 0.125
FORCED = [5, 0, 5, 0, 5, 5, 5]     # the worst-case trajectory: 7 sweeps, 3 pairs
ACCEPT_ALL = [5] * 6               # every prediction accepted: 6 sweeps, 1 pair
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class BenchResult:
    t_unet_step: float
    t_cycle: float
    t_keyframe_pair: float        # exact transmissible path (GOP headline)
    fps_gop: float
    n_sample_steps: int
    compile_time: float
    t_keyframe_pair_fused: float = 0.0  # the simulation coder
    # lockstep-batched serving path: B GOP chains share every sampler sweep
    throughput_batch: int = 0
    t_cycle_batched: float = 0.0
    t_keyframes_batched: float = 0.0
    fps_throughput: float = 0.0
    # FusedGOPSender.run on the forced worst-case trajectory, normalized to 100 steps
    t_fused_gop: float = 0.0
    fused_gop_cycles: int = 0
    fps_fused_gop: float = 0.0
    # DeviceGOPRunner on the same trajectory: exact keyframe streams, one host
    # read per update
    t_device_gop: float = 0.0
    fps_device_gop: float = 0.0
    # sampler-serial bound from a cycle timed in the same window, and the band
    fps_device_gop_bound: float = 0.0
    device_gop_overhead_ms: float = 0.0
    t_device_gop_min: float = 0.0
    t_device_gop_max: float = 0.0
    # the accept-all trajectory (6 sweeps, the first pair only)
    t_device_gop_acceptall: float = 0.0
    fps_device_gop_acceptall: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def bench_pipeline(
    subsample: Optional[int] = None,
    dtype=torch.bfloat16,
    include_codec: bool = True,
    batch: int = 1,
    seed: int = 0,
    throughput_batch: int = 8,
    fused_gop: bool = True,
    precision_schedule: str = "",
    device="cuda",
    cfg: Optional[Config] = None,
) -> BenchResult:
    """Measure the pipeline; ``cfg`` replaces the flagship ``Config()`` (the
    CPU tests pass a tiny one; its ``codec`` section sizes the ELIC)."""
    from tvc_torch.pipeline.predictor import FramePredictor

    dev = resolve_device(device)
    cfg = cfg if cfg is not None else Config()
    if subsample is not None:
        cfg.sampling.subsample = subsample
    n_steps = cfg.sampling.subsample
    calls = n_steps + 1  # + the final denoise step

    _log(f"building the predictor (fast init) on {dev}")
    if precision_schedule:
        # the first K steps run through a float32 twin over the same float32 masters
        cfg.sampling.precision_schedule = precision_schedule
        _log(f"precision schedule: {precision_schedule} (f32 masters)")
        predictor = FramePredictor.create(cfg, seed, device=dev, dtype=dtype, fast_init=True)
    else:
        predictor = FramePredictor.create(cfg, seed, device=dev, dtype=dtype, params_dtype=dtype,
                                          fast_init=True)
    size, c = cfg.data.image_size, cfg.data.channels
    cond = torch.zeros((batch, size, size, c * cfg.data.num_frames_cond), device=dev)

    def cycle(b_cond, key):
        predictor.generate(b_cond, generator=_gen(dev, key))
        _sync(dev)

    _log(f"first {n_steps}-step cycle (eager call, graph capture)")
    t0 = time.perf_counter()
    cycle(cond, 1)
    compile_time = time.perf_counter() - t0
    _log(f"first cycle in {compile_time:.3f}s")

    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        cycle(cond, 2 + i)
    t_cycle = (time.perf_counter() - t0) / reps
    t_step = t_cycle / calls
    _log(f"steady cycle: {t_cycle:.4f}s ({t_step * 1e3:.3f} ms/step)")

    coder = frames = None
    t_pair = t_pair_fused = 0.0
    if include_codec:
        coder, frames = _codec(cfg, dev)
        t_pair = _time_pair(coder, frames, cfg, dev, exact=True)
        t_pair_fused = _time_pair(coder, frames, cfg, dev, exact=False)
        _log(f"codec: keyframe pair exact={t_pair:.4f}s fused={t_pair_fused:.4f}s "
             "(medians of 5; the GOP model uses the exact transmissible path)")

    # scale a subsampled cycle to the 100-step budget; the per-call dispatch
    # is paid once a cycle and is not scaled
    t_dispatch = 0.0
    if n_steps < 100:
        t_dispatch = _dispatch_s(dev)
        _log(f"dispatch overhead: {t_dispatch * 1e3:.3f} ms/call")
    t_cycle_100 = _to_100(t_cycle, t_dispatch, n_steps)
    t_step_clean = max(t_cycle - t_dispatch, 0.0) / calls
    t_gop = 5 * t_cycle_100 + 3 * t_pair
    fps = 30.0 * batch / t_gop
    _log(f"GOP model: 5x{t_cycle_100:.4f}s + 3x{t_pair:.4f}s -> {fps:.4f} frames/s")

    # ---- lockstep-batched serving throughput ----
    tb = throughput_batch if batch == 1 else 0
    t_cycle_b = t_kf_b = fps_tp = 0.0
    if tb > 1:
        cond_b = torch.zeros((tb, size, size, c * cfg.data.num_frames_cond), device=dev)
        t0 = time.perf_counter()
        cycle(cond_b, 11)
        _log(f"first batched (B={tb}) cycle in {time.perf_counter() - t0:.3f}s")
        t0 = time.perf_counter()
        for i in range(3):
            cycle(cond_b, 12 + i)
        t_cycle_b = _to_100((time.perf_counter() - t0) / 3, t_dispatch, n_steps)
        if coder is not None:
            from tvc_torch.pipeline.keyframe import code_frames

            frames_b = np.random.RandomState(1).rand(2 * tb, size, size, c).astype(np.float32)
            code_frames(coder, frames_b, cfg.codec.patch, exact=True)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                code_frames(coder, frames_b, cfg.codec.patch, exact=True)
                _sync(dev)
                times.append(time.perf_counter() - t0)
            t_kf_b = float(np.median(times))
        fps_tp = 30.0 * tb / (5 * t_cycle_b + 3 * t_kf_b)
        _log(f"batched GOP model (B={tb}): 5x{t_cycle_b:.4f}s + 3x{t_kf_b:.4f}s "
             f"-> {fps_tp:.4f} frames/s")

    gop_paths = fused_gop and batch == 1 and coder is not None
    video = np.random.RandomState(5).rand(30, size, size, c).astype(np.float32)
    lp = None
    norm = len(FORCED) * (101 - calls) * t_step_clean if n_steps < 100 else 0.0

    # ---- FusedGOPSender.run: the GOP's state machine on the device ----
    t_fused = fps_fused = 0.0
    if gop_paths:
        from tvc_torch.metrics.lpips import LPIPSMetric
        from tvc_torch.pipeline.fused_gop import FusedGOPSender

        lp = LPIPSMetric.create(device=dev)
        fsender = FusedGOPSender(cfg=cfg, predictor=predictor, coder=coder, lpips=lp,
                                 num_frames_total=30)

        def fused_run(key):
            out = fsender.run(video, key, 0.1, forced_accepts=FORCED)
            return float(out["bits"]), int(out["n_updates"])  # a scalar read ends the run

        t0 = time.perf_counter()
        fused_run(31)
        _log(f"first fused GOP in {time.perf_counter() - t0:.3f}s")
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            fetched = fused_run(32 + i)
            times.append(time.perf_counter() - t0)
        if fetched[1] != len(FORCED):
            raise RuntimeError(f"the fused GOP made {fetched[1]} updates, not {len(FORCED)}")
        t_fused = float(np.median(times)) + norm
        fps_fused = 30.0 / t_fused
        _log(f"fused whole-GOP wall ({len(FORCED)} sweeps + 3 pairs, 100-step normalized): "
             f"{t_fused:.4f}s -> {fps_fused:.4f} frames/s")

    # ---- DeviceGOPRunner: exact keyframe streams, one read per update ----
    t_dev_gop = fps_dev_gop = fps_dev_bound = dev_overhead_ms = 0.0
    t_dev_min = t_dev_max = t_dev_aa = fps_dev_aa = 0.0
    if gop_paths:
        from tvc_torch.pipeline.sender import DeviceGOPRunner

        runner = DeviceGOPRunner(cfg, predictor, lpips=lp, num_frames_total=30)
        video_u8 = np.clip(video * 255.0, 0, 255).round().astype(np.uint8)

        def device_run(key, forced):
            out = runner.run(coder, video_u8, key, 0.1, patch=cfg.codec.patch,
                             forced_accepts=forced)
            _sync(dev)
            return out

        t0 = time.perf_counter()
        device_run(41, FORCED)
        _log(f"first device GOP in {time.perf_counter() - t0:.3f}s")

        def time_cycles(n=2):
            """A cycle timed beside the GOP runs, one warm discard first."""
            cycle(cond, 70)
            t0 = time.perf_counter()
            for i in range(n):
                cycle(cond, 71 + i)
            return _to_100((time.perf_counter() - t0) / n, t_dispatch, n_steps)

        times: List[float] = []
        cyc = [time_cycles()]
        for i in range(3):
            t0 = time.perf_counter()
            out = device_run(42 + i, FORCED)
            times.append(time.perf_counter() - t0)
        cyc.append(time_cycles())
        if out.n_updates != len(FORCED):
            raise RuntimeError(f"the device GOP made {out.n_updates} updates, not {len(FORCED)}")
        t_dev_gop = float(np.median(times)) + norm
        t_dev_min, t_dev_max = float(np.min(times)) + norm, float(np.max(times)) + norm
        fps_dev_gop = 30.0 / t_dev_gop
        # the 7 sweeps depend on each other: no GOP beats 7 cycles timed in this window
        t_cycle_now = float(np.min(cyc))
        fps_dev_bound = 30.0 / (len(FORCED) * t_cycle_now)
        dev_overhead_ms = (t_dev_gop - len(FORCED) * t_cycle_now) * 1e3
        _log(f"device GOP ({len(FORCED)} sweeps + 3 exact pairs, 100-step normalized): "
             f"{t_dev_gop:.4f}s [{t_dev_min:.4f}..{t_dev_max:.4f}] -> {fps_dev_gop:.4f} "
             f"frames/s (sampler-serial bound {fps_dev_bound:.4f} at t_cycle={t_cycle_now:.4f}s "
             f"[{cyc[0]:.4f},{cyc[1]:.4f}]; non-sampler overhead {dev_overhead_ms:.1f} ms/GOP)")

        device_run(45, ACCEPT_ALL)  # the tail update scores 3 frames: a shape of its own
        times_aa = []
        for i in range(3):
            t0 = time.perf_counter()
            out = device_run(46 + i, ACCEPT_ALL)
            times_aa.append(time.perf_counter() - t0)
        if out.n_updates != len(ACCEPT_ALL):
            raise RuntimeError(f"the accept-all GOP made {out.n_updates} updates, "
                               f"not {len(ACCEPT_ALL)}")
        norm_aa = len(ACCEPT_ALL) * (101 - calls) * t_step_clean if n_steps < 100 else 0.0
        t_dev_aa = float(np.median(times_aa)) + norm_aa
        fps_dev_aa = 30.0 / t_dev_aa
        _log(f"device GOP accept-all ({len(ACCEPT_ALL)} sweeps + 1 exact pair): "
             f"{t_dev_aa:.4f}s -> {fps_dev_aa:.4f} frames/s")

    return BenchResult(
        t_device_gop=t_dev_gop, fps_device_gop=fps_dev_gop, fps_device_gop_bound=fps_dev_bound,
        device_gop_overhead_ms=dev_overhead_ms, t_device_gop_min=t_dev_min,
        t_device_gop_max=t_dev_max, t_device_gop_acceptall=t_dev_aa,
        fps_device_gop_acceptall=fps_dev_aa, t_fused_gop=t_fused,
        fused_gop_cycles=len(FORCED) if t_fused else 0, fps_fused_gop=fps_fused,
        throughput_batch=tb, t_cycle_batched=t_cycle_b, t_keyframes_batched=t_kf_b,
        fps_throughput=fps_tp, t_unet_step=t_step, t_cycle=t_cycle_100, t_keyframe_pair=t_pair,
        fps_gop=fps, n_sample_steps=n_steps, compile_time=compile_time,
        t_keyframe_pair_fused=t_pair_fused)


def _to_100(t_cycle: float, t_dispatch: float, n_steps: int) -> float:
    """A cycle of ``n_steps`` scaled to 100 steps + the denoise step."""
    if n_steps < 100:
        return t_dispatch + max(t_cycle - t_dispatch, 0.0) * (101 / (n_steps + 1))
    return t_cycle * (101 / (n_steps + 1))


def _dispatch_s(dev: torch.device) -> float:
    """Seconds of one tiny launch and its synchronize."""
    x = torch.zeros((8, 128), device=dev)
    (x + 1.0).sum().item()
    t0 = time.perf_counter()
    for _ in range(5):
        y = x + 1.0
        _sync(dev)
    del y
    return (time.perf_counter() - t0) / 5


def _codec(cfg: Config, dev: torch.device):
    """The ELIC coder of ``cfg.codec`` on the seeded weights the CLI draws
    (``make_elic``, seed 3), and a seeded keyframe pair; the first codings of
    the pair are its warm-up. The JAX package's bench fills its codec with
    ``fast_init``; here ``fastinit`` cannot: the ELIC's checkerboard masks are
    non-persistent buffers, which a module built on ``meta`` leaves
    uninitialized after ``to_empty``."""
    from tvc_torch.models.codec.coding import ELICCoder
    from tvc_torch.models.codec.elic import make_elic
    from tvc_torch.pipeline.keyframe import code_frames

    _log(f"codec: ELIC N={cfg.codec.N} M={cfg.codec.M} (seeded weights)")
    coder = ELICCoder(make_elic(cfg.codec, seed=3, device=dev),
                      entropy_backend=cfg.codec.entropy_backend)
    size, c = cfg.data.image_size, cfg.data.channels
    frames = np.random.RandomState(0).rand(2, size, size, c).astype(np.float32)
    t0 = time.perf_counter()
    code_frames(coder, frames, cfg.codec.patch, exact=True)
    code_frames(coder, frames, cfg.codec.patch, exact=False)
    _sync(dev)
    _log(f"codec: warm-up pair in {time.perf_counter() - t0:.3f}s")
    return coder, frames


def _time_pair(coder, frames, cfg: Config, dev: torch.device, exact: bool) -> float:
    from tvc_torch.pipeline.keyframe import code_frames

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        code_frames(coder, frames, cfg.codec.patch, exact=exact)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv: Optional[List[str]] = None, cfg: Optional[Config] = None) -> int:
    """``bench.py``'s driver: the info JSON on stderr, then one JSON line on
    stdout with ``metric``, ``value``, ``unit`` and ``vs_baseline``. ``cfg``
    replaces the flagship config (the CPU tests)."""
    ap = argparse.ArgumentParser(prog="python -m tvc_torch.bench.throughput")
    ap.add_argument("--quick", action="store_true",
                    help="10 sampling steps, extrapolated to the 100-step budget")
    ap.add_argument("--steps", type=int, default=None, help="override sampling steps")
    ap.add_argument("--no-codec", action="store_true")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--throughput-batch", type=int, default=8,
                    help="also measure the lockstep-batched serving path at this GOP-chain "
                         "batch (0 = skip)")
    ap.add_argument("--no-fused-gop", action="store_true",
                    help="skip the whole-GOP measurements (FusedGOPSender, DeviceGOPRunner)")
    ap.add_argument("--precision-schedule", type=str, default="",
                    help="sampling.precision_schedule for the measured sampler, e.g. f32:10 "
                         "(float32 masters; docs/BF16.md)")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="write a torch.profiler trace of the whole run into this directory")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from tvc_torch.ops import attention
    from tvc_torch.utils.profiler import device_trace

    dev = resolve_device(args.device)
    subsample = args.steps if args.steps is not None else (10 if args.quick else 100)
    t0 = time.perf_counter()
    prof = device_trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with prof:
        res = bench_pipeline(subsample=subsample, dtype=DTYPES[args.dtype],
                             include_codec=not args.no_codec, batch=args.batch,
                             throughput_batch=args.throughput_batch,
                             fused_gop=not args.no_fused_gop,
                             precision_schedule=args.precision_schedule, device=dev, cfg=cfg)
    wall = time.perf_counter() - t0

    _log("result " + json.dumps(dataclasses.asdict(res)))
    _log(f"attention kernel launches: {attention.launches} "
         f"{json.dumps(attention.kernel_launches)}")
    info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "dtype": args.dtype,
        "sample_steps_measured": res.n_sample_steps,
        "t_unet_step_s": round(res.t_unet_step, 4),
        "t_cycle100_s": round(res.t_cycle, 3),
        "t_keyframe_pair_s": round(res.t_keyframe_pair, 3),
        "t_keyframe_pair_fused_s": round(res.t_keyframe_pair_fused, 3),
        "codec_path": "exact (transmissible bitstream, host rANS)",
        "precision_schedule": args.precision_schedule or "uniform",
        "compile_s": round(res.compile_time, 1),
        "bench_wall_s": round(wall, 1),
    }
    if res.t_fused_gop:
        info.update({"t_fused_gop_s": round(res.t_fused_gop, 3),
                     "fused_gop_cycles": res.fused_gop_cycles,
                     "fps_fused_gop": round(res.fps_fused_gop, 3)})
    if res.t_device_gop:
        info.update({
            "t_device_gop_s": round(res.t_device_gop, 3),
            "t_device_gop_band_s": [round(res.t_device_gop_min, 3),
                                    round(res.t_device_gop_max, 3)],
            "fps_device_gop_real": round(res.fps_device_gop, 3),
            "fps_device_gop_bound": round(res.fps_device_gop_bound, 3),
            "device_gop_overhead_ms": round(res.device_gop_overhead_ms, 1),
            "fps_device_gop_acceptall": round(res.fps_device_gop_acceptall, 3),
        })
    if res.throughput_batch:
        info.update({"throughput_batch": res.throughput_batch,
                     "t_cycle100_batched_s": round(res.t_cycle_batched, 3),
                     "t_keyframes_batched_s": round(res.t_keyframes_batched, 3),
                     "fps_throughput_batched": round(res.fps_throughput, 3)})
    info["fps_gop_model"] = round(res.fps_gop, 4)
    print(json.dumps(info), file=sys.stderr, flush=True)
    if res.fps_device_gop:
        metric = ("frames/s/chip (device-resident REAL worst-case 30-frame GOP, exact "
                  "transmissible streams, 128x128)")
        value = res.fps_device_gop
    else:
        metric = "frames/s/chip (worst-case 30-frame GOP encode+decode, 128x128)"
        value = res.fps_gop
    print(json.dumps({"metric": metric, "value": round(value, 4), "unit": "frames/s/chip",
                      "vs_baseline": round(value / BASELINE_FPS, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
