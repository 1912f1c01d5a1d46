"""Time the full-width UNet at several batch sizes with cuDNN's heuristic
choice of convolution algorithm and with its timed choice
(``tvc_torch.core.runtime.batched_conv_algorithms``), each mode in a fresh
process (cuDNN caches one choice per shape for a process, whichever mode
made it).

    python -m tvc_torch.tools.conv_algorithms [--batches 1 2 4 8] [--calls 5]
    python -m tvc_torch.tools.conv_algorithms --train [--batches 8] [--calls 5]

Prints one JSON line per (mode, batch): the first call's host seconds (the
timing of the algorithms included), the mean ms of ``--calls`` calls by CUDA
events, and whether two calls gave the same bits. With ``--train`` a call is
one DSM train step (forward, backward, clipping, Adam, EMA), which enters
``batched_conv_algorithms`` at its batch (the heuristic mode patches that
to do nothing in its own process), timed by the host clock around
synchronized steps, with the peak device memory of the first step and of
the rest. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

MODES = ("heuristic", "timed")


def _measure(mode: str, batches: List[int], calls: int) -> None:
    import contextlib

    import torch

    from tvc_torch.core.config import Config
    from tvc_torch.core.runtime import batched_conv_algorithms, set_numerics
    from tvc_torch.pipeline.predictor import FramePredictor

    set_numerics()
    cfg = Config()
    model = FramePredictor.create(cfg, seed=0, device="cuda").model
    size, c = cfg.data.image_size, cfg.data.channels
    for b in batches:
        g = torch.Generator(device="cuda").manual_seed(b)
        x = torch.randn((b, size, size, c * cfg.data.num_frames), generator=g, device="cuda")
        cond = torch.rand((b, size, size, c * cfg.data.num_frames_cond), generator=g,
                          device="cuda")
        t = torch.full((b,), 500, device="cuda")
        scope = (batched_conv_algorithms(b, "cuda") if mode == "timed"
                 else contextlib.nullcontext())
        with torch.no_grad(), scope:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = model(x, t, cond)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                out = model(x, t, cond)
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / calls
        print(json.dumps({"mode": mode, "batch": b, "first_call_s": first_s, "ms": ms,
                          "ms_per_chain": ms / b, "rerun_identical": bool(torch.equal(first, out)),
                          "gpu": torch.cuda.get_device_name(0)}), flush=True)


def _measure_train(mode: str, batches: List[int], calls: int) -> None:
    import contextlib
    from unittest import mock

    import torch

    from tvc_torch.core.config import Config
    from tvc_torch.core.runtime import set_numerics
    from tvc_torch.losses.dsm import draw_dsm
    from tvc_torch.parallel import train
    from tvc_torch.parallel.train import make_train_step
    from tvc_torch.samplers.schedules import Schedule

    set_numerics()
    if mode == "heuristic":
        mock.patch.object(train, "batched_conv_algorithms",
                          lambda *_: contextlib.nullcontext()).start()
    cfg = Config()
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    state = init_fn(0)
    size, c = cfg.data.image_size, cfg.data.channels
    for b in batches:
        g = torch.Generator(device="cuda").manual_seed(b)
        batch = {"x": torch.randn((b, size, size, c * cfg.data.num_frames), generator=g,
                                  device="cuda"),
                 "cond": torch.rand((b, size, size, c * cfg.data.num_frames_cond), generator=g,
                                    device="cuda")}
        labels, noise = draw_dsm(batch["x"].shape, Schedule.from_config(cfg),
                                 torch.Generator().manual_seed(b), device="cuda")
        times, peaks = [], []
        for _ in range(calls + 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step_fn(state, batch, labels, noise)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        print(json.dumps({"mode": mode, "train_step": True, "batch": b,
                          "first_step_s": times[0], "step_s": times[1:],
                          "first_step_peak_mem_gb": peaks[0], "peak_mem_gb": max(peaks[1:]),
                          "gpu": torch.cuda.get_device_name(0)}), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tvc_torch.tools.conv_algorithms")
    ap.add_argument("--batches", nargs="*", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="time train steps, not forwards")
    ap.add_argument("--mode", choices=MODES, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mode:
        (_measure_train if args.train else _measure)(args.mode, args.batches, args.calls)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rc = 0
    for mode in MODES:
        proc = subprocess.run([sys.executable, "-m", "tvc_torch.tools.conv_algorithms",
                               "--mode", mode, "--calls", str(args.calls), "--batches",
                               *map(str, args.batches), *(["--train"] if args.train else [])],
                              cwd=root, timeout=1800)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
