"""Compare two ways of running a frame predictor's update as CUDA graphs, as
a fresh receiver meets them, with the eager loop beside them:

- ``update``: the whole update (101 UNet calls and their combines) captured
  as one graph, keyed by the sampler's settings and the shapes; a key's
  first call runs eagerly, its second captures and replays, later calls
  replay;
- ``step``: the port's graphed UNet (``tvc_torch/samplers/graph.py``), one
  graph per input signature replayed once a UNet call, the combines eager;
- ``eager``: every UNet call launched from the host.

Each design runs in a fresh process that draws the full-width UNet's random
weights (``Config()``, seed 0) and then makes ``--updates`` DDPM predictions
at B = 1 from seeded draws and conditioning frames, as ``gop receive`` does
for a GOP.

    python -m tvc_torch.tools.graph_designs [--updates 11] [--order update step eager step update]

Prints one JSON line per process: each update's host seconds (draws to the
frames' copy to the host), their sum (``run_s``), the weights' draw
(``setup_s``), the capture's host seconds and pool bytes, the last update's
wall against its CUDA-event time, and a SHA-256 of each update's frames;
then one line that says whether every process made the same frames, and
exits 1 if not. Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

DESIGNS = ("update", "step", "eager")


def _measure(design: str, updates: int) -> dict:
    import torch

    from tvc_torch.core.config import Config
    from tvc_torch.core.runtime import set_numerics
    from tvc_torch.pipeline.predictor import FramePredictor
    from tvc_torch.pipeline.transforms import data_transform
    from tvc_torch.samplers import graph

    set_numerics()
    t0 = time.perf_counter()
    pred = FramePredictor.create(Config(), seed=0, device="cuda")
    setup_s = time.perf_counter() - t0
    cfg = pred.cfg
    cond_shape = (1, cfg.data.image_size, cfg.data.image_size,
                  cfg.data.channels * cfg.data.num_frames_cond)
    whole = {}  # the update design's graph: static inputs, output, capture cost

    def eager(x_init, cond, noise, warm_noise):
        return pred._sample(x_init, cond, noise, warm_noise, eps_fn=pred.model)

    def sample(x_init, cond, noise, warm_noise):
        inputs = {"x_init": x_init, "cond": cond, "noise": noise, "warm_noise": warm_noise}
        if design == "eager":
            return eager(**inputs)
        if design == "step":
            return pred._sample(**inputs)
        if not whole:
            whole["warm"] = True
            return eager(**inputs)
        if "graph" not in whole:
            static = {k: torch.empty_like(v) for k, v in inputs.items() if v is not None}
            ts = time.perf_counter()
            g, out, _, pool = graph.capture(eager, {**{k: None for k in inputs}, **static})
            whole.update(graph=g, static=static, out=out, pool=pool,
                         capture_s=time.perf_counter() - ts)
        for k, buf in whole["static"].items():
            buf.copy_(inputs[k])
        whole["graph"].replay()
        return whole["out"].clone()

    rng = np.random.default_rng(0)
    walls, digests = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        for i in range(updates):
            cond_frames = torch.from_numpy(rng.random(cond_shape, dtype=np.float32))
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            x_init, noise = pred.draws(torch.Generator(device="cuda").manual_seed(i), 1)
            step_rows, warm = pred._split(noise)
            cond = data_transform(cfg, cond_frames.to("cuda"))
            frames = sample(x_init, cond, step_rows, warm).cpu().numpy()
            end.record()
            end.synchronize()
            walls.append(time.perf_counter() - t)
            digests.append(hashlib.sha256(frames.tobytes()).hexdigest())
    if design == "step":
        (st,) = pred.graphs.stats().values()
        capture_s, pool = st["capture_s"], st["pool_bytes"]
    else:
        capture_s, pool = whole.get("capture_s"), whole.get("pool")
    return {"design": design, "updates_s": walls, "run_s": sum(walls), "setup_s": setup_s,
            "capture_s": capture_s, "pool_bytes": pool, "last_wall_s": walls[-1],
            "last_event_s": start.elapsed_time(end) / 1e3, "sha256": digests,
            "gpu": torch.cuda.get_device_name(0)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tvc_torch.tools.graph_designs")
    ap.add_argument("--updates", type=int, default=11)
    ap.add_argument("--order", nargs="*", choices=DESIGNS,
                    default=["update", "step", "eager", "step", "update"])
    ap.add_argument("--design", choices=DESIGNS, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.design:
        print(json.dumps(_measure(args.design, args.updates)), flush=True)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rows = []
    for design in args.order:
        proc = subprocess.run([sys.executable, "-m", "tvc_torch.tools.graph_designs",
                               "--design", design, "--updates", str(args.updates)],
                              cwd=root, timeout=900, capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    same = all(r["sha256"] == rows[0]["sha256"] for r in rows)
    print(json.dumps({"same_frames_in_every_process": same,
                      "run_s": {d: [r["run_s"] for r in rows if r["design"] == d]
                                for d in dict.fromkeys(args.order)}}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
