"""Time the ways to run the pseudo-3-D conv at the flagship width on cuDNN's
heuristic (the bitstream's numerics: float32, no TF32, deterministic,
``cudnn.benchmark`` off), each form in a fresh process.

    python -m tvc_torch.tools.pseudo3d_convs [--channels 192] [--size 128] [--frames 7]

The spatial 3x3 conv of every frame: frames folded into a 2-D conv's
batch, one 2-D conv a frame, or one 1x3x3 3-D conv on the (B, C, N, H, W)
volume; the temporal 3-tap conv over the frames of every pixel: pixels
folded into a 1-D conv's batch, a 3x1 2-D conv on (B, C, N, H*W), or one
3x1x1 3-D conv on the volume. Prints one JSON line per form: the mean ms of
5 calls by CUDA events, the peak reserved and allocated device memory,
whether a CUDA graph of the call captures and replays it bit for bit, and
the kernels it ran. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

FORMS = {
    "space_conv2d_frames_in_batch":
        "x = r(n, c, s, s); w = r(c, c, 3, 3); fn = lambda: F.conv2d(x, w, padding=1)",
    "space_conv2d_per_frame":
        "x = r(1, c, n, s, s); w = r(c, c, 3, 3); "
        "fn = lambda: torch.stack([F.conv2d(x[:, :, f], w, padding=1) for f in range(n)], 2)",
    "space_conv3d_1x3x3":
        "x = r(1, c, n, s, s); w = r(c, c, 1, 3, 3); fn = lambda: F.conv3d(x, w, padding=(0, 1, 1))",
    "time_conv1d_pixels_in_batch":
        "x = r(s * s, c, n); w = r(c, c, 3); fn = lambda: F.conv1d(x, w, padding=1)",
    "time_conv2d_3x1":
        "x = r(1, c, n, s * s); w = r(c, c, 3, 1); fn = lambda: F.conv2d(x, w, padding=(1, 0))",
    "time_conv3d_3x1x1":
        "x = r(1, c, n, s, s); w = r(c, c, 3, 1, 1); fn = lambda: F.conv3d(x, w, padding=(1, 0, 0))",
}

_BODY = """
import json, sys, torch, torch.nn.functional as F
from tvc_torch.core.runtime import set_numerics
set_numerics()
c, s, n = {c}, {s}, {n}
g = torch.Generator(device="cuda").manual_seed(0)
r = lambda *shape: torch.randn(shape, generator=g, device="cuda")
{form}
with torch.no_grad():
    y = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        fn()
    end.record()
    end.synchronize()
    row = dict(ms=start.elapsed_time(end) / 5,
               max_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               max_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y2 = fn()
        graph.replay()
        torch.cuda.synchronize()
        row["graph"] = "equal" if torch.equal(y, y2) else "differs"
    except Exception as e:  # the capture's failure is the finding
        row["graph"] = type(e).__name__ + ": " + str(e).splitlines()[0][:80]
from torch.profiler import ProfilerActivity, profile
with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
row["kernels"] = sorted({{e.key[:80] for e in prof.key_averages() if e.self_device_time_total > 0}})
print(json.dumps(row))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--channels", type=int, default=192)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--frames", type=int, default=7)
    args = ap.parse_args(argv)
    for name, form in FORMS.items():
        body = _BODY.format(c=args.channels, s=args.size, n=args.frames, form=form)
        proc = subprocess.run([sys.executable, "-c", body], capture_output=True, text=True,
                              timeout=600)
        lines = proc.stdout.strip().splitlines()
        row = json.loads(lines[-1]) if proc.returncode == 0 and lines else {
            "error": proc.stderr.strip()[-300:]}
        print(json.dumps({"form": name, "channels": args.channels, "size": args.size,
                          "frames": args.frames, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
