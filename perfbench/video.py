"""The traffic's videos: seeded synthetic clips, made in bulk on the host.

Each clip is a smooth moving pattern with a little noise (a sine grating
per channel drifting over time), the generator the port's smoke test uses,
with its parameters taken from the traffic file's ``video`` entry. Every
clip of a run is drawn from the run's seed and the clip's place (unit,
chain), so the same seed gives the same clips, and every seed gives clips
of the same size: only the content changes.
"""

from __future__ import annotations

import numpy as np


def moving_pattern(seed: int, unit: int, chain: int, frames: int, spec: dict) -> np.ndarray:
    """(frames, size, size, 3) float32 in [0, 1]."""
    rng = np.random.default_rng([seed, unit, chain])
    size = int(spec["size"])
    lo, hi = spec["freq"]
    freq = rng.uniform(lo, hi, (3, 2)).astype(np.float32)
    phase = rng.uniform(0.0, 2.0 * np.pi, 3).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    t = np.arange(frames, dtype=np.float32)[:, None, None]
    chans = [0.5 + 0.35 * np.sin(2 * np.pi * (freq[c, 0] * xx + freq[c, 1] * yy)[None]
                                 + phase[c] + float(spec["speed"]) * t) for c in range(3)]
    video = np.stack(chans, -1) + float(spec["noise"]) * rng.standard_normal(
        (frames, size, size, 3), dtype=np.float32)
    return np.clip(video, 0.0, 1.0).astype(np.float32)


def pool(seed: int, traffic: dict):
    """pool[unit][chain]: the clips of ``traffic["pool_units"]`` units."""
    spec = traffic["video"]
    return [[moving_pattern(seed, u, c, int(traffic["frames"]), spec)
             for c in range(int(traffic["chains"]))] for u in range(int(traffic["pool_units"]))]
