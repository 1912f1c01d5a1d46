"""Per-frame and clip-prefix video metrics (counterpart of ``tvc/metrics/video.py``).

Each wrapper takes two batches of videos, (B, T, H, W, C) in [0, 1], and
returns a dict of values per clip prefix (``"[:k]"``), the per-frame values
and a ``"final"`` entry. PSNR and SSIM run in float64 on the host; LPIPS
(on [-1, 1]-rescaled frames) and FVD run on their metric's device.
Grayscale videos are repeated to three channels for LPIPS and FVD.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tvc_torch.metrics.fvd import FVDMetric, _to_rgb
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.metrics.pixel import psnr as _psnr
from tvc_torch.metrics.pixel import ssim as _ssim


def _prefixes(name: str, vals, per_frame: int, final: bool, shape) -> Dict:
    t = len(vals)
    per = {f"[:{clip}]": float(np.mean(vals[:clip]))
           for clip in range(per_frame, t + 1, per_frame)}
    out = {name: per, f"{name}_per_frame": per_frame, f"{name}_video_setting": shape}
    if final:
        per["final"] = float(np.mean(vals))
    out[f"{name}_per_frame_values"] = vals
    return out


def calculate_psnr(videos1: np.ndarray, videos2: np.ndarray,
                   calculate_per_frame: int = 1, calculate_final: bool = True) -> Dict:
    """Per-frame PSNR averaged over the batch."""
    assert videos1.shape == videos2.shape
    b, t = videos1.shape[:2]
    vals = [float(np.mean([_psnr(videos1[i, j], videos2[i, j]) for i in range(b)]))
            for j in range(t)]
    return _prefixes("psnr", vals, calculate_per_frame, calculate_final, videos1.shape)


def calculate_ssim(videos1: np.ndarray, videos2: np.ndarray,
                   calculate_per_frame: int = 1, calculate_final: bool = True) -> Dict:
    """Per-frame SSIM averaged over the batch."""
    assert videos1.shape == videos2.shape
    b, t = videos1.shape[:2]
    vals = [float(np.mean([_ssim(videos1[i, j].transpose(2, 0, 1),
                                 videos2[i, j].transpose(2, 0, 1)) for i in range(b)]))
            for j in range(t)]
    return _prefixes("ssim", vals, calculate_per_frame, calculate_final, videos1.shape)


def calculate_lpips(videos1: np.ndarray, videos2: np.ndarray,
                    metric: Optional[LPIPSMetric] = None, calculate_per_frame: int = 1,
                    calculate_final: bool = True) -> Dict:
    """Per-frame LPIPS of frames rescaled to [-1, 1], averaged over the batch
    (by default LPIPS(alex) on the card)."""
    assert videos1.shape == videos2.shape
    metric = metric or LPIPSMetric.create()
    v1 = _to_rgb(np.asarray(videos1)) * 2 - 1
    v2 = _to_rgb(np.asarray(videos2)) * 2 - 1
    vals = [float(np.mean(metric(v1[:, j], v2[:, j]).cpu().numpy()))
            for j in range(v1.shape[1])]
    return _prefixes("lpips", vals, calculate_per_frame, calculate_final, videos1.shape)


def calculate_fvd(videos1: np.ndarray, videos2: np.ndarray,
                  metric: Optional[FVDMetric] = None, calculate_per_frame: int = 10,
                  calculate_final: bool = True) -> Dict:
    """FVD of clip prefixes of at least 10 frames (shorter prefixes are
    skipped; by default the I3D on the card)."""
    assert videos1.shape == videos2.shape
    metric = metric or FVDMetric()
    v1 = _to_rgb(np.asarray(videos1))
    v2 = _to_rgb(np.asarray(videos2))
    per = {}
    for clip in range(calculate_per_frame, v1.shape[1] + 1, calculate_per_frame):
        if clip < 10:  # the I3D needs at least 10 frames
            continue
        per[f"[:{clip}]"] = metric(v1[:, :clip], v2[:, :clip])
    out = {"fvd": per, "fvd_per_frame": calculate_per_frame,
           "fvd_video_setting": videos1.shape}
    if calculate_final:
        per["final"] = metric(v1, v2)
    return out
