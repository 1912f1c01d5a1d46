"""Rate-distortion envelopes by convex hull (counterpart of ``tvc/metrics/rd.py``).

The reference's vertex walks for PSNR (maximised), LPIPS (minimised) and FVD
(minimised, with its end points inserted). They rely on
``scipy.spatial.ConvexHull`` listing 2-D vertices counterclockwise.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import scipy.spatial as spt


def _hull(bpps: Sequence[float], values: Sequence[float]):
    points = np.stack([np.asarray(bpps), np.asarray(values)]).transpose(1, 0)
    return points, spt.ConvexHull(points=points)


def _select(points: np.ndarray, hull, sel) -> np.ndarray:
    pts = points[hull.vertices[sel]]
    return np.vstack((pts[:, 0], pts[:, 1]))


def psnr_envelope(bpps: Sequence[float], psnr_means: Sequence[float]) -> np.ndarray:
    """(2, K) array [bpp; psnr] on the upper-left edge of the hull."""
    points, hull = _hull(bpps, psnr_means)
    leftmost = int(np.argmin(points[hull.vertices, 0]))
    highest = int(np.argmax(points[hull.vertices, 1]))
    if highest > leftmost + 1:
        sel = list(range(highest + 1, len(hull.vertices)))
    else:
        sel = list(range(highest, leftmost + 1))
    return _select(points, hull, sel)


def lpips_envelope(bpps: Sequence[float], lpips_means: Sequence[float]) -> np.ndarray:
    """The lower-left edge for a minimised metric."""
    points, hull = _hull(bpps, lpips_means)
    lowest = int(np.argmin(points[hull.vertices, 1]))
    leftest = int(np.argmin(points[hull.vertices, 0]))
    if leftest >= lowest + 1:
        sel = list(range(leftest + 1, len(hull.vertices)))
    else:
        sel = list(range(leftest, lowest + 1))
    return _select(points, hull, sel)


def fvd_envelope(bpps: Sequence[float], fvds: Sequence[float]) -> np.ndarray:
    """The FVD variant, with the end points inserted."""
    points, hull = _hull(bpps, fvds)
    lowest = int(np.argmin(points[hull.vertices, 1]))
    leftest = int(np.argmin(points[hull.vertices, 0]))
    if leftest > lowest + 1:
        sel = [leftest] + list(range(leftest + 1, len(hull.vertices))) + [lowest]
    else:
        sel = list(range(leftest, lowest + 1))
    return _select(points, hull, sel)


def process_data_and_save(databatchidx: int, bpps: Sequence[float],
                          psnr_lists: Sequence[Sequence[float]],
                          lpips_lists: Sequence[Sequence[float]], fvds: Sequence[float],
                          save_path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One video's RD envelopes from its points' per-frame metric lists,
    saved as ``{psnr,lpips,fvd}_{idx}.npy``."""
    psnr_arr = psnr_envelope(bpps, np.mean(np.asarray(psnr_lists), axis=1))
    lpips_arr = lpips_envelope(bpps, np.mean(np.asarray(lpips_lists), axis=1))
    fvd_arr = fvd_envelope(bpps, fvds)
    os.makedirs(save_path, exist_ok=True)
    for name, arr in (("psnr", psnr_arr), ("lpips", lpips_arr), ("fvd", fvd_arr)):
        np.save(os.path.join(save_path, f"{name}_{databatchidx}.npy"), arr)
    return psnr_arr, lpips_arr, fvd_arr
