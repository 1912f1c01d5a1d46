"""Per-dataset anchor presets and averaged-curve plotting (counterpart of
``tvc/bench/presets.py``).

Data-driven presets over the one harness (``tvc_torch/bench/anchors.py``):

- **city**: the 24 Cityscapes clips, 128x128 yuv420p, 30 frames, both codecs;
- **uvg**: the 7 UVG clips (YachtRide..ShakeNDry), 128x128 centre crops,
  yuv420p, 30 frames;
- **smm**: 64 Stochastic-Moving-MNIST clips, 64x64, the gray plane only
  (``-pix_fmt gray``), H.265 only.

Each preset writes ``bench_<name>_<264|265>.npy`` in the (videos, 4 metrics
[psnr, lpips, fvd, bpp], n_qp) layout, and a ``psnr_lpips_fvd_bpp.txt`` per
video. ``plot_average_curves`` interpolates each video's metric-vs-bpp curve
onto a common 0.02-bpp grid, averages over videos, and draws the PSNR, LPIPS
and FVD panels with H.264, H.265 and the system's own curves.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tvc_torch.bench.anchors import build_anchor_array

UVG_NAMES = ["YachtRide", "Beauty", "Bosphorus", "HoneyBee", "Jockey",
             "ReadySteadyGo", "ShakeNDry"]


@dataclass(frozen=True)
class AnchorPreset:
    name: str
    width: int
    height: int
    pix_fmt: str                 # "yuv420p" | "gray"
    num_frames: int
    num_videos: int              # expected dataset size (informational)
    codecs: Tuple[str, ...]
    qp_range: Tuple[int, int] = (0, 51)
    framerate: int = 30
    video_names: Optional[Tuple[str, ...]] = None


PRESETS: Dict[str, AnchorPreset] = {
    "city": AnchorPreset("city", 128, 128, "yuv420p", 30, 24,
                         ("libx264", "libx265")),
    "uvg": AnchorPreset("uvg", 128, 128, "yuv420p", 30, 7,
                        ("libx264", "libx265"),
                        video_names=tuple(UVG_NAMES)),
    "smm": AnchorPreset("smm", 64, 64, "gray", 30, 64, ("libx265",)),
}


def run_preset(
    preset: AnchorPreset,
    videos_rgb01: np.ndarray,
    workdir: str,
    output_dir: str,
    lpips_metric=None,
    fvd_metric=None,
    qp_range: Optional[Sequence[int]] = None,
    require_ffmpeg: bool = True,
) -> Dict[str, np.ndarray]:
    """Run the full preset sweep; returns {codec: (V,4,n_qp) array}.

    Writes `bench_<preset>_<264|265>.npy` + per-video
    `psnr_lpips_fvd_bpp.txt` files under output_dir."""
    os.makedirs(output_dir, exist_ok=True)
    t = preset.num_frames
    v, vt = videos_rgb01.shape[:2]
    assert vt >= t, f"need >= {t} frames, got {vt}"
    if (videos_rgb01.shape[2], videos_rgb01.shape[3]) != (preset.height, preset.width):
        raise ValueError(
            f"preset {preset.name} expects {preset.height}x{preset.width} frames, "
            f"got {videos_rgb01.shape[2]}x{videos_rgb01.shape[3]}")
    qps = list(qp_range if qp_range is not None else
               range(preset.qp_range[0], preset.qp_range[1] + 1))

    out: Dict[str, np.ndarray] = {}
    for codec in preset.codecs:
        tag = "264" if "264" in codec else "265"
        arr = build_anchor_array(
            videos_rgb01[:, :t], os.path.join(workdir, f"{preset.name}_{tag}"),
            codec=codec, qp_range=qps, framerate=preset.framerate,
            lpips_metric=lpips_metric, fvd_metric=fvd_metric,
            pix_fmt=preset.pix_fmt, require_ffmpeg=require_ffmpeg,
        )
        np.save(os.path.join(output_dir, f"bench_{preset.name}_{tag}.npy"), arr)
        for vi in range(arr.shape[0]):
            vname = (preset.video_names[vi] if preset.video_names is not None
                     and vi < len(preset.video_names) else f"v{vi}")
            txt = os.path.join(output_dir, f"{preset.name}_{tag}_{vname}_psnr_lpips_fvd_bpp.txt")
            with open(txt, "w") as f:
                for q in range(arr.shape[2]):
                    f.write(f"PSNR: {arr[vi,0,q]}, LPIPS: {arr[vi,1,q]}, "
                            f"FVD: {arr[vi,2,q]}, BPP: {arr[vi,3,q]}\n")
        out[codec] = arr
    return out


# --------------------------------------------------------------------------
# interpolate-to-grid averaging and the 3-panel overlay
# --------------------------------------------------------------------------


def average_curves(bpps: Sequence[np.ndarray], metrics: Sequence[np.ndarray],
                   step: float = 0.02, bpp_max: float = 1.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-video (bpp, metric) curves -> mean curve on a common bpp grid:
    each curve is linearly interpolated onto multiples of ``step`` inside its
    own bpp range; grid points are averaged over the curves that cover them."""
    grid_vals: Dict[float, List[float]] = {}
    for b, m in zip(bpps, metrics):
        b = np.asarray(b, np.float64)
        m = np.asarray(m, np.float64)
        keep = np.isfinite(b) & np.isfinite(m)
        b, m = b[keep], m[keep]
        if len(b) < 2:
            continue
        order = np.argsort(b)
        b, m = b[order], m[order]
        b_u, idx = np.unique(b, return_index=True)
        m_u = m[idx]
        if len(b_u) < 2:
            continue
        lo = np.ceil(b_u[0] / step) * step
        pts = np.arange(lo, min(b_u[-1], bpp_max) + 1e-12, step)
        vals = np.interp(pts, b_u, m_u)
        for p, vv in zip(np.round(pts, 2), vals):
            grid_vals.setdefault(float(p), []).append(float(vv))
    if not grid_vals:
        return np.zeros(0), np.zeros(0)
    ks = sorted(grid_vals)
    return (np.asarray(ks),
            np.asarray([float(np.mean(grid_vals[k])) for k in ks]))


def plot_average_curves(
    out_png: str,
    anchors_264: Optional[np.ndarray] = None,
    anchors_265: Optional[np.ndarray] = None,
    ours_bpps: Optional[Sequence[np.ndarray]] = None,
    ours_metrics: Optional[Dict[str, Sequence[np.ndarray]]] = None,
    bpp_max: float = 1.0,
    title: str = "",
) -> None:
    """3-panel PSNR/LPIPS/FVD vs BPP averaged-curve figure.

    anchors_*: (V, 4, n_qp) arrays; ours_*: per-video bpp lists + metric
    lists keyed 'psnr'/'lpips'/'fvd'."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = [("psnr", "PSNR (dB)", 0), ("lpips", "LPIPS", 1), ("fvd", "FVD", 2)]
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
    for ax, (key, label, row) in zip(axes, names):
        for arr, lbl in ((anchors_264, "H.264"), (anchors_265, "H.265")):
            if arr is None:
                continue
            b, m = average_curves([a[3] for a in arr], [a[row] for a in arr],
                                  bpp_max=bpp_max)
            if len(b):
                ax.plot(b, m, marker="o", markersize=3, label=lbl)
        if ours_bpps is not None and ours_metrics is not None and key in ours_metrics:
            b, m = average_curves(ours_bpps, ours_metrics[key], bpp_max=bpp_max)
            if len(b):
                ax.plot(b, m, marker="s", markersize=3, label="Ours")
        ax.set_xlabel("BPP")
        ax.set_ylabel(label)
        ax.grid(True, alpha=0.4)
        ax.legend()
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
