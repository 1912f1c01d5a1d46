"""H.264 / H.265 anchors, driven through ffmpeg (counterpart of
``tvc/bench/anchors.py``).

Encode a 30-frame yuv420 (or gray) clip with libx264/libx265 over a CRF
sweep, decode it back, convert YUV to RGB (BT.709, bicubic chroma
upsampling), and record PSNR (8-bit rounded, host float64), LPIPS and FVD
(on their metrics' device) and bpp from the file size. The array layout is
the reference anchors': (videos, 4 metrics [psnr, lpips, fvd, bpp], n_qp).

ffmpeg is an external binary; ``have_ffmpeg()`` says whether one is on PATH.
``ffmpeg_encode``/``ffmpeg_decode`` are module-level functions, so a test can
stand in for the codec.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from tvc_torch.bench.colorspace import rgb2ycbcr, ycbcr2rgb, yuv_420_to_444, yuv_444_to_420
from tvc_torch.metrics.pixel import psnr as _psnr


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


@dataclass
class RawVideoSequence:
    """Planar yuv420p reader over a flat uint8 buffer."""

    data: np.ndarray
    width: int
    height: int
    bitdepth: int = 8

    @property
    def frame_size(self) -> int:
        return self.width * self.height * 3 // 2

    def __len__(self) -> int:
        return len(self.data) // self.frame_size

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        fs = self.frame_size
        w, h = self.width, self.height
        frame = self.data[i * fs : (i + 1) * fs]
        y = frame[: w * h].reshape(h, w)
        u = frame[w * h : w * h + w * h // 4].reshape(h // 2, w // 2)
        v = frame[w * h + w * h // 4 :].reshape(h // 2, w // 2)
        return y, u, v


def write_yuv420(frames_rgb01: np.ndarray, path: str) -> None:
    """(T,H,W,3) [0,1] RGB -> planar yuv420p file (BT.709, avg-pool chroma)."""
    with open(path, "wb") as f:
        for frame in frames_rgb01:
            ycc = rgb2ycbcr(frame)
            y, u, v = yuv_444_to_420(ycc[..., 0], ycc[..., 1], ycc[..., 2])
            for plane in (y, u, v):
                f.write((np.clip(plane, 0, 1) * 255).round().astype(np.uint8).tobytes())


def write_gray(frames01: np.ndarray, path: str) -> None:
    """(T,H,W[,1]) [0,1] -> planar 8-bit gray file (the SMMNIST anchors code
    the luma plane only, ``-pix_fmt gray``)."""
    if frames01.ndim == 4:
        frames01 = frames01.mean(-1) if frames01.shape[-1] == 3 else frames01[..., 0]
    with open(path, "wb") as f:
        f.write((np.clip(frames01, 0, 1) * 255).round().astype(np.uint8).tobytes())


def read_gray_rgb(path: str, width: int, height: int, num_frames: int) -> np.ndarray:
    """Planar gray file -> (T,H,W,3) RGB [0,1] (gray replicated to 3ch, the
    metric stack's `trans` convention for 1-channel video)."""
    data = np.fromfile(path, dtype=np.uint8)
    fs = width * height
    t = min(num_frames, len(data) // fs)
    g = data[: t * fs].reshape(t, height, width).astype(np.float32) / 255.0
    return np.repeat(g[..., None], 3, axis=-1)


def ffmpeg_encode(raw: str, mp4: str, codec: str, qp: int, w: int, h: int,
                  framerate: int, pix_fmt: str) -> None:
    """One ffmpeg encode. Module-level, so a test can stand in for the codec."""
    subprocess.run(
        f"ffmpeg -loglevel error -framerate {framerate} -video_size {w}x{h} "
        f"-pix_fmt {pix_fmt} -f rawvideo -i {raw} -c:v {codec} -preset veryfast "
        f"-s {w}x{h} -crf {qp} -pix_fmt {pix_fmt} -tune zerolatency {mp4} -y",
        shell=True, check=True,
    )


def ffmpeg_decode(mp4: str, rec: str, pix_fmt: str) -> None:
    subprocess.run(
        f"ffmpeg -loglevel error -i {mp4} -pix_fmt {pix_fmt} -f rawvideo {rec} -y",
        shell=True, check=True,
    )


def read_yuv420_rgb(path: str, width: int, height: int, num_frames: int) -> np.ndarray:
    """Decode a yuv420p file to (T,H,W,3) RGB [0,1] (bicubic chroma up)."""
    data = np.fromfile(path, dtype=np.uint8)
    seq = RawVideoSequence(data, width, height)
    out = []
    for i in range(min(num_frames, len(seq))):
        y, u, v = seq[i]
        ycc = yuv_420_to_444(y / 255.0, u / 255.0, v / 255.0, mode="bicubic")
        out.append(ycbcr2rgb(ycc))
    return np.stack(out)


def compress_and_evaluate(
    video_rgb01: np.ndarray,
    workdir: str,
    codec: str = "libx264",
    qp_range: Sequence[int] = range(0, 52),
    framerate: int = 30,
    lpips_metric=None,
    fvd_metric=None,
    pix_fmt: str = "yuv420p",
    require_ffmpeg: bool = True,
) -> np.ndarray:
    """One video through the CRF sweep; returns (4, len(qp_range)): rows
    psnr, lpips, fvd, bpp. ``lpips_metric``/``fvd_metric`` (the port's
    ``LPIPSMetric``/``FVDMetric``, or None for NaN rows) run on their device."""
    if require_ffmpeg:
        assert have_ffmpeg(), "ffmpeg binary not available"
    os.makedirs(workdir, exist_ok=True)
    t, h, w, _ = video_rgb01.shape
    raw = os.path.join(workdir, "input.yuv")
    if pix_fmt == "gray":
        write_gray(video_rgb01, raw)
    else:
        write_yuv420(video_rgb01, raw)

    psnrs, lpipss, fvds, bpps = [], [], [], []
    for qp in qp_range:
        mp4 = os.path.join(workdir, f"compressed_qp{qp}_{codec}.mp4")
        rec = os.path.join(workdir, f"rec_qp{qp}.yuv")
        ffmpeg_encode(raw, mp4, codec, qp, w, h, framerate, pix_fmt)
        ffmpeg_decode(mp4, rec, pix_fmt)
        if pix_fmt == "gray":
            org = read_gray_rgb(raw, w, h, t)
            dec = read_gray_rgb(rec, w, h, t)
        else:
            org = read_yuv420_rgb(raw, w, h, t)
            dec = read_yuv420_rgb(rec, w, h, t)

        # PSNR of the 8-bit rounded frames
        org_u8 = np.clip(org * 255, 0, 255).round()
        dec_u8 = np.clip(dec * 255, 0, 255).round()
        psnrs.append(np.mean([_psnr(org_u8[i], dec_u8[i], 255.0) for i in range(t)]))

        if lpips_metric is not None:
            d = lpips_metric(org.astype(np.float32), dec.astype(np.float32))
            lpipss.append(float(np.mean(d.cpu().numpy())))
        else:
            lpipss.append(float("nan"))
        if fvd_metric is not None:
            v1 = np.repeat(org[None], 2, axis=0)
            v2 = np.repeat(dec[None], 2, axis=0)
            fvds.append(float(fvd_metric(v1, v2)))
        else:
            fvds.append(float("nan"))
        bpps.append(os.path.getsize(mp4) * 8.0 / (w * h * t))

    return np.stack([np.asarray(psnrs), np.asarray(lpipss), np.asarray(fvds), np.asarray(bpps)])


def build_anchor_array(
    videos_rgb01: np.ndarray,
    workdir: str,
    codec: str = "libx264",
    qp_range: Sequence[int] = range(0, 52),
    **kw,
) -> np.ndarray:
    """(V, T, H, W, 3) -> (V, 4, len(qp_range)) anchor array."""
    out = []
    for i, v in enumerate(videos_rgb01):
        out.append(compress_and_evaluate(v, os.path.join(workdir, f"v{i}"), codec, qp_range, **kw))
    return np.stack(out)
