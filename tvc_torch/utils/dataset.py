"""Dataset preparation (counterpart of ``tvc/utils/dataset.py``): a centre
crop and Lanczos resize to the model's size, frame dumps between npy and PNG,
and the collation of metric text files into anchor arrays.

The JAX package reaches PIL for the resize and the PNG files; the card's
machine has no PIL, so both are written here:

- ``lanczos_resize`` is PIL's ``Image.resize(..., LANCZOS)`` on 8-bit
  images: a separable a = 3 windowed sinc whose support widens by the scale
  when it shrinks, coefficients normalised and rounded to 22-bit fixed
  point, the horizontal pass first, rounded and clipped to 8 bits between
  the passes (Pillow's ``Resample.c``);
- ``write_png`` writes 8-bit RGB with filter 0 and zlib; ``read_png`` reads
  8-bit greyscale, RGB, palette and alpha images, non-interlaced, with any of
  the five row filters, and returns RGB.
"""

from __future__ import annotations

import math
import os
import re
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

LANCZOS_SUPPORT = 3.0
PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -LANCZOS_SUPPORT <= x < LANCZOS_SUPPORT else 0.0


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), fixed-point weights (out, ksize)) of one axis."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        total = sum(k)
        if total != 0.0:
            k = [w / total for w in k]
        starts[xx] = xmin
        weights[xx, :xmax] = [int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0
                              else int(0.5 + w * (1 << PRECISION_BITS)) for w in k]
    return starts, weights


def _resample_axis0(img: np.ndarray, out_size: int) -> np.ndarray:
    """One 8-bit pass along axis 0 of an (n, m, c) uint8 array."""
    starts, weights = _coefficients(img.shape[0], out_size)
    src = np.concatenate([img.astype(np.int64),
                          np.zeros((weights.shape[1],) + img.shape[1:], np.int64)])
    idx = starts[:, None] + np.arange(weights.shape[1])[None]  # (out, ksize); padding weighs 0
    acc = np.einsum("ok,okmc->omc", weights, src[idx]) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def lanczos_resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, as PIL's LANCZOS resize."""
    out = img
    if width != img.shape[1]:
        out = _resample_axis0(out.transpose(1, 0, 2), width).transpose(1, 0, 2)
    if height != img.shape[0]:
        out = _resample_axis0(out, height)
    return np.ascontiguousarray(out)


def center_crop_resize(img: np.ndarray, size: int = 128) -> np.ndarray:
    """(H, W, 3) uint8 or float -> (size, size, 3) uint8: the centre square
    crop, Lanczos-resized."""
    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    crop = img[top: top + s, left: left + s]
    if crop.dtype != np.uint8:
        crop = np.clip(crop * 255 if crop.max() <= 1.0 else crop, 0, 255).astype(np.uint8)
    return lanczos_resize(crop, size, size)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG, every row filter 0."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png writes RGB, not {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) bytes of a non-interlaced image from its filtered rows."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    data = data[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(data[y, 0]), data[y, 1:].astype(np.int64)
        if ftype == 0:
            row = line
        elif ftype == 1:  # Sub: a running sum per byte of a pixel
            row = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            row = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: each pixel needs the one before
            row = np.zeros(stride, np.int64)
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(0, stride, bpp):
                up = prev[x: x + bpp]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, up_left)
                left = (line[x: x + bpp] + pred) & 0xFF
                row[x: x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"unknown PNG row filter {ftype}")
        out[y] = row
        prev = row
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG (greyscale, RGB, palette, with or without alpha) as
    (H, W, 3) uint8 RGB; alpha is dropped, as PIL's ``convert("RGB")`` does."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos: pos + 4])
        kind, data = blob[pos + 4: pos + 8], blob[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are read "
                         f"(depth {depth}, color type {color}, interlace {interlace})")
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    pix = pix.reshape(h, w, channels)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: a palette image without PLTE")
        return palette[pix[..., 0]]
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def video_to_pngs(video: np.ndarray, out_dir: str, prefix: str = "frame") -> List[str]:
    """(T, H, W, 3) in [0, 1] -> a PNG per frame."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, frame in enumerate(video):
        p = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
        write_png(p, np.clip(frame * 255, 0, 255).astype(np.uint8))
        paths.append(p)
    return paths


def pngs_to_video(paths: Sequence[str]) -> np.ndarray:
    """PNG files -> (T, H, W, 3) float32 in [0, 1]."""
    return np.stack([read_png(p) / 255.0 for p in paths]).astype(np.float32)


def build_dataset_npy(video_dirs: Sequence[str], out_path: str, size: int = 128,
                      num_frames: int = 30) -> np.ndarray:
    """A folder of PNGs per video -> a (B, T, C, H, W) npy in the [0, 255]
    range (the city_bonn.npy layout), float32."""
    videos = []
    for d in video_dirs:
        paths = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.lower().endswith(".png"))[:num_frames]
        videos.append(np.stack([center_crop_resize(read_png(p), size) for p in paths]))
    arr = np.transpose(np.stack(videos), (0, 1, 4, 2, 3)).astype(np.float32)
    np.save(out_path, arr)
    return arr


_METRIC_RE = re.compile(
    r"PSNR:\s*([\d.eE+-]+).*?LPIPS:\s*\[*([\d.eE+-]+).*?FVD:\s*([\d.eE+-]+).*?BPP:\s*([\d.eE+-]+)"
)


def collate_metric_txt(paths: Sequence[str]) -> np.ndarray:
    """``psnr_lpips_fvd_bpp.txt`` files -> the (videos, 4, QPs) anchor layout
    [psnr, lpips, fvd, bpp]."""
    out = []
    for p in paths:
        rows: List[List[float]] = [[], [], [], []]
        with open(p) as f:
            for line in f:
                m = _METRIC_RE.search(line)
                if m:
                    for i in range(4):
                        rows[i].append(float(m.group(i + 1)))
        out.append(np.asarray(rows))
    return np.stack(out)
