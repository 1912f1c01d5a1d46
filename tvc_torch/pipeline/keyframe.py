"""Keyframe coding: pad, compress, reconstruct, unpad, count bits (counterpart
of ``tvc/pipeline/keyframe.py``). Frames are coded as one batch."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tvc_torch.models.codec.coding import ELICCoder


def pad_to_multiple(x: np.ndarray, patch: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad (B, H, W, C) at the bottom and right to multiples of ``patch``."""
    h, w = x.shape[1], x.shape[2]
    pad_b = (h + patch - 1) // patch * patch - h
    pad_r = (w + patch - 1) // patch * patch - w
    if pad_b or pad_r:
        x = np.pad(x, ((0, 0), (0, pad_b), (0, pad_r), (0, 0)))
    return x, (pad_b, pad_r)


def per_frame_bits(strings, batch: int) -> List[int]:
    """Bits of each batch element, over the y and z streams."""
    y, z = per_frame_bits_split(strings, batch)
    return [yb + zb for yb, zb in zip(y, z)]


def per_frame_bits_split(strings, batch: int) -> Tuple[List[int], List[int]]:
    """Per batch element (y bits, z bits)."""
    y_strings, z_strings = strings
    y_bits = [0] * batch
    z_bits = [len(z_strings[b]) * 8 for b in range(batch)]
    for b in range(batch):
        for slice_streams in y_strings:
            for phase in slice_streams:  # [anchor, non_anchor]
                y_bits[b] += len(phase[b]) * 8
    return y_bits, z_bits


def code_frames_enc(coder: ELICCoder, frames: np.ndarray, patch: int = 64, exact: bool = True,
                    recon_device: bool = False):
    """Code a (T, H, W, 3) [0, 1] stack. Returns (decoded frames (T, H, W, 3),
    per-frame bits, the coder's output with its streams); the decoded frames
    are a host array, or with ``recon_device`` a tensor on the coder's device.
    ``exact=False`` takes the simulation coder (``ELICCoder.compress``)."""
    frames = np.asarray(frames, np.float32)
    x, (pad_b, pad_r) = pad_to_multiple(frames, patch)
    enc = coder.compress(x, return_recon=True, exact=exact, recon_device=recon_device)
    x_hat = enc["x_hat"][:, : x.shape[1] - pad_b, : x.shape[2] - pad_r, :]
    return x_hat, per_frame_bits(enc["strings"], frames.shape[0]), enc


def code_frames(coder: ELICCoder, frames: np.ndarray, patch: int = 64,
                exact: bool = True) -> Tuple[np.ndarray, List[int]]:
    """Encode and reconstruct a (T, H, W, 3) [0, 1] stack; (decoded frames,
    per-frame bits). The reconstruction comes from the encoder's decoded
    latents, which equal the decoder's. ``exact=False`` takes the simulation
    coder of the rate sweep, whose streams are not transmissible."""
    x_hat, bits, _ = code_frames_enc(coder, frames, patch, exact)
    return x_hat, bits


def code_frames_device(coder: ELICCoder, frames: np.ndarray, patch: int = 64,
                       exact: bool = True, return_enc: bool = False):
    """``code_frames`` whose reconstruction stays on the coder's device: the
    device-resident GOP loop feeds it to the next prediction without a trip
    through the host. Returns (x_hat (T, H, W, 3) tensor, per-frame bits), and
    the coder's output too with ``return_enc``."""
    x_hat, bits, enc = code_frames_enc(coder, frames, patch, exact, recon_device=True)
    return (x_hat, bits, enc) if return_enc else (x_hat, bits)
