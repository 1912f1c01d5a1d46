"""FVD: I3D features and the Fréchet distance (counterpart of
``tvc/metrics/fvd.py``).

Videos arrive as the sender and the sweep drivers pass them: numpy
(B, T, H, W, C) in [0, 1]. Each video's short side is resized to 224
(``jax.image.resize``'s bilinear, ``tvc_torch/ops/image_resize.py``), the
video centre-cropped and rescaled to [-1, 1], and the I3D runs in NCDHW on
the metric's device in batches of ``batch_size``. The
400-d features come back to the host, where ``frechet_distance`` (float64,
scipy) gives the scalar.

Without an I3D checkpoint the network runs on seeded random weights and the
metric says so (``calibrated=False``): the plumbing works, the number is
not the published FVD.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tvc_torch.core.runtime import resolve_device, to_tensor
from tvc_torch.metrics.frechet import frechet_distance
from tvc_torch.models.i3d import InceptionI3d
from tvc_torch.ops.image_resize import resize


def preprocess_video(video: torch.Tensor, resolution: int = 224) -> torch.Tensor:
    """(T, H, W, C) in [0, 1] -> (T, C, res, res) in [-1, 1]: the short side
    resized to ``resolution`` (the long side to the ceiling), then a centre crop."""
    t, h, w, c = video.shape
    scale = resolution / min(h, w)
    if h < w:
        target = (resolution, math.ceil(w * scale))
    else:
        target = (math.ceil(h * scale), resolution)
    x = resize(video.permute(0, 3, 1, 2), target)
    h0 = (target[0] - resolution) // 2
    w0 = (target[1] - resolution) // 2
    x = x[:, :, h0:h0 + resolution, w0:w0 + resolution]
    return (x - 0.5) * 2.0


class FVDMetric:
    """I3D feature extractor and Fréchet distance on ``device``.

    The I3D runs on cuDNN's heuristic choice of algorithms, as the rest of
    the port at B = 1: on an H100 it is as fast as cuDNN's timed choice
    (``chip_smoke.py`` phase 14 times both).
    """

    def __init__(self, i3d_state_dict: Optional[dict] = None, batch_size: int = 10,
                 device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        model = InceptionI3d(device="cpu")
        self.calibrated = i3d_state_dict is not None
        if self.calibrated:
            model.load_state_dict(i3d_state_dict, strict=True)
        else:
            model.init_weights(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size

    @torch.no_grad()
    def features(self, videos) -> np.ndarray:
        """(B, T, H, W, C) in [0, 1] -> (B, 400) float32 features on the host."""
        videos = to_tensor(videos, self.device)
        out = []
        for i in range(0, videos.shape[0], self.batch_size):
            batch = torch.stack([preprocess_video(v) for v in videos[i:i + self.batch_size]])
            out.append(self.model(batch.transpose(1, 2).contiguous()).cpu().numpy())
        return np.concatenate(out, axis=0)

    def __call__(self, videos1, videos2) -> float:
        """Scalar FVD between two video batches of one shape; grayscale
        videos are repeated to three channels."""
        videos1 = _to_rgb(np.asarray(videos1))
        videos2 = _to_rgb(np.asarray(videos2))
        assert videos1.shape == videos2.shape
        return frechet_distance(self.features(videos1), self.features(videos2))


def _to_rgb(v: np.ndarray) -> np.ndarray:
    if v.shape[-1] == 1:
        v = np.repeat(v, 3, axis=-1)
    return v
