"""Decode a default-width ELIC container written by the JAX package, and count
how many of its streams give the JAX package's symbols.

The fixture ``tvc_torch/testdata/cross_decode_elic.npz`` holds a TVC2
container (``"cpu"`` entropy backend) of two seeded 128x128 frames coded by
``tvc/``'s ``ELICCoder`` at N 192, M 320, the symbols ``tvc/`` decodes from
each stream (the z stream of each frame, and the anchor and non-anchor
stream of each slice of each frame), its reconstruction, and a SHA-256 of
the weights. The weights themselves are not stored: ``draw_weights`` makes
them again from the fixture's seed with ``numpy.random.default_rng``, which
gives the same bits on every host. ``tests/test_torch_cross_decode.py
--write`` writes the fixture; that file's test decodes it on the CPU, and
``tests/test_torch_gpu.py`` on the card.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, List

import numpy as np
import torch

from tvc_torch.core.runtime import resolve_device
from tvc_torch.models.codec import container
from tvc_torch.models.codec.coding import ELICCoder
from tvc_torch.models.codec.elic import ELICModel

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "testdata", "cross_decode_elic.npz")
N, M, GROUPS = 192, 320, (16, 16, 32, 64, 192)
SEED = 2026
G_A_GAIN, G_S_GAIN = 1.1, 0.5


def draw_weights(seed: int = SEED) -> ELICModel:
    """The default-width ELIC with every parameter drawn from
    ``default_rng(seed)`` in state-dict order: conv weights N(0, gain^2 /
    fan_in) (gain 1.1 in g_a, so the latents span many integers, 0.5 in g_s),
    the factorized prior's quantiles ordered around N(0, 1) medians, its other
    tensors N(0, 0.7^2), the rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    model = ELICModel(N, M, GROUPS, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("quantiles"):
                c = p.shape[0]
                med = rng.standard_normal(c)
                lo, hi = rng.uniform(4, 12, c), rng.uniform(4, 12, c)
                v = np.stack([med - lo, med, med + hi]).T[:, None, :]
            elif "entropy_bottleneck" in name:
                v = rng.standard_normal(p.shape) * 0.7
            elif p.dim() == 4:
                gain = G_S_GAIN if name.startswith("g_s.") else G_A_GAIN
                v = rng.standard_normal(p.shape) * gain / math.sqrt(p[0].numel())
            else:
                v = rng.standard_normal(p.shape) * 0.1
            p.copy_(torch.tensor(v, dtype=torch.float32))
    return model.eval()


def weights_sha256(model: ELICModel) -> str:
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def stream_names(frames: int, slices: int = len(GROUPS)) -> List[str]:
    """The streams in the order the port decodes them: z of every frame, then
    each frame's slices, anchor before non-anchor."""
    return [f"z_f{f}" for f in range(frames)] + [
        f"y_f{f}_s{i}_{part}" for f in range(frames) for i in range(slices)
        for part in ("anchor", "nonanchor")]


def load_fixture(path: str = FIXTURE) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def decode(device="cuda", path: str = FIXTURE) -> dict:
    """Decode the fixture's container in the port on ``device`` (the card
    unless the caller asks for the CPU); per stream, whether the port's
    symbols equal the JAX package's, and the reconstruction's largest
    difference from the JAX package's. Raises ValueError when the weights
    drawn here are not the fixture's."""
    dev = resolve_device(device)
    fx = load_fixture(path)
    model = draw_weights(int(fx["seed"]))
    digest = weights_sha256(model)
    if digest != str(fx["weights_sha256"]):
        raise ValueError(f"weight hash mismatch: the weights drawn from seed {int(fx['seed'])} "
                         f"hash to {digest}, the fixture's to {fx['weights_sha256']}; "
                         "the drawing or the model's parameters changed")
    enc = container.deserialize(fx["container"].tobytes(), expect_entropy_backend="cpu")
    coder = ELICCoder(model.to(dev), "cpu")
    decoded = []
    for dec in (coder.fb._dec, coder.gc._dec):
        def rec(*args, _orig=dec.decode_batch):
            out = _orig(*args)
            decoded.extend(np.asarray(out).reshape(len(args[0]), -1))
            return out
        dec.decode_batch = rec
    x_hat = coder.decompress(enc["strings"], enc["shape"])["x_hat"]
    names = stream_names(x_hat.shape[0])
    same = {n: bool(len(decoded) == len(names) and np.array_equal(got, fx[n]))
            for n, got in zip(names, decoded)}
    return {"device": str(dev), "streams": len(names), "matched": sum(same.values()),
            "per_stream": same, "x_hat_max_abs_diff": float(np.abs(x_hat - fx["x_hat"]).max()),
            "x_hat_max_abs": float(np.abs(fx["x_hat"]).max()),
            "container_bytes": int(fx["container"].size)}

