"""A run whose timed path is broken underneath comes out not correct.

The harness's look for a card is skipped (the CPU); the rest of a run goes
as on the card at tiny sizes, under the float32 cell's limits, with one
fault planted in the program each time."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.harness import run_cell
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.models.codec.coding import ELICCoder
from tvc_torch.pipeline.predictor import FramePredictor


def unchanged_state(mp):
    # every sampler step leaves its state as drawn
    mp.setattr(FramePredictor, "_sample", lambda self, x_init, cond, *a, **k: x_init[None])


def half_batch(mp):
    # the second half of a batch is left out: it repeats the first half's predictions
    orig = FramePredictor.generate

    def generate(self, cond_frames, *a, **k):
        out = orig(self, cond_frames, *a, **k).clone()
        h = out.shape[0] // 2
        out[h:] = out[: out.shape[0] - h]
        return out

    mp.setattr(FramePredictor, "generate", generate)


def altered_frame(mp):
    orig = FramePredictor.generate

    def generate(self, *a, **k):
        out = orig(self, *a, **k).clone()
        out[:, -1] = torch.clamp(out[:, -1] + 0.05, 0.0, 1.0)
        return out

    mp.setattr(FramePredictor, "generate", generate)


def altered_score(mp):
    orig = LPIPSMetric.__call__
    mp.setattr(LPIPSMetric, "__call__", lambda self, a, b: orig(self, a, b) * 1.05)


def altered_keyframe(mp):
    orig = ELICCoder.compress

    def compress(self, *a, **k):
        out = orig(self, *a, **k)
        out["x_hat"] = out["x_hat"] + 0.02
        return out

    mp.setattr(ELICCoder, "compress", compress)


def _replace_x_hat(out, fn):
    x = out["x_hat"]
    x = x.clone() if torch.is_tensor(x) else np.array(x)
    fn(x)
    out["x_hat"] = x


def half_keyframes(mp):
    # the second half of a keyframe batch repeats the first half's reconstructions
    orig = ELICCoder.compress

    def compress(self, x, *a, **k):
        out = orig(self, x, *a, **k)
        h = len(x) // 2

        def fn(t):
            t[h:] = t[: len(x) - h]

        _replace_x_hat(out, fn)
        return out

    mp.setattr(ELICCoder, "compress", compress)


def uncoded_pair(mp):
    # every other keyframe pair is passed on uncoded: its frames stand for their reconstruction
    orig = ELICCoder.compress
    calls = []

    def compress(self, x, *a, **k):
        out = orig(self, x, *a, **k)
        calls.append(1)
        if len(calls) % 2 == 0:
            def fn(t):
                t[...] = torch.as_tensor(np.asarray(x), device=t.device) if torch.is_tensor(t) else x

            _replace_x_hat(out, fn)
        return out

    mp.setattr(ELICCoder, "compress", compress)


def corrupt_stream(mp):
    # one byte of the first frame's first anchor stream flipped after coding
    orig = ELICCoder.compress

    def compress(self, *a, **k):
        out = orig(self, *a, **k)
        first = out["strings"][0][0][0]
        b = bytearray(first[0])
        b[len(b) // 2] ^= 0xFF
        first[0] = bytes(b)
        return out

    mp.setattr(ELICCoder, "compress", compress)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.gop", unchanged_state), ("tiny.lock", unchanged_state), ("tiny.lock", half_batch),
    ("tiny.gop", altered_frame), ("tiny.gop", altered_score), ("tiny.lock", altered_score),
    ("tiny.gop", altered_keyframe), ("tiny.lock", altered_keyframe),
    ("tiny.gop", half_keyframes), ("tiny.lock", half_keyframes), ("tiny.gop", uncoded_pair),
    ("tiny.gop", corrupt_stream), ("tiny.lock", corrupt_stream)])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_cell(cell, 2 ** 31 + 7, 0.01, False, device="cpu", root=tiny_root)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["tiny.gop", "tiny.lock"])
def test_sound_run_is_correct(tiny_root, cell):
    assert run_cell(cell, 2 ** 31 + 7, 0.01, False, device="cpu", root=tiny_root)["correct"]
