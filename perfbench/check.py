"""The comparison that decides ``correct``.

After the window has closed, the program's state is freed and its peak
memory read, the plain reference (``perfbench/reference``: the configuration's
own net, its ``reference`` module, under the shared DDPM sampler, LPIPS and
ELIC) recomputes what the timed path produced on the calls sampled for it,
from the same inputs and the same weights, and the gaps between the two are
the numbers compared:

- ``pred_rms``: root mean square of the program's predicted frames less the
  reference's ([0, 1] pixels), over the sampled predictions. The reference
  draws each prediction's noise itself from the update's seed, which it
  derives from the unit's seed as the runners do, and conditions on the
  frames the program conditioned on (the decoded frames so far: the program's
  own state, which the reference follows step by step);
- ``lpips_gap``: the largest gap between the program's LPIPS scores and the
  reference's on the same frame pairs, over the mean reference score;
- ``recon_med``: the worst frame's median gap between the program's
  keyframe reconstructions and the reference coder's, on the same frames,
  over the pixels the reference leaves inside (0, 1) (both sides clamp to
  [0, 1]), each frame against the nearest of the reference's ways of
  resolving its rounding ties (``perfbench/reference/elic.py``). The
  program's reconstructions are taken twice: as the sender made them
  (``x_hat``, what the next prediction conditions on) and as its receiver
  decodes them from the exact rANS streams it sent (``decompress`` after the
  window); streams that do not decode read infinity. The worst
  frame, because one wrong frame, or half a batch, is a wrong answer; the
  median of a frame, because a clamped or flipped patch is not;
- ``gops_wrong``: GOPs of the window whose frame count, decisions or accept
  trajectory differ from what the traffic forces (exact: limit 0).

``bits_gap`` (the program's stream bits against the reference's information
content, over the latter), ``stream_gap`` (the widest gap between the
sender's ``x_hat`` and its streams' decoding, 0 where the two ends agree),
``recon_rms`` (against the reference's usual rounding), ``pred_max`` and
``tie_rows`` (the reference's rows beyond one a frame) are printed beside
them and not compared: no control separates ``bits_gap`` from the program's
own readings, ``stream_gap`` compares the program with itself, the next two
swing with rounding ties, and the last counts them.

A number passes when it is at most its limit (``perfbench/limits/<cell>.json``).
The control of a cell (``perfbench/control.py``) puts the reference, one
precision lower, in the program's place: ``Reference(net, cfg, states, precision)``.
"""

from __future__ import annotations

import json
import math
import sys
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference.elic import PlainELIC
from perfbench.reference.lpips import lpips as plain_lpips
from perfbench.reference.precision import plain_numerics
from perfbench.reference.ddpm import predict, update_seed

COMPARED = ("pred_rms", "lpips_gap", "recon_med", "gops_wrong")
INFO = ("pred_max", "recon_rms", "stream_gap", "tie_rows", "bits_gap")


def _dev(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def frame_bits(strings, batch: int) -> List[float]:
    """Bits of each frame's streams (y streams of every slice and phase, and z)."""
    y_strings, z_strings = strings
    bits = [8.0 * len(z_strings[b]) for b in range(batch)]
    for slice_streams in y_strings:
        for phase in slice_streams:
            for b in range(batch):
                bits[b] += 8.0 * len(phase[b])
    return bits


class Reference:
    """The plain reference over the benchmark's weights, in one precision:
    ``net.Net`` (``net`` the configuration's reference module) for the UNet."""

    def __init__(self, net: ModuleType, cfg: dict, states: Dict[str, Dict[str, torch.Tensor]],
                 precision: str = "f32"):
        self.cfg = cfg
        self.unet = net.Net(cfg, states["unet"], precision)
        self.elic = PlainELIC(states["elic"], cfg["codec"]["groups"], precision)
        self.lpips_state = states["lpips"]
        self.precision = precision

    def outputs(self, kept: dict, unit_seed: int, device) -> dict:
        """The reference's answers to the kept calls: predictions, scores,
        reconstructions and bits."""
        out = {"pred": [], "scores": [], "recon": [], "rows": [], "bits": []}
        with plain_numerics():
            for i, r in kept["generate"]:
                out["pred"].append(predict(self.cfg, self.unet, _dev(r["cond"], device),
                                           update_seed(unit_seed, i)))
            for _, r in kept["score"]:
                out["scores"].append(plain_lpips(self.lpips_state, _dev(r["a"], device),
                                                 _dev(r["b"], device), self.precision))
            for _, r in kept["keyframe"]:
                code = self.elic.code(_dev(r["x"], device))
                out["recon"].append(code["x_hat"])
                out["rows"].append((code["rows"], code["frame"]))
                out["bits"].append(code["bits"])
        return out


def decode_streams(coder, kept: dict) -> None:
    """The program's receiver side: each kept keyframe call's streams decoded
    by the coder's ``decompress`` (``x_dec``; None where they do not decode)."""
    for _, r in kept["keyframe"]:
        try:
            r["x_dec"] = coder.decompress(r["strings"], r["shape"])["x_hat"]
        except Exception as e:  # a stream that does not decode is a wrong answer
            print(f"[perfbench] streams do not decode: {type(e).__name__}: {e}", file=sys.stderr)
            r["x_dec"] = None


def program_outputs(kept: dict, device) -> dict:
    return {"pred": [_dev(r["pred"], device) for _, r in kept["generate"]],
            "scores": [_dev(r["scores"], device) for _, r in kept["score"]],
            "recon": [_dev(r["x_hat"], device) for _, r in kept["keyframe"]],
            "decoded": [None if r.get("x_dec") is None else _dev(r["x_dec"], device)
                        for _, r in kept["keyframe"]],
            "bits": [torch.tensor(frame_bits(r["strings"], len(r["x"])), device=device)
                     for _, r in kept["keyframe"]]}


def _rms(cand: List[torch.Tensor], ref: List[torch.Tensor]) -> Optional[float]:
    if not ref:
        return None
    sq = sum(float(((c - r) ** 2).sum()) for c, r in zip(cand, ref))
    return math.sqrt(sq / sum(r.numel() for r in ref))


def _worst_frame_median(cand: List[Optional[torch.Tensor]], rows: list) -> Optional[float]:
    """The largest, over frames, of a frame's median gap to the nearest of the
    reference's rows for it (``PlainELIC.code``: one a way of resolving the
    frame's rounding ties), over the pixels that row leaves strictly inside
    (0, 1): a pixel both sides clamp reads 0 whatever either computed. A
    missing candidate reads infinity."""
    worst = None
    for c, (ref_rows, frame) in zip(cand, rows):
        if c is None:
            return math.inf
        for b, cb in enumerate(c):
            meds = []
            for rb in ref_rows[frame == b]:
                inside = (rb > 0) & (rb < 1)
                if inside.any():
                    meds.append(float((cb - rb).abs()[inside].median()))
            if meds:
                worst = min(meds) if worst is None else max(worst, min(meds))
    return worst


def numbers(cand: dict, ref: dict) -> Dict[str, Optional[float]]:
    """The gaps between a candidate's answers and the reference's."""
    out: Dict[str, Optional[float]] = {"pred_rms": _rms(cand["pred"], ref["pred"])}
    out["pred_max"] = (max(float((c - r).abs().max()) for c, r in zip(cand["pred"], ref["pred"]))
                       if ref["pred"] else None)
    if ref["scores"]:
        gap = max(float((c - r).abs().max()) for c, r in zip(cand["scores"], ref["scores"]))
        mean = float(torch.cat(ref["scores"]).abs().mean())
        out["lpips_gap"] = gap / max(mean, 1e-12)
    else:
        out["lpips_gap"] = None
    out["recon_rms"] = _rms(cand["recon"], ref["recon"])
    recon = [_worst_frame_median(cand[k], ref["rows"]) for k in ("recon", "decoded") if k in cand]
    out["recon_med"] = None if None in recon or not recon else max(recon)
    out["stream_gap"] = (max(math.inf if d is None else float((d - c).abs().max())
                             for c, d in zip(cand["recon"], cand["decoded"]))
                         if cand.get("decoded") else None)
    out["tie_rows"] = float(sum(len(f) - len(r) for r, (_, f) in zip(ref["recon"], ref["rows"])))
    out["bits_gap"] = (max(float(((c - r).abs() / r).max()) for c, r in zip(cand["bits"], ref["bits"]))
                       if ref["bits"] else None)
    return out


def judge(values: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers that have a limit.
    A number that was due and is missing fails."""
    checks, correct = {}, True
    for name in COMPARED:
        if name not in limits:
            continue
        v = values.get(name)
        ok = v is not None and math.isfinite(v) and v <= limits[name]
        correct = correct and ok
        checks[name] = {"value": v, "limit": limits[name]}
    return correct, checks


def print_checks(checks: dict, values: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on stderr."""
    for name in INFO:
        if values.get(name) is not None:
            print(f"[perfbench] info {name} = {values[name]!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"[perfbench] check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)


def load_limits(path) -> Dict[str, float]:
    with open(path) as f:
        data = json.load(f)
    return {k: float(v["limit"]) for k, v in data["limits"].items()}
