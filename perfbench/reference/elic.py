"""Plain ELIC keyframe coder: the reference of a keyframe coding event.

ELIC (He et al., CVPR 2022) as the reference's ``TestModel`` lays it out:
analysis and synthesis transforms of residual-bottleneck groups and
attention blocks, a hyperprior, channel-conditional transforms over uneven
groups and a two-phase checkerboard context per group. This is the coder's
deterministic side as plain ``torch`` operations in float32, every frame of
a batch at once: rounding against the means in each phase, the
reconstruction of the decoded latents, and the information content of the
symbols under the model (the bits an ideal entropy coder spends). Weights
come from a state dict under the reference's keys (``g_a.0.weight``, ...).

Rounding ties. A value to be rounded (``z - median``, ``y - mu``) that lies
within rounding error of a half is rounded either way by two sound
implementations, and a flipped symbol moves every later mean of its frame
(the checkerboard context, the channel-conditional transforms), so the
frame's whole reconstruction differs. Where a value lies within ``TIE``
(relative to the magnitudes it is made of) of a half, the reference
therefore follows both roundings: each frame becomes one or more rows, one
row a way of resolving its near ties (at most ``MAX_TIES`` in one phase of
one row, ``MAX_ROWS`` rows a frame; past these caps the usual rounding
alone). A program's frame is then compared with the nearest of its rows.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

SCALE_MIN = 0.11           # the Gaussian model's smallest scale
LIKELIHOOD_MIN = 1e-9      # the floor of a symbol's probability
TIE = 1e-5                 # a near tie: |frac(v) - 1/2| < TIE * (1 + the magnitudes of v's parts)
MAX_TIES = 4               # near ties of one row in one phase that are followed both ways
MAX_ROWS = 32              # rows of one frame


class PlainELIC:
    def __init__(self, state: Dict[str, torch.Tensor], groups: Sequence[int],
                 precision: str = "f32"):
        self.s = state
        self.groups = tuple(groups)
        self.M = sum(self.groups)
        self.p = Precision(precision)

    def w(self, key):
        return self.s[key].float()

    def conv(self, key, x, stride=1):
        wt = self.w(key + ".weight")
        return self.p.conv2d(x, wt, self.w(key + ".bias"), stride=stride,
                             padding=wt.shape[-1] // 2)

    def deconv(self, key, x):
        wt = self.w(key + ".weight")
        return self.p.conv_transpose2d(x, wt, self.w(key + ".bias"), stride=2,
                                       padding=wt.shape[-1] // 2, output_padding=1)

    def rbb(self, key, x):
        h = F.relu(self.conv(key + ".conv1", x))
        h = F.relu(self.conv(key + ".conv2", h))
        return x + self.conv(key + ".conv3", h)

    def unit(self, key, x):
        h = F.relu(self.conv(key + ".conv.0", x))
        h = F.relu(self.conv(key + ".conv.2", h))
        return F.relu(x + self.conv(key + ".conv.4", h))

    def attention(self, key, x):
        a = x
        for j in range(3):
            a = self.unit(f"{key}.conv_a.{j}", a)
        b = x
        for j in range(3):
            b = self.unit(f"{key}.conv_b.{j}", b)
        b = self.conv(f"{key}.conv_b.3", b)
        return x + a * torch.sigmoid(b)

    def g_a(self, x):
        for j in range(15):
            key = f"g_a.{j}"
            if j in (0, 4, 9, 13):
                x = self.conv(key, x, stride=2)
            elif j in (8, 14):
                x = self.attention(key, x)
            else:
                x = self.rbb(key, x)
        return x

    def g_s(self, y):
        for j in range(15):
            key = f"g_s.{j}"
            if j in (1, 5, 10, 14):
                y = self.deconv(key, y)
            elif j in (0, 6):
                y = self.attention(key, y)
            else:
                y = self.rbb(key, y)
        return y

    def h_a(self, y):
        z = F.relu(self.conv("h_a.0", y))
        z = F.relu(self.conv("h_a.2", z, stride=2))
        return self.conv("h_a.4", z, stride=2)

    def h_s(self, z):
        h = F.relu(self.deconv("h_s.0", z))
        h = F.relu(self.deconv("h_s.2", h))
        return self.conv("h_s.4", h)

    def aggregate(self, i, x):
        h = F.relu(self.conv(f"ParamAggregation.{i}.0", x))
        h = F.relu(self.conv(f"ParamAggregation.{i}.2", h))
        return self.conv(f"ParamAggregation.{i}.4", h).chunk(2, dim=1)

    def context(self, i, y_anchor):
        wt = self.w(f"context_prediction.{i}.weight")
        mask = torch.zeros(wt.shape[-2:], device=wt.device)
        mask[0::2, 1::2] = 1.0
        mask[1::2, 0::2] = 1.0
        return self.p.conv2d(y_anchor, wt * mask, self.w(f"context_prediction.{i}.bias"),
                             padding=wt.shape[-1] // 2)

    def cc(self, i, sup):
        h = F.relu(self.conv(f"cc_transforms.{i - 1}.0", sup))
        h = F.relu(self.conv(f"cc_transforms.{i - 1}.2", h))
        return self.conv(f"cc_transforms.{i - 1}.4", h)

    def factorized_likelihood(self, z):
        """P(z_hat) under the factorized prior, (B, C, h, w)."""
        b, c, hh, ww = z.shape
        x = z.permute(1, 0, 2, 3).reshape(c, 1, -1)

        def logits(v):
            k = 0
            while f"entropy_bottleneck._matrices.{k}" in self.s:
                m = self.w(f"entropy_bottleneck._matrices.{k}")
                v = torch.matmul(F.softplus(m), v) + self.w(f"entropy_bottleneck._biases.{k}")
                fk = f"entropy_bottleneck._factors.{k}"
                if fk in self.s:
                    v = v + torch.tanh(self.w(fk)) * torch.tanh(v)
                k += 1
            return v

        lo, up = logits(x - 0.5), logits(x + 0.5)
        sign = -torch.sign(lo + up)
        lk = torch.abs(torch.sigmoid(sign * up) - torch.sigmoid(sign * lo))
        return torch.clamp(lk, min=LIKELIHOOD_MIN).reshape(c, b, hh, ww).permute(1, 0, 2, 3)

    @staticmethod
    def gaussian_likelihood(sym, scale):
        """P(sym) for integer residuals ``sym`` under N(0, scale^2)."""
        s = torch.clamp(scale, min=SCALE_MIN)
        v = torch.abs(sym)
        up = 0.5 * torch.erfc(-((0.5 - v) / s) / math.sqrt(2.0))
        lo = 0.5 * torch.erfc(-((-0.5 - v) / s) / math.sqrt(2.0))
        return torch.clamp(up - lo, min=LIKELIHOOD_MIN)

    @staticmethod
    def _round(v, mag, used, frame, default):
        """Round ``v`` (R, C, H, W) to integers, following both roundings of
        each near tie at the positions ``used`` (a (H, W) mask, or None for
        all). Returns (symbols (R', C, H, W), the row each came from (R'),
        which rows keep the usual rounding (R'))."""
        r = torch.round(v)
        near = (v - torch.floor(v) - 0.5).abs() < TIE * (1.0 + mag)
        if used is not None:
            near = near & used
        counts = near.flatten(1).sum(1).tolist()
        src = torch.arange(len(v), device=v.device)
        if not any(counts):
            return r, src, default
        per_frame = torch.bincount(frame).tolist()
        out, rows, dflt = [], [], []
        for i, k in enumerate(counts):
            f = int(frame[i])
            if k == 0 or k > MAX_TIES or per_frame[f] + (1 << k) - 1 > MAX_ROWS:
                out.append(r[i]), rows.append(i), dflt.append(bool(default[i]))
                continue
            per_frame[f] += (1 << k) - 1
            pos = near[i].nonzero(as_tuple=True)
            lo = torch.floor(v[i][pos])
            usual = r[i][pos]
            for combo in range(1 << k):
                up = torch.tensor([(combo >> j) & 1 for j in range(k)], dtype=v.dtype,
                                  device=v.device)
                ri = r[i].clone()
                ri[pos] = lo + up
                out.append(ri), rows.append(i)
                dflt.append(bool(default[i]) and bool(torch.equal(lo + up, usual)))
        return (torch.stack(out), torch.tensor(rows, device=v.device),
                torch.tensor(dflt, device=v.device))

    def code(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) in [0, 1], H and W multiples of 64 -> ``x_hat``, the
        reconstruction under the usual rounding (B, H, W, 3), and ``bits`` a
        frame under it (B,); ``rows`` (R, H, W, 3), the reconstructions of
        every way of resolving the near ties, and ``frame`` (R,), the frame of
        each row."""
        xt = x.float().permute(0, 3, 1, 2)
        y = self.g_a(xt)
        z = self.h_a(y)
        frame = torch.arange(len(y), device=y.device)
        default = torch.ones(len(y), dtype=torch.bool, device=y.device)
        med = self.w("entropy_bottleneck.quantiles")[:, 0, 1][None, :, None, None]
        sym, src, default = self._round(z - med, z.abs() + med.abs(), None, frame, default)
        y, frame = y[src], frame[src]
        z_hat = sym + med
        bits = -torch.log2(self.factorized_likelihood(z_hat)).sum(dim=(1, 2, 3))
        lm, ls = self.h_s(z_hat).chunk(2, dim=1)
        hh, ww = y.shape[2:]
        ii = torch.arange(hh, device=y.device)[:, None]
        jj = torch.arange(ww, device=y.device)[None, :]
        anchor = ((ii + jj) % 2 == 0).float()
        first = prev = None
        slices = []
        offs = [0]
        for g in self.groups:
            offs.append(offs[-1] + g)
        for i in range(len(self.groups)):
            ys = y[:, offs[i]: offs[i + 1]]
            if i == 0:
                sup = torch.cat([lm, ls], dim=1)
            else:
                cm, cs = self.cc(i, first if i == 1 else torch.cat([first, prev], dim=1)).chunk(2, 1)
                sup = torch.cat([cm, cs, lm, ls], dim=1)
            zeros = sup.new_zeros((sup.shape[0], 2 * self.groups[i], hh, ww))
            mu_a, sc_a = self.aggregate(i, torch.cat([zeros, sup], dim=1))
            r_a, src, default = self._round(ys - mu_a, ys.abs() + mu_a.abs(), anchor.bool(),
                                            frame, default)
            y, ys, frame, mu_a, sc_a, sup, lm, ls, bits = (
                t[src] for t in (y, ys, frame, mu_a, sc_a, sup, lm, ls, bits))
            slices = [t[src] for t in slices]
            first = None if first is None else first[src]
            ya = (r_a + mu_a) * anchor
            mu_n, sc_n = self.aggregate(i, torch.cat([self.context(i, ya), sup], dim=1))
            r_n, src, default = self._round(ys - mu_n, ys.abs() + mu_n.abs(),
                                            (1.0 - anchor).bool(), frame, default)
            y, ys, frame, mu_a, sc_a, mu_n, sc_n, r_a, ya, lm, ls, bits = (
                t[src] for t in (y, ys, frame, mu_a, sc_a, mu_n, sc_n, r_a, ya, lm, ls, bits))
            slices = [t[src] for t in slices]
            first = None if first is None else first[src]
            yn = (r_n + mu_n) * (1.0 - anchor)
            lk = (self.gaussian_likelihood(r_a, sc_a) * anchor
                  + self.gaussian_likelihood(r_n, sc_n) * (1.0 - anchor))
            bits = bits - torch.log2(lk).sum(dim=(1, 2, 3))
            y_hat = ya + yn
            if i == 0:
                first = y_hat
            prev = y_hat
            slices.append(y_hat)
        rows = torch.clamp(self.g_s(torch.cat(slices, dim=1)), 0.0, 1.0).permute(0, 2, 3, 1)
        return {"x_hat": rows[default], "bits": bits[default], "rows": rows, "frame": frame}
