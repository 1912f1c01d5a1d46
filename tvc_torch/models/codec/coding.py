"""The ELIC bitstream coder (counterpart of ``tvc/models/codec/coding.py``, exact path).

``compress`` codes the hyper latent z through the factorized coder, then each
slice of y in two checkerboard phases (anchors, then non-anchors) through the
Gaussian coder; ``decompress`` mirrors it from the bitstreams alone.

rANS decodes only if the receiver reproduces the sender's entropy parameters
bit for bit: one ulp can move a scale across a table boundary and desync the
stream. The big transforms (g_a, h_a, g_s) only make or consume latents, so
they run on the model's device in one batched call. The entropy-parameter
chain (h_s, then per slice the cc, context and aggregation convs) runs
frame by frame at B = 1 in both ``compress`` and ``decompress``, the same ops
at the same shapes at both ends, on

- ``entropy_backend="cpu"``: the host, in a copy of the model on the CPU, with
  the intra-op thread count fixed to ``CHAIN_THREADS`` while the chain runs;
- ``entropy_backend="device"``: the model's device.

The TVC2 container records the backend, and a receiver with the other one
refuses the container. Rounding against the means (``round(y - mu)`` in
float32) and the scale indexes (float64 table) are host numpy, as in the JAX
package. Streams are laid out in (C, H, W/2) order per phase and frame.

Every tensor the chain takes is a contiguous NCHW copy (``_chain_input``): a
convolution may pick another algorithm for another memory format (on the
host, oneDNN's channels-last path gives other bits than its NCHW path), and
the encoder's latents come out of g_a in the layout of its input, the
decoder's from numpy.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from tvc_torch.entropy.factorized import FactorizedCoder
from tvc_torch.entropy.gaussian import GaussianCoder
from tvc_torch.models.codec import checkerboard as cb
from tvc_torch.models.codec.elic import ELICModel

# intra-op threads of the chain on the "cpu" backend: a receiver in another
# process or on another host gets the same sums whatever its default
CHAIN_THREADS = 1

BACKENDS = ("cpu", "device")


def _host(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous host copy."""
    return np.ascontiguousarray(t.detach().to("cpu").numpy())


def _chain_input(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float32 host array as a contiguous NCHW tensor on ``device``."""
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)


class ELICCoder:
    """An ``ELICModel`` bound to the host entropy coders."""

    def __init__(self, model: ELICModel, entropy_backend: str = "cpu"):
        if entropy_backend not in BACKENDS:
            raise ValueError(f"entropy_backend must be one of {BACKENDS}, got {entropy_backend!r}")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.entropy_backend = entropy_backend
        self.fb = FactorizedCoder.from_module(model.entropy_bottleneck)
        self.gc = GaussianCoder()
        if entropy_backend == "cpu" and self.device.type != "cpu":
            self._chain = copy.deepcopy(model).to("cpu").eval()
        else:
            self._chain = self.model
        self.chain_device = next(self._chain.parameters()).device

    @contextlib.contextmanager
    def _chain_numerics(self):
        """No autograd; on the host, a fixed thread count."""
        with torch.no_grad():
            if self.chain_device.type != "cpu":
                yield
                return
            threads = torch.get_num_threads()
            torch.set_num_threads(CHAIN_THREADS)
            try:
                yield
            finally:
                torch.set_num_threads(threads)

    # ---------------- one phase, one frame ----------------

    def _phase1(self, i, prev_anchor, prev_nonanchor, y_hat_first, lm, ls):
        """The previous slice's reconstruction, the support and the anchors'
        packed (means, scales) of slice i."""
        m = self._chain
        if i == 0:
            sup = m.slice_support(0, None, None, lm, ls)
        else:
            y_hat_prev = prev_anchor + cb.unpack_nonanchor(_chain_input(prev_nonanchor,
                                                                        self.chain_device))
            if i == 1:
                y_hat_first = y_hat_prev
            sup = m.slice_support(i, y_hat_first, y_hat_prev, lm, ls)
        mu, sc = m.anchor_params(i, sup)
        return sup, y_hat_first, _host(cb.pack_anchor(mu)), _host(cb.pack_anchor(sc))

    def _phase2(self, i, anchor_q, sup):
        """The decoded anchors and the non-anchors' packed (means, scales)."""
        y_anchor_dec = cb.unpack_anchor(_chain_input(anchor_q, self.chain_device))
        mu, sc = self._chain.nonanchor_params(i, y_anchor_dec, sup)
        return y_anchor_dec, _host(cb.pack_nonanchor(mu)), _host(cb.pack_nonanchor(sc))

    def _code_phase(self, y_cf: np.ndarray, mu: np.ndarray, sc: np.ndarray):
        """Encode one phase; returns (strings, decoded values). The decoded
        values are round(y - mu) + mu, which is what the decoder returns, so
        the encoder needs no rANS decode of its own stream."""
        idx = self.gc.build_indexes(sc)
        strings = self.gc.compress(y_cf, idx, mu)
        decoded = np.round(y_cf - mu).astype(np.float32) + np.asarray(mu, np.float32)
        return strings, decoded

    def _encode_frame_entropy(self, y_packed_f: np.ndarray, z_hat_f: np.ndarray):
        """One frame's serial chain and its rANS encode. Returns (strings per
        slice (anchor, non-anchor), decoded anchors per slice, packed decoded
        non-anchors per slice)."""
        groups, M = self.model.groups, self.model.M
        offs = np.concatenate([[0], np.cumsum(groups)])
        lm, ls = self._chain.hyper_params(_chain_input(z_hat_f, self.chain_device))
        strings: List[Tuple[bytes, bytes]] = []
        anchor_decs, nonanchor_qs = [], []
        y_hat_first = prev_anchor = prev_nonanchor = None
        for i in range(self.model.num_slices):
            sup, y_hat_first, mu_a, sc_a = self._phase1(i, prev_anchor, prev_nonanchor,
                                                        y_hat_first, lm, ls)
            s_a, anchor_q = self._code_phase(y_packed_f[:, offs[i]: offs[i + 1]], mu_a, sc_a)
            prev_anchor, mu_n, sc_n = self._phase2(i, anchor_q, sup)
            s_n, prev_nonanchor = self._code_phase(
                y_packed_f[:, M + offs[i]: M + offs[i + 1]], mu_n, sc_n)
            anchor_decs.append(prev_anchor)
            nonanchor_qs.append(prev_nonanchor)
            strings.append((s_a[0], s_n[0]))
        return strings, anchor_decs, nonanchor_qs

    def _decode_frame_entropy(self, y_strings, f: int, z_hat_f: np.ndarray):
        """One frame's serial chain driven by its bitstreams: the same ops at
        the same shapes as ``_encode_frame_entropy``."""
        lm, ls = self._chain.hyper_params(_chain_input(z_hat_f, self.chain_device))
        anchor_decs, nonanchor_qs = [], []
        y_hat_first = prev_anchor = prev_nonanchor = None
        for i in range(self.model.num_slices):
            sup, y_hat_first, mu_a, sc_a = self._phase1(i, prev_anchor, prev_nonanchor,
                                                        y_hat_first, lm, ls)
            anchor_q = self.gc.decompress(y_strings[i][0][f: f + 1],
                                          self.gc.build_indexes(sc_a), mu_a)
            prev_anchor, mu_n, sc_n = self._phase2(i, anchor_q, sup)
            prev_nonanchor = self.gc.decompress(y_strings[i][1][f: f + 1],
                                                self.gc.build_indexes(sc_n), mu_n)
            anchor_decs.append(prev_anchor)
            nonanchor_qs.append(prev_nonanchor)
        return anchor_decs, nonanchor_qs

    @torch.no_grad()
    def _synthesize(self, frames) -> np.ndarray:
        """g_s over the whole batch on the model's device; (B, H, W, 3) float32."""
        slices = []
        for i in range(self.model.num_slices):
            a = torch.cat([fr[0][i] for fr in frames]).to(self.device)
            q = _chain_input(np.concatenate([fr[1][i] for fr in frames]), self.device)
            slices.append(a + cb.unpack_nonanchor(q))
        x = self.model.synthesize(torch.cat(slices, dim=1))
        return _host(x.permute(0, 2, 3, 1))

    # ---------------- compress / decompress ----------------

    def compress(self, x, return_recon: bool = False, exact: bool = True) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1], H and W multiples of 64. Returns the
        streams ``[y_strings, z_strings]`` (y_strings[slice] = [anchor streams,
        non-anchor streams], one per frame), the z shape and phase times; with
        ``return_recon`` also ``x_hat``, the reconstruction from the decoded
        latents, which equals what ``decompress`` gives."""
        if not exact:
            raise NotImplementedError(
                "compress(exact=False), the fused simulation path of rate_sweep, is not "
                "ported yet (ROADMAP.md)")
        t0 = time.perf_counter()
        with torch.no_grad():
            xt = torch.tensor(np.asarray(x, np.float32), device=self.device)
            xt = xt.permute(0, 3, 1, 2).contiguous()
            y, z = self.model.encode_transforms(xt)
            y_packed = _host(torch.cat([cb.pack_anchor(y), cb.pack_nonanchor(y)], dim=1))
            z_np = _host(z)
        t_enc = time.perf_counter() - t0

        t0 = time.perf_counter()
        z_hat, z_sym = self.fb.quantize(z_np)
        z_strings = self.fb.compress_symbols(z_sym)
        with self._chain_numerics():
            frames = [self._encode_frame_entropy(y_packed[f: f + 1], z_hat[f: f + 1])
                      for f in range(y_packed.shape[0])]
        t_entropy = time.perf_counter() - t0

        y_strings = [[[fr[0][i][0] for fr in frames], [fr[0][i][1] for fr in frames]]
                     for i in range(self.model.num_slices)]
        out = {"strings": [y_strings, z_strings], "shape": tuple(z_np.shape[2:4]),
               "time": {"transforms": t_enc, "entropy": t_entropy}}
        if return_recon:
            t0 = time.perf_counter()
            out["x_hat"] = self._synthesize([fr[1:] for fr in frames])
            out["time"]["synthesis"] = time.perf_counter() - t0
        return out

    def decompress(self, strings, shape: Tuple[int, int]) -> Dict[str, Any]:
        """The mirror of ``compress`` driven by the streams alone; returns
        ``x_hat`` (B, H, W, 3) and phase times."""
        y_strings, z_strings = strings
        t0 = time.perf_counter()
        z_hat = self.fb.decompress(z_strings, shape)
        with self._chain_numerics():
            frames = [self._decode_frame_entropy(y_strings, f, z_hat[f: f + 1])
                      for f in range(z_hat.shape[0])]
        t_entropy = time.perf_counter() - t0
        t0 = time.perf_counter()
        x_hat = self._synthesize(frames)
        return {"x_hat": x_hat,
                "time": {"entropy": t_entropy, "synthesis": time.perf_counter() - t0}}


def num_coded_bytes(strings) -> int:
    """Total byte count of a nested structure of streams."""
    total = 0
    stack = [strings]
    while stack:
        s = stack.pop()
        if isinstance(s, (bytes, bytearray)):
            total += len(s)
        elif isinstance(s, (list, tuple)):
            stack.extend(s)
        else:
            raise TypeError(type(s))
    return total
