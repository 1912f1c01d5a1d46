"""The ELIC bitstream coder (counterpart of ``tvc/models/codec/coding.py``).

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

Every tensor the chain takes is a contiguous NCHW copy (``ELICCoder._to_chain``): a
convolution may pick another algorithm for another memory format (on the
host, oneDNN's channels-last path gives other bits than its NCHW path), and
the encoder's latents come out of g_a in the layout of its input, the
decoder's from numpy.

Spans of ``utils/profiler.py``: ``codec.compress`` and ``codec.decompress``
(each counting ``codec.frames``), inside them ``codec.transforms`` (the
device analysis and its host reads), ``codec.entropy`` (the z coder and the
chain) and ``codec.synthesis``, whose seconds are ``out["time"]``; inside
``codec.entropy``, ``codec.chain.nets`` (``hyper_params`` and each phase's
networks) and ``codec.chain.rans`` (the scale indexes and the rANS coders,
the z coder's too). The device's reads count as ``reads.codec``; the chain's
own transfers count only where it runs on the model's device
(``entropy_backend="device"``).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from tvc_torch.entropy.factorized import FactorizedCoder
from tvc_torch.entropy.gaussian import GaussianCoder
from tvc_torch.models.codec import checkerboard as cb
from tvc_torch.models.codec.elic import ELICModel
from tvc_torch.utils import profiler

# intra-op threads of the chain on the "cpu" backend: a receiver in another
# process or on another host gets the same sums whatever its default
CHAIN_THREADS = 1

BACKENDS = ("cpu", "device")


def _host(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous host copy, counted as a read of the codec."""
    return np.ascontiguousarray(profiler.fetch(t, "codec").numpy())


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
        self._chain_on_device = entropy_backend == "device"

    def _to_chain(self, a: np.ndarray) -> torch.Tensor:
        """A float32 host array as a contiguous NCHW tensor on the chain's
        device; an upload where the chain runs on the model's device."""
        a = np.ascontiguousarray(a, dtype=np.float32)
        return profiler.upload(a, self.chain_device) if self._chain_on_device else torch.tensor(a)

    def _from_chain(self, t: torch.Tensor) -> np.ndarray:
        """``_host`` of a chain output; a read where the chain runs on the model's device."""
        if self._chain_on_device:
            return _host(t)
        return np.ascontiguousarray(t.detach().numpy())

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
        with profiler.span("codec.chain.nets"):
            if i == 0:
                sup = m.slice_support(0, None, None, lm, ls)
            else:
                y_hat_prev = prev_anchor + cb.unpack_nonanchor(self._to_chain(prev_nonanchor))
                if i == 1:
                    y_hat_first = y_hat_prev
                sup = m.slice_support(i, y_hat_first, y_hat_prev, lm, ls)
            mu, sc = m.anchor_params(i, sup)
            return (sup, y_hat_first, self._from_chain(cb.pack_anchor(mu)),
                    self._from_chain(cb.pack_anchor(sc)))

    def _phase2(self, i, anchor_q, sup):
        """The decoded anchors and the non-anchors' packed (means, scales)."""
        with profiler.span("codec.chain.nets"):
            y_anchor_dec = cb.unpack_anchor(self._to_chain(anchor_q))
            mu, sc = self._chain.nonanchor_params(i, y_anchor_dec, sup)
            return (y_anchor_dec, self._from_chain(cb.pack_nonanchor(mu)),
                    self._from_chain(cb.pack_nonanchor(sc)))

    def _hyper(self, z_hat_f: np.ndarray):
        """A frame's hyper-prior means and scales on the chain's device."""
        with profiler.span("codec.chain.nets"):
            return self._chain.hyper_params(self._to_chain(z_hat_f))

    def _code_phase(self, y_cf: np.ndarray, mu: np.ndarray, sc: np.ndarray):
        """Encode one phase; returns (strings, decoded values). The decoded
        values are round(y - mu) + mu, which is what the decoder returns, so
        the encoder needs no rANS decode of its own stream."""
        with profiler.span("codec.chain.rans"):
            idx = self.gc.build_indexes(sc)
            strings = self.gc.compress(y_cf, idx, mu)
            decoded = np.round(y_cf - mu).astype(np.float32) + np.asarray(mu, np.float32)
            return strings, decoded

    def _decode_phase(self, strings, mu: np.ndarray, sc: np.ndarray) -> np.ndarray:
        """Decode one phase of one frame."""
        with profiler.span("codec.chain.rans"):
            return self.gc.decompress(strings, self.gc.build_indexes(sc), mu)

    def _encode_frame_entropy(self, y_packed_f: np.ndarray, z_hat_f: np.ndarray):
        """One frame's serial chain and its rANS encode. Returns (strings per
        slice (anchor, non-anchor), decoded anchors per slice, packed decoded
        non-anchors per slice)."""
        groups, M = self.model.groups, self.model.M
        offs = np.concatenate([[0], np.cumsum(groups)])
        lm, ls = self._hyper(z_hat_f)
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
        lm, ls = self._hyper(z_hat_f)
        anchor_decs, nonanchor_qs = [], []
        y_hat_first = prev_anchor = prev_nonanchor = None
        for i in range(self.model.num_slices):
            sup, y_hat_first, mu_a, sc_a = self._phase1(i, prev_anchor, prev_nonanchor,
                                                        y_hat_first, lm, ls)
            anchor_q = self._decode_phase(y_strings[i][0][f: f + 1], mu_a, sc_a)
            prev_anchor, mu_n, sc_n = self._phase2(i, anchor_q, sup)
            prev_nonanchor = self._decode_phase(y_strings[i][1][f: f + 1], mu_n, sc_n)
            anchor_decs.append(prev_anchor)
            nonanchor_qs.append(prev_nonanchor)
        return anchor_decs, nonanchor_qs

    @torch.no_grad()
    def _synthesize(self, frames, recon_device: bool = False):
        """g_s over the whole batch on the model's device; (B, H, W, 3) float32,
        on the host, or with ``recon_device`` a view of the device tensor."""
        slices = []
        for i in range(self.model.num_slices):
            a = torch.cat([fr[0][i] for fr in frames])
            a = a.to(self.device) if self._chain_on_device else profiler.upload(a, self.device)
            q = profiler.upload(np.ascontiguousarray(np.concatenate([fr[1][i] for fr in frames]),
                                                     dtype=np.float32), self.device)
            slices.append(a + cb.unpack_nonanchor(q))
        x = self.model.synthesize(torch.cat(slices, dim=1)).permute(0, 2, 3, 1)
        return x if recon_device else _host(x)

    # ---------------- compress / decompress ----------------

    def compress(self, x, return_recon: bool = False, exact: bool = True,
                 recon_device: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) in [0, 1], H and W multiples of 64. Returns the
        streams ``[y_strings, z_strings]`` (y_strings[slice] = [anchor streams,
        non-anchor streams], one per frame), the z shape and phase times; with
        ``return_recon`` also ``x_hat``, the reconstruction from the decoded
        latents, which equals what ``decompress`` gives. ``recon_device``
        leaves ``x_hat`` a tensor on the model's device.

        ``exact=False`` is the simulation coder of the rate sweep: one batched
        ``compress_forward`` on the model's device computes the symbols and
        the entropy parameters of every frame, and the host rANS codes them.
        Its streams have the exact path's sizes to within a flipped rounding,
        but only a receiver that repeats that batched pass could decode them:
        they are not transmissible."""
        with profiler.span("codec.compress"):
            profiler.count("codec.frames", len(x))
            if not exact:
                return self._compress_fused(x, return_recon, recon_device)
            return self._compress_exact(x, return_recon, recon_device)

    def _compress_exact(self, x, return_recon: bool, recon_device: bool) -> Dict[str, Any]:
        with profiler.timed("codec.transforms") as t_enc, torch.no_grad():
            xt = profiler.upload(np.asarray(x, np.float32), self.device)
            xt = xt.permute(0, 3, 1, 2).contiguous()
            y, z = self.model.encode_transforms(xt)
            y_packed = _host(torch.cat([cb.pack_anchor(y), cb.pack_nonanchor(y)], dim=1))
            z_np = _host(z)

        with profiler.timed("codec.entropy") as t_entropy:
            with profiler.span("codec.chain.rans"):
                z_hat, z_sym = self.fb.quantize(z_np)
                z_strings = self.fb.compress_symbols(z_sym)
            with self._chain_numerics():
                frames = [self._encode_frame_entropy(y_packed[f: f + 1], z_hat[f: f + 1])
                          for f in range(y_packed.shape[0])]

        y_strings = [[[fr[0][i][0] for fr in frames], [fr[0][i][1] for fr in frames]]
                     for i in range(self.model.num_slices)]
        out = {"strings": [y_strings, z_strings], "shape": tuple(z_np.shape[2:4]),
               "time": {"transforms": t_enc.seconds, "entropy": t_entropy.seconds}}
        if return_recon:
            with profiler.timed("codec.synthesis") as t_syn:
                out["x_hat"] = self._synthesize([fr[1:] for fr in frames], recon_device)
            out["time"]["synthesis"] = t_syn.seconds
        return out

    def _compress_fused(self, x, return_recon: bool, recon_device: bool) -> Dict[str, Any]:
        """The simulation coder (see ``compress``)."""
        groups, M = self.model.groups, self.model.M
        with profiler.timed("codec.transforms") as t_enc, torch.no_grad():
            xt = profiler.upload(np.asarray(x, np.float32), self.device)
            dev = self.model.compress_forward(xt.permute(0, 3, 1, 2).contiguous(), return_recon)
            z_sym, y_packed, pa, pn = (_host(dev[k]) for k in ("z_sym", "y_packed", "pa", "pn"))

        with profiler.timed("codec.entropy") as t_entropy:
            with profiler.span("codec.chain.rans"):
                z_strings = self.fb.compress_symbols(z_sym.astype(np.int32))
            offs = np.concatenate([[0], np.cumsum(groups)])
            y_strings = []
            for i in range(self.model.num_slices):
                lo, hi = offs[i], offs[i + 1]
                s_a, _ = self._code_phase(y_packed[:, lo:hi], pa[:, lo:hi],
                                          pa[:, M + lo: M + hi])
                s_n, _ = self._code_phase(y_packed[:, M + lo: M + hi], pn[:, lo:hi],
                                          pn[:, M + lo: M + hi])
                y_strings.append([s_a, s_n])
        out = {"strings": [y_strings, z_strings], "shape": tuple(z_sym.shape[2:4]),
               "time": {"transforms": t_enc.seconds, "entropy": t_entropy.seconds}}
        if return_recon:
            x_hat = dev["x_hat"].permute(0, 2, 3, 1)
            out["x_hat"] = x_hat if recon_device else _host(x_hat)
        return out

    def decompress(self, strings, shape: Tuple[int, int]) -> Dict[str, Any]:
        """The mirror of ``compress`` driven by the streams alone; returns
        ``x_hat`` (B, H, W, 3) and phase times."""
        y_strings, z_strings = strings
        with profiler.span("codec.decompress"):
            with profiler.timed("codec.entropy") as t_entropy:
                with profiler.span("codec.chain.rans"):
                    z_hat = self.fb.decompress(z_strings, shape)
                profiler.count("codec.frames", z_hat.shape[0])
                with self._chain_numerics():
                    frames = [self._decode_frame_entropy(y_strings, f, z_hat[f: f + 1])
                              for f in range(z_hat.shape[0])]
            with profiler.timed("codec.synthesis") as t_syn:
                x_hat = self._synthesize(frames)
        return {"x_hat": x_hat, "time": {"entropy": t_entropy.seconds, "synthesis": t_syn.seconds}}


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
