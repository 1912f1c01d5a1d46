"""The whole-GOP sender: a GOP's state machine kept on the device (counterpart
of ``tvc/pipeline/fused_gop.py``).

Prediction, the accept decision, the frame buffer and the fallback keyframes
all work on device tensors; per update the host reads one value per chain,
the accepted count, which decides the loop and the fallback branch. This is
the in-process sweep path: keyframes go through ``ELICModel.inference``
(clamped reconstructions, per-frame likelihood bits, no bitstreams), so its
bits are the entropy estimate, not rANS byte counts, and nothing it makes is
transmissible (``run_gop`` with ``keep_streams`` is).

Semantics kept from the JAX package: the video is padded past T by
replicating its last frame; a fallback at the tail codes a full pair, whose
bits past T are masked; the decision scores every predicted frame and accepts
``cumprod(ok & valid)``; ``forced_accepts[u] >= 0`` replaces update u's count
(clamped to the frames left); ``run_batched`` steps its chains in lockstep at
a fixed batch, finished chains computed and masked.

Update u of a chain coded with seed s draws its noise from a generator seeded
by ``update_seed(s, u)``, as ``run_gop`` does, or from ``noise(u)``.
``run_sharded`` spreads the chains over the processes of the data axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.metrics.pixel import psnr_torch
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.sender import NoiseSource, update_seed


@dataclasses.dataclass
class FusedGOPSender:
    """Binds the predictor, an ELIC coder (its ``model``) and the metric.
    ``use_psnr`` decides with PSNR >= rho (float32) instead of LPIPS <= rho."""

    cfg: Config
    predictor: FramePredictor
    coder: Any
    lpips: Optional[LPIPSMetric] = None
    num_frames_total: int = 30
    use_psnr: bool = False

    def __post_init__(self):
        cfg = self.cfg
        if cfg.data.image_size % cfg.codec.patch:
            raise ValueError("the whole-GOP sender needs frames whose size is a multiple of "
                             "codec.patch; use run_gop for other sizes")
        if cfg.data.num_frames_future:
            raise ValueError("the whole-GOP sender conditions on past frames only")
        self._pad = max(cfg.data.num_frames, cfg.data.num_frames_cond)
        self._max_updates = self.num_frames_total  # at worst one frame per update

    @property
    def device(self) -> torch.device:
        return self.predictor.device

    def _code_pair(self, model, frames: torch.Tensor):
        """(clamped reconstructions (n, H, W, C), likelihood bits per frame (n,))."""
        out = model.inference(frames.permute(0, 3, 1, 2).contiguous())
        lk = out["likelihoods"]
        bits = -(torch.log2(lk["y"].float()).sum(dim=(1, 2, 3))
                 + torch.log2(lk["z"].float()).sum(dim=(1, 2, 3)))
        return torch.clamp(out["x_hat"].float(), 0.0, 1.0).permute(0, 2, 3, 1), bits

    def _prep_video(self, video_gt: np.ndarray) -> torch.Tensor:
        v = torch.as_tensor(np.asarray(video_gt[: self.num_frames_total], np.float32))
        v = v.to(self.device)
        return torch.cat([v, v[-1:].expand((self._pad,) + v.shape[1:])], dim=0)

    def _draws(self, seed: int, update: int, noise: Optional[NoiseSource]):
        if noise is not None:
            x_init, eps = noise(update)
            return x_init.to(self.device), eps.to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(update_seed(seed, update))
        return self.predictor.draws(gen, 1)

    @torch.no_grad()
    def _run(self, videos: torch.Tensor, seeds: Sequence[int], thresholds: Sequence[float],
             forced: np.ndarray, model, noises: Sequence[Optional[NoiseSource]]) -> Dict[str, Any]:
        cfg, T, dev = self.cfg, self.num_frames_total, self.device
        nc, n_pred = cfg.data.num_frames_cond, cfg.data.num_frames
        B, _, H, W, C = videos.shape
        x_ge = torch.zeros((B, T + self._pad, H, W, C), device=dev)
        d = torch.zeros((B, T + self._pad), dtype=torch.int32, device=dev)
        accepts = torch.full((B, self._max_updates), -1, dtype=torch.int32, device=dev)
        bits = torch.zeros((B,), device=dev)
        for b in range(B):
            dec0, bits0 = self._code_pair(model, videos[b, :nc])
            x_ge[b, :nc] = dec0
            d[b, :nc] = 1
            bits[b] = bits0.sum()  # the first pair lies inside the GOP
        count, upd = [nc] * B, [0] * B
        thr = torch.as_tensor(np.asarray(thresholds, np.float32), device=dev)[:, None]
        offsets = torch.arange(n_pred, device=dev)
        while min(count) < T:
            live = [count[b] < T for b in range(B)]
            cond = torch.stack([x_ge[b, count[b] - nc: count[b]] for b in range(B)])
            cond = cond.permute(0, 2, 3, 1, 4).reshape(B, H, W, nc * C).contiguous()
            draws = [self._draws(seeds[b], upd[b], noises[b]) if live[b] else None
                     for b in range(B)]
            shapes = next(dr for dr in draws if dr is not None)
            draws = [dr if dr is not None else tuple(torch.zeros_like(t) for t in shapes)
                     for dr in draws]  # a finished chain's prediction is masked
            x_init = torch.cat([dr[0] for dr in draws], dim=0)
            eps = torch.cat([dr[1] for dr in draws], dim=1)
            preds = self.predictor.generate(cond, x_init=x_init, noise=eps)
            # a finished chain may stand past T + pad - n_pred: clamp its (masked) window
            last = T + self._pad - n_pred
            gt = torch.stack([videos[b, min(count[b], last): min(count[b], last) + n_pred]
                              for b in range(B)])
            flat_p = preds.reshape((B * n_pred, H, W, C)).contiguous()
            flat_g = gt.reshape((B * n_pred, H, W, C))
            if self.use_psnr:
                ok = psnr_torch(flat_p, flat_g, dim=(1, 2, 3)).view(B, n_pred) >= thr
            else:
                ok = self.lpips(flat_p, flat_g).view(B, n_pred) <= thr
            count_t = torch.as_tensor(count, device=dev)[:, None]
            valid = (count_t + offsets) < T
            n_acc = torch.cumprod((ok & valid).int(), dim=1).sum(dim=1)
            forced_u = torch.as_tensor([int(forced[b, min(upd[b], self._max_updates - 1)])
                                        for b in range(B)], device=dev)
            n_acc = torch.where(forced_u >= 0, torch.minimum(forced_u, valid.sum(dim=1)), n_acc)
            n_host = n_acc.tolist()  # the update's one read
            for b in range(B):
                if not live[b]:
                    continue
                n, at = int(n_host[b]), count[b]
                if n > 0:
                    x_ge[b, at: at + n] = preds[b, :n]
                else:
                    dec, b2 = self._code_pair(model, videos[b, at: at + nc])
                    # bits of pad frames past T are not billed
                    in_gop = ((at + torch.arange(nc, device=dev)) < T).float()
                    x_ge[b, at: at + nc] = dec
                    d[b, at: at + nc] = 1
                    bits[b] = bits[b] + (b2 * in_gop).sum()
                accepts[b, upd[b]] = n
                count[b] = at + (n if n > 0 else nc)
                upd[b] += 1
        return {"x_ge": x_ge[:, :T], "d": d[:, :T], "bits": bits,
                "n_updates": torch.as_tensor(upd), "accepts": accepts}

    def _forced(self, forced_accepts, batch: int) -> np.ndarray:
        forced = np.full((batch, self._max_updates), -1, np.int32)
        if forced_accepts is not None:
            fa = np.asarray(forced_accepts, np.int32).reshape(batch, -1)
            forced[:, : fa.shape[1]] = fa
        return forced

    def run(self, video_gt: np.ndarray, seed: int, threshold: float,
            forced_accepts: Optional[Sequence[int]] = None, coder=None,
            noise: Optional[NoiseSource] = None) -> Dict[str, Any]:
        """Code one GOP. ``video_gt``: (>=T, H, W, C) in [0, 1]. ``coder``
        replaces the bound coder for this call (the rate sweep's qualities).
        Returns device tensors: ``x_ge`` (T, H, W, C), ``d`` (T,), ``bits``
        (likelihood estimate), ``n_updates`` and ``accepts`` (-1 past the
        last update)."""
        out = self._run(self._prep_video(video_gt)[None], [seed], [threshold],
                        self._forced(forced_accepts, 1), (coder or self.coder).model, [noise])
        return {k: v[0] for k, v in out.items()}

    def run_batched(self, videos: np.ndarray, seeds: Sequence[int], thresholds: Sequence[float],
                    forced_accepts: Optional[np.ndarray] = None,
                    noises: Optional[Sequence[NoiseSource]] = None) -> Dict[str, Any]:
        """Code B GOPs in lockstep: (B, >=T, H, W, C) videos, B seeds and
        thresholds, optional (B, n) forced accepts; chain b draws as ``run``
        would with ``seeds[b]``. Returns ``run``'s tensors with a leading B."""
        B = len(videos)
        v = torch.stack([self._prep_video(videos[b]) for b in range(B)])
        return self._run(v, list(seeds), list(thresholds), self._forced(forced_accepts, B),
                         self.coder.model, list(noises) if noises is not None else [None] * B)

    def run_sharded(self, mesh, videos: np.ndarray, seeds: Sequence[int],
                    thresholds: Sequence[float],
                    noises: Optional[Sequence[NoiseSource]] = None) -> Dict[str, Any]:
        """The whole-GOP encode with the chains spread over the processes of
        ``mesh``'s data axis (its model axis must be 1), each on its own
        device. With one process the caller passes the global batch; with
        several, each passes its local shard (the same number of chains on
        every process). Each process runs its chains through ``run_batched``'s
        lockstep loop, and the outputs are gathered into the global batch
        along the data axis, in process order: every process returns
        ``run_batched``'s tensors for all chains.

        The JAX package compiles one sharded ``while_loop`` whose exit test
        reduces over the chain axis, so its processes must enter it in
        lockstep, after an ahead-of-time compile and a barrier. Here each
        process loops on its own chains and meets the others only at the
        final gather, so none of that is needed."""
        from tvc_torch.parallel.collectives import all_gather_frames

        if mesh.shape[mesh.axis_names[1]] != 1:
            raise ValueError("run_sharded spreads chains over the data axis; its mesh has a "
                             f"model axis of {mesh.shape[mesh.axis_names[1]]}")
        out = self.run_batched(videos, seeds, thresholds, noises=noises)
        if mesh.shape[mesh.axis_names[0]] == 1:
            return out
        return {k: all_gather_frames(v.to(self.device), group=mesh.data_group).to(v.device)
                for k, v in out.items()}
