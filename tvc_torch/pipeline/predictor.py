"""Diffusion frame predictor (counterpart of ``FramePredictor``, ``tvc/pipeline/predictor.py:25-174``).

The UNet's weights are bound once; each ``generate`` call runs the sampler
(100 DDPM steps plus the denoise step with the default config) on the
predictor's device. Randomness comes from an explicit ``torch.Generator``,
or, for parity with the JAX package, from explicit ``x_init`` and ``noise``
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from tvc_torch.core.config import Config
from tvc_torch.core.runtime import batched_conv_algorithms, resolve_device, to_tensor
from tvc_torch.models.diffusion.layers import init_params
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.transforms import data_transform, inverse_data_transform
from tvc_torch.samplers import Schedule, get_sampler
from tvc_torch.samplers.ancestral import step_constants


class FramePredictor:
    """A UNet with its schedule and sampler."""

    def __init__(self, cfg: Config, model: UNetMoreDDPM, sampler_version: Optional[str] = None):
        if cfg.sampling.precision_schedule:
            raise NotImplementedError(
                "sampling.precision_schedule ('f32:K') is not ported yet (ROADMAP.md)")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the port runs the UNet in float32 only "
                "(bf16 params are on ROADMAP.md)")
        self.cfg = cfg
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.version = (sampler_version or cfg.model.version).upper()
        self.sampler = get_sampler(self.version)
        self.schedule = Schedule.from_config(cfg)
        self.sub = self.schedule.subsample(cfg.sampling.subsample)

    @classmethod
    def create(cls, cfg: Config, seed: int = 0, device="cuda",
               sampler_version: Optional[str] = None) -> "FramePredictor":
        """A predictor with random weights drawn from ``seed``: the DDPM init of
        the JAX package, drawn on the host so that every device gets the same
        weights from one seed."""
        dev = resolve_device(device)
        model = UNetMoreDDPM(cfg, device="cpu")
        init_params(model, torch.Generator().manual_seed(seed))
        return cls(cfg, model.to(dev), sampler_version=sampler_version)

    @property
    def n_steps(self) -> int:
        """UNet calls per ``generate``."""
        return len(self.sub) + (1 if self.cfg.sampling.denoise else 0)

    def draws(self, generator: torch.Generator, batch: int = 1):
        """(x_init, noise): the draws ``generate`` makes from ``generator`` for
        ``batch`` predictions, in the same order, so that passing them gives
        the same frames. Rows of steps that add no noise are zeros."""
        cfg = self.cfg
        size = cfg.data.image_size
        shape = (batch, size, size, cfg.data.channels * cfg.data.num_frames)

        def randn():
            return torch.randn(shape, generator=generator, dtype=torch.float32,
                               device=generator.device)

        x_init = randn()
        sigma = step_constants(self.sub, denoise=cfg.sampling.denoise)["sigma"]
        noise = torch.stack([randn() if s != 0 else
                             torch.zeros(shape, device=generator.device) for s in sigma])
        return x_init, noise

    @torch.no_grad()
    def generate(self, cond_frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                 x_init: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cond_frames: (B, H, W, C*num_frames_cond) in [0, 1].
        Returns (B, num_frames, H, W, C) predicted frames in [0, 1].

        ``x_init`` (B, H, W, C*num_frames) and ``noise`` (see ``ddpm_sampler``)
        replace the draws from ``generator``; without them a generator is needed."""
        cfg = self.cfg
        samp = cfg.sampling
        b = cond_frames.shape[0]
        size, c = cfg.data.image_size, cfg.data.channels
        cond = data_transform(cfg, to_tensor(cond_frames, self.device))
        if x_init is None:
            if generator is None:
                raise ValueError("generate needs a generator or explicit x_init and noise")
            x_init = torch.randn((b, size, size, c * cfg.data.num_frames), generator=generator,
                                 dtype=torch.float32, device=generator.device)
        x_init = x_init.to(device=self.device, dtype=torch.float32)
        with batched_conv_algorithms(b, self.device):
            out = self.sampler(
                x_init, self.model, self.sub, cond=cond, denoise=samp.denoise,
                clip_before=samp.clip_before, final_only=True, generator=generator, noise=noise,
                gamma=cfg.model.gamma, t_min=samp.init_prev_t)[-1]
        out = inverse_data_transform(cfg, out.float())
        # (B,H,W,C*F) -> (B,F,H,W,C): frames are channel-stacked [f0 c0..2, f1 ...]
        return out.reshape(b, size, size, cfg.data.num_frames, c).permute(0, 3, 1, 2, 4)
