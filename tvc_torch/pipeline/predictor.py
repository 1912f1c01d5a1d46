"""Diffusion frame predictor (counterpart of ``FramePredictor``, ``tvc/pipeline/predictor.py:25-174``).

The UNet's weights are bound once; each ``generate`` call runs the sampler
of ``model.version`` on the predictor's device: DDPM (100 steps plus the
denoise step with the default config), DDIM, or F-PNDM, with the options of
``model.gamma`` and ``sampling.init_prev_t``. On the card every UNet call
after the first at a batch size replays one captured CUDA graph
(``samplers/graph.py``); on the CPU the sampler calls the UNet eagerly.

Randomness comes from an explicit ``torch.Generator`` (``draws``), or, for
parity with the JAX package, from explicit ``x_init`` and ``noise`` tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tvc_torch.core.config import Config
from tvc_torch.core.runtime import batched_conv_algorithms, resolve_device, to_tensor
from tvc_torch.models.diffusion.layers import init_params
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.transforms import data_transform, inverse_data_transform
from tvc_torch.samplers import Schedule, get_sampler
from tvc_torch.samplers.ancestral import (NoisePlan, active_steps, ddim_noise_plan,
                                          ddpm_noise_plan)
from tvc_torch.samplers.graph import GraphedEps
from tvc_torch.samplers.pndm import fpndm_sampler, fpndm_unet_calls

SMLD_REFUSAL = (
    "model.version='SMLD': anneal_langevin_dynamics takes noise levels (sigmas) and "
    "per-level labels, not the DDPM sub-schedule and the clip_before, gamma and t_min "
    "keywords a frame predictor passes (the JAX package's FramePredictor fails with a "
    "TypeError on its first generate). Call tvc_torch.samplers.anneal_langevin_dynamics "
    "with get_sigmas(cfg) instead.")


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
        if self.version == "SMLD":
            raise ValueError(SMLD_REFUSAL)
        self.schedule = Schedule.from_config(cfg)
        self.sub = self.schedule.subsample(cfg.sampling.subsample)
        self.graphs = GraphedEps(self.model)
        self.eps_fn = self.graphs if self.device.type == "cuda" else self.model

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

    def noise_plan(self) -> Optional[NoisePlan]:
        """What one prediction draws after ``x_init``; None for F-PNDM."""
        cfg, samp = self.cfg, self.cfg.sampling
        if self.version == "DDPM":
            return ddpm_noise_plan(self.sub, denoise=samp.denoise, gamma=cfg.model.gamma,
                                   t_min=samp.init_prev_t)
        if self.version == "DDIM":
            return ddim_noise_plan(self.sub, denoise=samp.denoise, gamma=cfg.model.gamma,
                                   t_min=samp.init_prev_t)
        return None

    @property
    def n_steps(self) -> int:
        """UNet calls per ``generate``: F-PNDM's 4 per bootstrap step and 1 per
        Adams-Bashforth step; one per active DDPM/DDIM step (an inactive step
        of the ``t_min`` warm start makes none)."""
        if self.version == "FPNDM":
            return fpndm_unet_calls(self.schedule, self.cfg.sampling.subsample)
        plan = self.noise_plan()
        return int(active_steps(self.sub, plan.n_steps, self.cfg.sampling.init_prev_t)[0].sum())

    @property
    def step_rows(self) -> int:
        """Rows of ``noise`` that carry the sampler's per-step draws (DDPM)."""
        return self.noise_plan().n_steps if self.version == "DDPM" else 0

    def draws(self, generator: torch.Generator, batch: int = 1):
        """(x_init, noise): every draw ``generate`` makes from ``generator`` for
        ``batch`` predictions, in the same order, so that passing them gives
        the same frames. ``noise`` stacks DDPM's per-step rows (zeros for a
        step that adds none) and then the ``t_min`` warm start's row; DDIM
        and F-PNDM have no step rows, so without a warm start it has none."""
        cfg = self.cfg
        size = cfg.data.image_size
        shape = (batch, size, size, cfg.data.channels * cfg.data.num_frames)
        x_init = torch.randn(shape, generator=generator, dtype=torch.float32,
                             device=generator.device)
        rows = []
        plan = self.noise_plan()
        if plan is not None:
            step, warm = plan.draw(shape, generator, step_rows=self.step_rows > 0)
            rows = ([] if step is None else list(step)) + ([] if warm is None else [warm])
        noise = torch.stack(rows) if rows else x_init.new_zeros((0,) + shape)
        return x_init, noise

    def _split(self, noise: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor],
                                                             Optional[torch.Tensor]]:
        """(step rows, warm row) of a ``draws``-shaped noise tensor."""
        plan = self.noise_plan()
        n = self.step_rows
        want = n + (1 if plan is not None and plan.warm is not None else 0)
        if want == 0 and noise is None:
            return None, None
        if noise is None or noise.shape[0] != want:
            raise ValueError(f"the {self.version} sampler takes {want} noise rows "
                             f"({n} step rows, then the warm start's), got "
                             f"{None if noise is None else tuple(noise.shape)}")
        return (noise[:n] if n else None), (noise[n] if want > n else None)

    def _sample(self, x_init, cond, noise=None, warm_noise=None, eps_fn=None) -> torch.Tensor:
        """The sampler's final sample; ``eps_fn`` replaces the predictor's
        (on the card, the graphed UNet)."""
        cfg, samp = self.cfg, self.cfg.sampling
        eps_fn = self.eps_fn if eps_fn is None else eps_fn
        if self.version == "FPNDM":
            return fpndm_sampler(x_init, eps_fn, self.schedule, samp.subsample, cond=cond,
                                 clip_before=samp.clip_before)
        kw = dict(cond=cond, denoise=samp.denoise, clip_before=samp.clip_before,
                  gamma=cfg.model.gamma, t_min=samp.init_prev_t, warm_noise=warm_noise)
        if self.version == "DDPM":
            kw["noise"] = noise
        return self.sampler(x_init, eps_fn, self.sub, **kw)

    @torch.no_grad()
    def generate(self, cond_frames: torch.Tensor, generator: Optional[torch.Generator] = None,
                 x_init: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cond_frames: (B, H, W, C*num_frames_cond) in [0, 1].
        Returns (B, num_frames, H, W, C) predicted frames in [0, 1].

        ``x_init`` (B, H, W, C*num_frames) and ``noise`` (as ``draws`` makes
        them) replace the draws from ``generator``; without them a generator
        is needed."""
        cfg = self.cfg
        b = cond_frames.shape[0]
        size, c = cfg.data.image_size, cfg.data.channels
        cond = data_transform(cfg, to_tensor(cond_frames, self.device))
        if x_init is None:
            if generator is None:
                raise ValueError("generate needs a generator or explicit x_init and noise")
            x_init, noise = self.draws(generator, b)
        x_init = x_init.to(device=self.device, dtype=torch.float32)
        if noise is not None:
            noise = noise.to(device=self.device, dtype=torch.float32)
        step_noise, warm_noise = self._split(noise)
        with batched_conv_algorithms(b, self.device):
            out = self._sample(x_init, cond, step_noise, warm_noise)
        out = inverse_data_transform(cfg, out[-1].float())
        # (B,H,W,C*F) -> (B,F,H,W,C): frames are channel-stacked [f0 c0..2, f1 ...]
        return out.reshape(b, size, size, cfg.data.num_frames, c).permute(0, 3, 1, 2, 4)
