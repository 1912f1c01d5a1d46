"""Diffusion frame predictor (counterpart of ``FramePredictor``, ``tvc/pipeline/predictor.py:25-174``).

The UNet's weights are bound once; each ``generate`` call runs the sampler
of ``model.version`` on the predictor's device: DDPM (100 steps plus the
denoise step with the default config), DDIM, or F-PNDM, with the options of
``model.gamma`` and ``sampling.init_prev_t``. On the card every UNet call
after the first at a batch size replays one captured CUDA graph
(``samplers/graph.py``); on the CPU the sampler calls the UNet eagerly. A
call of ``generate`` is a ``predictor.generate`` span of
``utils/profiler.py``, each UNet call a ``predictor.unet`` span inside it.

Randomness comes from an explicit ``torch.Generator`` (``draws``), or, for
parity with the JAX package, from explicit ``x_init`` and ``noise`` tensors.

Precision, as the JAX package's ``FramePredictor`` (``docs/BF16.md``):
``dtype`` is the UNet's compute dtype (float32, or bfloat16 for throughput);
``params_dtype`` stores the weights in that dtype, cast once (the float32
masters and the stored copy give the same bytes); ``sampling.precision_schedule
= "f32:K"`` runs DDPM's first K steps through a float32 twin of the UNet over
the same float32 masters, with a float32 carry. The carry, the conditioning
frames and ``x_init`` are in the carry dtype (the compute dtype, or float32
under ``f32:K``); the sampler's update and its noise are float32, and the
frames come back float32. ``cfg.compute_dtype`` is not read, as the JAX
package's predictor does not read it: the quality paths stay float32.
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
from tvc_torch.utils import profiler
from tvc_torch.utils.fastinit import zeros_like


def check_precision(cfg: Config, version: str, dtype, params_dtype) -> int:
    """The JAX package's refusals (``tvc/pipeline/predictor.py:39-60``), each
    with its exception type; returns K of ``sampling.precision_schedule =
    "f32:K"`` (0 without a schedule)."""
    ps = cfg.sampling.precision_schedule
    hi_steps = 0
    if ps:
        if not ps.startswith("f32:"):
            raise ValueError(f"precision_schedule must be 'f32:K', got {ps!r}")
        hi_steps = int(ps.split(":", 1)[1])
    if hi_steps > 0 and params_dtype is not None:
        raise AssertionError("precision_schedule needs f32 master params (params_dtype=None)")
    if hi_steps > 0 and dtype != torch.float32 and version != "DDPM":
        raise ValueError(f"precision_schedule is supported for DDPM (got {version})")
    if dtype != torch.float32 and hi_steps == 0 and cfg.sampling.init_prev_t > 0 \
            and version in ("DDPM", "DDIM"):
        # the JAX package's scan fails here: its warm start promotes the carry to float32
        raise TypeError("the init_prev_t warm start needs a float32 carry; a bf16 predictor "
                        "carries bf16 (the JAX package's sampler scan fails on it)")
    if cfg.model.embedding_type == "fourier":
        raise ValueError(
            "embedding_type='fourier' expects continuous noise-level conditioning; the "
            "DDPM/DDIM/FPNDM samplers pass integer step labels. Use NCSNpp directly with "
            "sigma inputs.")
    return hi_steps


SMLD_REFUSAL = (
    "model.version='SMLD': anneal_langevin_dynamics takes noise levels (sigmas) and "
    "per-level labels, not the DDPM sub-schedule and the clip_before, gamma and t_min "
    "keywords a frame predictor passes (the JAX package's FramePredictor fails with a "
    "TypeError on its first generate). Call tvc_torch.samplers.anneal_langevin_dynamics "
    "with get_sigmas(cfg) instead.")


class FramePredictor:
    """A UNet with its schedule and sampler, at a compute ``dtype``.

    ``model`` holds the weights; the predictor runs it at ``dtype`` (a twin
    over the same parameters where ``model.dtype`` differs) and, with
    ``params_dtype``, over a copy of its float32 weights cast to that dtype
    (``model`` itself is left as it is)."""

    def __init__(self, cfg: Config, model: UNetMoreDDPM, sampler_version: Optional[str] = None,
                 dtype=torch.float32, params_dtype=None):
        version = (sampler_version or cfg.model.version).upper()
        self.hi_steps = check_precision(cfg, version, dtype, params_dtype)
        self.cfg = cfg
        self.dtype = dtype
        self.device = next(model.parameters()).device
        if params_dtype is not None:
            stored = {k: v.to(params_dtype) if v.dtype == torch.float32 else v
                      for k, v in model.state_dict().items()}
            model = model.with_dtype(dtype, stored)
        elif model.dtype != dtype:
            model = model.with_dtype(dtype)
        self.model = model.eval()
        # f32:K: a float32 UNet over the same float32 masters runs the first K steps
        self.model_hi = (self.model.with_dtype(torch.float32).eval()
                         if self.hi_steps > 0 and dtype != torch.float32 else None)
        self.carry_dtype = torch.float32 if self.model_hi is not None else dtype
        self.version = version
        self.sampler = get_sampler(self.version)
        if self.version == "SMLD":
            raise ValueError(SMLD_REFUSAL)
        self.schedule = Schedule.from_config(cfg)
        self.sub = self.schedule.subsample(cfg.sampling.subsample)
        # one graph per input signature and per model: under f32:K both UNets
        # see the same float32 inputs
        on_card = self.device.type == "cuda"
        self.graphs = GraphedEps(self.model, graphs=on_card)
        self.eps_fn = self.graphs
        self.eps_fn_hi = (GraphedEps(self.model_hi, graphs=on_card)
                          if self.model_hi is not None else None)

    @classmethod
    def create(cls, cfg: Config, seed: int = 0, device="cuda",
               sampler_version: Optional[str] = None, dtype=torch.float32, params_dtype=None,
               fast_init: bool = False) -> "FramePredictor":
        """A predictor with random weights drawn from ``seed``: the DDPM init of
        the JAX package, drawn on the host so that every device gets the same
        weights from one seed. ``fast_init`` (benchmarks) instead fills every
        weight with 0.01 on the device, as the JAX package's ``fast_init``:
        the same work a step, no host draws."""
        # refused before the UNet is built, which raises otherwise on the Fourier embedding
        check_precision(cfg, (sampler_version or cfg.model.version).upper(), dtype,
                        params_dtype)
        dev = resolve_device(device)
        if fast_init:
            model = UNetMoreDDPM(cfg, device="meta").to_empty(device=dev)
            zeros_like(model, 0.01)
        else:
            # built without PyTorch's default init, which every draw below replaces
            model = UNetMoreDDPM(cfg, device="meta").to_empty(device="cpu")
            init_params(model, torch.Generator().manual_seed(seed))
            model = model.to(dev)
        return cls(cfg, model, sampler_version=sampler_version, dtype=dtype,
                   params_dtype=params_dtype)

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
        # drawn in float32 and rounded to the carry dtype
        x_init = torch.randn(shape, generator=generator, dtype=torch.float32,
                             device=generator.device).to(self.carry_dtype)
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

    def _sample(self, x_init, cond, noise=None, warm_noise=None, eps_fn=None,
                eps_fn_hi=None) -> torch.Tensor:
        """The sampler's final sample; ``eps_fn`` and ``eps_fn_hi`` replace the
        predictor's (on the card, the graphed UNets)."""
        cfg, samp = self.cfg, self.cfg.sampling
        eps_fn = self.eps_fn if eps_fn is None else eps_fn
        eps_fn_hi = self.eps_fn_hi if eps_fn_hi is None else eps_fn_hi
        if self.version == "FPNDM":
            return fpndm_sampler(x_init, eps_fn, self.schedule, samp.subsample, cond=cond,
                                 clip_before=samp.clip_before)
        kw = dict(cond=cond, denoise=samp.denoise, clip_before=samp.clip_before,
                  gamma=cfg.model.gamma, t_min=samp.init_prev_t, warm_noise=warm_noise)
        if self.version == "DDPM":
            kw["noise"] = noise
            if self.model_hi is not None:
                kw.update(eps_fn_hi=eps_fn_hi, hi_steps=self.hi_steps)
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
        with profiler.span("predictor.generate"):
            cond = data_transform(cfg, to_tensor(cond_frames, self.device, self.carry_dtype))
            if x_init is None:
                if generator is None:
                    raise ValueError("generate needs a generator or explicit x_init and noise")
                x_init, noise = self.draws(generator, b)
            x_init = x_init.to(device=self.device, dtype=self.carry_dtype)
            if noise is not None:
                noise = noise.to(device=self.device, dtype=torch.float32)
            step_noise, warm_noise = self._split(noise)
            with batched_conv_algorithms(b, self.device):
                out = self._sample(x_init, cond, step_noise, warm_noise)
            out = inverse_data_transform(cfg, out[-1].float())
            # (B,H,W,C*F) -> (B,F,H,W,C): frames are channel-stacked [f0 c0..2, f1 ...]
            return out.reshape(b, size, size, cfg.data.num_frames, c).permute(0, 3, 1, 2, 4)
