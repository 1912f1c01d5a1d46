"""Model registry and score-function wrappers (counterpart of ``tvc/models/registry.py``;
reference ``models/better/utils.py:27-186``).

A name -> constructor registry dispatching on ``config.model.arch``, and the
eps -> score conversion: SMLD ``s = -z / sigma``, DDPM ``s = -z / sqrt(1 - alpha)``.
Models are built on ``device`` (the card by default, as every entry point
of the port).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from tvc_torch.core.config import Config
from tvc_torch.core.runtime import resolve_device

_MODELS: Dict[str, Callable] = {}


def register_model(cls=None, *, name: Optional[str] = None):
    """Register a constructor ``(cfg, device=, dtype=) -> module`` under
    ``name`` (its ``__name__`` by default)."""
    def wrap(c):
        n = name or c.__name__
        if n in _MODELS:
            raise ValueError(f"model {n} already registered")
        _MODELS[n] = c
        return c

    return wrap if cls is None else wrap(cls)


def get_model(name: str):
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model: {name} (have {sorted(_MODELS)})") from None


def create_model(cfg: Config, device="cuda", dtype=torch.float32):
    """The model ``config.model.arch`` names: ``unetmore`` (and its 3-D and
    SPADE variants) -> ``UNetMoreDDPM``; ``unet`` -> the legacy ``UNetSMLD``
    or ``UNetDDPM`` by ``model.version``; else a registered constructor."""
    arch = cfg.model.arch
    if arch in ("unetmore", "unetmore3d", "unetmorepseudo3d"):
        from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM

        return UNetMoreDDPM(cfg, device=device, dtype=dtype)
    if arch == "unet":
        from tvc_torch.models.diffusion.unet_legacy import UNetDDPM, UNetSMLD

        if dtype != torch.float32:
            raise ValueError(f"the legacy UNet computes in float32, not {dtype}")
        cls = UNetSMLD if cfg.model.version.upper() == "SMLD" else UNetDDPM
        return cls(cfg, device=resolve_device(device))
    if arch in _MODELS:
        return _MODELS[arch](cfg, device=device, dtype=dtype)
    raise ValueError(f"unknown arch: {arch}")


def get_model_fn(model, train: bool = False):
    """A plain ``(x, labels, cond) -> eps`` closure, in eval mode unless ``train``."""
    model.train(train)

    def model_fn(x, labels, cond=None, cond_mask=None):
        return model(x, labels, cond)

    return model_fn


def get_score_fn(model, cfg: Config):
    """eps -> score: SMLD ``-z / sigma_y``, otherwise ``-z / sqrt(1 - alpha_y)``."""
    from tvc_torch.samplers.schedules import Schedule, get_sigmas

    model_fn = get_model_fn(model)
    if cfg.model.version.upper() == "SMLD":
        table, fn = np.asarray(get_sigmas(cfg), np.float32), lambda s: s
    else:
        table = np.asarray(Schedule.from_config(cfg).alphas, np.float32)
        fn = lambda a: torch.sqrt(1.0 - a)  # noqa: E731

    def score_fn(x, labels, cond=None):
        z = model_fn(x, labels, cond)
        level = torch.from_numpy(table).to(x.device)[labels.long()]
        return -z / fn(level.reshape((-1,) + (1,) * (x.dim() - 1)))

    return score_fn
