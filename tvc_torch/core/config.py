"""Configuration tree for the PyTorch port (counterpart of ``tvc/core/config.py``).

The dataclasses match the JAX package's field for field, with the same
defaults, so one YAML file or one ``section.key=value`` override list
configures both packages. Values are parsed with ``ast.literal_eval``.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import yaml


@dataclass
class DataConfig:
    dataset: str = "Cityscapes"
    image_size: int = 128
    channels: int = 3
    logit_transform: bool = False
    uniform_dequantization: bool = False
    gaussian_dequantization: bool = False
    random_flip: bool = True
    rescaled: bool = True
    color_jitter: float = 0.0
    num_frames: int = 5
    num_frames_cond: int = 2
    num_frames_future: int = 0
    prob_mask_cond: float = 0.0
    prob_mask_future: float = 0.0
    prob_mask_sync: bool = False


@dataclass
class ModelConfig:
    depth: str = "deeper"
    version: str = "DDPM"  # DDPM | DDIM | FPNDM
    gamma: bool = False
    arch: str = "unetmore"  # unetmore | unetmore3d | unetmorepseudo3d | unet
    type: str = "v1"
    time_conditional: bool = True
    dropout: float = 0.0
    sigma_dist: str = "linear"  # linear | cosine | geometric
    sigma_begin: float = 0.02
    sigma_end: float = 0.0001
    num_classes: int = 1000  # T: number of diffusion steps
    ema: bool = True
    ema_rate: float = 0.999
    spec_norm: bool = False
    normalization: str = "InstanceNorm++"
    nonlinearity: str = "swish"
    ngf: int = 192
    ch_mult: Tuple[int, ...] = (1, 1, 2, 3, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (8, 16, 32)
    n_head_channels: int = 192
    conditional: bool = True
    embedding_type: str = "positional"  # positional | fourier
    noise_in_cond: bool = False
    output_all_frames: bool = False
    cond_emb: bool = False
    spade: bool = False
    spade_dim: int = 128


@dataclass
class SamplingConfig:
    batch_size: int = 200
    data_init: bool = False
    ckpt_id: int = 0
    final_only: bool = True
    fid: bool = False
    ssim: bool = True
    fvd: bool = True
    denoise: bool = True
    subsample: int = 100
    num_samples4fid: int = 10000
    num_samples4fvd: int = 10000
    inpainting: bool = False
    interpolation: bool = False
    n_interpolations: int = 15
    consistent: bool = True
    step_lr: float = 0.0
    n_steps_each: int = 0
    train: bool = False
    num_frames_pred: int = 28
    clip_before: bool = True
    max_data_iter: int = 1000
    init_prev_t: float = -1.0
    one_frame_at_a_time: bool = False
    preds_per_test: int = 1
    # "f32:K": the first K sampler steps in f32, the rest in the compute
    # dtype; "" = one compute dtype throughout (the only value the port runs)
    precision_schedule: str = ""


@dataclass
class OptimConfig:
    weight_decay: float = 0.0
    optimizer: str = "Adam"
    lr: float = 1e-4
    warmup: int = 5000
    beta1: float = 0.9
    amsgrad: bool = False
    eps: float = 0.0
    grad_clip: float = 1.0


@dataclass
class CodecConfig:
    """ELIC keyframe codec hyper-parameters."""

    N: int = 192  # main channel count
    M: int = 320  # latent channel count
    num_slices: int = 5
    groups: Tuple[int, ...] = (16, 16, 32, 64, 192)  # uneven channel groups
    patch: int = 64  # pad H,W to multiples of this before coding
    exact_streams: bool = True
    entropy_backend: str = "cpu"


@dataclass
class MeshConfig:
    """Device-mesh / parallelism layout."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all devices
    model_parallel: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 1234
    # computation dtype for the diffusion UNet ("float32" | "bfloat16")
    compute_dtype: str = "float32"

    @property
    def n_frames(self) -> int:
        return self.data.num_frames + self.data.num_frames_cond + self.data.num_frames_future

    def validate(self) -> None:
        if self.model.cond_emb and not self.data.prob_mask_cond > 0:
            raise ValueError("cond_emb requires prob_mask_cond > 0")
        if self.data.prob_mask_sync and not (
            self.data.prob_mask_cond > 0
            and self.data.prob_mask_cond == self.data.prob_mask_future
        ):
            raise ValueError("prob_mask_sync requires equal nonzero cond/future mask probs")
        if self.model.output_all_frames:
            self.model.noise_in_cond = True


_SECTIONS = {
    "data": DataConfig,
    "model": ModelConfig,
    "sampling": SamplingConfig,
    "optim": OptimConfig,
    "codec": CodecConfig,
    "mesh": MeshConfig,
}


def _apply_section(dc, d: dict) -> None:
    names = {f.name for f in dataclasses.fields(dc)}
    for k, v in d.items():
        if k not in names:
            continue  # tolerate unknown keys, as the JAX package does
        cur = getattr(dc, k)
        if isinstance(cur, tuple):
            v = tuple(v)
        elif isinstance(cur, float) and isinstance(v, int):
            v = float(v)
        setattr(dc, k, v)


def config_from_dict(d: dict) -> Config:
    cfg = Config()
    for section, sub in d.items():
        if section in _SECTIONS and isinstance(sub, dict):
            _apply_section(getattr(cfg, section), sub)
        elif hasattr(cfg, section) and not isinstance(sub, dict):
            setattr(cfg, section, sub)
    cfg.validate()
    return cfg


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> Config:
    """Load a YAML config and apply ``section.key=value`` overrides."""
    d: dict = {}
    if path is not None:
        with open(path, "r") as f:
            d = yaml.safe_load(f) or {}
    cfg = config_from_dict(d)
    apply_overrides(cfg, overrides)
    cfg.validate()
    return cfg


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    items: List[str] = []
    for ov in overrides:
        items.extend(s for s in ov.split(" ") if s)
    for item in items:
        key, _, raw = item.partition("=")
        section, _, name = key.partition(".")
        target = getattr(cfg, section, None)
        if target is None or not hasattr(target, name):
            raise KeyError(f"unknown config key: {key}")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw  # plain string
        if isinstance(getattr(target, name), tuple) and isinstance(val, (list, tuple)):
            val = tuple(val)
        if isinstance(getattr(target, name), float) and isinstance(val, int):
            val = float(val)
        if isinstance(getattr(target, name), bool) and not isinstance(val, bool):
            # "true"/"false" as written on a command line; the JAX package
            # keeps the string, and its "false" is truthy
            if str(raw).lower() not in ("true", "false", "1", "0"):
                raise ValueError(f"{key} takes true or false, got {raw!r}")
            val = str(raw).lower() in ("true", "1")
        setattr(target, name, val)
    return cfg


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str, extra: Optional[dict] = None) -> None:
    """Write the run's config as YAML; ``extra`` adds top-level keys, such as
    ``{"provenance": {"calibrated": False, ...}}`` for a sweep run on
    uncalibrated metric weights."""
    d = config_to_dict(cfg)
    if extra:
        d.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(d, f, default_flow_style=False)
