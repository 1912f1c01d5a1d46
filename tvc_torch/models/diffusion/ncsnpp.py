"""NCSN++ conditional diffusion UNet (counterpart of ``tvc/models/diffusion/ncsnpp.py``).

The module list is generated by the same recipe as the reference
``ncsnpp_more.py``, so module ``i`` is ``all_modules.{i}`` and a reference
state dict (``checkpoint_*.pt``) loads with no converter. The public forward
takes and returns NHWC tensors, as the JAX package does; inside, activations
are NCHW tensors in one memory format for the whole call, chosen at the entry
by ``ops/layout.activation_layout`` from the device type and the compute
dtype: channels-last for bf16 on the card (cuDNN's bf16 kernels are NHWC
ones, so no activation is converted around them; the weights stay as
stored, which the caller may share, and are laid out channels-last a call),
contiguous for float32 on the card, and on the CPU the channels-last view of
the NHWC input, as before.

``UNetMoreDDPM`` builds the network ``cfg`` names, as the JAX package's
does: this 2-D NCSN++ (with the positional or Fourier time embedding and the
optional cond-mask embedding), the SPADE NCSN++ (``model.spade``,
``spade.py``), or the 3-D and pseudo-3-D NCSN++ (``model.arch =
unetmore3d | unetmorepseudo3d``, ``ncsnpp3d.py``).

``dtype`` is the compute dtype (float32 or bfloat16), as the JAX package's
``UNetMoreDDPM(dtype=...)``: the input frames are cast to it after the
conditioning frames are joined, the time embedding is computed in float32
and then cast, every layer computes in it, and the output is in it.
``UNetMoreDDPM.with_dtype`` gives a UNet of another compute dtype over the
same parameter storage (the ``f32:K`` precision schedule's float32 twin).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tvc_torch.core.config import Config
from tvc_torch.core.runtime import resolve_device
from tvc_torch.models.diffusion.layers import (
    AttnBlockpp,
    DDPMConv,
    Dense,
    Embed,
    GaussianFourierProjection,
    GetActNorm,
    ResnetBlockBigGAN,
    get_timestep_embedding,
)
from tvc_torch.ops.layout import activation_layout


@dataclasses.dataclass(frozen=True)
class NCSNppSpec:
    """Static architecture description (derived from Config)."""

    image_size: int = 128
    channels: int = 3
    num_frames: int = 5
    num_frames_cond: int = 2
    ngf: int = 192
    ch_mult: Tuple[int, ...] = (1, 1, 2, 3, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (8, 16, 32)
    n_head_channels: int = 192
    dropout: float = 0.0
    time_conditional: bool = True
    cond_emb: bool = False
    skip_rescale: bool = True
    num_classes: int = 1000
    embedding_type: str = "positional"

    @property
    def n_frames(self) -> int:
        return self.num_frames + self.num_frames_cond

    @classmethod
    def from_config(cls, cfg: Config) -> "NCSNppSpec":
        return cls(
            image_size=cfg.data.image_size,
            channels=cfg.data.channels,
            num_frames=cfg.data.num_frames,
            num_frames_cond=cfg.data.num_frames_cond + cfg.data.num_frames_future,
            ngf=cfg.model.ngf,
            ch_mult=tuple(cfg.model.ch_mult),
            num_res_blocks=cfg.model.num_res_blocks,
            attn_resolutions=tuple(cfg.model.attn_resolutions),
            n_head_channels=cfg.model.n_head_channels,
            dropout=cfg.model.dropout,
            time_conditional=cfg.model.time_conditional,
            cond_emb=cfg.model.cond_emb,
            num_classes=cfg.model.num_classes,
            embedding_type=cfg.model.embedding_type,
        )


def _build_plan(spec: NCSNppSpec) -> List[dict]:
    """The ordered module list, mirroring ncsnpp_more.py:70-249."""
    plan: List[dict] = []
    nf = spec.ngf
    num_resolutions = len(spec.ch_mult)
    all_res = [spec.image_size // (2 ** i) for i in range(num_resolutions)]

    if spec.embedding_type == "fourier":
        # all_modules[0] when present; scale 16
        plan.append({"kind": "fourier", "size": nf, "scale": 16.0})
    if spec.time_conditional:
        emb_in = 2 * nf if spec.embedding_type == "fourier" else nf
        plan.append({"kind": "dense", "in": emb_in, "out": nf * 4})
        plan.append({"kind": "dense", "in": nf * 4, "out": nf * 4})
        if spec.cond_emb:
            plan.append({"kind": "embed", "num": 2, "dim": nf // 2})

    plan.append({"kind": "conv3", "in": spec.channels * spec.n_frames, "out": nf})
    hs_c = [nf]
    in_ch = nf
    for i_level in range(num_resolutions):
        for _ in range(spec.num_res_blocks):
            out_ch = nf * spec.ch_mult[i_level]
            plan.append({"kind": "res", "in": in_ch, "out": out_ch})
            in_ch = out_ch
            if all_res[i_level] in spec.attn_resolutions:
                plan.append({"kind": "attn", "ch": in_ch})
            hs_c.append(in_ch)
        if i_level != num_resolutions - 1:
            plan.append({"kind": "res", "in": in_ch, "out": in_ch, "down": True})
            hs_c.append(in_ch)

    plan.append({"kind": "res", "in": in_ch, "out": in_ch})
    plan.append({"kind": "attn", "ch": in_ch})
    plan.append({"kind": "res", "in": in_ch, "out": in_ch})

    for i_level in reversed(range(num_resolutions)):
        for _ in range(spec.num_res_blocks + 1):
            out_ch = nf * spec.ch_mult[i_level]
            in_ch_old = hs_c.pop()
            plan.append({"kind": "res", "in": in_ch + in_ch_old, "out": out_ch})
            in_ch = out_ch
        if all_res[i_level] in spec.attn_resolutions:
            plan.append({"kind": "attn", "ch": in_ch})
        if i_level != 0:
            plan.append({"kind": "res", "in": in_ch, "out": in_ch, "up": True})

    if hs_c:
        raise AssertionError("unbalanced skip connections in the NCSN++ plan")
    plan.append({"kind": "actnorm", "ch": in_ch})
    plan.append({"kind": "conv3", "in": in_ch, "out": spec.channels * spec.num_frames,
                 "init_scale": 0.0})
    return plan


def groupnorm_shapes(spec: NCSNppSpec, attention: bool = True) -> List[Tuple[int, int, bool]]:
    """(channels, resolution, modulated by the time embedding) of each
    GroupNorm of one UNet call, in call order: two a residual block (the
    second after its resampling), one an attention block (left out without
    ``attention``: the SPADE net's modulated norms are the others), the final
    ``actnorm``. What the GroupNorm kernel's tests and timings run."""
    out: List[Tuple[int, int, bool]] = []
    res = spec.image_size
    for p in _build_plan(spec):
        if p["kind"] == "res":
            after = res * 2 if p.get("up") else res // 2 if p.get("down") else res
            out += [(p["in"], res, spec.time_conditional),
                    (p["out"], after, spec.time_conditional)]
            res = after
        elif p["kind"] == "actnorm" or (p["kind"] == "attn" and attention):
            out.append((p["ch"], res, False))
    return out


class NCSNpp(nn.Module):
    """The 2-D channel-stacked-frames NCSN++ UNet (ncsnpp_more.py:32-392)."""

    def __init__(self, spec: NCSNppSpec, dtype=torch.float32, device=None):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.plan = _build_plan(spec)
        # the cond-mask embedding is joined to the time embedding
        emb_dim = (4 * spec.ngf + (spec.ngf // 2 if spec.cond_emb else 0)
                   if spec.time_conditional else None)
        mods = []
        for p in self.plan:
            kind = p["kind"]
            if kind == "dense":
                mods.append(Dense(p["in"], p["out"], dtype=dtype, device=device))
            elif kind == "fourier":
                mods.append(GaussianFourierProjection(p["size"], p["scale"], device=device))
            elif kind == "embed":
                mods.append(Embed(p["num"], p["dim"], device=device))
            elif kind == "conv3":
                mods.append(DDPMConv(p["in"], p["out"], 3, init_scale=p.get("init_scale", 1.0),
                                     dtype=dtype, device=device))
            elif kind == "res":
                mods.append(ResnetBlockBigGAN(p["in"], p["out"], emb_dim, up=p.get("up", False),
                                              down=p.get("down", False),
                                              skip_rescale=spec.skip_rescale, dtype=dtype,
                                              device=device))
            elif kind == "attn":
                mods.append(AttnBlockpp(p["ch"], skip_rescale=True, init_scale=0.0,
                                        n_head_channels=spec.n_head_channels, dtype=dtype,
                                        device=device))
            elif kind == "actnorm":
                mods.append(GetActNorm(p["ch"], None, dtype=dtype, device=device))
            else:
                raise ValueError(kind)
        self.all_modules = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C*num_frames) noisy frames; cond: (B, H, W, C*num_frames_cond);
        time_cond: (B,) integer step labels (continuous noise levels with the
        Fourier embedding); cond_mask: (B,) 0/1 labels of the cond-mask
        embedding (ones by default). Returns (B, H, W, C*num_frames)."""
        spec = self.spec
        mods = self.all_modules
        m_idx = 0
        num_resolutions = len(spec.ch_mult)

        if cond is not None:
            x = torch.cat([x, cond], dim=-1)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        fmt = activation_layout(x.device.type, self.dtype)
        if fmt is not None:  # one activation layout through the call
            x = x.contiguous(memory_format=fmt)

        if spec.embedding_type == "fourier":
            temb = mods[0](torch.log(time_cond.float())).to(self.dtype)
            m_idx = 1
        else:
            temb = get_timestep_embedding(time_cond, spec.ngf).to(self.dtype)
        if spec.time_conditional:
            temb = mods[m_idx](temb)
            temb = mods[m_idx + 1](F.silu(temb))
            m_idx += 2
            if spec.cond_emb:
                if cond_mask is None:
                    cond_mask = torch.ones(x.shape[0], dtype=torch.long, device=x.device)
                temb = torch.cat([temb, mods[m_idx](cond_mask.long()).to(self.dtype)], dim=1)
                m_idx += 1
        else:
            temb = None

        hs = [mods[m_idx](x)]
        m_idx += 1
        for i_level in range(num_resolutions):
            for _ in range(spec.num_res_blocks):
                h = mods[m_idx](hs[-1], temb)
                m_idx += 1
                if h.shape[-1] in spec.attn_resolutions:
                    h = mods[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != num_resolutions - 1:
                hs.append(mods[m_idx](hs[-1], temb))
                m_idx += 1

        h = hs[-1]
        h = mods[m_idx](h, temb)
        h = mods[m_idx + 1](h)
        h = mods[m_idx + 2](h, temb)
        m_idx += 3

        for i_level in reversed(range(num_resolutions)):
            for _ in range(spec.num_res_blocks + 1):
                h = mods[m_idx](torch.cat([h, hs.pop()], dim=1), temb)
                m_idx += 1
            if h.shape[-1] in spec.attn_resolutions:
                h = mods[m_idx](h)
                m_idx += 1
            if i_level != 0:
                h = mods[m_idx](h, temb)
                m_idx += 1

        h = mods[m_idx](h)
        h = mods[m_idx + 1](h)
        m_idx += 2
        if hs or m_idx != len(mods):
            raise AssertionError("NCSN++ forward did not consume the module plan")
        return h.permute(0, 2, 3, 1)


def make_schedule(cfg: Config) -> dict:
    """Noise-schedule buffers (ncsnpp_more.py:735-749), float64 numpy."""
    T = cfg.model.num_classes
    dist = cfg.model.sigma_dist
    if dist == "linear":
        betas = np.linspace(cfg.model.sigma_begin, cfg.model.sigma_end, T, dtype=np.float64)
        alphas = np.cumprod(1.0 - betas[::-1])[::-1].copy()
        alphas_prev = np.concatenate([alphas[1:], [1.0]])
    elif dist == "cosine":
        t = np.linspace(T, 0, T + 1, dtype=np.float64) / T
        s = 0.008
        f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
        alphas = f[:-1] / f[-1]
        alphas_prev = np.concatenate([alphas[1:], [1.0]])
        betas = 1.0 - alphas / alphas_prev
    elif dist == "geometric":
        betas = np.logspace(np.log10(cfg.model.sigma_begin), np.log10(cfg.model.sigma_end), T)
        alphas = np.cumprod(1.0 - betas[::-1])[::-1].copy()
        alphas_prev = np.concatenate([alphas[1:], [1.0]])
    else:
        raise NotImplementedError(dist)
    return {"betas": betas, "alphas": alphas, "alphas_prev": alphas_prev}


def cond_noise(cond: torch.Tensor, noise) -> torch.Tensor:
    """The draw that ``noise_in_cond`` adds to the conditioning frames:
    ``noise`` itself, or drawn from it in ``cond``'s dtype where it is a
    ``torch.Generator``."""
    if noise is None:
        raise ValueError(
            "model.noise_in_cond perturbs the conditioning frames with noise the caller "
            "draws: pass noise= (a tensor of cond's shape or a torch.Generator); the JAX "
            "package's UNet fails the same way without a 'noise' rng, which its "
            "FramePredictor does not pass")
    if isinstance(noise, torch.Generator):
        return torch.randn(cond.shape, generator=noise, dtype=cond.dtype, device=cond.device)
    return noise.to(device=cond.device, dtype=cond.dtype)


def level(table: np.ndarray, y: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """``table[y]`` (a float32 schedule on the host), shaped to broadcast over ``cond``."""
    used = torch.from_numpy(table).to(cond.device)[y.long()]
    return used.reshape((cond.shape[0],) + (1,) * (cond.dim() - 1))


class UNetMoreDDPM(nn.Module):
    """The UNet wrapper (ncsnpp_more.py:721-770); its state dict holds the
    reference's keys, ``unet.all_modules.{i}.*``. The sampler, not the model,
    holds the noise schedule (``make_schedule`` / ``Schedule``).

    ``device`` is resolved like every entry point of the port: ``"cuda"`` by
    default, which raises on a host without a card; ``"meta"`` builds the
    parameter shapes only. ``dtype`` is the compute dtype.

    ``model.noise_in_cond`` perturbs the conditioning frames with the forward
    process's noise at the step's level; the draw is the caller's, as
    ``noise``: a tensor of ``cond``'s shape, or a ``torch.Generator`` to draw
    it from. Without it the call raises, as the JAX package's does without a
    ``noise`` rng (its predictor passes none)."""

    def __init__(self, cfg: Config, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the UNet computes in float32 or bfloat16, not {dtype}")
        self.cfg = cfg
        self.dtype = dtype
        if cfg.model.spade:
            from tvc_torch.models.diffusion.spade import SPADENCSNpp

            self.unet = SPADENCSNpp(cfg, dtype=dtype, device=dev)
        elif cfg.model.arch in ("unetmore3d", "unetmorepseudo3d"):
            from tvc_torch.models.diffusion.ncsnpp3d import NCSNpp3D

            self.unet = NCSNpp3D(cfg, pseudo3d=cfg.model.arch == "unetmorepseudo3d",
                                 dtype=dtype, device=dev)
        else:
            self.unet = NCSNpp(NCSNppSpec.from_config(cfg), dtype=dtype, device=dev)
        # the forward process's alphas for noise_in_cond, float32 as the JAX
        # package holds them; a host array, not a buffer, so ``to_empty`` keeps it
        self.alphas = make_schedule(cfg)["alphas"].astype(np.float32)

    def with_dtype(self, dtype, state: Optional[dict] = None) -> "UNetMoreDDPM":
        """A UNet computing in ``dtype`` whose parameters are this one's
        tensors (or ``state``'s), shared, not copied: an update of either is
        seen by both."""
        twin = UNetMoreDDPM(self.cfg, device="meta", dtype=dtype)
        twin.load_state_dict(self.state_dict() if state is None else state, strict=True,
                             assign=True)
        return twin.train(self.training)

    def forward_noise_cond(self, y, cond, noise):
        """``sqrt(a_y) cond + sqrt(1 - a_y) z``, ``z`` from ``cond_noise``."""
        used = level(self.alphas, y, cond)
        return torch.sqrt(used) * cond + torch.sqrt(1.0 - used) * cond_noise(cond, noise)

    def forward(self, x: torch.Tensor, y: torch.Tensor, cond: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None, noise=None) -> torch.Tensor:
        if self.cfg.model.noise_in_cond and cond is not None:
            cond = self.forward_noise_cond(y, cond, noise)
        return self.unet(x, y, cond, cond_mask=cond_mask)
