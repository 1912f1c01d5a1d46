"""The real-artifact validation harness, ``python -m tvc_torch.cli validate``
(counterpart of ``tvc/utils/validate.py``).

The reference's artifacts (``checkpoint_900000.pt`` with its EMA, the six
ELIC checkpoints ``0..5.pth.tar``, the LPIPS heads and a torchvision
backbone, the I3D weights, ``city_bonn.npy``) are not in the repository.
Each check takes an artifact's path, loads it into the port (the port reads
the reference's state dicts directly: where the JAX package converts, the
port loads) and holds it against the strongest oracle at hand, reporting
pass, fail or skip:

- lpips:     the heads, bit for bit, and the full net-lin distance against
             a torch AlexNet ``features`` trunk built without torchvision
             from the same state dict and the reference's distance math;
- diffusion: the checkpoint's EMA weights; eps-hat against the reference's
             own ``UNetMore_DDPM`` from ``--reference`` at several steps;
- codec:     each quality's checkpoint; a compress -> decompress round trip,
             byte-identical, with bpp and PSNR; bpp monotone in quality; the
             forward against the reference's ``TestModel`` where compressai
             and the reference tree are present;
- i3d:       the FVD(zeros, ones) = 151.17 known answer;
- bf16:      the float32 - bf16 endpoint drift of a full prediction with the
             real weights, judged by a calibrated LPIPS;
- rd:        one 30-frame GOP per quality in {4, 5} on the dataset against
             the published q4/q5 envelope.

Without its artifact (or oracle) a check skips, saying why; nothing is
downloaded. Checks run on ``device`` (``cuda`` by default), except the
torch oracles, which run on the CPU.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

REFERENCE_DEFAULT = "reference"  # a checkout of the reference repository


def _result(name: str, status: str, detail: str = "", **metrics) -> Dict[str, Any]:
    out = {"name": name, "status": status, "detail": detail}
    if metrics:
        out["metrics"] = {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                          for k, v in metrics.items()}
    return out


def ref_namespace(cfg, device=None):
    """A port Config -> the reference's nested-namespace config (its sections
    mirror configs/mine.yml one for one)."""
    import argparse
    import dataclasses

    def to_ns(d):
        ns = argparse.Namespace()
        for k, v in d.items():
            setattr(ns, k, to_ns(v) if isinstance(v, dict) else v)
        return ns

    d = dataclasses.asdict(cfg)
    d["model"]["ch_mult"] = list(cfg.model.ch_mult)
    d["model"]["attn_resolutions"] = list(cfg.model.attn_resolutions)
    ns = to_ns(d)
    ns.device = torch.device("cpu") if device is None else device
    return ns


def _guard(name):
    """Decorator: an exception inside a check becomes a fail result."""

    def deco(fn):
        def wrapped(*a, **kw):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 - a check reports, the harness goes on
                return _result(name, "fail",
                               f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=3)}")

        return wrapped

    return deco


def _on_path(reference: str) -> None:
    import sys

    if reference not in sys.path:
        sys.path.append(reference)


# --------------------------------------------------------------------------- LPIPS


def _torch_alexnet_features(sd):
    """torchvision's AlexNet ``features`` Sequential, built without
    torchvision, from the state dict's ``features.*`` entries."""
    from torch import nn

    seq = nn.Sequential(
        nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2),
        nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2),
        nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(inplace=True),
        nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(inplace=True),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2),
    )
    seq.load_state_dict({k[len("features."):]: v for k, v in sd.items()
                         if k.startswith("features.")})
    return seq.eval()


def check_lpips(alex_pth: Optional[str], lin_pth: Optional[str], net_type: str = "alex",
                device="cuda") -> Dict[str, Any]:
    """The LPIPS artifacts of ``net_type`` (alex | vgg | squeeze): the heads
    file of that backbone and, for alex, torchvision's backbone state dict."""
    name = "lpips" if net_type == "alex" else f"lpips-{net_type}"
    return _guard(name)(_check_lpips_impl)(alex_pth, lin_pth, net_type, name, device)


def _check_lpips_impl(alex_pth, lin_pth, net_type, name, device) -> Dict[str, Any]:
    if alex_pth is None and lin_pth is None:
        return _result(name, "skip", "no --lpips-alex/--lpips-lin given")
    from tvc_torch.metrics.lpips import _SCALE, _SHIFT, LPIPSMetric

    metric = LPIPSMetric.create(alex_pth, lin_pth, net_type=net_type, device=device)
    details: List[str] = []
    metrics: Dict[str, Any] = {}
    n_heads = len(metric.model.taps)
    lin_sd = torch.load(lin_pth, map_location="cpu", weights_only=True) \
        if lin_pth is not None else None
    if lin_sd is not None:
        for k in range(n_heads):
            key = f"lin{k}.model.1.weight"
            if key not in lin_sd:
                return _result(name, "fail", f"head {key} missing from {lin_pth} "
                                             f"(architecture defines {n_heads} heads)")
            got = getattr(metric.model, f"lin{k}").detach().cpu().numpy()
            np.testing.assert_array_equal(got, lin_sd[key].numpy())
        # a file with more heads than the backbone has is another backbone's
        extra = [k for k in lin_sd if k.startswith("lin") and k.endswith(".weight")
                 and int(k[3:].split(".")[0]) >= n_heads]
        if extra:
            return _result(name, "fail",
                           f"unexpected extra heads {sorted(extra)} in {lin_pth} "
                           f"(architecture defines {n_heads}) — wrong artifact for this "
                           "backbone?")
        details.append(f"{n_heads}/{n_heads} linear heads loaded bit-exactly")
        metrics["lin_heads"] = n_heads

    if alex_pth is not None and net_type != "alex":
        return _result(name, "fail", "backbone parity oracle is implemented for alex only "
                                     f"(got net_type={net_type} with a backbone path)")
    if alex_pth is not None:
        sd = torch.load(alex_pth, map_location="cpu", weights_only=True)
        trunk = _torch_alexnet_features(sd)
        rng = np.random.RandomState(0)
        x0 = rng.rand(2, 3, 64, 64).astype(np.float32) * 2 - 1
        x1 = rng.rand(2, 3, 64, 64).astype(np.float32) * 2 - 1

        def taps(x):
            out, h = [], x
            for i, layer in enumerate(trunk):
                h = layer(h)
                if i in (1, 4, 7, 9, 11):  # the ReLU taps
                    out.append(h)
            return out

        with torch.no_grad():
            sh = torch.tensor(_SHIFT).view(1, 3, 1, 1)
            sc = torch.tensor(_SCALE).view(1, 3, 1, 1)
            t0 = taps((torch.from_numpy(x0) - sh) / sc)
            t1 = taps((torch.from_numpy(x1) - sh) / sc)
            want = torch.zeros(2)
            for k, (a, b) in enumerate(zip(t0, t1)):
                # the reference's normalize_tensor: eps outside the root
                a = a / (a.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
                b = b / (b.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
                diff = (a - b) ** 2
                if lin_sd is not None:
                    d = torch.nn.functional.conv2d(
                        diff, lin_sd[f"lin{k}.model.1.weight"].clamp(min=0))
                else:
                    d = diff.sum(1, keepdim=True) * 0.1  # the heads' constant init
                want = want + d.mean((1, 2, 3))
            want = want.numpy()
        got = metric(x0.transpose(0, 2, 3, 1), x1.transpose(0, 2, 3, 1)).cpu().numpy()
        err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))
        details.append(f"full net-lin distance parity max_rel={err:.2e}")
        metrics["netlin_max_rel"] = err
        if err > 1e-4:
            return _result(name, "fail", "; ".join(details), **metrics)
    else:
        details.append("backbone skipped (no --lpips-alex; torchvision backbone state dict "
                       "required)")
    if not metric.calibrated:
        details.append("NOTE: metric remains uncalibrated without both files")
    return _result(name, "pass", "; ".join(details), **metrics)


# --------------------------------------------------------------------------- diffusion


def _load_unet(ckpt: str, cfg, device):
    from tvc_torch.core.runtime import resolve_device
    from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
    from tvc_torch.utils.convert import load_diffusion_checkpoint

    unet = UNetMoreDDPM(cfg, device="cpu")
    unet.load_state_dict(load_diffusion_checkpoint(ckpt, cfg), strict=True)
    return unet.to(resolve_device(device)).eval()


@_guard("diffusion")
def check_diffusion_ckpt(ckpt: Optional[str], cfg=None, reference: str = REFERENCE_DEFAULT,
                         timesteps: Sequence[int] = (3, 250, 700, 999), tol: float = 1e-4,
                         device="cuda") -> Dict[str, Any]:
    if ckpt is None:
        return _result("diffusion", "skip", "no --ckpt given")
    from tvc_torch.core.config import Config

    cfg = cfg or Config()
    unet = _load_unet(ckpt, cfg, device)
    dev = next(unet.parameters()).device
    detail = []
    metrics: Dict[str, Any] = {}
    if os.path.isdir(os.path.join(reference, "models")):
        _on_path(reference)
        from models.better.ncsnpp_more import UNetMore_DDPM as RefWrap
        from models.ema import EMAHelper

        # the reference's own load path (city_sender.py:306-322)
        states = torch.load(ckpt, map_location="cpu")
        ref = RefWrap(ref_namespace(cfg)).eval()
        ref.load_state_dict({k.replace("module.", "", 1): v for k, v in states[0].items()},
                            strict=False)
        if cfg.model.ema:
            ema = EMAHelper(mu=cfg.model.ema_rate)
            ema.register(ref)
            ema.load_state_dict(states[-1])
            ema.ema(ref)
        rng = np.random.RandomState(1)
        size, c = cfg.data.image_size, cfg.data.channels
        x = rng.randn(1, c * cfg.data.num_frames, size, size).astype(np.float32)
        cond = rng.randn(1, c * cfg.data.num_frames_cond, size, size).astype(np.float32)
        max_rel = 0.0
        for t in timesteps:
            with torch.no_grad():
                want = ref(torch.from_numpy(x), torch.tensor([t]),
                           cond=torch.from_numpy(cond)).numpy()
                got = unet(torch.from_numpy(x.transpose(0, 2, 3, 1)).to(dev),
                           torch.tensor([t], device=dev),
                           torch.from_numpy(cond.transpose(0, 2, 3, 1)).to(dev))
            got = got.cpu().numpy().transpose(0, 3, 1, 2)
            max_rel = max(max_rel, float(np.abs(got - want).max()
                                         / max(np.abs(want).max(), 1e-9)))
        metrics["eps_max_rel"] = max_rel
        detail.append(f"eps-hat parity vs reference torch model @t={list(timesteps)}: "
                      f"max_rel={max_rel:.2e}")
        if max_rel > tol:
            return _result("diffusion", "fail", "; ".join(detail), **metrics)
    else:
        detail.append("reference tree absent: loading ran, torch parity skipped")
    n_params = sum(p.numel() for p in unet.parameters())
    metrics["n_params"] = n_params
    detail.append(f"{n_params / 1e6:.1f}M params loaded (expect 262.1M for the flagship "
                  "checkpoint)")
    return _result("diffusion", "pass", "; ".join(detail), **metrics)


# --------------------------------------------------------------------------- codec


@_guard("codec")
def check_codec_ckpts(paths: Optional[Sequence[str]], reference: str = REFERENCE_DEFAULT,
                      codec_cfg=None, device="cuda") -> Dict[str, Any]:
    if not paths:
        return _result("codec", "skip", "no --codec-ckpts given")
    from tvc_torch.core.config import CodecConfig
    from tvc_torch.core.runtime import resolve_device
    from tvc_torch.models.codec.coding import ELICCoder, num_coded_bytes
    from tvc_torch.models.codec.elic import ELICModel
    from tvc_torch.utils.convert import load_codec_checkpoint

    codec_cfg = codec_cfg or CodecConfig()
    dev = resolve_device(device)
    x = np.random.RandomState(0).rand(1, 128, 128, 3).astype(np.float32)
    detail = []
    metrics: Dict[str, Any] = {}
    try:
        import compressai  # noqa: F401
        have_compressai = True
    except ImportError:
        have_compressai = False

    for q, path in enumerate(paths):
        model = ELICModel(codec_cfg.N, codec_cfg.M, tuple(codec_cfg.groups), device="cpu")
        model.load_state_dict(load_codec_checkpoint(path), strict=True)
        coder = ELICCoder(model.to(dev))
        enc = coder.compress(x, return_recon=True)
        dec = coder.decompress(enc["strings"], enc["shape"])
        identical = np.asarray(enc["x_hat"]).tobytes() == np.asarray(dec["x_hat"]).tobytes()
        bpp = num_coded_bytes(enc["strings"]) * 8 / (128 * 128)
        mse = float(np.mean((np.clip(np.asarray(dec["x_hat"]), 0, 1) - x) ** 2))
        psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
        metrics[f"q{q}_bpp"] = bpp
        metrics[f"q{q}_psnr"] = float(psnr)
        if not identical:
            return _result("codec", "fail",
                           f"q{q}: compress/decompress reconstruction NOT byte-identical")
        detail.append(f"q{q}: roundtrip byte-identical, bpp={bpp:.3f}, psnr={psnr:.2f}dB")
        if have_compressai and os.path.isdir(reference):
            _on_path(reference)
            from Network import TestModel  # the reference codec

            sd = torch.load(path, map_location="cpu")
            if "state_dict" in sd:
                sd = sd["state_dict"]
            ref = TestModel.from_state_dict(sd).eval()
            with torch.no_grad():
                want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2)))["x_hat"].numpy()
                got = coder.model(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(dev))
            got = got["x_hat"].cpu().numpy()
            rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))
            metrics[f"q{q}_fwd_rel"] = rel
            detail.append(f"q{q}: forward parity vs torch TestModel rel={rel:.2e}")
            if rel > 1e-3:
                return _result("codec", "fail", "; ".join(detail), **metrics)
    if not have_compressai:
        detail.append("torch TestModel parity skipped (compressai not importable)")
    # a swapped --codec-ckpts order would corrupt every sweep downstream: fail
    ok, mono = judge_bpp_monotone([metrics[f"q{q}_bpp"] for q in range(len(paths))])
    detail.append(mono)
    return _result("codec", "pass" if ok else "fail", "; ".join(detail), **metrics)


def judge_bpp_monotone(bpps: Sequence[float], slack: float = 0.8):
    """bpp must rise with the quality index (lambda 0.004 .. 0.45); ``slack``
    allows per-image noise between adjacent lambdas. Returns (ok, detail)."""
    if len(bpps) > 1 and not all(b2 >= b1 * slack for b1, b2 in zip(bpps, bpps[1:])):
        return False, (f"bpp NOT quality-monotone: {['%.4f' % b for b in bpps]}"
                       " — check --codec-ckpts order (q0..q5)")
    return True, "bpp quality-monotone"


# --------------------------------------------------------------------------- I3D


@_guard("i3d")
def check_i3d(i3d_ckpt: Optional[str], tol: float = 5.0, device="cuda") -> Dict[str, Any]:
    if i3d_ckpt is None:
        return _result("i3d", "skip", "no --i3d given")
    from tvc_torch.metrics.fvd import FVDMetric

    # the reference's artifact is a TorchScript archive, which torch.load
    # cannot read; a pytorch_i3d state dict loads directly
    try:
        sd = torch.load(i3d_ckpt, map_location="cpu")
        if not isinstance(sd, dict):
            sd = sd.state_dict()
    except Exception:  # noqa: BLE001 - not a pickle: try TorchScript
        sd = torch.jit.load(i3d_ckpt, map_location="cpu").state_dict()
    m = FVDMetric(sd, device=device)
    if not m.calibrated:
        return _result("i3d", "fail", "weights loaded but metric not calibrated")
    fvd = float(m(np.zeros((8, 30, 64, 64, 3), np.float32),
                  np.ones((8, 30, 64, 64, 3), np.float32)))
    return _result("i3d", "pass" if abs(fvd - 151.17) < tol else "fail",
                   f"FVD(zeros, ones) = {fvd:.2f} (golden 151.17 ± {tol}, "
                   "fvd_utils/README.md)", fvd_golden=fvd)


# --------------------------------------------------------------------------- bf16


@_guard("bf16")
def check_bf16_drift(ckpt: Optional[str], cfg=None, lpips_metric=None,
                     device="cuda") -> Dict[str, Any]:
    if ckpt is None:
        return _result("bf16", "skip", "no --ckpt given (drift is checkpoint-dependent, "
                                       "docs/BF16.md)")
    from tvc_torch.core.config import Config
    from tvc_torch.pipeline.predictor import FramePredictor

    cfg = cfg or Config()
    unet = _load_unet(ckpt, cfg, device)
    dev = next(unet.parameters()).device
    p32 = FramePredictor(cfg, unet, dtype=torch.float32)
    p16 = FramePredictor(cfg, unet, dtype=torch.bfloat16)
    size, c = cfg.data.image_size, cfg.data.channels
    cond = torch.rand((1, size, size, c * cfg.data.num_frames_cond),
                      generator=torch.Generator().manual_seed(1))
    x_init, noise = p32.draws(torch.Generator(dev).manual_seed(0), 1)
    f32 = p32.generate(cond, x_init=x_init, noise=noise).double().cpu().numpy()
    b16 = p16.generate(cond, x_init=x_init, noise=noise).double().cpu().numpy()
    drift = float(np.abs(f32 - b16).mean())
    out = {"endpoint_mean_abs_drift": drift, "endpoint_scale": float(np.abs(f32).mean())}
    detail = (f"full-sampler endpoint drift |f32-bf16| mean={drift:.4f} on "
              f"scale {out['endpoint_scale']:.3f}")
    if lpips_metric is not None and lpips_metric.calibrated:
        d = float(lpips_metric(f32.reshape(-1, size, size, c).astype(np.float32),
                               b16.reshape(-1, size, size, c).astype(np.float32)).mean())
        out["endpoint_lpips"] = d
        detail += f"; LPIPS(f32, bf16) = {d:.4f}"
        status = "pass" if d < 0.05 else "fail"
    elif not np.isfinite(drift):
        status = "fail"
    else:
        # a finite drift judged by no calibrated LPIPS judges nothing
        status = "skip"
        detail += (" (informational only: no calibrated LPIPS to judge against — supply "
                   "--lpips-alex/--lpips-lin)")
    return _result("bf16", status, detail, **out)


# --------------------------------------------------------------------------- RD point

# The published Cityscapes envelope at bpp = 0.06 (24-video mean and std).
# One GOP is held to mean - 2 std (PSNR) and mean + 2 std (LPIPS): a video
# from the same distribution clears a 2-sigma band with ~97.7% probability.
# bpp must lie inside the threshold walk's range (0, 1), where the reference
# breaks a walk.
RD_PUBLISHED = {"psnr_mean": 23.70, "psnr_std": 2.47, "lpips_mean": 0.12, "lpips_std": 0.03}


def judge_rd_point(bpp: float, psnr: float, lpips: float,
                   published: Dict[str, float] = RD_PUBLISHED, n_sigma: float = 2.0,
                   bpp_range=(0.0, 1.0)):
    """Pass or fail for one real GOP's RD point. Returns (ok, detail)."""
    problems = []
    if not (bpp_range[0] < bpp < bpp_range[1]):
        problems.append(f"bpp {bpp:.4f} outside walk range {bpp_range}")
    psnr_min = published["psnr_mean"] - n_sigma * published["psnr_std"]
    lpips_max = published["lpips_mean"] + n_sigma * published["lpips_std"]
    if psnr < psnr_min:
        problems.append(f"PSNR {psnr:.2f} < published-{n_sigma:g}sigma bound {psnr_min:.2f}")
    if lpips > lpips_max:
        problems.append(f"LPIPS {lpips:.4f} > published+{n_sigma:g}sigma bound "
                        f"{lpips_max:.4f}")
    if problems:
        return False, "; ".join(problems)
    return True, (f"within bounds (PSNR>={psnr_min:.2f}, LPIPS<={lpips_max:.4f}, "
                  f"bpp in {bpp_range})")


@_guard("rd")
def check_rd_point(data_npy: Optional[str], ckpt: Optional[str],
                   codec_ckpts: Optional[Sequence[str]], lpips_alex: Optional[str],
                   lpips_lin: Optional[str], threshold: float = 0.10,
                   qualities: Sequence[int] = (4, 5), device="cuda") -> Dict[str, Any]:
    # a calibrated LPIPS needs both the backbone and the heads
    missing = [n for n, v in [("--data", data_npy), ("--ckpt", ckpt),
                              ("--codec-ckpts", codec_ckpts), ("--lpips-alex", lpips_alex),
                              ("--lpips-lin", lpips_lin)] if not v]
    if missing:
        return _result("rd", "skip", f"needs {', '.join(missing)}")
    bad_q = [q for q in qualities if q >= len(codec_ckpts)]
    if bad_q:
        return _result("rd", "skip", f"qualities {bad_q} need codec checkpoints "
                                     f"q0..q{max(qualities)} (got {len(codec_ckpts)})")
    from tvc_torch.cli import build_coder
    from tvc_torch.core.config import Config
    from tvc_torch.metrics.lpips import LPIPSMetric, lpips_video
    from tvc_torch.metrics.pixel import psnr
    from tvc_torch.pipeline.driver import load_dataset
    from tvc_torch.pipeline.predictor import FramePredictor
    from tvc_torch.pipeline.sender import Sender, run_gop

    cfg = Config()
    video = load_dataset(data_npy)[0]
    T = min(30, video.shape[0])
    lp = LPIPSMetric.create(lpips_alex, lpips_lin, device=device)
    predictor = FramePredictor(cfg, _load_unet(ckpt, cfg, device))
    detail = []
    metrics: Dict[str, Any] = {}
    ok_all = True
    for q in qualities:
        coder = build_coder(cfg, device, codec_ckpts[q])
        sender = Sender(threshold=threshold, cfg=cfg, predictor=predictor, lpips=lp)
        gop = run_gop(sender, coder, video, cfg.seed, T, cfg.codec.patch)
        ps = float(np.mean([psnr(gop.x_ge[0, i], video[i]) for i in range(T)]))
        lp_mean = float(np.mean(lpips_video(lp, gop.x_ge[0], video[:T])))
        metrics[f"q{q}_bpp"] = gop.bpp
        metrics[f"q{q}_psnr"] = ps
        metrics[f"q{q}_lpips"] = lp_mean
        ok, judged = judge_rd_point(gop.bpp, ps, lp_mean)
        ok_all &= ok
        detail.append(f"q{q} rho={threshold}: bpp={gop.bpp:.4f} psnr={ps:.2f} "
                      f"lpips={lp_mean:.4f} -> {judged}")
    detail.append("published envelope (24-video mean, ret/readme.md): "
                  "PSNR 23.70±2.47 / LPIPS 0.12±0.03 @ bpp 0.06")
    return _result("rd", "pass" if ok_all else "fail", "; ".join(detail), **metrics)


# --------------------------------------------------------------------------- driver


def run_validation(ckpt: Optional[str] = None, codec_ckpts: Optional[Sequence[str]] = None,
                   i3d: Optional[str] = None, lpips_alex: Optional[str] = None,
                   lpips_lin: Optional[str] = None, data_npy: Optional[str] = None,
                   reference: str = REFERENCE_DEFAULT, with_bf16: bool = True,
                   with_rd: bool = True, lpips_lin_vgg: Optional[str] = None,
                   lpips_lin_squeeze: Optional[str] = None,
                   device="cuda") -> List[Dict[str, Any]]:
    """Every check, for the flagship's configuration; the list of their
    result dicts. ``lpips_lin_vgg``/``lpips_lin_squeeze``: the reference's
    other two head files, checked like alex's."""
    results = [
        check_lpips(lpips_alex, lpips_lin, device=device),
        check_diffusion_ckpt(ckpt, reference=reference, device=device),
        check_codec_ckpts(codec_ckpts, reference=reference, device=device),
        check_i3d(i3d, device=device),
    ]
    if lpips_lin_vgg is not None:
        results.insert(1, check_lpips(None, lpips_lin_vgg, net_type="vgg", device=device))
    if lpips_lin_squeeze is not None:
        results.insert(2 if lpips_lin_vgg else 1,
                       check_lpips(None, lpips_lin_squeeze, net_type="squeeze", device=device))
    if with_bf16:
        lp = None
        if lpips_alex and lpips_lin:
            from tvc_torch.metrics.lpips import LPIPSMetric

            lp = LPIPSMetric.create(lpips_alex, lpips_lin, device=device)
        results.append(check_bf16_drift(ckpt, lpips_metric=lp, device=device))
    if with_rd:
        results.append(check_rd_point(data_npy, ckpt, codec_ckpts, lpips_alex, lpips_lin,
                                      device=device))
    return results


def report(results: List[Dict[str, Any]], out_json: Optional[str] = None) -> int:
    """Print the report and optionally write it as JSON. Returns the exit
    code: 0 unless a check failed (skips do not fail)."""
    width = max(len(r["name"]) for r in results)
    n_fail = 0
    for r in results:
        mark = {"pass": "PASS", "fail": "FAIL", "skip": "skip"}[r["status"]]
        print(f"[validate] {r['name']:<{width}}  {mark}  {r['detail']}")
        n_fail += r["status"] == "fail"
    summary = {"pass": sum(r["status"] == "pass" for r in results), "fail": n_fail,
               "skip": sum(r["status"] == "skip" for r in results),
               "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}
    print(f"[validate] {summary['pass']} pass / {summary['fail']} fail / "
          f"{summary['skip']} skip")
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"results": results, "summary": summary}, f, indent=1)
        print(f"[validate] report -> {out_json}")
    return 1 if n_fail else 0
