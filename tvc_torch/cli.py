"""tvc_torch command-line interface (counterpart of ``tvc/cli.py``'s ``codec`` and ``gop``).

    python -m tvc_torch.cli codec --input-npy frames.npy --save-bitstream x.tvc \
        --output-npy sender.npy                      # encode, write a TVC2 container
    python -m tvc_torch.cli codec --from-bitstream x.tvc --input-npy frames.npy \
        --output-npy receiver.npy                    # decode it (input: size, PSNR)
    python -m tvc_torch.cli gop send --video-npy video.npy --payload gop.tvcg \
        --threshold 0.1 --allow-uncalibrated --output-npy sender.npy
    python -m tvc_torch.cli gop receive --payload gop.tvcg --output-npy receiver.npy

Every command runs on ``--device`` (``cuda`` by default; ``cpu`` on a host
without a card). Configuration: ``--config`` YAML and ``--config-mod
section.key=value`` overrides, as in the JAX package. Without checkpoints the
models take seeded random weights (a warning says so), the same in every
process, so a receiver rebuilds the sender's models.

A GOP payload (``.tvcg``, a numpy ``.npz``) carries what crosses the channel,
the seed, the accept counts and one container per keyframe coding event,
and the sender's numerics stamp (``tvc_torch.core.runtime.numerics_stamp``).
``gop receive`` exits 2, naming the field, when its own stamp differs.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

_STAMP = "numerics_"


def _add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", type=str, default=None, help="YAML config path")
    ap.add_argument("--config-mod", nargs="*", action="extend", default=[],
                    help="dotted overrides: section.key=value")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _load_cfg(args):
    from tvc_torch.core.config import load_config

    cfg = load_config(args.config, args.config_mod)
    cfg.seed = args.seed
    return cfg


def load_frames(path: str) -> np.ndarray:
    """(T, H, W, 3) float32 frames from a (T, H, W, 3) or (T, 3, H, W) npy."""
    x = np.load(path).astype(np.float32)
    if x.ndim == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.transpose(0, 2, 3, 1)
    return x


def build_coder(cfg, device, ckpt: Optional[str] = None):
    """The ELIC coder of ``cfg.codec``: a checkpoint's weights, or seeded random ones."""
    from tvc_torch.core.runtime import resolve_device
    from tvc_torch.models.codec.coding import ELICCoder
    from tvc_torch.models.codec.elic import ELICModel, make_elic
    from tvc_torch.utils.convert import load_codec_checkpoint

    if ckpt:
        model = ELICModel(cfg.codec.N, cfg.codec.M, tuple(cfg.codec.groups), device="cpu")
        model.load_state_dict(load_codec_checkpoint(ckpt), strict=True)
        model = model.to(resolve_device(device))
    else:
        print("[tvc_torch] WARNING: random codec weights", flush=True)
        model = make_elic(cfg.codec, seed=0, device=device)
    return ELICCoder(model, entropy_backend=cfg.codec.entropy_backend)


def build_predictor(cfg, device, ckpt: Optional[str] = None):
    """The frame predictor: a checkpoint's UNet, or seeded random weights,
    drawn as the JAX package draws them and then with the layers that its
    init scales to ~0 redrawn at unit scale, so that a random UNet's
    predictions carry signal."""
    from tvc_torch.core.runtime import resolve_device
    from tvc_torch.models.diffusion.layers import redraw_zero_scaled_
    from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
    from tvc_torch.pipeline.predictor import FramePredictor
    from tvc_torch.utils.convert import load_diffusion_checkpoint

    if ckpt:
        unet = UNetMoreDDPM(cfg, device="cpu")
        unet.load_state_dict(load_diffusion_checkpoint(ckpt, cfg), strict=True)
        return FramePredictor(cfg, unet.to(resolve_device(device)))
    print("[tvc_torch] WARNING: random diffusion weights", flush=True)
    predictor = FramePredictor.create(cfg, seed=0, device=device)
    redraw_zero_scaled_(predictor.model, torch.Generator().manual_seed(1))
    return predictor


def write_payload(path: str, gop, seed: int, calibrated: bool, stamp: Dict[str, str]) -> int:
    """Write a GOP payload to exactly ``path``; returns its size in bytes."""
    payload = {
        "seed": np.int64(seed),
        "num_frames_total": np.int64(gop.x_ge.shape[1]),
        "accepts": np.asarray(gop.accepts, np.int64),
        "n_containers": np.int64(len(gop.containers)),
        "calibrated": np.int64(int(calibrated)),
    }
    payload.update({_STAMP + k: np.asarray(v) for k, v in stamp.items()})
    for i, c in enumerate(gop.containers):
        payload[f"container_{i}"] = np.frombuffer(c, np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **payload)
        return f.tell()


def stamp_mismatch(payload, stamp: Dict[str, str]) -> Optional[str]:
    """The first numerics field in which a payload and this process differ, as
    a message; None if they agree."""
    theirs = {k[len(_STAMP):]: str(payload[k]) for k in payload.files if k.startswith(_STAMP)}
    for field in sorted(set(theirs) | set(stamp)):
        if theirs.get(field) != stamp.get(field):
            return (f"payload was produced with {_STAMP}{field}={theirs.get(field)!r} but this "
                    f"process runs {stamp.get(field)!r}; regenerated frames would not match the "
                    "sender's")
    return None


def cmd_codec(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="tvc_torch codec")
    _add_common_args(ap)
    ap.add_argument("--input-npy", default=None,
                    help="(T,H,W,3) or (T,C,H,W) [0,1] frames; with --from-bitstream only "
                         "their size and PSNR are used")
    ap.add_argument("--ckpt", type=str, default=None, help="ELIC checkpoint .pth.tar")
    ap.add_argument("--output-npy", type=str, default=None)
    ap.add_argument("--entropy-estimation", action="store_true",
                    help="likelihood-based bpp, no bitstreams (not ported)")
    ap.add_argument("--save-bitstream", type=str, default=None,
                    help="write the coded frames to a TVC2 container")
    ap.add_argument("--from-bitstream", type=str, default=None,
                    help="receiver mode: decode a TVC1/TVC2 container")
    args = ap.parse_args(argv)
    if args.entropy_estimation:
        raise NotImplementedError("codec --entropy-estimation is not ported yet (ROADMAP.md)")
    if args.input_npy is None and args.from_bitstream is None:
        ap.error("--input-npy is needed to encode")

    from tvc_torch.metrics.pixel import psnr
    from tvc_torch.models.codec import container
    from tvc_torch.pipeline.keyframe import code_frames_enc

    cfg = _load_cfg(args)
    x = load_frames(args.input_npy) if args.input_npy else None
    coder = build_coder(cfg, args.device, args.ckpt)
    t0 = time.perf_counter()
    if args.from_bitstream:
        enc = container.load(args.from_bitstream,
                             expect_entropy_backend=cfg.codec.entropy_backend)
        x_hat = coder.decompress(enc["strings"], enc["shape"])["x_hat"]
        msg = f"[receiver] decoded {x_hat.shape[0]} frames from {args.from_bitstream}"
        if x is not None:
            x_hat = x_hat[:, : x.shape[1], : x.shape[2]]
            msg += f" psnr={np.mean([psnr(a, b) for a, b in zip(x, x_hat)]):.2f}dB"
    else:
        x_hat, bits, enc = code_frames_enc(coder, x, cfg.codec.patch)
        msg = (f"frames={x.shape[0]} bpp={sum(bits) / x[..., 0].size:.4f} "
               f"psnr={np.mean([psnr(a, b) for a, b in zip(x, x_hat)]):.2f}dB")
        if args.save_bitstream:
            nbytes = container.save(args.save_bitstream, enc,
                                    entropy_backend=cfg.codec.entropy_backend)
            msg += f" wrote {nbytes} bytes -> {args.save_bitstream}"
    print(f"{msg} in {time.perf_counter() - t0:.6f} s", flush=True)
    if args.output_npy:
        np.save(args.output_npy, x_hat)
    return 0


def cmd_gop(argv: List[str]) -> int:
    """send: code one video's GOP and write the payload; receive: rebuild the
    frames from the payload alone, byte for byte the sender's."""
    ap = argparse.ArgumentParser(prog="tvc_torch gop")
    _add_common_args(ap)
    ap.add_argument("mode", choices=["send", "receive"])
    ap.add_argument("--video-npy", default=None,
                    help="send: (T,H,W,3) or (T,C,H,W) [0,1] frames of one video")
    ap.add_argument("--payload", required=True, help=".tvcg payload file")
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--decision", choices=["lpips", "psnr"], default="lpips",
                    help="accept rule: LPIPS <= threshold or PSNR >= threshold (dB)")
    ap.add_argument("--num-frames", type=int, default=30)
    ap.add_argument("--ckpt", type=str, default=None, help="diffusion checkpoint .pt")
    ap.add_argument("--codec-ckpt", type=str, default=None, help="ELIC .pth.tar")
    ap.add_argument("--lpips-alex", type=str, default=None)
    ap.add_argument("--lpips-lin", type=str, default=None)
    ap.add_argument("--output-npy", type=str, default=None,
                    help="write the sender's or the receiver's frames")
    ap.add_argument("--device-gop", action="store_true",
                    help="send through the device-resident GOP loop (not ported)")
    ap.add_argument("--allow-uncalibrated", action="store_true",
                    help="send: allow accept decisions on random LPIPS weights")
    args = ap.parse_args(argv)
    if args.device_gop:
        raise NotImplementedError("gop send --device-gop (DeviceGOPRunner) is not ported yet "
                                  "(ROADMAP.md)")

    from tvc_torch.core.runtime import numerics_stamp

    cfg = _load_cfg(args)
    stamp = numerics_stamp(args.device, cfg.codec.entropy_backend)
    if args.mode == "send":
        from tvc_torch.metrics.lpips import LPIPSMetric
        from tvc_torch.pipeline.sender import Sender, run_gop

        if args.video_npy is None:
            ap.error("gop send needs --video-npy")
        lp = LPIPSMetric.create(args.lpips_alex, args.lpips_lin, device=args.device)
        if not lp.calibrated and not args.allow_uncalibrated:
            print("[tvc_torch] ERROR: LPIPS weights missing; accept decisions would use random "
                  "features. Pass --lpips-alex/--lpips-lin or --allow-uncalibrated.",
                  file=sys.stderr)
            return 2
        video = load_frames(args.video_npy)
        coder = build_coder(cfg, args.device, args.codec_ckpt)
        predictor = build_predictor(cfg, args.device, args.ckpt)
        sender = Sender(args.threshold, cfg, predictor, lp, use_psnr=args.decision == "psnr")
        gop = run_gop(sender, coder, video, cfg.seed, min(args.num_frames, video.shape[0]),
                      cfg.codec.patch, keep_streams=True)
        nbytes = write_payload(args.payload, gop, cfg.seed, lp.calibrated, stamp)
        print(f"[gop send] T={gop.x_ge.shape[1]} bits={gop.bits} bpp={gop.bpp:.6f} "
              f"d={[int(v) for v in gop.d[0]]} accepts={gop.accepts} "
              f"payload={nbytes} bytes -> {args.payload} in {gop.wall_time:.6f} s", flush=True)
        frames = gop.x_ge[0]
    else:
        from tvc_torch.pipeline.receiver import run_gop_receiver

        with np.load(args.payload) as z:
            err = stamp_mismatch(z, stamp)
            if err:
                print(f"[tvc_torch] ERROR: {err}", file=sys.stderr)
                return 2
            containers = [z[f"container_{i}"].tobytes() for i in range(int(z["n_containers"]))]
            accepts = [int(a) for a in z["accepts"]]
            seed, total = int(z["seed"]), int(z["num_frames_total"])
        t0 = time.perf_counter()
        coder = build_coder(cfg, args.device, args.codec_ckpt)
        predictor = build_predictor(cfg, args.device, args.ckpt)
        t1 = time.perf_counter()
        frames = run_gop_receiver(cfg, accepts, containers, coder, predictor, seed, total)
        print(f"[gop receive] reconstructed {frames.shape[0]} frames from {args.payload} in "
              f"{time.perf_counter() - t1:.6f} s (models built in {t1 - t0:.6f} s)", flush=True)
    if args.output_npy:
        np.save(args.output_npy, frames)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"codec": cmd_codec, "gop": cmd_gop}
    if not argv or argv[0] not in cmds:
        print(f"usage: python -m tvc_torch.cli {{{','.join(cmds)}}} ...")
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
