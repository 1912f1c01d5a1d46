"""tvc_torch command-line interface (counterpart of ``tvc/cli.py``'s ``sweep``,
``codec``, ``gop``, ``anchors``, ``train`` and ``validate``).

    python -m tvc_torch.cli sweep --data-npy data.npy --output-path out \
        --i3d-ckpt i3d.pt --qualities 4 5 --batched 8   # rate sweep: points, envelopes, plots
    python -m tvc_torch.cli codec --input-npy frames.npy --save-bitstream x.tvc \
        --output-npy sender.npy                      # encode, write a TVC2 container
    python -m tvc_torch.cli codec --from-bitstream x.tvc --input-npy frames.npy \
        --output-npy receiver.npy                    # decode it (input: size, PSNR)
    python -m tvc_torch.cli codec --entropy-estimation --input-npy frames.npy
    python -m tvc_torch.cli gop send --video-npy video.npy --payload gop.tvcg \
        --threshold 0.1 --allow-uncalibrated --output-npy sender.npy [--device-gop]
    python -m tvc_torch.cli gop receive --payload gop.tvcg --output-npy receiver.npy
    python -m tvc_torch.cli anchors --data-npy data.npy --output out --preset city \
        --i3d-ckpt i3d.pt                          # H.264/H.265 anchors (needs ffmpeg)
    python -m tvc_torch.cli train --data-npy data.npy --out-dir out --steps 1000 \
        [--resume-from out/ckpt_500]               # DSM training, npz snapshots
    python -m tvc_torch.cli sweep ... --queue-dir q   # pull (video, quality) units
    python -m tvc_torch.cli validate --ckpt c.pt --codec-ckpts 0.pth.tar ...

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
import os
import sys
import tempfile
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


def build_coder(cfg, device, ckpt: Optional[str] = None, seed: int = 0):
    """The ELIC coder of ``cfg.codec``: a checkpoint's weights, or random ones
    drawn from ``seed``."""
    from tvc_torch.core.runtime import resolve_device
    from tvc_torch.models.codec.coding import ELICCoder
    from tvc_torch.models.codec.elic import ELICModel, make_elic
    from tvc_torch.utils.convert import load_codec_checkpoint

    if ckpt:
        model = ELICModel(cfg.codec.N, cfg.codec.M, tuple(cfg.codec.groups), device="cpu")
        model.load_state_dict(load_codec_checkpoint(ckpt), strict=True)
        model = model.to(resolve_device(device))
    else:
        print(f"[tvc_torch] WARNING: random codec weights (seed {seed})", flush=True)
        model = make_elic(cfg.codec, seed=seed, device=device)
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
                    help="likelihood-based bpp from ELICModel.inference, no bitstreams")
    ap.add_argument("--save-bitstream", type=str, default=None,
                    help="write the coded frames to a TVC2 container")
    ap.add_argument("--from-bitstream", type=str, default=None,
                    help="receiver mode: decode a TVC1/TVC2 container")
    args = ap.parse_args(argv)
    if args.input_npy is None and args.from_bitstream is None:
        ap.error("--input-npy is needed to encode")

    from tvc_torch.metrics.pixel import psnr
    from tvc_torch.models.codec import container
    from tvc_torch.pipeline.keyframe import code_frames_enc, pad_to_multiple

    cfg = _load_cfg(args)
    x = load_frames(args.input_npy) if args.input_npy else None
    coder = build_coder(cfg, args.device, args.ckpt)
    t0 = time.perf_counter()
    if args.entropy_estimation:
        if x is None:
            ap.error("--entropy-estimation needs --input-npy")
        xp, (pb, pr) = pad_to_multiple(x, cfg.codec.patch)
        with torch.no_grad():
            xt = torch.tensor(xp, device=coder.device).permute(0, 3, 1, 2).contiguous()
            out = coder.model.inference(xt)
            bits = -float(torch.log2(out["likelihoods"]["y"]).sum()
                          + torch.log2(out["likelihoods"]["z"]).sum())
            x_hat = torch.clamp(out["x_hat"], 0, 1).permute(0, 2, 3, 1).cpu().numpy()
        x_hat = x_hat[:, : xp.shape[1] - pb, : xp.shape[2] - pr]
        msg = (f"[entropy-estimation] frames={x.shape[0]} bpp={bits / x[..., 0].size:.4f} "
               f"psnr={np.mean([psnr(a, b) for a, b in zip(x, x_hat)]):.2f}dB")
    elif args.from_bitstream:
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
                    help="send: code through DeviceGOPRunner (state on the device, one host "
                         "read per update); the same payload, byte for byte")
    ap.add_argument("--allow-uncalibrated", action="store_true",
                    help="send: allow accept decisions on random LPIPS weights")
    args = ap.parse_args(argv)

    from tvc_torch.core.runtime import numerics_stamp

    cfg = _load_cfg(args)
    stamp = numerics_stamp(args.device, cfg)
    if args.mode == "send":
        from tvc_torch.metrics.lpips import LPIPSMetric
        from tvc_torch.pipeline.sender import DeviceGOPRunner, Sender, run_gop

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
        use_psnr = args.decision == "psnr"
        T = min(args.num_frames, video.shape[0])
        if args.device_gop:
            runner = DeviceGOPRunner(cfg, predictor, lpips=lp, use_psnr=use_psnr,
                                     num_frames_total=T)
            gop = runner.run(coder, video, cfg.seed, args.threshold, patch=cfg.codec.patch,
                             keep_streams=True)
        else:
            sender = Sender(args.threshold, cfg, predictor, lp, use_psnr=use_psnr)
            gop = run_gop(sender, coder, video, cfg.seed, T, cfg.codec.patch, keep_streams=True)
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


def cmd_sweep(argv: List[str]) -> int:
    """The rate sweep over a dataset: (quality x threshold) points per video,
    convex-hulled RD envelopes, ``points.json``, npy files, plots, and the
    run's ``config.yml`` with its provenance."""
    ap = argparse.ArgumentParser(prog="tvc_torch sweep")
    _add_common_args(ap)
    ap.add_argument("--data-npy", required=True, help="(B,T,C,H,W) dataset npy in [0, 255]")
    ap.add_argument("--output-path", required=True)
    ap.add_argument("--start-idx", type=int, default=0)
    ap.add_argument("--end-idx", type=int, default=0)
    ap.add_argument("--ckpt", type=str, default=None, help="diffusion checkpoint .pt")
    ap.add_argument("--codec-ckpts", nargs="*", default=None,
                    help="ELIC checkpoints q0..q5 (.pth.tar), indexed by quality")
    ap.add_argument("--qualities", nargs="*", type=int, default=[4, 5])
    ap.add_argument("--thresholds", nargs="*", type=float, default=None,
                    help="decision-threshold walk (default: 0.30..0.03 step -0.01)")
    ap.add_argument("--decision", choices=["lpips", "psnr"], default="lpips",
                    help="accept rule: LPIPS <= rho or PSNR >= rho in dB (give matching "
                         "--thresholds for psnr, e.g. 30 28 26)")
    ap.add_argument("--no-fvd", action="store_true",
                    help="skip FVD (default: every point's FVD, computed on --device)")
    ap.add_argument("--i3d-ckpt", type=str, default=None,
                    help="I3D weights for FVD: a pytorch_i3d state dict saved by torch.save "
                         "(.pt); without it the I3D takes seeded random weights")
    ap.add_argument("--lpips-alex", type=str, default=None, help="torchvision alexnet .pth")
    ap.add_argument("--lpips-lin", type=str, default=None, help="lpips linear heads .pth")
    ap.add_argument("--bench-264", type=str, default=None)
    ap.add_argument("--bench-265", type=str, default=None)
    ap.add_argument("--sim-codec", action="store_true",
                    help="code keyframes with the simulation coder (one batched pass on the "
                         "card; streams not transmissible); default: the exact coder")
    ap.add_argument("--batched", type=int, default=0,
                    help="run every (video, q, rho) job as lockstep-batched GOP chains of this "
                         "batch size (0: one GOP at a time)")
    ap.add_argument("--device-gop", action="store_true",
                    help="one GOP at a time through DeviceGOPRunner (not with --batched)")
    ap.add_argument("--exact-streams", action="store_true",
                    help=argparse.SUPPRESS)  # the old spelling of the default exact path
    ap.add_argument("--fused-gop", action="store_true",
                    help="one GOP at a time through the whole-GOP sender: likelihood bits, "
                         "not rANS byte counts (not with --exact-streams, --batched or "
                         "--queue-dir)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="processes sharing the walks (--batched)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--queue-dir", type=str, default=None,
                    help="pull (video, quality) units from a work queue on a shared "
                         "filesystem at this path instead of a static --num-processes/"
                         "--process-id share; a dead process's units are claimed again after "
                         "--queue-stale-after seconds")
    ap.add_argument("--queue-stale-after", type=float, default=900.0)
    ap.add_argument("--allow-uncalibrated", action="store_true",
                    help="run on random LPIPS or I3D weights; RD curves are then meaningless, "
                         "and config.yml says provenance.calibrated=false")
    args = ap.parse_args(argv)

    if args.fused_gop and (args.batched or args.queue_dir):
        print("[tvc_torch] --fused-gop is sequential-mode only and uses the device codec; "
              "drop --batched/--queue-dir")
        return 2
    if args.device_gop and args.batched:
        print("[tvc_torch] --device-gop runs GOP chains one at a time; drop --batched")
        return 2

    from tvc_torch.pipeline.driver import (load_dataset, run_sweep, run_sweep_batched,
                                           run_sweep_queued)

    cfg = _load_cfg(args)
    if args.sim_codec:
        cfg.codec.exact_streams = False
        print("[tvc_torch] codec path: the simulation coder (--sim-codec); its streams are not "
              "receiver-decodable")
    elif args.exact_streams:
        cfg.codec.exact_streams = True  # already the default
    metrics = build_metrics(args, with_fvd=not args.no_fvd)
    if metrics is None:
        return 2
    lp, fvd, provenance = metrics

    data = load_dataset(args.data_npy)
    coders = {q: build_coder(cfg, args.device, args.codec_ckpts[q] if args.codec_ckpts else None,
                             seed=q) for q in args.qualities}
    predictor = build_predictor(cfg, args.device, args.ckpt)
    common = dict(start_idx=args.start_idx, end_idx=args.end_idx, qualities=args.qualities,
                  thresholds=args.thresholds, with_fvd=not args.no_fvd, lpips_metric=lp,
                  fvd_metric=fvd, provenance=provenance, use_psnr=args.decision == "psnr")
    if args.queue_dir:
        n = run_sweep_queued(cfg, data, coders, predictor, args.output_path, args.queue_dir,
                             bench_264=args.bench_264, bench_265=args.bench_265,
                             stale_after=args.queue_stale_after, device_gop=args.device_gop,
                             **common)
        print(f"[queue] this process completed {n} work units", flush=True)
    elif args.batched > 0:
        run_sweep_batched(cfg, data, coders, predictor, args.output_path,
                          batch_size=args.batched, num_processes=args.num_processes,
                          process_id=args.process_id, **common)
    else:
        run_sweep(cfg, data, coders, predictor, args.output_path, bench_264=args.bench_264,
                  bench_265=args.bench_265, fused_gop=args.fused_gop,
                  device_gop=args.device_gop, **common)
    from tvc_torch.ops import attention

    print(f"[sweep] attention kernel launches: {attention.launches}", flush=True)
    if torch.device(args.device).type == "cuda":
        print(f"[sweep] peak device memory: {torch.cuda.max_memory_allocated() / 1e9} GB",
              flush=True)
    return 0


def build_metrics(args, with_fvd: bool):
    """(LPIPS, FVD or None, provenance) from ``--lpips-alex/--lpips-lin`` and
    ``--i3d-ckpt`` on ``--device``; None (after saying why on stderr) when a
    checkpoint is missing, or when weights are random and
    ``--allow-uncalibrated`` was not given."""
    from tvc_torch.metrics.fvd import FVDMetric
    from tvc_torch.metrics.lpips import LPIPSMetric

    for path in (args.lpips_alex, args.lpips_lin, args.i3d_ckpt if with_fvd else None):
        if path and not os.path.isfile(path):
            print(f"[tvc_torch] ERROR: no such checkpoint: {path}", file=sys.stderr)
            return None
    lp = LPIPSMetric.create(args.lpips_alex, args.lpips_lin, device=args.device)
    fvd = None
    if with_fvd:
        sd = torch.load(args.i3d_ckpt, map_location="cpu", weights_only=True) \
            if args.i3d_ckpt else None
        fvd = FVDMetric(sd, device=args.device)
    fvd_calibrated = fvd is None or fvd.calibrated
    calibrated = lp.calibrated and fvd_calibrated
    if not calibrated:
        missing = ([] if lp.calibrated else ["LPIPS (--lpips-alex/--lpips-lin)"]) + \
                  ([] if fvd_calibrated else ["FVD I3D (--i3d-ckpt)"])
        if not args.allow_uncalibrated:
            print("[tvc_torch] ERROR: missing metric weights: " + ", ".join(missing)
                  + "; decisions and metrics would use random features. Pass "
                    "--allow-uncalibrated to run anyway (stamped into provenance).",
                  file=sys.stderr)
            return None
        print("[tvc_torch] WARNING: running UNCALIBRATED (" + ", ".join(missing)
              + "); RD outputs are not meaningful", flush=True)
    provenance = {"calibrated": calibrated, "lpips_calibrated": lp.calibrated,
                  "fvd_calibrated": fvd_calibrated}
    return lp, fvd, provenance


def cmd_anchors(argv: List[str]) -> int:
    """H.264/H.265 anchors of a dataset through ffmpeg: (videos, [psnr, lpips,
    fvd, bpp], n_qp) arrays, per preset or for one codec."""
    ap = argparse.ArgumentParser(prog="tvc_torch anchors")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for the LPIPS and FVD rows")
    ap.add_argument("--data-npy", required=True, help="(B,T,C,H,W) dataset npy in [0, 255]")
    ap.add_argument("--output", required=True,
                    help="output .npy path, or with --preset the output directory")
    ap.add_argument("--workdir", default=None,
                    help="directory for the yuv and mp4 files (default: a temporary one)")
    ap.add_argument("--preset", choices=["city", "uvg", "smm"], default=None,
                    help="a dataset's sweep (codecs, pix_fmt, frame count, names): writes "
                         "bench_<preset>_26{4,5}.npy, a txt per video and an averaged-curve "
                         "plot into --output")
    ap.add_argument("--codec", choices=["libx264", "libx265"], default="libx264")
    ap.add_argument("--qp-min", type=int, default=0)
    ap.add_argument("--qp-max", type=int, default=51)
    ap.add_argument("--start-idx", type=int, default=0)
    ap.add_argument("--end-idx", type=int, default=0)
    ap.add_argument("--no-metrics", action="store_true",
                    help="skip LPIPS and FVD and write NaN rows (default: both, on --device)")
    ap.add_argument("--lpips-alex", type=str, default=None, help="torchvision alexnet .pth")
    ap.add_argument("--lpips-lin", type=str, default=None, help="lpips linear heads .pth")
    ap.add_argument("--i3d-ckpt", type=str, default=None, help="pytorch_i3d state dict (.pt)")
    ap.add_argument("--allow-uncalibrated", action="store_true",
                    help="run on random LPIPS or I3D weights")
    args = ap.parse_args(argv)

    from tvc_torch.bench.anchors import build_anchor_array, have_ffmpeg
    from tvc_torch.pipeline.driver import load_dataset

    if not have_ffmpeg():
        print("ffmpeg not available; the anchor harness requires it", file=sys.stderr)
        return 2
    lp = fvd = None
    if not args.no_metrics:
        metrics = build_metrics(args, with_fvd=True)
        if metrics is None:
            return 2
        lp, fvd, _ = metrics
    qps = range(args.qp_min, args.qp_max + 1)
    data = load_dataset(args.data_npy)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = args.workdir or tmp
        if args.preset:
            from tvc_torch.bench.presets import PRESETS, plot_average_curves, run_preset

            preset = PRESETS[args.preset]
            if args.end_idx > 0:
                data = data[args.start_idx: args.end_idx + 1]
            arrays = run_preset(preset, data, workdir, args.output, lpips_metric=lp,
                                fvd_metric=fvd, qp_range=qps)
            try:
                plot_average_curves(
                    os.path.join(args.output, f"bench_{preset.name}_avg.png"),
                    anchors_264=arrays.get("libx264"), anchors_265=arrays.get("libx265"),
                    title=f"{preset.name} anchors")
            except ImportError:
                print("skipped the plot (matplotlib is not installed)")
            print(f"preset {preset.name}: wrote {sorted(os.listdir(args.output))} -> "
                  f"{args.output} in {time.perf_counter() - t0:.6f} s", flush=True)
            return 0
        arr = build_anchor_array(data[args.start_idx: args.end_idx + 1], workdir, args.codec,
                                 qps, lpips_metric=lp, fvd_metric=fvd)
    np.save(args.output, arr)
    print(f"saved {arr.shape} -> {args.output} in {time.perf_counter() - t0:.6f} s", flush=True)
    return 0


def cmd_train(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="tvc_torch train")
    _add_common_args(ap)
    ap.add_argument("--data-npy", required=True, help="(B,T,C,H,W) dataset npy")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--snapshot-freq", type=int, default=500)
    ap.add_argument("--resume-from", type=str, default=None,
                    help="snapshot path prefix from a previous run of this command or of "
                         "the JAX package's (e.g. out/ckpt_500) to restore params/EMA/"
                         "optimizer/step and continue until --steps")
    args = ap.parse_args(argv)

    cfg = _load_cfg(args)
    from tvc_torch.ops import attention
    from tvc_torch.pipeline.driver import load_dataset
    from tvc_torch.pipeline.train_loop import train

    data = load_dataset(args.data_npy)
    metrics = train(cfg, data, num_steps=args.steps, batch_size=args.batch_size,
                    snapshot_freq=args.snapshot_freq, out_dir=args.out_dir,
                    resume_from=args.resume_from, device=args.device)
    print(metrics)
    print(f"[train] attention kernel launches: {attention.launches}", flush=True)
    if torch.device(args.device).type == "cuda":
        print(f"[train] peak device memory: {torch.cuda.max_memory_allocated() / 1e9} GB",
              flush=True)
    return 0


def cmd_validate(argv: List[str]) -> int:
    """Load every reference artifact given and hold it against the strongest
    oracle at hand (``tvc_torch/utils/validate.py``); print a pass/fail/skip
    line per check and exit 1 on any failure:

      python -m tvc_torch.cli validate --ckpt checkpoint_900000.pt \
          --codec-ckpts 0.pth.tar ... 5.pth.tar --i3d i3d_pretrained_400.pt \
          --lpips-alex alexnet.pth --lpips-lin weights/v0.1/alex.pth \
          --data city_bonn.npy --report validate.json
    """
    ap = argparse.ArgumentParser(prog="tvc_torch validate", description=cmd_validate.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="diffusion checkpoint_900000.pt (list layout: [0]=sd, [-1]=EMA)")
    ap.add_argument("--codec-ckpts", nargs="*", default=None,
                    help="ELIC checkpoints q0..q5 (.pth.tar)")
    ap.add_argument("--i3d", type=str, default=None, help="I3D weights (.pt state dict)")
    ap.add_argument("--lpips-alex", type=str, default=None,
                    help="torchvision alexnet state dict")
    ap.add_argument("--lpips-lin", type=str, default=None,
                    help="LPIPS linear heads (reference weights/v0.1/alex.pth)")
    ap.add_argument("--lpips-lin-vgg", type=str, default=None,
                    help="LPIPS vgg linear heads (weights/v0.1/vgg.pth)")
    ap.add_argument("--lpips-lin-squeeze", type=str, default=None,
                    help="LPIPS squeeze linear heads (weights/v0.1/squeeze.pth)")
    ap.add_argument("--data", type=str, default=None, help="city_bonn.npy")
    ap.add_argument("--reference", type=str, default="reference",
                    help="a checkout of the reference repository, for its torch modules as "
                         "parity oracles (default: ./reference)")
    ap.add_argument("--no-bf16", action="store_true", help="skip the bf16 drift check")
    ap.add_argument("--no-rd", action="store_true", help="skip the real GOP RD point")
    ap.add_argument("--report", type=str, default=None, help="JSON report path")
    args = ap.parse_args(argv)

    from tvc_torch.utils.validate import report, run_validation

    results = run_validation(
        ckpt=args.ckpt, codec_ckpts=args.codec_ckpts, i3d=args.i3d,
        lpips_alex=args.lpips_alex, lpips_lin=args.lpips_lin, data_npy=args.data,
        reference=args.reference, with_bf16=not args.no_bf16, with_rd=not args.no_rd,
        lpips_lin_vgg=args.lpips_lin_vgg, lpips_lin_squeeze=args.lpips_lin_squeeze,
        device=args.device)
    from tvc_torch.ops import attention

    print(f"[validate] attention kernel launches: {attention.launches}", flush=True)
    return report(results, args.report)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {"sweep": cmd_sweep, "codec": cmd_codec, "gop": cmd_gop, "anchors": cmd_anchors,
            "train": cmd_train, "validate": cmd_validate}
    if not argv or argv[0] not in cmds:
        print(f"usage: python -m tvc_torch.cli {{{','.join(cmds)}}} ...")
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
