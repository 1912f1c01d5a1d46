#!/usr/bin/env python3
"""Drive tvc_torch's main path on one NVIDIA GPU at full width: a whole
30-frame GOP coded into TVC2 containers and a payload, and rebuilt byte for
byte by a receiver in a fresh process.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and the
   numerics flags the port sets;
2. the build of every kernel from ``tvc_torch/csrc`` (with ``-Xptxas -v``) and
   of the host rANS coder into ``tvc_torch/build``;
3. every kernel against its plain PyTorch version on the card, at the shapes
   and in the layout of the flagship UNet (strided heads of (B, T, C)
   projections; B = 1 and 8; float32 and bfloat16), two launches bit-identical,
   with its plan (query tile, key splits, blocks), registers and spills, its
   time, the plain version's, ``scaled_dot_product_attention``'s as a
   yardstick and the bound of the card. Times are device times of a CUDA graph
   of many launches (``eager_ms``: the same launches from the host);
4. the full-width UNet (default ``Config()``, 262.1M parameters, seeded random
   weights): one forward through the kernel against one through the plain
   attention on the card, its time, and a profile of one call;
5. one predict-and-decide cycle at B = 1 through ``Sender.update`` (101 UNet
   calls, 1010 attention launches) on a seeded synthetic 30-frame 128x128
   video, and its rerun with the same generator seed, which must be
   byte-identical (the receiver regenerates frames that way);
6. the full-width ELIC keyframe codec (default ``CodecConfig``, seeded random
   weights) on the video's first two frames: compress, TVC2 container,
   decompress, with ``entropy_backend="device"`` and ``"cpu"``; the sender's
   reconstruction must equal the receiver's byte for byte;
7. the main path: ``run_gop`` over the 30-frame video with the full-width UNet
   and ELIC (``"device"`` backend), the payload written by the CLI's own
   function, then ``python -m tvc_torch.cli gop receive`` in a fresh process,
   whose frames must equal the sender's byte for byte. The sender must launch
   the attention kernel 1010 times per update, and take at least one accepted
   prediction and one fallback pair.

The last lines are the ``kernels`` JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result; nothing runs on the CPU.

    python3 chip_smoke.py --sweep   # also time every attention plan at the B=1 levels
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

F32_PEAK = 67e12     # H100 SXM float32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12    # H100 SXM device memory bytes/s

# the flagship UNet's attention levels: (name, tokens T, heads H, launches per UNet call)
LEVELS = [("32x32", 1024, 2, 3), ("16x16", 256, 3, 3), ("8x8", 64, 4, 4)]
HEAD_DIM = 192
F32_TOL = 1e-4       # max |kernel - plain| on N(0, 1) inputs, float32
UNET_REL_TOL = 1e-4  # full-width forward: max |kernel - plain| / max |plain|
# LPIPS rho of the bare cycle of phase 5. The seeded random LPIPS weights score
# this video's predictions from its first two frames at about 0.10-0.12 (H100
# run of this script).
THRESHOLD = 0.119
GOP_FRAMES = 30
# LPIPS rho of the GOP (phase 7). Its predictions are conditioned on frames
# decoded by a random-weight ELIC (about 5 dB PSNR), not on the video's own
# frames, so they score higher than phase 5's: on an H100, an all-fallback run
# of this GOP scored the first predicted frame of its 14 updates at 0.12816
# (the first update) and 0.12841-0.13523 (the others). A rho just above the
# first update's score accepts that prediction and rejects most predictions
# made from a decoded pair, so the GOP takes both paths.
GOP_THRESHOLD = 0.1285
GOP_THRESHOLD_REASON = ("just above the first update's first-frame LPIPS (0.12816 on an H100), "
                        "below most first-frame scores from decoded pairs (0.12841-0.13523)")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean time of one ``fn()`` over ``iters`` launches from the host, after
    warm-up (CUDA events: the card's time, or the host's where it launches
    slower than the card runs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Mean device time of one ``fn()`` in a CUDA graph of ``iters`` calls:
    the card's time without the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def attention_bound_ms(b, h, t, d, itemsize, peak):
    flops = 4.0 * b * h * t * t * d          # q k^T and p v, 2 FLOP per multiply-add
    nbytes = 4.0 * b * h * t * d * itemsize  # q, k, v read once, o written once
    return max(flops / peak, nbytes / HBM_BPS) * 1e3, flops / peak >= nbytes / HBM_BPS


def ptxas_entries(report: str) -> dict:
    """Registers and spill bytes of each kernel entry in an ``-Xptxas -v``
    report, keyed by (dtype, float4 columns a lane owns in p.v)."""
    entries, key = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\S*attention_fwdI(f|13__nv_bfloat16)Li(\d+)E",
                      line)
        if m:
            key = ("float32" if m.group(1) == "f" else "bfloat16", int(m.group(2)))
            entries[key] = {"registers": None, "spill_bytes": 0}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entries[key]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[key]["registers"] = int(m.group(1))
    return entries


def head_view(x, b, h, t, d):
    """(B, T, H*d) -> the strided (B, H, T, d) view the attention block passes."""
    return x.view(b, t, h, d).transpose(1, 2)


def phase_kernels(torch, attn, ptxas):
    """Phase 3: the attention kernel against its plain version at every flagship shape."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype, peak in ((torch.float32, F32_PEAK), (torch.bfloat16, BF16_PEAK)):
        for b in (1, 8):
            for name, t, h, per_call in LEVELS:
                q, k, v = (head_view(torch.randn((b, t, h * HEAD_DIM), generator=g,
                                                 device="cuda").to(dtype), b, h, t, HEAD_DIM)
                           for _ in range(3))
                out = attn.attention(q, k, v)
                ref = attn.attention_plain(q, k, v)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                if dtype == torch.float32:
                    tol = F32_TOL
                else:  # two bf16 ulps at the output's magnitude
                    tol = 2.0 ** -6 * max(1.0, ref.float().abs().max().item())
                if not err <= tol or not torch.isfinite(out).all():
                    fail(f"attention {name} B={b} {dtype}: max|kernel-plain| {err} > {tol}")
                if out.transpose(1, 2).stride() != (t * h * HEAD_DIM, h * HEAD_DIM, HEAD_DIM, 1):
                    fail(f"attention {name} B={b} {dtype}: output is not laid out as (B, T, H, d)")
                again = attn.attention(q, k, v)
                if not torch.equal(again, out):
                    fail(f"attention {name} B={b} {dtype}: two launches differ")
                plan = attn.attention_plan(b, h, t, HEAD_DIM, dtype)
                info = attn.kernel_info(dtype, HEAD_DIM, plan.splits)
                regs = ptxas[(str(dtype).replace("torch.", ""), -(-HEAD_DIM // 64))]
                iters = 50 if b * t >= 1024 else 200
                ms = graph_ms(torch, lambda: attn.attention(q, k, v), iters)
                eager = time_ms(torch, lambda: attn.attention(q, k, v), iters)
                plain_ms = graph_ms(torch, lambda: attn.attention_plain(q, k, v), iters)
                lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), iters)
                bound, by_ops = attention_bound_ms(b, h, t, HEAD_DIM, q.element_size(), peak)
                row = {"level": name, "B": b, "T": t, "H": h, "d": HEAD_DIM,
                       "dtype": str(dtype).replace("torch.", ""), "per_unet_call": per_call,
                       "bq": attn.QUERY_TILE, "splits": plan.splits, "blocks": plan.blocks,
                       "max_abs_err": err, "tol": tol, "ms": ms, "eager_ms": eager,
                       "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
                       "bound_by": "operations" if by_ops else "bytes",
                       "share_of_bound": bound / ms, **regs, **info}
                rows.append(row)
                log("attention_shape " + json.dumps(row))
    return rows


def phase_sweep(torch, attn):
    """``--sweep``: the kernel's time at every plan at the B=1 float32 levels."""
    for name, t, h, _ in LEVELS:
        g = torch.Generator(device="cuda").manual_seed(3)
        q, k, v = (head_view(torch.randn((1, t, h * HEAD_DIM), generator=g, device="cuda"),
                             1, h, t, HEAD_DIM) for _ in range(3))
        ref = attn.attention_plain(q, k, v)
        ntiles = -(-t // attn.KEY_TILE)
        for splits in range(1, attn.MAX_SPLITS + 1):
            per = -(-ntiles // splits)
            if -(-ntiles // per) != splits:
                continue
            plan = attn.AttentionPlan(splits, per * attn.KEY_TILE,
                                      h * -(-t // attn.QUERY_TILE) * splits)
            out = attn.launch(q, k, v, plan)
            err = (out - ref).abs().max().item()
            if not err <= F32_TOL:
                fail(f"sweep {name} {plan}: max|kernel-plain| {err}")
            ms = graph_ms(torch, lambda: attn.launch(q, k, v, plan), 50)
            clusters = attn.kernel_info(torch.float32, HEAD_DIM, splits)["max_active_clusters"]
            log("sweep " + json.dumps({"level": name, "splits": splits, "blocks": plan.blocks,
                                       "ms": ms, "max_abs_err": err,
                                       "max_active_clusters": clusters}))


def phase_unet(torch, attn, layers, predictor):
    """Phase 4: the full-width forward through the kernel against the plain attention."""
    from unittest import mock

    cfg = predictor.cfg
    model = predictor.model
    n_params = sum(p.numel() for p in model.parameters())
    log(f"unet: {n_params} parameters ({n_params / 1e6:.1f}M), "
        f"{n_params * 4 / 1e9:.3f} GB float32, image {cfg.data.image_size}, ngf {cfg.model.ngf}, "
        f"ch_mult {cfg.model.ch_mult}")
    if round(n_params / 1e6, 1) != 262.1:
        fail(f"expected the 262.1M-parameter flagship UNet, got {n_params}")
    g = torch.Generator(device="cuda").manual_seed(1)
    size, c = cfg.data.image_size, cfg.data.channels
    x = torch.randn((1, size, size, c * cfg.data.num_frames), generator=g, device="cuda")
    cond = torch.rand((1, size, size, c * cfg.data.num_frames_cond), generator=g,
                      device="cuda") * 2 - 1
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        before = attn.launches
        out = model(x, t, cond)
        if attn.launches - before != 10:
            fail(f"the UNet forward launched {attn.launches - before} attention kernels, not 10")
        with mock.patch.object(layers, "attention", attn.attention_plain):
            ref = model(x, t, cond)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        log(f"unet forward: max|kernel-plain| {err:.3e}, max|plain| {scale:.3e}, "
            f"rel {err / scale:.3e} (tol {UNET_REL_TOL})")
        if not torch.isfinite(out).all() or not scale > 1e-2 or not err <= UNET_REL_TOL * scale:
            fail("full-width forward through the kernel disagrees with the plain attention")
        unet_ms = time_ms(torch, lambda: model(x, t, cond), 10)
        log(f"unet forward B=1: {unet_ms:.3f} ms per call (CUDA events, 10 calls)")
        prof_lines = profile_unet(torch, lambda: model(x, t, cond))
    for line in prof_lines:
        log(line)
    return {"unet_ms": unet_ms, "forward_rel_err": err / scale, "n_params": n_params}


def profile_unet(torch, fn):
    """Device time of one UNet call by kernel, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels themselves; the aten:: ops above them repeat their device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    attn_us = sum(e.self_device_time_total for e in events if "attention_fwd" in e.key)
    copies = [e for e in events if "copy" in e.key.lower()]
    lines = [f"profile: one UNet call, {total / 1e3:.3f} ms of device time in "
             f"{len(events)} kernel names",
             f"profile: attention kernel {attn_us / 1e3:.3f} ms = "
             f"{attn_us / total if total else 0.0:.1%} of the device time",
             f"profile: copy kernels {sum(e.count for e in copies)} launches, "
             f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms"]
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        share = e.self_device_time_total / total if total else 0.0
        lines.append(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms {share:6.1%} "
                     f"x{e.count:<5d} {e.key[:90]}")
    return lines


def synthetic_video(n=30, size=128, seed=7):
    """A seeded smooth moving pattern with a little noise, (1, n, size, size, 3) in [0, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    freq = rng.uniform(0.5, 2.0, (3, 2)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    frames = []
    for t in range(n):
        chans = [0.5 + 0.35 * np.sin(2 * np.pi * (freq[ch, 0] * xx + freq[ch, 1] * yy)
                                     + phase[ch] + 0.15 * t) for ch in range(3)]
        frames.append(np.stack(chans, -1))
    video = np.stack(frames)[None] + 0.02 * rng.randn(1, n, size, size, 3)
    return np.clip(video, 0.0, 1.0).astype(np.float32)


def phase_cycle(torch, attn, sender, video):
    """Phase 5: one bare cycle from the video's first two frames, and its rerun."""
    n_cond = sender.cfg.data.num_frames_cond
    x_ge, d = video[:, :n_cond], np.ones((1, n_cond), np.int64)
    preds = []
    generate = sender.predictor.generate

    def recording_generate(*args, **kwargs):
        out = generate(*args, **kwargs)
        preds.append(out.clone())
        return out

    sender.predictor.generate = recording_generate
    per_call = sender.predictor.n_steps * sum(n for *_, n in LEVELS)
    try:
        attn.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ge = sender.update(torch.Generator(device="cuda").manual_seed(1000), video, x_ge, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = attn.launches
        pred = preds[-1]
        scores = sender.lpips(pred[0], video[0, n_cond:n_cond + pred.shape[1]])
        row = {"wall_s": wall, "accepted": ge.shape[1] - n_cond, "attention_launches": launches,
               "unet_calls": sender.predictor.n_steps,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "lpips": [round(x, 5) for x in scores.tolist()], "threshold": sender.threshold}
        log("cycle " + json.dumps(row))
        if launches != per_call:
            fail(f"the cycle launched the attention kernel {launches} times, not {per_call}")
        if pred.shape != (1, sender.cfg.data.num_frames, 128, 128, 3) or \
                not torch.isfinite(pred).all() or pred.min() < 0 or pred.max() > 1:
            fail(f"the cycle's prediction of shape {tuple(pred.shape)} is not frames in [0,1]")
        sender.update(torch.Generator(device="cuda").manual_seed(1000), video, x_ge, d)
        same = preds[-1].cpu().numpy().tobytes() == preds[0].cpu().numpy().tobytes()
    finally:
        sender.predictor.generate = generate
    log(f"determinism: the cycle rerun with the same seed is "
        f"{'byte-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("the rerun prediction is not byte-identical")
    return row


def timed(torch, fn):
    """(result, host seconds) of ``fn()``, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_codec(torch, model, video):
    """Phase 6: a full-width keyframe pair through both entropy backends."""
    from tvc_torch.metrics.pixel import psnr
    from tvc_torch.models.codec import container
    from tvc_torch.models.codec.coding import ELICCoder
    from tvc_torch.pipeline.keyframe import per_frame_bits

    x = video[0, :2]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"elic: {n_params} parameters ({n_params / 1e6:.2f}M), N {model.N}, M {model.M}, "
        f"groups {model.groups}")
    rows = {}
    for backend in ("device", "cpu"):
        coder = ELICCoder(model, backend)
        warm = coder.compress(x)
        coder.decompress(warm["strings"], warm["shape"])
        enc, t_enc = timed(torch, lambda: coder.compress(x, return_recon=True))
        blob = container.serialize(enc, entropy_backend=backend)
        got = container.deserialize(blob, expect_entropy_backend=backend)
        dec, t_dec = timed(torch, lambda: coder.decompress(got["strings"], got["shape"]))
        same = enc["x_hat"].tobytes() == dec["x_hat"].tobytes()
        bits = per_frame_bits(enc["strings"], 2)
        row = {"backend": backend, "container_bytes": len(blob), "bits_per_frame": bits,
               "bpp": sum(bits) / x[..., 0].size,
               "psnr_db": float(np.mean([psnr(a, b) for a, b in zip(x, enc["x_hat"])])),
               "encode_s": t_enc, "decode_s": t_dec, "encode_phases_s": enc["time"],
               "decode_phases_s": dec["time"], "byte_identical": same}
        log("codec_pair " + json.dumps(row))
        if enc["x_hat"].shape != x.shape or not np.isfinite(enc["x_hat"]).all():
            fail(f"codec ({backend}): reconstruction of shape {enc['x_hat'].shape} is not frames")
        if not same:
            fail(f"codec ({backend}): the receiver's reconstruction differs from the sender's")
        rows[backend] = row
    return {"n_params": n_params, **rows}


def phase_gop(torch, attn, sender, coder, video, config_mods):
    """Phase 7, the main path: a 30-frame GOP, its payload, and a receiver in a
    fresh process, which is given ``config_mods`` (the sender's config)."""
    from tvc_torch import cli
    from tvc_torch.core.runtime import numerics_stamp
    from tvc_torch.pipeline.sender import run_gop

    cfg = sender.cfg
    per_update = sender.predictor.n_steps * sum(n for *_, n in LEVELS)
    scores = []
    lpips = sender.lpips

    def recording_lpips(a, b):
        out = lpips(a, b)
        scores.append([round(v, 5) for v in out.tolist()])
        return out

    sender.lpips = recording_lpips
    torch.cuda.reset_peak_memory_stats()
    try:
        attn.reset_launches()  # the main path starts here
        gop, wall = timed(torch, lambda: run_gop(sender, coder, video[0], cfg.seed, GOP_FRAMES,
                                                  cfg.codec.patch, keep_streams=True))
        launches = attn.launches  # read right after the main path
    finally:
        sender.lpips = lpips
    peak = torch.cuda.max_memory_allocated() / 1e9
    d = [int(v) for v in gop.d[0]]
    row = {"n_updates": gop.n_updates, "accepts": gop.accepts, "d": d, "bits": gop.bits,
           "bpp": gop.bpp, "sender_wall_s": wall, "update_s": gop.update_s,
           "keyframe_events": len(gop.containers), "keyframe_s": gop.keyframe_s,
           "container_bytes": [len(c) for c in gop.containers], "lpips": scores,
           "threshold": sender.threshold,
           "threshold_margin": float(np.min(np.abs(np.concatenate(scores) - sender.threshold))),
           "attention_launches": launches,
           "peak_mem_gb": peak}
    log("gop_sender " + json.dumps(row))
    if launches != per_update * gop.n_updates:
        fail(f"the GOP launched the attention kernel {launches} times, not "
             f"{per_update} x {gop.n_updates}")
    if (len(d) != GOP_FRAMES or len(gop.containers) != 1 + gop.accepts.count(0)
            or d.count(0) != sum(gop.accepts) or len(gop.accepts) != gop.n_updates):
        fail("d, accepts and the containers disagree")
    x_ge = gop.x_ge[0]
    if x_ge.shape != (GOP_FRAMES,) + video.shape[2:] or x_ge.dtype != np.float32 or \
            not np.isfinite(x_ge).all() or x_ge.min() < 0 or x_ge.max() > 1:
        fail(f"the GOP's frames ({x_ge.shape}, {x_ge.dtype}) are not 30 frames in [0, 1]")

    with tempfile.TemporaryDirectory() as tmp:
        payload, out = os.path.join(tmp, "gop.tvcg"), os.path.join(tmp, "receiver.npy")
        nbytes = cli.write_payload(payload, gop, cfg.seed, False,
                                   numerics_stamp(coder.device, coder.entropy_backend))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tvc_torch.cli", "gop", "receive", "--payload", payload,
             "--output-npy", out, "--device", coder.device.type, "--config-mod", *config_mods],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        recv_wall = time.perf_counter() - t0
        for line in (proc.stdout + proc.stderr).strip().splitlines():
            log("  receiver| " + line)
        if proc.returncode != 0:
            fail(f"the receiver process exited {proc.returncode}")
        m = re.search(r"in ([0-9.]+) s \(models built in ([0-9.]+) s\)", proc.stdout)
        rec = np.load(out)
    same = rec.dtype == x_ge.dtype and rec.tobytes() == x_ge.tobytes()
    recv = {"payload_bytes": nbytes, "receiver_wall_s": recv_wall,
            "receiver_run_s": float(m.group(1)) if m else None,
            "receiver_models_s": float(m.group(2)) if m else None, "byte_identical": same}
    log("gop_receiver " + json.dumps(recv))
    if not same:
        fail("the receiver's frames differ from the sender's")
    if 0 not in gop.accepts or max(gop.accepts) == 0:
        fail(f"accepts {gop.accepts}: the GOP must take an accepted prediction and a fallback "
             f"pair; move GOP_THRESHOLD ({GOP_THRESHOLD}) between the scores above")
    return {**row, **recv}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the card only")
    sys.path.insert(0, ROOT)
    from tvc_torch.core.config import Config
    from tvc_torch.core.runtime import numerics, set_numerics
    from tvc_torch.metrics.lpips import LPIPSMetric
    from tvc_torch.models.diffusion import layers
    from tvc_torch.ops import _build
    from tvc_torch.ops import attention as attn
    from tvc_torch.pipeline.sender import Sender

    t_start = time.perf_counter()
    card = smi_name_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"cuDNN {torch.backends.cudnn.version()}, devices {torch.cuda.device_count()}")
    log("numerics " + json.dumps(set_numerics()))

    t0 = time.perf_counter()
    reports = _build.build(force=True)
    for name, report in reports.items():
        log(f"built {name} from tvc_torch/csrc/{_build.SOURCES[name]} "
            f"into {os.path.relpath(_build.lib_path(name), ROOT)}; ptxas report:")
        for line in report.strip().splitlines():
            log("  " + line)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_entries(reports["attention"])
    log("ptxas attention_fwd<dtype, float4 cols a lane>: " + json.dumps(
        {f"{dt},{c}": e for (dt, c), e in sorted(ptxas.items())}))
    at_192 = [e for (_, c), e in ptxas.items() if c == -(-HEAD_DIM // 64)]
    if len(at_192) != 2 or any(e["spill_bytes"] for e in at_192):
        fail(f"expected 2 spill-free instantiations at d = {HEAD_DIM}, got {at_192}")

    rows = phase_kernels(torch, attn, ptxas)
    if "--sweep" in sys.argv[1:]:
        phase_sweep(torch, attn)

    import tvc_torch.cli as cli
    from tvc_torch.entropy import rans

    rans_lib = rans.build(force=True)
    log(f"built the rANS coder into {os.path.relpath(rans_lib, ROOT)}")

    cfg = Config()
    cfg.codec.entropy_backend = "device"
    predictor = cli.build_predictor(cfg, "cuda")
    unet = phase_unet(torch, attn, layers, predictor)

    video = synthetic_video(n=GOP_FRAMES)
    lpips = LPIPSMetric.create(seed=0, device="cuda")
    cycle = phase_cycle(torch, attn, Sender(THRESHOLD, cfg, predictor, lpips), video)

    coder = cli.build_coder(cfg, "cuda")
    codec = phase_codec(torch, coder.model, video)

    log(f"gop threshold {GOP_THRESHOLD}: {GOP_THRESHOLD_REASON}")
    gop = phase_gop(torch, attn, Sender(GOP_THRESHOLD, cfg, predictor, lpips), coder, video,
                    ["codec.entropy_backend=device"])
    main_launches = gop["attention_launches"]
    if main_launches == 0:
        fail("the main path launched no attention kernel")

    main_rows = [r for r in rows if r["B"] == 1 and r["dtype"] == "float32"]
    per_call = {r["level"]: r["per_unet_call"] for r in main_rows}

    def per_unet_call(key):
        return sum(r[key] * per_call[r["level"]] for r in main_rows)

    # each level's bound is the larger of its two times; a call's is their sum
    ops_ms = sum(r["bound_ms"] * r["per_unet_call"] for r in main_rows
                 if r["bound_by"] == "operations")
    byte_ms = sum(r["bound_ms"] * r["per_unet_call"] for r in main_rows
                  if r["bound_by"] == "bytes")
    for r in main_rows:
        log(f"attention {r['level']} B=1 float32: kernel {r['ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['share_of_bound']:.1%} of bound), {r['blocks']} blocks")
    log(f"attention per UNet call: kernel {per_unet_call('ms'):.4f} ms, SDPA "
        f"{per_unet_call('library_ms'):.4f} ms, bound {ops_ms + byte_ms:.5f} ms "
        f"({(ops_ms + byte_ms) / per_unet_call('ms'):.1%} of bound)")
    log("summary " + json.dumps({
        "unet_ms": unet["unet_ms"], "cycle_wall_s": cycle["wall_s"],
        "codec_encode_s": {b: codec[b]["encode_s"] for b in ("device", "cpu")},
        "codec_decode_s": {b: codec[b]["decode_s"] for b in ("device", "cpu")},
        "gop_sender_wall_s": gop["sender_wall_s"], "gop_receiver_wall_s": gop["receiver_wall_s"],
        "gop_receiver_run_s": gop["receiver_run_s"], "gop_n_updates": gop["n_updates"],
        "gop_bpp": gop["bpp"], "gop_peak_mem_gb": gop["peak_mem_gb"], "numerics": numerics(),
        "total_s": time.perf_counter() - t_start}))
    kernels = [{
        "name": "attention",
        "route": "cuda",
        "source": "tvc_torch/csrc/attention.cu",
        "replaces": "tvc/ops/pallas_attention.py:47",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        # the 10 launches of one UNet call at B=1 in float32 (3 at 32x32, 3 at 16x16, 4 at 8x8)
        "ms": per_unet_call("ms"),
        "plain_ms": per_unet_call("plain_ms"),
        "bound_ms": ops_ms + byte_ms,
        "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
        "library_ms": per_unet_call("library_ms"),
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi_name_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
