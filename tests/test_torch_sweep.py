"""tvc_torch rate sweep, its driver and the sweep CLI against the JAX
package's, on the tiny pipeline of tests/test_torch_gop.py.

Tolerances: RD envelopes, work partitions and config dumps equal; the rate
sweep's points, ``d`` and bpp equal (the whole-GOP sender's likelihood bpp
within 1e-4 relative), PSNR within 1e-3 dB and LPIPS within 1e-5, with JAX's
noise handed to each point; the drivers write the JAX package's file layout.
With FVD (the I3D's weights drawn on the port and carried into JAX), the
sequential driver's ``points.json`` FVD values are the JAX sweep's within
1e-4 relative. The CLI's guards exit 2 as the JAX package's do, ``config.yml``
carries the provenance, and ``gop send --device-gop`` and ``gop receive`` in
other processes give the same frames byte for byte.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from test_torch_eval import _JaxFVD, _jax_i3d_params, _np_sd_tensors, _random_i3d
from test_torch_gop import (  # noqa: F401  (module-scoped fixtures)
    THRESHOLDS,
    TINY_MODS,
    _cli,
    jax_noise,
    one_torch_thread,
    pipelines,
    smooth_video,
)
from tvc.core.config import save_config as j_save_config
from tvc.metrics import rd as jrd
from tvc.parallel.mesh import partition_work as j_partition_work
from tvc.pipeline import driver as jdriver
from tvc.pipeline.fused_gop import FusedGOPSender as JFusedGOPSender
from tvc.pipeline.sender import DeviceGOPRunner as JDeviceGOPRunner
from tvc.pipeline.sender import RatePoint as JRatePoint
from tvc.pipeline.sender import rate_sweep as j_rate_sweep
from tvc_torch import cli
from tvc_torch.core.config import load_config, save_config
from tvc_torch.metrics.fvd import FVDMetric
from tvc_torch.metrics import rd
from tvc_torch.parallel.mesh import partition_work
from tvc_torch.pipeline import driver
from tvc_torch.pipeline.fused_gop import FusedGOPSender
from tvc_torch.pipeline.sender import (
    DeviceGOPRunner,
    RatePoint,
    Sender,
    rate_sweep,
    run_gop,
    update_seed,
)

T = 6
MIXED_RHO = THRESHOLDS[2]
SWEEP_THRESHOLDS = [THRESHOLDS[0], MIXED_RHO]


def _points(n, seed):
    """n RD points with noisy monotone metrics."""
    rng = np.random.RandomState(seed)
    bpp = np.sort(rng.uniform(0.01, 1.0, n))
    return (bpp, [list(20 + 10 * b + rng.randn(4)) for b in bpp],
            [list(0.5 - 0.3 * b + 0.02 * rng.randn(4)) for b in bpp],
            list(300 - 200 * bpp + 20 * rng.randn(n)))


@pytest.mark.parametrize("seed", range(4))
def test_rd_envelopes_match_jax(seed, tmp_path):
    bpp, psnrs, lpipss, fvds = _points(7, seed)
    for name in ("psnr_envelope", "lpips_envelope", "fvd_envelope"):
        vals = {"psnr_envelope": np.mean(psnrs, 1), "lpips_envelope": np.mean(lpipss, 1),
                "fvd_envelope": fvds}[name]
        np.testing.assert_array_equal(getattr(rd, name)(bpp, vals), getattr(jrd, name)(bpp, vals))
    got = rd.process_data_and_save(3, bpp, psnrs, lpipss, fvds, str(tmp_path / "port"))
    want = jrd.process_data_and_save(3, bpp, psnrs, lpipss, fvds, str(tmp_path / "jax"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("n_points", [2, 5])
def test_persist_rd_results_matches_jax(n_points, tmp_path):
    """With fewer than 3 points there is no hull: both write the raw points."""
    bpp, psnrs, lpipss, fvds = _points(n_points, 9)
    fields = [dict(quality=4, threshold=0.1 * i, bpp=float(b), psnr_list=p, lpips_list=lp,
                   fvd=float("nan") if i == 0 else float(f), d=[1, 0])
              for i, (b, p, lp, f) in enumerate(zip(bpp, psnrs, lpipss, fvds))]
    driver.persist_rd_results(0, [RatePoint(**f) for f in fields], str(tmp_path / "port"))
    jdriver.persist_rd_results(0, [JRatePoint(**f) for f in fields], str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and "psnr_0.npy" in names
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                          np.load(tmp_path / "jax" / name))
        elif name.endswith(".json"):
            assert (json.loads((tmp_path / "port" / name).read_text())
                    == json.loads((tmp_path / "jax" / name).read_text()))


def test_partition_work_and_config_dump_match_jax(pipelines, tmp_path):
    items = [(v, q) for v in range(5) for q in (4, 5)]
    for n in (1, 2, 3):
        for i in range(n):
            assert partition_work(items, n, i) == j_partition_work(items, n, i)
    cfg, jcfg = pipelines[0][0], pipelines[1][0]
    extra = {"provenance": {"calibrated": False}}
    save_config(cfg, str(tmp_path / "port.yml"), extra=extra)
    j_save_config(jcfg, str(tmp_path / "jax.yml"), extra=extra)
    assert (yaml.safe_load((tmp_path / "port.yml").read_text())
            == yaml.safe_load((tmp_path / "jax.yml").read_text()))


def _point_keys(key, n):
    keys = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


@pytest.mark.parametrize("runner", ["host", "device", "fused"])
def test_rate_sweep_matches_jax(pipelines, runner):
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    video, key = smooth_video(n=T), jax.random.PRNGKey(13)
    kw, jkw = {}, {}
    if runner == "device":
        kw["device_runner"] = DeviceGOPRunner(cfg, pred, lpips=lp, num_frames_total=T)
        jkw["device_runner"] = JDeviceGOPRunner(jcfg, jpred, lpips=jlp, num_frames_total=T)
    elif runner == "fused":
        kw["fused"] = FusedGOPSender(cfg, pred, coder, lp, num_frames_total=T)
        jkw["fused"] = JFusedGOPSender(cfg=jcfg, predictor=jpred, coder=jcoder, lpips=jlp,
                                       num_frames_total=T)
    want = j_rate_sweep(jcfg, video, {0: jcoder}, jpred, jlp, qualities=[0],
                        thresholds=SWEEP_THRESHOLDS, key=key, num_frames_total=T, bpp_stop=1e9,
                        verbose=False, **jkw)
    subs = _point_keys(key, len(SWEEP_THRESHOLDS))
    got = rate_sweep(cfg, video, {0: coder}, pred, lp, qualities=[0],
                     thresholds=SWEEP_THRESHOLDS, seed=0, num_frames_total=T, bpp_stop=1e9,
                     verbose=False, noise=lambda k: jax_noise(subs[k], pred), **kw)
    assert len(got) == len(want) == len(SWEEP_THRESHOLDS)
    for g, w in zip(got, want):
        assert (g.quality, g.threshold, g.d) == (w.quality, w.threshold, w.d)
        if runner == "fused":
            np.testing.assert_allclose(g.bpp, w.bpp, rtol=1e-4)
        else:
            assert g.bpp == w.bpp
        np.testing.assert_allclose(g.psnr_list, w.psnr_list, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.lpips_list, w.lpips_list, atol=1e-5, rtol=0)
        assert np.isnan(g.fvd) and np.isnan(w.fvd)
    assert got[0].d == [1, 1] + [0] * (T - 2) and got[1].d != got[0].d


def test_rate_sweep_stops_a_walk_and_seeds_each_point(pipelines, capsys):
    cfg, pred, coder, lp = pipelines[0]
    video = smooth_video(n=T)
    assert rate_sweep(cfg, video, {0: coder, 1: coder}, pred, lp, qualities=[0, 1],
                      thresholds=[1e9, 1e9], seed=2, num_frames_total=T, bpp_stop=1e-9) == []
    assert capsys.readouterr().out.count("stopping threshold walk") == 2
    kept = []
    points = rate_sweep(cfg, video, {0: coder}, pred, lp, qualities=[0], thresholds=[MIXED_RHO],
                        seed=2, num_frames_total=T, bpp_stop=1e9, verbose=False,
                        artifact_cb=lambda q, thr, x: kept.append((q, thr, x)))
    gop = run_gop(Sender(MIXED_RHO, cfg, pred, lp), coder, video, update_seed(2, 0), T)
    assert points[0].d == [int(v) for v in gop.d[0]] and points[0].bpp == gop.bpp
    assert kept[0][:2] == (0, MIXED_RHO) and kept[0][2].tobytes() == gop.x_ge[0].tobytes()


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_drivers_write_the_jax_layout(pipelines, tmp_path, mode):
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    data = np.stack([smooth_video(n=T, seed=s) for s in (7, 9)])
    common = dict(start_idx=0, end_idx=1, qualities=[0], thresholds=SWEEP_THRESHOLDS)
    if mode == "sequential":
        got = driver.run_sweep(cfg, data, {0: coder}, pred, str(tmp_path / "port"),
                               with_fvd=False, lpips_metric=lp, **common)
        want = jdriver.run_sweep(jcfg, data, {0: jcoder}, jpred, str(tmp_path / "jax"),
                                 with_fvd=False, lpips_metric=jlp, **common)
    else:
        got = driver.run_sweep_batched(cfg, data, {0: coder}, pred, str(tmp_path / "port"),
                                       batch_size=2, with_fvd=False, lpips_metric=lp,
                                       **common)
        want = jdriver.run_sweep_batched(jcfg, data, {0: jcoder}, jpred, str(tmp_path / "jax"),
                                         batch_size=2, with_fvd=False, lpips_metric=jlp,
                                         **common)
    assert sorted(got) == sorted(want) and [len(v) for v in got.values()] == \
        [len(want[k]) for k in got]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for vid in got:
        pts = json.loads((tmp_path / "port" / f"output_{vid}" / "points.json").read_text())
        assert [sorted(p) for p in pts] == [sorted(dataclasses.asdict(p)) for p in want[vid]]
        assert [p["d"] for p in pts] == [p.d for p in got[vid]]
    if mode == "sequential":
        # the queued driver: the JAX package's files, and the sequential points
        # (one quality: a unit's GOPs are the sequential sweep's, seed for seed)
        driver.run_sweep_queued(cfg, data, {0: coder}, pred, str(tmp_path / "port_q"),
                                str(tmp_path / "q"), with_fvd=False, lpips_metric=lp, **common)
        jdriver.run_sweep_queued(jcfg, data, {0: jcoder}, jpred, str(tmp_path / "jax_q"),
                                 str(tmp_path / "jq"), with_fvd=False, lpips_metric=jlp,
                                 **common)
        assert _tree(tmp_path / "port_q") == _tree(tmp_path / "jax_q")
        for vid in got:
            assert (json.loads((tmp_path / "port_q" / f"output_{vid}" / "points.json")
                               .read_text())
                    == json.loads((tmp_path / "port" / f"output_{vid}" / "points.json")
                                  .read_text()))


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_drivers_build_an_fvd_metric_by_default(pipelines, tmp_path, monkeypatch, mode):
    """Without an FVD metric both drivers build one on the predictor's device
    and write its value for each point, given the GOP and the ground truth
    each repeated to a batch of two; ``with_fvd=False`` writes none."""
    cfg, pred, coder, lp = pipelines[0]
    calls, built = [], []

    class RecordingFVD:
        def __init__(self, device="cuda"):
            built.append(device)

        def __call__(self, v1, v2):
            calls.append((v1, v2))
            return float(np.abs(v1 - v2).mean())

    monkeypatch.setattr(driver, "FVDMetric", RecordingFVD)
    data = smooth_video(n=T)[None]
    run = driver.run_sweep if mode == "sequential" else functools.partial(
        driver.run_sweep_batched, batch_size=2)
    got = run(cfg, data, {0: coder}, pred, str(tmp_path / "out"), qualities=[0],
              thresholds=[THRESHOLDS[0]], lpips_metric=lp)
    assert built == [pred.device] and len(calls) == len(got[0]) == 1
    v1, v2 = calls[0]
    assert v1.shape == v2.shape == (2, T, 64, 64, 3)
    assert np.array_equal(v1[0], v1[1]) and np.array_equal(v2[0], data[0]) and \
        np.array_equal(v2[1], data[0])
    pts = json.loads((tmp_path / "out" / "output_0" / "points.json").read_text())
    assert pts[0]["fvd"] == got[0][0].fvd == float(np.abs(v1 - v2).mean()) > 0
    got = run(cfg, data, {0: coder}, pred, str(tmp_path / "none"), qualities=[0],
              thresholds=[THRESHOLDS[0]], lpips_metric=lp, with_fvd=False)
    assert np.isnan(got[0][0].fvd) and len(built) == 1


def test_run_sweep_with_fvd_matches_jax(pipelines, tmp_path, monkeypatch):
    """A 10-frame GOP (the I3D needs 9) at one threshold, JAX's noise handed
    to the port's point; FVD in the sweep's repeated-pair form."""
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    data = smooth_video(n=10)[None]
    i3d = _random_i3d(8)
    subs = _point_keys(jax.random.PRNGKey(jcfg.seed), 1)
    monkeypatch.setattr(driver, "rate_sweep", functools.partial(
        rate_sweep, noise=lambda k: jax_noise(subs[k], pred)))
    common = dict(qualities=[0], thresholds=[THRESHOLDS[0]])
    got = driver.run_sweep(cfg, data, {0: coder}, pred, str(tmp_path / "port"), lpips_metric=lp,
                           fvd_metric=FVDMetric(_np_sd_tensors(i3d), device="cpu"), **common)
    want = jdriver.run_sweep(jcfg, data, {0: jcoder}, jpred, str(tmp_path / "jax"),
                             lpips_metric=jlp, fvd_metric=_JaxFVD(_jax_i3d_params(i3d)),
                             **common)
    pts = json.loads((tmp_path / "port" / "output_0" / "points.json").read_text())
    jpts = json.loads((tmp_path / "jax" / "output_0" / "points.json").read_text())
    assert len(pts) == len(jpts) == 1 and pts[0]["d"] == jpts[0]["d"] == [1, 1] + [0] * 8
    assert pts[0]["bpp"] == jpts[0]["bpp"] and jpts[0]["fvd"] > 0
    assert abs(pts[0]["fvd"] - jpts[0]["fvd"]) <= 1e-4 * jpts[0]["fvd"]
    assert got[0][0].fvd == pts[0]["fvd"] and want[0][0].fvd == jpts[0]["fvd"]
    fvd_npy = np.load(tmp_path / "port" / "output_0" / "fvd_0.npy")
    np.testing.assert_allclose(fvd_npy, np.load(tmp_path / "jax" / "output_0" / "fvd_0.npy"),
                               rtol=1e-4, atol=0)
    assert fvd_npy[1, 0] == pts[0]["fvd"]


# ------------------------------------------------------------- the CLI


def _dataset(path, n_frames=T):
    """A (1, T, C, H, W) dataset in [0, 255], as the sweep reads it."""
    video = smooth_video(n=n_frames)
    np.save(path, np.round(video.transpose(0, 3, 1, 2)[None] * 255).astype(np.uint8))
    return str(path)


@pytest.mark.parametrize("args,where,text", [
    (["--fused-gop", "--batched", "2"], "out", "sequential-mode only"),
    (["--fused-gop", "--queue-dir", "q"], "out", "sequential-mode only"),
    (["--device-gop", "--batched", "2"], "out", "drop --batched"),
    ([], "err", "FVD I3D (--i3d-ckpt)"),
    (["--queue-dir", "q"], "err", "FVD I3D (--i3d-ckpt)"),
    (["--i3d-ckpt", "missing.pt"], "err", "no such checkpoint: missing.pt"),
    (["--no-fvd", "--queue-dir", "q", "--queue-stale-after", "60"], "err",
     "--allow-uncalibrated"),
    (["--no-fvd"], "err", "--allow-uncalibrated"),
])
def test_cli_sweep_guards(tmp_path, capsys, args, where, text):
    rc = cli.main(["sweep", "--data-npy", _dataset(tmp_path / "d.npy"), "--output-path",
                   str(tmp_path / "out"), "--device", "cpu", "--config-mod", *TINY_MODS, *args])
    assert rc == 2
    assert text in getattr(capsys.readouterr(), where)
    assert not (tmp_path / "out" / "config.yml").exists()


@pytest.mark.parametrize("mode", [[], ["--batched", "2"], ["--exact-streams"]])
def test_cli_sweep_stamps_provenance(tmp_path, mode):
    """The sweep's provenance; ``--exact-streams``, the old spelling of the
    default exact path, is accepted as a no-op, as by the JAX package."""
    out = tmp_path / "out"
    rc = cli.main(["sweep", "--data-npy", _dataset(tmp_path / "d.npy"), "--output-path",
                   str(out), "--device", "cpu", "--config-mod", *TINY_MODS, "--no-fvd",
                   "--qualities", "0", "--thresholds", "1e9", "--allow-uncalibrated", *mode])
    assert rc == 0
    cfg = yaml.safe_load((out / "config.yml").read_text())
    assert cfg["provenance"] == {"calibrated": False, "lpips_calibrated": False,
                                 "fvd_calibrated": True}
    assert cfg["codec"]["N"] == 16 and cfg["data"]["image_size"] == 64
    assert {"points.json", "psnr_0.npy", "lpips_0.npy", "fvd_0.npy"} <= \
        set(os.listdir(out / "output_0"))


def test_cli_codec_entropy_estimation(tmp_path, capsys):
    x = smooth_video(n=2, size=60)
    np.save(tmp_path / "x.npy", x)
    rc = cli.main(["codec", "--entropy-estimation", "--input-npy", str(tmp_path / "x.npy"),
                   "--output-npy", str(tmp_path / "y.npy"), "--device", "cpu",
                   "--config-mod", *TINY_MODS])
    assert rc == 0
    msg = capsys.readouterr().out
    model = cli.build_coder(load_config(None, TINY_MODS), "cpu").model
    xp = np.pad(x, ((0, 0), (0, 4), (0, 4), (0, 0)))
    with torch.no_grad():
        out = model.inference(torch.tensor(xp).permute(0, 3, 1, 2).contiguous())
    bits = -float(sum(torch.log2(out["likelihoods"][k]).sum() for k in ("y", "z")))
    want = torch.clamp(out["x_hat"], 0, 1).permute(0, 2, 3, 1).numpy()[:, :60, :60]
    assert np.load(tmp_path / "y.npy").tobytes() == np.ascontiguousarray(want).tobytes()
    assert f"bpp={bits / x[..., 0].size:.4f}" in msg and "[entropy-estimation]" in msg


def test_cli_gop_send_device_gop_is_received_byte_for_byte(tmp_path):
    np.save(tmp_path / "video.npy", smooth_video(n=T))
    common = ["--device", "cpu", "--config-mod", *TINY_MODS]
    send = _cli("gop", "send", "--device-gop", "--video-npy", str(tmp_path / "video.npy"),
                "--payload", str(tmp_path / "gop.tvcg"), "--threshold", str(MIXED_RHO),
                "--num-frames", str(T), "--allow-uncalibrated", "--output-npy",
                str(tmp_path / "sender.npy"), *common)
    assert send.returncode == 0, send.stderr[-3000:]
    recv = _cli("gop", "receive", "--payload", str(tmp_path / "gop.tvcg"), "--output-npy",
                str(tmp_path / "receiver.npy"), *common)
    assert recv.returncode == 0, recv.stderr[-3000:]
    a, b = np.load(tmp_path / "sender.npy"), np.load(tmp_path / "receiver.npy")
    assert a.shape == (T, 64, 64, 3) and a.tobytes() == b.tobytes()
    assert "[gop send]" in send.stdout
