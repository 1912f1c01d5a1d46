"""tvc_torch's H.264/H.265 anchor harness, presets, colorspace and the
``anchors`` command against the JAX package's, on the CPU.

No ffmpeg binary is needed: either the module-level ``ffmpeg_encode``/
``ffmpeg_decode`` of both packages are replaced by one lossy stand-in codec
(quantise and deflate, as ``tests/test_anchor_presets.py`` does), or the
fake ``ffmpeg`` executable of ``tests/test_fake_ffmpeg.py`` goes on PATH.

Tolerances: colorspace transforms and chroma resampling equal bit for bit;
the anchors' PSNR and bpp rows equal; LPIPS rows within 1e-5 (the same
LPIPS(alex) weights in both); FVD rows within 1e-4 relative (the same I3D
weights, the sweep's repeated-pair form); preset arrays and text files equal.
"""

import os
import stat
import zlib

import numpy as np
import pytest
import torch

import tvc.bench.anchors as janchors
import tvc.bench.colorspace as jcs
from test_fake_ffmpeg import FAKE_FFMPEG
from test_torch_eval import _JaxFVD, _jax_i3d_params, _np_sd_tensors, _random_i3d
from test_torch_sender import _lpips_params
from tvc.bench import presets as jpresets
from tvc.metrics.lpips import LPIPSMetric as JLPIPSMetric
from tvc_torch import cli
from tvc_torch.bench import anchors, colorspace, presets
from tvc_torch.metrics.fvd import FVDMetric
from tvc_torch.metrics.lpips import LPIPS, LPIPSMetric
from tvc_torch.utils.convert import lpips_from_jax

RNG = np.random.RandomState(31)


def _enc(raw, mp4, codec, qp, w, h, framerate, pix_fmt):
    data = np.fromfile(raw, np.uint8)
    q = qp + 1
    with open(mp4, "wb") as f:
        f.write(np.uint16(q).tobytes() + zlib.compress((data // q).astype(np.uint8).tobytes(), 6))


def _dec(mp4, rec, pix_fmt):
    blob = open(mp4, "rb").read()
    q = int(np.frombuffer(blob[:2], np.uint16)[0])
    quant = np.frombuffer(zlib.decompress(blob[2:]), np.uint8)
    np.clip(quant.astype(np.int32) * q + q // 2, 0, 255).astype(np.uint8).tofile(rec)


@pytest.fixture
def stub_codec(monkeypatch):
    """One lossy stand-in codec for both packages' ffmpeg seams."""
    for mod in (anchors, janchors):
        monkeypatch.setattr(mod, "ffmpeg_encode", _enc)
        monkeypatch.setattr(mod, "ffmpeg_decode", _dec)


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "ffmpeg"
    exe.write_text(FAKE_FFMPEG)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    log = tmp_path / "ffmpeg_argv.jsonl"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_FFMPEG_LOG", str(log))
    return log


# ------------------------------------------------------------------ colorspace


@pytest.mark.parametrize("hw", [(32, 48), (64, 64), (48, 32)])
def test_colorspace_matches_jax(hw):
    rgb = RNG.rand(*hw, 3)
    ycc = colorspace.rgb2ycbcr(rgb)
    np.testing.assert_array_equal(ycc, jcs.rgb2ycbcr(rgb))
    np.testing.assert_array_equal(colorspace.ycbcr2rgb(ycc), jcs.ycbcr2rgb(ycc))
    np.testing.assert_allclose(colorspace.ycbcr2rgb(ycc), rgb, atol=1e-12)  # the round trip
    planes = colorspace.yuv_444_to_420(ycc[..., 0], ycc[..., 1], ycc[..., 2])
    for got, want in zip(planes, jcs.yuv_444_to_420(ycc[..., 0], ycc[..., 1], ycc[..., 2])):
        np.testing.assert_array_equal(got, want)
    for mode in ("bicubic", "bilinear", "nearest"):
        got = colorspace.yuv_420_to_444(*planes, mode=mode)
        want = jcs.yuv_420_to_444(*planes, mode=mode)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=mode)
    # 4:2:0 loses chroma detail only: the luma survives the round trip exactly
    back = colorspace.yuv_420_to_444(*planes)
    np.testing.assert_array_equal(back[..., 0], ycc[..., 0].astype(np.float32))


# ------------------------------------------------------------------ the harness


@pytest.fixture(scope="module")
def metric_pairs():
    """LPIPS(alex) and FVD of both packages on the same weights."""
    params = _lpips_params(3)
    model = LPIPS(device="cpu")
    model.load_state_dict(lpips_from_jax(params), strict=True)
    port_i3d = _random_i3d(5)
    return ((LPIPSMetric(model, False), FVDMetric(_np_sd_tensors(port_i3d), device="cpu")),
            (JLPIPSMetric(params=dict(params), calibrated=False),
             _JaxFVD(_jax_i3d_params(port_i3d))))


def test_compress_and_evaluate_matches_jax(stub_codec, metric_pairs, tmp_path):
    (lp, fvd), (jlp, jfvd) = metric_pairs
    video = RNG.rand(10, 32, 32, 3).astype(np.float32)
    got = anchors.compress_and_evaluate(video, str(tmp_path / "port"), qp_range=[4, 40],
                                        lpips_metric=lp, fvd_metric=fvd, require_ffmpeg=False)
    want = janchors.compress_and_evaluate(video, str(tmp_path / "jax"), qp_range=[4, 40],
                                          lpips_metric=jlp, fvd_metric=jfvd,
                                          require_ffmpeg=False)
    assert got.shape == want.shape == (4, 2)
    np.testing.assert_array_equal(got[0], want[0])  # PSNR
    np.testing.assert_array_equal(got[3], want[3])  # bpp
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=0)
    assert got[0, 0] > got[0, 1] and got[3, 0] > got[3, 1] and np.all(got[2] > 0)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("name", ["city", "smm"])
def test_run_preset_matches_jax(stub_codec, name, tmp_path):
    import dataclasses

    preset = dataclasses.replace(presets.PRESETS[name], num_frames=4)
    jpreset = dataclasses.replace(jpresets.PRESETS[name], num_frames=4)
    assert dataclasses.asdict(preset) == dataclasses.asdict(jpreset)
    videos = RNG.rand(2, 5, preset.height, preset.width, 3).astype(np.float32)
    got = presets.run_preset(preset, videos, str(tmp_path / "pw"), str(tmp_path / "port"),
                             qp_range=[10, 30], require_ffmpeg=False)
    want = jpresets.run_preset(jpreset, videos, str(tmp_path / "jw"), str(tmp_path / "jax"),
                               qp_range=[10, 30], require_ffmpeg=False)
    assert sorted(got) == sorted(want)
    for codec in want:
        np.testing.assert_array_equal(got[codec], want[codec])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    with pytest.raises(ValueError, match=f"{preset.height}x{preset.width}"):
        presets.run_preset(preset, videos[:, :, :16], str(tmp_path / "w"), str(tmp_path / "o"),
                           qp_range=[30], require_ffmpeg=False)


def test_average_curves_match_jax():
    bpps = [np.sort(RNG.uniform(0.01, 0.9, 6)) for _ in range(3)]
    metrics = [30 + 10 * b + RNG.randn(6) for b in bpps]
    for got, want in zip(presets.average_curves(bpps, metrics),
                         jpresets.average_curves(bpps, metrics)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "gray"])
def test_ffmpeg_command_lines_match_jax(fake_ffmpeg, tmp_path, pix_fmt):
    """Through real subprocesses: the same ffmpeg argv (paths aside) and the
    same array as the JAX package's harness."""
    import json

    video = RNG.rand(3, 32, 48, 3).astype(np.float32)
    got = anchors.compress_and_evaluate(video, str(tmp_path / "w"), codec="libx265",
                                        qp_range=[20, 40], pix_fmt=pix_fmt)
    port_calls = [json.loads(line) for line in open(fake_ffmpeg) if line.strip()]
    open(fake_ffmpeg, "w").close()
    want = janchors.compress_and_evaluate(video, str(tmp_path / "w"), codec="libx265",
                                          qp_range=[20, 40], pix_fmt=pix_fmt)
    jax_calls = [json.loads(line) for line in open(fake_ffmpeg) if line.strip()]
    assert port_calls == jax_calls and len(port_calls) == 4
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ the command


def _dataset(path, n_videos=1, frames=30, size=64):
    np.save(path, (RNG.rand(n_videos, frames, 3, size, size) * 255).astype(np.uint8))
    return str(path)


def test_cli_anchors_exits_2_without_ffmpeg(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(anchors, "have_ffmpeg", lambda: False)
    rc = cli.main(["anchors", "--data-npy", _dataset(tmp_path / "d.npy", frames=2),
                   "--output", str(tmp_path / "a.npy"), "--device", "cpu"])
    assert rc == 2 and "ffmpeg not available" in capsys.readouterr().err
    assert not (tmp_path / "a.npy").exists()


def test_cli_anchors_preset_matches_jax(fake_ffmpeg, tmp_path):
    data = _dataset(tmp_path / "d.npy", n_videos=2)
    rc = cli.main(["anchors", "--data-npy", data, "--output", str(tmp_path / "out"),
                   "--preset", "smm", "--qp-min", "30", "--qp-max", "31", "--device", "cpu",
                   "--no-metrics"])
    assert rc == 0
    from tvc.pipeline.driver import load_dataset as j_load_dataset

    want = jpresets.run_preset(jpresets.PRESETS["smm"], j_load_dataset(data),
                               str(tmp_path / "jw"), str(tmp_path / "jax"), qp_range=range(30, 32))
    got = np.load(tmp_path / "out" / "bench_smm_265.npy")
    np.testing.assert_array_equal(got, want["libx265"])
    assert got.shape == (2, 4, 2) and np.all(np.isnan(got[:, 1:3]))  # --no-metrics


def test_cli_anchors_metrics(fake_ffmpeg, tmp_path, capsys):
    data = _dataset(tmp_path / "d.npy", frames=10, size=32)
    args = ["anchors", "--data-npy", data, "--output", str(tmp_path / "a.npy"), "--qp-min", "20",
            "--qp-max", "20", "--device", "cpu"]
    assert cli.main(args) == 2  # random LPIPS and I3D weights need --allow-uncalibrated
    assert "FVD I3D (--i3d-ckpt)" in capsys.readouterr().err
    i3d = tmp_path / "i3d.pt"
    torch.save(_random_i3d(6).state_dict(), i3d)
    assert cli.main(args + ["--allow-uncalibrated", "--i3d-ckpt", str(i3d)]) == 0
    arr = np.load(tmp_path / "a.npy")[0, :, 0]
    # the fake codec is lossless: infinite PSNR, and zero LPIPS and FVD
    assert np.isposinf(arr[0]) and arr[1] == 0.0 and abs(arr[2]) <= 1e-9 and arr[3] > 0
    assert "UNCALIBRATED (LPIPS (--lpips-alex/--lpips-lin))" in capsys.readouterr().out
