"""tvc_torch's dataset tools and validation harness against the JAX
package's, on the CPU.

Tolerances: ``center_crop_resize`` within one 8-bit code value of the JAX
package's (PIL's LANCZOS; the port writes PIL's fixed-point resampling out
in numpy, so it is exact here, and one code allows a libm that rounds a sine
otherwise); PNG files round trip byte for byte and read the same in PIL and
in the port; ``collate_metric_txt`` and ``build_dataset_npy`` equal. The
harness: every check skips without artifacts with the JAX package's
statuses, ``report`` gives its exit codes and JSON summary, and on synthetic
artifacts written here (a tiny-config diffusion checkpoint in the
reference's list layout, seeded ELIC checkpoints, a seeded torchvision-layout
AlexNet and LPIPS heads) each check gives the JAX package's status on the
same files.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tvc.utils import dataset as jds
from tvc.utils import validate as JV
from tvc_torch import cli
from tvc_torch.utils import dataset as ds
from tvc_torch.utils import validate as V


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,size", [((100, 140), 64), ((50, 37), 128), ((256, 300), 128),
                                        ((97, 130), 33), ((64, 64), 64)],
                         ids=["down", "up", "down2", "odd", "same"])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_center_crop_resize_matches_pil(shape, size, kind):
    rng = np.random.RandomState(sum(shape) + size)
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    if kind == "float":
        img = img.astype(np.float32) / 255.0
    got, want = ds.center_crop_resize(img, size), jds.center_crop_resize(img, size)
    assert got.shape == want.shape == (size, size, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_lanczos_resize_of_a_rectangle_matches_pil():
    img = np.random.RandomState(1).randint(0, 256, (61, 90, 3)).astype(np.uint8)
    for h, w in ((40, 77), (122, 45), (61, 30)):
        want = np.asarray(Image.fromarray(img).resize((w, h), Image.LANCZOS))
        assert np.abs(ds.lanczos_resize(img, h, w).astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_read_matches_pil(tmp_path, mode):
    img = np.random.RandomState(2).randint(0, 256, (23, 31, 3)).astype(np.uint8)
    for i, opts in enumerate(({}, {"optimize": True}, {"compress_level": 0})):
        path = tmp_path / f"{mode}{i}.png"
        Image.fromarray(img).convert(mode).save(path, **opts)  # PIL picks the row filters
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(ds.read_png(str(path)), want)


def test_png_round_trip_and_pil_reads_the_port(tmp_path):
    video = np.random.RandomState(3).rand(3, 17, 29, 3).astype(np.float32)
    paths = ds.video_to_pngs(video, str(tmp_path / "port"))
    jpaths = jds.video_to_pngs(video, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p in paths:
        frame = ds.read_png(p)
        np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), frame)
        ds.write_png(str(tmp_path / "again.png"), frame)
        np.testing.assert_array_equal(ds.read_png(str(tmp_path / "again.png")), frame)
    got, want = ds.pngs_to_video(paths), jds.pngs_to_video(jpaths)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_build_dataset_npy_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    dirs = []
    for v in range(2):
        d = tmp_path / f"video{v}"
        jds.video_to_pngs(rng.rand(4, 40, 52, 3).astype(np.float32), str(d))
        dirs.append(str(d))
    got = ds.build_dataset_npy(dirs, str(tmp_path / "port.npy"), size=32, num_frames=3)
    want = jds.build_dataset_npy(dirs, str(tmp_path / "jax.npy"), size=32, num_frames=3)
    assert got.shape == (2, 3, 3, 32, 32) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))


def test_collate_metric_txt_matches_jax(tmp_path):
    paths = []
    for v in range(2):
        p = tmp_path / f"m{v}.txt"
        p.write_text("\n".join(f"QP {q} PSNR: {30 - q * 0.1 + v} LPIPS: [{0.1 + q / 100}] "
                               f"FVD: {200 + q} BPP: {1.0 / (q + 1):.6e}" for q in range(5))
                     + "\nnoise line\n")
        paths.append(str(p))
    got, want = ds.collate_metric_txt(paths), jds.collate_metric_txt(paths)
    assert got.shape == (2, 4, 5)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- validate


def _statuses(results):
    return [(r["name"], r["status"]) for r in results]


def test_every_check_skips_without_artifacts(capsys):
    got = V.run_validation(device="cpu")
    assert _statuses(got) == _statuses(JV.run_validation())
    assert {r["status"] for r in got} == {"skip"}
    assert [r["detail"] for r in got] == [r["detail"] for r in JV.run_validation()]
    assert V.report(got) == 0
    assert cli.main(["validate", "--device", "cpu"]) == 0
    assert "0 pass / 0 fail / 6 skip" in capsys.readouterr().out


def test_report_exit_codes_and_json_match_jax(tmp_path):
    results = [V._result("a", "pass", "ok", x=np.float32(1.5)), V._result("b", "skip", "none")]
    for mod, name in ((V, "port"), (JV, "jax")):
        assert mod.report(results, str(tmp_path / f"{name}.json")) == 0
        assert mod.report(results + [mod._result("c", "fail", "boom")]) == 1
    port = json.loads((tmp_path / "port.json").read_text())
    jax_ = json.loads((tmp_path / "jax.json").read_text())
    port["summary"].pop("timestamp"), jax_["summary"].pop("timestamp")
    assert port == jax_ and port["summary"] == {"pass": 1, "fail": 0, "skip": 1}


def test_guard_and_judges_match_jax():
    @V._guard("x")
    def boom():
        raise RuntimeError("kaput")

    r = boom()
    assert r["status"] == "fail" and "kaput" in r["detail"]
    for args in ((0.06, 23.7, 0.12), (1.3, 30.0, 0.05), (0.06, 18.0, 0.12), (0.06, 23.7, 0.2)):
        assert V.judge_rd_point(*args) == JV.judge_rd_point(*args)
    for bpps in ([0.1, 0.2, 0.3], [0.10, 0.09, 0.12], [2.0, 0.1, 0.2], [0.3]):
        assert V.judge_bpp_monotone(bpps) == JV.judge_bpp_monotone(bpps)


def _tiny_cfgs():
    from tvc.core.config import Config as JConfig
    from tvc_torch.core.config import Config

    out = []
    for cls in (Config, JConfig):
        cfg = cls()
        cfg.data.image_size = 16
        cfg.data.num_frames = 2
        cfg.data.num_frames_cond = 1
        cfg.model.ngf = 16
        cfg.model.ch_mult = (1, 2)
        cfg.model.num_res_blocks = 1
        cfg.model.attn_resolutions = (8,)
        cfg.model.n_head_channels = 8
        cfg.model.num_classes = 10
        cfg.sampling.subsample = 3
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Synthetic reference artifacts: a tiny diffusion checkpoint in the
    reference's list layout ([0] the DataParallel state dict, [-1] the EMA
    shadow), two seeded ELIC checkpoints, a torchvision-layout AlexNet and
    LPIPS heads."""
    from tvc_torch.models.codec.elic import make_elic
    from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM

    d = tmp_path_factory.mktemp("artifacts")
    cfg, _ = _tiny_cfgs()
    g = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(v.shape, generator=g) * 0.08
          for k, v in UNetMoreDDPM(cfg, device="cpu").state_dict().items()}
    ema = {k: torch.randn(v.shape, generator=g) * 0.08 for k, v in sd.items()}
    torch.save([{"module." + k: v for k, v in sd.items()}, {"step": 1}, ema],
               d / "checkpoint.pt")
    cfg.codec.N, cfg.codec.M, cfg.codec.groups = 16, 24, (4, 4, 4, 4, 8)
    codecs = []
    for q in range(2):
        path = d / f"{q}.pth.tar"
        torch.save(make_elic(cfg.codec, seed=q, device="cpu").state_dict(), path)
        codecs.append(str(path))
    convs = {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3), 8: (256, 384, 3),
             10: (256, 256, 3)}
    alex = {}
    for i, (o, c, k) in convs.items():
        alex[f"features.{i}.weight"] = torch.randn(o, c, k, k, generator=g) * (c * k * k) ** -0.5
        alex[f"features.{i}.bias"] = torch.randn(o, generator=g) * 0.01
    torch.save(alex, d / "alexnet.pth")
    lin = {f"lin{k}.model.1.weight": torch.rand(1, c, 1, 1, generator=g) * 0.1
           for k, c in enumerate((64, 192, 384, 256, 256))}
    torch.save(lin, d / "alex_lin.pth")
    return d, codecs


def test_checks_on_synthetic_artifacts_match_jax(artifacts):
    from tvc.core.config import CodecConfig as JCodecConfig
    from tvc_torch.core.config import CodecConfig

    d, codecs = artifacts
    cfg, jcfg = _tiny_cfgs()
    ckpt = str(d / "checkpoint.pt")
    pairs = [
        (V.check_diffusion_ckpt(ckpt, cfg=cfg, device="cpu"),
         JV.check_diffusion_ckpt(ckpt, cfg=jcfg)),
        (V.check_codec_ckpts(codecs, codec_cfg=CodecConfig(N=16, M=24, groups=(4, 4, 4, 4, 8)),
                             device="cpu"),
         JV.check_codec_ckpts(codecs, codec_cfg=JCodecConfig(N=16, M=24,
                                                             groups=(4, 4, 4, 4, 8)))),
        (V.check_lpips(str(d / "alexnet.pth"), str(d / "alex_lin.pth"), device="cpu"),
         JV.check_lpips(str(d / "alexnet.pth"), str(d / "alex_lin.pth"))),
        (V.check_lpips(None, str(d / "alex_lin.pth"), net_type="squeeze", device="cpu"),
         JV.check_lpips(None, str(d / "alex_lin.pth"), net_type="squeeze")),
    ]
    for got, want in pairs:
        assert (got["name"], got["status"]) == (want["name"], want["status"]), got["detail"]
    diffusion, codec, lpips, squeeze = (p[0] for p in pairs)
    assert diffusion["status"] == codec["status"] == lpips["status"] == "pass"
    assert squeeze["status"] == "fail"  # a 5-head file is not SqueezeNet's 7 heads
    assert diffusion["metrics"]["n_params"] == pairs[0][1]["metrics"]["n_params"]
    assert "byte-identical" in codec["detail"] and codec["metrics"]["q0_bpp"] > 0
    assert lpips["metrics"]["netlin_max_rel"] < 1e-4 and lpips["metrics"]["lin_heads"] == 5


def test_bf16_check_without_calibrated_lpips_is_informational(artifacts):
    cfg, _ = _tiny_cfgs()
    r = V.check_bf16_drift(str(artifacts[0] / "checkpoint.pt"), cfg=cfg, device="cpu")
    assert r["status"] == "skip" and "informational" in r["detail"]
    assert np.isfinite(r["metrics"]["endpoint_mean_abs_drift"])


def test_cli_validate_reports_a_failure(artifacts, tmp_path):
    """The CLI checks the flagship's codec widths: checkpoints of another
    width fail at load, in both packages; the CLI exits 1 and writes the
    JSON report."""
    out = tmp_path / "r.json"
    rc = cli.main(["validate", "--device", "cpu", "--codec-ckpts", *artifacts[1],
                   "--no-bf16", "--no-rd", "--report", str(out)])
    assert rc == 1
    blob = json.loads(out.read_text())
    assert [r["status"] for r in blob["results"]] == ["skip", "skip", "fail", "skip"]
    assert JV.report(JV.run_validation(codec_ckpts=artifacts[1], with_bf16=False,
                                       with_rd=False)) == 1
