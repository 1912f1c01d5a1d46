"""tvc_torch GOP loop and receiver against the JAX package's, on the tiny
pipeline (the UNet of tests/conftest.py, the tiny ELIC of
tests/test_torch_codec.py, random LPIPS(alex)) and a 10-frame 64x64 video.

The port draws each update's noise from a generator; for parity it takes the
noise JAX's key chain draws instead (split(key) per update, then split(sub)
into knoise/ksamp, then split(ksamp, n + 1)), so both packages see the same
noise. Tolerances: ``d``, ``accepts``, bits and containers exactly; frames
within 1e-4. The mid threshold sits between the JAX package's LPIPS scores,
more than 1e-3 of a score away from each (port and JAX scores agree to far
better than that), so both packages take the same decisions. The port's
receiver, in process and through the CLI in other processes, must rebuild
the port's sender byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_codec import jax_codec, random_elic
from test_torch_sender import _lpips_params, tiny_cfg
from tvc.core.config import Config as JConfig
from tvc.metrics.lpips import LPIPSMetric as JLPIPSMetric
from tvc.models.codec.coding import ELICCoder as JELICCoder
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.pipeline.predictor import FramePredictor as JFramePredictor
from tvc.pipeline.sender import Sender as JSender
from tvc.pipeline.sender import run_gop as j_run_gop
from tvc_torch import cli
from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPS, LPIPSMetric
from tvc_torch.models.codec.coding import ELICCoder
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.receiver import run_gop_receiver
from tvc_torch.pipeline.sender import Sender, run_gop, update_seed
from tvc_torch.utils.convert import lpips_from_jax, unet_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 10
# all accepted, all fallback, and between the JAX scores of this video (about
# 0.052-0.056): accepts [0, 1, 0, 2, 0], both paths
THRESHOLDS = [1e9, -1.0, 0.0535]
TINY_MODS = [
    "data.image_size=64", "data.num_frames=3", "data.num_frames_cond=2", "model.ngf=16",
    "model.ch_mult=(1,2)", "model.num_res_blocks=1", "model.attn_resolutions=(32,)",
    "model.n_head_channels=8", "model.num_classes=20", "sampling.subsample=5",
    "codec.N=16", "codec.M=24", "codec.groups=(4,4,4,4,8)",
]


def smooth_video(n=T, size=64, seed=7):
    """A seeded moving pattern with a little noise, (n, size, size, 3) in [0, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    freq, phase = rng.uniform(0.5, 2.0, (3, 2)), rng.uniform(0, 2 * np.pi, 3)
    video = np.stack([np.stack([0.5 + 0.35 * np.sin(2 * np.pi * (freq[c, 0] * xx + freq[c, 1] * yy)
                                                   + phase[c] + 0.15 * t) for c in range(3)], -1)
                      for t in range(n)])
    return np.clip(video + 0.02 * rng.randn(n, size, size, 3), 0, 1).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here use one intra-op thread: the models are tiny,
    and beside the suite's other worker processes a thread per core makes
    every small op wait at a barrier for threads the cores cannot run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline and the port's, on the same weights."""
    jcfg, cfg = tiny_cfg(JConfig), tiny_cfg(Config)
    size = cfg.data.image_size
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 9)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, size, size, 6)))
    rng = np.random.RandomState(42)
    variables = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.08).astype(np.float32), shapes)
    unet = UNetMoreDDPM(cfg, device="cpu")
    unet.load_state_dict(unet_from_jax(cfg, variables), strict=True)

    lp_params = _lpips_params(0)
    lp = LPIPS(device="cpu")
    lp.load_state_dict(lpips_from_jax(lp_params), strict=True)

    codec = random_elic(0)
    jmodel, jvars = jax_codec(codec)
    port = (cfg, FramePredictor(cfg, unet), ELICCoder(codec, "cpu"), LPIPSMetric(lp, False))
    jax_ = (jcfg, JFramePredictor(jcfg, variables), JELICCoder(jmodel, jvars),
            JLPIPSMetric(params=dict(lp_params), calibrated=False))
    return port, jax_


def jax_noise(key, predictor):
    """update i -> the (x_init, noise) that JAX's run_gop draws for update i."""
    cfg = predictor.cfg
    shape = (1, cfg.data.image_size, cfg.data.image_size, cfg.data.channels * cfg.data.num_frames)
    subs = []

    def source(i):
        nonlocal key
        while len(subs) <= i:
            key, sub = jax.random.split(key)
            subs.append(sub)
        knoise, ksamp = jax.random.split(subs[i])
        keys = jax.random.split(ksamp, len(predictor.sub) + 1)
        return (torch.tensor(np.asarray(jax.random.normal(knoise, shape, jnp.float32))),
                torch.tensor(np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                                       for k in keys])))

    return source


class _Scores:
    """Wraps a metric, recording every score it gives."""

    def __init__(self, metric):
        self.metric, self.scores = metric, []
        self.calibrated = False

    def __call__(self, a, b):
        s = self.metric(a, b)
        self.scores.append(np.asarray(s))
        return s


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_run_gop_matches_jax(pipelines, threshold):
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    video, key = smooth_video(), jax.random.PRNGKey(5)
    jscores = _Scores(jlp)
    want = j_run_gop(JSender(threshold, jcfg, jpred, jscores), jcoder, video, key,
                     num_frames_total=T, patch=64, keep_streams=True)
    margin = np.abs(np.concatenate(jscores.scores) - threshold).min()
    assert margin > 1e-3 * 0.056, "the threshold is too close to a JAX score to decide alike"

    got = run_gop(Sender(threshold, cfg, pred, lp), coder, video, seed=0, num_frames_total=T,
                  patch=64, keep_streams=True, noise=jax_noise(key, pred))
    np.testing.assert_array_equal(got.d, want.d)
    assert got.accepts == want.accepts and got.n_updates == want.n_updates
    assert got.bits == want.bits and got.bpp == want.bpp
    assert got.containers == want.containers
    assert got.x_ge.shape == want.x_ge.shape == (1, T, 64, 64, 3)
    np.testing.assert_allclose(got.x_ge, want.x_ge, atol=1e-4, rtol=0)
    if threshold == THRESHOLDS[2]:
        assert 0 in got.accepts and max(got.accepts) > 0


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_receiver_rebuilds_the_sender(pipelines, threshold):
    """The port's own generators, seeded per update; the receiver's frames
    are the sender's byte for byte (all accepted, all fallback, mixed)."""
    cfg, pred, coder, lp = pipelines[0]
    video = smooth_video()
    gop = run_gop(Sender(threshold, cfg, pred, lp), coder, video, seed=11, num_frames_total=T,
                  patch=64, keep_streams=True)
    assert len(gop.containers) == 1 + gop.accepts.count(0)
    assert gop.d.shape == (1, T) and int((gop.d == 0).sum()) == sum(gop.accepts)
    rec = run_gop_receiver(cfg, gop.accepts, gop.containers, coder, pred, seed=11,
                           num_frames_total=T)
    assert rec.dtype == gop.x_ge.dtype == np.float32
    assert rec.tobytes() == gop.x_ge[0].tobytes()


def test_gop_trims_to_num_frames_and_seeds_per_update(pipelines):
    """Frames past the GOP are never coded or scored; updates draw distinct noise."""
    cfg, pred, coder, lp = pipelines[0]
    video = smooth_video(n=14)
    long = run_gop(Sender(-1.0, cfg, pred, lp), coder, video, seed=3, num_frames_total=6,
                   keep_streams=True)
    short = run_gop(Sender(-1.0, cfg, pred, lp), coder, video[:6], seed=3, num_frames_total=6,
                    keep_streams=True)
    assert long.containers == short.containers and long.bits == short.bits
    assert len({update_seed(3, u) for u in range(100)}) == 100


def test_run_gop_refuses_the_simulation_path(pipelines):
    """The simulation coder's streams are not transmissible: with
    keep_streams run_gop refuses it; without, it codes the same bits."""
    cfg, pred, coder, lp = pipelines[0]
    sim = tiny_cfg(Config)
    sim.codec.exact_streams = False
    with pytest.raises(ValueError, match="exact_streams"):
        run_gop(Sender(-1.0, sim, pred, lp), coder, smooth_video(), seed=1, num_frames_total=4,
                keep_streams=True)
    got = run_gop(Sender(-1.0, sim, pred, lp), coder, smooth_video(), seed=1, num_frames_total=4)
    want = run_gop(Sender(-1.0, cfg, pred, lp), coder, smooth_video(), seed=1, num_frames_total=4)
    assert got.containers is None and got.d.tolist() == want.d.tolist()
    assert got.bits == want.bits
    np.testing.assert_allclose(got.x_ge, want.x_ge, atol=1e-2)


def test_receiver_refuses_a_short_payload(pipelines):
    cfg, pred, coder, lp = pipelines[0]
    gop = run_gop(Sender(-1.0, cfg, pred, lp), coder, smooth_video(), seed=1, num_frames_total=6,
                  keep_streams=True)
    with pytest.raises(ValueError, match="containers"):
        run_gop_receiver(cfg, gop.accepts, gop.containers[:-1], coder, pred, 1, 6)
    with pytest.raises(ValueError, match="left unused"):
        run_gop_receiver(cfg, gop.accepts + [0], gop.containers + gop.containers[:1], coder,
                         pred, 1, 6)


def _cli(*args, **kw):
    # one thread, as in this process: the payload's stamp records the count
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "tvc_torch.cli", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


@pytest.fixture(scope="module")
def cli_gop(tmp_path_factory):
    """``gop send`` in one process, ``gop receive`` in another, on the CPU."""
    d = tmp_path_factory.mktemp("cli_gop")
    np.save(d / "video.npy", smooth_video())
    common = ["--device", "cpu", "--config-mod", *TINY_MODS]
    send = _cli("gop", "send", "--video-npy", str(d / "video.npy"), "--payload",
                str(d / "gop.tvcg"), "--threshold", "0.05", "--num-frames", str(T),
                "--allow-uncalibrated", "--output-npy",
                str(d / "sender.npy"), *common)
    assert send.returncode == 0, send.stderr[-3000:]
    recv = _cli("gop", "receive", "--payload", str(d / "gop.tvcg"), "--output-npy",
                str(d / "receiver.npy"), *common)
    assert recv.returncode == 0, recv.stderr[-3000:]
    return d, common, send.stdout, recv.stdout


def test_cli_gop_is_byte_identical_across_processes(cli_gop):
    d, _, send_out, recv_out = cli_gop
    a, b = np.load(d / "sender.npy"), np.load(d / "receiver.npy")
    assert a.shape == (T, 64, 64, 3) and a.dtype == np.float32
    assert a.tobytes() == b.tobytes(), "the receiver's frames differ from the sender's"
    assert "[gop send]" in send_out and "[gop receive] reconstructed 10 frames" in recv_out


@pytest.mark.parametrize("field", ["torch", "attention_build", "cpu_threads", "model.version",
                                   "sampling.init_prev_t"])
def test_cli_receive_refuses_other_numerics(cli_gop, tmp_path, capsys, field):
    d, common, _, _ = cli_gop
    with np.load(d / "gop.tvcg") as z:
        payload = {k: z[k] for k in z.files}
    key = "numerics_" + field
    assert key in payload
    payload[key] = np.asarray(str(payload[key]) + "-other")
    path = tmp_path / "changed.tvcg"
    with open(path, "wb") as f:
        np.savez(f, **payload)
    assert cli.main(["gop", "receive", "--payload", str(path), *common]) == 2
    assert key in capsys.readouterr().err


def test_cli_ddim_payload_needs_a_ddim_receiver(tmp_path):
    """A GOP sent with model.version=DDIM is rebuilt byte for byte by a DDIM
    receiver in a fresh process; a receiver under DDPM exits 2 naming the field."""
    np.save(tmp_path / "video.npy", smooth_video())
    payload = str(tmp_path / "ddim.tvcg")
    ddim = ["--device", "cpu", "--config-mod", *TINY_MODS, "model.version=DDIM"]
    send = _cli("gop", "send", "--video-npy", str(tmp_path / "video.npy"), "--payload", payload,
                "--threshold", "0.05", "--num-frames", str(T), "--allow-uncalibrated",
                "--output-npy", str(tmp_path / "sender.npy"), *ddim)
    assert send.returncode == 0, send.stderr[-3000:]
    recv = _cli("gop", "receive", "--payload", payload, "--output-npy",
                str(tmp_path / "receiver.npy"), *ddim)
    assert recv.returncode == 0, recv.stderr[-3000:]
    a, b = np.load(tmp_path / "sender.npy"), np.load(tmp_path / "receiver.npy")
    assert a.shape == (T, 64, 64, 3) and a.tobytes() == b.tobytes()
    ddpm = _cli("gop", "receive", "--payload", payload, "--device", "cpu", "--config-mod",
                *TINY_MODS)
    assert ddpm.returncode == 2
    assert "numerics_model.version='DDIM'" in ddpm.stderr and "'DDPM'" in ddpm.stderr


def test_cli_receive_refuses_another_entropy_backend(cli_gop, capsys):
    d, common, _, _ = cli_gop
    rc = cli.main(["gop", "receive", "--payload", str(d / "gop.tvcg"), *common,
                   "--config-mod", "codec.entropy_backend=device"])
    assert rc == 2
    assert "numerics_entropy_backend" in capsys.readouterr().err


def test_cli_gop_send_needs_lpips_weights_or_opt_in(cli_gop, capsys):
    d, common, _, _ = cli_gop
    rc = cli.main(["gop", "send", "--video-npy", str(d / "video.npy"), "--payload",
                   str(d / "unused.tvcg"), *common])
    assert rc == 2 and not (d / "unused.tvcg").exists()


def test_cli_codec_roundtrip_across_processes(tmp_path):
    np.save(tmp_path / "in.npy", smooth_video(n=2))
    common = ["--device", "cpu", "--config-mod", *TINY_MODS, "codec.entropy_backend=device"]
    enc = _cli("codec", "--input-npy", str(tmp_path / "in.npy"), "--save-bitstream",
               str(tmp_path / "x.tvc"), "--output-npy", str(tmp_path / "sender.npy"), *common)
    assert enc.returncode == 0, enc.stderr[-3000:]
    dec = _cli("codec", "--from-bitstream", str(tmp_path / "x.tvc"), "--input-npy",
               str(tmp_path / "in.npy"), "--output-npy", str(tmp_path / "receiver.npy"), *common)
    assert dec.returncode == 0, dec.stderr[-3000:]
    assert (tmp_path / "x.tvc").read_bytes()[:4] == b"TVC2"
    a, b = np.load(tmp_path / "sender.npy"), np.load(tmp_path / "receiver.npy")
    assert a.shape == (2, 64, 64, 3) and a.tobytes() == b.tobytes()
