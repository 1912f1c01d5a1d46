"""tvc_torch serving paths against the JAX package's, on the tiny pipeline of
tests/test_torch_gop.py (the UNet of tests/conftest.py, the tiny ELIC of
tests/test_torch_codec.py, random LPIPS(alex), 64x64 frames).

Tolerances:
- the factorized likelihoods and ``ELICModel.inference``/``forward``/
  ``compress_forward``: symbols equal, likelihoods and entropy parameters
  within 1e-5 relative (of their largest value; y's likelihoods within 1e-4,
  their bits within 1e-5), ``x_hat`` within 1e-4;
- ``compress(exact=False)``: streams equal to JAX's simulation coder's for
  the same pair, and as many bytes as the exact coder (the JAX package's own
  rate-exactness check, with its 1e-2 on the reconstruction);
- ``DeviceGOPRunner`` against the port's ``run_gop`` with the same seed:
  ``d``, accepts, bits, containers and frames byte-identical, with float and
  uint8 input and with forced accepts;
- ``DeviceGOPRunner``, ``BatchedGOPRunner`` and ``FusedGOPSender`` against
  the JAX package's with JAX's noise handed in: decisions, accepts and stats
  equal, rANS bits equal, likelihood bits within 1e-4 relative, frames within
  1e-4.

The thresholds come from tests/test_torch_gop.py: all accepted, all fallback,
and one between the JAX package's LPIPS scores of this video.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_codec import assert_close, frames, nhwc
from test_torch_gop import (  # noqa: F401  (module-scoped fixtures)
    THRESHOLDS,
    jax_noise,
    one_torch_thread,
    pipelines,
    smooth_video,
)
from tvc.metrics.pixel import psnr_jax
from tvc.models.codec.coding import num_coded_bytes
from tvc.models.codec.elic import ELICModel as JELICModel
from tvc.ops.quantize import ste_round as j_ste_round
from tvc.pipeline.batched import BatchedGOPRunner as JBatchedGOPRunner
from tvc.pipeline.batched import GOPJob as JGOPJob
from tvc.pipeline.fused_gop import FusedGOPSender as JFusedGOPSender
from tvc.pipeline.sender import DeviceGOPRunner as JDeviceGOPRunner
from tvc_torch.metrics.pixel import psnr_torch
from tvc_torch.ops.quantize import ste_round
from tvc_torch.pipeline.batched import BatchedGOPRunner, GOPJob
from tvc_torch.pipeline.fused_gop import FusedGOPSender
from tvc_torch.pipeline.keyframe import code_frames, code_frames_device
from tvc_torch.pipeline.sender import DeviceGOPRunner, Sender, run_gop

T = 8
FUSED_T = 6
MIXED = THRESHOLDS[2]


def _port_x(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def _jax_eb(jmodel, variables, z, training=False, rng=None):
    return jmodel.apply(variables, z, training, rng,
                        method=lambda m, z, t, r: m.entropy_bottleneck(z, training=t, rng=r))


# ------------------------------------------------------------- codec pieces


def test_factorized_likelihood_matches_jax(pipelines):
    coder = pipelines[0][2]
    jcoder = pipelines[1][2]
    z = np.random.RandomState(3).randn(2, 2, 3, 16).astype(np.float32) * 6
    want_hat, want_lk = _jax_eb(jcoder.model, jcoder.variables, jnp.asarray(z))
    with torch.no_grad():
        got_hat, got_lk = coder.model.entropy_bottleneck(_port_x(z))
    np.testing.assert_array_equal(nhwc(got_hat), np.asarray(want_hat))
    assert_close(nhwc(got_lk), want_lk)
    assert float(got_lk.min()) >= float(np.float32(1e-9))
    # training: z plus U(-0.5, 0.5) noise, likelihoods of the noisy values
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        noisy, lk = coder.model.entropy_bottleneck(_port_x(z), training=True, generator=g)
    delta = nhwc(noisy) - z
    assert np.abs(delta).max() <= 0.5 and np.abs(delta).std() > 0.1
    _, want = _jax_eb(jcoder.model, jcoder.variables, jnp.asarray(nhwc(noisy)))
    np.testing.assert_allclose(nhwc(lk).max(), np.asarray(want).max(), rtol=1e-2)


def test_ste_round_is_round_with_identity_gradient():
    x = torch.tensor(np.random.RandomState(0).randn(64).astype(np.float32) * 3,
                     requires_grad=True)
    y = ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(j_ste_round(x.detach().numpy())))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(64, np.float32))


@pytest.mark.parametrize("method", ["inference", "forward", "compress_forward"])
def test_elic_fused_forwards_match_jax(pipelines, method):
    coder, jcoder = pipelines[0][2], pipelines[1][2]
    x = frames(2, 12)
    xj = jnp.asarray(x)
    with torch.no_grad():
        if method == "compress_forward":
            got = coder.model.compress_forward(_port_x(x), return_recon=True)
        else:
            got = getattr(coder.model, method)(_port_x(x))
    if method == "compress_forward":
        want = jcoder.model.apply(jcoder.variables, xj, True, method=JELICModel.compress_forward)
        np.testing.assert_array_equal(nhwc(got["z_sym"]), np.asarray(want["z_sym"]))
        M = coder.model.M
        for k in ("pa", "pn"):
            assert_close(nhwc(got[k]), want[k])
        # the y symbols of each phase: round(y - mu)
        y, pa, pn = (nhwc(got[k]) for k in ("y_packed", "pa", "pn"))
        wy, wpa, wpn = (np.asarray(want[k]) for k in ("y_packed", "pa", "pn"))
        np.testing.assert_array_equal(np.round(y[..., :M] - pa[..., :M]),
                                      np.round(wy[..., :M] - wpa[..., :M]))
        np.testing.assert_array_equal(np.round(y[..., M:] - pn[..., :M]),
                                      np.round(wy[..., M:] - wpn[..., :M]))
        np.testing.assert_allclose(nhwc(got["x_hat"]), np.asarray(want["x_hat"]), atol=1e-4)
        return
    jm = JELICModel.inference if method == "inference" else JELICModel.__call__
    want = jcoder.model.apply(jcoder.variables, xj, method=jm)
    lk, wlk = got["likelihoods"], want["likelihoods"]
    assert_close(nhwc(lk["z"]), wlk["z"])
    # y's likelihoods depend on the entropy parameters through the Gaussian's
    # slope (up to 1/(0.11 sqrt(2 pi)) per unit of mean), which turns their
    # 1e-5 agreement into up to about 2e-5 here; the bits agree to 1e-5
    assert_close(nhwc(lk["y"]), wlk["y"], rel=1e-4)
    bits = -sum(float(torch.log2(lk[k].double()).sum()) for k in ("y", "z"))
    wbits = -sum(float(np.log2(np.asarray(wlk[k], np.float64)).sum()) for k in ("y", "z"))
    assert abs(bits - wbits) <= 1e-5 * abs(wbits)
    np.testing.assert_allclose(nhwc(got["x_hat"]), np.asarray(want["x_hat"]), atol=1e-4)


def test_elic_forward_with_noise_quantization(pipelines):
    model = pipelines[0][2].model
    x = _port_x(frames(1, 13))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        a = model(x, noisequant=True, generator=g)
        b = model(x)
    assert a["x_hat"].shape == b["x_hat"].shape == x.shape
    assert not torch.equal(a["likelihoods"]["y"], b["likelihoods"]["y"])
    assert all(torch.isfinite(t).all() for t in (a["x_hat"], *a["likelihoods"].values()))
    with pytest.raises(ValueError, match="generator"):
        model(x, noisequant=True)


def test_simulation_compress_matches_jax(pipelines):
    coder, jcoder = pipelines[0][2], pipelines[1][2]
    x = frames(2, 14)
    got = coder.compress(x, return_recon=True, exact=False)
    want = jcoder.compress(x, return_recon=True, exact=False)
    assert got["strings"] == want["strings"]
    assert got["shape"] == tuple(want["shape"])
    np.testing.assert_allclose(got["x_hat"], want["x_hat"], atol=1e-4)
    exact = coder.compress(x, return_recon=True)
    assert num_coded_bytes(got["strings"]) == num_coded_bytes(exact["strings"])
    np.testing.assert_allclose(got["x_hat"], exact["x_hat"], atol=1e-2)


def test_code_frames_device_keeps_the_reconstruction_on_the_device(pipelines):
    coder = pipelines[0][2]
    x = frames(2, 15, size=60)  # padded to 64 and cut back
    want, bits = code_frames(coder, x, 64)
    got, got_bits, enc = code_frames_device(coder, x, 64, return_enc=True)
    assert torch.is_tensor(got) and got.shape == (2, 60, 60, 3)
    assert got.numpy().tobytes() == np.ascontiguousarray(want).tobytes() and got_bits == bits
    sim, sim_bits = code_frames(coder, x, 64, exact=False)
    assert sum(sim_bits) == sum(bits) and sim.shape == want.shape


def test_psnr_torch_matches_jax():
    rng = np.random.RandomState(4)
    a, b = rng.rand(3, 8, 8, 3).astype(np.float32), rng.rand(3, 8, 8, 3).astype(np.float32)
    got = psnr_torch(torch.tensor(a), torch.tensor(b), dim=(1, 2, 3)).numpy()
    np.testing.assert_allclose(got, np.asarray(psnr_jax(a, b, axis=(1, 2, 3))), rtol=1e-6)
    assert float(psnr_torch(torch.tensor(a), torch.tensor(b))) == pytest.approx(
        float(psnr_jax(a, b)), rel=1e-6)


# ------------------------------------------------------------- DeviceGOPRunner


class _ForcedSender(Sender):
    """``run_gop``'s sender with each update's accepted count forced."""

    def __init__(self, forced, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.forced, self.u = list(forced), 0

    def decide(self, pred, gt):
        n = min(self.forced[self.u], pred.shape[1])
        self.u += 1
        return np.zeros((1, n), np.int64), pred[:, :n]


def _assert_same_gop(got, want):
    assert got.d.tolist() == want.d.tolist() and got.accepts == want.accepts
    assert got.bits == want.bits and got.bpp == want.bpp and got.n_updates == want.n_updates
    assert got.containers == want.containers
    assert got.x_ge.dtype == want.x_ge.dtype == np.float32
    assert got.x_ge.tobytes() == want.x_ge.tobytes()


@pytest.mark.parametrize("case", ["all", "none", "mixed", "uint8", "forced"])
def test_device_runner_is_run_gop_byte_for_byte(pipelines, case):
    cfg, pred, coder, lp = pipelines[0]
    video = smooth_video(n=T + 2)
    threshold = {"all": THRESHOLDS[0], "none": THRESHOLDS[1]}.get(case, MIXED)
    forced = [0, 3, 9] if case == "forced" else None  # 9: clamped to the frame left
    if case == "uint8":
        video = np.round(video * 255).astype(np.uint8)
    host_video = video.astype(np.float32) / 255.0 if case == "uint8" else video
    sender = (_ForcedSender(forced, threshold, cfg, pred, lp) if forced
              else Sender(threshold, cfg, pred, lp))
    runner = DeviceGOPRunner(cfg, pred, lpips=lp, num_frames_total=T)
    want = run_gop(sender, coder, host_video, seed=21, num_frames_total=T, keep_streams=True)
    timings = {}
    got = runner.run(coder, video, 21, threshold, forced_accepts=forced, timings=timings,
                     keep_streams=True)
    _assert_same_gop(got, want)
    assert len(timings["cycle_fetch"]) == got.n_updates == len(got.update_s)
    assert len(timings["keyframes"]) == len(got.containers) == 1 + got.accepts.count(0)
    if case == "forced":
        assert got.accepts == [0, 3, 1]
    if case == "mixed":
        assert 0 in got.accepts and max(got.accepts) > 0


def test_device_runner_psnr_mode_decides_in_float32(pipelines):
    """The PSNR rule scores with psnr_torch; far from the threshold it takes
    run_gop's decisions."""
    cfg, pred, coder, lp = pipelines[0]
    video = smooth_video(n=T)
    for threshold in (-100.0, 100.0):
        want = run_gop(Sender(threshold, cfg, pred, lp, use_psnr=True), coder, video, seed=4,
                       num_frames_total=T)
        got = DeviceGOPRunner(cfg, pred, lpips=None, use_psnr=True, num_frames_total=T).run(
            coder, video, 4, threshold)
        assert got.accepts == want.accepts and got.x_ge.tobytes() == want.x_ge.tobytes()


def test_device_runner_refuses_simulated_streams(pipelines):
    cfg, pred, coder, lp = pipelines[0]
    sim = type(cfg)(**{**cfg.__dict__})
    sim.codec = type(cfg.codec)(**{**cfg.codec.__dict__, "exact_streams": False})
    runner = DeviceGOPRunner(sim, pred, lpips=lp, num_frames_total=4)
    with pytest.raises(ValueError, match="exact_streams"):
        runner.run(coder, smooth_video(n=4), 0, 1e9, keep_streams=True)
    # without streams the simulation coder runs
    got = runner.run(coder, smooth_video(n=4), 0, 1e9)
    assert got.containers is None and got.bits > 0


@pytest.mark.parametrize("mode", ["lpips", "psnr"])
def test_device_runner_matches_jax(pipelines, mode):
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    video, key = smooth_video(n=T), jax.random.PRNGKey(8)
    use_psnr = mode == "psnr"
    threshold = 9.0 if use_psnr else MIXED
    want = JDeviceGOPRunner(jcfg, jpred, lpips=jlp, use_psnr=use_psnr,
                            num_frames_total=T).run(jcoder, video, key, threshold,
                                                    keep_streams=True)
    got = DeviceGOPRunner(cfg, pred, lpips=lp, use_psnr=use_psnr, num_frames_total=T).run(
        coder, video, 0, threshold, keep_streams=True, noise=jax_noise(key, pred))
    np.testing.assert_array_equal(got.d, want.d)
    assert got.accepts == want.accepts and got.bits == want.bits
    assert got.containers == want.containers
    np.testing.assert_allclose(got.x_ge, want.x_ge, atol=1e-4, rtol=0)


# ------------------------------------------------------------- BatchedGOPRunner


def jax_sweep_noise(key, predictor, batch):
    """sweep s -> the (x_init, noise) JAX's BatchedGOPRunner draws at sweep s."""
    cfg = predictor.cfg
    shape = (batch, cfg.data.image_size, cfg.data.image_size,
             cfg.data.channels * cfg.data.num_frames)
    subs = []

    def sweep(s):
        nonlocal key
        while len(subs) <= s:
            key, sub = jax.random.split(key)
            subs.append(sub)
        knoise, ksamp = jax.random.split(subs[s])
        keys = jax.random.split(ksamp, len(predictor.sub) + 1)
        return (torch.tensor(np.asarray(jax.random.normal(knoise, shape, jnp.float32))),
                torch.tensor(np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                                       for k in keys])))

    return sweep


def _walks(cls, videos, thresholds, n_frames):
    return [[cls(video=v, threshold=t, quality=0, num_frames_total=n_frames) for t in thresholds]
            for v in videos]


def _assert_same_results(got, want, exact_frames=False):
    assert len(got) == len(want)
    for gw, ww in zip(got, want):
        assert [r is None for r in gw] == [r is None for r in ww]
        for g, w in zip(gw, ww):
            if g is None:
                continue
            np.testing.assert_array_equal(g.d, w.d)
            assert g.bits == w.bits and g.bpp == w.bpp and g.n_updates == w.n_updates
            if exact_frames:
                assert g.x_ge.tobytes() == w.x_ge.tobytes()
            else:
                np.testing.assert_allclose(g.x_ge, w.x_ge, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["walks", "retire"])
def test_batched_runner_matches_jax(pipelines, case):
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    n = 6
    videos = [smooth_video(n=n, seed=s) for s in (7, 9)]
    if case == "walks":  # backfill: two walks of two points on two slots
        thr, stop = [1e9, MIXED], 1e9
    else:  # the first point's bpp retires each walk
        thr, stop = [-1.0, -2.0, -3.0], 1e-6
    key = jax.random.PRNGKey(2)
    want, wstats = JBatchedGOPRunner(jcfg, jpred, {0: jcoder}, lpips=jlp, batch_size=2).run_walks(
        _walks(JGOPJob, videos, thr, n), key, bpp_stop=stop)
    runner = BatchedGOPRunner(cfg, pred, {0: coder}, lpips=lp, batch_size=2)
    got, stats = runner.run_walks(_walks(GOPJob, videos, thr, n), 0, bpp_stop=stop,
                                  noise=jax_sweep_noise(key, pred, 2))
    assert stats == wstats
    _assert_same_results(got, want)
    if case == "retire":
        assert stats["jobs_run"] == 2 and stats["jobs_skipped"] == 4
        # a rerun with the port's own generators is bit-identical
        a, sa = runner.run_walks(_walks(GOPJob, videos, [MIXED], n), 5)
        b, sb = runner.run_walks(_walks(GOPJob, videos, [MIXED], n), 5)
        assert sa == sb
        _assert_same_results(a, b, exact_frames=True)


def test_batched_tail_clamp_matches_jax(pipelines):
    """Reject-all chains ending at the video's end code a 1-frame fallback in
    the same batch: each chain gets its own frames (the JAX package's
    tests/test_batched.py case)."""
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    n = 5
    videos = np.random.RandomState(31).rand(2, n, 64, 64, 3).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = JBatchedGOPRunner(jcfg, jpred, {0: jcoder}, lpips=jlp, batch_size=2).run(
        [JGOPJob(video=v, threshold=-1.0, quality=0, num_frames_total=n) for v in videos], key)
    got = BatchedGOPRunner(cfg, pred, {0: coder}, lpips=lp, batch_size=2).run(
        [GOPJob(video=v, threshold=-1.0, quality=0, num_frames_total=n) for v in videos], 0,
        noise=jax_sweep_noise(key, pred, 2))
    _assert_same_results([got], [want])
    for i, r in enumerate(got):
        assert r.d[0].tolist() == [1] * n
        own = np.concatenate([code_frames(coder, videos[i][a: a + 2], 64)[0] for a in (0, 2, 4)])
        np.testing.assert_allclose(r.x_ge[0], own[:n], atol=1e-4)


def test_batched_walks_must_be_ordered(pipelines):
    cfg, pred, coder, lp = pipelines[0]
    runner = BatchedGOPRunner(cfg, pred, {0: coder}, lpips=lp, batch_size=2)
    video = smooth_video(n=4)
    with pytest.raises(ValueError, match="least-transmitting"):
        runner.run_walks(_walks(GOPJob, [video], [0.1, 0.2], 4), 0)
    with pytest.raises(ValueError, match="shorter"):
        runner.run([GOPJob(video=video, threshold=0.1, quality=0, num_frames_total=6)], 0)


# ------------------------------------------------------------- FusedGOPSender


@pytest.fixture(scope="module")
def fused(pipelines):
    """The port's whole-GOP sender and the JAX package's (compiled once)."""
    (cfg, pred, coder, lp), (jcfg, jpred, jcoder, jlp) = pipelines
    return (FusedGOPSender(cfg, pred, coder, lp, num_frames_total=FUSED_T),
            JFusedGOPSender(cfg=jcfg, predictor=jpred, coder=jcoder, lpips=jlp,
                            num_frames_total=FUSED_T))


def _assert_same_fused(got, want):
    n = int(want["n_updates"])
    assert int(got["n_updates"]) == n
    np.testing.assert_array_equal(got["d"].cpu().numpy(), np.asarray(want["d"]))
    np.testing.assert_array_equal(got["accepts"].cpu().numpy(), np.asarray(want["accepts"]))
    np.testing.assert_allclose(float(got["bits"]), float(want["bits"]), rtol=1e-4)
    np.testing.assert_allclose(got["x_ge"].cpu().numpy(), np.asarray(want["x_ge"]), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("case", ["mixed", "forced"])
def test_fused_run_matches_jax(pipelines, fused, case):
    port, jfused = fused
    pred = pipelines[0][1]
    video, key = smooth_video(n=FUSED_T), jax.random.PRNGKey(21)
    forced = [0, 3, -1] if case == "forced" else None
    want = jfused.run(video, key, MIXED, forced_accepts=forced)
    got = port.run(video, 0, MIXED, forced_accepts=forced, noise=jax_noise(key, pred))
    _assert_same_fused(got, want)
    if case == "forced":  # 3 clamped to the 2 frames left
        assert got["accepts"][:3].tolist() == [0, 2, -1]
    else:
        assert 0 in got["accepts"].tolist()


def test_fused_psnr_decisions(pipelines):
    """PSNR >= rho in float32: accept-all and reject-all thresholds."""
    cfg, pred, coder, lp = pipelines[0]
    port = FusedGOPSender(cfg, pred, coder, None, num_frames_total=FUSED_T, use_psnr=True)
    video = smooth_video(n=FUSED_T)
    assert port.run(video, 1, -100.0)["d"].tolist() == [1, 1] + [0] * (FUSED_T - 2)
    assert port.run(video, 1, 100.0)["d"].tolist() == [1] * FUSED_T


def test_fused_run_batched_matches_jax_and_run(pipelines, fused):
    port, jfused = fused
    pred = pipelines[0][1]
    videos = np.stack([smooth_video(n=FUSED_T, seed=s) for s in (7, 9)])
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    thresholds = np.asarray([MIXED, 1e9], np.float32)
    forced = np.asarray([[0, 3, 0], [-1, -1, -1]], np.int32)
    want = jfused.run_batched(videos, keys, thresholds, forced_accepts=forced)
    got = port.run_batched(videos, [0, 0], thresholds, forced_accepts=forced,
                           noises=[jax_noise(k, pred) for k in keys])
    for b in range(2):
        _assert_same_fused({k: v[b] for k, v in got.items()},
                           {k: v[b] for k, v in want.items()})
    # the port's own generators: each chain is its run, a rerun is bit-identical
    a = port.run_batched(videos, [5, 6], thresholds, forced_accepts=forced)
    b = port.run_batched(videos, [5, 6], thresholds, forced_accepts=forced)
    for k in a:
        assert torch.equal(a[k], b[k])
    for i, s in enumerate((5, 6)):
        one = port.run(videos[i], s, float(thresholds[i]), forced_accepts=forced[i])
        assert one["accepts"].tolist() == a["accepts"][i].tolist()
        np.testing.assert_allclose(one["x_ge"].numpy(), a["x_ge"][i].numpy(), atol=1e-5)
        np.testing.assert_allclose(float(one["bits"]), float(a["bits"][i]), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="A10"):
        port.run_sharded(None, videos, [0, 0], thresholds)


def test_fused_run_batched_masks_finished_chains(pipelines, fused):
    """A chain whose last fallback pair ends past T stays masked while the
    other chain runs on; each chain still equals its own run."""
    port = fused[0]
    videos = np.stack([smooth_video(n=FUSED_T, seed=s) for s in (7, 9)])
    forced = np.asarray([[3, 0, -1, -1], [1, 1, 1, 1]], np.int32)  # 2->5->7; 2->3->4->5->6
    out = port.run_batched(videos, [1, 2], [1e9, 1e9], forced_accepts=forced)
    assert out["n_updates"].tolist() == [2, 4]
    assert out["d"].tolist() == [[1, 1, 0, 0, 0, 1], [1, 1, 0, 0, 0, 0]]
    for i, s in enumerate((1, 2)):
        one = port.run(videos[i], s, 1e9, forced_accepts=forced[i])
        assert one["accepts"].tolist() == out["accepts"][i].tolist()
        np.testing.assert_allclose(one["x_ge"].numpy(), out["x_ge"][i].numpy(), atol=1e-5)
