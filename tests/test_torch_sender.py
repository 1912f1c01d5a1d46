"""tvc_torch accept decision (LPIPS(alex), PSNR, ``Sender``) against the JAX package.

Tolerances: LPIPS(alex) through five float32 conv layers, max |diff| <=
1e-4 x the score; PSNR is the same float64 host code, equal to 1e-12. The
accepted counts must be equal, with thresholds set halfway between the JAX
scores, far from any score compared with the LPIPS tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.metrics.lpips import LPIPS as JLPIPS
from tvc.metrics.lpips import LPIPSMetric as JLPIPSMetric
from tvc.metrics.lpips import load_lpips_weights as j_load_lpips_weights
from tvc.metrics.pixel import psnr as j_psnr
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.pipeline.predictor import FramePredictor as JFramePredictor
from tvc.pipeline.sender import Sender as JSender
from tvc.pipeline.sender import stack_frames as j_stack_frames
from tvc_torch.core.config import Config
from tvc_torch.metrics.lpips import LPIPS, LPIPSMetric
from tvc_torch.metrics.pixel import psnr
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.sender import Sender, stack_frames
from tvc_torch.utils.convert import lpips_from_jax, unet_from_jax


def tiny_cfg(cls):
    """The tiny config of tests/conftest.py (``tiny_pipeline``)."""
    cfg = cls()
    cfg.data.image_size = 64
    cfg.data.num_frames = 3
    cfg.data.num_frames_cond = 2
    cfg.model.ngf = 16
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (32,)
    cfg.model.n_head_channels = 8
    cfg.model.num_classes = 20
    cfg.sampling.subsample = 5
    return cfg


def _lpips_params(seed):
    """Random LPIPS(alex) params: LeCun-scaled convs, heads in [-0.05, 0.2)
    (negative heads exercise the clamp at zero)."""
    rng = np.random.RandomState(seed)
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(JLPIPS().init, jax.random.PRNGKey(0), x, x)["params"]

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "lin" in name:
            return rng.uniform(-0.05, 0.2, s.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def metrics():
    params = _lpips_params(0)
    jlp = JLPIPSMetric(params=dict(params), calibrated=False)
    model = LPIPS(device="cpu")
    model.load_state_dict(lpips_from_jax(params), strict=True)
    return jlp, LPIPSMetric(model, calibrated=False)


def _frames(n, seed, size=64):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def _graded(gt, seed, amps=(0.02, 0.1, 0.3)):
    """Predictions whose error grows frame by frame, so that thresholds cut prefixes."""
    noise = np.random.RandomState(seed).randn(*gt.shape).astype(np.float32)
    amp = np.asarray(amps, np.float32)[: gt.shape[1]].reshape(1, -1, 1, 1, 1)
    return np.clip(gt + amp * noise, 0.0, 1.0)


def test_lpips_matches_jax(metrics):
    jlp, lp = metrics
    a, b = _frames(4, 1), _frames(4, 2)
    b[0] = a[0]  # identical pair: distance 0
    want = np.asarray(jlp(a, b))
    got = lp(a, b).numpy()
    assert got.shape == (4,) and got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_lpips_weights_load_from_pth(tmp_path, metrics):
    """torchvision AlexNet and LPIPS head files load into both packages alike."""
    rng = np.random.RandomState(5)
    alex = {}
    for cid, (o, i, k) in zip((0, 3, 6, 8, 10), [(64, 3, 11), (192, 64, 5), (384, 192, 3),
                                                 (256, 384, 3), (256, 256, 3)]):
        alex[f"features.{cid}.weight"] = torch.tensor(rng.randn(o, i, k, k) / np.sqrt(i * k * k),
                                                      dtype=torch.float32)
        alex[f"features.{cid}.bias"] = torch.tensor(rng.randn(o) * 0.1, dtype=torch.float32)
    lin = {f"lin{k}.model.1.weight": torch.tensor(rng.rand(1, c, 1, 1), dtype=torch.float32)
           for k, c in enumerate((64, 192, 384, 256, 256))}
    torch.save(alex, tmp_path / "alexnet.pth")
    torch.save(lin, tmp_path / "alex.pth")

    jparams, jcal = j_load_lpips_weights(dict(metrics[0].params), str(tmp_path / "alexnet.pth"),
                                         str(tmp_path / "alex.pth"))
    jlp = JLPIPSMetric(params=jparams, calibrated=jcal)
    lp = LPIPSMetric.create(str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth"),
                            device="cpu")
    assert lp.calibrated and jcal
    a, b = _frames(2, 3), _frames(2, 4)
    np.testing.assert_allclose(lp(a, b).numpy(), np.asarray(jlp(a, b)), rtol=1e-4)


def test_psnr_matches_jax():
    a, b = _frames(2, 6), _frames(2, 7)
    assert psnr(a, b) == pytest.approx(j_psnr(a, b), rel=1e-12)
    assert psnr(a, a) == j_psnr(a, a) == float("inf")
    assert psnr(a * 255, b * 255, maxvalue=255.0) == pytest.approx(
        j_psnr(a * 255, b * 255, maxvalue=255.0), rel=1e-12)


def test_stack_frames_matches_jax():
    x = np.random.RandomState(8).rand(2, 3, 4, 5, 3)
    np.testing.assert_array_equal(stack_frames(x), j_stack_frames(x))


def _thresholds(scores, higher_is_better):
    """All-reject, all-accept, and the midpoints between sorted scores."""
    s = np.sort(np.asarray(scores, np.float64))
    mids = list((s[1:] + s[:-1]) / 2)
    lo, hi = s[0] - 1.0, s[-1] + 1.0
    return [hi, lo] + mids if higher_is_better else [lo, hi] + mids


@pytest.mark.parametrize("use_psnr", [False, True], ids=["lpips", "psnr"])
def test_decide_matches_jax(metrics, use_psnr):
    jlp, lp = metrics
    gt = _frames(3, 9)[None]
    pred = _graded(gt, 10)
    if use_psnr:
        scores = [psnr(pred[0, j], gt[0, j]) for j in range(3)]
    else:
        scores = np.asarray(jlp(pred[0], gt[0]))
    counts = []
    for thr in _thresholds(scores, higher_is_better=use_psnr):
        jd, jge = JSender(thr, tiny_cfg(JConfig), None, jlp, use_psnr).decide(pred, gt)
        d, ge = Sender(thr, tiny_cfg(Config), None, lp, use_psnr).decide(pred, gt)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(ge, jge)
        counts.append(d.shape[1])
    assert counts[:2] == [0, 3]  # all-reject, all-accept
    assert sorted(counts[2:]) == [1, 2]


@pytest.fixture(scope="module")
def predictors():
    """The JAX predictor and the port's, on the same random weights."""
    jcfg, cfg = tiny_cfg(JConfig), tiny_cfg(Config)
    size = cfg.data.image_size
    model = JUNetMoreDDPM(cfg=jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 9)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, size, size, 6)))
    rng = np.random.RandomState(42)
    variables = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.08).astype(np.float32), shapes)
    unet = UNetMoreDDPM(cfg, device="cpu")
    unet.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    return JFramePredictor(jcfg, variables), FramePredictor(cfg, unet)


def test_update_matches_jax(metrics, predictors):
    """One predict/decide step on the tiny config: the same noise, the same
    weights, the same accepted count at every threshold."""
    jlp, lp = metrics
    jpred, pred = predictors
    jcfg, cfg = jpred.cfg, pred.cfg
    video = np.clip(_frames(1, 11)[None].repeat(8, axis=1)
                    + 0.05 * np.random.RandomState(12).randn(1, 8, 64, 64, 3), 0, 1
                    ).astype(np.float32)
    x_ge, d = video[:, :2], np.ones((1, 2), np.int64)
    key = jax.random.PRNGKey(21)

    # the JAX prediction and its scores place the thresholds
    jframes = np.asarray(jpred.generate(key, jnp.asarray(j_stack_frames(x_ge))))
    scores = np.asarray(jlp(jframes[0], video[0, 2:5]))

    shape = (1, 64, 64, 9)
    knoise, ksamp = jax.random.split(key)
    x_init = torch.tensor(np.asarray(jax.random.normal(knoise, shape, jnp.float32)))
    keys = jax.random.split(ksamp, len(pred.sub) + 1)
    noise = torch.tensor(np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                                   for k in keys]))
    tframes = pred.generate(j_stack_frames(x_ge), x_init=x_init, noise=noise).numpy()
    tscores = lp(tframes[0], video[0, 2:5]).numpy()
    np.testing.assert_allclose(tscores, scores, rtol=1e-3)

    counts = []
    for thr in _thresholds(scores, higher_is_better=False):
        jd, jge = JSender(thr, jcfg, jpred, jlp).update(key, video, x_ge, d)
        td, tge = Sender(thr, cfg, pred, lp).update(None, video, x_ge, d, x_init=x_init,
                                                     noise=noise)
        np.testing.assert_array_equal(td, jd)
        assert tge.shape == jge.shape
        np.testing.assert_allclose(tge, jge, atol=1e-4)
        counts.append(td.shape[1] - 2)
    assert counts[:2] == [0, 3]
