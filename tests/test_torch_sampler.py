"""tvc_torch DDPM sampler and frame predictor against the JAX package.

torch cannot reproduce ``jax.random``, so the noise is drawn in JAX from the
same keys the JAX code splits (``ancestral.py:70,155``,
``predictor.py:166-169``) and handed to the port as tensors.

Tolerances: with a closed-form eps function every step is the same float32
arithmetic, max |diff| <= 1e-5; through the tiny UNet the per-call float32
rounding (see test_torch_ncsnpp.py) carries through 6 UNet calls and the
clip, max |diff| <= 1e-4 on frames in [0, 1].
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.pipeline.predictor import FramePredictor as JFramePredictor
from tvc.pipeline.transforms import data_transform as j_data_transform
from tvc.pipeline.transforms import inverse_data_transform as j_inverse_data_transform
from tvc.samplers.ancestral import ddpm_sampler as j_ddpm_sampler
from tvc.samplers.schedules import Schedule as JSchedule
from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.transforms import data_transform, inverse_data_transform
from tvc_torch.samplers import get_sampler
from tvc_torch.samplers.ancestral import ddpm_sampler
from tvc_torch.samplers.schedules import Schedule
from tvc_torch.utils.convert import unet_from_jax


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


def jax_step_noise(key, n, shape):
    """The per-step draws of the JAX sampler: normal(split(key, n)[i])."""
    keys = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.normal(keys[i], shape, jnp.float32))
                     for i in range(n)])


@pytest.mark.parametrize("sigma_dist", ["linear", "cosine", "geometric"])
@pytest.mark.parametrize("subsample", [5, 100])
def test_schedule_matches_jax(sigma_dist, subsample):
    jcfg, cfg = tiny_cfg(JConfig), tiny_cfg(Config)
    jcfg.model.sigma_dist = cfg.model.sigma_dist = sigma_dist
    jsub = JSchedule.from_config(jcfg).subsample(subsample)
    sub = Schedule.from_config(cfg).subsample(subsample)
    for name in ("steps", "alphas", "alphas_prev", "betas"):
        np.testing.assert_array_equal(getattr(sub, name), getattr(jsub, name))


def _eps_jax(x, labels, cond):
    return jnp.tanh(0.7 * x + 0.01 * labels[:, None, None, None].astype(jnp.float32)
                    + 0.3 * jnp.mean(cond, axis=-1, keepdims=True))


def _eps_torch(x, labels, cond):
    return torch.tanh(0.7 * x + 0.01 * labels[:, None, None, None].float()
                      + 0.3 * cond.mean(dim=-1, keepdim=True))


@pytest.mark.parametrize("denoise,clip_before,final_only",
                         [(True, True, True), (False, True, True), (True, False, True),
                          (True, True, False)],
                         ids=["default", "no_denoise", "no_clip", "trajectory"])
def test_ddpm_sampler_matches_jax(denoise, clip_before, final_only):
    cfg = tiny_cfg(JConfig)
    sub = JSchedule.from_config(cfg).subsample(cfg.sampling.subsample)
    rng = np.random.RandomState(0)
    x_init = rng.randn(2, 8, 8, 9).astype(np.float32)
    cond = rng.rand(2, 8, 8, 6).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(7)
    want = np.asarray(j_ddpm_sampler(key, jnp.asarray(x_init), _eps_jax, sub,
                                     cond=jnp.asarray(cond), denoise=denoise,
                                     clip_before=clip_before, final_only=final_only))
    noise = jax_step_noise(key, len(sub) + 1, x_init.shape)
    tsub = Schedule.from_config(tiny_cfg(Config)).subsample(cfg.sampling.subsample)
    got = ddpm_sampler(torch.from_numpy(x_init), _eps_torch, tsub, cond=torch.from_numpy(cond),
                       denoise=denoise, clip_before=clip_before, final_only=final_only,
                       noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ddpm_sampler_labels_and_noise_rows():
    """Labels are the raw steps, then L-1 for the denoise step; no noise is
    drawn at the last regular step or the denoise step."""
    cfg = tiny_cfg(Config)
    sub = Schedule.from_config(cfg).subsample(cfg.sampling.subsample)
    seen = []

    def eps(x, labels, cond):
        seen.append(int(labels[0]))
        return torch.zeros_like(x)

    x = torch.zeros(1, 4, 4, 3)
    noise = torch.full((len(sub) + 1, 1, 4, 4, 3), float("nan"))
    noise[: len(sub) - 1] = 0.0  # a NaN row that were used would poison the result
    out = ddpm_sampler(x, eps, sub, noise=noise)
    assert seen == [0, 4, 8, 12, 16, 4]
    assert torch.isfinite(out).all()


def test_ddpm_sampler_needs_noise_source():
    cfg = tiny_cfg(Config)
    sub = Schedule.from_config(cfg).subsample(cfg.sampling.subsample)
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="generator"):
        ddpm_sampler(x, lambda x, l, c: x, sub)
    with pytest.raises(ValueError, match="noise"):
        ddpm_sampler(x, lambda x, l, c: x, sub, noise=torch.zeros(2, 1, 4, 4, 3))
    g = torch.Generator().manual_seed(0)
    a = ddpm_sampler(x, lambda x, l, c: x, sub, generator=g)
    b = ddpm_sampler(x, lambda x, l, c: x, sub, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["rescaled", "logit"])
def test_transforms_match_jax(mode):
    jcfg, cfg = tiny_cfg(JConfig), tiny_cfg(Config)
    if mode == "logit":
        jcfg.data.rescaled = cfg.data.rescaled = False
        jcfg.data.logit_transform = cfg.data.logit_transform = True
    x = np.random.RandomState(9).rand(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(j_data_transform(jcfg, jnp.asarray(x)))
    got = data_transform(cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    back = np.asarray(j_inverse_data_transform(jcfg, jnp.asarray(want)))
    np.testing.assert_allclose(inverse_data_transform(cfg, got).numpy(), back, atol=1e-6)


def test_dequantization_draws_from_the_generator():
    cfg = tiny_cfg(Config)
    cfg.data.uniform_dequantization = True
    x = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        data_transform(cfg, x)
    a = data_transform(cfg, x, torch.Generator().manual_seed(1))
    b = data_transform(cfg, x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert 0 < (a - (2 * x - 1)).abs().max() <= 2 / 256 + 1e-6


def test_get_sampler():
    assert get_sampler("ddpm") is ddpm_sampler
    for v in ("DDIM", "FPNDM"):
        with pytest.raises(NotImplementedError):
            get_sampler(v)
    with pytest.raises(ValueError):
        get_sampler("nope")


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
    jpred = JFramePredictor(jcfg, variables)
    unet = UNetMoreDDPM(cfg, device="cpu")
    unet.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    return jpred, FramePredictor(cfg, unet)


def jax_generate_noise(pred, key, b):
    """x_init and the per-step noise exactly as JAX ``FramePredictor.generate`` draws them."""
    cfg = pred.cfg
    shape = (b, cfg.data.image_size, cfg.data.image_size, cfg.data.channels * cfg.data.num_frames)
    knoise, ksamp = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(knoise, shape, jnp.float32))
    return x_init, jax_step_noise(ksamp, len(pred.sub) + 1, shape)


def test_frame_predictor_generate_matches_jax(predictors):
    jpred, pred = predictors
    cond = np.random.RandomState(3).rand(2, 64, 64, 6).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jpred.generate(key, jnp.asarray(cond)))
    x_init, noise = jax_generate_noise(jpred, key, 2)
    got = pred.generate(cond, x_init=torch.tensor(x_init), noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape == (2, 3, 64, 64, 3)
    assert pred.n_steps == 6
    assert 0.01 < want.std()  # not a constant image
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_frame_predictor_generator_is_repeatable(predictors):
    _, pred = predictors
    cond = np.random.RandomState(4).rand(1, 64, 64, 6).astype(np.float32)
    a = pred.generate(cond, generator=torch.Generator().manual_seed(5))
    b = pred.generate(cond, generator=torch.Generator().manual_seed(5))
    c = pred.generate(cond, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
