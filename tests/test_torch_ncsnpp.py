"""tvc_torch NCSN++ UNet against the JAX package, with weights carried by
``tvc_torch.utils.convert``.

Tolerance: the two forwards agree to float32 rounding of a deep net,
max |diff| <= 5e-5 x max |output| (the bound tests/test_reference_parity.py
uses for the JAX package against the reference torch code).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.models.diffusion.ncsnpp import NCSNppSpec as JSpec
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.models.diffusion.ncsnpp import _build_plan as j_build_plan
from tvc.models.diffusion.ncsnpp import make_schedule as j_make_schedule
from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.ncsnpp import (NCSNppSpec, UNetMoreDDPM, _build_plan,
                                                make_schedule)
from tvc_torch.utils.convert import load_diffusion_checkpoint, unet_from_jax


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


def flagship_shaped_cfg(cls):
    """The flagship topology (5 levels, 2 res blocks, attention at 3
    resolutions) at 1/24 width, as in tests/test_reference_parity.py."""
    cfg = cls()
    cfg.data.image_size = 32
    cfg.model.ngf = 8
    cfg.model.n_head_channels = 4
    cfg.model.attn_resolutions = (2, 4, 8)
    return cfg


def random_variables(init, *args, seed, scale=0.08):
    """Parameters of ``init``'s shapes drawn N(0, scale) with numpy: the
    zero-init final convs of the real init would make the comparison vacuous
    (and ``jax.eval_shape`` costs a fraction of an eager init)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), shapes)


def _inputs(cfg, b=2, seed=1):
    rng = np.random.RandomState(seed)
    size, c = cfg.data.image_size, cfg.data.channels
    x = rng.randn(b, size, size, c * cfg.data.num_frames).astype(np.float32)
    cond = rng.randn(b, size, size, c * cfg.data.num_frames_cond).astype(np.float32)
    t = np.array([3, 777][:b], np.int32) % cfg.model.num_classes
    return x, t, cond


@pytest.mark.parametrize("cfg_fn", [tiny_cfg, flagship_shaped_cfg],
                         ids=["tiny", "flagship_shaped"])
def test_plan_matches_jax(cfg_fn):
    jplan = j_build_plan(JSpec.from_config(cfg_fn(JConfig)))
    plan = _build_plan(NCSNppSpec.from_config(cfg_fn(Config)))
    assert len(plan) == len(jplan)
    for p, jp in zip(plan, jplan):
        assert {k: v for k, v in p.items() if k in jp} == jp


@pytest.mark.parametrize("cfg_fn", [tiny_cfg, flagship_shaped_cfg],
                         ids=["tiny", "flagship_shaped"])
def test_unet_forward_matches_jax(cfg_fn):
    jcfg, cfg = cfg_fn(JConfig), cfg_fn(Config)
    x, t, cond = _inputs(cfg)
    jmodel = JUNetMoreDDPM(cfg=jcfg)
    variables = random_variables(jmodel.init, jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32),
                                 jnp.asarray(cond[:1]), seed=42)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(t),
                                            jnp.asarray(cond)))

    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    torch.from_numpy(cond)).numpy()

    scale = np.abs(want).max()
    assert scale > 1e-2, "degenerate output; the comparison would be vacuous"
    np.testing.assert_allclose(got, want, atol=5e-5 * scale)


def test_full_width_parameter_shapes_match_jax():
    """The default Config() (262.1M params): the port built on the meta device
    has exactly the parameter shapes of the JAX init, after conversion."""
    jcfg, cfg = JConfig(), Config()
    size, c = cfg.data.image_size, cfg.data.channels
    x = jax.ShapeDtypeStruct((1, size, size, c * cfg.data.num_frames), jnp.float32)
    cond = jax.ShapeDtypeStruct((1, size, size, c * cfg.data.num_frames_cond), jnp.float32)
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0), x,
                            jax.ShapeDtypeStruct((1,), jnp.int32), cond)
    # np.zeros maps pages lazily and the conversion only takes views: no 1 GB copy
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    converted = {k: tuple(v.shape) for k, v in unet_from_jax(cfg, zeros).items()}

    model = UNetMoreDDPM(cfg, device="meta")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert converted == ours
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s)) for s in ours.values())
    assert round(n_params / 1e6, 1) == 262.1


@pytest.mark.parametrize("section,key,value", [
    ("model", "spade", True), ("model", "arch", "unetmore3d"),
    ("model", "arch", "unetmorepseudo3d"), ("model", "embedding_type", "fourier"),
    ("model", "noise_in_cond", True)])
def test_unported_branches_raise(section, key, value):
    cfg = Config()
    setattr(getattr(cfg, section), key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNetMoreDDPM(cfg, device="meta")


@pytest.mark.parametrize("sigma_dist", ["linear", "cosine", "geometric"])
def test_make_schedule_matches_jax(sigma_dist):
    jcfg, cfg = JConfig(), Config()
    jcfg.model.sigma_dist = cfg.model.sigma_dist = sigma_dist
    want, got = j_make_schedule(jcfg), make_schedule(cfg)
    for name in ("betas", "alphas", "alphas_prev"):
        np.testing.assert_array_equal(got[name], want[name])


def test_reference_checkpoint_loads_without_conversion(tmp_path):
    """A reference ``checkpoint_*.pt`` list ([0] DataParallel weights, [-1] the
    EMA shadow, keys ``module.unet.all_modules.*``) loads into the port as it is."""
    cfg = tiny_cfg(Config)
    src = UNetMoreDDPM(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ema = {f"module.{k}": torch.randn(v.shape, generator=gen) for k, v in src.state_dict().items()}
    raw = {k: torch.zeros_like(v) for k, v in ema.items()}
    torch.save([raw, {"lr": 1e-4}, 3, 900000, ema], tmp_path / "checkpoint_900000.pt")
    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(load_diffusion_checkpoint(str(tmp_path / "checkpoint_900000.pt"), cfg),
                          strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ema[f"module.{k}"])
