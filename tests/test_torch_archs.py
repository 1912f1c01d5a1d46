"""tvc_torch's SPADE, 3-D and pseudo-3-D NCSN++ and the 2-D NCSN++ options
(Fourier embedding, cond-mask embedding, ``noise_in_cond``) against the JAX
package, layer by layer and as whole networks, on the same numpy-seeded
weights and inputs.

Tolerances: float32 max |diff| <= 5e-5 x max |want| (tests/test_torch_ncsnpp.py);
bf16 layers at test_torch_bf16.py's ``LAYER_TOL`` (4 bf16 ulps at the
output's magnitude); a predictor update within 1e-4 (test_torch_sampler.py).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.models.diffusion import layers as jl
from tvc.models.diffusion import layers3d as jl3
from tvc.models.diffusion import ncsnpp3d as jn3
from tvc.models.diffusion import spade as jsp
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.pipeline.predictor import FramePredictor as JFramePredictor
from tvc.utils.convert import _build_plan_3d as j_build_plan_3d
from tvc_torch.core.config import Config
from tvc_torch.models.diffusion import layers as tl
from tvc_torch.models.diffusion import layers3d as tl3
from tvc_torch.models.diffusion import ncsnpp3d as tn3
from tvc_torch.models.diffusion import spade as tsp
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.utils.convert import (spade_state_dict_from_jax, state_dict_3d_from_jax,
                                     state_dict_from_jax, unet_from_jax)

from test_torch_bf16 import LAYER_TOL
from test_torch_sampler import jax_generate_noise

ARCHS = {"spade": dict(spade=True, spade_dim=16), "unetmore3d": dict(arch="unetmore3d"),
         "unetmorepseudo3d": dict(arch="unetmorepseudo3d")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as test_torch_bf16.py: the tier-1 workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(cls, **model):
    """The capability tests' tiny config (tests/test_capability_models.py)."""
    cfg = cls()
    cfg.data.image_size = 16
    cfg.data.num_frames = 2
    cfg.data.num_frames_cond = 1
    cfg.model.ngf = 8
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (8,)
    cfg.model.n_head_channels = 8
    cfg.model.num_classes = 20
    cfg.sampling.subsample = 4
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _params(jmod, *args, seed=3, scale=0.3):
    """Every parameter of ``jmod`` drawn N(0, scale) with numpy."""
    rng = np.random.RandomState(seed)
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(jmod.init, rngs, *args)
    return jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32),
                                  shapes)


def _close(got, want, rel=5e-5):
    scale = np.abs(want).max()
    assert scale > 1e-3, "degenerate output; the comparison would be vacuous"
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * scale)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().double().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# SPADE (spade.py)
# ---------------------------------------------------------------------------


def _spade_case(name, dtype=jnp.float32):
    """(JAX module, port module, JAX args, port args, output to NHWC)."""
    x, seg = _rand((2, 8, 8, 16), 0), _rand((2, 16, 16, 3), 1)
    emb = _rand((2, 12), 2)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    if name == "myspade":
        return (jsp.MySPADE(16, 8, dtype=dtype), tsp.MySPADE(16, 3, 8, dtype=tdt),
                (x, seg), (nchw(x), nchw(seg)))
    if name == "actnorm":
        return (jsp.GetActNormSPADE(16, spade_dim=8, dtype=dtype),
                tsp.GetActNormSPADE(16, 3, 12, 8, dtype=tdt),
                (x, emb, seg), (nchw(x), torch.from_numpy(emb), nchw(seg)))
    up, down = name == "res_up", name == "res_down"
    out = 24 if name == "res_wider" else None
    return (jsp.ResnetBlockBigGANSPADE(16, out, up=up, down=down, spade_dim=8, dtype=dtype),
            tsp.ResnetBlockBigGANSPADE(16, out, 3, 12, up=up, down=down, spade_dim=8,
                                       dtype=tdt),
            (x, emb, seg), (nchw(x), torch.from_numpy(emb), nchw(seg)))


@pytest.mark.parametrize("name", ["myspade", "actnorm", "res", "res_up", "res_down",
                                  "res_wider"])
def test_spade_layers_match_jax(name):
    jmod, tmod, jargs, targs = _spade_case(name)
    jargs = [jnp.asarray(a) for a in jargs]
    params = _params(jmod, *jargs)
    want = np.asarray(jmod.apply(params, *jargs), np.float64)
    tmod.load_state_dict(spade_state_dict_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = nhwc(tmod(*targs))
    _close(got, want)


def _bf16_run(jmod, jmod32, tmod, jargs, targs, to_state, out):
    """(port bf16, JAX bf16, JAX float32) outputs as float64, on inputs and
    parameters already on the bf16 grid."""
    jargs = [jnp.asarray(np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
             for a in jargs]
    params = _params(jmod, *[a.astype(jnp.bfloat16) for a in jargs])
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32)), params)
    want = np.asarray(jmod.apply(params, *[a.astype(jnp.bfloat16) for a in jargs])
                      .astype(jnp.float32), np.float64)
    want32 = np.asarray(jmod32.apply(params, *jargs), np.float64)
    tmod.load_state_dict(to_state(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(*[(t or torch.from_numpy)(np.array(a)).to(torch.bfloat16)
                     for a, t in zip(jargs, targs)])
    assert got.dtype == torch.bfloat16
    return out(got), want, want32


def _spade_bf16(name):
    jmod, tmod, jargs, _ = _spade_case(name, jnp.bfloat16)
    return _bf16_run(jmod, _spade_case(name)[0], tmod, jargs, (nchw, None, nchw),
                     spade_state_dict_from_jax, nhwc)


def _res3d_bf16(name):
    jmod, tmod = _res3d_case(name, jnp.bfloat16)
    x, emb = _rand((2, 8, 8, 8 * 3), 9), _rand((2, 20), 10)
    return _bf16_run(jmod, _res3d_case(name)[0], tmod, (x, emb),
                     (lambda a: _vol(a, 3), None), state_dict_3d_from_jax, _stack)


def test_spade_resblock_bf16_matches_jax():
    got, want, _ = _spade_bf16("res")
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("case", ["spade:res_down", "spade:res_wider", "3d:conv3d_down",
                                  "3d:pseudo_down"])
def test_bf16_resblocks_as_close_to_float32_as_jax(case):
    """bf16 rounds differently in the two packages (a bias added in a float32
    epilogue here, after a bf16 rounding there), and the SPADE and 3-D blocks
    chain more roundings than the 2-D one: every block's distance to the
    float32 result stays within 1.5x of the JAX package's own."""
    kind, name = case.split(":")
    got, want, want32 = (_spade_bf16 if kind == "spade" else _res3d_bf16)(name)
    scale = np.abs(want32).max()
    ours, theirs = np.abs(got - want32).max() / scale, np.abs(want - want32).max() / scale
    assert 0 < theirs and ours <= 1.5 * theirs, (ours, theirs)


def test_spade_resize_is_torch_nearest():
    seg = _rand((1, 16, 16, 3), 4)
    want = np.asarray(jsp._nearest_resize_torch(jnp.asarray(seg), 4, 4))
    got = nhwc(torch.nn.functional.interpolate(nchw(seg), size=(4, 4), mode="nearest"))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 3-D layers (layers3d.py, ncsnpp3d.py)
# ---------------------------------------------------------------------------


def _vol(x, n):
    return tl3.stacked_to_volume(torch.from_numpy(x), n)


def _stack(v):
    return tl3.volume_to_stacked(v).detach().double().numpy()


def test_volume_views_match_jax():
    x = _rand((2, 4, 5, 3 * 4), 5)
    v = _vol(x, 4)
    np.testing.assert_array_equal(np.asarray(jl3.stacked_to_volume(jnp.asarray(x), 4)),
                                  v.permute(0, 2, 3, 4, 1).numpy())
    np.testing.assert_array_equal(_stack(v), x)
    for j, t in ((jn3.frame_major_to_channel_major, tn3.frame_major_to_channel_major),
                 (jn3.channel_major_to_frame_major, tn3.channel_major_to_frame_major)):
        np.testing.assert_array_equal(t(torch.from_numpy(x), 4).numpy(),
                                      np.asarray(j(jnp.asarray(x), 4)))
    fm = tn3.frame_major_to_volume(torch.from_numpy(x), 4)
    assert torch.equal(fm, _vol(tn3.frame_major_to_channel_major(torch.from_numpy(x), 4)
                                .numpy(), 4))
    np.testing.assert_array_equal(tn3.volume_to_frame_major(fm).numpy(), x)


def _layer3d_case(name):
    """(JAX module, port module, JAX input (stacked), frames, extra)."""
    x = _rand((2, 8, 8, 4 * 3), 6)
    if name == "conv3d":
        return jl3.Conv3dDDPM(5, 3), tl3.Conv3dDDPM(4, 5, 3), x, 3
    if name == "conv3d_1x1":
        return jl3.Conv3dDDPM(5, 3, kernel_size=1), tl3.Conv3dDDPM(4, 5, 1), x, 3
    if name == "pseudo":
        return jl3.PseudoConv3d(5, 3), tl3.PseudoConv3d(4, 5, 3), x, 3
    if name == "pseudo_1x1":
        return jl3.PseudoConv3d(5, 3, kernel_size=1), tl3.PseudoConv3d(4, 5, 1), x, 3
    x = _rand((2, 8, 8, 16 * 3), 7)
    if name == "attn3d":
        return jl3.AttnBlockpp3d(16, 3, n_head_channels=8), tl3.AttnBlockpp3d(16, 8), x, 3
    if name == "converter":
        return jl3.FrameConverter1x1(3, 2), tl3.FrameConverter1x1(3, 2), x, 3
    raise ValueError(name)


@pytest.mark.parametrize("name", ["conv3d", "conv3d_1x1", "pseudo", "pseudo_1x1", "attn3d",
                                  "converter"])
def test_3d_layers_match_jax(name):
    jmod, tmod, x, n = _layer3d_case(name)
    params = _params(jmod, jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)), np.float64)
    tmod.load_state_dict(state_dict_3d_from_jax(params["params"],
                                                converter=name == "converter"), strict=True)
    with torch.no_grad():
        got = _stack(tmod(_vol(x, n)))
    _close(got, want)


@pytest.mark.parametrize("c,n_head_channels", [(16, 8), (12, 8), (16, -1), (4, 8)],
                         ids=["two_heads", "uneven_one_head", "one_head", "narrow"])
def test_time_attention_matches_jax(c, n_head_channels):
    """(B', N, C) in the JAX package, (B', C, N) here; heads max(1, C // n_head_channels)."""
    x = _rand((6, 5, c), 8)
    jmod = jl3.TimeAttnBlock(c, n_head_channels=n_head_channels)
    params = _params(jmod, jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)), np.float64)
    tmod = tl3.TimeAttnBlock(c, n_head_channels=n_head_channels)
    tmod.load_state_dict(state_dict_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).double().numpy()
    _close(got, want)


def _res3d_case(name, dtype=jnp.float32):
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pseudo = name.startswith("pseudo")
    kind = name.split("_")[1]
    up, down = kind == "up", kind == "down"
    out = 12 * 3 if kind == "wider" else None
    jmod = jn3.ResnetBlockBigGAN3D(8 * 3, 3, out, pseudo3d=pseudo, up=up, down=down,
                                   dtype=dtype)
    tmod = tn3.ResnetBlockBigGAN3D(8 * 3, 3, out, pseudo, 20, up=up, down=down, dtype=tdt)
    return jmod, tmod


@pytest.mark.parametrize("name", ["conv3d_plain", "conv3d_up", "conv3d_down", "conv3d_wider",
                                  "pseudo_plain", "pseudo_down"])
def test_3d_resblock_matches_jax(name):
    jmod, tmod = _res3d_case(name)
    x, emb = _rand((2, 8, 8, 8 * 3), 9), _rand((2, 20), 10)
    params = _params(jmod, jnp.asarray(x), jnp.asarray(emb))
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(emb)), np.float64)
    tmod.load_state_dict(state_dict_3d_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = _stack(tmod(_vol(x, 3), torch.from_numpy(emb)))
    _close(got, want)


def test_3d_resblock_bf16_matches_jax():
    got, want, _ = _res3d_bf16("conv3d_plain")
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("with_emb", [True, False])
def test_get_act_norm_3d_matches_jax(with_emb):
    """The statistics span each group's whole (N, H, W) volume."""
    x, emb = _rand((2, 4, 4, 8 * 3), 11, 3.0) + 1.0, _rand((2, 20), 12)
    jmod = jn3.GetActNorm3D(8 * 3, 3, emb=with_emb)
    args = (jnp.asarray(x), jnp.asarray(emb)) if with_emb else (jnp.asarray(x),)
    params = _params(jmod, *args)
    want = np.asarray(jmod.apply(params, *args), np.float64)
    tmod = tn3.GetActNorm3D(8 * 3, 3, 20 if with_emb else None)
    tmod.load_state_dict(state_dict_3d_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = _stack(tmod(_vol(x, 3), torch.from_numpy(emb) if with_emb else None))
    _close(got, want)


def test_3d_plan_matches_jax():
    for cfg_fn in (lambda c: tiny_cfg(c, arch="unetmore3d"), lambda c: c()):
        jplan, plan = j_build_plan_3d(cfg_fn(JConfig)), tn3.build_plan_3d(cfg_fn(Config))
        assert len(plan) == len(jplan)
        for p, jp in zip(plan, jplan):
            assert {k: v for k, v in p.items() if k in jp} == jp


# ---------------------------------------------------------------------------
# Whole networks through UNetMoreDDPM and unet_from_jax
# ---------------------------------------------------------------------------


def _unet_inputs(cfg, b=2, seed=1):
    size, c = cfg.data.image_size, cfg.data.channels
    x = _rand((b, size, size, c * cfg.data.num_frames), seed)
    cond = _rand((b, size, size, c * cfg.data.num_frames_cond), seed + 1)
    return x, np.array([3, 17][:b], np.int32), cond


def _unet_variables(jcfg, x, t, cond, seed=42):
    return _params(JUNetMoreDDPM(cfg=jcfg), jnp.asarray(x[:1]),
                   jnp.asarray(t[:1]), jnp.asarray(cond[:1]), seed=seed, scale=0.08)


@functools.lru_cache(maxsize=None)
def arch_pair(name):
    """The JAX UNet's variables and the port's UNet carrying them."""
    jcfg, cfg = tiny_cfg(JConfig, **ARCHS[name]), tiny_cfg(Config, **ARCHS[name])
    x, t, cond = _unet_inputs(cfg)
    variables = _unet_variables(jcfg, x, t, cond)
    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    return jcfg, cfg, variables, model


@pytest.mark.parametrize("arch", list(ARCHS))
def test_arch_forward_matches_jax(arch):
    jcfg, cfg, variables, model = arch_pair(arch)
    x, t, cond = _unet_inputs(cfg)
    want = np.asarray(jax.jit(JUNetMoreDDPM(cfg=jcfg).apply)(
        variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond)), np.float64)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond))
    assert got.shape == x.shape
    _close(got.double().numpy(), want)


@pytest.mark.parametrize("arch", ["spade", "unetmore3d"])
def test_arch_predictor_update_matches_jax(arch):
    """One FramePredictor update (4 DDPM steps and the denoise) on JAX's draws."""
    jcfg, cfg, variables, model = arch_pair(arch)
    jpred, pred = JFramePredictor(jcfg, variables), FramePredictor(cfg, model)
    cond = np.random.RandomState(3).rand(1, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jpred.generate(key, jnp.asarray(cond)))
    x_init, noise = jax_generate_noise(jpred, key, 1)
    got = pred.generate(cond, x_init=torch.tensor(x_init), noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape == (1, 2, 16, 16, 3) and pred.n_steps == 5
    assert 0.01 < want.std()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meta_build_to_empty_holds_no_buffer(arch):
    """The fast-init route (meta -> to_empty -> fill) leaves nothing
    uninitialized: the new archs hold no buffers at all."""
    cfg = tiny_cfg(Config, **ARCHS[arch])
    pred = FramePredictor.create(cfg, device="cpu", fast_init=True)
    assert not list(pred.model.buffers())
    assert all(torch.all(p == 0.01) for p in pred.model.parameters())
    out = pred.generate(np.full((1, 16, 16, 3), 0.5, np.float32),
                        generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 2, 16, 16, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("arch", ["unetmore", *ARCHS])
def test_seeded_init_draws_every_parameter(arch):
    """``FramePredictor.create`` skips PyTorch's default init: every parameter
    of every arch is drawn by ``init_params``, the same values as over a
    default-initialized UNet."""
    cfg = tiny_cfg(Config, **ARCHS.get(arch, {}))
    model = UNetMoreDDPM(cfg, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    tl.init_params(model, torch.Generator().manual_seed(4))
    ref = tl.init_params(UNetMoreDDPM(cfg, device="cpu"), torch.Generator().manual_seed(4))
    got = FramePredictor.create(cfg, seed=4, device="cpu").model.state_dict()
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("arch,millions", [("spade", 347.2), ("unetmore3d", 1010.6),
                                           ("unetmorepseudo3d", 706.5)])
def test_full_width_parameter_shapes_match_jax(arch, millions):
    """The default Config() with the arch switched: ``unet_from_jax`` of the
    JAX init's shapes equals the port's meta-device state dict."""
    model_kw = {k: v for k, v in ARCHS[arch].items() if k != "spade_dim"}
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        for k, v in model_kw.items():
            setattr(c.model, k, v)
    size, c = cfg.data.image_size, cfg.data.channels
    x = jax.ShapeDtypeStruct((1, size, size, c * cfg.data.num_frames), jnp.float32)
    cond = jax.ShapeDtypeStruct((1, size, size, c * cfg.data.num_frames_cond), jnp.float32)
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0), x,
                            jax.ShapeDtypeStruct((1,), jnp.int32), cond)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    converted = {k: tuple(v.shape) for k, v in unet_from_jax(cfg, zeros).items()}
    ours = {k: tuple(v.shape) for k, v in UNetMoreDDPM(cfg, device="meta").state_dict().items()}
    assert converted == ours
    assert round(sum(int(np.prod(s)) for s in ours.values()) / 1e6, 1) == millions


# ---------------------------------------------------------------------------
# The 2-D NCSN++ options: Fourier embedding, cond_emb, noise_in_cond
# ---------------------------------------------------------------------------


def test_gaussian_fourier_projection_matches_jax():
    x = np.log(np.array([0.01, 0.5, 7.0], np.float32))
    jmod = jl.GaussianFourierProjection(embedding_size=16, scale=16.0)
    params = _params(jmod, jnp.asarray(x), scale=16.0)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)), np.float64)
    tmod = tl.GaussianFourierProjection(16, 16.0)
    tmod.load_state_dict(state_dict_from_jax(params["params"]), strict=True)
    assert not tmod.W.requires_grad
    _close(tmod(torch.from_numpy(x)).double().numpy(), want)


@pytest.mark.parametrize("option", ["fourier", "cond_emb", "cond_emb_default_mask"])
def test_ncsnpp_option_forward_matches_jax(option):
    kw = dict(embedding_type="fourier") if option == "fourier" else dict(cond_emb=True)
    jcfg, cfg = tiny_cfg(JConfig, **kw), tiny_cfg(Config, **kw)
    x, t, cond = _unet_inputs(cfg)
    if option == "fourier":  # continuous noise levels, log()'d by the embedding
        t = np.array([0.05, 3.5], np.float32)
    mask = None if option == "cond_emb_default_mask" else np.array([0, 1], np.int32)
    variables = _unet_variables(jcfg, x, t, cond)
    jargs = [jnp.asarray(a) for a in (x, t, cond)]
    apply = jax.jit(JUNetMoreDDPM(cfg=jcfg).apply)
    want = np.asarray(apply(variables, *jargs,
                            cond_mask=None if mask is None else jnp.asarray(mask)), np.float64)
    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    tt = torch.from_numpy(t) if option == "fourier" else torch.from_numpy(t).long()
    with torch.no_grad():
        got = model(torch.from_numpy(x), tt, torch.from_numpy(cond),
                    cond_mask=None if mask is None else torch.from_numpy(mask))
    _close(got.double().numpy(), want)


def test_noise_in_cond_matches_jax_on_its_draw():
    """The JAX UNet's own draw (recorded as it is made) handed to the port."""
    jcfg, cfg = tiny_cfg(JConfig, noise_in_cond=True), tiny_cfg(Config, noise_in_cond=True)
    x, t, cond = _unet_inputs(cfg)
    variables = _unet_variables(jcfg, x, t, cond)
    draws, normal = [], jax.random.normal

    def recording_normal(*args, **kwargs):
        draws.append(normal(*args, **kwargs))
        return draws[-1]

    with mock.patch.object(jax.random, "normal", recording_normal):
        want = np.asarray(JUNetMoreDDPM(cfg=jcfg).apply(
            variables, *[jnp.asarray(a) for a in (x, t, cond)],
            rngs={"noise": jax.random.PRNGKey(5)}), np.float64)
    assert len(draws) == 1 and draws[0].shape == cond.shape
    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    args = (torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond))
    with torch.no_grad():
        got = model(*args, noise=torch.from_numpy(np.array(draws[0])))
        z = torch.randn(cond.shape, generator=torch.Generator().manual_seed(2))
        a = model(*args, noise=z)
        b = model(*args, noise=torch.Generator().manual_seed(2))
    _close(got.double().numpy(), want)
    assert torch.equal(a, b)


def test_noise_in_cond_without_a_draw_fails_as_jax_does():
    """The JAX UNet without a 'noise' rng raises, so its FramePredictor (which
    passes none) fails at the first generate; the port raises ValueError there."""
    jcfg, cfg = tiny_cfg(JConfig, noise_in_cond=True), tiny_cfg(Config, noise_in_cond=True)
    x, t, cond = _unet_inputs(cfg, b=1)
    variables = _unet_variables(jcfg, x, t, cond)
    with pytest.raises(Exception, match="noise"):
        JFramePredictor(jcfg, variables).generate(jax.random.PRNGKey(0), jnp.asarray(cond))
    model = UNetMoreDDPM(cfg, device="cpu")
    with pytest.raises(ValueError, match="noise"):
        model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond))
    pred = FramePredictor(cfg, model)
    with pytest.raises(ValueError, match="noise_in_cond"):
        pred.generate(np.zeros((1, 16, 16, 3), np.float32),
                      generator=torch.Generator().manual_seed(0))


def test_predictor_refuses_fourier_as_jax_does():
    jcfg, cfg = (tiny_cfg(JConfig, embedding_type="fourier"),
                 tiny_cfg(Config, embedding_type="fourier"))
    with pytest.raises(ValueError, match="fourier"):
        JFramePredictor(jcfg, {})
    with pytest.raises(ValueError, match="fourier"):
        FramePredictor.create(cfg, device="cpu")
