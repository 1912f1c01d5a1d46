"""tvc_torch's library layers against the JAX package: the remaining
resampling ops and their environment switches, the fused leaky ReLU, the
DDPM residual block and FIR resampling modules, the legacy UNet through the
registry, the norm zoo, the NCSNv2 blocks and the ELIC library layers.

Each port module gets every parameter drawn with numpy; the JAX module gets
the same values (through ``tvc.utils.convert``'s converters where the JAX
package has one, by name otherwise). Tolerance: float32 max |diff| <= 5e-5 x
max |want| (tests/test_torch_ncsnpp.py); the resampling ops 1e-6 on N(0, 1)
inputs (tests/test_torch_resample.py).
"""

import re
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.models import registry as jreg
from tvc.models.codec import layers as jcl
from tvc.models.diffusion import layers as jl
from tvc.models.diffusion import ncsnv2_blocks as jnb
from tvc.models.diffusion import normalization as jnorm
from tvc.ops import fused_act as jfa
from tvc.ops import resample as jres
from tvc.utils import convert as jconv
from tvc_torch.core.config import Config
from tvc_torch.core.runtime import numerics_stamp
from tvc_torch.models import registry as treg
from tvc_torch.models.codec import layers as tcl
from tvc_torch.models.diffusion import layers as tl
from tvc_torch.models.diffusion import ncsnv2_blocks as tnb
from tvc_torch.models.diffusion import normalization as tnorm
from tvc_torch.models.diffusion import unet_legacy as tleg
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.ops import fused_act as tfa
from tvc_torch.ops import resample as tres
from tvc_torch.utils.convert import state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as test_torch_bf16.py: the tier-1 workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _params(jmod, *args, seed=3, scale=0.3):
    """Every parameter of ``jmod`` drawn N(0, scale) with numpy."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32),
                                  shapes)


def _randomize(module, seed=3, scale=0.3):
    """Every parameter of a port module drawn N(0, scale) with numpy; returns
    the state dict as numpy arrays."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for _, p in sorted(module.named_parameters()):
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * scale))
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _close(got, want, rel=5e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 1e-3, "degenerate output; the comparison would be vacuous"
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * scale)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().double().numpy().transpose(0, 2, 3, 1)


def hwio(w):
    """A PyTorch (O, I, kh, kw) kernel as flax's (kh, kw, I, O)."""
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


# ---------------------------------------------------------------------------
# ops/resample.py and ops/fused_act.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [(1, 3, 3, 1), (1, 2, 1)], ids=["4tap", "3tap"])
@pytest.mark.parametrize("op", ["upsample_conv_2d", "conv_downsample_2d"])
def test_conv_resampling_matches_jax(op, k):
    x, w = _rand((2, 8, 8, 5), 0), _rand((6, 5, 3, 3), 1)
    want = np.asarray(getattr(jres, op)(jnp.asarray(x), jnp.asarray(hwio(w)), k))
    got = nhwc(getattr(tres, op)(nchw(x), torch.from_numpy(w), k))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("op", ["naive_upsample_2d", "naive_downsample_2d"])
def test_naive_resampling_matches_jax(op):
    x = _rand((2, 8, 8, 5), 2)
    want = np.asarray(getattr(jres, op)(jnp.asarray(x), 2))
    got = getattr(tres, op)(torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("env", [{"TVC_POLYPHASE": "0"}, {"TVC_FUSED_FIR": "1"}],
                         ids=["generic_upfirdn", "fused_fir"])
@pytest.mark.parametrize("op", ["upsample_2d", "downsample_2d"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_resample_env_paths_match_jax(monkeypatch, env, op, layout):
    """Both packages read the variables at each call."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    x = _rand((2, 8, 8, 5), 3)
    want = np.asarray(getattr(jres, op)(jnp.asarray(x)))
    if layout == "nhwc":
        got = getattr(tres, op)(torch.from_numpy(x)).numpy()
    else:
        got = nhwc(getattr(tres, op)(nchw(x), spatial_axes=tres.NCHW))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_resample_settings_are_stamped(monkeypatch):
    x = torch.from_numpy(_rand((1, 8, 8, 4), 4))
    base, stamp = tres.upsample_2d(x), numerics_stamp("cpu", Config())
    assert (stamp["env_polyphase"], stamp["env_fused_fir"]) == ("1", "0")
    monkeypatch.setenv("TVC_FUSED_FIR", "1")
    fused = tres.upsample_2d(x)
    assert numerics_stamp("cpu", Config())["env_fused_fir"] == "1"
    torch.testing.assert_close(fused, base, atol=1e-6, rtol=0)
    monkeypatch.setenv("TVC_POLYPHASE", "0")  # the fused form needs the polyphase one
    assert tres.resample_env() == {"env_polyphase": "0", "env_fused_fir": "0"}


@pytest.mark.parametrize("slope,scale", [(0.2, 2 ** 0.5), (0.01, 1.0)])
def test_fused_leaky_relu_matches_jax(slope, scale):
    x, b = _rand((2, 4, 4, 6), 5), _rand((6,), 6)
    want = np.asarray(jfa.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b), slope, scale))
    got = tfa.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b), slope, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    shim = tfa.FusedLeakyReLU(torch.from_numpy(b), slope, scale)
    assert torch.equal(shim(torch.from_numpy(x)), got)


# ---------------------------------------------------------------------------
# models/diffusion/layers.py leftovers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["same", "nin_skip", "conv_skip", "no_temb"])
def test_resnet_block_ddpm_matches_jax(case):
    out = 8 if case == "same" or case == "no_temb" else 12
    x, emb = _rand((2, 8, 8, 8), 7), _rand((2, 16), 8)
    temb = case != "no_temb"
    jmod = jl.ResnetBlockDDPM(8, out, temb=temb, conv_shortcut=case == "conv_skip")
    args = (jnp.asarray(x), jnp.asarray(emb) if temb else None)
    params = _params(jmod, *args)
    want = jmod.apply(params, *args)
    tmod = tl.ResnetBlockDDPM(8, out, 16 if temb else None, conv_shortcut=case == "conv_skip")
    tmod.load_state_dict(state_dict_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(nchw(x), torch.from_numpy(emb) if temb else None)
    _close(nhwc(got), want)


@pytest.mark.parametrize("with_conv", [True, False])
@pytest.mark.parametrize("kind", ["up", "down"])
def test_fir_resampling_modules_match_jax(kind, with_conv):
    x = _rand((2, 8, 8, 6), 9)
    jcls, tcls = ((jl.FIRUpsample, tl.FIRUpsample) if kind == "up"
                  else (jl.FIRDownsample, tl.FIRDownsample))
    jmod, tmod = jcls(6, 10, with_conv=with_conv), tcls(6, 10, with_conv=with_conv)
    params = _params(jmod, jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x))
    if with_conv:
        p = params["params"]
        tmod.load_state_dict({"Conv2d_0.weight": torch.from_numpy(
            np.ascontiguousarray(p["weight"].transpose(3, 2, 0, 1))),
            "Conv2d_0.bias": torch.from_numpy(p["bias"])}, strict=True)
    with torch.no_grad():
        _close(nhwc(tmod(nchw(x))), want)


# ---------------------------------------------------------------------------
# The legacy UNet, through the registry (unet_legacy.py, registry.py)
# ---------------------------------------------------------------------------


def legacy_cfg(cls, depth="deep", ngf=32, **model):
    cfg = cls()
    cfg.model.arch = "unet"
    cfg.model.depth = depth
    cfg.model.ngf = ngf
    cfg.data.image_size = 16
    cfg.data.num_frames = 2
    cfg.data.num_frames_cond = 1
    cfg.model.num_classes = 20
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg


def _legacy_pair(depth, ngf, **model):
    jcfg, cfg = legacy_cfg(JConfig, depth, ngf, **model), legacy_cfg(Config, depth, ngf, **model)
    tmodel = treg.create_model(cfg, device="cpu")
    sd = _randomize(tmodel, seed=1, scale=0.08)
    variables = jconv.convert_legacy_unet_state_dict(jcfg, sd)
    return jcfg, cfg, jreg.create_model(jcfg), variables, tmodel


@pytest.mark.parametrize("depth,ngf,version,all_frames", [
    ("deep", 32, "DDPM", False), ("deeper", 8, "DDPM", True), ("deep", 32, "SMLD", False)],
    ids=["deep_ddpm_32_groups", "deeper_narrow_all_frames", "deep_smld"])
def test_legacy_unet_matches_jax(depth, ngf, version, all_frames):
    """Weights carried by tvc.utils.convert.convert_legacy_unet_state_dict,
    models made by both packages' create_model."""
    jcfg, cfg, jmodel, variables, tmodel = _legacy_pair(depth, ngf, version=version,
                                                        output_all_frames=all_frames)
    assert isinstance(tmodel, tleg.UNetSMLD if version == "SMLD" else tleg.UNetDDPM)
    x, cond = _rand((2, 16, 16, 6), 10), _rand((2, 16, 16, 3), 11)
    t = np.array([3, 17], np.int32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    assert got.shape == (2, 16, 16, 6)
    _close(got.numpy(), want)


@pytest.mark.parametrize("version", ["SMLD", "DDPM"])
def test_score_fn_matches_jax(version):
    jcfg, cfg, jmodel, variables, tmodel = _legacy_pair("deep", 8, version=version)
    x, cond = _rand((2, 16, 16, 6), 12), _rand((2, 16, 16, 3), 13)
    t = np.array([0, 19], np.int32)
    want = jax.jit(jreg.get_score_fn(jmodel, variables, jcfg))(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = treg.get_score_fn(tmodel, cfg)(torch.from_numpy(x), torch.from_numpy(t),
                                             torch.from_numpy(cond))
    _close(got.numpy(), want)


@pytest.mark.parametrize("version", ["SMLD", "DDPM"])
def test_legacy_noise_in_cond_matches_jax_on_its_draw(version):
    jcfg, cfg, jmodel, variables, tmodel = _legacy_pair("deep", 8, version=version,
                                                        noise_in_cond=True)
    x, cond = _rand((1, 16, 16, 6), 14), _rand((1, 16, 16, 3), 15)
    t = np.array([7], np.int32)
    draws, normal = [], jax.random.normal

    def recording_normal(*args, **kwargs):
        draws.append(normal(*args, **kwargs))
        return draws[-1]

    with mock.patch.object(jax.random, "normal", recording_normal):
        want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                            rngs={"noise": jax.random.PRNGKey(2)})
    assert len(draws) == 1
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    with torch.no_grad():
        got = tmodel(*args, noise=torch.from_numpy(np.array(draws[0])))
        with pytest.raises(ValueError, match="noise_in_cond"):
            tmodel(*args)
    _close(got.numpy(), want)


def test_registry_dispatch_and_registration():
    cfg = Config()
    assert isinstance(treg.create_model(cfg, device="meta"), UNetMoreDDPM)
    for arch in ("unetmore3d", "unetmorepseudo3d"):
        cfg.model.arch = arch
        assert isinstance(treg.create_model(cfg, device="meta"), UNetMoreDDPM)
    cfg.model.arch = "nope"
    with pytest.raises(ValueError, match="unknown arch"):
        treg.create_model(cfg, device="meta")

    @treg.register_model(name="zoo_test_model")
    def build(cfg, device=None, dtype=None):
        return torch.nn.Identity()

    cfg.model.arch = "zoo_test_model"
    assert isinstance(treg.create_model(cfg, device="meta"), torch.nn.Identity)
    assert treg.get_model("zoo_test_model") is build
    with pytest.raises(ValueError, match="already registered"):
        treg.register_model(build, name="zoo_test_model")
    with pytest.raises(ValueError, match="unknown model"):
        treg.get_model("missing")


# ---------------------------------------------------------------------------
# The norm zoo (normalization.py)
# ---------------------------------------------------------------------------


def _norm_case(name):
    """(JAX module, port module, JAX params from the port's state dict)."""
    if name == "instance":
        t = tnorm.InstanceNorm2d(6)
        return jnorm.InstanceNorm2d(6), t, lambda sd: {"weight": sd["instance_norm.weight"],
                                                       "bias": sd["instance_norm.bias"]}
    if name == "instance_plus":
        return jnorm.InstanceNorm2dPlus(6), tnorm.InstanceNorm2dPlus(6), dict
    if name == "instance_plus_nobias":
        return jnorm.InstanceNorm2dPlus(6, bias=False), tnorm.InstanceNorm2dPlus(6, False), dict
    if name == "variance":
        return jnorm.VarianceNorm2d(6), tnorm.VarianceNorm2d(6), dict
    embed = lambda sd: {"embed": sd["embed.weight"]}  # noqa: E731
    if name == "cond_instance_plus":
        return (jnorm.ConditionalInstanceNorm2dPlus(6, 10),
                tnorm.ConditionalInstanceNorm2dPlus(6, 10), embed)
    if name == "cond_instance_plus_nobias":
        return (jnorm.ConditionalInstanceNorm2dPlus(6, 10, bias=False),
                tnorm.ConditionalInstanceNorm2dPlus(6, 10, bias=False), embed)
    return jnorm.ConditionalVarianceNorm2d(6, 10), tnorm.ConditionalVarianceNorm2d(6, 10), embed


@pytest.mark.parametrize("name", ["instance", "instance_plus", "instance_plus_nobias",
                                  "variance", "cond_instance_plus",
                                  "cond_instance_plus_nobias", "cond_variance"])
def test_norms_match_jax(name):
    jmod, tmod, to_jax = _norm_case(name)
    sd = _randomize(tmod, seed=16)
    x = _rand((2, 5, 5, 6), 17, 2.0) + 0.5
    y = np.array([1, 7])
    cond = name.startswith("cond")
    jargs = (jnp.asarray(x), jnp.asarray(y)) if cond else (jnp.asarray(x),)
    want = jmod.apply({"params": to_jax(sd)}, *jargs)
    with torch.no_grad():
        got = tmod(nchw(x), torch.from_numpy(y)) if cond else tmod(nchw(x))
    _close(nhwc(got), want)


def test_get_normalization_matches_jax():
    for name, cls in (("InstanceNorm", tnorm.InstanceNorm2d),
                      ("InstanceNorm++", tnorm.InstanceNorm2dPlus),
                      ("VarianceNorm", tnorm.VarianceNorm2d)):
        assert type(tnorm.get_normalization(name)(4)) is cls
        assert type(jnorm.get_normalization(name)(4)).__name__ == cls.__name__
    cond = tnorm.get_normalization("InstanceNorm++", conditional=True, num_classes=7)(4)
    assert isinstance(cond, tnorm.ConditionalInstanceNorm2dPlus)
    assert cond.embed.weight.shape == (7, 12)
    for pkg in (tnorm, jnorm):
        with pytest.raises(ValueError):
            pkg.get_normalization("nope")
        with pytest.raises(NotImplementedError):
            pkg.get_normalization("VarianceNorm", conditional=True)


# ---------------------------------------------------------------------------
# NCSNv2 blocks (ncsnv2_blocks.py)
# ---------------------------------------------------------------------------

_NCSN_RULES = [  # the reference's keys -> the JAX package's names
    (re.compile(r"adapt_convs\.(\d+)\."), r"adapt_\1/"),
    (re.compile(r"output_convs\."), "output/"),
    (re.compile(r"(msf|crp)\."), r"\1/"),
    (re.compile(r"(convs|norms)\.(\d+)\."), r"\1_\2/"),
    (re.compile(r"(\d+)_(\d+)_(conv|norm)\."),
     lambda m: f"{m.group(3)}_{int(m.group(1)) - 1}_{int(m.group(2)) - 1}/"),
]


def ncsn_tree(sd):
    """A port NCSNv2 block's state dict as the JAX block's parameter tree."""
    tree = {}
    for key, v in sd.items():
        path = key
        for pat, rep in _NCSN_RULES:
            path = pat.sub(rep, path)
        *mods, leaf = path.split("/")
        if leaf == "weight" and v.ndim == 4:
            mods, leaf, v = mods + ["conv"], "kernel", hwio(v)
        elif leaf == "embed.weight":
            leaf = "embed"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def _cond_norm(nf, name=None, device=None):
    return tnorm.ConditionalInstanceNorm2dPlus(nf, 10, device=device)


def _jcond_norm(nf, name=None):
    return jnorm.ConditionalInstanceNorm2dPlus(nf, 10, name=name)


def _ncsn_case(name):
    """(JAX block, port block, JAX args, port args, the tvc converter's tree or None)."""
    x, x2 = _rand((2, 8, 8, 6), 18), _rand((2, 4, 4, 6), 19)
    y = np.array([2, 9])
    if name == "crp_max":
        return (jnb.CRPBlock(6, 2), tnb.CRPBlock(6, 2), (x,), (nchw(x),),
                lambda sd: jconv.convert_crp_state_dict(sd, 2))
    if name == "crp_avg":
        return (jnb.CRPBlock(6, 3, maxpool=False), tnb.CRPBlock(6, 3, maxpool=False), (x,),
                (nchw(x),), lambda sd: jconv.convert_crp_state_dict(sd, 3))
    if name == "rcu":
        return (jnb.RCUBlock(6, 2, 2), tnb.RCUBlock(6, 2, 2), (x,), (nchw(x),),
                lambda sd: jconv.convert_rcu_state_dict(sd, 2, 2))
    if name == "msf":
        return (jnb.MSFBlock(5, 2), tnb.MSFBlock((6, 6), 5), ([x, x2], (8, 8)),
                ([nchw(x), nchw(x2)], (8, 8)), lambda sd: jconv.convert_msf_state_dict(sd, 2))
    if name == "refine":
        return (jnb.RefineBlock(6, (6, 6)), tnb.RefineBlock((6, 6), 6), ([x, x2], (8, 8)),
                ([nchw(x), nchw(x2)], (8, 8)),
                lambda sd: jconv.convert_refine_state_dict(sd, 2))
    if name == "refine_end_single":
        return (jnb.RefineBlock(6, (6,), end=True), tnb.RefineBlock((6,), 6, end=True),
                ([x], (8, 8)), ([nchw(x)], (8, 8)),
                lambda sd: jconv.convert_refine_state_dict(sd, 1, end=True))
    ty = torch.from_numpy(y)
    if name == "cond_crp":
        return (jnb.CondCRPBlock(6, 2, _jcond_norm), tnb.CondCRPBlock(6, 2, _cond_norm),
                (x, y), (nchw(x), ty), None)
    if name == "cond_rcu":
        return (jnb.CondRCUBlock(6, 2, 2, _jcond_norm), tnb.CondRCUBlock(6, 2, 2, _cond_norm),
                (x, y), (nchw(x), ty), None)
    if name == "cond_msf":
        return (jnb.CondMSFBlock(5, 2, (6, 6), _jcond_norm),
                tnb.CondMSFBlock((6, 6), 5, _cond_norm), ([x, x2], y, (8, 8)),
                ([nchw(x), nchw(x2)], ty, (8, 8)), None)
    return (jnb.CondRefineBlock(6, (6, 6), _jcond_norm), tnb.CondRefineBlock((6, 6), 6, _cond_norm),
            ([x, x2], y, (8, 8)), ([nchw(x), nchw(x2)], ty, (8, 8)), None)


def _jargs(args):
    return [[jnp.asarray(a) for a in v] if isinstance(v, list) else
            (v if isinstance(v, tuple) else jnp.asarray(v)) for v in args]


@pytest.mark.parametrize("name", ["crp_max", "crp_avg", "rcu", "msf", "refine",
                                  "refine_end_single", "cond_crp", "cond_rcu", "cond_msf",
                                  "cond_refine"])
def test_ncsnv2_blocks_match_jax(name):
    jmod, tmod, jargs, targs, converter = _ncsn_case(name)
    sd = _randomize(tmod, seed=20, scale=0.2)
    tree = ncsn_tree(sd)
    if converter is not None:  # the names agree with the JAX package's converter
        want_tree = jax.tree_util.tree_map(np.asarray, converter(sd))
        assert jax.tree_util.tree_structure(want_tree) == jax.tree_util.tree_structure(tree)
    want = jmod.apply({"params": tree}, *_jargs(jargs))
    with torch.no_grad():
        got = tmod(*targs)
    _close(nhwc(got), want)


@pytest.mark.parametrize("shape", [(8, 8), (13, 7), (1, 1)])
def test_bilinear_align_corners_matches_jax(shape):
    x = _rand((2, 5, 6, 3), 21)
    want = jnb.interpolate_bilinear_align_corners(jnp.asarray(x), shape)
    got = tnb.interpolate_bilinear_align_corners(nchw(x), shape)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# ELIC library layers (models/codec/layers.py)
# ---------------------------------------------------------------------------

_SUBPEL = re.compile(r"(^|\.)(subpel_conv|upsample)\.(weight|bias)$")


def _codec_case(name):
    if name.startswith("masked"):
        t = name[-1]
        return jcl.MaskedConv2d(6, mask_type=t), tcl.MaskedConv2d(4, 6, 5, mask_type=t), 4
    if name == "subpel":
        return jcl.SubpelConv3x3(6, 2), tcl.SubpelConv3x3(4, 6, 2), 4
    if name.startswith("gdn"):
        inverse = name == "gdn_inverse"
        return jcl.GDN(4, inverse=inverse), tcl.GDN(4, inverse=inverse), 4
    if name == "res_stride":
        return jcl.ResidualBlockWithStride(6), tcl.ResidualBlockWithStride(4, 6), 4
    if name == "res_stride1_same":
        return jcl.ResidualBlockWithStride(4, stride=1), tcl.ResidualBlockWithStride(4, 4, 1), 4
    if name == "res_upsample":
        return jcl.ResidualBlockUpsample(6), tcl.ResidualBlockUpsample(4, 6), 4
    if name == "res_wider":
        return jcl.ResidualBlock(6), tcl.ResidualBlock(4, 6), 4
    return jcl.ResidualBlock(4), tcl.ResidualBlock(4, 4), 4


@pytest.mark.parametrize("name", ["masked_A", "masked_B", "subpel", "gdn", "gdn_inverse",
                                  "res_stride", "res_stride1_same", "res_upsample", "res_wider",
                                  "res_same"])
def test_codec_library_layers_match_jax(name):
    jmod, tmod, cin = _codec_case(name)
    x = _rand((2, 8, 8, cin), 22)
    params = _params(jmod, jnp.asarray(x), scale=0.3)
    if name.startswith("gdn") or name.startswith("res"):  # GDN's reparametrized positives
        params = jax.tree_util.tree_map(np.abs, params)
    want = jmod.apply(params, jnp.asarray(x))
    p = params["params"]
    if name.startswith("masked"):
        sd = {"weight": np.ascontiguousarray(p["weight"].transpose(3, 2, 0, 1)),
              "bias": p["bias"]}
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    elif name == "subpel":
        sd = {f"0.{k}": v for k, v in state_dict_from_jax(p).items()}
    else:
        sd = {_SUBPEL.sub(r"\1\2.0.\3", k): v for k, v in state_dict_from_jax(p).items()}
        if name == "res_upsample":  # its 3x3 conv is named conv, as the wrapped nn.Conv
            sd = {f"conv.{k}" if k in ("weight", "bias") else k: v for k, v in sd.items()}
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tmod(nchw(x))
    _close(nhwc(got), want)


def test_masked_conv_holds_no_buffer():
    """The mask is made in the forward: a module moved with to_empty keeps it."""
    m = tcl.MaskedConv2d(4, 6, 5, mask_type="B", device="meta").to_empty(device="cpu")
    assert not list(m.buffers())
    with torch.no_grad():
        m.weight.fill_(1.0)
        m.bias.zero_()
        out = m(torch.ones(1, 4, 5, 5))
    assert out[0, 0, 2, 2].item() == 4 * 13  # 12 causal taps and the centre (mask B)
