"""tvc_torch's bfloat16 throughput path against the JAX package's, and the
exact equalities it keeps within itself.

Tolerances:
- One layer in bfloat16 against the JAX layer at ``dtype=bfloat16``, both on
  the same bf16 input: max |diff| <= 4 bf16 ulps at the output's magnitude,
  2^-6 x max |want| (bf16 keeps 8 mantissa bits, 2^-8 = 3.9e-3 relative; the
  two frameworks round at other places: cuDNN and oneDNN add a conv's bias
  before rounding once, XLA rounds the product, then the sum).
- One UNet call in bfloat16 (the port against the JAX package, and the
  port's bf16 against its own float32): max rel <= 0.10 and mean rel <= 0.02,
  the bounds of tests/test_bf16_drift.py (depth amplifies the bf16 rounding).
- The sampler with ``eps_fn_hi`` on closed-form eps functions: float32
  arithmetic of the same steps, max |diff| <= 1e-5 (tests/test_torch_sampler.py).
- The port against itself: bit for bit (bf16-stored weights and float32
  masters at bf16 compute; ``f32:K`` with K >= L + 1 and the float32 run;
  ``f32:0`` and uniform bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.models.diffusion import layers as jl
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.pipeline.predictor import FramePredictor as JFramePredictor
from tvc.samplers.ancestral import ddim_sampler as j_ddim_sampler
from tvc.samplers.ancestral import ddpm_sampler as j_ddpm_sampler
from tvc.samplers.schedules import Schedule as JSchedule
from tvc_torch.core.config import Config
from tvc_torch.core.runtime import numerics_stamp
from tvc_torch.models.diffusion import layers as tl
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.samplers.ancestral import ddpm_sampler
from tvc_torch.samplers.schedules import Schedule
from tvc_torch.utils.convert import state_dict_from_jax, unet_from_jax

from test_torch_ncsnpp import flagship_shaped_cfg, random_variables, tiny_cfg
from test_torch_sampler import jax_step_noise

BF16 = torch.bfloat16
LAYER_TOL = 2.0 ** -6      # 4 bf16 ulps at the output's magnitude
UNET_MAX_REL, UNET_MEAN_REL = 0.10, 0.02



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the tier-1 run shares the host's
    cores among its workers, and an oversubscribed OpenMP pool made one tiny
    UNet call 10-100x slower on an 8-core host (0.03 s alone, 0.36 s on one
    thread under load, 5-7 s on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _bf16_input(shape, seed=0):
    """N(0.5, 2) values already on the bf16 grid, so both frameworks read the same input."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2 + 0.5
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _run_layer(jmod, tmod, x, *extra, seed=3, scale=0.3):
    """(port output as NHWC float64, JAX output float64): the JAX layer
    initialised at random, its parameters carried into the port's layer."""
    jx = jnp.asarray(x, jnp.bfloat16)
    jextra = [jnp.asarray(e, jnp.bfloat16) for e in extra]
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jx, *jextra)
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), shapes)
    want = np.asarray(jmod.apply(params, jx, *jextra).astype(jnp.float32), np.float64)
    if params:
        tmod.load_state_dict(state_dict_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(BF16),
                   *[torch.from_numpy(e).to(BF16) for e in extra])
    assert got.dtype == BF16
    return got.double().numpy().transpose(0, 2, 3, 1), want


def _close(got, want, tol=LAYER_TOL):
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, want, atol=tol * scale)


@pytest.mark.parametrize("k", [3, 1])
def test_ddpm_conv_bf16_matches_jax(k):
    got, want = _run_layer(jl.DDPMConv(24, k, dtype=jnp.bfloat16),
                           tl.DDPMConv(16, 24, k, dtype=BF16), _bf16_input((2, 8, 8, 16)))
    _close(got, want)


def test_nin_bf16_matches_jax():
    x = _bf16_input((2, 8, 8, 16))
    jmod = jl.NIN(24, dtype=jnp.bfloat16)
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32),
                                    jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                                   jnp.asarray(x, jnp.bfloat16)))
    want = np.asarray(jmod.apply(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tmod = tl.NIN(16, 24, dtype=BF16)
    tmod.load_state_dict(state_dict_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    _close(got.double().numpy(), want)


@pytest.mark.parametrize("bf16_io", ["0", "1"], ids=["f32_io", "bf16_io"])
@pytest.mark.parametrize("affine", [True, False])
def test_groupnorm_bf16_matches_jax(bf16_io, affine, monkeypatch):
    """Both TVC_GN_BF16_IO modes: statistics in float32 either way."""
    monkeypatch.setenv("TVC_GN_BF16_IO", bf16_io)
    got, want = _run_layer(jl.GroupNormRef(ch=32, eps=1e-5, use_affine=affine,
                                           dtype=jnp.bfloat16),
                           tl.GroupNormRef(32, eps=1e-5, affine=affine, dtype=BF16),
                           _bf16_input((2, 6, 6, 32)), scale=1.0)
    _close(got, want)


def test_gn_bf16_io_leaves_float32_untouched(monkeypatch):
    """The flag applies to a non-float32 compute dtype only, as in the JAX package."""
    x = torch.from_numpy(_bf16_input((2, 32, 6, 6)))
    gn = tl.GroupNormRef(32)
    with torch.no_grad():
        monkeypatch.setenv("TVC_GN_BF16_IO", "0")
        off = gn(x)
        monkeypatch.setenv("TVC_GN_BF16_IO", "1")
        on = gn(x)
    assert off.dtype == on.dtype == torch.float32 and torch.equal(off, on)


@pytest.mark.parametrize("with_emb", [True, False])
def test_get_act_norm_bf16_matches_jax(with_emb):
    x = _bf16_input((2, 6, 6, 32))
    if with_emb:
        got, want = _run_layer(jl.GetActNorm(ch=32, emb=True, dtype=jnp.bfloat16),
                               tl.GetActNorm(32, 40, dtype=BF16), x, _bf16_input((2, 40), 1))
    else:
        got, want = _run_layer(jl.GetActNorm(ch=32, emb=False, dtype=jnp.bfloat16),
                               tl.GetActNorm(32, None, dtype=BF16), x)
    _close(got, want)


@pytest.mark.parametrize("c,n_head_channels,hw", [(16, 8, 8), (32, -1, 4)])
def test_attn_block_bf16_matches_jax(c, n_head_channels, hw):
    """The port's plain attention (P rounded to bf16 before p.v) against the
    JAX block's default einsum backend, which rounds P the same way."""
    got, want = _run_layer(jl.AttnBlockpp(channels=c, init_scale=0.0,
                                          n_head_channels=n_head_channels, dtype=jnp.bfloat16),
                           tl.AttnBlockpp(c, init_scale=0.0, n_head_channels=n_head_channels,
                                          dtype=BF16),
                           _bf16_input((2, hw, hw, c)))
    _close(got, want)


@pytest.mark.parametrize("mode", ["plain", "up", "down", "channels"])
def test_resnet_block_biggan_bf16_matches_jax(mode):
    in_ch, out_ch = (16, 24) if mode == "channels" else (16, 16)
    kw = {"up": mode == "up", "down": mode == "down"}
    got, want = _run_layer(
        jl.ResnetBlockBigGAN(in_ch=in_ch, out_ch=out_ch, temb=True, init_scale=0.0,
                             dtype=jnp.bfloat16, **kw),
        tl.ResnetBlockBigGAN(in_ch, out_ch, 40, init_scale=0.0, dtype=BF16, **kw),
        _bf16_input((2, 8, 8, in_ch)), _bf16_input((2, 40), 1), scale=0.2)
    _close(got, want)


def _rel(got, want):
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean()


@pytest.mark.parametrize("cfg_fn", [tiny_cfg, flagship_shaped_cfg],
                         ids=["tiny", "flagship_shaped"])
def test_unet_bf16_call_matches_jax(cfg_fn):
    """One UNet call in bf16 against the JAX package's and against the port's
    float32, on the same weights and inputs."""
    jcfg, cfg = cfg_fn(JConfig), cfg_fn(Config)
    rng = np.random.RandomState(1)
    size, c = cfg.data.image_size, cfg.data.channels
    x = rng.randn(2, size, size, c * cfg.data.num_frames).astype(np.float32)
    cond = rng.randn(2, size, size, c * cfg.data.num_frames_cond).astype(np.float32)
    t = np.array([3, 777], np.int32) % cfg.model.num_classes
    variables = random_variables(JUNetMoreDDPM(cfg=jcfg).init, jnp.asarray(x[:1]),
                                 jnp.zeros((1,), jnp.int32), jnp.asarray(cond[:1]), seed=42)
    jmodel = JUNetMoreDDPM(cfg=jcfg, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x, jnp.bfloat16),
                                            jnp.asarray(t), jnp.asarray(cond, jnp.bfloat16))
                      .astype(jnp.float32), np.float64)

    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    model16 = model.with_dtype(BF16)
    args = (torch.from_numpy(t).long(),)
    with torch.no_grad():
        got = model16(torch.from_numpy(x).to(BF16), *args, torch.from_numpy(cond).to(BF16))
        f32 = model(torch.from_numpy(x), *args, torch.from_numpy(cond)).double().numpy()
    assert got.dtype == BF16
    got = got.double().numpy()
    assert np.abs(want).max() > 1e-2
    for a, b in ((got, want), (got, f32)):
        max_rel, mean_rel = _rel(a, b)
        assert max_rel <= UNET_MAX_REL and mean_rel <= UNET_MEAN_REL, (max_rel, mean_rel)


def test_with_dtype_shares_the_parameters():
    """The f32:K twin runs over the same storage: no second copy of the weights."""
    model = UNetMoreDDPM(tiny_cfg(Config), device="cpu")
    twin = model.with_dtype(BF16)
    assert twin.dtype == BF16 and model.dtype == torch.float32
    pairs = list(zip(model.parameters(), twin.parameters()))
    assert pairs and all(a.data_ptr() == b.data_ptr() for a, b in pairs)
    with torch.no_grad():
        model.unet.all_modules[0].weight.add_(1.0)
    assert torch.equal(model.unet.all_modules[0].weight, twin.unet.all_modules[0].weight)


def _predictor_cfg(schedule=""):
    cfg = tiny_cfg(Config)
    cfg.sampling.subsample = 4  # 4 steps + denoise: L + 1 = 5 UNet calls
    cfg.sampling.precision_schedule = schedule
    return cfg


@pytest.fixture(scope="module")
def tiny_unet():
    cfg = tiny_cfg(Config)
    variables = random_variables(JUNetMoreDDPM(cfg=tiny_cfg(JConfig)).init,
                                 jnp.zeros((1, 64, 64, 9)), jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, 64, 64, 6)), seed=42)
    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    return model


def _generate(pred, seed=5):
    cond = np.random.RandomState(3).rand(1, 64, 64, 6).astype(np.float32)
    return pred.generate(cond, generator=torch.Generator().manual_seed(seed))


def test_bf16_stored_weights_equal_f32_masters(tiny_unet):
    cfg = _predictor_cfg()
    masters = FramePredictor(cfg, tiny_unet, dtype=BF16)
    stored = FramePredictor(cfg, tiny_unet, dtype=BF16, params_dtype=BF16)
    assert all(p.dtype == BF16 for p in stored.model.parameters())
    assert all(p.dtype == torch.float32 for p in masters.model.parameters())
    assert all(p.dtype == torch.float32 for p in tiny_unet.parameters())  # left as it was
    a, b = _generate(masters), _generate(stored)
    assert a.dtype == b.dtype == torch.float32
    assert torch.isfinite(a).all() and a.std() > 0.01
    assert torch.equal(a, b)


def test_precision_schedule_covering_every_step_is_the_f32_run(tiny_unet):
    """f32:K with K >= L + 1 = 5 is the all-float32 run, bit for bit."""
    pred = FramePredictor(_predictor_cfg(), tiny_unet)
    assert pred.n_steps == 5
    f32 = _generate(pred)
    for k in (5, 9):
        mixed = FramePredictor(_predictor_cfg(f"f32:{k}"), tiny_unet, dtype=BF16)
        assert mixed.carry_dtype == torch.float32 and mixed.model_hi.dtype == torch.float32
        assert torch.equal(_generate(mixed), f32)


def test_precision_schedule_of_zero_is_uniform_bf16(tiny_unet):
    uniform = FramePredictor(_predictor_cfg(), tiny_unet, dtype=BF16)
    zero = FramePredictor(_predictor_cfg("f32:0"), tiny_unet, dtype=BF16)
    assert zero.model_hi is None and zero.carry_dtype == BF16
    bf16 = _generate(uniform)
    assert torch.equal(_generate(zero), bf16)
    assert not torch.equal(bf16, _generate(FramePredictor(_predictor_cfg(), tiny_unet)))


def test_bf16_carry_and_f32_update(tiny_unet):
    """A bf16 predictor carries bf16 between steps and hands the UNet bf16
    frames; under f32:K the first K calls go to the float32 twin with a
    float32 carry."""
    seen = []

    def spy(model):
        def fn(x, labels, cond):
            seen.append((model.dtype, x.dtype, cond.dtype))
            return model(x, labels, cond)
        return fn

    pred = FramePredictor(_predictor_cfg("f32:2"), tiny_unet, dtype=BF16)
    pred.eps_fn, pred.eps_fn_hi = spy(pred.model), spy(pred.model_hi)
    _generate(pred)
    f32 = torch.float32
    assert seen == [(f32, f32, f32)] * 2 + [(BF16, f32, f32)] * 3
    seen.clear()
    pred = FramePredictor(_predictor_cfg(), tiny_unet, dtype=BF16)
    pred.eps_fn = spy(pred.model)
    _generate(pred)
    assert seen == [(BF16, BF16, BF16)] * 5


@pytest.mark.parametrize("version", ["DDIM", "FPNDM"])
def test_bf16_carry_other_samplers(tiny_unet, version):
    cfg = _predictor_cfg()
    cfg.model.version = version
    out = _generate(FramePredictor(cfg, tiny_unet, dtype=BF16))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert 0.0 <= out.min() and out.max() <= 1.0


def _eps_jax_hi(x, labels, cond):
    return jnp.sin(0.5 * x) + 0.2 * jnp.mean(cond, axis=-1, keepdims=True)


def _eps_torch_hi(x, labels, cond):
    return torch.sin(0.5 * x) + 0.2 * cond.mean(dim=-1, keepdim=True)


@pytest.mark.parametrize("hi_steps", [1, 3, 6])
def test_ddpm_sampler_hi_steps_matches_jax(hi_steps):
    """The two-scan schedule of ``ddpm_sampler(eps_fn_hi=, hi_steps=)`` with
    JAX's draws; 6 = L + 1 runs every step through ``eps_fn_hi``."""
    from test_torch_sampler import _eps_jax, _eps_torch

    jcfg, cfg = tiny_cfg(JConfig), tiny_cfg(Config)
    sub = JSchedule.from_config(jcfg).subsample(jcfg.sampling.subsample)
    rng = np.random.RandomState(0)
    x_init = rng.randn(2, 8, 8, 9).astype(np.float32)
    cond = rng.rand(2, 8, 8, 6).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(7)
    want = np.asarray(j_ddpm_sampler(key, jnp.asarray(x_init), _eps_jax, sub,
                                     cond=jnp.asarray(cond), eps_fn_hi=_eps_jax_hi,
                                     hi_steps=hi_steps))
    noise = jax_step_noise(key, len(sub) + 1, x_init.shape)
    tsub = Schedule.from_config(cfg).subsample(cfg.sampling.subsample)
    got = ddpm_sampler(torch.from_numpy(x_init), _eps_torch, tsub, cond=torch.from_numpy(cond),
                       noise=torch.tensor(noise), eps_fn_hi=_eps_torch_hi,
                       hi_steps=hi_steps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    base = ddpm_sampler(torch.from_numpy(x_init), _eps_torch, tsub, cond=torch.from_numpy(cond),
                        noise=torch.tensor(noise)).numpy()
    assert np.abs(got - base).max() > 1e-3  # eps_fn_hi was called


def _randomize_like_jax(shapes, seed=3, scale=0.08):
    """tests/test_bf16_drift.py's ``_randomize`` over the init's shapes."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * scale).astype(s.dtype), shapes)


def test_precision_schedule_endpoint_distance_shrinks_with_k():
    """tests/test_bf16_drift.py::test_mixed_precision_schedule_endpoints on the
    port, with that test's weights, conditioning and JAX's draws: the
    endpoint's distance to the float32 run at K = 5 is at most K = 2's."""
    jcfg, cfg = flagship_shaped_cfg(JConfig), flagship_shaped_cfg(Config)
    for c in (jcfg, cfg):
        c.model.num_classes = 100
        c.sampling.subsample = 10
    size = cfg.data.image_size
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(5),
                            jnp.zeros((1, size, size, 15)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, size, size, 6)))
    variables = _randomize_like_jax(shapes)
    model = UNetMoreDDPM(cfg, device="cpu")
    model.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    cond = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (1, size, size, 6)))
    knoise, ksamp = jax.random.split(jax.random.PRNGKey(0))
    shape = (1, size, size, 15)
    x_init = torch.tensor(np.asarray(jax.random.normal(knoise, shape, jnp.float32)))
    noise = torch.tensor(jax_step_noise(ksamp, 11, shape))
    f32 = FramePredictor(cfg, model).generate(cond, x_init=x_init, noise=noise).double()

    def mixed(k):
        cfg.sampling.precision_schedule = f"f32:{k}"
        pred = FramePredictor(cfg, model, dtype=BF16)
        return pred.generate(cond, x_init=x_init, noise=noise).double()

    assert torch.equal(mixed(11), f32)
    d = {k: (mixed(k) - f32).abs().mean().item() for k in (2, 5)}
    assert all(np.isfinite(v) for v in d.values())
    assert d[5] <= d[2] + 1e-6, d


def _refusal(pkg, schedule="", dtype="f32", params_dtype=None, version="DDPM",
             embedding="positional"):
    cfg = tiny_cfg(JConfig if pkg == "jax" else Config)
    cfg.sampling.precision_schedule = schedule
    cfg.model.version = version
    cfg.model.embedding_type = embedding
    types = {"jax": {"f32": jnp.float32, "bf16": jnp.bfloat16},
             "torch": {"f32": torch.float32, "bf16": BF16}}[pkg]
    pd = None if params_dtype is None else types[params_dtype]
    if pkg == "jax":
        return JFramePredictor(cfg, {}, dtype=types[dtype], params_dtype=pd)
    return FramePredictor.create(cfg, device="cpu", dtype=types[dtype], params_dtype=pd)


@pytest.mark.parametrize("kw", [
    {"schedule": "bf16:3", "dtype": "bf16"},
    {"schedule": "f32:x", "dtype": "bf16"},
    {"schedule": "f32:3", "dtype": "bf16", "params_dtype": "bf16"},
    {"schedule": "f32:3", "dtype": "f32", "params_dtype": "bf16"},
    {"schedule": "f32:3", "dtype": "bf16", "version": "DDIM"},
    {"schedule": "f32:3", "dtype": "bf16", "version": "FPNDM"},
    {"embedding": "fourier"},
], ids=["not_f32", "not_an_int", "stored_bf16", "stored_bf16_f32_compute", "ddim", "fpndm",
        "fourier"])
def test_refusals_match_jax(kw):
    with pytest.raises(Exception) as jerr:
        _refusal("jax", **kw)
    with pytest.raises(Exception) as terr:
        _refusal("torch", **kw)
    assert type(terr.value) is type(jerr.value), (terr.value, jerr.value)


@pytest.mark.parametrize("version", ["DDPM", "DDIM"])
def test_bf16_warm_start_refused_as_jax_fails(version):
    """A bf16 carry with the init_prev_t warm start: the JAX package's sampler
    scan raises a TypeError (its warm start promotes the carry to float32);
    the port refuses the predictor with the same type. Under f32:K the carry
    is float32 and both run."""
    jcfg = tiny_cfg(JConfig)
    sub = JSchedule.from_config(jcfg).subsample(jcfg.sampling.subsample)
    sampler = {"DDPM": j_ddpm_sampler, "DDIM": j_ddim_sampler}[version]
    with pytest.raises(TypeError):
        sampler(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3), jnp.bfloat16),
                lambda x, labels, cond: jnp.tanh(x), sub, t_min=0.5)
    cfg = tiny_cfg(Config)
    cfg.model.version = version
    cfg.sampling.init_prev_t = 0.5
    with pytest.raises(TypeError):
        FramePredictor.create(cfg, device="cpu", dtype=BF16)
    FramePredictor.create(cfg, device="cpu")
    if version == "DDPM":
        cfg.sampling.precision_schedule = "f32:2"
        assert FramePredictor.create(cfg, device="cpu", dtype=BF16).carry_dtype == torch.float32


def test_accepted_precision_settings_build():
    """What the JAX package accepts, the port builds: f32:K under DDPM in
    bf16, f32:K at f32 compute (a no-op there), bf16-stored weights alone."""
    for kw in ({"schedule": "f32:3", "dtype": "bf16"}, {"schedule": "f32:3"},
               {"dtype": "bf16", "params_dtype": "bf16"}, {"schedule": "f32:3", "version": "DDIM"}):
        pred = _refusal("torch", **kw)
        twin = kw.get("dtype") == "bf16" and "schedule" in kw
        assert (pred.model_hi is not None) == twin


def test_numerics_stamp_names_the_precision(monkeypatch):
    """A payload made in one precision mode is refused by a receiver in another."""
    cfg = tiny_cfg(Config)
    base = numerics_stamp("cpu", cfg)
    assert base["compute_dtype"] == "float32" and base["sampling.precision_schedule"] == ""
    assert numerics_stamp("cpu", cfg, compute_dtype=BF16)["compute_dtype"] == "bfloat16"
    cfg.sampling.precision_schedule = "f32:10"
    assert numerics_stamp("cpu", cfg)["sampling.precision_schedule"] == "f32:10"
    monkeypatch.setenv("TVC_GN_BF16_IO", "1")
    assert numerics_stamp("cpu", cfg)["env_gn_bf16_io"] != base["env_gn_bf16_io"]
