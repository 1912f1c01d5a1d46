"""tvc_torch NCSN++ layers against the JAX package, with weights carried by
``tvc_torch.utils.convert.state_dict_from_jax``.

The port's layers are NCHW inside the UNet; the JAX layers are NHWC, so the
tests transpose at the boundary. Tolerance: float32, max |diff| <= 1e-5 x
max |output| for one layer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.models.diffusion import layers as jl
from tvc_torch.models.diffusion import layers as tl
from tvc_torch.utils.convert import state_dict_from_jax


def random_params(module, *args, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), shapes)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(got_nchw, want_nhwc, rel=1e-5):
    want = np.asarray(want_nhwc)
    got = got_nchw.detach().numpy().transpose(0, 2, 3, 1)
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, want, atol=rel * scale)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2 + 0.5


def run_both(jmod, tmod, x, *extra, seed=3):
    """Init ``jmod`` at random, carry its params into ``tmod``, return both outputs."""
    jx = jnp.asarray(x)
    jextra = [jnp.asarray(e) for e in extra]
    params = random_params(jmod, jx, *jextra, seed=seed)
    want = jmod.apply(params, jx, *jextra)
    if params:
        tmod.load_state_dict(state_dict_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(nchw(x), *[torch.from_numpy(e) for e in extra])
    return got, want


@pytest.mark.parametrize("ch", [1, 6, 16, 24, 96, 384])
def test_num_groups_for_matches_jax(ch):
    assert tl.num_groups_for(ch) == jl.num_groups_for(ch)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 3, 99, 777], np.int32)
    for dim in (16, 17):
        want = np.asarray(jl.get_timestep_embedding(jnp.asarray(t), dim))
        got = tl.get_timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_groupnorm_matches_jax(eps):
    x = _x((2, 8, 8, 24))
    got, want = run_both(jl.GroupNormRef(ch=24, eps=eps), tl.GroupNormRef(24, eps=eps), x)
    close(got, want)


@pytest.mark.parametrize("with_emb", [False, True], ids=["affine", "emb"])
def test_get_act_norm_matches_jax(with_emb):
    x = _x((2, 8, 8, 16))
    if with_emb:
        emb = _x((2, 32), seed=1)
        got, want = run_both(jl.GetActNorm(ch=16, emb=True), tl.GetActNorm(16, 32), x, emb)
    else:
        got, want = run_both(jl.GetActNorm(ch=16), tl.GetActNorm(16, None), x)
    close(got, want)


@pytest.mark.parametrize("c,n_head_channels,hw", [(16, 8, 8), (24, 8, 4), (12, -1, 8)],
                         ids=["2heads", "3heads", "1head"])
def test_attn_block_matches_jax(c, n_head_channels, hw):
    x = _x((2, hw, hw, c))
    jm = jl.AttnBlockpp(channels=c, n_head_channels=n_head_channels)
    tm = tl.AttnBlockpp(c, n_head_channels=n_head_channels)
    got, want = run_both(jm, tm, x)
    close(got, want)


@pytest.mark.parametrize("mode", ["plain", "up", "down", "channels"])
def test_resnet_block_biggan_matches_jax(mode):
    in_ch, out_ch = (16, 24) if mode == "channels" else (16, 16)
    up, down = mode == "up", mode == "down"
    x = _x((2, 8, 8, in_ch))
    temb = _x((2, 32), seed=1)
    jm = jl.ResnetBlockBigGAN(in_ch=in_ch, out_ch=out_ch, up=up, down=down)
    tm = tl.ResnetBlockBigGAN(in_ch, out_ch, 32, up=up, down=down)
    got, want = run_both(jm, tm, x, temb)
    assert got.shape[1] == out_ch
    close(got, want)


def test_resnet_block_without_temb_matches_jax():
    x = _x((2, 8, 8, 16))
    jm = jl.ResnetBlockBigGAN(in_ch=16, out_ch=16, temb=False)
    tm = tl.ResnetBlockBigGAN(16, 16, None)
    got, want = run_both(jm, tm, x)
    close(got, want)


def test_default_init_statistics():
    """The DDPM init: uniform with variance scale / fan_avg, drawn from the generator."""
    w = torch.empty(256, 128, 3, 3)
    tl.default_init_(w, 1.0, torch.Generator().manual_seed(0))
    fan_avg = (128 * 9 + 256 * 9) / 2
    bound = np.sqrt(3.0 / fan_avg)
    assert w.abs().max() <= bound
    np.testing.assert_allclose(w.var().item(), 1.0 / fan_avg, rtol=0.02)
    w2 = torch.empty_like(w)
    tl.default_init_(w2, 1.0, torch.Generator().manual_seed(0))
    assert torch.equal(w, w2)
