"""tvc_torch entropy coding against the JAX package's.

Tolerances: none. The CDF tables (``cdf``, ``cdf_length``, ``offset``) of the
Gaussian and factorized coders, the scale indexes and the rANS bytes are
integers and must equal the JAX package's exactly; the port's coder is held
to the JAX package's pure-Python mirror of the stream layout, escapes
included, so the JAX package's native coder is never built here. The
likelihood is float32 on both sides, within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tvc.entropy import cdf as jcdf
from tvc.entropy.factorized import FactorizedCoder as JFactorizedCoder
from tvc.entropy.gaussian import GaussianCoder as JGaussianCoder
from tvc.entropy.gaussian import build_indexes_np as j_build_indexes_np
from tvc.entropy.gaussian import gaussian_likelihood as j_gaussian_likelihood
from tvc.entropy.rans import PyRansDecoder, PyRansEncoder
from tvc_torch.entropy import cdf, rans
from tvc_torch.entropy.factorized import FactorizedCoder, FactorizedEntropy
from tvc_torch.entropy.gaussian import GaussianCoder, build_indexes_np, gaussian_likelihood


def _pmfs(seed, n=40):
    """Skewed pmfs with empty bins: the repair path of the quantizer."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(2, 80)
        p = rng.rand(k) ** rng.randint(1, 40)
        p[rng.rand(k) < 0.3] = 0.0
        p[rng.randint(k)] += 1e-3
        out.append(p / p.sum())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_cdf_matches_jax(seed):
    for p in _pmfs(seed):
        np.testing.assert_array_equal(cdf.pmf_to_quantized_cdf(p), jcdf.pmf_to_quantized_cdf(p))


def test_gaussian_tables_match_jax():
    g, jg = GaussianCoder(), JGaussianCoder()
    for name in ("scale_table", "cdf", "cdf_length", "offset"):
        a, b = getattr(g, name), getattr(jg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _random_bottleneck(seed, channels=16):
    """A FactorizedEntropy with every parameter drawn at random (the init
    leaves the factors at zero and the matrices constant)."""
    rng = np.random.RandomState(seed)
    eb = FactorizedEntropy(channels, device="cpu")
    with torch.no_grad():
        for p in list(eb._matrices) + list(eb._biases) + list(eb._factors):
            p.copy_(torch.tensor(rng.randn(*p.shape) * 0.7, dtype=torch.float32))
        med = rng.randn(channels) * 2
        q = np.stack([med - rng.uniform(2, 12, channels), med, med + rng.uniform(2, 12, channels)])
        eb.quantiles.copy_(torch.tensor(q.T[:, None, :], dtype=torch.float32))
    return eb


def test_factorized_tables_match_jax():
    eb = _random_bottleneck(3)
    fc, jfc = FactorizedCoder.from_module(eb), JFactorizedCoder(eb.host_params())
    for name in ("medians", "cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(fc, name), getattr(jfc, name), err_msg=name)
    np.testing.assert_array_equal(eb.medians().numpy(), eb.quantiles.detach().numpy()[:, 0, 1])


def test_factorized_quantize_matches_jax_and_decode():
    """z_hat and the symbols equal the JAX package's (float64 median, NCHW
    here against NHWC there), and the decoder returns z_hat bit for bit."""
    eb = _random_bottleneck(4)
    fc, jfc = FactorizedCoder.from_module(eb), JFactorizedCoder(eb.host_params())
    z = (np.random.RandomState(5).randn(2, 16, 3, 4) * 8).astype(np.float32)
    z_hat, sym = fc.quantize(z)
    jz_hat, jsym = jfc.quantize(z.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(z_hat, jz_hat.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(sym, jsym.transpose(0, 3, 1, 2))
    strings = fc.compress_symbols(sym)
    assert fc.decompress(strings, (3, 4)).tobytes() == z_hat.tobytes()
    # stream order: (C, H, W) per batch element, as the JAX mirror codes it
    py = PyRansEncoder().encode_with_indexes(sym[1].reshape(-1), fc._indexes(3, 4), fc.cdf,
                                             fc.cdf_length, fc.offset)
    assert strings[1] == py


def test_build_indexes_match_jax():
    table = GaussianCoder().scale_table
    rng = np.random.RandomState(6)
    s = np.concatenate([np.exp(rng.uniform(-4, 7, 5000)), table, np.nextafter(table, 0),
                        np.nextafter(table, np.inf), [0.0, 1e-9, 1e9]]).astype(np.float32)
    idx = build_indexes_np(s, table)
    np.testing.assert_array_equal(idx, j_build_indexes_np(s, table))
    assert idx.min() == 0 and idx.max() == len(table) - 1


def test_gaussian_likelihood_matches_jax():
    rng = np.random.RandomState(7)
    x, mu = rng.randn(3, 64).astype(np.float32) * 4, rng.randn(3, 64).astype(np.float32)
    sc = np.exp(rng.uniform(-4, 4, (3, 64))).astype(np.float32)
    got = gaussian_likelihood(torch.tensor(x), torch.tensor(sc), torch.tensor(mu)).numpy()
    want = np.asarray(j_gaussian_likelihood(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(mu)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _symbols(seed, n, coder):
    """Symbols around each index's centre, a tenth of them far outside the
    table (escapes through the bypass bins, both signs, up to 2^20)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(coder.cdf_length), n).astype(np.int32)
    half = -coder.offset[idx]  # the table's centre bin codes symbol 0
    sym = (rng.randn(n) * half * 0.4).astype(np.int32)
    far = rng.rand(n) < 0.1
    sym[far] = rng.randint(-(1 << 20), 1 << 20, far.sum())
    return sym.astype(np.int32), idx


@pytest.mark.parametrize("seed", [0, 1])
def test_rans_bytes_match_jax_mirror(seed):
    gc = GaussianCoder()
    sym, idx = _symbols(seed, 3000, gc)
    enc = rans.RansEncoder().encode_with_indexes(sym, idx, gc.cdf, gc.cdf_length, gc.offset)
    want = PyRansEncoder().encode_with_indexes(sym, idx, gc.cdf, gc.cdf_length, gc.offset)
    assert enc == want
    dec = rans.RansDecoder().decode_with_indexes(enc, idx, gc.cdf, gc.cdf_length, gc.offset)
    np.testing.assert_array_equal(dec, sym)
    np.testing.assert_array_equal(
        PyRansDecoder().decode_with_indexes(enc, idx, gc.cdf, gc.cdf_length, gc.offset), sym)


def test_rans_batch_streams_are_independent():
    gc = GaussianCoder()
    sym, idx = _symbols(2, 900, gc)
    counts = [0, 300, 600]
    streams = rans.RansEncoder().encode_batch(sym, idx, counts, gc.cdf, gc.cdf_length, gc.offset)
    assert streams[1] == rans.RansEncoder().encode_with_indexes(
        sym[:300], idx[:300], gc.cdf, gc.cdf_length, gc.offset)
    assert len(streams[0]) == 8  # the flushed state alone
    dec = rans.RansDecoder().decode_batch(streams, idx, counts, gc.cdf, gc.cdf_length, gc.offset)
    np.testing.assert_array_equal(dec, sym)


def test_gaussian_coder_roundtrip_is_quantize_dequantize():
    gc = GaussianCoder()
    rng = np.random.RandomState(8)
    y = (rng.randn(2, 4, 6, 3) * 20).astype(np.float32)
    mu = rng.randn(2, 4, 6, 3).astype(np.float32)
    idx = gc.build_indexes(np.exp(rng.uniform(-3, 5, y.shape)).astype(np.float32))
    dec = gc.decompress(gc.compress(y, idx, mu), idx, mu)
    want = np.round(y - mu).astype(np.float32) + mu
    assert dec.tobytes() == want.tobytes()


@pytest.mark.parametrize("bad", [np.nan, np.inf, 3e9])
def test_non_finite_latents_are_refused(bad):
    """A latent that does not cast to an int32 symbol becomes INT_MIN, whose
    escape coding never ends in the rANS coder (seen with the huge means of
    a codec on random weights): both coders refuse it with a ValueError."""
    gc = GaussianCoder()
    y = np.zeros((1, 2, 3, 3), np.float32)
    y[0, 1, 2, 0] = bad
    idx = gc.build_indexes(np.ones_like(y))
    with pytest.raises(ValueError, match="non-finite latents"):
        gc.compress(y, idx, np.zeros_like(y))
    fc = FactorizedCoder.from_module(_random_bottleneck(4))
    z = np.zeros((1, 16, 3, 4), np.float32)
    z[0, 3, 1, 2] = bad
    with pytest.raises(ValueError, match="non-finite latents"):
        fc.quantize(z)


def test_rans_rejects_bad_input():
    gc = GaussianCoder()
    with pytest.raises(ValueError):
        rans.RansEncoder().encode_with_indexes([1, 2], [0, len(gc.cdf)], gc.cdf, gc.cdf_length,
                                               gc.offset)
    with pytest.raises(ValueError):
        rans.RansDecoder().decode_with_indexes(b"\0" * 6, [0], gc.cdf, gc.cdf_length, gc.offset)


def test_rans_build_is_keyed_on_source_and_flags(monkeypatch):
    """The library lands in tvc_torch/build and is rebuilt when the key changes."""
    path = rans.build()
    assert path.parent == rans.BUILD and path.parent.name == "build"
    assert rans.key_path().read_text() == rans.build_key()
    assert not rans._stale()
    monkeypatch.setattr(rans, "CXX_FLAGS", rans.CXX_FLAGS + ["-DTVC_KEY_PROBE"])
    assert rans._stale()
