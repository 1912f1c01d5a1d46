"""tvc_torch attention (plain version and wrapper) against the JAX package's
oracle and its Pallas kernel (interpret mode).

Tolerance: float32 einsum attention in two frameworks, max |diff| <= 2e-5 on
N(0, 1) inputs (the bound tests/test_pallas_attention.py uses).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tvc.ops.pallas_attention import attention_pallas, attention_reference
from tvc_torch.ops import attention as attn_mod
from tvc_torch.ops.attention import attention, attention_plain

SHAPES = [
    (2, 3, 64, 32),    # tests/test_pallas_attention.py
    (1, 4, 64, 192),   # the flagship's 8x8 level: T = 64, d = 192
    (1, 2, 96, 192),   # T not a multiple of the kernel's 32-row tiles
]


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_attention_reference(shape):
    q, k, v = _qkv(shape, 13)
    want = np.asarray(attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape, 7)
    want = np.asarray(attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       interpret=True))
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_plain_bf16_matches_attention_reference():
    """bf16 inputs: f32 softmax, weights rounded to bf16 before the second
    product, bf16 output; within 2 bf16 ulps of magnitude-1 values."""
    q, k, v = _qkv((1, 2, 64, 192), 3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(attention_reference(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * 2.0 ** -8)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 64, 192), 5))
    attn_mod.reset_launches()
    out = attention(q, k, v)
    assert attn_mod.launches == 0
    assert torch.equal(out, attention_plain(q, k, v))


@pytest.mark.parametrize("case", ["float64", "float16", "3d", "head_dim", "mismatch",
                                  "strided", "meta"])
def test_wrapper_rejects_bad_input(case):
    q = torch.randn(1, 2, 16, 8)
    k, v = q.clone(), q.clone()
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "3d":
        q, k, v = q[0], k[0], v[0]
    elif case == "head_dim":
        q = k = v = torch.randn(1, 1, 16, 257)
    elif case == "mismatch":
        k = torch.randn(1, 2, 8, 8)
    elif case == "strided":
        q = torch.randn(1, 2, 8, 16).transpose(2, 3)
    elif case == "meta":
        q, k, v = (x.to("meta") for x in (q, k, v))
    with pytest.raises((TypeError, ValueError)):
        attention(q, k, v)
