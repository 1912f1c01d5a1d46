"""tvc_torch attention (plain version and wrapper) against the JAX package's
oracle and its Pallas kernel (interpret mode), and the kernel's launch plan.

Tolerance: float32 einsum attention in two frameworks, max |diff| <= 2e-5 on
N(0, 1) inputs (the bound tests/test_pallas_attention.py uses).
"""

import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tvc.ops.pallas_attention import attention_pallas, attention_reference
from tvc_torch.ops import attention as attn_mod
from tvc_torch.ops.attention import (KEY_TILE, MAX_SPLITS, QUERY_TILE, TC_KEY_TILE,
                                     TC_MAX_BLOCKS, attention, attention_plain, attention_plan)

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


# the flagship levels at B = 1 and 8, ragged T (33, 100, 1000, 1023) and tiny heads
PLAN_SHAPES = [(1, 2, 1024, 192), (1, 3, 256, 192), (1, 4, 64, 192), (8, 2, 1024, 192),
               (8, 3, 256, 192), (8, 4, 64, 192), (1, 2, 33, 192), (2, 3, 100, 192),
               (1, 2, 1000, 192), (1, 2, 1023, 192), (1, 1, 1, 8), (3, 5, 77, 30)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_key_once(shape, dtype):
    """Block s of a cluster takes keys [s * kps, min(t, (s + 1) * kps)): the
    ranges must tile [0, t) with none empty, in whole key tiles."""
    b, h, t, d = shape
    plan = attention_plan(b, h, t, d, dtype)
    assert 1 <= plan.splits <= MAX_SPLITS
    assert plan.keys_per_split > 0 and plan.keys_per_split % KEY_TILE == 0
    seen = np.zeros(t, np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.keys_per_split, min(t, (s + 1) * plan.keys_per_split)
        assert lo < hi, f"split {s} of {plan} is empty"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.blocks == b * h * math.ceil(t / QUERY_TILE) * plan.splits


def test_plan_depends_on_shape_and_dtype_alone(monkeypatch):
    """The plan fixes the order of the kernel's sums, so a sender and a receiver
    must get the same plan whatever card they run on: it reads no device."""
    assert list(inspect.signature(attention_plan).parameters) == ["b", "h", "t", "d", "dtype"]
    want = [attention_plan(*s, torch.float32) for s in PLAN_SHAPES]
    want16 = [attention_plan(*s, torch.bfloat16) for s in PLAN_SHAPES]

    def no_device(*args, **kwargs):
        raise AssertionError("attention_plan queried the device")

    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    attention_plan.cache_clear()  # compute the plans again under the patch
    assert [attention_plan(*s, torch.float32) for s in PLAN_SHAPES] == want
    assert [attention_plan(*s, torch.bfloat16) for s in PLAN_SHAPES] == want16


@pytest.mark.parametrize("shape,splits,blocks", [
    ((1, 2, 1024, 192), 3, 96),  # 32x32: 16 query tiles x 2 heads x 3 splits of 352 keys
    ((1, 3, 256, 192), 8, 96),   # 16x16: 4 x 3 x 8 splits of one 32-key tile
    ((1, 4, 64, 192), 2, 8),     # 8x8: 1 x 4 x 2 splits of one tile
], ids=["32x32", "16x16", "8x8"])
def test_plan_flagship_block_counts(shape, splits, blocks):
    plan = attention_plan(*shape, torch.float32)
    assert (plan.splits, plan.blocks) == (splits, blocks)


# the bf16 paths' shapes: the flagship levels at every batch a path predicts
# at, and the 3-D nets' frames folded into the batch (b = 7 and 5)
BF16_PLAN_SHAPES = PLAN_SHAPES + [(b, h, t, 192) for b in (2, 4, 5, 7)
                                  for h, t in ((2, 1024), (3, 256), (4, 64))]


@pytest.mark.parametrize("shape", BF16_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_plan_covers_every_key_once_in_whole_bf16_tiles(shape):
    """The bf16 kernel's plan: its 64-key tiles, whole, each key in one split,
    none empty, and no more blocks than fit in one wave unless one split a
    query tile already exceeds it."""
    b, h, t, d = shape
    plan = attention_plan(b, h, t, d, torch.bfloat16)
    assert 1 <= plan.splits <= MAX_SPLITS
    assert plan.keys_per_split > 0 and plan.keys_per_split % TC_KEY_TILE == 0
    seen = np.zeros(t, np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.keys_per_split, min(t, (s + 1) * plan.keys_per_split)
        assert lo < hi, f"split {s} of {plan} is empty"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    groups = b * h * math.ceil(t / QUERY_TILE)
    assert plan.blocks == groups * plan.splits
    assert plan.blocks <= max(TC_MAX_BLOCKS, groups)


@pytest.mark.parametrize("shape,splits,blocks", [
    ((1, 2, 1024, 192), 6, 192),  # 32x32: 16 query tiles x 2 heads x 6 splits of 192 keys
    ((1, 3, 256, 192), 4, 48),    # 16x16: 4 x 3 x 4 splits of one 64-key tile
    ((1, 4, 64, 192), 1, 4),      # 8x8: one tile, no split
    ((8, 2, 1024, 192), 1, 256),
    ((8, 3, 256, 192), 2, 192),
    ((8, 4, 64, 192), 1, 32),
], ids=["32x32", "16x16", "8x8", "32x32-B8", "16x16-B8", "8x8-B8"])
def test_bf16_plan_flagship_block_counts(shape, splits, blocks):
    plan = attention_plan(*shape, torch.bfloat16)
    assert (plan.splits, plan.blocks) == (splits, blocks)


@pytest.mark.parametrize("shape", [(1, 2, 64, 192), (2, 3, 33, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wrapper_takes_strided_heads_on_cpu(shape):
    """q, k, v as the attention block passes them: (B, H, T, d) views of
    (B, T, H * d) projections, not contiguous."""
    b, h, t, d = shape
    rng = np.random.RandomState(11)
    x = [rng.randn(b, t, h * d).astype(np.float32) for _ in range(3)]
    views = [torch.from_numpy(a).view(b, t, h, d).transpose(1, 2) for a in x]
    assert not any(v.is_contiguous() for v in views)
    heads = [np.ascontiguousarray(a.reshape(b, t, h, d).transpose(0, 2, 1, 3)) for a in x]
    want = np.asarray(attention_reference(*map(jnp.asarray, heads)))
    got = attention(*views)
    assert got.shape == (b, h, t, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_wrapper_rejects_transposed_head_dim():
    q, k, v = (torch.randn(1, 2, 192, 64).transpose(2, 3) for _ in range(3))  # (1, 2, 64, 192)
    with pytest.raises(ValueError, match="unit stride"):
        attention(q, k, v)


@pytest.mark.parametrize("case", ["aligned", "head_dim", "offset", "row_stride"])
def test_bf16_kernel_operands_are_16_byte_rows(case):
    """What the bf16 kernel reads: a view already in whole 16-byte chunks
    passes as it is; a head dim that is not a multiple of 8 is padded with
    zeros; an unaligned base or stride is copied. Values never change."""
    base = torch.randn(2, 40, 3 * 64).bfloat16()
    x = base.view(2, 40, 3, 64).transpose(1, 2)  # strided heads, d = 64
    if case == "head_dim":
        x = torch.randn(2, 3, 40, 30).bfloat16()
    elif case == "offset":
        x = torch.randn(2 * 3 * 40 * 64 + 1).bfloat16()[1:].view(2, 3, 40, 64)
    elif case == "row_stride":
        x = torch.randn(2, 3, 40, 68).bfloat16()[..., :64]
    dq = -(-x.shape[-1] // 8) * 8
    y = attn_mod._tc_operand(x, dq)
    assert y.shape == x.shape[:-1] + (dq,) and y.data_ptr() % 16 == 0
    assert all(s % 8 == 0 for s in y.stride()[:3]) and y.stride(-1) == 1
    assert torch.equal(y[..., :x.shape[-1]], x) and not y[..., x.shape[-1]:].any()
    assert (y is x) == (case == "aligned")


def test_launch_counts_by_kernel():
    """Launches count in total and by kernel; a graph's replay adds what its
    capture recorded of each kernel."""
    attn_mod.reset_launches()
    assert attn_mod.launches == 0 and set(attn_mod.kernel_launches.values()) == {0}
    attn_mod.count_launches(10, {"attention": 4, "attention_tc": 6})
    attn_mod.count_launches(1010)
    assert attn_mod.launches == 1020
    assert attn_mod.kernel_launches == {"attention": 4, "attention_tc": 6}
    attn_mod.reset_launches()
    assert attn_mod.launches == 0 and set(attn_mod.kernel_launches.values()) == {0}
