"""tvc_torch FIR resampling against the JAX package (default numerics:
polyphase on, fused FIR off).

Tolerance: float32 sums of a few taps, max |diff| <= 1e-6 on N(0, 1) inputs
(the bound tests/test_reference_parity.py uses for upfirdn2d).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tvc.ops import resample as jres
from tvc_torch.ops import resample as tres


def _x(shape=(2, 9, 9, 3), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (0, 0)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (2, 1)), (1, 1, (-1, 2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    x = _x()
    k = jres.setup_kernel([1, 3, 3, 1])
    want = np.asarray(jres.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad))
    got = tres.upfirdn2d(torch.from_numpy(x), k, up=up, down=down, pad=pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("k", [(1, 3, 3, 1), (1, 2, 1), (1, 1)], ids=["4tap", "3tap", "2tap"])
@pytest.mark.parametrize("gain", [1.0, 2.0])
@pytest.mark.parametrize("op", ["upsample_2d", "downsample_2d"])
def test_resample_2d_matches_jax(op, k, gain):
    x = _x((2, 8, 8, 5), seed=1)
    want = np.asarray(getattr(jres, op)(jnp.asarray(x), k, factor=2, gain=gain))
    got = getattr(tres, op)(torch.from_numpy(x), k, factor=2, gain=gain).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("op", ["upsample_2d", "downsample_2d"])
def test_nchw_axes_match_nhwc(op):
    x = torch.from_numpy(_x((2, 8, 8, 5), seed=2))
    nhwc = getattr(tres, op)(x)
    nchw = getattr(tres, op)(x.permute(0, 3, 1, 2).contiguous(), spatial_axes=tres.NCHW)
    assert torch.equal(nchw.permute(0, 2, 3, 1), nhwc)


def test_setup_kernel_matches_jax():
    for k in ([1, 3, 3, 1], [[1, 2], [3, 4]]):
        np.testing.assert_array_equal(tres.setup_kernel(k), jres.setup_kernel(k))
