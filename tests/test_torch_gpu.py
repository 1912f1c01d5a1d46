"""tvc_torch kernels against their plain versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it runs on a host that has only
PyTorch; there, run it without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: float32 max |kernel - plain| <= 1e-4 on N(0, 1) inputs (the two
differ only in the order of float32 sums); bfloat16 within two bf16 ulps of
the output's magnitude (the plain version rounds the softmax weights to bf16,
the kernel keeps them in float32).
"""

import pytest
import torch

from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.ops import attention as attn

pytestmark = pytest.mark.gpu

# the flagship UNet's attention shapes (B, H, T, d), plus ragged and small heads
SHAPES = [(1, 2, 1024, 192), (1, 3, 256, 192), (1, 4, 64, 192), (8, 2, 1024, 192),
          (2, 3, 100, 192), (2, 2, 33, 64), (1, 1, 7, 8), (1, 2, 64, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype)
    before = attn.launches
    out = attn.attention(q, k, v)
    assert attn.launches == before + 1
    ref = attn.attention_plain(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6 * scale
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_attention_kernel_is_bit_repeatable(cuda):
    q, k, v = _qkv((1, 2, 1024, 192), torch.float32, seed=1)
    a = attn.attention(q, k, v)
    b = attn.attention(q, k, v)
    assert torch.equal(a, b)


def test_attention_kernel_rejects_bad_input(cuda):
    q = torch.randn(1, 2, 16, 8, device="cuda")
    with pytest.raises(TypeError):
        attn.attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        attn.attention(q, q, q.transpose(2, 3).contiguous())
    with pytest.raises(ValueError):
        attn.attention(q, q.cpu(), q)


def test_small_unet_forward_kernel_matches_plain(cuda):
    """A narrow NCSN++ on the card: the kernel inside the net agrees with the
    plain attention inside the net."""
    from unittest import mock

    from tvc_torch.models.diffusion import layers

    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.ngf = 16
    cfg.model.n_head_channels = 8
    cfg.model.attn_resolutions = (4, 8, 16)
    model = UNetMoreDDPM(cfg, device="cpu").eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # every weight N(0, 0.08): no zero-init layer hides the attention
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.08)
    model = model.to("cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, 32, 32, 15), generator=g, device="cuda")
    cond = torch.randn((1, 32, 32, 6), generator=g, device="cuda")
    t = torch.tensor([10], device="cuda")
    with torch.no_grad():
        out = model(x, t, cond)
        with mock.patch.object(layers, "attention", attn.attention_plain):
            ref = model(x, t, cond)
    scale = ref.abs().max().item()
    assert scale > 1e-3
    assert (out - ref).abs().max().item() <= 1e-4 * scale
