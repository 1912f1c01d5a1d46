"""The UNet's activation layout (``tvc_torch/ops/layout.py``) on the CPU.

The rule chooses one memory format a call from the device type and the
compute dtype; each layer returns the layout it receives. Given a
channels-last input, the layers return channels-last, with values equal to
the contiguous input's at the layer tests' tolerance (float32: max |diff| <=
1e-5 x max |output|; CPU convolutions and norms sum in another order per
layout). The FIR resampling keeps its input's layout where
``layout.keeps_layout`` holds, on the card; the tests that go through it
take the card's answer (``card_layouts``), and one holds that the CPU's
stays as it was. Small shapes, one torch thread.
"""

import pytest
import torch

from tvc_torch.models.diffusion import layers as tl
from tvc_torch.ops import layout, resample
from tvc_torch.ops.layout import activation_layout, channels_last, like

CL = torch.channels_last


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rule_is_channels_last_for_bf16_on_the_card_contiguous_for_float32_and_keeps_the_cpu():
    assert activation_layout("cuda", torch.bfloat16) == torch.channels_last
    assert activation_layout("cuda", torch.float32) == torch.contiguous_format
    assert activation_layout("cpu", torch.float32) is None
    assert activation_layout("cpu", torch.bfloat16) is None


@pytest.fixture
def card_layouts(monkeypatch):
    """The FIR resampling takes the card's route, the kernel's launch done by
    the ops it replaces on the (N, H, W, C) tensor the kernel reads."""
    def launch(src, y, taps, up, fused):
        assert src.is_contiguous() and y.is_contiguous()
        y.copy_(resample._polyphase(src, taps, up, resample.NHWC, fused))

    monkeypatch.setattr(layout, "keeps_layout", lambda x: True)
    monkeypatch.setattr(resample, "_card", lambda x: True)
    monkeypatch.setattr(resample, "_launch", launch)


def test_cpu_resampling_leaves_its_results_as_before():
    x = torch.randn(2, 8, 6, 6).contiguous(memory_format=CL)
    assert not layout.keeps_layout(x)
    up = resample.upsample_2d(x, spatial_axes=resample.NCHW)
    assert up.is_contiguous()  # the polyphase stack's layout: the CPU nets' convolutions see it
    assert torch.equal(up, resample.upsample_2d(x.contiguous(), spatial_axes=resample.NCHW))


def test_like_keeps_values_and_takes_the_reference_layout():
    x = torch.randn(2, 8, 4, 4)
    xcl = x.contiguous(memory_format=CL)
    assert channels_last(like(x, xcl)) and torch.equal(like(x, xcl), x)
    assert like(xcl, x).is_contiguous() and torch.equal(like(xcl, x), x)
    assert like(xcl, xcl) is xcl
    v = torch.randn(1, 4, 3, 5, 5)
    vcl = v.movedim(1, -1).contiguous().movedim(-1, 1)
    assert like(v, vcl).stride() == vcl.stride() and torch.equal(like(v, vcl), v)


def _pair(c=16, r=8, b=2, seed=0):
    x = torch.randn((b, c, r, r), generator=torch.Generator().manual_seed(seed)) * 2 + 0.3
    return x, x.contiguous(memory_format=CL)


def _same(got_cl, got, x_cl):
    assert channels_last(got_cl), got_cl.stride()
    assert got_cl.shape == got.shape and got.is_contiguous()
    scale = got.abs().max().item()
    assert scale > 1e-3
    assert (got_cl - got).abs().max().item() <= 1e-5 * scale
    assert channels_last(x_cl)  # the input is left as it was


def _init(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return module.eval()


def test_get_act_norm_keeps_channels_last():
    x, xcl = _pair()
    mod = _init(tl.GetActNorm(16, 32), 1)
    emb = torch.randn(2, 32)
    with torch.no_grad():
        _same(mod(xcl, emb), mod(x, emb), xcl)


@pytest.mark.parametrize("kind", ["plain", "up", "down"])
def test_resnet_block_biggan_keeps_channels_last(kind, card_layouts):
    x, xcl = _pair()
    mod = _init(tl.ResnetBlockBigGAN(16, 24, 32, up=kind == "up", down=kind == "down"), 2)
    emb = torch.randn(2, 32)
    with torch.no_grad():
        _same(mod(xcl, emb), mod(x, emb), xcl)


def test_attention_block_keeps_channels_last():
    x, xcl = _pair(c=16, r=8)
    mod = _init(tl.AttnBlockpp(16, n_head_channels=8), 3)
    with torch.no_grad():
        _same(mod(xcl), mod(x), xcl)


def test_resnet_block_ddpm_nin_keeps_channels_last():
    x, xcl = _pair()
    mod = _init(tl.ResnetBlockDDPM(16, 24, 32), 4)
    assert hasattr(mod, "NIN_0")
    emb = torch.randn(2, 32)
    with torch.no_grad():
        _same(mod(xcl, emb), mod(x, emb), xcl)


@pytest.mark.parametrize("polyphase", ["1", "0"], ids=["polyphase", "upfirdn"])
@pytest.mark.parametrize("fused", ["0", "1"], ids=["axes", "fused"])
def test_fir_resampling_returns_its_input_layout(polyphase, fused, monkeypatch, card_layouts):
    monkeypatch.setenv("TVC_POLYPHASE", polyphase)
    monkeypatch.setenv("TVC_FUSED_FIR", fused)
    x, xcl = _pair()
    for fn in (resample.upsample_2d, resample.downsample_2d):
        got = fn(x, spatial_axes=resample.NCHW)
        got_cl = fn(xcl, spatial_axes=resample.NCHW)
        _same(got_cl, got, xcl)
        assert torch.equal(got_cl, got)  # elementwise taps: the same values
    w = torch.randn(24, 16, 3, 3, generator=torch.Generator().manual_seed(5)) * 0.2
    for fn in (resample.upsample_conv_2d, resample.conv_downsample_2d):
        _same(fn(xcl, w), fn(x, w), xcl)


@pytest.mark.parametrize("cls", [tl.FIRUpsample, tl.FIRDownsample])
def test_fir_modules_keep_channels_last(cls, card_layouts):
    x, xcl = _pair()
    mod = _init(cls(16, 24, with_conv=True), 6)
    with torch.no_grad():
        _same(mod(xcl), mod(x), xcl)


@pytest.mark.parametrize("fused", ["0", "1"], ids=["axes", "fused"])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_fir_card_route_reads_every_layout_as_it_lies(up, fused, monkeypatch, card_layouts):
    """The card's route reads a contiguous NHWC, a channels-last NCHW and a
    contiguous NCHW tensor (as the NHWC tensor of its planes), odd sizes
    included, and returns the ops' values in its input's layout."""
    monkeypatch.setenv("TVC_FUSED_FIR", fused)
    fn = resample.upsample_2d if up else resample.downsample_2d
    x = torch.randn((2, 7, 5, 3), generator=torch.Generator().manual_seed(8)).to(torch.bfloat16)
    taps = resample._taps(resample._separable_4tap((1, 3, 3, 1)) * (2.0 if up else 1.0),
                          x.dtype)
    want = resample._polyphase(x, taps, up, resample.NHWC, fused == "1")
    got = fn(x)
    assert got.is_contiguous() and torch.equal(got, want)
    nchw = x.permute(0, 3, 1, 2)
    for xx in (nchw, nchw.contiguous()):
        got = fn(xx, spatial_axes=resample.NCHW)
        assert got.stride() == like(got.contiguous(), xx).stride()
        assert torch.equal(got.permute(0, 2, 3, 1), want)


def test_fir_card_route_raises_for_another_layout_or_dtype(card_layouts):
    x = torch.randn(2, 8, 6, 6)
    with pytest.raises(ValueError):
        resample.upsample_2d(x[:, :, :, ::2], spatial_axes=resample.NCHW)
    with pytest.raises(TypeError):
        resample.downsample_2d(x.double(), spatial_axes=resample.NCHW)


def test_fir_card_route_gradient_is_the_ops_gradient(card_layouts):
    x, xcl = _pair()
    dy = torch.randn((2, 16, 16, 16), generator=torch.Generator().manual_seed(9))
    leaf = xcl.clone().requires_grad_()
    y = resample.upsample_2d(leaf, spatial_axes=resample.NCHW)
    assert y.grad_fn is not None and channels_last(y)
    (got,) = torch.autograd.grad(y, leaf, dy)
    ref = x.clone().requires_grad_()
    taps = resample._taps(resample._separable_4tap((1, 3, 3, 1)) * 2.0, x.dtype)
    (want,) = torch.autograd.grad(resample._polyphase(ref, taps, True, resample.NCHW, False),
                                  ref, dy)
    assert channels_last(got) and torch.equal(got, want)
