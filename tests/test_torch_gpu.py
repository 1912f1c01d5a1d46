"""tvc_torch kernels against their plain versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it runs on a host that has only
PyTorch; there, run it without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: float32 max |kernel - plain| <= 1e-4 on N(0, 1) inputs (the two
differ only in the order of float32 sums); bfloat16 within two bf16 ulps of
the output's magnitude (the plain version rounds the softmax weights to bf16,
the tensor-core kernel keeps about 16 bits of them). Reruns must be
bit-identical: each kernel joins its key splits in a fixed order. The
GroupNorm kernel's tolerances are stated with its tests.
"""

import pytest
import torch

from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.ncsnpp import NCSNppSpec, UNetMoreDDPM, groupnorm_shapes
from tvc_torch.ops import attention as attn
from tvc_torch.ops import groupnorm

pytestmark = pytest.mark.gpu

# the flagship UNet's attention shapes (B, H, T, d) at every batch a serving
# path predicts at (1; 2, the whole-GOP sender's run_batched; 4, the CLI sweep;
# 8, the lockstep runner), each batch with its own launch plan, plus ragged T
# (T = 100 and 1000: the last key split is short), small heads and d = 30 (not
# a multiple of 4: the kernel's element-by-element path)
FLAGSHIP = [(1, 2, 1024, 192), (1, 3, 256, 192), (1, 4, 64, 192)]
BATCHED = [(b, h, t, d) for b in (2, 4, 8) for _, h, t, d in FLAGSHIP]
SHAPES = FLAGSHIP + BATCHED + [(2, 3, 100, 192), (2, 2, 33, 64), (1, 1, 7, 8),
                               (1, 2, 64, 256), (1, 2, 1000, 192), (1, 3, 77, 30)]


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


def _heads(shape, dtype, seed=0):
    """q, k, v as the attention block passes them: strided (B, H, T, d) views
    of (B, T, H * d) projections."""
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, h * d), generator=g, device="cuda").to(dtype)
            .view(b, t, h, d).transpose(1, 2) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_strided_heads_match_plain(cuda, shape, dtype):
    b, h, t, d = shape
    q, k, v = _heads(shape, dtype)
    out = attn.attention(q, k, v)
    ref = attn.attention_plain(q, k, v)
    assert out.dtype == dtype and out.shape == (b, h, t, d)
    assert out.transpose(1, 2).is_contiguous()  # laid out as (B, T, H, d)
    scale = max(1.0, ref.float().abs().max().item())
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6 * scale
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_attention_kernel_unaligned_input_matches_plain(cuda):
    """A q that starts one float past a 16-byte boundary takes the element path."""
    shape = (1, 2, 96, 192)
    q, k, v = _qkv(shape, torch.float32, seed=4)
    q = torch.empty(q.numel() + 1, device="cuda")[1:].view(shape).copy_(q)
    out = attn.attention(q, k, v)
    assert (out - attn.attention_plain(q, k, v)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("shape,dtype", [
    (s, dt) for dt in (torch.float32, torch.bfloat16) for s in SHAPES
    if attn.attention_plan(*s, dt).splits > 1],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x)[6:])
def test_attention_kernel_splits_are_bit_repeatable(cuda, shape, dtype):
    assert attn.attention_plan(*shape, dtype).splits > 1
    q, k, v = _heads(shape, dtype, seed=1)
    assert torch.equal(attn.attention(q, k, v), attn.attention(q, k, v))


# the bf16 kernel's operands: every head dim up to 256 (d = 40 and 8 pad to
# one 64-column block) at ragged T (the last key tile and query tile short)
TC_HEAD_DIMS = (8, 40, 64, 128, 192, 256)
RAGGED_T = (33, 100, 1000, 1023)
# the 3-D nets fold their frames into the batch: b = 7 and 5 at the flagship levels
ZOO_3D = [(b, h, t, d) for b in (7, 5) for _, h, t, d in FLAGSHIP]


def _bf16_close(out, ref):
    scale = max(1.0, ref.float().abs().max().item())
    return (out.float() - ref.float()).abs().max().item() <= 2.0 ** -6 * scale


@pytest.mark.parametrize("t", RAGGED_T)
@pytest.mark.parametrize("d", TC_HEAD_DIMS)
def test_tc_kernel_head_dims_and_ragged_t(cuda, d, t):
    """The bf16 route launches the tensor-core kernel (and only it) at every
    head dim and ragged T, strided heads in, (B, T, H, d) out."""
    shape = (2, 2, t, d)
    q, k, v = _heads(shape, torch.bfloat16, seed=d + t)
    before = dict(attn.kernel_launches)
    out = attn.attention(q, k, v)
    assert attn.kernel_launches["attention_tc"] == before["attention_tc"] + 1
    assert attn.kernel_launches["attention"] == before["attention"]
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    assert _bf16_close(out, attn.attention_plain(q, k, v))


@pytest.mark.parametrize("case", ["offset", "row_stride", "head_stride", "contiguous"])
def test_tc_kernel_unaligned_views_match_plain(cuda, case):
    """Views whose base or strides are not whole 16-byte chunks (copied by the
    wrapper before the launch) and a contiguous (B, H, T, d) input."""
    b, h, t, d = 1, 2, 300, 192
    g = torch.Generator(device="cuda").manual_seed(9)
    qkv = []
    for _ in range(3):
        if case == "offset":  # one bf16 past a 16-byte boundary
            x = torch.randn(b * t * h * d + 1, generator=g, device="cuda").bfloat16()[1:]
            x = x.view(b, t, h, d).transpose(1, 2)
        elif case == "row_stride":  # rows 4 values apart from a 16-byte multiple
            x = torch.randn((b, t, h * d + 4), generator=g, device="cuda").bfloat16()[..., 4:]
            x = x.view(b, t, h, d).transpose(1, 2)
        elif case == "head_stride":  # heads 4 values apart
            x = torch.randn((b, h, t * d + 4), generator=g, device="cuda").bfloat16()
            x = x[..., :t * d].view(b, h, t, d)
        else:
            x = torch.randn((b, h, t, d), generator=g, device="cuda").bfloat16()
        qkv.append(x)
    out = attn.attention(*qkv)
    assert out.transpose(1, 2).is_contiguous()
    assert _bf16_close(out, attn.attention_plain(*qkv))
    assert torch.equal(out, attn.attention(*qkv))


@pytest.mark.parametrize("shape", ZOO_3D, ids=lambda s: "x".join(map(str, s)))
def test_tc_kernel_3d_shapes_match_plain(cuda, shape):
    q, k, v = _heads(shape, torch.bfloat16, seed=3)
    out = attn.attention(q, k, v)
    assert _bf16_close(out, attn.attention_plain(q, k, v))
    assert torch.equal(out, attn.attention(q, k, v))


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


# ---------------------------------------------------------------- the GroupNorm kernel

# Tolerances of the GroupNorm kernel against ``group_norm_plain`` on the card:
# the two differ only in the order of the statistics' sums (a tree over the
# slice against ATen's Welford), which moves the mean and rstd by a few
# float32 ulps. float32: max |kernel - plain| <= 1e-4 x max(1, max |plain|).
# bf16: that change flips a value lying within it of a bf16 rounding boundary,
# one bf16 ulp (2^-8 of the value), and the flip carries through the chain's
# later roundings; so at most 1% of the elements may differ at all, none by
# more than 2^-6 x max(1, max |plain|).
GN_SHAPES = sorted(set(groupnorm_shapes(NCSNppSpec.from_config(Config()))))


def _gn_inputs(b, c, spatial, dtype, mode, seed=0):
    """x ~ 2 N(0, 1) + 0.3; per mode: (N, C) scale and shift as ``GetActNorm``
    passes them (halves of one (N, 2C) projection), or a (C,) float32 weight
    around 1 and bias, or neither."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, c, *spatial), generator=g, device="cuda") * 2 + 0.3).to(dtype)
    w = bias = scale = shift = None
    if mode == "emb":
        scale, shift = (torch.randn((b, 2 * c), generator=g, device="cuda") * 0.3).to(
            dtype).chunk(2, dim=1)
    elif mode == "affine":
        w = 1 + 0.3 * torch.randn(c, generator=g, device="cuda")
        bias = 0.3 * torch.randn(c, generator=g, device="cuda")
    return x, w, bias, scale, shift


def _gn_close(got, want, layout_of=None):
    """``got`` within the tolerances above, laid out as ``layout_of`` (the
    kernel's input: it writes the layout it reads), contiguous by default."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if layout_of is None:
        assert got.is_contiguous()
    else:
        assert got.stride() == layout_of.stride()
    scale = max(1.0, want.float().abs().max().item())
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert diff.max().item() <= 1e-4 * scale
    else:
        assert diff.max().item() <= 2.0 ** -6 * scale
        assert (diff > 0).float().mean().item() <= 0.01


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GN_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}{'_emb' if s[2] else ''}")
def test_groupnorm_kernel_matches_plain_at_unet_shapes(cuda, shape, dtype, b):
    """Each GroupNorm shape of the flagship UNet as the UNet runs it (with the
    time embedding and SiLU, or affine), one launch."""
    c, r, emb = shape
    x, w, bias, scale, shift = _gn_inputs(b, c, (r, r), dtype, "emb" if emb else "affine")
    before = groupnorm.launches
    got = groupnorm.group_norm_act(x, 32, 1e-5, w, bias, scale, shift, True, dtype)
    assert groupnorm.launches == before + 1
    _gn_close(got, groupnorm.group_norm_plain(x, 32, 1e-5, w, bias, scale, shift, True, dtype))


@pytest.mark.parametrize("bf16_io", ["0", "1"], ids=["f32_io", "bf16_io"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no_silu"])
@pytest.mark.parametrize("mode", ["emb", "affine", "param_free"])
def test_groupnorm_kernel_modes_match_plain(cuda, mode, silu, dtype, bf16_io, monkeypatch):
    """Every mode, with and without SiLU, both TVC_GN_BF16_IO settings, at a
    split slice (B = 1, 8 splits), a packed one (8x8) and a ragged one (runs
    of 30 pixels: one element a load, bf16 weights)."""
    monkeypatch.setenv("TVC_GN_BF16_IO", bf16_io)
    for b, c, spatial in ((1, 384, (64, 64)), (8, 768, (8, 8)), (3, 64, (5, 6))):
        x, w, bias, scale, shift = _gn_inputs(b, c, spatial, dtype, mode, seed=c)
        if w is not None and c == 64:
            w, bias = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        got = groupnorm.group_norm_act(x, 32, 1e-6, w, bias, scale, shift, silu, dtype)
        _gn_close(got, groupnorm.group_norm_plain(x, 32, 1e-6, w, bias, scale, shift, silu,
                                                  dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_groupnorm_kernel_5d_and_spade_match_plain(cuda, dtype):
    """``GetActNorm3D`` on the 3-D nets' volumes (7 frames; the widest at
    128 x 128 reads its slices again from device memory) and SPADE's
    param-free norm."""
    from tvc_torch.models.diffusion.ncsnpp3d import GetActNorm3D
    from tvc_torch.models.diffusion.spade import MySPADE

    wide = 384 if dtype == torch.float32 else 768
    for c, r in ((192, 32), (192, 128), (wide, 128)):
        mod = GetActNorm3D(7 * c, 7, 768, dtype=dtype, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(r)
        v = (torch.randn((1, c, 7, r, r), generator=g, device="cuda") * 2).to(dtype)
        assert groupnorm.groupnorm_plan(1, c, 7 * r * r, 32, dtype).resident == (c != wide)
        emb = torch.randn((1, 768), generator=g, device="cuda").to(dtype)
        with torch.no_grad():
            got = mod(v, emb)
            scale, shift = mod.Dense_0(torch.nn.functional.silu(emb)).chunk(2, dim=1)
            norm = mod.Norm_0
            want = groupnorm.group_norm_plain(v, norm.num_groups, norm.eps, None, None, scale,
                                              shift, True, dtype)
        _gn_close(got, want)
    spade = MySPADE(384, 6, 64, dtype=dtype, device="cuda")
    x = _gn_inputs(2, 384, (32, 32), dtype, "param_free")[0]
    with torch.no_grad():
        got = spade.param_free_norm(x)
    _gn_close(got, groupnorm.group_norm_plain(x, 32, 1e-6, dtype=dtype))


# the SPADE NCSN++'s 71 modulated norms of a flagship-width call: 20
# (channels, resolution) pairs, each run here with and without the time term
SPADE_SHAPES = sorted({(c, r) for c, r, _ in
                       groupnorm_shapes(NCSNppSpec.from_config(Config()), attention=False)})


def _spade_inputs(b, c, r, dtype, emb, seed=0):
    """x as ``_gn_inputs``; gamma and beta ~ 0.3 N(0, 1) of x's shape, as the
    SPADE net's convolutions write them (contiguous); scale and shift with
    ``emb``."""
    x, _, _, scale, shift = _gn_inputs(b, c, (r, r), dtype, "emb" if emb else "param_free",
                                       seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    gamma, beta = ((torch.randn(x.shape, generator=g, device="cuda") * 0.3).to(dtype)
                   for _ in range(2))
    return x, scale, shift, gamma, beta


@pytest.mark.parametrize("emb", [True, False], ids=["emb", "no_emb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPADE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_groupnorm_spade_kernel_matches_plain_at_spade_shapes(cuda, shape, dtype, emb):
    """Each modulated norm of the SPADE net at B = 1, one launch of the SPADE
    entry, against the plain composition (``_gn_close``'s tolerances: the
    modulation's roundings are the composition's, so only the statistics'
    order differs); a rerun gives the same bits."""
    c, r = shape
    x, scale, shift, gamma, beta = _spade_inputs(1, c, r, dtype, emb, seed=c + r)
    before, plain_before = groupnorm.spade_launches, groupnorm.launches
    got = groupnorm.group_norm_act(x, 32, 1e-6, None, None, scale, shift, True, dtype,
                                   gamma=gamma, beta=beta)
    assert groupnorm.spade_launches == before + 1 and groupnorm.launches == plain_before
    _gn_close(got, groupnorm.group_norm_plain(x, 32, 1e-6, None, None, scale, shift, True, dtype,
                                              gamma=gamma, beta=beta))
    assert torch.equal(got, groupnorm.group_norm_act(x, 32, 1e-6, None, None, scale, shift, True,
                                                     dtype, gamma=gamma, beta=beta))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_groupnorm_spade_kernel_layouts_and_modes_match_plain(cuda, dtype, monkeypatch):
    """The SPADE entry at B = 8, on a channels-last x (gamma and beta copied
    channels-last by the wrapper, the result channels-last), without SiLU, on
    channels-last gamma and beta (copied contiguous for a contiguous x), a
    ragged shape (one element a load) and both TVC_GN_BF16_IO settings."""
    for io in ("0", "1"):
        monkeypatch.setenv("TVC_GN_BF16_IO", io)
        for b, c, r, silu in ((8, 768, 8, True), (1, 384, 64, False), (3, 64, 5, True)):
            x, scale, shift, gamma, beta = _spade_inputs(b, c, r, dtype, True, seed=b)
            want = groupnorm.group_norm_plain(x, 32, 1e-6, None, None, scale, shift, silu,
                                              dtype, gamma=gamma, beta=beta)
            cl = torch.channels_last
            for xx, gg, bb in ((x, gamma, beta), (x.contiguous(memory_format=cl), gamma, beta),
                               (x, gamma.contiguous(memory_format=cl),
                                beta.contiguous(memory_format=cl))):
                _gn_close(groupnorm.group_norm_act(xx, 32, 1e-6, None, None, scale, shift, silu,
                                                   dtype, gamma=gg, beta=bb), want, layout_of=xx)


def test_groupnorm_spade_rejects_bad_input(cuda):
    x = torch.randn(2, 64, 8, 8, device="cuda")
    with pytest.raises(ValueError):  # gamma without beta
        groupnorm.group_norm_act(x, 32, 1e-6, gamma=x)
    with pytest.raises(ValueError):  # gamma of another shape
        groupnorm.group_norm_act(x, 32, 1e-6, gamma=x[:1], beta=x[:1])
    with pytest.raises(ValueError):  # gamma in another dtype
        groupnorm.group_norm_act(x, 32, 1e-6, gamma=x.bfloat16(), beta=x.bfloat16())
    with pytest.raises(ValueError):  # the SPADE norm takes no affine weights
        groupnorm.group_norm_act(x, 32, 1e-6, torch.ones(64, device="cuda"),
                                 torch.zeros(64, device="cuda"), gamma=x, beta=x)


def test_groupnorm_spade_gradient_matches_plain_autograd(cuda):
    """Under autograd the SPADE entry's output carries the plain composition's
    gradient, gamma's and beta's included (SPADE training)."""
    x, scale, shift, gamma, beta = (t.detach().clone().requires_grad_() for t in
                                    _spade_inputs(2, 384, 32, torch.float32, True, seed=5))
    leaves = [x, scale, shift, gamma, beta]
    dy = torch.randn_like(x)
    before = groupnorm.spade_launches
    out = groupnorm.group_norm_act(x, 32, 1e-6, None, None, scale, shift, True,
                                   gamma=gamma, beta=beta)
    assert groupnorm.spade_launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, dy)
    ref = groupnorm.group_norm_plain(x, 32, 1e-6, None, None, scale, shift, True,
                                     gamma=gamma, beta=beta)
    want = torch.autograd.grad(ref, leaves, dy)
    _gn_close(out.detach(), ref.detach())
    for a, e in zip(got, want):
        assert (a - e).abs().max().item() <= 1e-4 * e.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_groupnorm_kernel_reruns_are_bit_identical(cuda, dtype):
    """Split slices (cluster joins) and packed ones give the same bits twice."""
    for b, c, r in ((1, 384, 128), (8, 384, 128), (1, 192, 64), (8, 768, 8)):
        x, w, bias, scale, shift = _gn_inputs(b, c, (r, r), dtype, "emb", seed=r)
        a = groupnorm.group_norm_act(x, 32, 1e-5, w, bias, scale, shift, True, dtype)
        assert torch.equal(a, groupnorm.group_norm_act(x, 32, 1e-5, w, bias, scale, shift,
                                                        True, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_groupnorm_kernel_reads_channels_last(cuda, dtype):
    """A channels-last input (the bf16 UNet's activations) is read as it lies,
    into a channels-last output: split, packed, ragged and 5-D, the same bits
    on a rerun."""
    for b, c, spatial, mode in ((1, 192, (128, 128), "affine"), (8, 384, (64, 64), "emb"),
                                (8, 768, (8, 8), "emb"), (3, 64, (5, 6), "param_free"),
                                (1, 192, (7, 32, 32), "emb")):
        x, w, bias, scale, shift = _gn_inputs(b, c, spatial, dtype, mode, seed=c)
        xcl = x.movedim(1, -1).contiguous().movedim(-1, 1)
        assert not xcl.is_contiguous()
        got = groupnorm.group_norm_act(xcl, 32, 1e-5, w, bias, scale, shift, True, dtype)
        _gn_close(got, groupnorm.group_norm_plain(x, 32, 1e-5, w, bias, scale, shift, True,
                                                  dtype), layout_of=xcl)
        assert torch.equal(got, groupnorm.group_norm_act(xcl, 32, 1e-5, w, bias, scale, shift,
                                                         True, dtype))


LAYOUT_CASES = [(torch.bfloat16, 1), (torch.bfloat16, 8), (torch.float32, 1)]


@pytest.mark.parametrize("entry", ["plain", "spade"])
@pytest.mark.parametrize("dtype,b", LAYOUT_CASES, ids=["bf16_B1", "bf16_B8", "f32_B1"])
def test_groupnorm_kernel_channels_last_output_is_its_contiguous_output(cuda, dtype, b, entry):
    """Every norm shape of a concat call (the plain entry, as the UNet runs
    it) and of a SPADE call (the SPADE entry, gamma and beta channels-last):
    from one channels-last input, the channels-last output equals the
    contiguous one bit for bit (only the store's addresses differ), and each
    channels-last write is counted."""
    shapes = GN_SHAPES if entry == "plain" else [(c, r, e) for c, r in SPADE_SHAPES
                                                 for e in (True, False)]
    for c, r, emb in shapes:
        if entry == "plain":
            x, w, bias, scale, shift = _gn_inputs(b, c, (r, r), dtype, "emb" if emb else "affine",
                                                  seed=c + r)
            kw = {}
        else:
            x, scale, shift, gamma, beta = _spade_inputs(b, c, r, dtype, emb, seed=c + r)
            w = bias = None
            kw = {"gamma": gamma.contiguous(memory_format=torch.channels_last),
                  "beta": beta.contiguous(memory_format=torch.channels_last)}
        xcl = x.contiguous(memory_format=torch.channels_last)
        args = (xcl, 32, 1e-5, w, bias, scale, shift, True)
        before = groupnorm.channels_last_writes
        with torch.no_grad():
            got = groupnorm.launch(*args, **kw)
            flat = groupnorm.launch(*args, **kw, out_channels_last=False)
        assert groupnorm.channels_last_writes == before + 1
        assert got.stride() == xcl.stride() and flat.is_contiguous()
        assert torch.equal(got, flat), (c, r, emb)


def test_groupnorm_kernel_writes_channels_last_only_from_channels_last(cuda):
    x = torch.randn(2, 64, 8, 8, device="cuda")
    with pytest.raises(ValueError):
        groupnorm.launch(x, 32, 1e-5, out_channels_last=True)


@pytest.mark.parametrize("fused", [False, True], ids=["axes", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_fir_kernel_is_the_polyphase_ops_byte_for_byte(cuda, dtype, up, fused):
    """``csrc/fir.cu`` against the ops of ``ops/resample.py`` it replaces on
    the card (the two axis passes, or the one-pass form): the flagship's
    resampled shapes at B = 8, a ragged one (one element a load), an odd
    one, an unaligned view and the NCHW planes of each, the same bytes, one
    launch each."""
    from tvc_torch.ops import resample

    k4 = resample._separable_4tap((1, 3, 3, 1))
    gain = 4.0 if up else 1.0
    taps = resample._taps(k4 * (gain ** 0.5), dtype)
    g = torch.Generator(device="cuda").manual_seed(7)
    for shape in ((8, 64, 64, 192), (8, 16, 16, 576), (2, 6, 4, 7), (2, 7, 5, 3)):
        x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
        want = resample._polyphase(x, taps, up, resample.NHWC, fused)
        unaligned = torch.randn((x.numel() + 1,), generator=g, device="cuda").to(dtype)[1:]
        for xx, axes in ((x, resample.NHWC), (unaligned.view(shape).copy_(x), resample.NHWC),
                         (x.permute(0, 3, 1, 2).contiguous(), resample.NCHW)):
            before = resample.launches
            got = resample._fir_card(xx, taps, up, axes, fused)
            assert resample.launches == before + 1
            if axes == resample.NCHW:
                assert got.is_contiguous()
                got = got.permute(0, 2, 3, 1)
            assert got.shape == want.shape and torch.equal(got, want), (shape, axes)


def test_fir_kernel_gradient_is_the_ops_gradient(cuda):
    """Where autograd records, the kernel runs (``KernelFIR``) and x's
    gradient is the ops' own, in x's layout."""
    from tvc_torch.ops import resample

    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((2, 64, 16, 16), generator=g, device="cuda").to(torch.bfloat16)
    for xx in (x, x.contiguous(memory_format=torch.channels_last)):
        for fn, up in ((resample.upsample_2d, True), (resample.downsample_2d, False)):
            leaf = xx.clone().requires_grad_()
            before = resample.launches
            y = fn(leaf, spatial_axes=resample.NCHW)
            assert resample.launches == before + 1 and y.grad_fn is not None
            dy = torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)
            (got,) = torch.autograd.grad(y, leaf, dy)
            ref = xx.clone().requires_grad_()
            taps = resample._taps(resample._separable_4tap((1, 3, 3, 1)) * (2.0 if up else 1.0),
                                  x.dtype)
            (want,) = torch.autograd.grad(resample._polyphase(ref, taps, up, resample.NCHW,
                                                              False), ref, dy)
            assert got.stride() == xx.stride() and torch.equal(got, want)


def test_groupnorm_kernel_rejects_bad_input(cuda):
    x = torch.randn(2, 64, 8, 8, device="cuda")
    with pytest.raises(TypeError):  # no float16 kernel
        groupnorm.group_norm_act(x.half(), 32, 1e-5, dtype=torch.float16)
    with pytest.raises(TypeError):  # the input in another dtype than the compute dtype
        groupnorm.group_norm_act(x, 32, 1e-5, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the kernel reads contiguous or channels-last tensors
        groupnorm.launch(x.transpose(2, 3), 32, 1e-5)
    with pytest.raises(ValueError):
        groupnorm.launch(x[:, :, :, ::2], 32, 1e-5)
    # the wrapper makes any other layout contiguous first, as ATen's group norm does
    odd = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert torch.equal(groupnorm.group_norm_act(odd, 32, 1e-5),
                       groupnorm.group_norm_act(x, 32, 1e-5))
    with pytest.raises(ValueError):  # a weight on another device
        groupnorm.group_norm_act(x, 32, 1e-5, torch.ones(64), torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError):  # 64 channels in 24 groups
        groupnorm.group_norm_act(x, 24, 1e-5)


@pytest.mark.parametrize("mode", ["emb", "affine"])
def test_groupnorm_gradient_matches_plain_autograd(cuda, mode):
    """Where autograd records, the kernel's output carries a grad_fn, and the
    gradients of x, the weights and the embedding's scale and shift are plain
    autograd's (the backward recomputes the composition)."""
    x, w, bias, scale, shift = (None if t is None else t.detach().clone().requires_grad_()
                                for t in _gn_inputs(2, 384, (32, 32), torch.float32, mode, seed=5))
    leaves = [t for t in (x, w, bias, scale, shift) if t is not None]
    dy = torch.randn_like(x)
    before = groupnorm.launches
    out = groupnorm.group_norm_act(x, 32, 1e-5, w, bias, scale, shift, True)
    assert groupnorm.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, dy)
    ref = groupnorm.group_norm_plain(x, 32, 1e-5, w, bias, scale, shift, True)
    want = torch.autograd.grad(ref, leaves, dy)
    _gn_close(out.detach(), ref.detach())
    for a, e in zip(got, want):
        assert (a - e).abs().max().item() <= 1e-4 * e.abs().max().item()


def test_unet_call_launches_every_groupnorm_once(cuda):
    """A narrow NCSN++ call on the card launches the kernel once a GroupNorm
    (eager, and counted at each graph replay) and agrees with the plain
    composition inside the net."""
    from unittest import mock

    from tvc_torch.models.diffusion import layers
    from tvc_torch.samplers.graph import GraphedEps

    cfg, model, model16 = _bf16_unet()
    per_call = len(groupnorm_shapes(NCSNppSpec.from_config(cfg)))
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, 32, 32, 15), generator=g, device="cuda")
    cond = torch.randn((1, 32, 32, 6), generator=g, device="cuda")
    t = torch.tensor([10], device="cuda")
    with torch.no_grad():
        for net, tol in ((model, 1e-4), (model16, 5e-2)):
            xs, cs = x.to(net.dtype), cond.to(net.dtype)
            groupnorm.reset_launches()
            out = net(xs, t, cs)
            assert groupnorm.launches == per_call
            with mock.patch.object(layers, "group_norm_act", groupnorm.group_norm_plain):
                ref = net(xs, t, cs)
            assert groupnorm.launches == per_call
            scale = ref.float().abs().max().item()
            assert (out.float() - ref.float()).abs().max().item() <= tol * scale
        graphed = GraphedEps(model)
        groupnorm.reset_launches()
        outs = [graphed(x, t, cond) for _ in range(4)]  # eager, capture + replay, 2 replays
    assert groupnorm.launches == 4 * per_call
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert graphed.stats()[next(iter(graphed.stats()))]["groupnorm_launches"] == per_call


def _spade_unet():
    """A narrow SPADE NCSN++ of the flagship's topology (every weight
    N(0, 0.08)) on the card: 71 modulated norms, 10 attention blocks."""
    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.ngf = 16
    cfg.model.n_head_channels = 8
    cfg.model.attn_resolutions = (4, 8, 16)
    cfg.model.spade = True
    cfg.model.spade_dim = 16
    model = UNetMoreDDPM(cfg, device="cpu").eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.08)
    return cfg, model.to("cuda")


def test_spade_unet_call_launches_the_spade_kernel_once_a_norm(cuda):
    """A SPADE call launches the SPADE entry 71 times, the plain entry 10
    times (the attention blocks' norms) and attention 10 times, eager and
    counted at each graph replay, in float32 and bf16, and agrees with the
    plain composition inside the net."""
    from unittest import mock

    from tvc_torch.models.diffusion import spade
    from tvc_torch.samplers.graph import GraphedEps

    cfg, model = _spade_unet()
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, 32, 32, 15), generator=g, device="cuda")
    cond = torch.rand((1, 32, 32, 6), generator=g, device="cuda") * 2 - 1
    t = torch.tensor([10], device="cuda")
    with torch.no_grad():
        for net, tol in ((model, 1e-4), (model.with_dtype(torch.bfloat16), 5e-2)):
            xs = x.to(net.dtype)
            groupnorm.reset_launches()
            attn.reset_launches()
            out = net(xs, t, cond)
            assert (groupnorm.spade_launches, groupnorm.launches, attn.launches) == (71, 10, 10)
            with mock.patch.object(spade, "group_norm_act", groupnorm.group_norm_plain):
                ref = net(xs, t, cond)
            scale = ref.float().abs().max().item()
            assert scale > 1e-2 and (out.float() - ref.float()).abs().max().item() <= tol * scale
        graphed = GraphedEps(model)
        groupnorm.reset_launches()
        outs = [graphed(x, t, cond) for _ in range(4)]  # eager, capture + replay, 2 replays
    assert (groupnorm.spade_launches, groupnorm.launches) == (4 * 71, 4 * 10)
    assert all(torch.equal(o, outs[0]) for o in outs)
    (st,) = graphed.stats().values()
    assert st["spade_launches"] == 71 and st["groupnorm_launches"] == 10


def test_spade_update_through_the_graph_equals_eager_byte_for_byte(cuda):
    """A SPADE DDPM update through its graphed UNet gives the eager loop's
    frames byte for byte, three times, with 71 SPADE launches a UNet call."""
    from tvc_torch.core.runtime import batched_conv_algorithms
    from tvc_torch.pipeline.predictor import FramePredictor
    from tvc_torch.pipeline.transforms import data_transform, inverse_data_transform

    cfg, model = _spade_unet()
    cfg.model.num_classes = 100
    cfg.sampling.subsample = 10
    pred = FramePredictor(cfg, model)
    cond = torch.rand((1, 32, 32, 6), generator=torch.Generator(device="cuda").manual_seed(4),
                      device="cuda")
    x_init, noise = pred.draws(torch.Generator(device="cuda").manual_seed(5), 1)
    outs = []
    for _ in range(3):
        groupnorm.reset_launches()
        outs.append(pred.generate(cond, x_init=x_init, noise=noise))
        assert groupnorm.spade_launches == 71 * pred.n_steps
    step, warm = pred._split(noise)
    with torch.no_grad(), batched_conv_algorithms(1, "cuda"):
        eager = pred._sample(x_init, data_transform(cfg, cond), step, warm,
                             eps_fn=pred.model)[-1]
    eager = inverse_data_transform(cfg, eager).reshape(1, 32, 32, 5, 3).permute(0, 3, 1, 2, 4)
    for out in outs:
        assert out.cpu().numpy().tobytes() == eager.cpu().numpy().tobytes()


# ---------------------------------------------------------------- the codec and the GOP


def _pair(seed=0, size=128):
    """Two smooth seeded frames, (2, size, size, 3) in [0, 1]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    frames = [np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx + t * yy))
                        for _ in range(3)], -1) for t in range(2)]
    return np.clip(np.stack(frames) + 0.02 * rng.randn(2, size, size, 3), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def full_codec():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tvc_torch.core.config import CodecConfig
    from tvc_torch.models.codec.elic import make_elic

    return make_elic(CodecConfig(), seed=0, device="cuda")


@pytest.mark.parametrize("backend", ["cpu", "device"])
def test_full_width_pair_roundtrip_is_byte_identical(full_codec, backend):
    from tvc_torch.models.codec import container
    from tvc_torch.models.codec.coding import ELICCoder

    coder = ELICCoder(full_codec, backend)
    enc = coder.compress(_pair(), return_recon=True)
    got = container.deserialize(container.serialize(enc, backend), expect_entropy_backend=backend)
    dec = ELICCoder(full_codec, backend).decompress(got["strings"], got["shape"])
    assert enc["x_hat"].shape == (2, 128, 128, 3)
    assert enc["x_hat"].tobytes() == dec["x_hat"].tobytes()


def test_full_width_pair_codes_like_its_frames(full_codec):
    from tvc_torch.models.codec.coding import ELICCoder

    coder = ELICCoder(full_codec, "device")
    x = _pair(1)
    pair = coder.compress(x)["strings"]
    for f in range(2):
        one = coder.compress(x[f: f + 1])["strings"]
        assert one[1] == [pair[1][f]]
        assert one[0] == [[[ph[f]] for ph in sl] for sl in pair[0]]


def test_device_entropy_parameters_match_cpu(full_codec):
    """Each phase of the chain on the card against the same phase on the host,
    on the host's inputs: close (1e-5 of the largest value), not equal."""
    import numpy as np

    from tvc_torch.models.codec.coding import ELICCoder

    host, card = ELICCoder(full_codec, "cpu"), ELICCoder(full_codec, "device")

    def dev(t):
        return None if t is None else t.to("cuda")

    pairs = []
    phase1, phase2 = host._phase1, host._phase2

    def rec_phase1(i, prev_anchor, prev_nonanchor, first, lm, ls):
        out = phase1(i, prev_anchor, prev_nonanchor, first, lm, ls)
        pairs.append((out[2:], card._phase1(i, dev(prev_anchor), prev_nonanchor, dev(first),
                                            dev(lm), dev(ls))[2:]))
        return out

    def rec_phase2(i, anchor_q, sup):
        out = phase2(i, anchor_q, sup)
        pairs.append((out[1:], card._phase2(i, anchor_q, dev(sup))[1:]))
        return out

    host._phase1, host._phase2 = rec_phase1, rec_phase2
    with torch.no_grad():
        z = full_codec.encode_transforms(torch.tensor(_pair(2)).permute(0, 3, 1, 2).cuda())[1]
        z_hat = host.fb.quantize(z.cpu().numpy())[0]
        card_hyper = full_codec.hyper_params(torch.tensor(z_hat).cuda())
        host_hyper = host._chain.hyper_params(torch.tensor(z_hat))
    for a, b in zip(host_hyper, card_hyper):
        assert (a - b.cpu()).abs().max().item() <= 1e-5 * a.abs().max().item()
    host.compress(_pair(2))
    assert len(pairs) == 2 * 2 * full_codec.num_slices
    differ = 0
    for host_out, card_out in pairs:
        for a, b in zip(host_out, card_out):
            scale = float(np.abs(a).max())
            assert float(np.abs(a - b).max()) <= 1e-5 * scale
            differ += int(not np.array_equal(a, b))
    print(f"{differ} of {2 * len(pairs)} parameter maps differ between the backends")


def _narrow_pipeline():
    """A narrow UNet, ELIC and random LPIPS on the card."""
    from tvc_torch.core.config import CodecConfig
    from tvc_torch.metrics.lpips import LPIPSMetric
    from tvc_torch.models.codec.coding import ELICCoder
    from tvc_torch.models.codec.elic import make_elic
    from tvc_torch.pipeline.predictor import FramePredictor

    cfg = Config()
    cfg.data.image_size = 64
    cfg.data.num_frames = 3
    cfg.model.ngf = 16
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (32,)
    cfg.model.n_head_channels = 8
    cfg.model.num_classes = 20
    cfg.sampling.subsample = 5
    pred = FramePredictor.create(cfg, seed=0, device="cuda")
    coder = ELICCoder(make_elic(CodecConfig(N=16, M=24, groups=(4, 4, 4, 4, 8)), device="cuda"),
                      "device")
    return cfg, pred, coder, LPIPSMetric.create(seed=0, device="cuda")


def test_small_gop_receiver_rebuilds_the_sender_on_card(cuda):
    """A narrow pipeline on the card: the receiver's frames are the sender's,
    byte for byte, through accepted predictions and fallback pairs."""
    import numpy as np

    from tvc_torch.pipeline.receiver import run_gop_receiver
    from tvc_torch.pipeline.sender import Sender, run_gop

    cfg, pred, coder, lp = _narrow_pipeline()
    video = np.random.RandomState(3).rand(10, 64, 64, 3).astype(np.float32)
    for threshold in (1e9, -1.0):
        gop = run_gop(Sender(threshold, cfg, pred, lp), coder, video, seed=4, num_frames_total=10,
                      keep_streams=True)
        rec = run_gop_receiver(cfg, gop.accepts, gop.containers, coder, pred, 4, 10)
        assert rec.tobytes() == gop.x_ge[0].tobytes()


def test_small_bf16_gop_receiver_rebuilds_the_sender_on_card(cuda):
    """A bf16 predictor (bf16-stored weights, the tensor-core kernel): a fresh
    receiver's predictor rebuilds the sender's frames byte for byte through
    accepted predictions and fallback pairs."""
    import numpy as np

    from tvc_torch.pipeline.predictor import FramePredictor
    from tvc_torch.pipeline.receiver import run_gop_receiver
    from tvc_torch.pipeline.sender import Sender, run_gop

    cfg, pred, coder, lp = _narrow_pipeline()
    video = np.random.RandomState(3).rand(10, 64, 64, 3).astype(np.float32)
    for threshold in (1e9, -1.0):
        sender = FramePredictor(cfg, pred.model, dtype=torch.bfloat16,
                                params_dtype=torch.bfloat16)
        before = attn.kernel_launches["attention_tc"]
        gop = run_gop(Sender(threshold, cfg, sender, lp), coder, video, seed=4,
                      num_frames_total=10, keep_streams=True)
        assert attn.kernel_launches["attention_tc"] > before
        receiver = FramePredictor(cfg, pred.model, dtype=torch.bfloat16,
                                  params_dtype=torch.bfloat16)
        rec = run_gop_receiver(cfg, gop.accepts, gop.containers, coder, receiver, 4, 10)
        assert rec.tobytes() == gop.x_ge[0].tobytes()


def test_device_runner_is_run_gop_on_card(cuda):
    """DeviceGOPRunner on the card, uint8 input converted there: run_gop's
    decisions, bits, containers and frames, byte for byte."""
    import numpy as np

    from tvc_torch.pipeline.sender import DeviceGOPRunner, Sender, run_gop

    cfg, pred, coder, lp = _narrow_pipeline()
    video = np.round(np.random.RandomState(5).rand(10, 64, 64, 3) * 255).astype(np.uint8)
    for threshold in (1e9, -1.0):
        want = run_gop(Sender(threshold, cfg, pred, lp), coder, video.astype(np.float32) / 255.0,
                       seed=6, num_frames_total=10, keep_streams=True)
        got = DeviceGOPRunner(cfg, pred, lpips=lp, num_frames_total=10).run(
            coder, video, 6, threshold, keep_streams=True)
        assert got.accepts == want.accepts and got.bits == want.bits
        assert got.containers == want.containers
        assert got.x_ge.tobytes() == want.x_ge.tobytes()


def test_recorder_adds_no_sync_and_counts_every_host_read(cuda, monkeypatch):
    """A B = 1 ``DeviceGOPRunner`` update with the span recorder on calls
    ``torch.cuda.synchronize`` no more often than with it off, gives the same
    frames, and its host reads (``.cpu()`` of a card tensor: the scores, the
    frames, the device entropy chain's parameters) are the recorder's count."""
    import numpy as np

    from tvc_torch.pipeline.sender import DeviceGOPRunner
    from tvc_torch.utils import profiler

    cfg, pred, coder, lp = _narrow_pipeline()
    video = np.random.RandomState(5).rand(5, 64, 64, 3).astype(np.float32)
    runner = DeviceGOPRunner(cfg, pred, lpips=lp, num_frames_total=5)
    runner.run(coder, video, 6, 1e9)  # the eager call and the graph's capture
    calls = {"sync": 0, "read": 0}
    sync, cpu = torch.cuda.synchronize, torch.Tensor.cpu

    def counted_sync(*args, **kwargs):
        calls["sync"] += 1
        return sync(*args, **kwargs)

    def counted_cpu(self, *args, **kwargs):
        calls["read"] += int(self.is_cuda)
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)

    def one_update():
        calls.update(sync=0, read=0)
        gop = runner.run(coder, video, 6, 1e9)
        assert gop.n_updates == 1
        return gop, dict(calls)

    off, off_calls = one_update()
    with profiler.tracing():
        on, on_calls = one_update()
    counters = profiler.record()["counters"]
    assert on_calls["sync"] <= off_calls["sync"]
    reads = sum(n for k, n in counters.items() if k.startswith("reads.") and k.count(".") == 1)
    assert on_calls["read"] == off_calls["read"] == reads
    assert counters["reads.score"] == 1 and counters["reads.runner"] == 1
    assert counters["graph.replays"] == pred.n_steps and "graph.captures" not in counters
    assert on.x_ge.tobytes() == off.x_ge.tobytes() and on.containers == off.containers


def test_batched_prediction_reruns_bit_identical(cuda):
    """Predictions at B > 1 (cuDNN's timed algorithm choice) repeat bit for
    bit in a process; a B = 1 prediction is unchanged by them."""
    cfg, pred, _, _ = _narrow_pipeline()
    g = torch.Generator(device="cuda").manual_seed(0)
    cond = torch.rand((4, 64, 64, 6), generator=g, device="cuda")
    one = pred.generate(cond[:1], generator=torch.Generator(device="cuda").manual_seed(1))
    outs = [pred.generate(cond, generator=torch.Generator(device="cuda").manual_seed(2))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    again = pred.generate(cond[:1], generator=torch.Generator(device="cuda").manual_seed(1))
    assert torch.equal(one, again)


def _rel_err(a, b):
    return (a - b).abs().max().item() / b.abs().max().item()


def test_i3d_features_on_card_match_cpu(cuda):
    """The full I3D (seeded, every BatchNorm tensor drawn) on the card against
    the same module on the CPU: features within 1e-4 of the largest."""
    import numpy as np

    from tvc_torch.metrics.fvd import FVDMetric

    host = FVDMetric(device="cpu", seed=3)
    card = FVDMetric(device="cuda", seed=3)
    videos = np.random.RandomState(4).rand(2, 10, 64, 80, 3).astype(np.float32)
    want, got = torch.tensor(host.features(videos)), torch.tensor(card.features(videos))
    assert got.shape == (2, 400) and _rel_err(got, want) <= 1e-4
    v1 = np.repeat(videos[:1], 2, 0)
    v2 = np.repeat(videos[1:], 2, 0)
    assert abs(card(v1, v2) - host(v1, v2)) <= 1e-3 * host(v1, v2)


def test_inception_and_lpips_on_card_match_cpu(cuda):
    import numpy as np

    from tvc_torch.metrics.lpips import LPIPSMetric
    from tvc_torch.models.inception import FIDInceptionFeatures

    imgs = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    want = torch.tensor(FIDInceptionFeatures(device="cpu", seed=6)(imgs))
    got = torch.tensor(FIDInceptionFeatures(device="cuda", seed=6)(imgs))
    assert got.shape == (2, 2048) and _rel_err(got, want) <= 1e-4
    other = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    for net_type in ("alex", "vgg", "squeeze"):
        host = LPIPSMetric.create(device="cpu", net_type=net_type)(imgs, other)
        card = LPIPSMetric.create(device="cuda", net_type=net_type)(imgs, other).cpu()
        assert (host - card).abs().max().item() <= 1e-5, net_type


@pytest.mark.parametrize("version,gamma,t_min", [("DDPM", False, -1.0), ("DDPM", True, 0.5),
                                                 ("DDIM", False, 0.5), ("FPNDM", False, -1.0)],
                         ids=["ddpm", "ddpm_gamma_t_min", "ddim_t_min", "fpndm"])
def test_graph_equals_eager_bit_for_bit(cuda, version, gamma, t_min):
    """Each sampler through the graphed UNet (a batch's first UNet call is
    the eager warm-up, the second captures and replays, every later one
    replays) gives the eager sampler's frames bit for bit at B = 1 and 2, and
    the graph's launches are counted at replay."""
    cfg, base, _, _ = _narrow_pipeline()
    from tvc_torch.pipeline.predictor import FramePredictor

    cfg.model.version, cfg.model.gamma, cfg.sampling.init_prev_t = version, gamma, t_min
    pred = FramePredictor(cfg, base.model)
    g = torch.Generator(device="cuda").manual_seed(0)
    for b in (1, 2):
        cond = torch.rand((b, 64, 64, 6), generator=g, device="cuda")
        x_init, noise = pred.draws(torch.Generator(device="cuda").manual_seed(b), b)
        outs, counts = [], []
        for _ in range(3):
            attn.reset_launches()
            outs.append(pred.generate(cond, x_init=x_init, noise=noise))
            counts.append(attn.launches)
        assert counts[0] == counts[1] == counts[2] > 0 and counts[0] % pred.n_steps == 0
        from tvc_torch.core.runtime import batched_conv_algorithms
        from tvc_torch.pipeline.transforms import data_transform, inverse_data_transform

        step, warm = pred._split(noise)
        with batched_conv_algorithms(b, "cuda"):
            eager = pred._sample(x_init, data_transform(cfg, cond), step, warm,
                                 eps_fn=pred.model)[-1]
        eager = inverse_data_transform(cfg, eager).reshape(b, 64, 64, 3, 3).permute(0, 3, 1, 2, 4)
        for out in outs:
            assert torch.equal(out, eager)
    n = 3 * pred.n_steps - 1  # three updates, less the warm-up call
    assert [s["replays"] for s in pred.graphs.stats().values()] == [n, n]



def _bf16_unet():
    """A narrow NCSN++ (every weight N(0, 0.08)) on the card, and its bf16 twin."""
    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.ngf = 16
    cfg.model.n_head_channels = 8
    cfg.model.attn_resolutions = (4, 8, 16)
    model = UNetMoreDDPM(cfg, device="cpu").eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.08)
    model = model.to("cuda")
    return cfg, model, model.with_dtype(torch.bfloat16)


def test_bf16_unet_kernel_matches_plain(cuda):
    """The kernel in bf16 inside the bf16 UNet against the plain attention
    (which rounds P to bf16 before p.v; the kernel keeps it in float32): bf16
    rounding carried through the net, max |diff| <= 5e-2 x max |plain|, and
    every call's 10 launches in bf16."""
    from unittest import mock

    from tvc_torch.models.diffusion import layers

    cfg, _, model16 = _bf16_unet()
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, 32, 32, 15), generator=g, device="cuda").to(torch.bfloat16)
    cond = torch.randn((1, 32, 32, 6), generator=g, device="cuda").to(torch.bfloat16)
    t = torch.tensor([10], device="cuda")
    with torch.no_grad():
        attn.reset_launches()
        out = model16(x, t, cond)
        assert attn.launches == 10
        with mock.patch.object(layers, "attention", attn.attention_plain):
            ref = model16(x, t, cond)
    assert out.dtype == ref.dtype == torch.bfloat16
    scale = ref.float().abs().max().item()
    assert scale > 1e-3
    assert (out.float() - ref.float()).abs().max().item() <= 5e-2 * scale


def test_bf16_graph_equals_eager_bit_for_bit(cuda):
    """A bf16 predictor (bf16-stored weights) through its graphed UNet gives
    the eager sampler's frames bit for bit at B = 1 and 2, and the float32
    masters at bf16 compute give the same frames."""
    from tvc_torch.pipeline.predictor import FramePredictor
    from tvc_torch.core.runtime import batched_conv_algorithms
    from tvc_torch.pipeline.transforms import data_transform, inverse_data_transform

    cfg, model, _ = _bf16_unet()
    cfg.model.num_classes = 20
    cfg.sampling.subsample = 4
    pred = FramePredictor(cfg, model, dtype=torch.bfloat16, params_dtype=torch.bfloat16)
    masters = FramePredictor(cfg, model, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    for b in (1, 2):
        cond = torch.rand((b, 32, 32, 6), generator=g, device="cuda")
        x_init, noise = pred.draws(torch.Generator(device="cuda").manual_seed(b), b)
        assert x_init.dtype == torch.bfloat16
        outs = [pred.generate(cond, x_init=x_init, noise=noise) for _ in range(3)]
        step, warm = pred._split(noise)
        with torch.no_grad(), batched_conv_algorithms(b, "cuda"):
            eager = pred._sample(x_init, data_transform(cfg, cond.to(torch.bfloat16)), step, warm,
                                 eps_fn=pred.model)[-1]
        eager = inverse_data_transform(cfg, eager.float()).reshape(b, 32, 32, 5, 3)
        eager = eager.permute(0, 3, 1, 2, 4)
        for out in outs:
            assert out.dtype == torch.float32 and torch.equal(out, eager)
        assert torch.equal(masters.generate(cond, x_init=x_init, noise=noise), outs[0])


def test_bf16_unet_call_runs_no_layout_conversion(cuda):
    """One full-width bf16 UNet call at B = 8 on bf16-stored weights, as the
    lockstep runner makes it, runs channels-last end to end: a profile of it
    has no cuDNN kernel converting NCHW to NHWC or back, every GroupNorm
    writes channels-last (81 a call) and the output is finite; the float32
    call at B = 1 writes none."""
    from torch.profiler import ProfilerActivity, profile

    cfg = Config()
    model = UNetMoreDDPM(cfg, device="cuda").eval()
    stored = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
              for k, v in model.state_dict().items()}
    net = model.with_dtype(torch.bfloat16, stored)
    del stored
    size, ch = cfg.data.image_size, cfg.data.channels
    per_call = len(groupnorm_shapes(NCSNppSpec.from_config(cfg)))
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype, b, unet in ((torch.bfloat16, 8, net), (torch.float32, 1, model)):
        x = torch.randn((b, size, size, ch * cfg.data.num_frames), generator=g,
                        device="cuda").to(dtype)
        cond = torch.randn((b, size, size, ch * cfg.data.num_frames_cond), generator=g,
                           device="cuda").to(dtype)
        t = torch.full((b,), 500, device="cuda")
        with torch.no_grad():
            unet(x, t, cond)  # cuDNN's first choice of algorithms, the weights stored
            torch.cuda.synchronize()
            groupnorm.reset_launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = unet(x, t, cond)
                torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        writes = groupnorm.channels_last_writes
        if dtype == torch.bfloat16:
            assert writes == per_call == 81
            names = [e.key for e in prof.key_averages()]
            assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n], names
        else:
            assert writes == 0


def test_unet_calls_count_channels_last_writes_at_each_replay(cuda):
    """``groupnorm.channels_last_writes``: 81 a bf16 call of the narrow net
    of the flagship's topology (eager and at each graph replay, the graph's
    stats included), 0 a float32 call."""
    from tvc_torch.samplers.graph import GraphedEps

    cfg, model, model16 = _bf16_unet()
    per_call = len(groupnorm_shapes(NCSNppSpec.from_config(cfg)))
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, 32, 32, 15), generator=g, device="cuda")
    cond = torch.randn((1, 32, 32, 6), generator=g, device="cuda")
    t = torch.tensor([10], device="cuda")
    with torch.no_grad():
        for net, writes in ((model16, per_call), (model, 0)):
            graphed = GraphedEps(net)
            groupnorm.reset_launches()
            for _ in range(4):  # eager, capture + replay, 2 replays
                graphed(x.to(net.dtype), t, cond.to(net.dtype))
            assert groupnorm.channels_last_writes == 4 * writes
            assert groupnorm.launches == 4 * per_call
            (st,) = graphed.stats().values()
            assert st["channels_last_writes"] == writes


def test_unet_calls_count_fir_launches_at_each_replay(cuda):
    """``resample.launches``: the FIR kernel runs every polyphase resampling
    of a UNet call, two a BigGAN up or down block, in bf16 and float32
    (eager and at each graph replay, the graph's stats included)."""
    from tvc_torch.models.diffusion.layers import ResnetBlockBigGAN
    from tvc_torch.ops import resample
    from tvc_torch.samplers.graph import GraphedEps

    cfg, model, model16 = _bf16_unet()
    per_call = sum(2 for m in model.modules()
                   if isinstance(m, ResnetBlockBigGAN) and (m.up or m.down))
    assert per_call == 16
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, 32, 32, 15), generator=g, device="cuda")
    cond = torch.randn((1, 32, 32, 6), generator=g, device="cuda")
    t = torch.tensor([10], device="cuda")
    with torch.no_grad():
        for net in (model16, model):
            graphed = GraphedEps(net)
            resample.reset_launches()
            for _ in range(4):  # eager, capture + replay, 2 replays
                graphed(x.to(net.dtype), t, cond.to(net.dtype))
            assert resample.launches == 4 * per_call
            (st,) = graphed.stats().values()
            assert st["fir_launches"] == per_call


def test_precision_schedule_covering_every_step_is_f32_on_card(cuda):
    """f32:K with K >= L + 1 is the float32 predictor's run bit for bit."""
    import copy

    from tvc_torch.pipeline.predictor import FramePredictor

    cfg, model, _ = _bf16_unet()
    cfg.model.num_classes = 20
    cfg.sampling.subsample = 4
    f32 = FramePredictor(cfg, model)
    mixed_cfg = copy.deepcopy(cfg)
    mixed_cfg.sampling.precision_schedule = f"f32:{f32.n_steps}"
    mixed = FramePredictor(mixed_cfg, model, dtype=torch.bfloat16)
    cond = torch.rand((1, 32, 32, 6), generator=torch.Generator(device="cuda").manual_seed(3),
                      device="cuda")
    x_init, noise = f32.draws(torch.Generator(device="cuda").manual_seed(4), 1)
    want = f32.generate(cond, x_init=x_init, noise=noise)
    for _ in range(2):  # the eager call, then the graph
        assert torch.equal(mixed.generate(cond, x_init=x_init, noise=noise), want)

def test_default_width_tvc_container_decodes_on_card(cuda):
    """The default-width container ``tvc/`` wrote (tests/test_torch_cross_decode.py)
    decodes in the port with its g_s on the card; the count of streams that
    give ``tvc/``'s symbols is printed."""
    from tvc_torch.tools import cross_decode

    out = cross_decode.decode("cuda")
    print(f"cross-package decode on the card: {out['matched']} of {out['streams']} streams "
          f"give tvc's symbols; x_hat within {out['x_hat_max_abs_diff']:.3g}")
    assert out["matched"] == out["streams"]
    assert out["x_hat_max_abs_diff"] <= 1e-4 * out["x_hat_max_abs"]


# ---------------------------------------------------------------- training


LEVELS = [(2, 1024), (3, 256), (4, 64)]  # (heads, tokens) at 32x32, 16x16, 8x8; d = 192


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("h,t", LEVELS, ids=["32x32", "16x16", "8x8"])
def test_attention_gradient_matches_plain_autograd(cuda, h, t, b):
    """Where autograd records, the kernel's output carries a grad_fn and its
    dQ, dK, dV (``attention_backward``) match autograd through
    ``attention_plain`` within 1e-4 of the gradient's magnitude (float32 sums
    in another order; the backward reads the kernel's own output)."""
    q, k, v = (x.requires_grad_() for x in _heads((b, h, t, 192), torch.float32, seed=3))
    g = torch.Generator(device="cuda").manual_seed(4)
    dout = torch.randn((b, t, h, 192), generator=g, device="cuda").transpose(1, 2)
    before = attn.launches
    out = attn.attention(q, k, v)
    assert attn.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert attn.launches == before + 1  # the backward is torch products, no launch
    ref_out = attn.attention_plain(q, k, v)
    want = torch.autograd.grad(ref_out, (q, k, v), dout)
    assert (out - ref_out).abs().max().item() <= 1e-4
    for a, w in zip(got, want):
        assert (a - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_full_width_train_step_kernel_matches_plain(cuda):
    """The 262.1M UNet at B = 2: the DSM loss and every gradient through the
    kernel against the same step with the plain attention (loss within 1e-5,
    each gradient within 1e-3 of its magnitude or of a thousandth of the
    largest); every attention block's GroupNorm_0 and NIN_0..2 get non-zero
    gradients; one optimizer step moves the parameters and the EMA."""
    from unittest import mock

    from tvc_torch.losses.dsm import anneal_dsm_score_estimation, draw_dsm
    from tvc_torch.models.diffusion import layers
    from tvc_torch.parallel.train import make_train_step
    from tvc_torch.samplers.schedules import Schedule

    cfg = Config()
    cfg.optim.warmup = 0  # with the default warmup the first update has lr 0
    init_fn, step_fn = make_train_step(cfg, device="cuda")
    state = init_fn(0)
    layers.redraw_zero_scaled_(state.module, torch.Generator().manual_seed(1))
    state.ema = {n: p.detach().clone() for n, p in state.params.items()}
    size, c = cfg.data.image_size, cfg.data.channels
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {"x": torch.rand((2, size, size, c * cfg.data.num_frames), generator=g,
                             device="cuda") * 2 - 1,
             "cond": torch.rand((2, size, size, c * cfg.data.num_frames_cond), generator=g,
                                device="cuda") * 2 - 1}
    labels, noise = draw_dsm(batch["x"].shape, Schedule.from_config(cfg),
                             torch.Generator().manual_seed(6), device="cuda")

    def grads():
        state.module.zero_grad(set_to_none=True)
        loss = anneal_dsm_score_estimation(lambda x, y, co, _m: state.model(x, y, co),
                                           batch["x"], Schedule.from_config(cfg),
                                           cond=batch["cond"], labels=labels, noise=noise)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in state.params.items()}

    from tvc_torch.core.runtime import batched_conv_algorithms

    with batched_conv_algorithms(2, "cuda"):  # as step_fn runs it
        loss, got = grads()
        with mock.patch.object(layers, "attention", attn.attention_plain):
            ref_loss, want = grads()
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    attn_names = [n for n in want if any(f".{m}." in n for m in
                                         ("GroupNorm_0", "NIN_0", "NIN_1", "NIN_2"))]
    assert len(attn_names) == 10 * 8  # 10 blocks: GroupNorm_0 and NIN_0..2, weight and bias each
    for n, w in want.items():
        assert (got[n] - w).abs().max().item() <= 1e-3 * max(w.abs().max().item(), floor), n
    for n in attn_names:
        if not n.endswith("NIN_1.b"):  # softmax ignores a shift of every key's logit
            assert got[n].abs().max().item() > 0, n
    before = {n: p.detach().clone() for n, p in state.params.items()}
    ema_before = {n: e.clone() for n, e in state.ema.items()}
    state, step_loss = step_fn(state, batch, labels, noise)
    assert torch.isfinite(step_loss)
    moved = sum(not torch.equal(p, before[n]) for n, p in state.params.items())
    ema_moved = sum(not torch.equal(e, ema_before[n]) for n, e in state.ema.items())
    assert moved > 0 and ema_moved > 0


# ---------------------------------------------------------------- the model zoo


def _random_weights_(module, seed=0, scale=0.08):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # no zero-init layer hides the attention or the output
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return module


@pytest.mark.parametrize("mods", [{"spade": True, "spade_dim": 16}, {"arch": "unetmore3d"},
                                  {"arch": "unetmorepseudo3d"}],
                         ids=["spade", "unetmore3d", "unetmorepseudo3d"])
def test_zoo_arch_forward_on_card_matches_cpu(cuda, mods):
    """A narrow SPADE, 3-D or pseudo-3-D NCSN++ on the card against the same
    weights on the CPU; 10 attention launches a call (b = 7 and 5 on the 3-D
    nets), the kernel against the plain attention inside the net."""
    from unittest import mock

    from tvc_torch.models.diffusion import layers

    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.ngf = 16
    cfg.model.n_head_channels = 8
    cfg.model.attn_resolutions = (4, 8, 16)
    for k, v in mods.items():
        setattr(cfg.model, k, v)
    model = _random_weights_(UNetMoreDDPM(cfg, device="cpu").eval())
    g = torch.Generator().manual_seed(2)
    x, cond = torch.randn((1, 32, 32, 15), generator=g), torch.randn((1, 32, 32, 6), generator=g)
    t = torch.tensor([10])
    with torch.no_grad():
        want = model(x, t, cond)
        model = model.to("cuda")
        before = attn.launches
        got = model(x.cuda(), t.cuda(), cond.cuda())
        launches = attn.launches - before
        with mock.patch.object(layers, "attention", attn.attention_plain):
            plain = model(x.cuda(), t.cuda(), cond.cuda())
    scale = want.abs().max().item()
    assert scale > 1e-3 and launches == 10
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * scale
    assert (got - plain).abs().max().item() <= 1e-4 * scale


def test_zoo_library_on_card_matches_cpu(cuda):
    """The legacy UNet through create_model, the NCSNv2 blocks, the norm zoo,
    fused_leaky_relu and the ELIC library layers: card against CPU."""
    from tvc_torch.models import registry
    from tvc_torch.models.codec import layers as codec
    from tvc_torch.models.diffusion import ncsnv2_blocks as nb
    from tvc_torch.models.diffusion import normalization as norms
    from tvc_torch.ops.fused_act import fused_leaky_relu

    g = torch.Generator().manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=g)

    cfg = Config()
    cfg.model.arch = "unet"
    cfg.model.ngf = 32
    cfg.data.image_size = 16
    labels = torch.tensor([1, 7])
    cond_norm = norms.get_normalization("InstanceNorm++", conditional=True, num_classes=10)
    x, x2 = rand(2, 8, 16, 16), rand(2, 8, 8, 8)
    cases = [
        (registry.create_model(cfg, device="cpu"),
         (rand(2, 16, 16, 15), torch.tensor([3, 900]), rand(2, 16, 16, 6))),
        (nb.CondRefineBlock((8, 8), 8, cond_norm), ([x, x2], labels, (16, 16))),
        (nb.RefineBlock((8, 8), 8), ([x, x2], (16, 16))),
        (norms.InstanceNorm2dPlus(8), (x,)),
        (norms.VarianceNorm2d(8), (x,)),
        (norms.ConditionalVarianceNorm2d(8, 10), (x, labels)),
        (codec.MaskedConv2d(8, 8, 5, "B"), (x,)),
        (codec.ResidualBlockWithStride(8, 16), (x,)),
        (codec.ResidualBlockUpsample(8, 16), (x,)),
        (codec.ResidualBlock(8, 16), (x,)),
    ]

    def to_card(args):
        return [to_card(a) if isinstance(a, list) else
                (a.cuda() if torch.is_tensor(a) else a) for a in args]

    for module, args in cases:
        module = _random_weights_(module.eval(), scale=0.2)
        with torch.no_grad():
            want = module(*args)
            got = module.cuda()(*to_card(args)).cpu()
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), module
    y, bias = rand(2, 4, 4, 8), rand(8)
    torch.testing.assert_close(fused_leaky_relu(y.cuda(), bias.cuda()).cpu(),
                               fused_leaky_relu(y, bias), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- zoo and bf16 training


@pytest.mark.parametrize("mods,dtype", [({"spade": True, "spade_dim": 16}, torch.float32),
                                        ({"arch": "unetmore3d"}, torch.float32),
                                        ({"arch": "unetmorepseudo3d"}, torch.float32),
                                        ({}, torch.bfloat16)],
                         ids=["spade", "unetmore3d", "unetmorepseudo3d", "bf16"])
def test_train_step_on_card_matches_cpu(cuda, mods, dtype):
    """One DSM step of a narrow zoo net (float32) or of the 2-D net in bf16 on
    the card against the same step on the CPU: the loss within 1e-4 (float32)
    or 2e-2 (bf16) relative, every gradient within 1e-3 (float32) or 0.1 (bf16,
    the bf16 forward's largest relative error, tests/test_torch_bf16.py) of
    the largest gradient, the masters, moments and EMA float32."""
    from tvc_torch.parallel.train import make_train_step

    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.ngf = 16
    cfg.model.n_head_channels = 8
    cfg.model.attn_resolutions = (4, 8, 16)
    cfg.optim.warmup = 0
    for k, v in mods.items():
        setattr(cfg.model, k, v)
    g = torch.Generator().manual_seed(2)
    batch = {"x": torch.randn((2, 32, 32, 15), generator=g),
             "cond": torch.randn((2, 32, 32, 6), generator=g)}
    labels, noise = torch.tensor([10, 900]), torch.randn((2, 32, 32, 15), generator=g)
    weights = _random_weights_(UNetMoreDDPM(cfg, device="cpu")).state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        init_fn, step_fn = make_train_step(cfg, dtype=dtype, device=dev)
        state = init_fn(0)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(weights[n])
        before = attn.launches
        state, loss = step_fn(state, {k: v.to(dev) for k, v in batch.items()},
                              labels.to(dev), noise.to(dev))
        out[dev] = (float(loss), {n: p.grad.float().cpu() for n, p in state.params.items()},
                    attn.launches - before)
        assert all(p.dtype == state.ema[n].dtype == state.opt_state[f"mu/{n}"].dtype
                   == torch.float32 for n, p in state.params.items())
    (loss_c, grads_c, _), (loss_g, grads_g, launches) = out["cpu"], out["cuda"]
    loss_tol, grad_tol = (1e-4, 1e-3) if dtype == torch.float32 else (2e-2, 0.1)
    assert launches > 0
    assert abs(loss_g - loss_c) <= loss_tol * abs(loss_c)
    top = max(float(v.abs().max()) for v in grads_c.values())
    for n in grads_c:
        assert (grads_g[n] - grads_c[n]).abs().max().item() <= grad_tol * top, n
