"""tvc_torch kernels against their plain versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it runs on a host that has only
PyTorch; there, run it without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: float32 max |kernel - plain| <= 1e-4 on N(0, 1) inputs (the two
differ only in the order of float32 sums); bfloat16 within two bf16 ulps of
the output's magnitude (the plain version rounds the softmax weights to bf16,
the kernel keeps them in float32). Reruns must be bit-identical: the kernel
joins its key splits in a fixed order.
"""

import pytest
import torch

from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.ops import attention as attn

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [s for s in SHAPES
                                   if attn.attention_plan(*s, torch.float32).splits > 1],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_kernel_splits_are_bit_repeatable(cuda, shape, dtype):
    assert attn.attention_plan(*shape, dtype).splits > 1
    q, k, v = _heads(shape, dtype, seed=1)
    assert torch.equal(attn.attention(q, k, v), attn.attention(q, k, v))


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
