"""The GroupNorm chain's wrapper (``tvc_torch/ops/groupnorm.py``) on the CPU.

On a CPU tensor ``group_norm_act`` is the plain PyTorch composition the
layers ran before the kernel existed: here ``GroupNormRef``, ``GetActNorm``,
``GetActNorm3D`` and SPADE's param-free norm are held byte for byte to that
composition, written out below as it stood, in float32 and bf16 and in both
``TVC_GN_BF16_IO`` settings. The kernel's launch counter stays 0 on the CPU
and is exported by the recorder; the launch plan is checked at every
GroupNorm shape of the flagship UNet. The kernel itself runs only on the card
(``tests/test_torch_gpu.py``).
"""

import itertools
import math
import os

import pytest
import torch
import torch.nn.functional as F

from tvc_torch.core.config import Config
from tvc_torch.models.diffusion import layers as tl
from tvc_torch.models.diffusion.ncsnpp import NCSNppSpec, UNetMoreDDPM, groupnorm_shapes
from tvc_torch.models.diffusion.ncsnpp3d import GetActNorm3D
from tvc_torch.models.diffusion.spade import MySPADE
from tvc_torch.ops import groupnorm
from tvc_torch.utils import profiler

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run shares the host's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the composition as the layers ran it


def old_group_norm_ref(gn, x):
    dt = gn.dtype
    w = gn.weight.to(dt) if gn.affine else None
    b = gn.bias.to(dt) if gn.affine else None
    if dt != torch.float32 and os.environ.get("TVC_GN_BF16_IO", "0") == "1":
        return F.group_norm(x.to(dt), gn.num_groups, w, b, gn.eps)
    w = None if w is None else w.float()
    b = None if b is None else b.float()
    return F.group_norm(x.float(), gn.num_groups, w, b, gn.eps).to(dt)


def old_get_act_norm(mod, x, emb):
    y = old_group_norm_ref(mod.Norm_0, x)
    if mod.has_emb:
        unit = (slice(None), slice(None)) + (None,) * (x.dim() - 2)
        scale, shift = mod.Dense_0(F.silu(emb))[unit].chunk(2, dim=1)
        y = y * (1 + scale) + shift
    return F.silu(y)


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5 + (1.0 if p.dim() == 1 else 0.0))
    return module


def _input(shape, dtype, seed=0, channels_last=False):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2 + 0.3).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _cases(dtype):
    """(name, new call, old call) of each module the chain serves."""
    g2 = _randomize(tl.GroupNormRef(64, eps=1e-6, dtype=dtype), 1)
    free = tl.GroupNormRef(64, eps=1e-6, affine=False, dtype=dtype)
    act_emb = _randomize(tl.GetActNorm(64, 40, dtype=dtype), 2)
    act_aff = _randomize(tl.GetActNorm(64, None, dtype=dtype), 3)
    act3 = _randomize(GetActNorm3D(7 * 32, 7, 40, dtype=dtype), 4)
    act3_aff = _randomize(GetActNorm3D(7 * 32, 7, None, dtype=dtype), 5)
    spade = _randomize(MySPADE(64, 6, 16, dtype=dtype), 6)
    x, x3 = _input((2, 64, 8, 8), dtype), _input((2, 32, 7, 6, 6), dtype, seed=7)
    xcl = _input((2, 64, 8, 8), dtype, seed=8, channels_last=True)
    emb = _input((2, 40), dtype, seed=9)
    seg = _input((2, 6, 8, 8), dtype, seed=10)
    return [
        ("affine", lambda: g2(x), lambda: old_group_norm_ref(g2, x)),
        ("param_free", lambda: free(x), lambda: old_group_norm_ref(free, x)),
        ("channels_last", lambda: g2(xcl), lambda: old_group_norm_ref(g2, xcl)),
        ("act_emb", lambda: act_emb(x, emb), lambda: old_get_act_norm(act_emb, x, emb)),
        ("act_emb_channels_last", lambda: act_emb(xcl, emb),
         lambda: old_get_act_norm(act_emb, xcl, emb)),
        ("act_affine", lambda: act_aff(x), lambda: old_get_act_norm(act_aff, x, None)),
        ("act3d_emb", lambda: act3(x3, emb), lambda: old_get_act_norm(act3, x3, emb)),
        ("act3d_affine", lambda: act3_aff(x3), lambda: old_get_act_norm(act3_aff, x3, None)),
        ("spade", lambda: spade(x, seg), lambda: old_spade(spade, x, seg)),
    ]


def old_spade(spade, x, seg):
    """``MySPADE`` as it ran before the kernel: the old param-free norm, then
    the modulation by the conditioning net's gamma and beta."""
    normalized = old_group_norm_ref(spade.param_free_norm, x)
    if seg.shape[-2:] != x.shape[-2:]:
        seg = F.interpolate(seg, size=tuple(x.shape[-2:]), mode="nearest")
    actv = spade.mlp_shared(seg)
    return normalized * (1 + spade.mlp_gamma(actv)) + spade.mlp_beta(actv)


CASES = ["affine", "param_free", "channels_last", "act_emb", "act_emb_channels_last",
         "act_affine", "act3d_emb", "act3d_affine", "spade"]


@pytest.mark.parametrize("bf16_io", ["0", "1"], ids=["f32_io", "bf16_io"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_cpu_chain_is_the_old_composition_byte_for_byte(case, dtype, bf16_io, monkeypatch):
    monkeypatch.setenv("TVC_GN_BF16_IO", bf16_io)
    groupnorm.reset_launches()
    (name, new, old), = [c for c in _cases(dtype) if c[0] == case]
    with torch.no_grad():
        got, want = new(), old()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    assert torch.equal(got, want) and got.float().abs().max() > 0.1
    assert groupnorm.launches == 0


def test_plain_composition_differentiates_as_the_old_one():
    """Under autograd on the CPU the wrapper is the composition: the same
    gradients for the input, the weights and the embedding."""
    mod = _randomize(tl.GetActNorm(64, 40), 2)
    x = _input((2, 64, 8, 8), torch.float32).requires_grad_()
    emb = _input((2, 40), torch.float32, seed=9).requires_grad_()
    dy = _input((2, 64, 8, 8), torch.float32, seed=11)
    grads = []
    for fn in (mod, lambda a, e: old_get_act_norm(mod, a, e)):
        mod.zero_grad()
        inputs = [x, emb, *mod.parameters()]
        grads.append(torch.autograd.grad(fn(x, emb), inputs, dy))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_launch_counter_stays_zero_on_cpu_and_is_recorded():
    groupnorm.reset_launches()
    cfg = Config()
    cfg.data.image_size = 16
    cfg.model.ngf = 8
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (8,)
    cfg.model.n_head_channels = 4
    model = UNetMoreDDPM(cfg, device="cpu").eval()
    x = torch.randn(1, 16, 16, 15)
    cond = torch.randn(1, 16, 16, 6)
    with profiler.tracing(), torch.no_grad():
        model(x, torch.tensor([3]), cond)
        rec = profiler.record()
    assert groupnorm.launches == 0
    assert rec["counters"]["groupnorm.kernel_launches"] == 0


def test_groupnorm_shapes_are_the_calls_of_the_net(monkeypatch):
    """``groupnorm_shapes`` lists the GroupNorms a UNet call makes, in order,
    with their channels, resolution and modulation (a tiny net of the
    flagship's topology); the flagship makes 81: 70 modulated, 10 attention
    norms and the final one, 76.9M elements a sample, 24 distinct shapes."""
    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.ngf = 8
    cfg.model.n_head_channels = 4
    cfg.model.attn_resolutions = (2, 4, 8)
    seen = []
    real = groupnorm.group_norm_plain

    def spy(x, num_groups, eps, weight=None, bias=None, scale=None, shift=None, *a, **k):
        seen.append((x.shape[1], x.shape[-1], scale is not None))
        return real(x, num_groups, eps, weight, bias, scale, shift, *a, **k)

    monkeypatch.setattr(groupnorm, "group_norm_plain", spy)
    model = UNetMoreDDPM(cfg, device="cpu").eval()
    with torch.no_grad():
        model(torch.randn(1, 32, 32, 15), torch.tensor([3]), torch.randn(1, 32, 32, 6))
    assert seen == groupnorm_shapes(NCSNppSpec.from_config(cfg))
    flagship = groupnorm_shapes(NCSNppSpec.from_config(Config()))
    assert len(flagship) == 81 and sum(e for _, _, e in flagship) == 70
    assert sum(c * r * r for c, r, _ in flagship) == 76_935_168
    assert len(set(flagship)) == 24


FLAGSHIP = sorted(set(groupnorm_shapes(NCSNppSpec.from_config(Config()))))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 8])
def test_plan_covers_every_pixel_within_the_card(b, dtype):
    """At every flagship shape: the splits cover each run with none empty, a
    cluster of at most 16, whole 16-byte vectors, shared memory within what a
    block may take; at B = 1 the largest slices are spread over clusters of 8
    blocks or more to fill the card, at B = 8 a slice is split only for its
    size."""
    esize = 4 if dtype == torch.float32 else 2
    for (c, r, _), cl in itertools.product(FLAGSHIP, (False, True)):
        hw = r * r
        plan = groupnorm.groupnorm_plan(b, c, hw, tl.num_groups_for(c), dtype, cl)
        assert plan == groupnorm.groupnorm_plan(b, c, hw, tl.num_groups_for(c), dtype, cl)
        assert 1 <= plan.splits <= groupnorm.MAX_SPLITS
        assert (plan.splits - 1) * plan.pix < hw <= plan.splits * plan.pix
        assert plan.vec == 16 // esize and plan.pix % plan.vec == 0
        cg = c // 32
        wide = c // (16 // esize) > groupnorm.THREADS  # more runs a pixel than threads
        small = cg * hw * esize < groupnorm.SPLIT_BYTES and (
            b * 32 >= groupnorm.FILL_BLOCKS // 2 or wide)
        if cl and small:  # one block a slice, runs of a pixel's group
            assert plan.chunk == 0 and cg % plan.run == 0 and plan.run * esize in (2, 4, 8, 16)
            assert plan.run * esize == 16 or cg % (2 * plan.run) != 0
        elif cl:  # a pixel's channels in runs of 16 bytes' worth, halved until they divide C;
            # chunks of whole rows of a block's pixels, enough of them to fill the card
            assert c % plan.run == 0 and plan.run * esize in (2, 4, 8, 16)
            assert plan.run * esize == 16 or c % (2 * plan.run) != 0
            rows = groupnorm.THREADS // (c // plan.run)
            assert plan.chunk % rows == 0 or plan.chunk == hw
            blocks = b * -(-hw // plan.chunk)  # of each kernel: the card filled within 2x
            assert blocks >= min(groupnorm.FILL_BLOCKS // 2, b * -(-hw // rows))
        else:
            assert plan.run == plan.chunk == 0
        assert plan.splits & (plan.splits - 1) == 0  # a power of two at these shapes
        # the part and each channel's coefficients (16 bytes) within what a block may take
        assert plan.resident and plan.smem <= 200 * 1024
        assert plan.smem == cg * (plan.pix * esize + 16)
        assert plan.blocks == plan.splits * b * 32
        if b == 1 and r == 128:  # 32 slices spread over 8 blocks or more each
            assert plan.splits >= 8
        if b == 8 and plan.splits > 1:  # 256 slices fill the card: split only for size
            assert cg * r * r * esize > groupnorm.SPLIT_BYTES


def test_plan_reads_large_slices_again_and_rejects_what_it_cannot_run():
    # a 3-D net's volume: 7 frames x 128 x 128 x 12 channels a group in float32
    plan = groupnorm.groupnorm_plan(1, 384, 7 * 128 * 128, 32, torch.float32)
    assert plan.splits == 16 and not plan.resident and plan.smem == 16 * 12  # coefficients only
    # runs of 30 pixels are no whole 16-byte vectors: one element a load
    assert groupnorm.groupnorm_plan(2, 64, 30, 32, BF16).vec == 1
    with pytest.raises(TypeError):
        groupnorm.groupnorm_plan(1, 64, 64, 32, torch.float16)
    with pytest.raises(ValueError):
        groupnorm.groupnorm_plan(1, 60, 64, 32, torch.float32)
    # a channels-last x streamed in more runs a pixel than a block has threads
    assert groupnorm.groupnorm_plan(1, 2048, 64 * 64, 32, BF16, True).chunk > 0
    with pytest.raises(ValueError):
        groupnorm.groupnorm_plan(1, 4096, 64 * 64, 32, BF16, True)


def test_cpu_rejects_what_the_card_rejects():
    """The CPU path checks its arguments as the card's does, so a caller
    that passes what the kernel refuses fails here too."""
    x = torch.randn(2, 64, 8, 8)
    with pytest.raises(TypeError):  # no float16 kernel
        groupnorm.group_norm_act(x.half(), 32, 1e-5, dtype=torch.float16)
    with pytest.raises(TypeError):  # the input in another dtype than the compute dtype
        groupnorm.group_norm_act(x, 32, 1e-5, dtype=BF16)
    with pytest.raises(ValueError):  # 64 channels in 24 groups
        groupnorm.group_norm_act(x, 24, 1e-5)
    with pytest.raises(ValueError):  # a weight without its bias
        groupnorm.group_norm_act(x, 32, 1e-5, torch.ones(64))
    scale = torch.zeros(2, 64)
    with pytest.raises(ValueError):  # scale and shift in another dtype than the compute dtype
        groupnorm.group_norm_act(x, 32, 1e-5, scale=scale.to(BF16), shift=scale.to(BF16))
    assert groupnorm.group_norm_act(x, 32, 1e-5, scale=scale, shift=scale).dtype == x.dtype


def test_graph_replays_count_the_captured_launches(monkeypatch):
    """``GraphedEps`` adds a graph's captured GroupNorm and FIR launches at
    each replay, as it does the attention kernels' (a CPU stand-in for the
    graph: the capture counts 81 and 16 captured launches, the replay reruns
    the call)."""
    from tvc_torch.ops import resample
    from tvc_torch.samplers import graph as graph_mod

    class Replayer:
        def __init__(self, fn, inputs, out):
            self.fn, self.inputs, self.out = fn, inputs, out

        def replay(self):
            self.out.copy_(self.fn(**self.inputs))

    def capture(fn, inputs):
        out = fn(**inputs)
        groupnorm.captured += 81
        resample.captured += 16
        return Replayer(fn, inputs, out), out, 0, 0

    monkeypatch.setattr(graph_mod, "capture", capture)
    g = graph_mod.GraphedEps(lambda x, labels, cond=None: x + labels.float()[:, None])
    x, labels = torch.zeros(2, 3), torch.tensor([1, 2])
    groupnorm.reset_launches()
    resample.reset_launches()
    g(x, labels)  # the eager warm-up (on the CPU: no launch)
    assert groupnorm.launches == resample.launches == 0
    for k in (1, 2, 3):  # the capture and its replay, then replays
        g(x, labels)
        assert groupnorm.launches == 81 * k and resample.launches == 16 * k
    (st,) = g.stats().values()
    assert st["groupnorm_launches"] == 81 and st["replays"] == 3
    assert st["fir_launches"] == 16
    resample.reset_launches()
    groupnorm.reset_launches()
    assert groupnorm.launches == 0
