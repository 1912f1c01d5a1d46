"""tvc_torch ELIC codec against the JAX package's, on the tiny codec of
tests/conftest.py (N=16, M=24, groups (4, 4, 4, 4, 8)) at 64x64.

Weights: a random port state dict (every parameter drawn, so no zero bias
or zero factor hides a path) -> ``tvc.utils.convert.convert_elic_state_dict``
-> JAX variables.

Tolerances: checkerboard packing, symbols, scale indexes and containers
exactly (byte for byte); layers, transforms and the entropy parameters
(mu, scales) of every slice and phase within 1e-5 x max |reference|;
reconstructions within 1e-4 (float32 through g_s).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.models.codec import checkerboard as jcb
from tvc.models.codec import container as jcontainer
from tvc.models.codec import layers as jlayers
from tvc.models.codec.coding import ELICCoder as JELICCoder
from tvc.models.codec.elic import ELICModel as JELICModel
from tvc.utils.convert import (
    _attention_block,
    _conv,
    _deconv,
    _rbb,
    _residual_unit,
    convert_elic_state_dict,
)
from tvc_torch.core.config import CodecConfig
from tvc_torch.models.codec import checkerboard as cb
from tvc_torch.models.codec import container, layers
from tvc_torch.models.codec.coding import ELICCoder, num_coded_bytes
from tvc_torch.models.codec.elic import ELICModel, make_elic
from tvc_torch.pipeline import keyframe
from tvc_torch.utils.convert import elic_from_jax, load_codec_checkpoint

N, M, GROUPS = 16, 24, (4, 4, 4, 4, 8)
REL = 1e-5
GS_GAIN = 0.5


def randomize_(module: torch.nn.Module, seed: int, gain: float = 1.0) -> torch.nn.Module:
    """Every parameter at random: conv weights N(0, gain^2 / fan_in), the
    rest N(0, 0.1^2), the factorized prior's matrices/biases/factors
    N(0, 0.7^2) around ordered quantiles."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("quantiles"):
                c = p.shape[0]
                med = rng.randn(c)
                q = np.stack([med - rng.uniform(4, 12, c), med, med + rng.uniform(4, 12, c)])
                p.copy_(torch.tensor(q.T[:, None, :], dtype=torch.float32))
            elif "entropy_bottleneck" in name:
                p.copy_(torch.tensor(rng.randn(*p.shape) * 0.7, dtype=torch.float32))
            elif p.dim() == 4:
                p.copy_(torch.tensor(rng.randn(*p.shape) * gain / math.sqrt(p[0].numel()),
                                     dtype=torch.float32))
            else:
                p.copy_(torch.tensor(rng.randn(*p.shape) * 0.1, dtype=torch.float32))
    return module


def random_elic(seed: int = 0) -> ELICModel:
    """The tiny codec with random weights. g_a's gain makes the latents span
    many integers and scale bins; g_s's keeps its output within a few units of
    [0, 1], so that an ulp in a mean stays an ulp in the frame."""
    model = randomize_(ELICModel(N, M, GROUPS, device="cpu"), seed, gain=1.1)
    randomize_(model.g_s, seed + 1, gain=GS_GAIN)
    return model.eval()


def jax_codec(model: ELICModel):
    """The JAX ELIC and its variables, converted from the port's state dict."""
    return (JELICModel(N=model.N, M=model.M, groups=model.groups),
            convert_elic_state_dict(model.state_dict(), groups=model.groups))


def frames(n, seed, size=64):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} x {scale}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here use one intra-op thread: the models are tiny,
    and beside the suite's other worker processes a thread per core makes
    every small op wait at a barrier for threads the cores cannot run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def codecs():
    model = random_elic(0)
    jmodel, variables = jax_codec(model)
    return model, jmodel, variables


# ---------------------------------------------------------------- layers


def test_checkerboard_matches_jax():
    y = torch.tensor(np.random.RandomState(1).randn(2, 3, 8, 6).astype(np.float32))
    yj = jnp.asarray(nhwc(y))
    for fn, jfn in ((cb.pack_anchor, jcb.pack_anchor), (cb.pack_nonanchor, jcb.pack_nonanchor),
                    (cb.keep_anchor, jcb.keep_anchor), (cb.keep_nonanchor, jcb.keep_nonanchor)):
        np.testing.assert_array_equal(nhwc(fn(y)), np.asarray(jfn(yj)))
    pa, pn = cb.pack_anchor(y), cb.pack_nonanchor(y)
    assert pa.shape == (2, 3, 8, 3)
    np.testing.assert_array_equal(nhwc(cb.unpack_anchor(pa)),
                                  np.asarray(jcb.unpack_anchor(jnp.asarray(nhwc(pa)))))
    np.testing.assert_array_equal(nhwc(cb.unpack_nonanchor(pn)),
                                  np.asarray(jcb.unpack_nonanchor(jnp.asarray(nhwc(pn)))))
    assert torch.equal(cb.unpack_anchor(pa) + cb.unpack_nonanchor(pn), y)


def _layer_cases():
    """(name, port layer, JAX layer, JAX params from the port's state dict, input channels)."""
    return [
        ("conv_k5s2", layers.Conv(5, 7), jlayers.Conv(7, 5, 2), lambda sd: {"conv": _conv(sd, "l")}, 5),
        ("conv_k5s1", layers.Conv(6, 4, 5, 1), jlayers.Conv(4, 5, 1),
         lambda sd: {"conv": _conv(sd, "l")}, 6),
        ("deconv", layers.Deconv(6, 5), jlayers.Deconv(5), lambda sd: {"conv": _deconv(sd, "l")}, 6),
        ("conv1x1", layers.Conv1x1(6, 9), jlayers.Conv1x1(9), lambda sd: {"conv": _conv(sd, "l")}, 6),
        ("conv3x3", layers.Conv3x3(6, 9), jlayers.Conv3x3(9), lambda sd: {"conv": _conv(sd, "l")}, 6),
        ("rbb", layers.ResidualBottleneckBlock(8), jlayers.ResidualBottleneckBlock(8),
         lambda sd: _rbb(sd, "l"), 8),
        ("residual_unit", layers.ResidualUnit(8), jlayers.ResidualUnit(8),
         lambda sd: _residual_unit(sd, "l"), 8),
        ("attention_block", layers.AttentionBlock(8), jlayers.AttentionBlock(8),
         lambda sd: _attention_block(sd, "l"), 8),
        ("masked_conv", layers.CheckboardMaskedConv(4, 8), jlayers.CheckboardMaskedConv(8),
         lambda sd: {"weight": sd["l.weight"].numpy().transpose(2, 3, 1, 0),
                     "bias": sd["l.bias"].numpy()}, 4),
    ]


@pytest.mark.parametrize("case", range(len(_layer_cases())),
                         ids=[c[0] for c in _layer_cases()])
def test_layer_matches_jax(case):
    _, layer, jlayer, params, cin = _layer_cases()[case]
    randomize_(layer.eval(), seed=case)
    sd = {f"l.{k}": v for k, v in layer.state_dict().items()}
    x = torch.tensor(np.random.RandomState(10 + case).randn(2, cin, 6, 8).astype(np.float32))
    with torch.no_grad():
        got = layer(x)
    want = jlayer.apply({"params": params(sd)}, jnp.asarray(nhwc(x)))
    assert_close(nhwc(got), want)


def test_checkerboard_mask_is_the_references():
    np.testing.assert_array_equal(layers.checkerboard_mask(5, 5), jlayers.checkerboard_mask(5, 5))
    conv = layers.CheckboardMaskedConv(2, 3)
    assert "mask" not in conv.state_dict()  # the raw weight is the parameter


@pytest.mark.parametrize("stage", ["g_a", "h_a", "h_s", "g_s"])
def test_transforms_match_jax(codecs, stage):
    model, jmodel, variables = codecs
    rng = np.random.RandomState(11)
    x = {"g_a": rng.rand(2, 3, 64, 64), "h_a": rng.randn(2, M, 4, 4) * 3,
         "h_s": np.round(rng.randn(2, N, 1, 1) * 3), "g_s": np.round(rng.randn(2, M, 4, 4) * 3)}
    xt = torch.tensor(x[stage].astype(np.float32))
    with torch.no_grad():
        got = getattr(model, stage)(xt)
    want = jmodel.apply(variables, jnp.asarray(nhwc(xt)), method=getattr(JELICModel, stage))
    assert_close(nhwc(got), want)


def test_elic_from_jax_inverts_the_converter(codecs):
    model, _, variables = codecs
    back = elic_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    fresh = ELICModel(N, M, GROUPS, device="cpu")
    fresh.load_state_dict(back, strict=True)


def test_load_codec_checkpoint_drops_derived_buffers(tmp_path, codecs):
    """A reference-style checkpoint (wrapped, with compressai's CDF buffers,
    the Gaussian conditional's and the context masks) loads as stored."""
    model = codecs[0]
    sd = dict(model.state_dict())
    sd.update({"entropy_bottleneck._offset": torch.zeros(N, dtype=torch.int32),
               "entropy_bottleneck._quantized_cdf": torch.zeros(N, 9, dtype=torch.int32),
               "entropy_bottleneck._cdf_length": torch.zeros(N, dtype=torch.int32),
               "gaussian_conditional.scale_table": torch.ones(64),
               "gaussian_conditional._offset": torch.zeros(64, dtype=torch.int32),
               "context_prediction.0.mask": torch.ones(8, 4, 5, 5)})
    path = tmp_path / "elic.pth.tar"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    loaded = load_codec_checkpoint(str(path))
    assert set(loaded) == set(model.state_dict())
    fresh = ELICModel(N, M, GROUPS, device="cpu")
    fresh.load_state_dict(loaded, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---------------------------------------------------------------- the bitstream


class _Recorder:
    """Records each phase's (symbols, mu, scales) and the z symbols a coder codes."""

    def __init__(self, coder):
        self.phases, self.z = [], []
        code_phase, quantize = coder._code_phase, coder.fb.quantize

        def rec_phase(y, mu, sc):
            self.phases.append((np.round(y - mu).astype(np.int32), np.asarray(mu), np.asarray(sc)))
            return code_phase(y, mu, sc)

        def rec_quantize(z):
            out = quantize(z)
            self.z.append(out[1])
            return out

        coder._code_phase, coder.fb.quantize = rec_phase, rec_quantize


@pytest.fixture(scope="module")
def one_frame(codecs):
    """One frame coded by both packages (the JAX coder runs its frames on
    threads, so phases are recorded one frame at a time)."""
    model, jmodel, variables = codecs
    x = frames(1, 12)
    port, jport = ELICCoder(model, "cpu"), JELICCoder(jmodel, variables, entropy_backend="cpu")
    rec, jrec = _Recorder(port), _Recorder(jport)
    enc = port.compress(x, return_recon=True)
    jenc = jport.compress(x, return_recon=True)
    return enc, jenc, rec, jrec, jport


def test_entropy_parameters_match_jax(one_frame):
    _, _, rec, jrec, _ = one_frame
    assert len(rec.phases) == len(jrec.phases) == 2 * len(GROUPS)
    for (_, mu, sc), (_, jmu, jsc) in zip(rec.phases, jrec.phases):
        assert_close(mu, jmu)
        assert_close(sc, jsc)


def test_symbols_match_jax(one_frame):
    _, _, rec, jrec, jport = one_frame
    np.testing.assert_array_equal(rec.z[0], jrec.z[0].transpose(0, 3, 1, 2))
    for (s, _, sc), (js, _, jsc) in zip(rec.phases, jrec.phases):
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(jport.gc.build_indexes(sc), jport.gc.build_indexes(jsc))
    # the test codes more than zeros, and reaches several scale bins
    syms = np.concatenate([s.reshape(-1) for s, _, _ in rec.phases])
    assert np.abs(syms).max() >= 3 and len(np.unique(syms)) >= 5
    idx = np.concatenate([jport.gc.build_indexes(sc).reshape(-1) for _, _, sc in rec.phases])
    assert len(np.unique(idx)) >= 8


def test_reconstruction_matches_jax(one_frame):
    enc, jenc, _, _, _ = one_frame
    assert_close(enc["x_hat"], jenc["x_hat"], rel=1e-4)


@pytest.mark.parametrize("backend", [None, "cpu", "device"])
def test_containers_match_jax(codecs, backend):
    """The same pair through both packages: the same container, byte for byte
    (TVC1, and TVC2 with either backend byte)."""
    model, jmodel, variables = codecs
    x = frames(2, 13)
    port = ELICCoder(model, backend or "cpu")
    jport = JELICCoder(jmodel, variables, entropy_backend=backend or "cpu")
    blob = container.serialize(port.compress(x), entropy_backend=backend)
    jblob = jcontainer.serialize(jport.compress(x), entropy_backend=backend)
    assert blob[:4] == (b"TVC1" if backend is None else b"TVC2")
    assert blob == jblob


def test_jax_container_decodes_in_port(codecs, one_frame):
    """A container the JAX package wrote decodes in the port to the JAX
    package's symbols, and to its reconstruction within 1e-4."""
    model = codecs[0]
    _, jenc, _, jrec, jport = one_frame
    blob = jcontainer.serialize(jenc, entropy_backend="cpu")
    port = ELICCoder(model, "cpu")
    decoded = []
    decode_batch = port.gc._dec.decode_batch

    def rec(*args):
        out = decode_batch(*args)
        decoded.append(out)
        return out

    port.gc._dec.decode_batch = rec
    enc = container.deserialize(blob, expect_entropy_backend="cpu")
    x_hat = port.decompress(enc["strings"], enc["shape"])["x_hat"]
    assert len(decoded) == 2 * len(GROUPS)
    for got, (js, _, _) in zip(decoded, jrec.phases):
        np.testing.assert_array_equal(got, js.reshape(-1))
    assert_close(x_hat, jport.decompress(jenc["strings"], jenc["shape"])["x_hat"], rel=1e-4)


@pytest.mark.parametrize("backend", [None, "cpu", "device"])
def test_container_headers_read_both_ways(codecs, backend):
    x = frames(2, 14)
    enc = ELICCoder(codecs[0], backend or "cpu").compress(x)
    for write, read in ((container.serialize, jcontainer.deserialize),
                        (jcontainer.serialize, container.deserialize)):
        got = read(write(enc, entropy_backend=backend), expect_entropy_backend=backend)
        assert got["strings"] == enc["strings"] and got["shape"] == enc["shape"]
        assert got["entropy_backend"] == backend
    if backend is not None:
        other = "cpu" if backend == "device" else "device"
        with pytest.raises(ValueError, match="entropy_backend"):
            container.deserialize(container.serialize(enc, backend), expect_entropy_backend=other)
    with pytest.raises(ValueError):
        container.deserialize(container.serialize(enc, backend) + b"\0")


@pytest.mark.parametrize("backend", ["cpu", "device"])
def test_port_roundtrip_is_byte_identical(codecs, backend):
    coder = ELICCoder(codecs[0], backend)
    x = frames(2, 15)
    enc = coder.compress(x, return_recon=True)
    got = container.deserialize(container.serialize(enc, backend), expect_entropy_backend=backend)
    dec = coder.decompress(got["strings"], got["shape"])
    assert enc["x_hat"].shape == (2, 64, 64, 3)
    assert enc["x_hat"].tobytes() == dec["x_hat"].tobytes()
    bits = keyframe.per_frame_bits(enc["strings"], 2)
    assert sum(bits) == 8 * num_coded_bytes(enc["strings"])


def test_pair_codes_like_its_frames(codecs):
    """The entropy chain runs frame by frame, so a pair's streams are its
    frames' streams."""
    coder = ELICCoder(codecs[0], "cpu")
    x = frames(2, 16)
    pair = coder.compress(x)["strings"]
    for f in range(2):
        one = coder.compress(x[f: f + 1])["strings"]
        assert one[1] == [pair[1][f]]
        assert one[0] == [[[ph[f]] for ph in sl] for sl in pair[0]]


def test_code_frames_pads_and_crops(codecs):
    coder = ELICCoder(codecs[0], "cpu")
    x = frames(2, 17, size=64)[:, :50, :60]
    x_hat, bits = keyframe.code_frames(coder, x, patch=64)
    assert x_hat.shape == x.shape and len(bits) == 2 and min(bits) > 0


def test_make_elic_is_seeded():
    cfg = CodecConfig(N=N, M=M, groups=GROUPS)
    a, b = (make_elic(cfg, seed=3, device="cpu") for _ in range(2))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not torch.equal(a.g_a[0].weight, make_elic(cfg, seed=4, device="cpu").g_a[0].weight)


def test_paths_left_out_raise(codecs):
    """The fused forwards, the simulation coder and code_frames_device are
    ported (tests/test_torch_serving.py); the library-only layers are held
    against the JAX package in tests/test_torch_zoo.py."""
    model = codecs[0]
    x = torch.zeros(1, 3, 64, 64)
    with torch.no_grad():
        assert model.inference(x)["x_hat"].shape == x.shape
    assert torch.is_tensor(keyframe.code_frames_device(ELICCoder(model), frames(1, 0))[0])


def test_chain_takes_contiguous_nchw_at_both_ends(codecs):
    """g_a's latents keep the layout of its input (a permuted NHWC frame is
    channels-last), and a convolution may take another algorithm, with other
    bits, for another memory format: the chain must see the same contiguous
    layout when it encodes and when it decodes."""
    model = codecs[0]
    coder = ELICCoder(model, "cpu")
    layouts = []
    hyper, nonanchor = coder._chain.hyper_params, coder._chain.nonanchor_params

    def rec_hyper(z):
        layouts.append(z.is_contiguous())
        return hyper(z)

    def rec_nonanchor(i, y_anchor, sup):
        layouts.append(y_anchor.is_contiguous() and sup.is_contiguous())
        return nonanchor(i, y_anchor, sup)

    coder._chain.hyper_params, coder._chain.nonanchor_params = rec_hyper, rec_nonanchor
    enc = coder.compress(frames(2, 18), return_recon=True)
    coder.decompress(enc["strings"], enc["shape"])
    assert len(layouts) == 2 * 2 * (1 + len(GROUPS)) and all(layouts)


def test_chain_bits_tool_runs_narrow_on_the_host():
    from tvc_torch.tools import chain_bits

    report = chain_bits.main(["--device", "cpu", "--narrow"])
    assert report["threads_1_again"] == {"maps": 22, "maps_differ": 0, "max_rel_diff": 0.0}
    for key in ("channels_last", "threads_2", "threads_4"):
        assert report[key]["maps"] == 22 and report[key]["max_rel_diff"] < 1e-4
