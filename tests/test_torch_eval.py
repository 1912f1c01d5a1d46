"""tvc_torch's evaluation networks and metrics against the JAX package's.

The same seeded numpy inputs go through the JAX function (the oracle) and the
port on the CPU. Weights are drawn whole on the port (every conv, bias and
all four BatchNorm tensors, positive variances), carried into JAX by the JAX
package's own loaders (``load_i3d_weights``, ``load_inception_weights``,
``convert_vgg16``/``convert_squeezenet``), and the port's ``*_from_jax``
converters are checked the other way. The JAX networks take their parameter
shapes from ``jax.eval_shape``: their constructors' eager ``init`` runs a
full forward (65 s for the I3D on this CPU), which the oracle does not need.

Tolerances (max |port - JAX|): the I3D's units, SAME pools and an inception
block 1e-5 of the largest value; the whole I3D at 224x224 and InceptionV3 at
299x299 1e-4 of the largest feature; ``preprocess_video`` 1e-5 (upscale) and
5e-5 (a non-integer downscale, where JAX's own float32 resize lies 8.4e-6 from
a float64 one and the port's 1e-7); the resize weights 1e-6; FVD in the
sweep's repeated-pair form 1e-4 relative, and ``frechet_distance`` on the same features 1e-12 relative; FVD
features of two distinct videos 1e-4 of the largest (their Fréchet distance
is ill-conditioned at a batch of two and is not compared); VGG and SqueezeNet
LPIPS and ``lpips_video`` 1e-5; ``ssim`` 1e-12, ``ssim_torch`` 1e-5; the
``calculate_*`` wrappers the same keys and values within those tolerances;
FID/PR 1e-9 relative on the same features.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.metrics import fid_pr as jfid
from tvc.metrics import video as jvideo
from tvc.metrics.backbones import convert_squeezenet, convert_vgg16
from tvc.metrics.frechet import frechet_distance as j_frechet
from tvc.metrics.fvd import FVDMetric as JFVDMetric
from tvc.metrics.fvd import preprocess_video as j_preprocess
from tvc.metrics.lpips import LPIPS as JLPIPS
from tvc.metrics.lpips import LPIPSMetric as JLPIPSMetric
from tvc.metrics.lpips import lpips_video as j_lpips_video
from tvc.metrics.pixel import ssim as j_ssim
from tvc.metrics.pixel import ssim_jax
from tvc.models import i3d as ji3d
from tvc.models.inception import FIDInceptionFeatures as JFID
from tvc.models.inception import InceptionV3Features as JInceptionV3
from tvc.models.inception import load_inception_weights as j_load_inception
from tvc_torch.metrics import fid_pr, video
from tvc_torch.metrics.frechet import frechet_distance
from tvc_torch.metrics.fvd import FVDMetric, preprocess_video
from tvc_torch.metrics.lpips import LPIPS, LPIPSMetric, lpips_video
from tvc_torch.metrics.pixel import ssim, ssim_torch
from tvc_torch.models import i3d
from tvc_torch.models.i3d import InceptionI3d, InceptionModule, Unit3D, init_conv_bn_
from tvc_torch.models.inception import FIDInceptionFeatures, InceptionV3Features
from tvc_torch.ops.image_resize import resize_weights
from tvc_torch.utils.convert import (
    i3d_from_jax,
    inception_from_jax,
    lpips_from_jax,
    squeezenet_from_jax,
    vgg16_from_jax,
)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The suite runs files in parallel workers; two intra-op threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _zeros(model, *args):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _assert_sd_equal(got, want):
    got = {k: v for k, v in got.items()}
    want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


def _random_i3d(seed=0):
    model = InceptionI3d(device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.eval()


def _jax_i3d_params(port):
    return ji3d.load_i3d_weights(
        _zeros(ji3d.InceptionI3d(), jnp.zeros((1, 10, 224, 224, 3))), _np_sd(port))


class _JaxFVD(JFVDMetric):
    """The JAX FVDMetric on given parameters: its ``features`` and
    ``__call__`` unchanged, its constructor's eager init forward skipped."""

    def __init__(self, params, batch_size=10):
        self.model = ji3d.InceptionI3d()
        self.params, self.batch_size, self.calibrated = params, batch_size, True
        fn = jax.jit(lambda p, v: self.model.apply({"params": p}, v))
        self._feats = lambda v: fn(self.params, v)


@pytest.fixture(scope="module")
def i3d_pair():
    """The port's seeded I3D, and the JAX FVD oracle on the same weights
    (compiled once per module)."""
    port = _random_i3d()
    return port, _JaxFVD(_jax_i3d_params(port))


def _videos(b, t, h, w, seed):
    return np.random.RandomState(seed).rand(b, t, h, w, 3).astype(np.float32)


# ------------------------------------------------------------------ I3D pieces


@pytest.mark.parametrize("n,k,s", [(10, 7, 2), (11, 7, 2), (224, 7, 2), (9, 3, 2), (8, 2, 2),
                                   (7, 3, 1), (5, 1, 1), (4, 3, 3)])
def test_same_pads_match_lax(n, k, s):
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert i3d.same_pads([n], [k], [s]) == list(want)


@pytest.mark.parametrize("shape", [(1, 9, 17, 15, 3), (2, 8, 16, 14, 3)], ids=["odd", "even"])
def test_unit3d_stride2_matches_jax(shape):
    unit = Unit3D(3, 8, (7, 7, 7), (2, 2, 2), device="cpu")
    init_conv_bn_(unit, torch.Generator().manual_seed(1))
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    junit = ji3d.Unit3D(8, (7, 7, 7), (2, 2, 2))
    params = _zeros(junit, jnp.asarray(x))
    ji3d._convert_unit(params, {f"u.{k}": v for k, v in _np_sd(unit).items()}, "u")
    want = np.asarray(junit.apply({"params": params}, x))
    with torch.no_grad():
        got = unit(torch.tensor(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (shape[0],) + tuple(-(-n // 2) for n in shape[1:4]) + (8,)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kernel,stride", [((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)),
                                           ((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2))])
@pytest.mark.parametrize("shape", [(1, 7, 9, 11, 4), (1, 8, 10, 12, 4)], ids=["odd", "even"])
def test_max_pool_same_matches_flax(shape, kernel, stride):
    """Signed inputs: the padding is -inf, as flax's, not pytorch_i3d's 0."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = np.asarray(ji3d._max_pool_same(jnp.asarray(x), kernel, stride))
    got = i3d.max_pool_same(torch.tensor(x).permute(0, 4, 1, 2, 3), kernel, stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


def test_inception_module_matches_jax():
    out = (8, 6, 10, 4, 6, 6)
    block = InceptionModule(12, out, device="cpu")
    init_conv_bn_(block, torch.Generator().manual_seed(4))
    x = np.maximum(np.random.RandomState(5).randn(1, 4, 9, 9, 12), 0).astype(np.float32)
    jblock = ji3d.InceptionModule(out)
    params = _zeros(jblock, jnp.asarray(x))
    sd = _np_sd(block)
    for br in ji3d._BRANCHES:
        ji3d._convert_unit(params[br], sd, br)
    want = np.asarray(jblock.apply({"params": params}, x))
    with torch.no_grad():
        got = block(torch.tensor(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    _close(got, want, 1e-5)


def test_i3d_matches_jax_at_224(i3d_pair):
    port, jfvd = i3d_pair
    x = np.random.RandomState(6).uniform(-1, 1, (1, 10, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jfvd._feats(x))
    with torch.no_grad():
        got = port(torch.tensor(x).permute(0, 4, 1, 2, 3).contiguous()).numpy()
    assert got.shape == want.shape == (1, 400) and np.abs(want).max() > 1.0
    _close(got, want, 1e-4)
    # and the other way: the JAX tree back into the port's keys
    _assert_sd_equal(i3d_from_jax(jax.tree_util.tree_map(np.asarray, jfvd.params)),
                     _np_sd(port))


@pytest.mark.parametrize("prefix", ["", "end_points."])
def test_pytorch_i3d_checkpoint_loads_without_a_converter(prefix, tmp_path):
    """pytorch_i3d's keys, with or without ``end_points.`` and without
    ``num_batches_tracked`` (older checkpoints), load strictly."""
    sd = {prefix + k: v.clone() for k, v in _random_i3d(7).state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert "Mixed_3b.b1b.bn.running_var" in [k[len(prefix):] for k in sd]
    torch.save(sd, tmp_path / "i3d.pt")
    metric = FVDMetric(torch.load(tmp_path / "i3d.pt", weights_only=True), device="cpu")
    assert metric.calibrated
    for k, v in metric.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[prefix + k]), k
    assert not FVDMetric(device="cpu").calibrated


def test_convert_tf_name_matches_jax():
    names = ["Conv3d_1a_7x7/conv_3d/w:0", "Mixed_3b/Branch_0/Conv3d_0a_1x1/batch_norm/beta:0",
             "Mixed_3b/Branch_1/Conv3d_0b_3x3/conv_3d/w:0",
             "Mixed_5b/Branch_2/Conv3d_0a_1x1/conv_3d/w:0",
             "Mixed_5b/Branch_2/Conv3d_0a_3x3/conv_3d/w:0",
             "Mixed_4c/Branch_3/Conv3d_0b_1x1/batch_norm/moving_variance:0",
             "Mixed_4c/Branch_2/Conv3d_0a_1x1/batch_norm/moving_mean:0",
             "Logits/Conv3d_0c_1x1/conv_3d/b:0", "Conv3d_2c_3x3/batch_norm/beta:0"]
    for name in names:
        assert i3d.convert_tf_name(name) == ji3d.convert_tf_name(name), name
    assert i3d.convert_tf_name(names[0]) == "Conv3d_1a_7x7.conv3d.weight"
    assert i3d.convert_tf_name(names[1]) == "Mixed_3b.b0.bn.bias"
    assert i3d.convert_tf_name(names[2]) == "Mixed_3b.b1b.conv3d.weight"
    assert i3d.convert_tf_name(names[3]) == "Mixed_5b.b2a.conv3d.weight"
    tf = {"Conv3d_1a_7x7/conv_3d/w:0": np.random.RandomState(8).randn(7, 7, 7, 3, 64),
          "Conv3d_1a_7x7/batch_norm/beta:0": np.random.RandomState(9).randn(1, 1, 1, 1, 64)}
    got, want = i3d.tf_vars_to_state_dict(tf), ji3d.tf_vars_to_state_dict(tf)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["Conv3d_1a_7x7.conv3d.weight"].shape == (64, 3, 7, 7, 7)
    assert got["Conv3d_1a_7x7.bn.bias"].shape == (64,)


# ------------------------------------------------------------------ FVD


@pytest.mark.parametrize("hw,tol", [((64, 64), 1e-5), ((48, 80), 1e-5), ((300, 256), 5e-5)],
                         ids=["up_square", "up_wide", "down_tall"])
def test_preprocess_video_matches_jax(hw, tol):
    v = _videos(1, 3, *hw, seed=10)[0]
    want = np.asarray(j_preprocess(jnp.asarray(v)))
    got = preprocess_video(torch.tensor(v)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (3, 224, 224, 3)
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("n_in,n_out,kernel", [(300, 263, "bilinear"), (256, 224, "bilinear"),
                                                (128, 224, "bilinear"), (64, 128, "cubic"),
                                                (257, 224, "cubic")])
def test_resize_weights_equal_jax(n_in, n_out, kernel):
    import jax._src.image.scale as jscale

    fn = {"bilinear": jscale._fill_triangle_kernel, "cubic": jscale._fill_keys_cubic_kernel}
    want = jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, fn[kernel], True)
    np.testing.assert_allclose(resize_weights(n_in, n_out, kernel), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_fvd_in_the_sweeps_form_matches_jax(i3d_pair):
    """The sweep's call: the GOP and the ground truth, each repeated to a
    batch of two, so each side's covariance is 0 and FVD = |mu1 - mu2|^2."""
    port, jfvd = i3d_pair
    metric = FVDMetric(_np_sd_tensors(port), device="cpu")
    gt, rec = _videos(1, 10, 64, 64, 11), _videos(1, 10, 64, 64, 12)
    v1, v2 = np.repeat(rec, 2, 0), np.repeat(gt, 2, 0)
    want = jfvd(v1, v2)
    got = metric(v1, v2)
    assert np.isfinite(got) and want > 0
    assert abs(got - want) <= 1e-4 * want
    f1, f2 = metric.features(v1), metric.features(v2)
    assert abs(frechet_distance(f1, f2) - j_frechet(f1, f2)) <= 1e-12 * abs(j_frechet(f1, f2))


def _np_sd_tensors(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_fvd_features_of_distinct_videos_match_jax(i3d_pair):
    port, jfvd = i3d_pair
    metric = FVDMetric(_np_sd_tensors(port), device="cpu", batch_size=1)
    videos = _videos(2, 10, 64, 80, 13)
    _close(metric.features(videos), jfvd.features(videos), 1e-4)


# ------------------------------------------------------------------ InceptionV3


def test_inception_v3_matches_jax():
    port = InceptionV3Features(device="cpu")
    port.init_weights(torch.Generator().manual_seed(14))
    port.eval()
    jmodel = JInceptionV3()
    params = j_load_inception(_zeros(jmodel, jnp.zeros((1, 299, 299, 3))), _np_sd(port))
    x = np.random.RandomState(15).uniform(-1, 1, (2, 299, 299, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(params, x))
    with torch.no_grad():
        got = port(torch.tensor(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.shape == want.shape == (2, 2048) and np.abs(want).max() > 0.1
    _close(got, want, 1e-4)
    _assert_sd_equal(inception_from_jax(params), _np_sd(port))

    # the FID handle: 64x64 images resized to 299 and rescaled to [-1, 1]
    jfid_handle = JFID.__new__(JFID)
    jfid_handle.model, jfid_handle.params, jfid_handle.batch_size = jmodel, params, 2
    fn = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))
    jfid_handle._fn = lambda v: fn(params, v)
    imgs = np.random.RandomState(16).rand(2, 64, 64, 3).astype(np.float32)
    handle = FIDInceptionFeatures(_np_sd_tensors(port), batch_size=2, device="cpu")
    assert handle.calibrated
    _close(handle(imgs), jfid_handle(imgs), 1e-4)


# ------------------------------------------------------------------ LPIPS backbones


def _random_lpips(net_type, seed):
    model = LPIPS(device="cpu", net_type=net_type)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("lin"):
                p.uniform_(0.0, 0.2, generator=g)  # heads are clamped at 0
            elif name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=g)
            else:
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5, generator=g)
    return model.eval()


def _jax_lpips_params(model):
    net_type = model.net_type
    x = jnp.zeros((1, 64, 64, 3))
    params = _zeros(JLPIPS(net_type=net_type), x, x)
    backbone = {k[len("net."):]: v for k, v in _np_sd(model).items() if k.startswith("net.")}
    params["net"] = {"vgg": convert_vgg16, "squeeze": convert_squeezenet}[net_type](
        params["net"], backbone)
    for k in range(len(model.taps)):
        params[f"lin{k}"] = getattr(model, f"lin{k}").detach().numpy().transpose(2, 3, 1, 0)
    return params


@pytest.mark.parametrize("net_type", ["vgg", "squeeze"])
def test_lpips_backbones_match_jax(net_type):
    model = _random_lpips(net_type, 17)
    params = _jax_lpips_params(model)
    _assert_sd_equal(lpips_from_jax(params, net_type), _np_sd(model))
    backbone = {"vgg": vgg16_from_jax, "squeeze": squeezenet_from_jax}[net_type](params["net"])
    _assert_sd_equal(backbone, _np_sd(model.net))
    jmetric = JLPIPSMetric(params=params, calibrated=False, net_type=net_type)
    metric = LPIPSMetric(model, False)
    a, b = _videos(1, 3, 64, 64, 18)[0], _videos(1, 3, 64, 64, 19)[0]
    want = np.asarray(jmetric(a, b))
    assert want.shape == (3,) and want.min() > 0
    np.testing.assert_allclose(metric(a, b).numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lpips_video(metric, a, b), j_lpips_video(jmetric, a, b),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("net_type", ["vgg", "squeeze"])
def test_lpips_loads_torchvision_backbones(net_type, tmp_path):
    """A torchvision state dict (``features.*`` and a classifier the trunk
    does not have) and the LPIPS heads load from files, as in the JAX package."""
    src = _random_lpips(net_type, 20)
    backbone = {k[len("net."):]: v for k, v in src.state_dict().items() if k.startswith("net.")}
    backbone["classifier.1.weight"] = torch.zeros(3, 3)
    torch.save(backbone, tmp_path / "net.pth")
    torch.save({f"lin{k}.model.1.weight": getattr(src, f"lin{k}").detach().clone()
                for k in range(len(src.taps))}, tmp_path / "lin.pth")
    metric = LPIPSMetric.create(str(tmp_path / "net.pth"), str(tmp_path / "lin.pth"),
                                device="cpu", net_type=net_type)
    assert metric.calibrated
    for k, v in src.state_dict().items():
        assert torch.equal(metric.model.state_dict()[k], v), k


# ------------------------------------------------------------------ SSIM


@pytest.mark.parametrize("shape", [(3, 32, 40), (1, 24, 24), (20, 30)])
def test_ssim_matches_jax(shape):
    a = np.random.RandomState(21).rand(*shape)
    b = np.clip(a + 0.1 * np.random.RandomState(22).randn(*shape), 0, 1)
    want = j_ssim(a, b)
    assert abs(ssim(a, b) - want) <= 1e-12 and 0 < want < 1


def test_ssim_torch_matches_jax():
    a = _videos(1, 4, 32, 40, 23)[0]
    b = np.clip(a + 0.1 * np.random.RandomState(24).randn(*a.shape), 0, 1).astype(np.float32)
    want = np.asarray(ssim_jax(jnp.asarray(a), jnp.asarray(b)))
    got = ssim_torch(torch.tensor(a), torch.tensor(b)).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # and the host float64 version frame by frame
    host = [ssim(x.transpose(2, 0, 1), y.transpose(2, 0, 1)) for x, y in zip(a, b)]
    np.testing.assert_allclose(got, host, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the video wrappers


def _assert_same_result(got, want, tol):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            assert list(got[k]) == list(want[k])
            for key in want[k]:
                assert abs(got[k][key] - want[k][key]) <= tol * max(1.0, abs(want[k][key])), key
        elif isinstance(want[k], list):
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name", ["psnr", "ssim", "lpips"])
def test_frame_wrappers_match_jax(name):
    v1 = _videos(2, 4, 32, 32, 25)
    v2 = np.clip(v1 + 0.05 * np.random.RandomState(26).randn(*v1.shape), 0, 1).astype(np.float32)
    if name == "lpips":
        model = _random_lpips("vgg", 27)
        kw = {"metric": LPIPSMetric(model, False)}
        jkw = {"metric": JLPIPSMetric(params=_jax_lpips_params(model), calibrated=False,
                                      net_type="vgg")}
        tol = 1e-5
    else:
        kw = jkw = {}
        tol = 1e-12
    got = getattr(video, f"calculate_{name}")(v1, v2, calculate_per_frame=2, **kw)
    want = getattr(jvideo, f"calculate_{name}")(v1, v2, calculate_per_frame=2, **jkw)
    _assert_same_result(got, want, tol)
    assert list(got[name]) == ["[:2]", "[:4]", "final"]


def test_calculate_fvd_matches_jax(i3d_pair):
    """Prefixes under 10 frames are skipped: 12 frames by 5 give [:10] only."""
    port, jfvd = i3d_pair
    metric = FVDMetric(_np_sd_tensors(port), device="cpu")
    v1, v2 = _videos(2, 12, 32, 32, 28), _videos(2, 12, 32, 32, 29)
    v1[1], v2[1] = v1[0], v2[0]  # repeated pairs: a well-conditioned distance
    got = video.calculate_fvd(v1, v2, metric=metric, calculate_per_frame=5)
    want = jvideo.calculate_fvd(v1, v2, metric=jfvd, calculate_per_frame=5)
    assert list(got) == list(want) and list(got["fvd"]) == list(want["fvd"]) == ["[:10]", "final"]
    for k in want["fvd"]:
        assert abs(got["fvd"][k] - want["fvd"][k]) <= 1e-4 * want["fvd"][k], k
    assert got["fvd_video_setting"] == want["fvd_video_setting"]


# ------------------------------------------------------------------ FID / PR


def test_fid_pr_matches_jax():
    rng = np.random.RandomState(30)
    real, fake = rng.randn(40, 16), rng.randn(36, 16) * 1.1 + 0.2
    got, want = fid_pr.get_fid_pr(real, fake, k=3), jfid.get_fid_pr(real, fake, k=3)
    assert got[1:] == want[1:] and abs(got[0] - want[0]) <= 1e-9 * abs(want[0])
    np.testing.assert_array_equal(fid_pr.nearest_neighbor_indices(fake[:5], real, k=4,
                                                                  feat_samples_flipped=fake[5:10]),
                                  jfid.nearest_neighbor_indices(fake[:5], real, k=4,
                                                                feat_samples_flipped=fake[5:10]))
    # the epsilon repair of a singular product
    mu, sig = np.zeros(3), np.diag([1.0, 0.0, 2.0])
    assert abs(fid_pr.calculate_frechet_distance(mu, sig, mu + 1, sig)
               - jfid.calculate_frechet_distance(mu, sig, mu + 1, sig)) <= 1e-9
