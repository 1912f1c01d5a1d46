"""The frame predictor under every sampler against the JAX package, its draws,
and the CUDA-graph wrapper's bookkeeping.

The predictor parity feeds the port the draws JAX's ``FramePredictor.generate``
makes: ``x_init`` from the first half of the split key, the sampler's step
and warm-start draws from the second (``jax.random.split`` as each sampler
splits it, ``_gamma_noise`` and ``fold_in(k, 1)`` where it uses them).
Tolerance: max |diff| <= 1e-4 on frames in [0, 1], as for DDPM
(test_torch_sampler.py): the tiny UNet's float32 rounding carries through up
to 14 calls.

``draws`` against what each sampler consumes is in test_torch_graph_draws.py.

On the CPU the predictor calls its UNet eagerly; the graphed UNet's
bookkeeping (an eager first call, then static buffers, one graph per input
signature, the cloned output, launch counts, a capture that fails) is
checked here with a stand-in capture, and the graphs themselves by the
card-only tests in test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.pipeline.predictor import FramePredictor as JFramePredictor
from tvc.samplers.ancestral import _gamma_noise
from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.ops import attention
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.samplers import graph as graph_mod
from tvc_torch.samplers.ancestral import active_steps
from tvc_torch.samplers.graph import GraphedEps
from tvc_torch.utils.convert import unet_from_jax

TOL = 1e-4

# version, model.gamma, sampling.init_prev_t
CASES = {
    "ddpm_gamma_t_min": ("DDPM", True, 0.5),
    "ddim_t_min": ("DDIM", False, 0.5),
    "fpndm": ("FPNDM", False, -1.0),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the tier-1 run shares the host's
    cores among its workers, and an oversubscribed OpenMP pool made one tiny
    UNet call 10-100x slower on an 8-core host (0.03 s alone, 0.36 s on one
    thread under load, 5-7 s on eight)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(cls, version="DDPM", gamma=False, t_min=-1.0):
    """The tiny config of tests/conftest.py (``tiny_pipeline``) with a sampler."""
    cfg = cls()
    cfg.data.image_size = 64
    cfg.data.num_frames = 3
    cfg.data.num_frames_cond = 2
    cfg.model.ngf = 16
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (32,)
    cfg.model.n_head_channels = 8
    cfg.model.num_classes = 20
    cfg.sampling.subsample = 5
    cfg.model.version = version
    cfg.model.gamma = gamma
    cfg.sampling.init_prev_t = t_min
    return cfg


@pytest.fixture(scope="module")
def weights():
    """Random JAX variables for the tiny UNet and the port's UNet holding them."""
    jcfg, cfg = tiny_cfg(JConfig), tiny_cfg(Config)
    size = cfg.data.image_size
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 9)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, size, size, 6)))
    rng = np.random.RandomState(42)
    variables = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.08).astype(np.float32), shapes)
    unet = UNetMoreDDPM(cfg, device="cpu")
    unet.load_state_dict(unet_from_jax(cfg, variables), strict=True)
    return variables, unet


def jax_draws(jpred, key, b):
    """x_init and the port's ``noise`` rows as JAX ``FramePredictor.generate`` draws them."""
    cfg = jpred.cfg
    shape = (b, cfg.data.image_size, cfg.data.image_size, cfg.data.channels * cfg.data.num_frames)
    knoise, ksamp = jax.random.split(key)
    x_init = np.asarray(jax.random.normal(knoise, shape, jnp.float32))
    if jpred.version == "FPNDM":
        return x_init, np.zeros((0,) + shape, np.float32)
    sub, gamma, t_min = jpred.sub, cfg.model.gamma, cfg.sampling.init_prev_t
    L = len(sub)
    n = L + 1  # denoise
    keys = jax.random.split(ksamp, L + 1 if jpred.version == "DDPM" else n)
    a = np.concatenate([sub.alphas, [sub.alphas[-1]]]).astype(np.float32)

    def draw(k, i):
        if not gamma:
            return np.asarray(jax.random.normal(k, shape, jnp.float32))
        g = min(i, L - 1)
        return np.asarray(_gamma_noise(k, shape, jnp.float32(sub.k_cum[g]),
                                       jnp.float32(sub.theta_t[g]), jnp.float32(a[i]),
                                       jnp.float32))

    rows = [draw(keys[i], i) for i in range(n)] if jpred.version == "DDPM" else []
    _, warm = active_steps(sub, n, t_min)
    if warm is not None:
        k = jax.random.fold_in(keys[warm], 1) if jpred.version == "DDPM" else keys[warm]
        rows.append(draw(k, warm))
    return x_init, np.stack(rows)


@pytest.mark.parametrize("case", list(CASES))
def test_predictor_matches_jax(weights, case):
    version, gamma, t_min = CASES[case]
    variables, unet = weights
    jpred = JFramePredictor(tiny_cfg(JConfig, version, gamma, t_min), variables)
    pred = FramePredictor(tiny_cfg(Config, version, gamma, t_min), unet)
    cond = np.random.RandomState(3).rand(2, 64, 64, 6).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jpred.generate(key, jnp.asarray(cond)))
    x_init, noise = jax_draws(jpred, key, 2)
    got = pred.generate(cond, x_init=torch.tensor(x_init), noise=torch.tensor(noise)).numpy()
    assert got.shape == want.shape == (2, 3, 64, 64, 3)
    assert 0.01 < want.std()
    np.testing.assert_allclose(got, want, atol=TOL)
    assert pred.graphs.entries == {}  # the CPU calls the UNet eagerly


def test_flagship_unet_calls(weights):
    """UNet calls per update at the flagship schedule: DDPM and DDIM 101,
    F-PNDM 109, DDPM from init_prev_t = 0.5 96 (raw steps 50-990 against
    0.5 x 100, and the denoise step)."""
    _, unet = weights
    counts = {}
    for version, t_min in (("DDPM", -1.0), ("DDIM", -1.0), ("FPNDM", -1.0), ("DDPM", 0.5)):
        cfg = Config()
        cfg.model.version, cfg.sampling.init_prev_t = version, t_min
        counts[(version, t_min)] = FramePredictor(cfg, unet).n_steps
    assert counts == {("DDPM", -1.0): 101, ("DDIM", -1.0): 101, ("FPNDM", -1.0): 109,
                      ("DDPM", 0.5): 96}


def test_smld_predictor_is_refused(weights):
    _, unet = weights
    with pytest.raises(ValueError, match="anneal_langevin_dynamics"):
        FramePredictor(tiny_cfg(Config, "SMLD"), unet)
    with pytest.raises(ValueError, match="unknown sampler"):
        FramePredictor(tiny_cfg(Config, "nope"), unet)


class _Replayer:
    """A CPU stand-in for a captured graph: replay reruns ``fn`` on the static inputs."""

    def __init__(self, fn, inputs, out):
        self.fn, self.inputs, self.out = fn, inputs, out

    def replay(self):
        self.out.copy_(self.fn(**self.inputs))


def _fake_capture(launches):
    def capture(fn, inputs):
        out = fn(**inputs)
        return _Replayer(fn, inputs, out), out, launches, 0
    return capture


def test_graphed_sampler_buffers_and_keys(monkeypatch):
    """The samplers' graphed UNet: an eager first call per input signature,
    then one graph per signature that reads x, the labels and cond from its
    static buffers, a cloned output, and launches counted at each replay."""
    monkeypatch.setattr(graph_mod, "capture", _fake_capture(10))
    calls = []

    def eps(x, labels, cond=None):
        calls.append(x.data_ptr())
        return x * 2 + labels.float()[:, None] + (0 if cond is None else cond)

    g = GraphedEps(eps)
    x = torch.arange(4.0).reshape(2, 2)
    attention.reset_launches()
    out0 = g(x, torch.tensor([1, 2]))  # the eager warm-up: no graph yet
    assert torch.equal(out0, eps(x, torch.tensor([1, 2])))
    assert calls[0] == x.data_ptr() and g.entries == {} and attention.launches == 0
    calls.clear()
    out1 = g(x + 1, torch.tensor([5, 6]))  # captured, then replayed
    assert torch.equal(out1, (x + 1) * 2 + torch.tensor([[5.0], [6.0]])) and len(calls) == 2
    assert attention.launches == 10  # counted at the replay, not at the capture
    out1.zero_()  # the output is a clone
    assert torch.equal(g(x, torch.tensor([0, 1])), x * 2 + torch.tensor([[0.0], [1.0]]))
    assert attention.launches == 20 and len(calls) == 3
    (st,) = g.stats().values()
    assert st["replays"] == 2 and st["attention_launches"] == 10
    cond = torch.ones(2, 2)
    for _ in range(2):  # float labels and a cond: other signatures, other graphs
        g(x, torch.tensor([0.5, 1.5]))
        assert torch.equal(g(x, torch.tensor([0, 1]), cond), x * 2 + torch.tensor([[1.0], [2.0]]))
    assert len(g.entries) == 3 and len(g.warm) == 3


def test_graphed_sampler_raises_on_a_failed_capture(monkeypatch):
    def failing(fn, inputs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graph_mod, "capture", failing)
    g = GraphedEps(lambda x, labels, cond: x + 1)
    assert torch.equal(g(torch.zeros(2), torch.zeros(2)), torch.ones(2))
    with pytest.raises(RuntimeError, match="capture of the UNet call"):
        g(torch.zeros(2), torch.zeros(2))
    assert g.entries == {}


def test_attention_counts_graph_launches_on_replay():
    attention.reset_launches()
    attention.count_launches(1010)
    assert attention.launches == 1010
    attention.reset_launches()
    assert attention.launches == 0
