"""The frame predictor's ``draws`` against what each sampler consumes: the
rows it makes, their order, and the frames a generator gives against the
frames its draws give (byte for byte, in one process on one torch thread).

Split from test_torch_graph.py (same weights and config), so that the
tier-1 run's workers take the two files apart.
"""

import pytest
import torch

from tvc_torch.core.config import Config
from tvc_torch.pipeline.predictor import FramePredictor
from test_torch_graph import tiny_cfg, weights  # noqa: F401  (module-scoped fixture)


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


@pytest.mark.parametrize("version,gamma,t_min,rows,calls", [
    ("DDPM", False, -1.0, 6, 6),
    ("DDPM", True, 0.5, 7, 5),
    ("DDPM", False, 9.0, 6, 1),
    ("DDIM", False, -1.0, 0, 6),
    ("DDIM", True, 0.5, 1, 5),
    ("FPNDM", False, -1.0, 0, 14),
])
def test_draws_match_what_the_sampler_consumes(weights, version, gamma, t_min, rows, calls):
    """``draws`` makes exactly the rows the sampler reads, in a fixed order, and
    a generator gives the frames its draws give."""
    _, unet = weights
    pred = FramePredictor(tiny_cfg(Config, version, gamma, t_min), unet)
    x_init, noise = pred.draws(torch.Generator().manual_seed(5), 2)
    assert x_init.shape == (2, 64, 64, 9) and noise.shape == (rows, 2, 64, 64, 9)
    assert pred.n_steps == calls
    plan = pred.noise_plan()
    if plan is not None and version == "DDPM":
        # a step that adds no noise (or does not run) draws nothing
        assert not noise[:plan.n_steps][~torch.as_tensor(plan.rows)].any()
    seen = []
    forward = unet.forward

    def counting(x, labels, cond):
        seen.append(labels[0].item())
        return forward(x, labels, cond)

    cond = torch.rand(2, 64, 64, 6, generator=torch.Generator().manual_seed(1))
    unet.forward = counting
    try:
        a = pred.generate(cond, generator=torch.Generator().manual_seed(5))
    finally:
        del unet.forward
    b = pred.generate(cond, x_init=x_init, noise=noise)
    assert torch.equal(a, b)
    assert len(seen) == calls
    with pytest.raises(ValueError, match="noise rows"):
        pred.generate(cond, x_init=x_init, noise=torch.zeros((rows + 1,) + tuple(x_init.shape)))
