"""tvc_torch's throughput harness, fast init and profiler on the CPU.

The harness runs at a tiny config (5 frames predicted from 2, so the forced
worst-case trajectory [5, 0, 5, 0, 5, 5, 5] and the accept-all one make 7
and 6 updates as at full size), 2 sampler steps and a lockstep batch of 2.
Its times are the CPU's and mean nothing; the test holds the harness's
plumbing: every field of ``BenchResult`` finite, the trajectories' update
counts, and ``bench.py``'s output format.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core.config import Config as JConfig
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.utils.profiler import count_params as j_count_params
from tvc_torch.bench import throughput
from tvc_torch.core.config import Config
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.utils import fastinit, profiler

from test_torch_ncsnpp import tiny_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_cfg() -> Config:
    cfg = tiny_cfg(Config)
    cfg.data.num_frames = 5
    cfg.codec.N, cfg.codec.M, cfg.codec.groups = 16, 24, (4, 4, 4, 4, 8)
    return cfg



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the tier-1 run shares the host's
    cores among its workers, and an oversubscribed OpenMP pool made one tiny
    UNet call 10-100x slower on an 8-core host (0.03 s alone, 0.36 s on one
    thread under load, 5-7 s on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LAST_LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


def test_bench_py_prints_the_same_last_line_keys():
    """The root bench.py's last print names exactly these keys."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    last = src[src.rindex("print(json.dumps({"):src.rindex("}))")]
    assert set(re.findall(r'"(\w+)":', last)) == LAST_LINE_KEYS


@pytest.fixture(scope="module")
def bench_run():
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = throughput.main(["--device", "cpu", "--steps", "2", "--throughput-batch", "2"],
                             cfg=bench_cfg())
    return rc, out.getvalue(), err.getvalue()


def test_bench_pipeline_fields_are_finite(bench_run):
    rc, _, err = bench_run
    assert rc == 0
    line = next(ln for ln in err.splitlines() if ln.startswith("[bench] result "))
    res = json.loads(line[len("[bench] result "):])
    assert set(res) == {f.name for f in throughput.dataclasses.fields(throughput.BenchResult)}
    for k, v in res.items():
        assert np.isfinite(v), k
    assert res["n_sample_steps"] == 2 and res["throughput_batch"] == 2
    assert res["fused_gop_cycles"] == len(throughput.FORCED) == 7
    for k in ("t_unet_step", "t_cycle", "t_keyframe_pair", "t_keyframe_pair_fused",
              "t_cycle_batched", "t_fused_gop", "t_device_gop", "t_device_gop_acceptall",
              "fps_device_gop", "fps_device_gop_bound", "compile_time"):
        assert res[k] > 0, k
    assert res["t_device_gop_min"] <= res["t_device_gop"] <= res["t_device_gop_max"]


def test_bench_main_prints_bench_py_lines(bench_run):
    _, out, err = bench_run
    last = json.loads(out.strip().splitlines()[-1])
    assert set(last) == LAST_LINE_KEYS
    assert last["unit"] == "frames/s/chip" and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 0.125, 2)
    info = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])
    assert info["platform"] == "cpu" and info["dtype"] == "bf16"
    assert info["precision_schedule"] == "uniform"
    for k in ("t_cycle100_s", "t_device_gop_s", "fps_device_gop_bound", "fps_throughput_batched",
              "fps_gop_model"):
        assert k in info


def test_bench_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        throughput.main(["--quick"])


def test_fast_init_predictor_holds_bf16_fills():
    cfg = bench_cfg()
    pred = FramePredictor.create(cfg, device="cpu", dtype=torch.bfloat16,
                                 params_dtype=torch.bfloat16, fast_init=True)
    for p in pred.model.parameters():
        assert p.dtype == torch.bfloat16
        assert torch.all(p == torch.tensor(0.01, dtype=torch.bfloat16))


def test_random_like_is_keyed_by_name_and_seed():
    cfg = bench_cfg()
    a = fastinit.random_like(UNetMoreDDPM(cfg, device="cpu"), scale=0.02, seed=3)
    b = fastinit.random_like(UNetMoreDDPM(cfg, device="cpu"), scale=0.02, seed=3)
    c = fastinit.random_like(UNetMoreDDPM(cfg, device="cpu"), scale=0.02, seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(torch.equal(sa[k], sc[k]) for k in sa if sa[k].numel() > 1)
    # two weights of one shape get other draws
    k0 = next(k for k in sa if k.endswith("NIN_0.W"))
    w0, w1 = sa[k0], sa[k0.replace("NIN_0", "NIN_1")]
    assert w0.shape == w1.shape and not torch.equal(w0, w1)
    flat = torch.cat([v.flatten() for v in sa.values()])
    assert abs(flat.std().item() - 0.02) < 2e-3
    assert fastinit.leaf_seed("x", 3) != fastinit.leaf_seed("x", 4)


def test_zeros_like_and_force_fetch():
    m = fastinit.zeros_like(torch.nn.Linear(3, 4))
    assert all(torch.all(p == 0.01) for p in m.parameters())
    assert fastinit.zeros_like(torch.nn.Linear(2, 2), fill=0.5).weight[0, 0].item() == 0.5
    assert fastinit.force_fetch(torch.arange(5.0) + 2) == 2.0


@pytest.mark.parametrize("full", [False, True], ids=["tiny", "flagship"])
def test_count_params_matches_jax(full):
    jcfg, cfg = (JConfig(), Config()) if full else (tiny_cfg(JConfig), tiny_cfg(Config))
    size, c = cfg.data.image_size, cfg.data.channels
    shapes = jax.eval_shape(
        JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, size, size, c * cfg.data.num_frames), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.int32),
        jax.ShapeDtypeStruct((1, size, size, c * cfg.data.num_frames_cond), jnp.float32))
    model = UNetMoreDDPM(cfg, device="meta")
    n = profiler.count_params(model)
    assert n == j_count_params(shapes) == profiler.count_params(model.state_dict())
    if full:
        assert round(n / 1e6, 1) == 262.1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiler.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
