"""The port's span-and-counter recorder (``tvc_torch/utils/profiler.py``) on
the GOP paths, on the CPU: the tiny configuration of ``tests/conftest.py``
(64x64 frames, ngf 16, 5 sampling steps) with a tiny ELIC and random
LPIPS(alex), all built from seeds in this file, one torch thread.

- off (the default), ``DeviceGOPRunner`` and ``BatchedGOPRunner`` record
  nothing and never open a profiler range;
- on, they give the same bytes as off, the spans nest as the layers do, and
  they count 1 host read a GOP beside its updates' score reads, 1 a lockstep
  sweep beside its chains';
- under ``torch.profiler`` the ``tvc.*`` ranges are the recorded spans, one
  for one, on the same clock;
- the recorder's own bookkeeping, and ``gop send --trace``.
"""

import json

import numpy as np
import pytest
import torch

from tvc_torch import cli
from tvc_torch.core.config import CodecConfig, Config
from tvc_torch.metrics.lpips import LPIPSMetric
from tvc_torch.models.codec.coding import ELICCoder
from tvc_torch.models.codec.elic import make_elic
from tvc_torch.pipeline.batched import BatchedGOPRunner, GOPJob
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.sender import DeviceGOPRunner
from tvc_torch.utils import profiler

SIZE = 64
FORCED = [3, 0, 3, 0, 3, 3, 3]  # 7 updates, 3 coding events
FORCED_T = 21                   # 2 + 3 + 2 + 3 + 2 + 3 + 3 + 3
WALK_T = 8                      # 2 + 3 + 3: two lockstep sweeps
CODEC = CodecConfig(N=16, M=24, groups=(4, 4, 4, 4, 8))
TINY_MODS = ["data.image_size=64", "data.num_frames=3", "model.ngf=16", "model.ch_mult=(1,2)",
             "model.num_res_blocks=1", "model.attn_resolutions=(32,)",
             "model.n_head_channels=8", "model.num_classes=20", "sampling.subsample=5",
             "codec.N=16", "codec.M=24", "codec.groups=(4,4,4,4,8)"]


def tiny_cfg() -> Config:
    cfg = Config()
    cfg.data.image_size = SIZE
    cfg.data.num_frames = 3
    cfg.model.ngf = 16
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (32,)
    cfg.model.n_head_channels = 8
    cfg.model.num_classes = 20
    cfg.sampling.subsample = 5
    cfg.codec = CODEC
    return cfg


def video(n: int, seed: int = 7) -> np.ndarray:
    """A moving pattern with a little noise, (n, 64, 64, 3) in [0, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    frames = np.stack([0.5 + 0.35 * np.sin(2 * np.pi * (xx + 0.5 * yy) + 0.15 * t + c)
                       for t in range(n) for c in range(3)]).reshape(n, 3, SIZE, SIZE)
    frames = frames.transpose(0, 2, 3, 1) + 0.02 * rng.randn(n, SIZE, SIZE, 3)
    return np.clip(frames, 0, 1).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and an empty record."""
    profiler.enable()
    profiler.disable()
    yield
    profiler.disable()


@pytest.fixture(scope="module")
def pipeline():
    cfg = tiny_cfg()
    pred = FramePredictor.create(cfg, seed=0, device="cpu")
    coder = ELICCoder(make_elic(CODEC, seed=0, device="cpu"), "cpu")
    return cfg, pred, coder, LPIPSMetric.create(seed=0, device="cpu")


def run_gop(pipeline, seed=11):
    cfg, pred, coder, lp = pipeline
    runner = DeviceGOPRunner(cfg, pred, lpips=lp, num_frames_total=FORCED_T)
    return runner.run(coder, video(FORCED_T), seed, 0.1, forced_accepts=FORCED, keep_streams=True)


def run_walk(pipeline):
    cfg, pred, coder, lp = pipeline
    runner = BatchedGOPRunner(cfg, pred, {0: coder}, lpips=lp, batch_size=2)
    jobs = [[GOPJob(video=video(WALK_T, seed=s), threshold=1e9, quality=0,
                    num_frames_total=WALK_T)] for s in (1, 2)]
    results, stats = runner.run_walks(jobs, 5, bpp_stop=None)
    return [w[0] for w in results], stats


def recorded(fn, *args):
    with profiler.tracing():
        out = fn(*args)
    return out, profiler.record()


def refuse(*args, **kwargs):
    raise AssertionError("record_function entered with the recorder off")


@pytest.fixture(scope="module")
def runs(pipeline):
    """The forced GOP and the two-chain walk, recorder off (with what it
    recorded) and on."""
    with pytest.MonkeyPatch.context() as mp:
        # a recording span would open a range here, as under a running profiler
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd, "_profiler_enabled", lambda: True)
        profiler.enable()
        profiler.disable()
        off = (run_gop(pipeline), run_walk(pipeline))
        off_rec = profiler.record()
    gop_on, gop_rec = recorded(run_gop, pipeline)
    walk_on, walk_rec = recorded(run_walk, pipeline)
    return off, (gop_on, walk_on), (gop_rec, walk_rec), off_rec


def names(rec):
    return [s["name"] for s in rec["spans"]]


def ancestors(rec, i):
    spans, out = rec["spans"], []
    while spans[i]["parent"] >= 0:
        i = spans[i]["parent"]
        out.append(spans[i]["name"])
    return out


def assert_same_gop(a, b):
    assert a.d.tolist() == b.d.tolist() and a.accepts == b.accepts and a.bits == b.bits
    assert a.containers == b.containers
    assert a.x_ge.dtype == b.x_ge.dtype and a.x_ge.tobytes() == b.x_ge.tobytes()


def test_off_records_nothing_and_opens_no_profiler_range(runs):
    gop, (gops, _) = runs[0]
    assert gop.n_updates == len(FORCED) and all(g is not None for g in gops)
    rec = runs[3]
    assert rec["spans"] == []
    assert set(rec["counters"]) == {"attention.kernel_launches", "groupnorm.kernel_launches",
                                    "groupnorm.spade_launches", "groupnorm.channels_last_writes",
                                    "resample.fir_launches"}
    # the fields the program reports are read all the same
    assert len(gop.update_s) == 7 and len(gop.keyframe_s) == 3 and gop.wall_time > 0


def test_recording_leaves_the_bytes_unchanged(runs):
    (gop_off, (walk_off, stats_off)), (gop_on, (walk_on, stats_on)) = runs[:2]
    assert_same_gop(gop_on, gop_off)
    assert stats_on == stats_off == {"sweeps": 2, "jobs_run": 2, "jobs_skipped": 0}
    for a, b in zip(walk_on, walk_off):
        assert_same_gop(a, b)


def test_spans_nest_as_the_layers(runs):
    gop_rec, walk_rec = runs[2]
    for rec in (gop_rec, walk_rec):
        assert all(s["end_ns"] >= s["start_ns"] for s in rec["spans"])
        for i, name in enumerate(names(rec)):
            up = ancestors(rec, i)
            if name.startswith("codec.chain."):
                assert "codec.entropy" in up and "codec.compress" in up
            if name in ("codec.transforms", "codec.entropy", "codec.synthesis"):
                assert up[0] == "codec.compress"
            if name == "predictor.unet":
                assert up[0] == "predictor.generate"
            if name == "score":
                assert up[0] in ("runner.update", "runner.decide")
    n = names(gop_rec)
    assert n[0] == "runner.gop" and n.count("runner.gop") == 1
    assert n.count("runner.update") == 7 and n.count("runner.keyframe") == 3
    assert n.count("predictor.generate") == 7 and n.count("codec.compress") == 3
    assert n.count("predictor.unet") == gop_rec["counters"]["unet.eager_calls"] == 7 * 6
    assert ancestors(gop_rec, n.index("runner.assemble")) == ["runner.gop"]
    # a fallback pair is coded inside its update
    kf = [ancestors(gop_rec, i) for i, s in enumerate(n) if s == "runner.keyframe"]
    assert kf == [["runner.gop"], ["runner.update", "runner.gop"],
                  ["runner.update", "runner.gop"]]
    w = names(walk_rec)
    assert w[0] == "runner.walks" and w.count("runner.sweep") == 2
    assert w.count("runner.backfill") == 1 and w.count("runner.decide") == 4
    assert "runner.fallback" not in w


def test_spans_carry_their_gops(runs):
    gop_rec, walk_rec = runs[2]
    assert {s["gop"] for s in gop_rec["spans"] if s["name"].startswith("runner.")} == {11}
    by_name = {}
    for s in walk_rec["spans"]:
        by_name.setdefault(s["name"], []).append(s["gop"])
    assert by_name["runner.backfill"] == [[0, 1]]
    assert by_name["runner.sweep"] == [[0, 1], [0, 1]]
    assert by_name["runner.decide"] == [0, 1, 0, 1]
    assert by_name["runner.walks"] == [None]


def test_host_reads_a_gop_and_a_sweep(runs):
    gop_rec, walk_rec = (r["counters"] for r in runs[2])
    # the forced GOP: one score read an update, then the frames' one fetch
    assert gop_rec["reads.score"] == 7 and gop_rec["reads.runner"] == 1
    assert gop_rec["reads.runner.bytes"] == FORCED_T * SIZE * SIZE * 3 * 4
    # the walk at B = 2: each sweep fetches the prediction and reads each chain's scores
    assert walk_rec["reads.runner"] == 2 and walk_rec["reads.score"] == 2 * 2
    assert walk_rec["reads.score.bytes"] == 4 * 3 * 4
    # the codec's device reads: y and z of each compress, and the lockstep batch's frames
    assert gop_rec["reads.codec"] == 3 * 2 and walk_rec["reads.codec"] == 3
    assert gop_rec["codec.frames"] == 3 * 2 and walk_rec["codec.frames"] == 2 * 2
    assert gop_rec["score.frames"] == 3 * 7 and walk_rec["score.frames"] == 3 * 4
    # on the CPU every UNet call is eager
    assert gop_rec["unet.eager_calls"] == 7 * 6 and walk_rec["unet.eager_calls"] == 2 * 6
    assert "graph.replays" not in gop_rec and "kernels.builds" not in gop_rec
    assert gop_rec["uploads"] > 0 and gop_rec["uploads.bytes"] > 0


def test_profiler_ranges_are_the_spans_on_its_clock(pipeline):
    """One update's GOP under torch.profiler: a ``tvc.<name>`` range for
    each span, in the same order, nested the same way, of the same length."""
    from torch.profiler import ProfilerActivity, profile

    cfg, pred, coder, lp = pipeline
    runner = DeviceGOPRunner(cfg, pred, lpips=lp, num_frames_total=5)
    with profiler.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run(coder, video(5), 3, 1e9, keep_streams=True)
    rec = profiler.record()
    ranges = sorted(((e.name[4:], e.time_range.start, e.time_range.end)
                     for e in prof.events() if e.name.startswith("tvc.")),
                    key=lambda r: (r[1], -r[2]))
    assert [r[0] for r in ranges] == names(rec) and len(ranges) > 20
    # nesting by containment on the profiler's clock
    stack, parents = [], []
    for i, (_, a, b) in enumerate(ranges):
        while stack and ranges[stack[-1]][2] < b:
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        stack.append(i)
    assert parents == [s["parent"] for s in rec["spans"]]
    for (_, a, b), s in zip(ranges, rec["spans"]):
        assert abs((b - a) - (s["end_ns"] - s["start_ns"]) / 1e3) < 1e3  # microseconds


def test_recorder_bookkeeping():
    with profiler.span("outside"):  # off: nothing
        pass
    outer = profiler.timed("early")  # opened before enable: seconds, no span
    outer.__enter__()
    profiler.enable()
    outer.__exit__(None, None, None)
    assert outer.seconds >= 0
    ids = [4, 5]
    with profiler.span("a", gop=7):
        with profiler.span("b", gop=lambda: list(ids)):
            profiler.count("c")
            profiler.count("c", 2)
        with profiler.timed("d") as d:
            x = profiler.fetch(torch.arange(6, dtype=torch.float32), "runner")
            profiler.upload(np.zeros(5, np.uint8), "cpu")
            profiler.upload(torch.zeros(3), "cpu", torch.float64)
    profiler.enable()  # while recording: a no-op
    profiler.disable()
    with profiler.span("after"):
        pass
    profiler.count("c")
    rec = profiler.record()  # kept after disable()
    assert names(rec) == ["a", "b", "d"]
    assert [s["parent"] for s in rec["spans"]] == [-1, 0, 0]
    assert [s["gop"] for s in rec["spans"]] == [7, [4, 5], None]
    assert (rec["spans"][2]["end_ns"] - rec["spans"][2]["start_ns"]) / 1e9 == d.seconds
    assert x.tolist() == list(range(6))
    c = rec["counters"]
    assert c["c"] == 3 and c["reads.runner"] == 1 and c["reads.runner.bytes"] == 24
    assert c["uploads"] == 2 and c["uploads.bytes"] == 5 + 12
    assert isinstance(c["attention.kernel_launches"], dict)
    with profiler.tracing():  # a fresh record
        assert profiler._on and profiler.record()["spans"] == []
    assert not profiler._on


def test_device_trace_writes_the_spans_and_counters(tmp_path):
    with profiler.device_trace(str(tmp_path)):
        with profiler.span("work"):
            profiler.count("units")
            torch.ones(8).sum()
    assert not profiler._on
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "tvc.work" for e in events)
    assert json.loads((tmp_path / "counters.json").read_text())["units"] == 1


def test_cli_gop_send_trace(tmp_path):
    np.save(tmp_path / "v.npy", video(5))
    out = tmp_path / "trace"
    rc = cli.main(["gop", "send", "--device", "cpu", "--video-npy", str(tmp_path / "v.npy"),
                   "--payload", str(tmp_path / "g.tvcg"), "--threshold", "1e9",
                   "--allow-uncalibrated", "--device-gop", "--trace", str(out),
                   "--config-mod", *TINY_MODS])
    assert rc == 0 and not profiler._on
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("name", "").startswith("tvc.")}
    assert {"tvc.runner.gop", "tvc.runner.update", "tvc.predictor.generate",
            "tvc.predictor.unet", "tvc.score", "tvc.codec.compress",
            "tvc.codec.chain.nets", "tvc.codec.chain.rans"} <= spans
    counters = json.loads((out / "counters.json").read_text())
    assert counters["reads.score"] == 1 and counters["reads.runner"] == 1
