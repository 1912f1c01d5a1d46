"""tvc_torch's work queue and queued sweep, on the CPU.

Every case of tests/test_queue.py runs against the port's ``WorkQueue``
(claims under concurrency, idempotent completion, stale-claim recovery with
sub-second leases, the no-hardlink single winner and its crash recovery),
and a queue directory written by one package is read alike by the other.
``run_sweep_queued`` drains on the tiny pipeline of tests/conftest.py (the
port's, at the same config): two drains complete every unit, one merges, and
the points equal ``run_sweep``'s exactly (the same GOPs with the same seeds),
through ``run_gop`` and through ``DeviceGOPRunner``; ``sweep --queue-dir``
exits 0 and writes the same points.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tvc.parallel.queue import WorkQueue as JWorkQueue
from tvc_torch import cli
from tvc_torch.parallel.queue import WorkQueue
from tvc_torch.pipeline import driver

from test_torch_gop import TINY_MODS, smooth_video


def _jobs(n):
    return [{"id": f"u{i}", "payload": i} for i in range(n)]


def test_claim_done_roundtrip(tmp_path):
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(3))
    seen = []
    while (job := q.claim("w0")) is not None:
        seen.append(job["payload"])
        q.mark_done(job["id"], {"out": job["payload"] * 10})
    assert sorted(seen) == [0, 1, 2]
    assert q.all_done()
    assert q.results()["u2"] == {"out": 20}


def test_create_or_open_races_to_one_joblist(tmp_path):
    q1 = WorkQueue.create_or_open(str(tmp_path), _jobs(2))
    q2 = WorkQueue.create_or_open(str(tmp_path), _jobs(5))  # the first list stays
    assert len(q2.jobs()) == 2 and q1.jobs() == q2.jobs()
    with pytest.raises(FileNotFoundError):
        WorkQueue.create_or_open(str(tmp_path / "missing"))


def test_duplicate_ids_rejected(tmp_path):
    with pytest.raises(ValueError):
        WorkQueue.create_or_open(str(tmp_path), [{"id": "a"}, {"id": "a"}])


def test_concurrent_claims_are_disjoint(tmp_path):
    n = 40
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(n))
    claimed = {w: [] for w in range(8)}

    def worker(w):
        wq = WorkQueue(str(tmp_path))
        while (job := wq.claim(f"w{w}")) is not None:
            claimed[w].append(job["id"])
            wq.mark_done(job["id"], w)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    ids = [i for v in claimed.values() for i in v]
    assert len(ids) == n and len(set(ids)) == n  # every unit ran exactly once
    assert q.all_done()


def test_stale_claim_recovery(tmp_path):
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(1), stale_after=0.2)
    job = q.claim("dead-host")
    assert job is not None
    assert q.claim("thief") is None  # a live claim
    time.sleep(0.25)
    stolen = q.claim("thief")
    assert stolen is not None and stolen["id"] == job["id"]
    assert q.mark_done(job["id"], "thief-result") is True
    assert q.mark_done(job["id"], "late-dead-host-result") is False
    assert q.results()[job["id"]] == "thief-result"


def test_heartbeat_prevents_steal(tmp_path):
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(1), stale_after=0.4)
    job = q.claim("slow-but-alive")
    for _ in range(3):
        time.sleep(0.2)
        q.heartbeat(job["id"])
    assert q.claim("thief") is None
    q.mark_done(job["id"], 1)


def test_drain_counts_and_pending(tmp_path):
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(5))
    assert q.drain("solo", lambda job: job["payload"]) == 5
    assert q.pending() == []
    assert q.drain("solo", lambda job: 0) == 0


def _no_link(monkeypatch):
    def no_link(src, dst):
        raise OSError("no hardlinks here")

    monkeypatch.setattr(os, "link", no_link)


def test_mark_done_no_hardlink_fallback_single_winner(tmp_path, monkeypatch):
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(1))
    _no_link(monkeypatch)
    assert q.mark_done("u0", {"who": "winner"}) is True
    assert q.mark_done("u0", {"who": "late"}) is False
    assert q.results()["u0"] == {"who": "winner"}
    assert os.path.exists(os.path.join(str(tmp_path), "done", "u0.json.lock"))


def test_mark_done_no_hardlink_racers_keep_one_winner(tmp_path, monkeypatch):
    """Eight threads complete one unit at once without hardlinks: exactly one
    returns True, and its bytes are the ones that persist."""
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(1))
    _no_link(monkeypatch)
    wins = {}
    threads = [threading.Thread(target=lambda w=w: wins.__setitem__(w, q.mark_done(
        "u0", {"who": w}))) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    winners = [w for w, won in wins.items() if won]
    assert len(winners) == 1 and q.results()["u0"] == {"who": winners[0]}


def test_mark_done_no_hardlink_crash_recovery(tmp_path, monkeypatch):
    """A winner that died between lock and rename does not wedge the unit:
    after the grace window the next completer publishes its result and
    still returns False."""
    q = WorkQueue.create_or_open(str(tmp_path), _jobs(1))
    _no_link(monkeypatch)
    path = q._done_path("u0")
    os.close(os.open(path + ".lock", os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    t0 = time.perf_counter()
    assert q.mark_done("u0", {"who": "recoverer"}) is False
    assert time.perf_counter() - t0 >= 0.9  # the 1 s grace window of the JAX package
    assert q.results()["u0"] == {"who": "recoverer"}
    assert q.all_done()


def test_queue_directories_are_shared_with_the_jax_package(tmp_path):
    """A queue created by one package is drained by the other: the files and
    their meaning are the same."""
    jq = JWorkQueue.create_or_open(str(tmp_path), _jobs(3))
    assert jq.claim("jax")["id"] == "u0"
    q = WorkQueue(str(tmp_path))
    assert q.drain("port", lambda job: job["payload"]) == 2
    jq.mark_done("u0", "jax-result")
    assert jq.all_done() and q.results() == jq.results() == {"u0": "jax-result", "u1": 1,
                                                              "u2": 2}


# ------------------------------------------------------------- the queued sweep


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tier-1 workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_pipeline():
    """tests/conftest.py's tiny pipeline, the port's (seeded random weights)."""
    from tvc_torch.cli import build_coder
    from tvc_torch.core.config import load_config
    from tvc_torch.metrics.lpips import LPIPSMetric
    from tvc_torch.pipeline.predictor import FramePredictor

    cfg = load_config(None, TINY_MODS)
    cfg.codec.patch = 64
    return (cfg, FramePredictor.create(cfg, seed=0, device="cpu"), build_coder(cfg, "cpu"),
            LPIPSMetric.create(device="cpu"))


def _points(path, vid):
    return json.loads((path / f"output_{vid}" / "points.json").read_text())


def test_queued_sweep_merges_once_and_equals_run_sweep(tiny_pipeline, tmp_path):
    cfg, pred, coder, lp = tiny_pipeline
    data = np.stack([smooth_video(n=6, seed=s) for s in (0, 1)])
    kw = dict(start_idx=0, end_idx=1, qualities=[4], thresholds=[0.9], with_fvd=False,
              lpips_metric=lp)
    out, qdir = tmp_path / "out", str(tmp_path / "queue")
    n0 = driver.run_sweep_queued(cfg, data, {4: coder}, pred, str(out), qdir, owner="w0", **kw)
    n1 = driver.run_sweep_queued(cfg, data, {4: coder}, pred, str(out), qdir, owner="w1", **kw)
    assert n0 + n1 == 2
    q = WorkQueue(qdir)
    assert q.all_done()
    with open(os.path.join(qdir, "done", "__merged__.json")) as f:
        assert json.load(f) == {"owner": "w0"}  # the first drained process merged
    # a third worker neither runs units again nor merges again
    assert driver.run_sweep_queued(cfg, data, {4: coder}, pred, str(out), qdir, **kw) == 0
    driver.run_sweep(cfg, data, {4: coder}, pred, str(tmp_path / "seq"), save_artifacts=False,
                     **kw)
    for vid in (0, 1):
        assert _points(out, vid) == _points(tmp_path / "seq", vid)
        assert len(_points(out, vid)) == 1 and _points(out, vid)[0]["quality"] == 4


def test_queued_sweep_device_gop(tiny_pipeline, tmp_path):
    """With device_gop the units run through DeviceGOPRunner: the same
    points as the host loop's queue."""
    cfg, pred, coder, lp = tiny_pipeline
    data = smooth_video(n=6, seed=2)[None]
    kw = dict(start_idx=0, end_idx=0, qualities=[4], thresholds=[0.9, 0.05], with_fvd=False,
              lpips_metric=lp)
    assert driver.run_sweep_queued(cfg, data, {4: coder}, pred, str(tmp_path / "dev"),
                                   str(tmp_path / "q_dev"), device_gop=True, **kw) == 1
    driver.run_sweep_queued(cfg, data, {4: coder}, pred, str(tmp_path / "host"),
                            str(tmp_path / "q_host"), **kw)
    assert _points(tmp_path / "dev", 0) == _points(tmp_path / "host", 0)


def test_queued_unit_renews_its_claim(tiny_pipeline, tmp_path, monkeypatch):
    """The background heartbeat keeps a unit's claim younger than its lease
    while the unit runs."""
    cfg, pred, coder, lp = tiny_pipeline
    monkeypatch.setattr(driver, "HEARTBEAT_S", 0.05)
    ages = []
    real = driver.rate_sweep

    def slow_sweep(*a, **k):
        time.sleep(0.6)
        path = os.path.join(str(tmp_path / "q"), "claims", "v0_q4")
        ages.append(time.time() - os.path.getmtime(path))
        return real(*a, **k)

    monkeypatch.setattr(driver, "rate_sweep", slow_sweep)
    driver.run_sweep_queued(cfg, smooth_video(n=6)[None], {4: coder}, pred,
                            str(tmp_path / "out"), str(tmp_path / "q"), qualities=[4],
                            thresholds=[0.9], with_fvd=False, lpips_metric=lp)
    assert ages and ages[0] < 0.45  # unrenewed, the claim would be 0.6 s old


def test_cli_sweep_queue_dir(tmp_path, capsys):
    video = smooth_video(n=6)
    np.save(tmp_path / "d.npy", np.round(video.transpose(0, 3, 1, 2)[None] * 255)
            .astype(np.uint8))
    args = ["sweep", "--data-npy", str(tmp_path / "d.npy"), "--device", "cpu", "--no-fvd",
            "--allow-uncalibrated", "--qualities", "0", "--thresholds", "0.9",
            "--config-mod", *TINY_MODS]
    rc = cli.main(args + ["--output-path", str(tmp_path / "q_out"), "--queue-dir",
                          str(tmp_path / "q"), "--queue-stale-after", "60"])
    assert rc == 0 and "completed 1 work units" in capsys.readouterr().out
    assert cli.main(args + ["--output-path", str(tmp_path / "seq")]) == 0
    assert _points(tmp_path / "q_out", 0) == _points(tmp_path / "seq", 0)
    assert (tmp_path / "q_out" / "config.yml").exists()
