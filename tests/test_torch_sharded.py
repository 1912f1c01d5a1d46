"""tvc_torch's processes on gloo, on the CPU: the launcher's bring-up with a
queued sweep merged once, ``FusedGOPSender.run_sharded`` with one chain a
process, and the sharded serving dry run.

Worker processes are spawned fresh (``torch.distributed`` over gloo; they
import neither JAX nor the JAX package). Tolerances: ``run_sharded``'s
output is ``run_batched``'s on each process's own chain byte for byte (the
same loop on the same local batch), and the gathered global batch is the
same on both processes; against the JAX package's ``run_sharded`` on a
two-device CPU mesh, with JAX's draws handed in, the decisions, accept
counts and update counts are equal and the predicted frames within 1e-4
(tests/test_torch_serving.py's bound for the whole-GOP sender).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tvc.pipeline.fused_gop import FusedGOPSender as JFusedGOPSender
from tvc_torch.core.config import save_config

from test_torch_gop import (  # noqa: F401  (module-scoped fixtures)
    THRESHOLDS,
    TINY_MODS,
    jax_noise,
    one_torch_thread,
    pipelines,
    smooth_video,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
T = 6
MIXED = THRESHOLDS[2]

_SHARDED_WORKER = r"""
import sys
import numpy as np
import torch
from tvc_torch.core.config import load_config
from tvc_torch.metrics.lpips import LPIPS, LPIPSMetric
from tvc_torch.models.codec.coding import ELICCoder
from tvc_torch.models.codec.elic import ELICModel
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.parallel.mesh import initialize_distributed, make_mesh
from tvc_torch.parallel.train import dryrun_serving
from tvc_torch.pipeline.fused_gop import FusedGOPSender
from tvc_torch.pipeline.predictor import FramePredictor

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
cfg = load_config(f"{d}/cfg.yml")
w = torch.load(f"{d}/weights.pt", weights_only=True)
unet = UNetMoreDDPM(cfg, device="cpu")
unet.load_state_dict(w["unet"])
codec = ELICModel(int(w["N"]), int(w["M"]), tuple(w["groups"]), device="cpu")
codec.load_state_dict(w["codec"])
lp = LPIPS(device="cpu")
lp.load_state_dict(w["lpips"])
sender = FusedGOPSender(cfg, FramePredictor(cfg, unet), ELICCoder(codec, "cpu"),
                        LPIPSMetric(lp, False), num_frames_total=int(w["T"]))
inp = np.load(f"{d}/inputs.npz")
noise = lambda u: (torch.from_numpy(inp[f"x{rank}"][u]), torch.from_numpy(inp[f"e{rank}"][u]))
mine = slice(rank, rank + 1)
args = (inp["videos"][mine], [rank], inp["thresholds"][mine])
out = sender.run_sharded(make_mesh(), *args, noises=[noise])
local = sender.run_batched(*args, noises=[noise])
res = {f"g/{k}": v.numpy() for k, v in out.items()}
res.update({f"l/{k}": v.numpy() for k, v in local.items()})
res.update({f"s/{k}": np.float64(v) for k, v in dryrun_serving(make_mesh(), device="cpu").items()})
np.savez(f"{d}/out{rank}.npz", **res)
torch.distributed.destroy_process_group()
"""

_LAUNCH_WORKER = r"""
import json, sys
import torch.distributed as dist
import tvc_torch.cli as cli
from tvc_torch.parallel import launcher

seen = {}
real = cli.main

def spy(argv):
    seen.update(world=dist.get_world_size(), rank=dist.get_rank(), backend=dist.get_backend(),
                argv=argv)
    return real(argv)

cli.main = spy
rc = launcher.main(sys.argv[1:])
print(json.dumps(dict(rc=rc, **seen)))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(cmds, env_extra=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=dict(env, **(env_extra or {}).get(i, {})),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, cmd in enumerate(cmds)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return logs


@pytest.fixture(scope="module")
def sharded_run(pipelines, tmp_path_factory):
    """The port's pipeline weights, two chains and JAX's draws for them, and
    the two workers' results."""
    d = tmp_path_factory.mktemp("sharded")
    cfg, pred, coder, lp = pipelines[0]
    save_config(cfg, str(d / "cfg.yml"))
    torch.save({"unet": pred.model.state_dict(), "codec": coder.model.state_dict(),
                "lpips": lp.model.state_dict(), "T": T, "N": coder.model.N, "M": coder.model.M,
                "groups": list(coder.model.groups)}, d / "weights.pt")
    videos = np.stack([smooth_video(n=T, seed=s) for s in (7, 9)])
    keys = jax.random.split(jax.random.PRNGKey(8), WORLD)
    draws = {}
    for b in range(WORLD):
        src = jax_noise(keys[b], pred)
        pairs = [src(u) for u in range(T)]  # at most one update a frame
        draws[f"x{b}"] = np.stack([p[0].numpy() for p in pairs])
        draws[f"e{b}"] = np.stack([p[1].numpy() for p in pairs])
    thresholds = np.asarray([MIXED, 1e9], np.float32)
    np.savez(d / "inputs.npz", videos=videos, thresholds=thresholds, **draws)
    port = _free_port()
    _spawn([[sys.executable, "-c", _SHARDED_WORKER, str(r), str(port), str(d)]
            for r in range(WORLD)])
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]
    return videos, keys, thresholds, outs


def test_run_sharded_is_run_batched_on_each_local_chain(sharded_run):
    _, _, _, outs = sharded_run
    for rank, out in enumerate(outs):
        for k in ("x_ge", "d", "bits", "n_updates", "accepts"):
            g, loc = out[f"g/{k}"], out[f"l/{k}"]
            assert g.shape[0] == WORLD and g.dtype == loc.dtype
            assert g[rank:rank + 1].tobytes() == loc.tobytes(), (rank, k)
            assert g.tobytes() == outs[1 - rank][f"g/{k}"].tobytes(), k  # one global batch


def test_run_sharded_matches_jax_on_a_cpu_mesh(pipelines, sharded_run):
    """The gathered batch against the JAX package's ``run_sharded`` on a
    two-device CPU mesh: the decisions, the accept and update counts and the
    predicted frames. That program's fallback keyframes come out other than
    its own ``run`` and ``run_batched``'s (ROADMAP.md, section C); the port's
    keyframes and bits are ``run_batched``'s byte for byte (above), which
    tests/test_torch_serving.py holds to the JAX package's ``run_batched``."""
    videos, keys, thresholds, outs = sharded_run
    jcfg, jpred, jcoder, jlp = pipelines[1]
    jfused = JFusedGOPSender(cfg=jcfg, predictor=jpred, coder=jcoder, lpips=jlp,
                             num_frames_total=T)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    with mesh:
        want = {k: np.asarray(v)
                for k, v in jfused.run_sharded(mesh, videos, keys, thresholds).items()}
    got = outs[0]
    for b in range(WORLD):
        assert int(got["g/n_updates"][b]) == int(want["n_updates"][b])
        np.testing.assert_array_equal(got["g/d"][b], want["d"][b])
        np.testing.assert_array_equal(got["g/accepts"][b], want["accepts"][b])
        predicted = got["g/d"][b] == 0
        np.testing.assert_allclose(got["g/x_ge"][b][predicted], want["x_ge"][b][predicted],
                                   atol=1e-4, rtol=0)
    # chain 0 mixes accepts and fallbacks; chain 1 accepts every prediction
    assert 0 in got["g/accepts"][0].tolist()
    assert got["g/d"][1].tolist() == [1, 1] + [0] * (T - 2)


def test_dryrun_serving_on_two_processes(sharded_run):
    for out in sharded_run[3]:
        assert float(out["s/serving_chains"]) == WORLD
        assert np.isfinite(float(out["s/serving_bits"]))
    assert float(sharded_run[3][0]["s/serving_bits"]) == float(sharded_run[3][1]["s/serving_bits"])


def test_launcher_brings_up_gloo_and_merges_a_queue_once(tmp_path):
    """Two launcher processes (``TVC_*`` variables) run ``sweep --queue-dir``:
    both join one gloo group and get the sharding flags; the units are run
    once across them, exactly one process merges, and the merged points are
    a one-process sequential sweep's."""
    data = np.stack([smooth_video(n=T, seed=s) for s in (0, 1)])
    np.save(tmp_path / "d.npy", np.round(data.transpose(0, 1, 4, 2, 3) * 255).astype(np.uint8))
    sweep = ["sweep", "--data-npy", str(tmp_path / "d.npy"), "--device", "cpu", "--no-fvd",
             "--allow-uncalibrated", "--qualities", "0", "--thresholds", "0.9",
             "--end-idx", "1", "--config-mod", *TINY_MODS]
    qdir = tmp_path / "q"
    env = {r: {"TVC_COORDINATOR": f"127.0.0.1:{_free_port() if r == 0 else 0}",
               "TVC_NUM_PROCESSES": str(WORLD), "TVC_PROCESS_ID": str(r)} for r in range(WORLD)}
    env[1]["TVC_COORDINATOR"] = env[0]["TVC_COORDINATOR"]
    logs = _spawn([[sys.executable, "-c", _LAUNCH_WORKER, *sweep, "--output-path",
                    str(tmp_path / "out"), "--queue-dir", str(qdir)] for _ in range(WORLD)],
                  env_extra=env)
    res = [json.loads(log.strip().splitlines()[-1]) for log in logs]
    for r, out in enumerate(res):
        assert out["rc"] == 0 and out["world"] == WORLD and out["rank"] == r
        assert out["backend"] == "gloo"
        assert out["argv"][-4:] == ["--num-processes", str(WORLD), "--process-id", str(r)]
    done = [int(log.split("[queue] this process completed ")[1].split()[0]) for log in logs]
    assert sum(done) == 2
    assert sum("[queue] merged" in log for log in logs) == 1
    assert os.path.exists(qdir / "done" / "__merged__.json")

    from tvc_torch import cli

    assert cli.main(sweep + ["--output-path", str(tmp_path / "seq")]) == 0
    for vid in (0, 1):
        got = json.loads((tmp_path / "out" / f"output_{vid}" / "points.json").read_text())
        want = json.loads((tmp_path / "seq" / f"output_{vid}" / "points.json").read_text())
        assert got == want


def test_launcher_partitions_a_batched_sweep(tmp_path):
    """Two launcher processes run ``sweep --batched``: each takes its static
    share of the (video, quality) walks, and together they cover the rate
    points of one process's sweep. Their values differ: a walk's chains are
    seeded by its index in the process's own list, as in the JAX package."""
    data = np.stack([smooth_video(n=T, seed=s) for s in (0, 1)])
    np.save(tmp_path / "d.npy", np.round(data.transpose(0, 1, 4, 2, 3) * 255).astype(np.uint8))
    sweep = ["sweep", "--data-npy", str(tmp_path / "d.npy"), "--device", "cpu", "--no-fvd",
             "--allow-uncalibrated", "--qualities", "0", "--thresholds", "0.9", "0.05",
             "--end-idx", "1", "--batched", "2", "--config-mod", *TINY_MODS]
    coord = f"127.0.0.1:{_free_port()}"
    env = {r: {"TVC_COORDINATOR": coord, "TVC_NUM_PROCESSES": str(WORLD),
               "TVC_PROCESS_ID": str(r)} for r in range(WORLD)}
    logs = _spawn([[sys.executable, "-c", _LAUNCH_WORKER, *sweep, "--output-path",
                    str(tmp_path / f"out{r}")] for r in range(WORLD)], env_extra=env)
    for r, log in enumerate(logs):
        out = json.loads(log.strip().splitlines()[-1])
        assert out["rc"] == 0 and out["argv"][-1] == str(r)

    from tvc_torch import cli

    assert cli.main(sweep + ["--output-path", str(tmp_path / "one")]) == 0
    for vid in (0, 1):
        got = [json.loads((tmp_path / f"out{r}" / f"output_{vid}" / "points.json").read_text())
               for r in range(WORLD) if (tmp_path / f"out{r}" / f"output_{vid}").exists()]
        assert len(got) == 1  # walk (vid, 0) ran in exactly one process
        want = json.loads((tmp_path / "one" / f"output_{vid}" / "points.json").read_text())
        assert ([(p["quality"], p["threshold"]) for p in got[0]]
                == [(p["quality"], p["threshold"]) for p in want])
