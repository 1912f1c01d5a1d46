"""tvc_torch's tensor parallelism over the model axis, on gloo on the CPU,
against one process and against the JAX package's sharding rule.

Worker processes (spawned fresh; they import neither JAX nor the JAX
package) form a (data, model) mesh of 1 x 2 and of 2 x 2. Each takes its data
index's slice of the global batch and draws, holds its model index's slice of
every kernel the rule shards (the output channels of each kernel of at least
2**16 elements that the model axis divides), and takes one train step. The
configs are the dry run's tiny one at ngf 64 (so that kernels pass the
rule's size) for the 2-D, 3-D and pseudo-3-D nets.

Tolerances (tests/test_torch_train_zoo.py's, over test_torch_ddp.py's): the
loss relative 1e-6; the gathered (clipped) gradients within 1e-5 of each
tensor's magnitude (a layer's slice is a product of another shape, summed
in another order; the input gradients are summed over the model group), or
within 1e-7 of the largest gradient, about one float32 ulp of it, where a
small tensor's gradient is a sum that cancels (the pseudo-3-D net's frame
converter's bias); each parameter after the first
Adam step within lr x min(2, |g - g_ref| / (min(|g|, |g_ref|) + eps)) +
1e-6 x lr + two float32 ulps; the EMA within (1 - ema_rate) of that bound.
The slices, the collectives and the snapshots move bytes and must be exact.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tvc.core.config import Config as JConfig
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.parallel.mesh import shard_params as j_shard_params
from tvc_torch.core.config import Config
from tvc_torch.losses.dsm import draw_dsm
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.parallel.mesh import Mesh, shard_params
from tvc_torch.parallel.train import make_train_step, tiny_train_config
from tvc_torch.pipeline.train_loop import train
from tvc_torch.samplers.schedules import Schedule
from tvc_torch.utils.convert import unet_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
ARCHS = {"2d": {}, "unetmore3d": {"arch": "unetmore3d"},
         "unetmorepseudo3d": {"arch": "unetmorepseudo3d"}}
LAYOUTS = {2: ["2d", "unetmore3d", "unetmorepseudo3d"], 4: ["2d"]}

_WORKER = r"""
import sys
import numpy as np
import torch
from tvc_torch.parallel.mesh import data_sharding, initialize_distributed, make_mesh
from tvc_torch.parallel.train import make_train_step, tiny_train_config
from tvc_torch.pipeline.train_loop import train

rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")


def config(arch):
    cfg = tiny_train_config()
    cfg.model.ngf = 64
    cfg.optim.lr = 1e-3
    cfg.mesh.model_parallel = 2
    if arch != "2d":
        cfg.model.arch = arch
    return cfg


res = {}
for arch in sys.argv[5:]:
    data = np.load(f"{d}/{arch}.npz")
    cfg = config(arch)
    mesh = make_mesh(cfg.mesh)
    assert mesh.shape == {"data": world // 2, "model": 2}
    init_fn, step_fn = make_train_step(cfg, mesh, device="cpu")
    state = init_fn(0)
    whole = {n: torch.from_numpy(data["w/" + n]) for n in state.params}
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(state.local(whole)[n])
    state.ema = state.local(whole)
    res.update({f"{arch}/local/{n}": p.detach().numpy().copy()
                for n, p in state.params.items()})
    local = lambda a: data_sharding(mesh, torch.from_numpy(a))
    batch = {"x": local(data["x"]), "cond": local(data["cond"])}
    state, loss = step_fn(state, batch, local(data["labels"]), local(data["noise"]))
    res[f"{arch}/loss"] = loss.numpy()
    for tag, tensors in (("p", state.params), ("e", state.ema),
                         ("g", {n: p.grad for n, p in state.params.items()})):
        res.update({f"{arch}/{tag}/{n}": t.detach().numpy()
                    for n, t in state.whole(tensors).items()})
if world == 2:
    # a one-process snapshot, loaded under the model axis and written back
    # unchanged (no step is left to take)
    video = np.load(f"{d}/video.npy")
    train(config("2d"), video, num_steps=1, batch_size=2, out_dir=f"{d}/tp_run",
          resume_from=f"{d}/one/ckpt_final", device="cpu")
np.savez(f"{d}/out{rank}.npz", **res)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as the workers: the tier-1 workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(arch, cls=Config):
    cfg = tiny_train_config() if cls is Config else cls()
    if cls is not Config:  # the same fields on the JAX package's Config
        ref = tiny_train_config()
        for section in ("data", "model", "optim"):
            for k, v in vars(getattr(ref, section)).items():
                setattr(getattr(cfg, section), k, v)
    cfg.model.ngf = 64
    cfg.optim.lr = LR
    for k, v in ARCHS[arch].items():
        setattr(cfg.model, k, v)
    return cfg


def _inputs(arch, b=4):
    cfg = _config(arch)
    model = UNetMoreDDPM(cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    weights = {n: (torch.randn(p.shape, generator=g) * 0.08).numpy()
               for n, p in model.named_parameters()}
    rng = np.random.RandomState(6)
    size, c = cfg.data.image_size, cfg.data.channels
    x = rng.randn(b, size, size, c * cfg.data.num_frames).astype(np.float32)
    cond = rng.randn(b, size, size, c * cfg.data.num_frames_cond).astype(np.float32)
    labels, noise = draw_dsm(x.shape, Schedule.from_config(cfg), torch.Generator().manual_seed(7))
    return cfg, weights, {"x": x, "cond": cond, "labels": labels.numpy(),
                          "noise": noise.numpy()}


def _one_process(cfg, weights, inputs):
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(torch.from_numpy(weights[n]))
    state.ema = {n: torch.from_numpy(weights[n]).clone() for n in state.ema}
    batch = {k: torch.from_numpy(inputs[k]) for k in ("x", "cond")}
    return step_fn(state, batch, torch.from_numpy(inputs["labels"]),
                   torch.from_numpy(inputs["noise"]))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """For each world size, the inputs and the workers' results."""
    runs = {}
    for world, archs in LAYOUTS.items():
        d = tmp_path_factory.mktemp(f"tp{world}")
        cases = {}
        for arch in archs:
            cfg, weights, inputs = _inputs(arch)
            np.savez(d / f"{arch}.npz", **inputs, **{f"w/{n}": w for n, w in weights.items()})
            cases[arch] = (cfg, weights, inputs)
        if world == 2:
            video = np.random.RandomState(3).rand(2, 6, 8, 8, 3).astype(np.float32)
            np.save(d / "video.npy", video)
            train(_config("2d"), video, num_steps=1, batch_size=2, out_dir=str(d / "one"),
                  device="cpu")
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port),
                                   str(d), *archs], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
        runs[world] = (d, cases, [dict(np.load(d / f"out{r}.npz")) for r in range(world)])
    return runs


CASES = [(w, a) for w, archs in LAYOUTS.items() for a in archs]


@pytest.mark.parametrize("world,arch", CASES, ids=[f"{w}procs-{a}" for w, a in CASES])
def test_tensor_parallel_step_is_the_one_process_step(tp_runs, world, arch):
    _, cases, outs = tp_runs[world]
    cfg, weights, inputs = cases[arch]
    state, loss = _one_process(cfg, weights, inputs)
    eps = max(cfg.optim.eps, 1e-8)
    floor = 1e-2 * max(float(p.grad.abs().max()) for p in state.params.values())
    for out in outs:
        assert abs(float(out[f"{arch}/loss"]) - float(loss)) <= 1e-6 * abs(float(loss))
        for n, p in state.params.items():
            g, g_ref = out[f"{arch}/g/{n}"], p.grad.numpy()
            assert g.shape == g_ref.shape, n
            assert np.abs(g - g_ref).max() <= 1e-5 * max(np.abs(g_ref).max(), floor), n
            p_ref = p.detach().numpy()
            slope = np.abs(g - g_ref) / (np.minimum(np.abs(g), np.abs(g_ref)) + eps)
            bound = LR * np.minimum(2.0, slope) + 1e-6 * LR + 2 * np.spacing(np.abs(p_ref))
            assert (np.abs(out[f"{arch}/p/{n}"] - p_ref) <= bound).all(), n
            assert (np.abs(out[f"{arch}/e/{n}"] - state.ema[n].numpy())
                    <= (1 - cfg.model.ema_rate) * bound + 1e-7).all(), n
    for out in outs[1:]:  # every process holds the same whole state
        for n in state.params:
            assert np.array_equal(out[f"{arch}/p/{n}"], outs[0][f"{arch}/p/{n}"]), n


def _jax_specs(arch):
    """The JAX package's spec of each of the port's parameters on a (2, 2)
    mesh (a JAX leaf filled with its index finds its port parameter through
    the converter)."""
    jcfg = _config(arch, JConfig)
    size, c = jcfg.data.image_size, jcfg.data.channels
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, size, size, c * jcfg.data.num_frames)),
                            jax.numpy.zeros((1,), jax.numpy.int32),
                            jax.numpy.zeros((1, size, size, c * jcfg.data.num_frames_cond)))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    ids = jax.tree_util.tree_unflatten(treedef, [np.full(s.shape, i, np.float32)
                                                 for i, s in enumerate(leaves)])
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    jspecs = jax.tree_util.tree_leaves(j_shard_params(shapes, jmesh),
                                       is_leaf=lambda s: hasattr(s, "spec"))
    return {n: tuple(jspecs[int(t.reshape(-1)[0])].spec)
            for n, t in unet_from_jax(_config(arch), ids).items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_slices_are_the_jax_rule(tp_runs, arch):
    """Each process holds exactly its model index's slice of the output
    channels of the kernels the JAX package shards, and the rest whole."""
    world = 2
    _, cases, outs = tp_runs[world]
    weights = cases[arch][1]
    jspecs = _jax_specs(arch)
    model = UNetMoreDDPM(_config(arch), device="meta")
    assert shard_params(model, Mesh({"data": 2, "model": 2}, ("data", "model"))) == jspecs
    n_sharded = 0
    for rank, out in enumerate(outs):
        for n, w in weights.items():
            local = out[f"{arch}/local/{n}"]
            if not jspecs[n]:
                assert np.array_equal(local, w), n
                continue
            n_sharded += 1
            dim = w.ndim - 1 if n.endswith(".W") else 0  # the output channels
            half = w.shape[dim] // 2
            assert np.array_equal(local, np.take(w, range(rank * half, (rank + 1) * half),
                                                 axis=dim)), n
    assert n_sharded > 0


def test_snapshot_under_the_model_axis_is_the_one_process_snapshot(tp_runs):
    d = tp_runs[2][0]
    for part in ("params", "ema", "opt"):
        with np.load(d / "one" / f"ckpt_final.{part}.npz") as a, \
                np.load(d / "tp_run" / f"ckpt_final.{part}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].tobytes() == b[k].tobytes(), (part, k)
    assert int(np.load(d / "tp_run" / "ckpt_final.step.npy")) == 1
