"""tvc_torch's data-parallel layer on gloo, against one process and against
the JAX package's collectives and sharding rules, on the CPU.

Two worker processes (``torch.distributed`` over gloo, spawned fresh; they
import neither JAX nor the JAX package) each take half the global batch and
half its draws: their DDP step must give the one-process step on the whole
batch. Tolerances: loss relative 1e-6; the averaged (and clipped) gradients
within 1e-5 of each tensor's magnitude or of a thousandth of the largest
gradient, whichever is larger (the batch is summed in another order); each parameter after the first Adam step within
lr x |g - g_ref| / (|g_ref| + eps) + 1e-6 x lr + two float32 ulps of the
parameter (the rounding of p + u) of the reference, the bound
that step, lr x g / (|g| + eps), puts on the effect of the gradient's
difference (it is sign-like: an element near eps moves by up to a quarter of
its relative error times lr); the EMA within (1 - ema_rate) of that bound.
The collectives move bytes and must be exact.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tvc.core.config import MeshConfig as JMeshConfig
from tvc.parallel.collectives import all_gather_frames as j_all_gather
from tvc.parallel.collectives import broadcast_from as j_broadcast_from
from tvc.parallel.collectives import ring_exchange as j_ring_exchange
from tvc.parallel.mesh import data_sharding as j_data_sharding
from tvc.parallel.mesh import make_mesh as j_make_mesh
from tvc.parallel.mesh import param_partition_spec as j_param_partition_spec
from tvc.parallel.mesh import shard_params as j_shard_params
from tvc_torch.core.config import MeshConfig
from tvc_torch.losses.dsm import draw_dsm
from tvc_torch.models.diffusion.ncsnpp import UNetMoreDDPM
from tvc_torch.parallel import collectives
from tvc_torch.parallel import mesh as mesh_module
from tvc_torch.parallel.mesh import (Mesh, data_sharding, initialize_distributed, make_mesh,
                                     param_partition_spec, replicated, shard_params)
from tvc_torch.parallel.train import (dryrun_multichip, dryrun_serving, make_train_step,
                                      tiny_train_config)
from tvc_torch.samplers.schedules import Schedule
from tvc_torch.utils.convert import unet_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LR = 1e-3

_WORKER = r"""
import sys
import numpy as np
import torch
from tvc_torch.parallel import collectives
from tvc_torch.parallel import mesh as mesh_module
from tvc_torch.parallel.mesh import data_sharding, initialize_distributed, make_mesh
from tvc_torch.parallel.train import dryrun_multichip, make_train_step, tiny_train_config

rank, world, port, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
data = np.load(inp)
cfg = tiny_train_config()
cfg.optim.lr = float(data["lr"])
mesh = make_mesh(cfg.mesh)
assert mesh.shape == {"data": world, "model": 1} and mesh.rank == rank
init_fn, step_fn = make_train_step(cfg, device="cpu")
state = init_fn(0)
names = [k[len("w/"):] for k in data.files if k.startswith("w/")]
with torch.no_grad():
    for n, p in state.params.items():
        p.copy_(torch.from_numpy(data["w/" + n]))
state.ema = {n: torch.from_numpy(data["w/" + n]).clone() for n in state.ema}
local = lambda a: data_sharding(mesh, torch.from_numpy(a))
batch = {"x": local(data["x"]), "cond": local(data["cond"])}
state, loss = step_fn(state, batch, local(data["labels"]), local(data["noise"]))
res = {"loss": loss.numpy(), "world": np.int64(torch.distributed.get_world_size())}
res.update({"p/" + n: p.detach().numpy() for n, p in state.params.items()})
res.update({"e/" + n: e.numpy() for n, e in state.ema.items()})
res.update({"g/" + n: p.grad.numpy() for n, p in state.params.items()})
block = torch.from_numpy(data["frames"][rank:rank + 1])
res["gather"] = collectives.all_gather_frames(block).numpy()
res["bcast"] = collectives.broadcast_from(block, src=1).numpy()
res["ring1"] = collectives.ring_exchange(block, shift=1).numpy()
res["ring3"] = collectives.ring_exchange(block, shift=3).numpy()
dryrun = dryrun_multichip(device="cpu")
res["dryrun_loss"] = np.float64(dryrun["loss"])
res["dryrun_model_axis"] = np.int64(dryrun["model_axis"])
res["dryrun_serving_chains"] = np.float64(dryrun["serving_chains"])
np.savez(out, **res)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """The inputs and the two workers' results (one gloo group of 2)."""
    tmp = tmp_path_factory.mktemp("ddp")
    cfg = tiny_train_config()
    cfg.optim.lr = LR
    model = UNetMoreDDPM(cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    weights = {n: (torch.randn(p.shape, generator=g) * 0.08).numpy()
               for n, p in model.named_parameters()}
    rng = np.random.RandomState(6)
    size, c, b = cfg.data.image_size, cfg.data.channels, 4
    x = rng.randn(b, size, size, c * cfg.data.num_frames).astype(np.float32)
    cond = rng.randn(b, size, size, c * cfg.data.num_frames_cond).astype(np.float32)
    labels, noise = draw_dsm(x.shape, Schedule.from_config(cfg), torch.Generator().manual_seed(7))
    frames = np.arange(WORLD * 4 * 3, dtype=np.float32).reshape(WORLD, 4, 3)
    inp = tmp / "inputs.npz"
    np.savez(inp, x=x, cond=cond, labels=labels.numpy(), noise=noise.numpy(), frames=frames,
             lr=np.float64(LR), **{f"w/{n}": w for n, w in weights.items()})
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(WORLD), str(port),
                               str(inp), str(tmp / f"out{r}.npz")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
    inputs = {"cfg": cfg, "weights": weights, "x": x, "cond": cond, "labels": labels,
              "noise": noise, "frames": frames}
    return inputs, outs


def test_ddp_step_on_two_gloo_processes_is_the_full_batch_step(ddp_run):
    inputs, outs = ddp_run
    cfg = inputs["cfg"]
    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(torch.from_numpy(inputs["weights"][n]))
    state.ema = {n: torch.from_numpy(inputs["weights"][n]).clone() for n in state.ema}
    batch = {k: torch.from_numpy(inputs[k]) for k in ("x", "cond")}
    state, loss = step_fn(state, batch, inputs["labels"], inputs["noise"])
    eps = max(cfg.optim.eps, 1e-8)
    # NIN_1's bias has a zero gradient (softmax ignores a shift of every key's
    # logit): rounding noise, held against a thousandth of the largest gradient
    floor = 1e-3 * max(float(p.grad.abs().max()) for p in state.params.values())
    for out in outs:
        assert int(out["world"]) == WORLD
        assert abs(float(out["loss"]) - float(loss)) <= 1e-6 * abs(float(loss))
        for n, p in state.params.items():
            g, g_ref = out["g/" + n], p.grad.numpy()
            assert np.abs(g - g_ref).max() <= 1e-5 * max(np.abs(g_ref).max(), floor), n
            p_ref = p.detach().numpy()
            bound = (LR * np.abs(g - g_ref) / (np.abs(g_ref) + eps) + 1e-6 * LR
                     + 2 * np.spacing(np.abs(p_ref)))
            assert (np.abs(out["p/" + n] - p_ref) <= bound).all(), n
            assert (np.abs(out["e/" + n] - state.ema[n].numpy())
                    <= (1 - cfg.model.ema_rate) * bound + 1e-7).all(), n
    # the replicas stay identical: DDP averages the same gradients on both
    for n in state.params:
        assert np.array_equal(outs[0]["p/" + n], outs[1]["p/" + n]), n
    # and the step moved every parameter the loss reaches
    moved = [n for n, p in state.params.items()
             if not np.array_equal(p.detach().numpy(), inputs["weights"][n])]
    assert len(moved) > 0.9 * len(state.params)
    assert all(np.isfinite(float(o["dryrun_loss"])) for o in outs)


def test_collectives_on_two_gloo_processes_match_jax(ddp_run):
    inputs, outs = ddp_run
    frames = inputs["frames"]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    xs = jax.device_put(frames, j_data_sharding(mesh, 3))
    gather = np.asarray(j_all_gather(xs, mesh))
    bcast = np.asarray(j_broadcast_from(xs, mesh, src=1))
    ring = np.asarray(j_ring_exchange(xs, mesh, shift=1))
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["gather"], gather)
        np.testing.assert_array_equal(out["bcast"], bcast)
        np.testing.assert_array_equal(out["ring1"], ring[rank:rank + 1])
        np.testing.assert_array_equal(out["ring3"], np.roll(frames, 3, axis=0)[rank:rank + 1])


def test_collectives_without_a_group_are_a_group_of_one():
    x = torch.arange(6.0).reshape(2, 3)
    for y in (collectives.all_gather_frames(x), collectives.broadcast_from(x),
              collectives.ring_exchange(x, shift=1)):
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_mesh_rules_match_jax(monkeypatch):
    shapes = [(3, 3, 192, 384), (384,), (3, 3, 192, 191), (64, 64), (512, 256), (7, 9, 1024)]
    for tp in (1, 2, 4):
        for s in shapes:
            assert param_partition_spec(s, "model", tp) == tuple(
                j_param_partition_spec(s, "model", tp)), (s, tp)
    assert replicated(make_mesh()) == ()
    # with one process the mesh is 1x1, as the JAX mesh over one device; a model
    # axis that does not divide the processes falls back to 1 in both
    mesh = make_mesh(MeshConfig(model_parallel=2))
    jmesh = j_make_mesh(JMeshConfig(model_parallel=2), devices=jax.devices()[:1])
    assert mesh.shape == dict(jmesh.shape) == {"data": 1, "model": 1}
    assert mesh.axis_names == jmesh.axis_names
    monkeypatch.setattr(mesh_module, "world", lambda: (8, 0))  # a group of 8 processes
    assert make_mesh().shape == {"data": 8, "model": 1}
    # a model axis of 2 over 8 processes: process r sits where the JAX mesh puts
    # device r, and takes the data group of its column and the model group of its row
    monkeypatch.setattr(mesh_module.dist, "new_group", lambda ranks: tuple(ranks))
    jmesh = j_make_mesh(JMeshConfig(model_parallel=2), devices=jax.devices()[:8])
    layout = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        monkeypatch.setattr(mesh_module, "world", lambda r=rank: (8, r))
        m = make_mesh(MeshConfig(model_parallel=2))
        assert m.shape == dict(jmesh.shape) == {"data": 4, "model": 2}
        assert layout[m.data_index, m.model_index] == rank
        assert m.model_group == tuple(layout[m.data_index])
        assert m.data_group == tuple(layout[:, m.model_index])
    monkeypatch.undo()
    x = torch.arange(8.0)
    halves = [data_sharding(Mesh({"data": 2, "model": 1}, ("data", "model"), r), x)
              for r in (0, 1)]
    assert torch.equal(torch.cat(halves), x)
    initialize_distributed(None, 1, 0)  # single process: a no-op, as in the JAX package
    assert not torch.distributed.is_initialized()


def test_shard_params_matches_jax():
    """The rule over the tiny UNet's parameters gives the JAX package's specs
    on a (4, 2) mesh, leaf by leaf (each JAX leaf filled with its own index
    finds its port parameter through the converter)."""
    cfg = tiny_train_config()
    cfg.model.ngf = 64  # kernels past the rule's 2**16 elements
    from tvc.core.config import Config as JConfig
    from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM

    jcfg = JConfig()
    for section in ("data", "model"):
        for k, v in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), k, v)
    size, c = cfg.data.image_size, cfg.data.channels
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, size, size, c * cfg.data.num_frames)),
                            jax.numpy.zeros((1,), jax.numpy.int32),
                            jax.numpy.zeros((1, size, size, c * cfg.data.num_frames_cond)))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    ids = jax.tree_util.tree_unflatten(treedef, [np.full(s.shape, i, np.float32)
                                                 for i, s in enumerate(leaves)])
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    jspecs = jax.tree_util.tree_leaves(j_shard_params(shapes, jmesh),
                                       is_leaf=lambda s: hasattr(s, "spec"))
    model = UNetMoreDDPM(cfg, device="meta")
    specs = shard_params(model, Mesh({"data": 4, "model": 2}, ("data", "model")))
    by_name = unet_from_jax(cfg, ids)
    assert set(specs) == set(by_name)
    sharded = 0
    for name, spec in specs.items():
        leaf = int(by_name[name].reshape(-1)[0])
        assert spec == tuple(jspecs[leaf].spec), name
        sharded += bool(spec)
    assert sharded > 0


def test_serving_dry_run_waits_for_a10():
    """The sharded serving leg of the dry run, in one process: one chain,
    every predicted frame accepted."""
    res = dryrun_serving(make_mesh(), device="cpu")
    assert res["serving_chains"] == 1 and np.isfinite(res["serving_bits"])


def test_dryrun_multichip_takes_a_model_axis_of_two(ddp_run):
    """Over two processes the dry run takes a model axis of 2, as the JAX
    package's does on an even device count, and its serving leg runs one
    chain a process."""
    for out in ddp_run[1]:
        assert int(out["dryrun_model_axis"]) == 2
        assert float(out["dryrun_serving_chains"]) == WORLD


def test_dryrun_multichip_single_process():
    res = dryrun_multichip(device="cpu")
    assert np.isfinite(res["loss"]) and np.isfinite(res["sample_abs_max"])
