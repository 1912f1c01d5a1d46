"""tvc_torch's training path against the JAX package's, on the CPU.

The same numpy-seeded weights, batches and draws go through both. The port
never imitates ``jax.random``: where the JAX function draws from a key, the
test reproduces its draws with JAX (``k_label, k_noise = jax.random.split(key)``)
and hands them to the port.

Tolerances, each with its reason:
- DSM loss: relative 1e-6 (float32 elementwise arithmetic and one sum, in
  another order).
- Optimizers: parameters within 1e-5 x lr x steps absolute after 5 steps
  (an update is at most about lr in size; the two differ in float32
  rounding of the moments and the global norm); the update counts exact.
- EMA: exact (two float32 products and one sum, in the JAX order).
- Attention backward: 1e-5 x the gradient's magnitude (float32 products
  summed in another order).
- Whole train step: loss relative 1e-5, Adam's first moment within 2e-4 of
  each tensor's magnitude (a deep net's float32 backward); parameters after an
  Adam step within 2e-3 x lr absolute (Adam's first step is sign-like,
  g / (|g| + eps), so a relative gradient error moves it by at most that
  share of lr); EMA within 2e-3 x lr x (1 - ema_rate).
- clip_batches: exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.losses.dsm import anneal_dsm_score_estimation as j_dsm
from tvc.losses.ema import ema_update as j_ema_update
from tvc.losses.optimizers import get_optimizer as j_get_optimizer
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.ops.pallas_attention import attention_reference
from tvc.parallel.train import TrainState as JTrainState
from tvc.parallel.train import make_train_step as j_make_train_step
from tvc.pipeline.train_loop import clip_batches as j_clip_batches
from tvc.samplers.schedules import Schedule as JSchedule
from tvc.utils.checkpoint_io import _flatten as j_flatten
from tvc.utils.checkpoint_io import load_train_state as j_load_train_state
from tvc.utils.checkpoint_io import save_train_state as j_save_train_state
from tvc_torch import cli
from tvc_torch.core.config import Config
from tvc_torch.losses import anneal_dsm_score_estimation, draw_dsm, ema_update, get_optimizer
from tvc_torch.losses.ema import EMAHelper
from tvc_torch.ops import attention as attn
from tvc_torch.parallel.train import make_train_step
from tvc_torch.pipeline.train_loop import clip_batches
from tvc_torch.samplers.schedules import Schedule
from tvc_torch.utils.checkpoint_io import _from_optax, load_train_state
from tvc_torch.utils.convert import unet_from_jax


def tiny_train_cfg(cls):
    """The tiny config of tests/test_train_loop.py."""
    cfg = cls()
    cfg.data.image_size = 16
    cfg.data.num_frames = 2
    cfg.data.num_frames_cond = 1
    cfg.model.ngf = 8
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (8,)
    cfg.model.n_head_channels = 4
    cfg.model.num_classes = 10
    cfg.optim.warmup = 0
    return cfg


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# DSM loss
# ---------------------------------------------------------------------------


def _eps_jax(x, labels, cond, cond_mask):
    c = 0.0 if cond is None else 0.1 * jnp.mean(cond, axis=-1, keepdims=True)
    return 0.3 * x + 0.01 * labels.reshape(-1, 1, 1, 1) + c


def _eps_torch(x, labels, cond, cond_mask):
    c = 0.0 if cond is None else 0.1 * torch.mean(cond, dim=-1, keepdim=True)
    return 0.3 * x + 0.01 * labels.reshape(-1, 1, 1, 1) + c


@pytest.mark.parametrize("variant", ["normal", "gamma", "l1", "all_frames", "smld"])
def test_dsm_loss_matches_jax(variant):
    jcfg, cfg = JConfig(), Config()
    jcfg.model.gamma = cfg.model.gamma = variant == "gamma"
    jsched, sched = JSchedule.from_config(jcfg), Schedule.from_config(cfg)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 8, 8, 15).astype(np.float32)
    cond = rng.randn(3, 8, 8, 6).astype(np.float32)
    kw = {"l1": variant == "l1", "gamma": variant == "gamma",
          "all_frames": variant == "all_frames"}
    sigmas = None
    if variant == "smld":
        kw["version"], sigmas = "SMLD", np.geomspace(1.0, 0.01, 12)
    key = jax.random.PRNGKey(7)
    want = float(j_dsm(key, _eps_jax, jnp.asarray(x), jsched, cond=jnp.asarray(cond),
                       sigmas=sigmas, **kw))

    # the draws tvc's loss makes from this key
    k_label, k_noise = jax.random.split(key)
    shape = (3, 8, 8, 21) if variant == "all_frames" else x.shape
    n = len(sigmas) if variant == "smld" else len(jsched.alphas)
    labels = jax.random.randint(k_label, (3,), 0, n)
    if variant == "gamma":
        k_cum = jnp.asarray(jsched.k_cum, jnp.float32)[labels].reshape(3, 1, 1, 1)
        noise = jax.random.gamma(k_noise, jnp.broadcast_to(k_cum, shape))
    else:
        noise = jax.random.normal(k_noise, shape, jnp.float32)
    got = float(anneal_dsm_score_estimation(
        _eps_torch, torch.from_numpy(x), sched, cond=torch.from_numpy(cond), sigmas=sigmas,
        labels=torch.from_numpy(np.asarray(labels, np.int64)),
        noise=torch.from_numpy(np.array(noise)), **kw))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


@pytest.mark.parametrize("gamma", [False, True], ids=["normal", "gamma"])
def test_dsm_draws_from_a_generator(gamma):
    """Without explicit draws the loss draws them from the generator: the same
    seed gives the same loss, and ``draw_dsm`` gives those very draws."""
    cfg = Config()
    cfg.model.gamma = gamma
    sched = Schedule.from_config(cfg)
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 8, 8, 15).astype(np.float32))
    a = anneal_dsm_score_estimation(_eps_torch, x, sched, gamma=gamma,
                                    generator=torch.Generator().manual_seed(3))
    labels, noise = draw_dsm(x.shape, sched, torch.Generator().manual_seed(3), gamma=gamma)
    b = anneal_dsm_score_estimation(_eps_torch, x, sched, gamma=gamma, labels=labels,
                                    noise=noise)
    assert torch.equal(a, b) and torch.isfinite(a)
    assert labels.shape == (4,) and 0 <= labels.min() and labels.max() < len(sched.alphas)
    if gamma:
        assert (noise > 0).all()  # Gamma draws, centred only inside the loss
    with pytest.raises(ValueError, match="generator"):
        anneal_dsm_score_estimation(_eps_torch, x, sched)


# ---------------------------------------------------------------------------
# optimizers and EMA
# ---------------------------------------------------------------------------


def _grad_tree(rng, shapes, scale):
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("warmup", [0, 3], ids=["no_warmup", "warmup3"])
@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["no_clip", "clip1"])
@pytest.mark.parametrize("name,weight_decay", [("Adam", 0.0), ("Adam", 0.05), ("RMSprop", 0.0),
                                               ("SGD", 0.0)],
                         ids=["adam", "adamw", "rmsprop", "sgd"])
def test_optimizer_matches_optax(name, weight_decay, clip, warmup):
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.optim.optimizer, c.optim.weight_decay = name, weight_decay
        c.optim.grad_clip, c.optim.warmup, c.optim.lr = clip, warmup, 1e-2
        c.optim.amsgrad = True  # ignored by both, as optax.adam ignores it
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 3, 2, 4)}
    rng = np.random.RandomState(0)
    params = _grad_tree(rng, shapes, 1.0)
    tx = j_get_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    opt = get_optimizer(cfg)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = opt.init(tparams)
    steps = 5
    for i in range(steps):
        # a small gradient on one step: the clip triggers on some steps only
        grads = _grad_tree(rng, shapes, 0.05 if i == 2 else 1.0)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.step_(tparams, {k: torch.tensor(v) for k, v in grads.items()}, tstate)
    for k in shapes:
        err = np.abs(tparams[k].numpy() - np.asarray(jparams[k])).max()
        assert err <= 1e-5 * cfg.optim.lr * steps, (k, err)
    assert int(tstate["count"]) == steps
    if name == "Adam":
        assert int(tstate["adam_count"]) == steps
    if warmup:  # the schedule is read before the count moves: update 1 has lr 0
        assert opt.lr(0) == 0.0 and opt.lr(warmup) == np.float32(cfg.optim.lr)


def test_optimizer_refuses_unknown():
    cfg = Config()
    cfg.optim.optimizer = "Adagrad"
    with pytest.raises(NotImplementedError, match="Adagrad"):
        get_optimizer(cfg)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(2)
    shadow = {k: rng.randn(4, 5).astype(np.float32) for k in "ab"}
    params = {k: rng.randn(4, 5).astype(np.float32) for k in "ab"}
    want = j_ema_update({k: jnp.asarray(v) for k, v in shadow.items()},
                        {k: jnp.asarray(v) for k, v in params.items()}, 0.999)
    tshadow = {k: torch.tensor(v) for k, v in shadow.items()}
    got = ema_update(tshadow, {k: torch.tensor(v) for k, v in params.items()}, 0.999)
    assert got is tshadow
    for k in "ab":
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    helper = EMAHelper(0.5)
    p = {"w": torch.ones(3, requires_grad=True)}
    helper.register(p)
    assert helper.shadow["w"].data_ptr() != p["w"].data_ptr()  # a copy, never an alias
    with torch.no_grad():
        p["w"].mul_(3.0)
    helper.update(p)
    assert torch.equal(helper.ema(p)["w"], torch.full((3,), 2.0))


# ---------------------------------------------------------------------------
# attention's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2, 40, 192), (1, 3, 16, 192)], ids=["T40", "T16"])
def test_attention_backward_matches_jax_vjp(shape):
    b, h, t, d = shape
    rng = np.random.RandomState(4)
    q, k, v, dout = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(attention_reference, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    # strided heads in, a (B, T, H, d)-laid-out output and a non-contiguous dout, as on the card
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
                  for a in (q, k, v))
    tout = torch.from_numpy(np.ascontiguousarray(np.asarray(out).transpose(0, 2, 1, 3))
                            ).transpose(1, 2)
    tdout = torch.from_numpy(np.ascontiguousarray(dout.transpose(0, 2, 1, 3))).transpose(1, 2)
    assert not tdout.is_contiguous()
    got = attn.attention_backward(tq, tk, tv, tout, tdout)
    for g, w in zip(got, want):
        assert g.shape == shape
        assert rel_err(g.numpy(), w) <= 1e-5


def test_kernel_attention_function_gives_attention_backward(monkeypatch):
    """``KernelAttention``'s wiring, with ``launch`` standing in as the plain
    version on the CPU: the output carries a grad_fn and autograd returns
    ``attention_backward``'s gradients, which equal autograd through
    ``attention_plain``."""
    monkeypatch.setattr(attn, "launch", lambda q, k, v, plan: attn.attention_plain(q, k, v))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 40, 2, 192), generator=g).transpose(1, 2).requires_grad_()
               for _ in range(3))
    dout = torch.randn((2, 2, 40, 192), generator=g)
    out = attn.KernelAttention.apply(q, k, v)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(attn.attention_plain(q, k, v), (q, k, v), dout)
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# the whole train step, snapshots and the loop
# ---------------------------------------------------------------------------


def _variables(jcfg, seed=11, scale=0.08):
    size, c = jcfg.data.image_size, jcfg.data.channels
    x = jnp.zeros((1, size, size, c * jcfg.data.num_frames))
    cond = jnp.zeros((1, size, size, c * jcfg.data.num_frames_cond))
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.int32), cond)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32),
                                  shapes)


def _batch(cfg, b=2, seed=3):
    rng = np.random.RandomState(seed)
    size, c = cfg.data.image_size, cfg.data.channels
    return {"x": rng.randn(b, size, size, c * cfg.data.num_frames).astype(np.float32),
            "cond": rng.randn(b, size, size, c * cfg.data.num_frames_cond).astype(np.float32)}


def _jax_draws(key, cfg, shape):
    """The labels and noise tvc's train step draws from ``key``."""
    k_label, k_noise = jax.random.split(key)
    labels = jax.random.randint(k_label, (shape[0],), 0, cfg.model.num_classes)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(labels, np.int64)), torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def jax_step():
    """tvc's jitted train step on the tiny config, lr 1e-3, warmup 4 (so the
    schedule's count matters), on a one-device mesh."""
    jcfg = tiny_train_cfg(JConfig)
    jcfg.optim.lr, jcfg.optim.warmup = 1e-3, 4
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, step_fn = j_make_train_step(jcfg, mesh)
    return jcfg, step_fn


def _jax_state(jcfg, variables):
    tx = j_get_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    return JTrainState(params=params, opt_state=tx.init(params),
                       ema=jax.tree_util.tree_map(lambda p: p.copy(), params),
                       step=jnp.zeros((), jnp.int32))


def _port_state(cfg, variables, init_fn):
    state = init_fn(0)
    sd = unet_from_jax(cfg, variables)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(sd[n])
    state.ema = {n: sd[n].clone().contiguous() for n in state.ema}
    return state


def _assert_states_close(cfg, state, jstate, lr):
    jparams = unet_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate.params))
    jema = unet_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate.ema))
    for n, p in state.params.items():
        assert np.abs(p.detach().numpy() - jparams[n].numpy()).max() <= 2e-3 * lr, n
        diff = np.abs(state.ema[n].numpy() - jema[n].numpy()).max()
        assert diff <= 2e-3 * lr * (1 - cfg.model.ema_rate) + 1e-7, n
    jopt = _from_optax(j_flatten(jstate.opt_state), cfg)
    assert int(state.opt_state["count"]) == int(jopt["count"]) == int(jstate.step)
    assert int(state.opt_state["adam_count"]) == int(jopt["adam_count"])
    # Adam's first moment, against the tensor's magnitude or a thousandth of the
    # largest: NIN_1's bias has a zero gradient (softmax ignores a shift of
    # every key's logit), so both hold rounding noise there
    floor = 1e-3 * max(float(v.abs().max()) for k, v in jopt.items() if k.startswith("mu/"))
    for n in state.params:
        got, want = state.opt_state[f"mu/{n}"].numpy(), jopt[f"mu/{n}"].numpy()
        assert np.abs(got - want).max() <= 2e-4 * max(np.abs(want).max(), floor), n


def test_train_step_matches_jax(jax_step):
    jcfg, j_step_fn = jax_step
    cfg = tiny_train_cfg(Config)
    cfg.optim.lr, cfg.optim.warmup = 1e-3, 4
    variables = _variables(jcfg)
    batch = _batch(cfg)
    key = jax.random.PRNGKey(21)
    jstate, jloss = j_step_fn(_jax_state(jcfg, variables),
                              {k: jnp.asarray(v) for k, v in batch.items()}, key)
    # a second step: update 1 had lr 0 (warmup), so step 2 is the one that moves
    jstate, jloss = j_step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(22))

    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = _port_state(cfg, variables, init_fn)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, loss = step_fn(state, tbatch, *_jax_draws(key, cfg, batch["x"].shape))
    grads = {n: p.grad.clone() for n, p in state.params.items()}
    state, loss = step_fn(state, tbatch, *_jax_draws(jax.random.PRNGKey(22), cfg,
                                                     batch["x"].shape))
    assert state.step == 2
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert all(torch.isfinite(g).all() for g in grads.values())
    # every attention block's input side gets a gradient through the attention
    attn_grads = [g for n, g in grads.items() if any(s in n for s in ("GroupNorm_0", "NIN_0"))]
    assert attn_grads and all(g.abs().max() > 0 for g in attn_grads)
    _assert_states_close(cfg, state, jstate, cfg.optim.lr)
    for n, p in state.params.items():  # the EMA is a copy of its own
        assert state.ema[n].data_ptr() != p.data_ptr()


def test_resume_from_a_jax_snapshot(jax_step, tmp_path):
    """tvc trains two steps and snapshots; the port resumes from its files and
    takes step 3, as tvc does from the same snapshot with the same draws."""
    jcfg, j_step_fn = jax_step
    cfg = tiny_train_cfg(Config)
    cfg.optim.lr, cfg.optim.warmup = 1e-3, 4
    variables = _variables(jcfg, seed=12)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, seed=4).items()}
    jstate = _jax_state(jcfg, variables)
    for i in range(2):
        jstate, _ = j_step_fn(jstate, batch, jax.random.PRNGKey(30 + i))
    path = str(tmp_path / "ckpt_2")
    j_save_train_state(path, jstate.params, jstate.ema, 2, opt_state=jstate.opt_state)

    template = _jax_state(jcfg, variables)
    params, ema, step, opt = j_load_train_state(path, template.params, template.ema,
                                                template.opt_state)
    jstate = template.replace(params=params, ema=ema, opt_state=opt,
                              step=jnp.asarray(step, jnp.int32))
    key = jax.random.PRNGKey(40)
    jstate, jloss = j_step_fn(jstate, batch, key)

    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    params, ema, step, opt = load_train_state(path, state.params, state.ema, state.opt_state,
                                              cfg)
    assert step == 2 and int(opt["count"]) == 2 and int(opt["adam_count"]) == 2
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(params[n])
    state.ema, state.opt_state, state.step = ema, opt, step
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    state, loss = step_fn(state, tbatch, *_jax_draws(key, cfg, tbatch["x"].shape))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_states_close(cfg, state, jstate, cfg.optim.lr)


def test_clip_batches_match_jax():
    jcfg, cfg = tiny_train_cfg(JConfig), tiny_train_cfg(Config)
    data = np.random.RandomState(0).rand(3, 9, 16, 16, 3).astype(np.float32)
    ours = clip_batches(data, cfg, 5, np.random.RandomState(8))
    theirs = j_clip_batches(data, jcfg, 5, np.random.RandomState(8))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _files(prefix):
    out = {}
    for suffix in (".params.npz", ".ema.npz", ".opt.npz", ".step.npy"):
        with open(prefix + suffix, "rb") as f:
            out[suffix] = f.read()
    return out


def test_cli_train_snapshots_and_resumes(tmp_path, capsys):
    data = tmp_path / "d.npy"
    np.save(data, (np.random.RandomState(3).rand(2, 8, 3, 16, 16) * 255).astype(np.uint8))
    mods = ["data.image_size=16", "data.num_frames=2", "data.num_frames_cond=1", "model.ngf=8",
            "model.ch_mult=(1,2)", "model.num_res_blocks=1", "model.attn_resolutions=(8,)",
            "model.n_head_channels=4", "model.num_classes=10", "optim.warmup=2"]
    common = ["train", "--device", "cpu", "--data-npy", str(data), "--batch-size", "3",
              "--config-mod", *mods]
    out = tmp_path / "run"
    assert cli.main(common + ["--out-dir", str(out), "--steps", "4", "--snapshot-freq", "2"]) == 0
    for name in ("ckpt_2", "ckpt_4", "ckpt_final"):
        assert os.path.exists(out / f"{name}.opt.npz")
    assert int(np.load(out / "ckpt_final.step.npy")) == 4
    assert "step 1/4 loss" in capsys.readouterr().out

    # a resume to the snapshot's own step trains nothing: the state goes through
    # load and save unchanged, byte for byte
    same = tmp_path / "same"
    assert cli.main(common + ["--out-dir", str(same), "--steps", "2",
                              "--resume-from", str(out / "ckpt_2")]) == 0
    assert _files(str(same / "ckpt_final")) == _files(str(out / "ckpt_2"))

    # a resume to step 4 continues the optimizer's counts; without .opt.npz the
    # optimizer starts fresh
    resumed = tmp_path / "resumed"
    assert cli.main(common + ["--out-dir", str(resumed), "--steps", "4",
                              "--resume-from", str(out / "ckpt_2")]) == 0
    assert "resumed from" in capsys.readouterr().out
    opt = np.load(resumed / "ckpt_final.opt.npz")
    assert int(opt["count"]) == 4 and int(opt["adam_count"]) == 4
    os.remove(out / "ckpt_2.opt.npz")
    fresh = tmp_path / "fresh"
    assert cli.main(common + ["--out-dir", str(fresh), "--steps", "4",
                              "--resume-from", str(out / "ckpt_2")]) == 0
    assert int(np.load(fresh / "ckpt_final.opt.npz")["count"]) == 2
    assert int(np.load(fresh / "ckpt_final.step.npy")) == 4


def test_bf16_training_refuses():
    with pytest.raises(NotImplementedError, match="float32"):
        make_train_step(tiny_train_cfg(Config), dtype=torch.bfloat16, device="cpu")
