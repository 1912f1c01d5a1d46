"""tvc_torch's training of the model zoo and bf16 training against the JAX
package's train step, on the CPU.

For SPADE, the 3-D and the pseudo-3-D nets (the capability tests' 16x16
config, tests/test_torch_archs.py) and for the 2-D net in bf16, one DSM step
of the port against ``tvc/parallel/train.py``'s ``make_train_step`` on a
one-device mesh, from the same parameters (``unet_from_jax``) with the draws
JAX takes handed to the port. Both clip the gradients in place by the same
global norm; JAX's clipped gradient is Adam's first moment over (1 - b1).

Tolerances (test_torch_ddp.py's bounds, with the float32 gradient error of a
deep net against the JAX package from test_torch_train.py):
- loss: relative 1e-5 (float32);
- every gradient within 2e-4 of its tensor's magnitude, or of a thousandth
  of the largest gradient where that is larger (NIN_1's bias has a zero
  gradient: softmax ignores a shift of every key's logit, so both hold
  rounding noise there);
- each parameter after the first Adam step within
  lr x min(2, |g - g_ref| / (min(|g|, |g_ref|) + eps)) + 1e-6 x lr + two
  float32 ulps of the parameter: Adam's first step is g / (|g| + eps), whose
  slope is at most 1 / (|x| + eps) between g and g_ref and whose range is 2
  (test_torch_ddp.py divides by |g_ref| alone, which holds where the two
  gradients differ by rounding, not where they differ in sign); the EMA
  within (1 - ema_rate) of that bound.
bf16: the port rounds to bf16 in other places than the JAX package (the
forward test, test_torch_bf16.py, names them: GroupNorm's scale and shift,
and the attention's P, which the kernel keeps in float32), so the two bf16
steps are two different roundings of one float32 step. The loss and each
gradient tensor of the port's bf16 step must then lie within twice the
distance between the JAX package's bf16 step and the float32 step (two
independent roundings lie about sqrt(2) times one rounding's distance
apart; the float32 step is the port's, the JAX package's within the float32
bounds above), the gradients with the floor above; the parameters and the
EMA within the Adam bound over these gradients.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.losses.optimizers import get_optimizer as j_get_optimizer
from tvc.models.diffusion.ncsnpp import UNetMoreDDPM as JUNetMoreDDPM
from tvc.parallel.train import TrainState as JTrainState
from tvc.parallel.train import make_train_step as j_make_train_step
from tvc.utils.checkpoint_io import _flatten as j_flatten
from tvc.utils.checkpoint_io import load_train_state as j_load_train_state
from tvc.utils.checkpoint_io import save_train_state as j_save_train_state
from tvc_torch.core.config import Config
from tvc_torch.parallel.train import make_train_step
from tvc_torch.utils.checkpoint_io import _from_optax, load_train_state
from tvc_torch.utils.convert import unet_from_jax

from test_torch_archs import ARCHS, tiny_cfg
from test_torch_train import tiny_train_cfg

LR = 1e-3
B1 = 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tier-1 workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    if arch == "2d":
        pair = tiny_train_cfg(JConfig), tiny_train_cfg(Config)
    else:
        pair = tiny_cfg(JConfig, **ARCHS[arch]), tiny_cfg(Config, **ARCHS[arch])
    for c in pair:
        c.optim.lr, c.optim.warmup = LR, 0
    return pair


def _variables(jcfg, seed=11, scale=0.08):
    size, c = jcfg.data.image_size, jcfg.data.channels
    shapes = jax.eval_shape(JUNetMoreDDPM(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, c * jcfg.data.num_frames)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, size, size, c * jcfg.data.num_frames_cond)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32),
                                  shapes)


def _batch(cfg, b=2, seed=3):
    rng = np.random.RandomState(seed)
    size, c = cfg.data.image_size, cfg.data.channels
    return {"x": rng.randn(b, size, size, c * cfg.data.num_frames).astype(np.float32),
            "cond": rng.randn(b, size, size, c * cfg.data.num_frames_cond).astype(np.float32)}


def _jax_draws(key, cfg, shape):
    k_label, k_noise = jax.random.split(key)
    labels = jax.random.randint(k_label, (shape[0],), 0, cfg.model.num_classes)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return torch.from_numpy(np.array(labels, np.int64)), torch.from_numpy(np.array(noise))


def _jax_state(jcfg, variables):
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    return JTrainState(params=params, opt_state=j_get_optimizer(jcfg).init(params),
                       ema=jax.tree_util.tree_map(lambda p: p.copy(), params),
                       step=jnp.zeros((), jnp.int32))


@functools.lru_cache(maxsize=None)
def jax_step_fn(arch, dtype_name):
    """The JAX package's jitted train step on a one-device mesh."""
    jcfg, _ = _cfgs(arch)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return j_make_train_step(jcfg, mesh, dtype=getattr(jnp, dtype_name))[1]


@functools.lru_cache(maxsize=None)
def jax_step(arch, dtype_name):
    """The JAX package's state after one step, its loss and its clipped
    gradients, in the port's names."""
    jcfg, cfg = _cfgs(arch)
    step_fn = jax_step_fn(arch, dtype_name)
    variables = _variables(jcfg)
    batch = _batch(cfg)
    jstate, jloss = step_fn(_jax_state(jcfg, variables),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(21))
    jopt = _from_optax(j_flatten(jstate.opt_state), cfg)
    grads = {k[len("mu/"):]: v / np.float32(1 - B1) for k, v in jopt.items()
             if k.startswith("mu/")}
    return variables, jstate, float(jloss), grads, jopt


def port_step(arch, dtype, variables):
    _, cfg = _cfgs(arch)
    init_fn, step_fn = make_train_step(cfg, device="cpu", dtype=dtype)
    state = init_fn(0)
    sd = unet_from_jax(cfg, variables)
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(sd[n])
    state.ema = {n: sd[n].clone().contiguous() for n in state.ema}
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    labels, noise = _jax_draws(jax.random.PRNGKey(21), cfg, batch["x"].shape)
    state, loss = step_fn(state, batch, labels, noise)
    return cfg, state, float(loss)


def assert_step_close(cfg, state, loss, jax_out, loss_tol, grad_tol):
    """``loss_tol``: the loss's absolute bound; ``grad_tol(name, floor)``:
    a gradient tensor's."""
    _, jstate, jloss, jgrads, jopt = jax_out
    assert abs(loss - jloss) <= loss_tol
    jparams = unet_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate.params))
    jema = unet_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate.ema))
    eps = max(cfg.optim.eps, 1e-8)
    floor = 1e-3 * max(float(g.abs().max()) for g in jgrads.values())
    assert set(jgrads) == set(state.params)
    for n, p in state.params.items():
        assert p.dtype == torch.float32 and state.ema[n].dtype == torch.float32, n
        g, g_ref = p.grad.numpy(), jgrads[n].numpy()
        assert np.abs(g - g_ref).max() <= grad_tol(n, floor), n
        p_ref = jparams[n].numpy()
        slope = np.abs(g - g_ref) / (np.minimum(np.abs(g), np.abs(g_ref)) + eps)
        bound = LR * np.minimum(2.0, slope) + 1e-6 * LR + 2 * np.spacing(np.abs(p_ref))
        assert (np.abs(p.detach().numpy() - p_ref) <= bound).all(), n
        assert (np.abs(state.ema[n].numpy() - jema[n].numpy())
                <= (1 - cfg.model.ema_rate) * bound + 1e-7).all(), n
    assert int(state.opt_state["count"]) == int(jopt["count"]) == 1
    assert int(state.opt_state["adam_count"]) == int(jopt["adam_count"]) == 1


@pytest.mark.parametrize("arch", list(ARCHS))
def test_zoo_train_step_matches_jax(arch):
    jax_out = jax_step(arch, "float32")
    cfg, state, loss = port_step(arch, torch.float32, jax_out[0])
    jgrads = jax_out[3]
    assert_step_close(cfg, state, loss, jax_out, 1e-5 * abs(jax_out[2]),
                      lambda n, floor: 2e-4 * max(float(jgrads[n].abs().max()), floor))
    # the step reached every block: the attention blocks' inputs have gradients
    attn = [p.grad for n, p in state.params.items() if "NIN_0" in n]
    assert attn and all(g.abs().max() > 0 for g in attn)


def test_bf16_train_step_matches_jax():
    jax_out = jax_step("2d", "bfloat16")
    jloss, jgrads = jax_out[2], jax_out[3]
    # the float32 step: the port's, which is the JAX package's within 2e-4 of
    # each gradient (test_zoo_train_step_matches_jax's bound), far inside bf16's
    _, state32, loss32 = port_step("2d", torch.float32, jax_out[0])
    grads32 = {n: p.grad for n, p in state32.params.items()}
    cfg, state, loss = port_step("2d", torch.bfloat16, jax_out[0])
    assert 0 < abs(jloss - loss32) <= 1e-3 * abs(loss32)  # bf16 did round
    assert_step_close(cfg, state, loss, jax_out, 2 * abs(jloss - loss32),
                      lambda n, floor: 2 * max(float((jgrads[n] - grads32[n]).abs().max()),
                                               floor))


def test_resume_a_jax_3d_snapshot(tmp_path):
    """The JAX package trains the 3-D net one step and snapshots; the port
    loads the snapshot into its own state and takes the next step as JAX
    does from the same files and draws."""
    arch = "unetmore3d"
    jcfg, cfg = _cfgs(arch)
    variables, jstate, _, _, _ = jax_step(arch, "float32")
    path = str(tmp_path / "ckpt_1")
    j_save_train_state(path, jstate.params, jstate.ema, 1, opt_state=jstate.opt_state)
    j_step_fn = jax_step_fn(arch, "float32")
    template = _jax_state(jcfg, variables)
    params, ema, step, opt = j_load_train_state(path, template.params, template.ema,
                                                template.opt_state)
    jstate = template.replace(params=params, ema=ema, opt_state=opt,
                              step=jnp.asarray(step, jnp.int32))
    batch = _batch(cfg, seed=4)
    key = jax.random.PRNGKey(40)
    jstate, jloss = j_step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    init_fn, step_fn = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    params, ema, step, opt = load_train_state(path, state.params, state.ema, state.opt_state,
                                              cfg)
    assert step == 1 and int(opt["count"]) == 1
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(params[n])
    state.ema, state.opt_state, state.step = ema, opt, step
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, loss = step_fn(state, tbatch, *_jax_draws(key, cfg, tbatch["x"].shape))
    assert state.step == 2
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jparams = unet_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jstate.params))
    for n, p in state.params.items():
        # two Adam steps of up to lr each, in float32 (test_torch_train.py's bound)
        assert np.abs(p.detach().numpy() - jparams[n].numpy()).max() <= 2e-3 * LR, n
