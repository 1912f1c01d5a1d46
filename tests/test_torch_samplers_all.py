"""Every tvc_torch sampler and sampler option against the JAX package.

torch cannot reproduce ``jax.random``, so each sampler's draws are made in
JAX from the keys the JAX sampler splits, with its own ``_gamma_noise`` and
``fold_in(k, 1)`` for the Gamma and warm-start draws, and handed to the port
as tensors. ``x_init`` and ``cond`` are numpy-seeded, the eps function a
closed form.

Tolerances: DDPM and DDIM run the same float32 arithmetic per step,
max |diff| <= 1e-5; F-PNDM's chain of transfers over 14 calls (the tiny
schedule; 109 at subsample 100) <= 1e-4; the Langevin samplers <= 1e-5 on the
final sample (and on the trajectory where one is returned).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tvc.core.config import Config as JConfig
from tvc.samplers import langevin as jl
from tvc.samplers.ancestral import _gamma_noise
from tvc.samplers.ancestral import ddim_sampler as j_ddim_sampler
from tvc.samplers.ancestral import ddpm_sampler as j_ddpm_sampler
from tvc.samplers.pndm import fpndm_sampler as j_fpndm_sampler
from tvc.samplers.schedules import Schedule as JSchedule
from tvc.samplers.schedules import get_sigmas as j_get_sigmas
from tvc_torch.core.config import Config
from tvc_torch.samplers import langevin as tl
from tvc_torch.samplers.ancestral import (active_steps, ddim_noise_plan, ddim_sampler,
                                          ddpm_noise_plan, ddpm_sampler)
from tvc_torch.samplers.pndm import fpndm_sampler, fpndm_unet_calls
from tvc_torch.samplers.schedules import Schedule, get_sigmas

SHAPE = (2, 8, 8, 9)
COND_SHAPE = (2, 8, 8, 6)
ATOL = 1e-5
FPNDM_ATOL = 1e-4


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


def tiny_cfg(cls, gamma=False, sigma_dist="linear"):
    """The sampler settings of tests/conftest.py's tiny config (T = 20, subsample 5)."""
    cfg = cls()
    cfg.model.num_classes = 20
    cfg.model.gamma = gamma
    cfg.model.sigma_dist = sigma_dist
    cfg.sampling.subsample = 5
    return cfg


def schedules(gamma=False, subsample=5):
    jsched = JSchedule.from_config(tiny_cfg(JConfig, gamma))
    sched = Schedule.from_config(tiny_cfg(Config, gamma))
    return jsched, sched, jsched.subsample(subsample), sched.subsample(subsample)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*SHAPE).astype(np.float32),
            (rng.rand(*COND_SHAPE) * 2 - 1).astype(np.float32))


def _eps_jax(x, labels, cond):
    return jnp.tanh(0.7 * x + 0.01 * labels.astype(jnp.float32).reshape((-1, 1, 1, 1))
                    + 0.3 * jnp.mean(cond, axis=-1, keepdims=True))


def _eps_torch(x, labels, cond):
    return torch.tanh(0.7 * x + 0.01 * labels.float().reshape(-1, 1, 1, 1)
                      + 0.3 * cond.mean(dim=-1, keepdim=True))


def counting(fn, calls):
    def eps(x, labels, cond):
        calls.append(labels[0].item())
        return fn(x, labels, cond)
    return eps


def t(a):
    return torch.tensor(np.asarray(a))


# ----------------------------------------------------------------- schedules

@pytest.mark.parametrize("sigma_dist", ["linear", "geometric", "cosine"])
def test_get_sigmas_matches_jax(sigma_dist):
    np.testing.assert_array_equal(get_sigmas(tiny_cfg(Config, sigma_dist=sigma_dist)),
                                  j_get_sigmas(tiny_cfg(JConfig, sigma_dist=sigma_dist)))


@pytest.mark.parametrize("frac", [1.0, 0.5, 0.3])
@pytest.mark.parametrize("gamma", [False, True], ids=["normal", "gamma"])
def test_schedule_frac_matches_jax(frac, gamma):
    jsched, sched, _, _ = schedules(gamma)
    want, got = jsched.frac(frac), sched.frac(frac)
    for name in ("steps", "alphas", "alphas_prev", "betas", "k_cum", "theta_t"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- the draws

def jax_rows(keys, shape, gamma_params=None, fold=False):
    """Each key's draw: normal, or the centred Gamma noise of ``gamma_params[i]``."""
    rows = []
    for i, k in enumerate(keys):
        k = jax.random.fold_in(k, 1) if fold else k
        if gamma_params is None:
            rows.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
        else:
            kc, th, a = (jnp.float32(v) for v in gamma_params[i])
            rows.append(np.asarray(_gamma_noise(k, shape, kc, th, a, jnp.float32)))
    return np.stack(rows)


def gamma_params(sub, n):
    a = np.concatenate([sub.alphas, [sub.alphas[-1]]])[:n].astype(np.float32)
    gi = np.minimum(np.arange(n), len(sub) - 1)
    return [(np.float32(sub.k_cum[g]), np.float32(sub.theta_t[g]), a[i])
            for i, g in enumerate(gi)]


DDPM_CASES = {
    "default": {},
    "no_denoise": {"denoise": False},
    "no_clip": {"clip_before": False},
    "trajectory": {"final_only": False},
    "just_beta": {"just_beta": True},
    "same_noise": {"same_noise": True},
    "gamma": {"gamma": True},
    "t_min": {"t_min": 2.0},
    "t_min_half": {"t_min": 0.5},
    "t_min_trajectory": {"t_min": 2.0, "final_only": False},
    "gamma_t_min": {"gamma": True, "t_min": 2.0},
    "t_min_no_step": {"t_min": 9.0},
}


@pytest.mark.parametrize("case", list(DDPM_CASES))
def test_ddpm_sampler_options_match_jax(case):
    kw = DDPM_CASES[case]
    gamma = kw.get("gamma", False)
    _, _, jsub, sub = schedules(gamma)
    x_init, cond = inputs(1)
    key = jax.random.PRNGKey(7)
    want = np.asarray(j_ddpm_sampler(key, jnp.asarray(x_init), _eps_jax, jsub,
                                     cond=jnp.asarray(cond), **kw))
    denoise = kw.get("denoise", True)
    n = len(jsub) + (1 if denoise else 0)
    keys = jax.random.split(key, len(jsub) + 1)[:n]
    gp = gamma_params(jsub, n) if gamma else None
    noise = jax_rows(keys, SHAPE, gp)
    active, warm = active_steps(sub, n, kw.get("t_min", -1.0))
    warm_noise = None
    if warm is not None:
        warm_noise = t(jax_rows([keys[warm]], SHAPE, [gp[warm]] if gamma else None, fold=True)[0])
    calls = []
    got = ddpm_sampler(t(x_init), counting(_eps_torch, calls), sub, cond=t(cond),
                       noise=t(noise), warm_noise=warm_noise, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    # an inactive step of the warm start makes no UNet call; its output is x unchanged
    assert len(calls) == int(active.sum())
    if case == "t_min":
        assert calls == [12, 16, 4] and warm == 3


DDIM_CASES = {
    "default": {},
    "no_denoise": {"denoise": False},
    "no_clip": {"clip_before": False},
    "trajectory": {"final_only": False},
    "t_min": {"t_min": 2.0},
    "gamma_t_min": {"gamma": True, "t_min": 0.5},
    "gamma": {"gamma": True},
}


@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_ddim_sampler_matches_jax(case):
    kw = DDIM_CASES[case]
    gamma = kw.get("gamma", False)
    _, _, jsub, sub = schedules(gamma)
    x_init, cond = inputs(2)
    key = jax.random.PRNGKey(8)
    want = np.asarray(j_ddim_sampler(key, jnp.asarray(x_init), _eps_jax, jsub,
                                     cond=jnp.asarray(cond), **kw))
    n = len(jsub) + (1 if kw.get("denoise", True) else 0)
    keys = jax.random.split(key, n)
    active, warm = active_steps(sub, n, kw.get("t_min", -1.0))
    warm_noise = None
    if warm is not None:
        gp = gamma_params(jsub, n) if gamma else None
        warm_noise = t(jax_rows([keys[warm]], SHAPE, [gp[warm]] if gamma else None)[0])
    calls = []
    got = ddim_sampler(t(x_init), counting(_eps_torch, calls), sub, cond=t(cond),
                       warm_noise=warm_noise, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert len(calls) == int(active.sum())


def test_samplers_draw_from_a_generator_in_plan_order():
    """With a generator, DDPM draws its step rows, then the warm row, as
    ``NoisePlan.draw`` does; the same draws passed explicitly give the same sample."""
    _, _, _, sub = schedules(True)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    cond = torch.zeros(COND_SHAPE)
    for kw in ({}, {"gamma": True, "t_min": 0.5}, {"t_min": 2.0}):
        plan = ddpm_noise_plan(sub, gamma=kw.get("gamma", False), t_min=kw.get("t_min", -1.0))
        noise, warm = plan.draw(SHAPE, torch.Generator().manual_seed(3))
        a = ddpm_sampler(x, _eps_torch, sub, cond=cond,
                         generator=torch.Generator().manual_seed(3), **kw)
        b = ddpm_sampler(x, _eps_torch, sub, cond=cond, noise=noise, warm_noise=warm, **kw)
        assert torch.equal(a, b)
        # no draw for a step that adds no noise or does not run
        active, _ = active_steps(sub, plan.n_steps, kw.get("t_min", -1.0))
        assert not plan.rows[~active].any() and not plan.rows[-2:].any()
    plan = ddim_noise_plan(sub, gamma=True, t_min=0.5)
    assert not plan.rows.any() and plan.warm == 1
    a = ddim_sampler(x, _eps_torch, sub, cond=cond, gamma=True, t_min=0.5,
                     generator=torch.Generator().manual_seed(4))
    _, warm = plan.draw(SHAPE, torch.Generator().manual_seed(4), step_rows=False)
    assert torch.equal(a, ddim_sampler(x, _eps_torch, sub, cond=cond, gamma=True, t_min=0.5,
                                       warm_noise=warm))
    with pytest.raises(ValueError, match="warm"):
        ddim_sampler(x, _eps_torch, sub, cond=cond, t_min=0.5)


def test_gamma_needs_the_gamma_schedule():
    _, _, _, sub = schedules(False)
    with pytest.raises(ValueError, match="model.gamma"):
        ddpm_sampler(torch.zeros(SHAPE), _eps_torch, sub, gamma=True,
                     generator=torch.Generator())


# ------------------------------------------------------------------- F-PNDM

@pytest.mark.parametrize("subsample,clip_before,final_only",
                         [(5, True, True), (10, True, True), (5, False, True), (5, True, False)],
                         ids=["default", "subsample10", "no_clip", "trajectory"])
def test_fpndm_sampler_matches_jax(subsample, clip_before, final_only):
    jsched, sched, _, _ = schedules()
    x_init, cond = inputs(3)
    want = np.asarray(j_fpndm_sampler(jax.random.PRNGKey(0), jnp.asarray(x_init), _eps_jax,
                                      jsched, subsample, cond=jnp.asarray(cond),
                                      clip_before=clip_before, final_only=final_only))
    calls = []
    got = fpndm_sampler(t(x_init), counting(_eps_torch, calls), sched, subsample, cond=t(cond),
                        clip_before=clip_before, final_only=final_only).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FPNDM_ATOL)
    assert len(calls) == fpndm_unet_calls(sched, subsample) == 4 * 3 + (subsample - 3)


def test_fpndm_labels_are_fractional_float32():
    """Float labels, the first midpoint -0.5, walking toward -1; 109 calls at
    the flagship subsample of 100."""
    _, sched, _, _ = schedules()
    seen = []

    def eps(x, labels, cond):
        assert labels.dtype == torch.float32
        seen.append(float(labels[0]))
        return torch.zeros_like(x)

    fpndm_sampler(torch.zeros(1, 4, 4, 3), eps, sched, 5)
    assert seen[:4] == [0.0, -0.5, -0.5, -1.0]
    assert seen[4:8] == [4.0, 2.0, 2.0, 0.0]
    assert seen[12:] == [12.0, 16.0]
    flagship = Schedule.from_config(Config())
    assert fpndm_unet_calls(flagship, 100) == 109


# ----------------------------------------------------------------- Langevin

SIGMAS = np.geomspace(1.0, 0.01, 4)
N_EACH = 3
STEP_LR = 1e-4


def _score_jax(x, labels, cond):
    return -0.3 * x + 0.05 * jnp.sin(labels.astype(jnp.float32)).reshape((-1, 1, 1, 1))


def _score_torch(x, labels, cond):
    return -0.3 * x + 0.05 * torch.sin(labels.float()).reshape(-1, 1, 1, 1)


def jax_normal_rows(key, n, shape):
    return jax_rows(jax.random.split(key, n), shape)


LANGEVIN_CASES = {
    "default": {},
    "trajectory": {"final_only": False},
    "harm_mean": {"harm_mean": True},
    "same_noise": {"same_noise": True},
    "frac_steps": {"frac_steps": 0.5},
    "no_denoise": {"denoise": False, "final_only": False},
}


@pytest.mark.parametrize("case", list(LANGEVIN_CASES))
def test_anneal_langevin_dynamics_matches_jax(case):
    kw = LANGEVIN_CASES[case]
    x_init, cond = inputs(4)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jl.anneal_langevin_dynamics(
        key, jnp.asarray(x_init), _eps_jax, SIGMAS, cond=jnp.asarray(cond),
        n_steps_each=N_EACH, step_lr=STEP_LR, **kw))
    levels = len(SIGMAS) - (int((1 - kw["frac_steps"]) * len(SIGMAS)) if "frac_steps" in kw
                            else 0)
    noise = jax_normal_rows(key, levels * N_EACH, SHAPE)
    got = tl.anneal_langevin_dynamics(t(x_init), _eps_torch, SIGMAS, cond=t(cond),
                                      n_steps_each=N_EACH, step_lr=STEP_LR,
                                      noise=t(noise), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("harm_mean", [False, True])
def test_sparse_anneal_langevin_dynamics_matches_jax(harm_mean):
    x_init, cond = inputs(5)
    key = jax.random.PRNGKey(10)
    want = np.asarray(jl.sparse_anneal_langevin_dynamics(
        key, jnp.asarray(x_init), 0.25, _eps_jax, SIGMAS, cond=jnp.asarray(cond),
        n_steps_each=N_EACH, step_lr=STEP_LR, harm_mean=harm_mean))
    noise = jax_normal_rows(key, len(SIGMAS) * N_EACH, SHAPE)
    got = tl.sparse_anneal_langevin_dynamics(t(x_init), 0.25, _eps_torch, SIGMAS, cond=t(cond),
                                             n_steps_each=N_EACH, step_lr=STEP_LR,
                                             harm_mean=harm_mean, noise=t(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"harm_mean": True, "final_only": False}, {"denoise": False}],
                         ids=["default", "harm_mean_trajectory", "no_denoise"])
def test_anneal_langevin_dynamics_consistent_matches_jax(kw):
    """eps_fn sees sigma values (float32), then the label L - 1 in the denoise step."""
    x_init, cond = inputs(6)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jl.anneal_langevin_dynamics_consistent(
        key, jnp.asarray(x_init), _eps_jax, SIGMAS, cond=jnp.asarray(cond),
        n_steps_each=N_EACH, step_lr=STEP_LR, **kw))
    n = (len(SIGMAS) - 1) * N_EACH + 1
    noise = jax_normal_rows(key, n, SHAPE)
    seen = []
    got = tl.anneal_langevin_dynamics_consistent(
        t(x_init), counting(_eps_torch, seen), SIGMAS, cond=t(cond), n_steps_each=N_EACH,
        step_lr=STEP_LR, noise=t(noise), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(seen[:n], np.geomspace(1.0, 0.01, n).astype(np.float32),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="satisfy"):
        tl.anneal_langevin_dynamics_consistent(t(x_init), _eps_torch, SIGMAS, step_lr=1.0,
                                               n_steps_each=N_EACH, noise=t(noise))


def test_anneal_langevin_dynamics_inpainting_matches_jax():
    x_init, cond = inputs(7)
    ref = np.random.RandomState(8).rand(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = np.asarray(jl.anneal_langevin_dynamics_inpainting(
        key, jnp.asarray(x_init), jnp.asarray(ref), _eps_jax, SIGMAS, cond=jnp.asarray(cond),
        n_steps_each=N_EACH, step_lr=STEP_LR))
    keys = jax.random.split(key, len(SIGMAS) * N_EACH)
    pairs = [jax.random.split(k) for k in keys]
    half = SHAPE[:2] + (SHAPE[2] // 2,) + SHAPE[3:]
    corrupt = np.stack([np.asarray(jax.random.normal(p[0], half, jnp.float32)) for p in pairs])
    noise = np.stack([np.asarray(jax.random.normal(p[1], SHAPE, jnp.float32)) for p in pairs])
    x = t(x_init)
    got = tl.anneal_langevin_dynamics_inpainting(x, t(ref), _eps_torch, SIGMAS, cond=t(cond),
                                                 n_steps_each=N_EACH, step_lr=STEP_LR,
                                                 noise=t(noise), corrupt_noise=t(corrupt))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert torch.equal(x, t(x_init))  # the input is not written


def test_anneal_langevin_dynamics_interpolation_matches_jax():
    x_init, cond = inputs(9)
    n_int = 3
    key = jax.random.PRNGKey(13)
    cond_rep = np.repeat(cond, n_int, axis=0)
    want = np.asarray(jl.anneal_langevin_dynamics_interpolation(
        key, jnp.asarray(x_init), _eps_jax, SIGMAS, n_int, cond=jnp.asarray(cond_rep),
        n_steps_each=N_EACH, step_lr=STEP_LR))
    keys = jax.random.split(key, len(SIGMAS) * N_EACH)
    noise = np.stack([np.stack([np.asarray(jax.random.normal(k, SHAPE, jnp.float32))
                                for k in jax.random.split(ki)]) for ki in keys])
    got = tl.anneal_langevin_dynamics_interpolation(
        t(x_init), _eps_torch, SIGMAS, n_int, cond=t(cond_rep), n_steps_each=N_EACH,
        step_lr=STEP_LR, noise=t(noise)).numpy()
    assert got.shape == want.shape == (1, SHAPE[0] * n_int) + SHAPE[1:]
    np.testing.assert_allclose(got, want, atol=ATOL)
