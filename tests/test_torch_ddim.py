"""The port's DDIM sampler and sweep against the JAX package, on the CPU.

Inputs are drawn with numpy from seeds and handed to both packages; the
model stand-in is one linear function written in both frameworks, so no UNet
compiles except in the ReconProgram test.

Tolerances, fp32 on both sides:
- grids: exact (integer math);
- one step: atol/rtol 1e-6 (the same elementwise formulas in the same
  order), at the top of the grid, mid-grid and the last step (t_prev < 0);
- a sweep over the 25-step grid with every start point: atol/rtol 1e-5 (up
  to 24 chained steps of that error);
- the ReconProgram on the tiny UNet: MSE and ELBO rtol 1e-5 (one UNet
  forward agrees to ~3e-6, tests/test_torch_unet.py);
- port-only invariants of tests/test_ddim.py at its 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import ddim as jddim
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.diffusion.plms import pndm_start_points
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch.diffusion import ddim, schedules
from ddpm_ood_tpu_torch.recon import sweep
from torch_recon_parity import (SCHED_ARGS, both_recon_programs, linear_model_jax,
                                linear_model_torch)

TOL = dict(atol=1e-6, rtol=1e-6)
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("steps", [10, 25, 100, 1000])
def test_ddim_timesteps_match_jax(steps):
    np.testing.assert_array_equal(ddim.ddim_timesteps(1000, steps),
                                  jddim.ddim_timesteps(1000, steps))


@pytest.mark.parametrize("ptype", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("t,t_prev,eta", [
    (960, 920, 0.0),   # the top of the 25-step grid
    (999, 998, 0.0),   # the top of the 1000-step grid
    (500, 460, 0.0),
    (500, 460, 0.7),   # eta > 0 with the noise passed in
    (40, 0, 0.0),
    (0, -40, 0.0),     # the last step: to the clean sample
    (10, -10, 0.5),
])
def test_ddim_step_matches_jax(ptype, t, t_prev, eta):
    rng = np.random.default_rng(t + 7)
    x, out, noise = (rng.standard_normal((3, 8, 8, 1)).astype(np.float32) for _ in range(3))
    js = jsched.make_schedule(*SCHED_ARGS, prediction_type=ptype)
    ts = schedules.make_schedule(*SCHED_ARGS, prediction_type=ptype)
    want = jddim.ddim_step(js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(t_prev),
                           jnp.asarray(x), eta=eta, noise=jnp.asarray(noise))
    got = ddim.ddim_step(ts, T(out), torch.tensor(t), torch.tensor(t_prev), T(x), eta=eta,
                         noise=T(noise))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddim_step_per_lane_timesteps_match_jax_vmap():
    """(K,) timesteps, one per lane, as jax.vmap of the scalar step."""
    rng = np.random.default_rng(1)
    x, out = (rng.standard_normal((4, 2, 8, 8, 1)).astype(np.float32) for _ in range(2))
    t = np.array([960, 500, 40, 0], np.int32)
    js = jsched.make_schedule(*SCHED_ARGS)
    want = jax.vmap(lambda o, tt, xx: jddim.ddim_step(js, o, tt, tt - 40, xx))(
        jnp.asarray(out), jnp.asarray(t), jnp.asarray(x))
    got = ddim.ddim_step(schedules.make_schedule(*SCHED_ARGS), T(out), T(t), T(t) - 40, T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddim_eta_without_noise_raises():
    ts = schedules.make_schedule(*SCHED_ARGS)
    x = torch.zeros((1, 4, 4, 1))
    with pytest.raises(ValueError, match="noise"):
        ddim.ddim_step(ts, x, torch.tensor(500), torch.tensor(400), x, eta=0.5)


def test_ddim_sweep_matches_jax():
    """Every start point of the 25-step grid, the top one (960) included."""
    rng = np.random.default_rng(2)
    ts = ddim.ddim_timesteps(1000, 25)
    st = pndm_start_points(ts, 1)
    x0 = rng.uniform(size=(2, 8, 8, 1)).astype(np.float32)
    noise = rng.standard_normal((len(st), 2, 8, 8, 1)).astype(np.float32)
    want = jsweep.ddim_sweep(jsched.make_schedule(*SCHED_ARGS), linear_model_jax, jnp.asarray(x0),
                             jnp.asarray(noise), jnp.asarray(ts), jnp.asarray(st), 25)
    got = sweep.ddim_sweep(schedules.make_schedule(*SCHED_ARGS), linear_model_torch, T(x0),
                           T(noise), T(ts), T(st), 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_recon_program_ddim_matches_jax():
    """Tiny UNet, 10-step grid, skip 3, 2 lane groups, with the ELBO column."""
    jprog, (jt, jmse, jperc, jelbo), prog, (t, mse, perc, elbo) = both_recon_programs(
        "ddim", score_elbo=True)
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_array_equal(prog.timesteps_desc, jprog.timesteps_desc)
    assert mse.shape == elbo.shape == (len(t), 2)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=0)
    np.testing.assert_allclose(elbo.numpy(), np.asarray(jelbo), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(perc.numpy(), np.asarray(jperc))  # zeros on both sides
    # one forward per grid step of each group, and one ELBO forward per group
    groups = sweep.group_t_starts(prog.timesteps_desc, prog.t_starts, 2)
    assert prog.model_evals == sum(len(s) for s, _ in groups) + len(groups)


# port-only invariants (tests/test_ddim.py)

def test_ddim_step_perfect_model_renoises_x0():
    """With the true epsilon, eta = 0 DDIM maps x_t to x0 noised to t_prev."""
    sched = schedules.make_schedule(*SCHED_ARGS)
    rng = np.random.default_rng(0)
    x0, eps = (T(rng.standard_normal((2, 8, 8, 1)).astype(np.float32)) for _ in range(2))
    x_t = schedules.add_noise(sched, x0, eps, 500)
    got = ddim.ddim_step(sched, eps, torch.tensor(500), torch.tensor(400), x_t)
    np.testing.assert_allclose(got.numpy(), schedules.add_noise(sched, x0, eps, 400).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_ddim_final_step_returns_x0():
    sched = schedules.make_schedule("linear_beta", 1000)
    x0 = torch.full((1, 4, 4, 1), 0.3)
    eps = T(np.random.default_rng(2).standard_normal((1, 4, 4, 1)).astype(np.float32))
    x_t = schedules.add_noise(sched, x0, eps, 100)
    got = ddim.ddim_step(sched, eps, torch.tensor(100), torch.tensor(-1), x_t)
    np.testing.assert_allclose(got.numpy(), x0.numpy(), atol=1e-5)


def test_ddim_sweep_lanes_match_single_lane_runs():
    """Each lane of a masked sweep equals a sweep of that lane alone."""
    sched = schedules.make_schedule(*SCHED_ARGS)
    ts = T(ddim.ddim_timesteps(1000, 10))
    t_starts = torch.tensor([100, 400, 800], dtype=torch.int32)
    rng = np.random.default_rng(3)
    x0 = T(rng.standard_normal((2, 8, 8, 1)).astype(np.float32))
    noise = T(rng.standard_normal((3, 2, 8, 8, 1)).astype(np.float32))
    swept = sweep.ddim_sweep(sched, linear_model_torch, x0, noise, ts, t_starts, 10)
    for k in range(3):
        single = sweep.ddim_sweep(sched, linear_model_torch, x0, noise[k: k + 1], ts,
                                  t_starts[k: k + 1], 10)
        np.testing.assert_allclose(swept[k].numpy(), single[0].numpy(), atol=2e-5, rtol=2e-4)
