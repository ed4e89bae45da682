"""The port's DPM-Solver++(2M) sampler and sweep against the JAX package, on
the CPU.

Inputs are drawn with numpy from seeds and handed to both packages; the
model stand-ins are functions written in both frameworks, so no UNet
compiles except in the ReconProgram test. The sweep parity test uses the
linear one: with the nonlinear one of tests/test_dpm.py the high start
points grow to |x| ~ 100 over 24 steps and amplify fp32 rounding, so both
packages land ~1e-2 from a float64 run at t = 960 (and 1.2e-3 from each
other).

Tolerances, fp32 on both sides:
- grids: exact;
- one masked step over lanes that mix has_prev and active: atol/rtol 1e-6,
  at the top of the grid (t + step > 999, clamped), mid-grid and the last
  step (t_next < 0, acp = 1);
- a sweep over the 25-step grid with every start point: atol/rtol 1e-5 (up
  to 24 chained steps of that error);
- the ReconProgram on the tiny UNet: MSE rtol 1e-5 (one UNet forward agrees
  to ~3e-6, tests/test_torch_unet.py);
- port-only invariants of tests/test_dpm.py: the exact epsilon recovers x0
  (1e-4), a lane of a masked sweep equals that lane alone (2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import dpm_solver as jdpm
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.diffusion.plms import pndm_start_points
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch.diffusion import dpm_solver as dpm
from ddpm_ood_tpu_torch.diffusion import schedules
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


def toy_model_torch(x, t):
    """The nonlinear stand-in of tests/test_dpm.py."""
    tt = (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.sin(3.0 * x) * (0.5 + tt) + 0.1 * x


@pytest.mark.parametrize("steps", [10, 25, 100])
def test_dpm_timesteps_match_jax(steps):
    np.testing.assert_array_equal(dpm.dpm_timesteps(1000, steps), jdpm.dpm_timesteps(1000, steps))


@pytest.mark.parametrize("t,ratio", [
    (960, 40),   # top of the 25-step grid: t + ratio = 1000 is clamped to 999
    (999, 1),    # top of the 1000-step grid
    (500, 40),
    (40, 40),    # t_next = 0
    (0, 40),     # the last step: t_next = -40, to the clean sample
])
def test_dpm_step_matches_jax_vmap(t, ratio):
    """Four lanes: (has_prev, active) = (F, T), (T, T), (T, F), (F, F)."""
    rng = np.random.default_rng(t + ratio)
    x, prev, out = (rng.standard_normal((4, 2, 8, 8, 1)).astype(np.float32) for _ in range(3))
    has_prev = np.array([False, True, True, False])
    active = np.array([True, True, False, False])
    js = jsched.make_schedule(*SCHED_ARGS)
    jstate = jdpm.DPMState(x=jnp.asarray(x), prev_x0=jnp.asarray(prev),
                           has_prev=jnp.asarray(has_prev))
    tj = jnp.int32(t)
    want = jax.vmap(lambda s, o, a: jdpm.dpm_step(js, s, o, tj, tj - ratio, tj + ratio,
                                                  active=a))(jstate, jnp.asarray(out),
                                                             jnp.asarray(active))
    state = dpm.DPMState(x=T(x), prev_x0=T(prev), has_prev=T(has_prev))
    tt = torch.tensor(t, dtype=torch.int32)
    got = dpm.dpm_step(schedules.make_schedule(*SCHED_ARGS), state, T(out), tt, tt - ratio,
                       tt + ratio, active=T(active))
    assert torch.isfinite(got.x).all()
    for field in ("x", "prev_x0"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   **TOL, err_msg=field)
    np.testing.assert_array_equal(got.has_prev.numpy(), np.asarray(want.has_prev))
    np.testing.assert_array_equal(got.x[2:].numpy(), x[2:])  # inactive lanes untouched


@pytest.mark.parametrize("t", [-40, 0, 500, 999, 1039])
def test_alpha_sigma_and_lambda_match_jax(t):
    """Reads past either end of the table: clamped, and acp = 1 below 0."""
    js = jsched.make_schedule(*SCHED_ARGS)
    ts = schedules.make_schedule(*SCHED_ARGS)
    pairs = zip(dpm._alpha_sigma(ts, torch.tensor(t)), jdpm._alpha_sigma(js, jnp.int32(t)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = dpm._lambda(ts, torch.tensor(t)).numpy()
    assert np.isfinite(got)
    np.testing.assert_allclose(got, np.asarray(jdpm._lambda(js, jnp.int32(t))), **TOL)


def test_dpm_sweep_matches_jax():
    """Every start point of the 25-step grid, the top one (960) included."""
    rng = np.random.default_rng(2)
    ts = dpm.dpm_timesteps(1000, 25)
    st = pndm_start_points(ts, 1)
    x0 = rng.uniform(size=(2, 8, 8, 1)).astype(np.float32)
    noise = rng.standard_normal((len(st), 2, 8, 8, 1)).astype(np.float32)
    want = jsweep.dpm_sweep(jsched.make_schedule(*SCHED_ARGS), linear_model_jax,
                            jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts),
                            jnp.asarray(st), 25)
    got = sweep.dpm_sweep(schedules.make_schedule(*SCHED_ARGS), linear_model_torch, T(x0),
                          T(noise), T(ts), T(st), 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_recon_program_dpm_matches_jax():
    """Tiny UNet, 10-step grid, skip 3, 2 lane groups."""
    jprog, (jt, jmse, jperc), prog, (t, mse, perc) = both_recon_programs("dpm")
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_array_equal(prog.timesteps_desc, jprog.timesteps_desc)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(perc.numpy(), np.asarray(jperc))  # zeros on both sides
    np.testing.assert_allclose(prog.last_preview.numpy(), np.asarray(jprog.last_preview),
                               atol=1e-4, rtol=0)
    assert prog.model_evals == sum(
        len(s) for s, _ in sweep.group_t_starts(prog.timesteps_desc, prog.t_starts, 2))


# port-only invariants (tests/test_dpm.py)

@pytest.mark.parametrize("shape", [(3, 8, 8, 1), (2, 6, 6, 4, 3)])
def test_dpm_exact_epsilon_recovers_x0(shape):
    """The true epsilon makes every x0 prediction exact, so the solver lands
    on x0 (2D images and 3D volumes)."""
    sched = schedules.make_schedule(*SCHED_ARGS)
    rng = np.random.default_rng(1)
    x0 = T(rng.uniform(size=shape).astype(np.float32))
    noise = T(rng.standard_normal((1,) + shape).astype(np.float32))
    ts = T(dpm.dpm_timesteps(1000, 10))
    acp = sched.alphas_cumprod

    def exact_eps(x, t):
        a = acp[t.long()].reshape((-1,) + (1,) * (x.dim() - 1))
        return (x - torch.sqrt(a) * x0) / torch.sqrt(1.0 - a)

    model = lambda x, t: exact_eps(x.movedim(1, -1), t).movedim(-1, 1)  # noqa: E731
    out = sweep.dpm_sweep(sched, model, x0, noise, ts, ts[:1].clone(), 10)
    np.testing.assert_allclose(out[0].numpy(), x0.numpy(), rtol=1e-4, atol=1e-4)


def test_dpm_sweep_lanes_match_single_lane_runs():
    sched = schedules.make_schedule(*SCHED_ARGS)
    ts = T(dpm.dpm_timesteps(1000, 10))
    t_starts = torch.tensor([100, 500, 900], dtype=torch.int32)
    rng = np.random.default_rng(2)
    x0 = T(rng.uniform(size=(2, 8, 8, 1)).astype(np.float32))
    noise = T(rng.standard_normal((3, 2, 8, 8, 1)).astype(np.float32))
    swept = sweep.dpm_sweep(sched, toy_model_torch, x0, noise, ts, t_starts, 10)
    for k in range(3):
        single = sweep.dpm_sweep(sched, toy_model_torch, x0, noise[k: k + 1], ts,
                                 t_starts[k: k + 1], 10)
        np.testing.assert_allclose(swept[k].numpy(), single[0].numpy(), rtol=2e-5, atol=2e-6)
