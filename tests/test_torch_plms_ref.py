"""The port's carried-history PLMS sweep (``sampler="plms_ref"``) against the
JAX package, on the CPU.

Inputs are drawn with numpy from seeds and handed to both packages; the
model stand-in is one linear function written in both frameworks, so no UNet
compiles except in the ReconProgram test.

Tolerances:
- the host-side step table: exact, column by column, before any UNet runs;
- the sweep over the 10-step grid with the stand-in, against the JAX scan
  form and its eager form: atol/rtol 1e-5 (the eager form sums the
  Adams-Bashforth terms with integer coefficients and divides once, the
  table form multiplies by fractions);
- the ReconProgram on the tiny UNet: MSE rtol 1e-5 (one UNet forward agrees
  to ~3e-6, tests/test_torch_unet.py);
- port-only: the first trajectory starts from a fresh history, so it equals
  the fresh-history sweep's first lane (1e-6); the later ones do not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import plms as jplms
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu_torch.diffusion import plms, schedules
from ddpm_ood_tpu_torch.recon import sweep
from torch_recon_parity import (SCHED_ARGS, both_recon_programs, linear_model_jax,
                                linear_model_torch)

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("steps,skip", [(100, 4), (10, 3), (10, 1), (50, 7)])
def test_step_table_matches_jax_column_by_column(steps, skip):
    ts = plms.pndm_timesteps(1000, steps)
    st = plms.pndm_start_points(ts, skip)
    got = plms._build_ref_exact_step_table(ts, st, 1000 // steps)
    want = jplms._build_ref_exact_step_table(ts, st, 1000 // steps)
    assert sorted(got) == sorted(want)
    for col, value in want.items():
        assert got[col].dtype == value.dtype, col
        np.testing.assert_array_equal(got[col], value, err_msg=col)


def _sweep_inputs(seed=2, steps=10, skip=1):
    rng = np.random.default_rng(seed)
    ts = plms.pndm_timesteps(1000, steps)
    st = plms.pndm_start_points(ts, skip)
    x0 = rng.uniform(size=(2, 8, 8, 1)).astype(np.float32)
    noise = rng.standard_normal((len(st), 2, 8, 8, 1)).astype(np.float32)
    return ts, st, x0, noise


@pytest.mark.parametrize("form", ["scan", "eager"])
def test_sweep_matches_jax(form):
    """Every start point of the 10-step grid; the lanes after the first start
    at the Adams-Bashforth order the one before ended at."""
    ts, st, x0, noise = _sweep_inputs()
    jax_sweep = {"scan": jplms.plms_reference_exact_sweep,
                 "eager": jplms.plms_reference_exact_sweep_eager}[form]
    want = jax_sweep(jsched.make_schedule(*SCHED_ARGS), linear_model_jax, jnp.asarray(x0),
                     jnp.asarray(noise), ts, st, 10)
    got = plms.plms_reference_exact_sweep(schedules.make_schedule(*SCHED_ARGS),
                                          linear_model_torch, T(x0), T(noise), ts, st, 10)
    assert got.shape == (len(st), 2, 8, 8, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_recon_program_plms_ref_matches_jax():
    """Tiny UNet, 10-step grid, skip 3: one UNet call of batch 2 per row."""
    jprog, (jt, jmse, jperc), prog, (t, mse, perc) = both_recon_programs("plms_ref")
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(perc.numpy(), np.asarray(jperc))  # zeros on both sides
    np.testing.assert_allclose(prog.last_preview.numpy(), np.asarray(jprog.last_preview),
                               atol=1e-4, rtol=0)
    table = plms._build_ref_exact_step_table(prog.timesteps_desc, prog.t_starts, 100)
    assert prog.model_evals == len(table["t"])


# port-only

def test_first_lane_is_the_fresh_history_sweep_and_later_lanes_are_not():
    ts, st, x0, noise = _sweep_inputs()
    sched = schedules.make_schedule(*SCHED_ARGS)
    carried = plms.plms_reference_exact_sweep(sched, linear_model_torch, T(x0), T(noise), ts,
                                              st, 10)
    fresh = sweep.plms_sweep(sched, linear_model_torch, T(x0), T(noise), T(ts), T(st), 10)
    np.testing.assert_allclose(carried[0].numpy(), fresh[0].numpy(), atol=1e-6, rtol=1e-6)
    for k in range(1, len(st)):
        assert not torch.allclose(carried[k], fresh[k], atol=1e-4, rtol=1e-4), k


@pytest.mark.parametrize("flag", ["score_elbo", "score_ssim", "score_error_maps"])
def test_plms_ref_refuses_extra_scores(flag):
    with pytest.raises(ValueError, match="plms_ref"):
        sweep.ReconProgram(sched=schedules.make_schedule(*SCHED_ARGS), model_fn=linear_model_torch,
                           sampler="plms_ref", **{flag: True})


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="Unknown sampler"):
        sweep.ReconProgram(sched=schedules.make_schedule(*SCHED_ARGS), model_fn=linear_model_torch,
                           sampler="euler")
