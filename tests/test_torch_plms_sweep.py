"""The port's schedules, PLMS step and reconstruction sweep against JAX, on the CPU.

Inputs and noise are made with numpy from a seed and handed to both
packages; nothing is seeded on both sides.

Tolerances:
- grids, start points and lane groups: exact (integer math).
- schedule tables: exact (both build them in float64 on the host with numpy
  and store float32).
- forward-process and PLMS-step math: atol 1e-6 / rtol 1e-6 in fp32 (the same
  elementwise formulas in the same order; XLA may still fuse a multiply-add).
- the (K, B) MSE table of the full program with the tiny UNet: rtol 1e-5
  (2e-7 observed). One UNet forward agrees to ~3e-6 absolute
  (test_torch_unet.py); a lane chains at most 11 of them through the PLMS
  recursion, and each MSE averages 256 squared errors of values in [0, 1].
  The preview (single clamped pixels, no averaging): atol 1e-4.
- the metrics tail (LPIPS from one set of JAX params, 1 - SSIM, the error
  maps) on the same program: LPIPS and SSIM atol 1e-5 (values ~0.05 and
  ~0.5; the metrics of reconstructions that agree to ~1e-6), the error maps
  (single pixels) atol 1e-4 like the preview.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import plms as jplms
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch.diffusion import plms, schedules
from ddpm_ood_tpu_torch.models.unet import make_unet
from ddpm_ood_tpu_torch.recon import sweep
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_lpips import jax_lpips_init
from test_torch_unet import seeded_jax_params

TOL = dict(atol=1e-6, rtol=1e-6)
SCHED_ARGS = ("scaled_linear_beta", 1000, 0.0015, 0.0195)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("steps,skip", [(100, 4), (10, 3), (50, 1), (1000, 7)])
def test_grid_start_points_and_groups_match_jax(steps, skip):
    ts = plms.pndm_timesteps(1000, steps)
    np.testing.assert_array_equal(ts, jplms.pndm_timesteps(1000, steps))
    st = plms.pndm_start_points(ts, skip)
    np.testing.assert_array_equal(st, jplms.pndm_start_points(ts, skip))
    for groups in (1, 2, 16):
        got = sweep.group_t_starts(ts, st, groups)
        want = jsweep.group_t_starts(ts, st, groups)
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("name,snr", [("linear_beta", 1.0), ("scaled_linear_beta", 1.0),
                                      ("cosine_beta", 1.0), ("scaled_linear_beta", 0.5)])
def test_schedule_tables_match_jax(name, snr):
    got = schedules.make_schedule(name, 1000, 0.0015, 0.0195, snr_shift=snr)
    want = jsched.make_schedule(name, 1000, 0.0015, 0.0195, snr_shift=snr)
    for field in ("betas", "alphas", "alphas_cumprod"):
        g = getattr(got, field)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, field)))


@pytest.mark.parametrize("ptype", ["epsilon", "sample", "v_prediction"])
def test_forward_process_math_matches_jax(ptype):
    rng = np.random.default_rng(0)
    x0, noise, out = (rng.standard_normal((3, 8, 8, 1)).astype(np.float32) for _ in range(3))
    t = np.array([0, 499, 999], np.int32)
    ts = schedules.make_schedule(*SCHED_ARGS, prediction_type=ptype)
    js = jsched.make_schedule(*SCHED_ARGS, prediction_type=ptype)
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    pairs = [
        (schedules.add_noise(ts, T(x0), T(noise), T(t)), jsched.add_noise(js, x0, noise, t)),
        (schedules.epsilon_from_model_output(ts, T(out), T(x0), T(t)),
         jsched.epsilon_from_model_output(js, out, x0, t)),
        (schedules.pred_x0_from_model_output(ts, T(out), T(x0), T(t)),
         jsched.pred_x0_from_model_output(js, out, x0, t)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multi_lane_step_with_mixed_counters_matches_vmap():
    """Lanes at Euler, Heun re-do, AB2, AB3 and AB4 (counter 7), one inactive:
    one step of the port equals jax.vmap(plms_step) lane for lane."""
    rng = np.random.default_rng(1)
    k, shape = 6, (2, 4, 4, 1)
    x, cur, out = (rng.standard_normal((k,) + shape).astype(np.float32) for _ in range(3))
    ets = rng.standard_normal((k, 4) + shape).astype(np.float32)
    counter = np.array([0, 1, 2, 3, 7, 4], np.int32)
    active = np.array([True, True, True, True, True, False])
    t = 500

    js = jsched.make_schedule(*SCHED_ARGS)
    jstate = jplms.PLMSState(x=jnp.asarray(x), ets=jnp.asarray(ets),
                             counter=jnp.asarray(counter), cur_sample=jnp.asarray(cur))
    want = jax.vmap(lambda s, o, a: jplms.plms_step(js, s, o, jnp.int32(t), 10, active=a))(
        jstate, jnp.asarray(out), jnp.asarray(active))

    ts = schedules.make_schedule(*SCHED_ARGS)
    state = plms.PLMSState(x=torch.from_numpy(x), ets=torch.from_numpy(ets),
                           counter=torch.from_numpy(counter), cur_sample=torch.from_numpy(cur))
    got = plms.plms_step(ts, state, torch.from_numpy(out), torch.tensor(t, dtype=torch.int32),
                         10, torch.from_numpy(active))
    for field in ("x", "ets", "cur_sample"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **TOL, err_msg=field)
    np.testing.assert_array_equal(got.counter.numpy(), np.asarray(want.counter))
    # the inactive lane is untouched
    np.testing.assert_array_equal(got.x[5].numpy(), x[5])


def test_sweep_main_path_grid_matches_jax():
    """plms_sweep over the 100-step grid, all 25 skip-4 lanes in one group,
    with a linear stand-in for the UNet (eps_hat = 0.1 x)."""
    rng = np.random.default_rng(2)
    ts = plms.pndm_timesteps(1000, 100)
    st = plms.pndm_start_points(ts, 4)
    x0 = rng.uniform(size=(2, 8, 8, 1)).astype(np.float32)
    noise = rng.standard_normal((len(st), 2, 8, 8, 1)).astype(np.float32)
    want = jsweep.plms_sweep(jsched.make_schedule(*SCHED_ARGS), lambda x, t: 0.1 * x,
                             jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts),
                             jnp.asarray(st), 100)
    got = sweep.plms_sweep(schedules.make_schedule(*SCHED_ARGS), lambda x, t: 0.1 * x,
                           torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(ts),
                           torch.from_numpy(st), 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_recon_program_mse_table_matches_jax():
    """Tiny UNet with the same weights, the same host noise: 10 steps, skip 3,
    2 lane groups."""
    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=3)
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(2, 16, 16, 1)).astype(np.float32)

    def host_noise(shape, t_starts):
        return np.random.default_rng(5).standard_normal(shape).astype(np.float32)

    jprog = jsweep.ReconProgram(
        sched=jsched.make_schedule(*SCHED_ARGS),
        model_fn=jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t), params),
        num_inference_steps=10, inference_skip_factor=3, num_groups=2,
        host_noise_fn=host_noise, latent_sample_shape=(16, 16, 1), overlap_host_noise=False,
    )
    jt, jmse, jperc = jprog(jnp.asarray(images), jax.random.PRNGKey(0))

    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    prog = sweep.ReconProgram(
        sched=schedules.make_schedule(*SCHED_ARGS),
        model_fn=model.to(memory_format=torch.channels_last).eval(),
        num_inference_steps=10, inference_skip_factor=3, num_groups=2, host_noise_fn=host_noise,
    )
    t, mse, perc = prog(images)
    np.testing.assert_array_equal(t, np.asarray(jt))
    assert mse.shape == (4, 2) and prog.model_evals == sum(
        len(s) for s, _ in sweep.group_t_starts(prog.timesteps_desc, prog.t_starts, 2))
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(perc.numpy(), np.asarray(jperc))  # zeros on both sides
    np.testing.assert_allclose(prog.last_preview.numpy(), np.asarray(jprog.last_preview),
                               atol=1e-4, rtol=0)


def test_recon_program_metrics_tail_matches_jax():
    """The same program with LPIPS (one set of JAX params, 16x16 padded to
    32), --score_ssim and --save_error_maps on both sides: every output of the
    metrics tail, across 2 lane groups."""
    from ddpm_ood_tpu.losses import lpips as jlpips
    from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
    from ddpm_ood_tpu_torch.utils.convert import jax_lpips_params_to_state_dict

    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=3)
    lpips_params = jax_lpips_init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    images = rng.uniform(size=(2, 16, 16, 1)).astype(np.float32)

    def host_noise(shape, t_starts):
        return np.random.default_rng(7).standard_normal(shape).astype(np.float32)

    common = dict(num_inference_steps=10, inference_skip_factor=3, num_groups=2,
                  host_noise_fn=host_noise, score_ssim=True, score_error_maps=True)
    jprog = jsweep.ReconProgram(
        sched=jsched.make_schedule(*SCHED_ARGS),
        model_fn=jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t), params),
        perceptual_fn=jlpips.PerceptualLoss(dimensions=2, params=lpips_params),
        latent_sample_shape=(16, 16, 1), overlap_host_noise=False, **common)
    jt, jmse, jperc, jssim = jprog(jnp.asarray(images), jax.random.PRNGKey(0))

    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    prog = sweep.ReconProgram(
        sched=schedules.make_schedule(*SCHED_ARGS),
        model_fn=model.to(memory_format=torch.channels_last).eval(),
        perceptual_fn=PerceptualLoss(state_dict=jax_lpips_params_to_state_dict(lpips_params)),
        **common)
    t, mse, perc, ssim_d = prog(images)
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=0)
    assert (perc > 0).all() and (ssim_d > 0).all()
    np.testing.assert_allclose(perc.numpy(), np.asarray(jperc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ssim_d.numpy(), np.asarray(jssim), atol=1e-5, rtol=0)
    assert prog.last_error_maps.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(prog.last_error_maps.numpy(), np.asarray(jprog.last_error_maps),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(prog.last_preview.numpy(), np.asarray(jprog.last_preview),
                               atol=1e-4, rtol=0)
