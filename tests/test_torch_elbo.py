"""The port's variational-bound (ELBO) score against the JAX package, on the
CPU.

Inputs are drawn with numpy from seeds and handed to both packages.

Tolerances, fp32 on both sides:
- the (T,) weight table and the per-image terms of each prediction type:
  rtol 1e-6 (the same formulas; the mean over 64 values may sum in another
  order);
- the ReconProgram on the tiny UNet (PLMS, 2 lane groups): the ELBO table
  rtol 1e-5, as the MSE table (one UNet forward agrees to ~3e-6,
  tests/test_torch_unet.py), and the MSE and LPIPS tables with the ELBO
  switched on equal the port's own without it;
- port-only invariants of tests/test_elbo.py: the weights against a float64
  numpy formula (rtol 1e-4), the exact epsilon scores 0, a worse epsilon
  scores higher.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import elbo as jelbo
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu_torch.diffusion import elbo, schedules
from torch_recon_parity import SCHED_ARGS, both_recon_programs

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["scaled_linear_beta", "linear_beta", "cosine_beta"])
def test_elbo_weights_match_jax(name):
    got = elbo.elbo_kl_weights(schedules.make_schedule(name, 1000, 0.0015, 0.0195)).numpy()
    want = np.asarray(jelbo.elbo_kl_weights(jsched.make_schedule(name, 1000, 0.0015, 0.0195)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ptype", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("per_image_t", [False, True])
def test_elbo_terms_match_jax(ptype, per_image_t):
    rng = np.random.default_rng(3)
    out, x_t, noise = (rng.standard_normal((4, 8, 8, 1)).astype(np.float32) for _ in range(3))
    t = np.array([1, 40, 500, 999], np.int32) if per_image_t else np.int32(300)
    got = elbo.elbo_terms_from_model(schedules.make_schedule(*SCHED_ARGS, prediction_type=ptype),
                                     T(out), T(x_t), T(noise), torch.as_tensor(t))
    want = jelbo.elbo_terms_from_model(jsched.make_schedule(*SCHED_ARGS, prediction_type=ptype),
                                       jnp.asarray(out), jnp.asarray(x_t), jnp.asarray(noise),
                                       jnp.asarray(t))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_recon_program_elbo_matches_jax():
    """PLMS with score_elbo, 10-step grid, skip 3, 2 lane groups (the images
    are both_recon_programs' draw, reused for the run without the ELBO)."""
    _, (jt, jmse, _, jelbo_tab), prog, (t, mse, perc, elbo_tab) = both_recon_programs(
        "plms", score_elbo=True)
    np.testing.assert_array_equal(t, np.asarray(jt))
    assert elbo_tab.shape == (len(t), 2) and (elbo_tab > 0).all()
    np.testing.assert_allclose(elbo_tab.numpy(), np.asarray(jelbo_tab), rtol=1e-5, atol=0)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5, atol=0)
    # the ELBO call changes nothing else: the same program without it
    prog.score_elbo = False
    prog.model_evals = 0
    _, mse_off, perc_off = prog(np.random.default_rng(4).uniform(size=(2, 16, 16, 1))
                                .astype(np.float32))
    np.testing.assert_array_equal(mse_off.numpy(), mse.numpy())
    np.testing.assert_array_equal(perc_off.numpy(), perc.numpy())


# port-only invariants (tests/test_elbo.py)

def test_elbo_weights_match_numpy_float64_formula():
    sched = schedules.make_schedule(*SCHED_ARGS)
    betas = sched.betas.numpy().astype(np.float64)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    sigma_sq = betas * (1.0 - acp_prev) / (1.0 - acp)
    want = betas**2 / (2.0 * np.maximum(sigma_sq, 1e-20) * alphas * (1.0 - acp))
    got = elbo.elbo_kl_weights(sched).numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)  # t = 0 is clamped
    assert np.isfinite(got).all()


def test_exact_epsilon_scores_zero_and_worse_scores_higher():
    sched = schedules.make_schedule(*SCHED_ARGS)
    rng = np.random.default_rng(1)
    x0 = T(rng.uniform(size=(3, 8, 8, 1)).astype(np.float32))
    noise, err = (T(rng.standard_normal((3, 8, 8, 1)).astype(np.float32)) for _ in range(2))
    for t in (50, 300, 950):
        tt = torch.full((3,), t)
        x_t = schedules.add_noise(sched, x0, noise, tt)
        np.testing.assert_allclose(
            elbo.elbo_terms_from_model(sched, noise, x_t, noise, tt).numpy(), 0.0, atol=1e-10)
        small = elbo.elbo_terms_from_model(sched, noise + 0.1 * err, x_t, noise, tt)
        large = elbo.elbo_terms_from_model(sched, noise + 0.5 * err, x_t, noise, tt)
        assert (small > 0).all() and (large > small).all()
