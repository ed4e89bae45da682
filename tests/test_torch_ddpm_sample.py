"""The port's DDPM ancestral step and sampler against the JAX package's, on the CPU.

``ddpm_step`` takes its noise as an argument in both packages, so one numpy
draw goes to both. ``ddpm_sample`` draws from a ``torch.Generator``; it is
held against JAX's ``ddpm_step`` driven over the same timesteps with the same
draws, taken again from the same seed.

Tolerance: atol 1e-6 / rtol 1e-5 per step in fp32 (the same elementwise
formulas; XLA may fuse a multiply-add); 1e-5 over the 20-step chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import ddpm as jddpm
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu_torch.diffusion import ddpm, schedules

SCHED_ARGS = ("scaled_linear_beta", 1000, 0.0015, 0.0195)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ptype", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("t", [0, 1, 37, 500, 999])
@pytest.mark.parametrize("clip", [True, False])
def test_ddpm_step_matches_jax(ptype, t, clip):
    rng = np.random.default_rng(t)
    out, x_t, noise = (rng.standard_normal((2, 8, 8, 1)).astype(np.float32) for _ in range(3))
    want = jddpm.ddpm_step(jsched.make_schedule(*SCHED_ARGS, prediction_type=ptype),
                           jnp.asarray(out), jnp.int32(t), jnp.asarray(x_t), jnp.asarray(noise),
                           clip_sample=clip)
    got = ddpm.ddpm_step(schedules.make_schedule(*SCHED_ARGS, prediction_type=ptype),
                         torch.from_numpy(out), t, torch.from_numpy(x_t),
                         torch.from_numpy(noise), clip_sample=clip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_ddpm_sample_is_the_jax_step_chain():
    """All T timesteps from T-1 down to 0, the model called with the batch's
    timestep, and one generator draw per step."""
    sched_t = schedules.make_schedule("linear_beta", 20, 1e-3, 0.2)
    sched_j = jsched.make_schedule("linear_beta", 20, 1e-3, 0.2)
    x_T = torch.randn(3, 1, 4, 4, generator=torch.Generator().manual_seed(0))
    calls = []

    def model_fn(x, t):
        calls.append(t.tolist())
        return 0.3 * x + 0.01 * t[:, None, None, None].float()

    got = ddpm.ddpm_sample(sched_t, model_fn, x_T, torch.Generator().manual_seed(7))
    assert calls == [[t] * 3 for t in range(19, -1, -1)]

    gen = torch.Generator().manual_seed(7)
    x = jnp.asarray(x_T.numpy())
    for t in range(19, -1, -1):
        noise = torch.randn(x_T.shape, generator=gen).numpy()
        out = 0.3 * x + 0.01 * t
        x = jddpm.ddpm_step(sched_j, out, jnp.int32(t), x, jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(x), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ptype", ["epsilon", "sample", "v_prediction"])
def test_training_target_matches_jax(ptype):
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((4, 8, 8, 1)).astype(np.float32) for _ in range(2))
    t = np.array([0, 10, 500, 999], np.int32)
    want = jsched.training_target(jsched.make_schedule(*SCHED_ARGS, prediction_type=ptype),
                                  jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = schedules.training_target(schedules.make_schedule(*SCHED_ARGS, prediction_type=ptype),
                                    torch.from_numpy(x0), torch.from_numpy(noise),
                                    torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
