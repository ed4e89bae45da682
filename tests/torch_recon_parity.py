"""Shared inputs of the sampler parity tests (tests/test_torch_ddim.py,
test_torch_dpm.py, test_torch_elbo.py and test_torch_plms_ref.py): a linear
UNet stand-in written in both frameworks, and one scoring program of each
package on the same tiny UNet weights, images and noise.

The weights are seeded JAX params carried into the port by
``utils/convert.py``; the images and the (K, B, 16, 16, 1) noise are drawn
with numpy from seeds and handed to both programs. Both run fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch.diffusion import schedules
from ddpm_ood_tpu_torch.models.unet import make_unet
from ddpm_ood_tpu_torch.recon import sweep
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_unet import seeded_jax_params

SCHED_ARGS = ("scaled_linear_beta", 1000, 0.0015, 0.0195)


def linear_model_jax(x, t):
    """eps_hat = 0.05 x + 0.02 t / 1000, for samples of any rank."""
    return 0.05 * x + 0.02 * (t.astype(jnp.float32) / 1000.0).reshape((-1,) + (1,) * (x.ndim - 1))


def linear_model_torch(x, t):
    return 0.05 * x + 0.02 * (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))


def both_recon_programs(sampler: str, score_elbo: bool = False, steps: int = 10,
                        skip: int = 3, groups: int = 2, seed: int = 3):
    """Runs the JAX and the port ReconProgram on one batch of 2 images;
    returns (jax program, its outputs, port program, its outputs)."""
    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=seed)
    images = np.random.default_rng(seed + 1).uniform(size=(2, 16, 16, 1)).astype(np.float32)

    def host_noise(shape, t_starts):
        return np.random.default_rng(seed + 2).standard_normal(shape).astype(np.float32)

    common = dict(num_inference_steps=steps, inference_skip_factor=skip, num_groups=groups,
                  sampler=sampler, score_elbo=score_elbo, host_noise_fn=host_noise)
    jprog = jsweep.ReconProgram(
        sched=jsched.make_schedule(*SCHED_ARGS),
        model_fn=jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t), params),
        latent_sample_shape=(16, 16, 1), overlap_host_noise=False, **common)
    jout = jprog(jnp.asarray(images), jax.random.PRNGKey(0))

    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    prog = sweep.ReconProgram(
        sched=schedules.make_schedule(*SCHED_ARGS),
        model_fn=model.to(memory_format=torch.channels_last).eval(), **common)
    return jprog, jout, prog, prog(images)
