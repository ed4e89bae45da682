"""DDPM ancestral sampler (validation sample grids).

Port of ``ddpm_ood_tpu/diffusion/ddpm.py``: monai-generative's
``DDPMScheduler.step`` (variance_type="fixed_small", clip_sample=True)
driven over all T timesteps. The JAX package runs the loop as one
``lax.scan``; here it is a Python loop of eager launches with the timestep
as a host integer, so no step waits for the device. Noise comes from an
explicit ``torch.Generator``; ``ddpm_step`` takes it as an argument, as in
JAX, so tests can feed both packages one draw.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .schedules import NoiseSchedule, pred_x0_from_model_output


def ddpm_step(sched: NoiseSchedule, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
              noise: torch.Tensor, clip_sample: bool = True) -> torch.Tensor:
    """One ancestral posterior sample x_{t-1} ~ q(x_{t-1} | x_t, pred_x0).

    `t` is one timestep for the whole batch; `noise` a fresh standard normal
    of x_t's shape (unused at t = 0)."""
    t = int(t)
    acp = sched.alphas_cumprod
    acp_t = acp[t]
    acp_prev = acp[t - 1] if t > 0 else torch.ones((), dtype=acp.dtype, device=acp.device)
    beta_t = sched.betas[t]

    x0 = pred_x0_from_model_output(sched, model_output, x_t, t)
    if clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    coef_x0 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = torch.sqrt(sched.alphas[t]) * (1.0 - acp_prev) / (1.0 - acp_t)
    mean = coef_x0 * x0 + coef_xt * x_t
    if t == 0:
        return mean
    variance = torch.clamp((1.0 - acp_prev) / (1.0 - acp_t) * beta_t, min=1e-20)
    return mean + torch.sqrt(variance) * noise


def ddpm_sample(sched: NoiseSchedule, model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                input_noise: torch.Tensor, generator: Optional[torch.Generator] = None,
                clip_sample: bool = True) -> torch.Tensor:
    """x_T = input_noise -> x_0 over all T timesteps. `model_fn(x, t_batch)`
    maps (B, ...) samples and (B,) int timesteps to the model output."""
    x = input_noise
    batch = x.shape[0]
    for t in range(sched.num_train_timesteps - 1, -1, -1):
        t_batch = torch.full((batch,), t, dtype=torch.long, device=x.device)
        model_output = model_fn(x, t_batch)
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = ddpm_step(sched, model_output, t, x, noise, clip_sample=clip_sample)
    return x
