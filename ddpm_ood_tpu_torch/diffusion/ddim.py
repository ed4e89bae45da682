"""DDIM sampler (arXiv:2010.02502): one UNet call per step, no history.

Port of ``ddpm_ood_tpu/diffusion/ddim.py`` (``ddim_step``,
``ddim_timesteps``, ``ddim_denoise``):

    x_{t_prev} = sqrt(acp_prev) * x0_pred
               + sqrt(1 - acp_prev - sigma^2) * eps_pred
               + sigma * noise
    sigma = eta * sqrt((1-acp_prev)/(1-acp_t)) * sqrt(1 - acp_t/acp_prev)

``t`` and ``t_prev`` may be 0-dim or per-lane (K,) int tensors; a lane
whose ``t_prev`` is below 0 steps to the clean sample (acp_prev = 1). Every
table read is clamped into [0, T - 1] first, as the JAX gather clamps.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedules import (NoiseSchedule, active_suffix, epsilon_from_model_output, lanes,
                        pred_x0_from_model_output)


def ddim_step(sched: NoiseSchedule, model_output: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor, x_t: torch.Tensor, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DDIM update x_t -> x_{t_prev}; t_prev < 0 means "to x_0"."""
    acp = sched.alphas_cumprod
    last = sched.num_train_timesteps - 1
    t = torch.as_tensor(t, device=acp.device)
    t_prev = torch.as_tensor(t_prev, device=acp.device)
    acp_t = acp[t.clamp(0, last).long()]
    acp_prev = torch.where(t_prev >= 0, acp[t_prev.clamp(0, last).long()],
                           torch.ones((), dtype=acp.dtype, device=acp.device))
    x0 = pred_x0_from_model_output(sched, model_output, x_t, t)
    eps = epsilon_from_model_output(sched, model_output, x_t, t)
    if eta > 0.0:
        sigma = (eta * torch.sqrt((1.0 - acp_prev) / (1.0 - acp_t))
                 * torch.sqrt(1.0 - acp_t / acp_prev))
    else:
        sigma = torch.zeros_like(acp_prev)
    n = x_t.dim()
    dir_xt = lanes(torch.sqrt(torch.clamp(1.0 - acp_prev - sigma**2, min=0.0)), n) * eps
    out = lanes(torch.sqrt(acp_prev), n) * x0 + dir_xt
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        out = out + lanes(sigma, n) * noise
    return out


def ddim_timesteps(num_train_timesteps: int = 1000, num_inference_steps: int = 100) -> np.ndarray:
    """Descending evenly spaced grid, no duplicate entry ([900, ..., 0] for 1000/10)."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int32)
    return ts[::-1].copy()


def ddim_denoise(sched: NoiseSchedule,
                 model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 x_start: torch.Tensor, timesteps_desc, t_start, num_inference_steps: int,
                 eta: float = 0.0) -> torch.Tensor:
    """Denoise x_start (B, ...) from t_start over the grid entries at or
    below it (``plms.plms_denoise``'s contract); eta > 0 needs noise, which
    this form does not draw, so ``ddim_step`` raises."""
    step_ratio = sched.num_train_timesteps // num_inference_steps
    b = x_start.shape[0]
    x = x_start
    for t in active_suffix(timesteps_desc, t_start, x_start.device):
        x = ddim_step(sched, model_fn(x, t.expand(b)), t, t - step_ratio, x, eta=eta)
    return x
