"""Per-timestep variational-bound (ELBO) terms for likelihood-based OOD scoring.

Port of ``ddpm_ood_tpu/diffusion/elbo.py``. The DDPM objective bounds
-log p(x); its per-timestep KL terms

    L_{t-1} = KL( q(x_{t-1} | x_t, x0)  ||  p_theta(x_{t-1} | x_t) )
            = w_t * ||eps - eps_theta(x_t, t)||^2            (fixed_small)
    w_t     = beta_t^2 / (2 sigma_t^2 alpha_t (1 - acp_t))
    sigma_t^2 = beta_t (1 - acp_{t-1}) / (1 - acp_t)

say how well the model denoises this image at noise level t. ``--score_elbo``
writes them, in bits/dim, as the ``elbo`` column beside ``mse``. Any
prediction type is converted to its implied epsilon first. Everything here
is fp32 (the caller switches autocast off).
"""

from __future__ import annotations

import math

import torch

from .schedules import NoiseSchedule, epsilon_from_model_output

_LN2 = math.log(2.0)


def elbo_kl_weights(sched: NoiseSchedule) -> torch.Tensor:
    """(T,) table of w_t. sigma_t^2 is clamped at 1e-20, which only matters
    at t = 0, where the posterior variance is 0; start points never include
    t = 0."""
    acp = sched.alphas_cumprod
    acp_prev = torch.cat([torch.ones((1,), dtype=acp.dtype, device=acp.device), acp[:-1]])
    sigma_sq = torch.clamp(sched.betas * (1.0 - acp_prev) / (1.0 - acp), min=1e-20)
    return torch.square(sched.betas) / (2.0 * sigma_sq * sched.alphas * (1.0 - acp))


def elbo_terms_from_model(sched: NoiseSchedule, model_output: torch.Tensor, x_t: torch.Tensor,
                          noise: torch.Tensor, t) -> torch.Tensor:
    """KL terms in bits/dim from a raw model output of any prediction type.

    model_output, x_t and noise: (B, *spatial, C); t: a scalar or (B,).
    Returns (B,)."""
    t = torch.as_tensor(t, device=x_t.device)
    eps_pred = epsilon_from_model_output(sched, model_output, x_t, t)
    w = elbo_kl_weights(sched)[t.long()]
    per_img = torch.mean(torch.square(noise - eps_pred), dim=tuple(range(1, noise.dim())))
    return w * per_img / _LN2
