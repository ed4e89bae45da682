"""DPM-Solver++(2M): second-order multistep ODE sampler (arXiv:2211.01095).

Port of ``ddpm_ood_tpu/diffusion/dpm_solver.py`` (``DPMState``,
``dpm_init_state``, ``_alpha_sigma``, ``_lambda``, ``dpm_step``,
``dpm_timesteps``, ``dpm_denoise``), in the data-prediction (x0) form:

    alpha_t = sqrt(acp_t), sigma_t = sqrt(1 - acp_t), lambda_t = log(alpha/sigma)
    step s -> u (u < s in time), h = lambda_u - lambda_s:
      first order : x_u = (sigma_u/sigma_s) x_s - alpha_u (e^{-h} - 1) x0(x_s, s)
      2M          : the same with x0 replaced by
                    D = (1 + 1/(2r)) x0_s - 1/(2r) x0_prev,  r = h_prev / h
    e^{-h} = (alpha_s sigma_u) / (sigma_s alpha_u), finite at sigma_u = 0.

The final update (u < 0, to the clean sample) is first order, which there
reduces to x = x0(x_s, s). The JAX sweep vmaps ``dpm_step`` over lanes with
a scalar ``has_prev`` each; here the state carries a leading (K,) lane axis,
``has_prev`` is a (K,) bool tensor, and ``active`` (K,) gates ``x``,
``prev_x0`` and ``has_prev`` alike. Timesteps past either end of the table
are clamped before the read, and t < 0 reads acp = 1, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .ddim import ddim_timesteps
from .schedules import NoiseSchedule, active_suffix, lanes, pred_x0_from_model_output


@dataclasses.dataclass
class DPMState:
    """Lane-batched multistep carry: x and prev_x0 (K, *sample), has_prev (K,) bool."""

    x: torch.Tensor        # current sample
    prev_x0: torch.Tensor  # x0 prediction from the lane's previous active step
    has_prev: torch.Tensor  # the lane took at least one step


def dpm_init_state(x_start: torch.Tensor) -> DPMState:
    """Fresh state for K lanes; x_start is (K, *sample)."""
    return DPMState(x=x_start, prev_x0=torch.zeros_like(x_start),
                    has_prev=torch.zeros((x_start.shape[0],), dtype=torch.bool,
                                         device=x_start.device))


def _alpha_sigma(sched: NoiseSchedule, t: torch.Tensor):
    acp_table = sched.alphas_cumprod
    t = torch.as_tensor(t, device=acp_table.device)
    acp = acp_table[t.clamp(0, sched.num_train_timesteps - 1).long()]
    acp = torch.where(t >= 0, acp, torch.ones((), dtype=acp.dtype, device=acp.device))
    return torch.sqrt(acp), torch.sqrt(1.0 - acp)


def _lambda(sched: NoiseSchedule, t: torch.Tensor) -> torch.Tensor:
    a, s = _alpha_sigma(sched, t)
    return torch.log(a) - torch.log(torch.clamp(s, min=1e-20))


def dpm_step(sched: NoiseSchedule, state: DPMState, model_output: torch.Tensor,
             t: torch.Tensor, t_next: torch.Tensor, t_prev_eval: torch.Tensor,
             active: torch.Tensor) -> DPMState:
    """One masked multistep update of every lane: the model was evaluated at
    `t`, each lane advances to `t_next`; `t_prev_eval` (t + grid step) is
    where its previous evaluation happened, for r = h_prev / h. The
    timesteps are 0-dim or (K,); lanes whose `active` (K,) is False pass
    through untouched."""
    n = state.x.dim()
    a_s, s_s = _alpha_sigma(sched, t)
    a_u, s_u = _alpha_sigma(sched, t_next)
    x0 = pred_x0_from_model_output(sched, model_output, state.x, t)

    exp_neg_h = (a_s * s_u) / (s_s * a_u)
    ratio = lanes(s_u / s_s, n)
    step = lanes(a_u * (exp_neg_h - 1.0), n)
    first_order = ratio * state.x - step * x0

    h = _lambda(sched, t_next) - _lambda(sched, t)
    h_prev = _lambda(sched, t) - _lambda(sched, t_prev_eval)
    r = h_prev / torch.clamp(h, min=1e-20)
    coef = lanes(1.0 / (2.0 * torch.clamp(r, min=1e-20)), n)
    d = (1.0 + coef) * x0 - coef * state.prev_x0
    second_order = ratio * state.x - step * d

    t_next = torch.as_tensor(t_next, device=state.has_prev.device)
    use_second = torch.logical_and(state.has_prev, t_next >= 0)
    new_x = torch.where(lanes(use_second, n), second_order, first_order)

    act = lanes(active, n)
    return DPMState(
        x=torch.where(act, new_x, state.x),
        prev_x0=torch.where(act, x0, state.prev_x0),
        has_prev=torch.logical_or(state.has_prev, active),
    )


def dpm_timesteps(num_train_timesteps: int = 1000, num_inference_steps: int = 100) -> np.ndarray:
    """Descending uniform grid, the DDIM grid: one model evaluation per entry."""
    return ddim_timesteps(num_train_timesteps, num_inference_steps)


def dpm_denoise(sched: NoiseSchedule,
                model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                x_start: torch.Tensor, timesteps_desc, t_start,
                num_inference_steps: int) -> torch.Tensor:
    """Denoise x_start (B, ...) from t_start over the grid entries at or
    below it (``plms.plms_denoise``'s contract): the B samples ride the lane
    axis, and the first step is first order."""
    step_ratio = sched.num_train_timesteps // num_inference_steps
    b = x_start.shape[0]
    state = dpm_init_state(x_start)
    active = torch.ones((b,), dtype=torch.bool, device=x_start.device)
    for t in active_suffix(timesteps_desc, t_start, x_start.device):
        state = dpm_step(sched, state, model_fn(state.x, t.expand(b)), t, t - step_ratio,
                         t + step_ratio, active)
    return state.x
