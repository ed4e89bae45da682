"""PNDM/PLMS sampler with per-lane state (pure PLMS, skip_prk_steps=True).

Port of ``ddpm_ood_tpu/diffusion/plms.py`` minus the carried-history
``plms_reference_exact_sweep``. Every trajectory ("lane") keeps its own
epsilon history and warm-up counter. The JAX sweep vmaps ``plms_step`` over
lanes, and its ``lax.switch`` then branches on each lane's own counter,
because lanes join the grid at different timesteps. Here the lane dimension
is written out: the state holds a leading (K,) lane axis, and the order of
each lane's step (Euler, the Heun re-do, or Adams-Bashforth 2/3/4) is picked
per lane from a coefficient table indexed by its counter, then applied with
``torch.where``. No step synchronises with the host.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .schedules import NoiseSchedule, epsilon_from_model_output


def pndm_timesteps(num_train_timesteps: int = 1000, num_inference_steps: int = 100) -> np.ndarray:
    """Descending PLMS grid with the second-largest entry duplicated
    (101 entries for 1000/100: [990, 980, 980, 970, ..., 10, 0])."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
    plms = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
    return plms.astype(np.int32)


def pndm_start_points(timesteps_desc: np.ndarray, inference_skip_factor: int = 1) -> np.ndarray:
    """Reconstruction start timesteps: reversed(timesteps)[1::skip_factor], ascending."""
    return np.ascontiguousarray(timesteps_desc[::-1][1::inference_skip_factor])


# Per-order rows over the post-push history [e_{k-3}, e_{k-2}, e_{k-1}, e_k]
# (oldest to newest), indexed by clamp(counter, 0, 4):
#   0 Euler: e_k;  1 Heun re-do: (e_k + e_{k-1}) / 2 (e_{k-1} is the previous
#   step's epsilon);  2-4 Adams-Bashforth of that order.
_COEFFS = np.array([
    (0.0, 0.0, 0.0, 1.0),
    (0.0, 0.0, 0.5, 0.5),
    (0.0, 0.0, -1.0 / 2.0, 3.0 / 2.0),
    (0.0, 5.0 / 12.0, -16.0 / 12.0, 23.0 / 12.0),
    (-9.0 / 24.0, 37.0 / 24.0, -59.0 / 24.0, 55.0 / 24.0),
], dtype=np.float32)


@functools.cache
def _coeff_table(device: torch.device) -> torch.Tensor:
    """The (5, 4) table on `device`, copied there once."""
    return torch.as_tensor(_COEFFS, device=device)


@dataclasses.dataclass
class PLMSState:
    """Lane-batched PLMS state: x (K, *sample), ets (K, 4, *sample) with
    index 3 newest, counter (K,) int32, cur_sample (K, *sample) -- the start
    sample saved for the counter == 1 re-do."""

    x: torch.Tensor
    ets: torch.Tensor
    counter: torch.Tensor
    cur_sample: torch.Tensor


def plms_init_state(x_start: torch.Tensor) -> PLMSState:
    """Fresh state for K lanes; x_start is (K, *sample)."""
    k = x_start.shape[0]
    return PLMSState(
        x=x_start,
        ets=torch.zeros((k, 4) + tuple(x_start.shape[1:]), dtype=x_start.dtype,
                        device=x_start.device),
        counter=torch.zeros((k,), dtype=torch.int32, device=x_start.device),
        cur_sample=torch.zeros_like(x_start),
    )


def _lanes(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(K,) -> (K, 1, ..., 1) broadcastable against a rank-`ndim` lane tensor."""
    return v.reshape(v.shape + (1,) * (ndim - v.dim()))


def _transfer(sched: NoiseSchedule, sample: torch.Tensor, timestep: torch.Tensor,
              prev_timestep: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """PNDM eq. 11 transfer x_t -> x_{t_prev}; timesteps are per lane (K,)."""
    acp = sched.alphas_cumprod
    last = sched.num_train_timesteps - 1
    acp_t = acp[timestep.clamp(0, last).long()]
    acp_prev = torch.where(prev_timestep >= 0, acp[prev_timestep.clamp(0, last).long()],
                           acp[0])  # set_alpha_to_one=False
    bp_t = 1.0 - acp_t
    bp_prev = 1.0 - acp_prev
    sample_coeff = torch.sqrt(acp_prev / acp_t)
    denom = acp_t * torch.sqrt(bp_prev) + torch.sqrt(acp_t * bp_t * acp_prev)
    n = sample.dim()
    return (_lanes(sample_coeff, n) * sample
            - _lanes(acp_prev - acp_t, n) * eps / _lanes(denom, n))


def plms_step(sched: NoiseSchedule, state: PLMSState, model_output: torch.Tensor,
              t: torch.Tensor, step_ratio: int, active: torch.Tensor) -> PLMSState:
    """One PLMS update for every lane at grid timestep `t` (a 0-dim int
    tensor). Lanes with `active` False (K,) pass through unchanged, which is
    how trajectories of different lengths share one loop."""
    n = state.x.dim()
    eps = epsilon_from_model_output(sched, model_output, state.x, t)
    pushed = torch.cat([state.ets[:, 1:], eps[:, None]], dim=1)
    order = state.counter.clamp(0, 4).long()
    coeffs = _coeff_table(eps.device)[order].to(eps.dtype)  # (K, 4)
    c = [_lanes(coeffs[:, i], n) for i in range(4)]
    # newest first, the summation order of the JAX step
    out = c[3] * pushed[:, 3] + c[2] * pushed[:, 2] + c[1] * pushed[:, 1] + c[0] * pushed[:, 0]

    heun = _lanes(order == 1, n)
    first = _lanes(order == 0, n)
    sample = torch.where(heun, state.cur_sample, state.x)
    t_lane = t.to(torch.int32).expand(order.shape)
    t_used = torch.where(order == 1, t_lane + step_ratio, t_lane)
    t_prev = torch.where(order == 1, t_lane, t_lane - step_ratio)
    new_x = _transfer(sched, sample, t_used, t_prev, out)
    new_ets = torch.where(heun.unsqueeze(1), state.ets, pushed)  # the re-do does not push
    new_cur = torch.where(first, state.x, state.cur_sample)

    act = _lanes(active, n)
    return PLMSState(
        x=torch.where(act, new_x, state.x),
        ets=torch.where(act.unsqueeze(1), new_ets, state.ets),
        counter=torch.where(active, state.counter + 1, state.counter),
        cur_sample=torch.where(act, new_cur, state.cur_sample),
    )
