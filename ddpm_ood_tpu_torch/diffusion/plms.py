"""PNDM/PLMS sampler with per-lane state (pure PLMS, skip_prk_steps=True).

Port of ``ddpm_ood_tpu/diffusion/plms.py``. Every trajectory ("lane") of
the scoring sweep keeps its own epsilon history and warm-up counter. The
JAX sweep vmaps ``plms_step`` over lanes, and its ``lax.switch`` then
branches on each lane's own counter, because lanes join the grid at
different timesteps. Here the lane dimension is written out: the state
holds a leading (K,) lane axis, and the order of each lane's step (Euler,
the Heun re-do, or Adams-Bashforth 2/3/4) is picked per lane from a
coefficient table indexed by its counter, then applied with
``torch.where``. No step synchronises with the host.

``plms_reference_exact_sweep`` is the other semantics, the reference
pipeline's own: one scheduler per batch whose history and counter carry
over from one start point's trajectory to the next (``sampler="plms_ref"``,
the parity path). Every decision of that chain is fixed by the grid, so a
host-side step table (``_build_ref_exact_step_table``) drives one eager
loop with one UNet call of batch B per row.

``plms_denoise`` is one trajectory (the sample CLI's): the batch rides the
lane axis, every lane with the same counter.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from .schedules import (NoiseSchedule, active_suffix, add_noise,
                        epsilon_from_model_output, lanes)


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
    return (lanes(sample_coeff, n) * sample
            - lanes(acp_prev - acp_t, n) * eps / lanes(denom, n))


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
    c = [lanes(coeffs[:, i], n) for i in range(4)]
    # newest first, the summation order of the JAX step
    out = c[3] * pushed[:, 3] + c[2] * pushed[:, 2] + c[1] * pushed[:, 1] + c[0] * pushed[:, 0]

    heun = lanes(order == 1, n)
    first = lanes(order == 0, n)
    sample = torch.where(heun, state.cur_sample, state.x)
    t_lane = t.to(torch.int32).expand(order.shape)
    t_used = torch.where(order == 1, t_lane + step_ratio, t_lane)
    t_prev = torch.where(order == 1, t_lane, t_lane - step_ratio)
    new_x = _transfer(sched, sample, t_used, t_prev, out)
    new_ets = torch.where(heun.unsqueeze(1), state.ets, pushed)  # the re-do does not push
    new_cur = torch.where(first, state.x, state.cur_sample)

    act = lanes(active, n)
    return PLMSState(
        x=torch.where(act, new_x, state.x),
        ets=torch.where(act.unsqueeze(1), new_ets, state.ets),
        counter=torch.where(active, state.counter + 1, state.counter),
        cur_sample=torch.where(act, new_cur, state.cur_sample),
    )


def plms_denoise(sched: NoiseSchedule,
                 model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 x_start: torch.Tensor, timesteps_desc, t_start,
                 num_inference_steps: int) -> torch.Tensor:
    """Denoise x_start (B, ...), noised to t_start, over the grid entries at
    or below t_start with a fresh PLMS history: the reference's inner loop
    (src/trainers/reconstruct.py:149-157) for one start point.
    `model_fn(x, t (B,))` maps x's layout to the model output in it."""
    step_ratio = sched.num_train_timesteps // num_inference_steps
    b = x_start.shape[0]
    state = plms_init_state(x_start)  # the B samples as B lanes of one counter
    active = torch.ones((b,), dtype=torch.bool, device=x_start.device)
    for t in active_suffix(timesteps_desc, t_start, x_start.device):
        state = plms_step(sched, state, model_fn(state.x, t.expand(b)), t, step_ratio, active)
    return state.x


def _build_ref_exact_step_table(timesteps_desc: np.ndarray, t_starts: np.ndarray,
                                step_ratio: int) -> dict:
    """Host-side step table of the carried-history sweep, one row per UNet
    call over the lanes' concatenated segments (the grid suffix at or below
    each ascending start point).

    The history length and the global counter evolve the same way for every
    batch, so each row's choices are known up front: the coefficients over
    the post-push history ``pushed = [ets[1:], eps]`` (oldest to newest;
    Euler (0,0,0,1), the counter == 1 Heun re-do (0,0,1/2,1/2), AB2
    (0,0,-1/2,3/2), AB3 (0,5,-16,23)/12, AB4 (-9,37,-59,55)/24), whether eps
    is appended, whether the re-do restarts from the saved sample or the
    sample is saved, the (t_used, t_prev) transfer pair, and each segment's
    first and last rows."""
    ts_desc = np.asarray(timesteps_desc)
    cols = {k: [] for k in ("lane", "t", "t_used", "t_prev", "coeffs",
                            "append", "use_cur", "save_cur", "first", "last")}
    counter = 0
    n_ets = 0
    ab = {
        2: (0.0, 0.0, -1.0 / 2.0, 3.0 / 2.0),
        3: (0.0, 5.0 / 12.0, -16.0 / 12.0, 23.0 / 12.0),
        4: (-9.0 / 24.0, 37.0 / 24.0, -59.0 / 24.0, 55.0 / 24.0),
    }
    for k, t_start in enumerate(np.asarray(t_starts)):
        seg = [int(t) for t in ts_desc[ts_desc <= t_start]]
        for j, t in enumerate(seg):
            if counter == 0:
                n_ets = 1
                row = ((0.0, 0.0, 0.0, 1.0), True, False, True, t, t - step_ratio)
            elif counter == 1:
                row = ((0.0, 0.0, 0.5, 0.5), False, True, False, t + step_ratio, t)
            else:
                n_ets = min(n_ets + 1, 4)
                row = (ab[n_ets], True, False, False, t, t - step_ratio)
            coeffs, append, use_cur, save_cur, t_used, t_prev = row
            for name, value in (("lane", k), ("t", t), ("first", j == 0),
                                ("last", j == len(seg) - 1), ("coeffs", coeffs),
                                ("append", append), ("use_cur", use_cur),
                                ("save_cur", save_cur), ("t_used", t_used),
                                ("t_prev", t_prev)):
                cols[name].append(value)
            counter += 1
    ints = ("lane", "t", "t_used", "t_prev")
    return {k: (np.asarray(v, np.int32) if k in ints
                else np.asarray(v, np.float32) if k == "coeffs" else np.asarray(v))
            for k, v in cols.items()}


def plms_reference_exact_sweep(sched: NoiseSchedule,
                               model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                               x0: torch.Tensor, noise: torch.Tensor,
                               timesteps_desc: np.ndarray, t_starts: np.ndarray,
                               num_inference_steps: int, b_scale: float = 1.0) -> torch.Tensor:
    """Multi-start-point sweep with the reference's carried-history semantics.

    The reference loops its start points in ascending order through one
    PNDM scheduler per batch, so the epsilon history and step counter leak
    from one trajectory into the next: every trajectory after the first
    starts at the Adams-Bashforth order the previous one ended at, fed by its
    epsilons. This reproduces that, sequentially: one
    ``model_fn(x (B, *spatial, C), t (B,))`` call per row of the step table.
    Decisions come from the host table, so no step waits for the device.

    x0: (B, *spatial, C); noise: (K, B, *spatial, C); t_starts ascending.
    Returns the (K, B, *spatial, C) reconstructions (still b_scaled)."""
    step_ratio = sched.num_train_timesteps // num_inference_steps
    steps = _build_ref_exact_step_table(timesteps_desc, t_starts, step_ratio)
    device = x0.device
    starts = torch.as_tensor(np.asarray(t_starts, np.int32), device=device)
    x_starts = add_noise(sched, (x0 * b_scale)[None], noise, starts)  # (K, B, ...)
    zeros = torch.zeros_like(x0)
    x, cur, ets = zeros, zeros, [zeros] * 4
    recons = [None] * len(starts)
    t_all = torch.as_tensor(steps["t"], device=device)
    t_used_all = torch.as_tensor(steps["t_used"], device=device)
    t_prev_all = torch.as_tensor(steps["t_prev"], device=device)
    for i, lane in enumerate(steps["lane"].tolist()):
        if steps["first"][i]:
            x = x_starts[lane]
        t = t_all[i]
        eps = epsilon_from_model_output(sched, model_fn(x, t.expand(x.shape[0])), x, t)
        pushed = ets[1:] + [eps]
        c = steps["coeffs"][i].tolist()
        # newest first, the order of the JAX eager form's sums
        out = c[3] * pushed[3] + c[2] * pushed[2] + c[1] * pushed[1] + c[0] * pushed[0]
        sample = cur if steps["use_cur"][i] else x
        new_x = _transfer(sched, sample, t_used_all[i], t_prev_all[i], out)
        if steps["append"][i]:
            ets = pushed
        if steps["save_cur"][i]:
            cur = x
        x = new_x
        if steps["last"][i]:
            recons[lane] = x
    return torch.stack(recons)
