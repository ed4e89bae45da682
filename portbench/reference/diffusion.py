"""The noise schedule, PNDM's PLMS sampler (skip_prk_steps, as diffusers'
``PNDMScheduler.step_plms``) and DPM-Solver++(2M), one trajectory a start
point, and the multi-start-point scoring sweep built from them.

A start point t_s of a grid runs the grid's entries at or below t_s from
x = sqrt(acp[t_s]) x0 + sqrt(1 - acp[t_s]) noise, with a fresh sampler
state. All start points step together (the model is called once a grid
entry on every trajectory that has started), each with its own state.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def scaled_linear_betas(start: float, end: float, n: int = 1000) -> np.ndarray:
    return (np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2).astype(np.float32)


def alphas_cumprod(betas: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.cumprod(1.0 - betas.astype(np.float32),
                                       dtype=np.float64).astype(np.float32))


def plms_grid(n_train: int, n_steps: int) -> np.ndarray:
    """Descending, the second-largest entry twice: [990, 980, 980, ..., 0]."""
    ratio = n_train // n_steps
    ts = np.arange(n_steps) * ratio
    return np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1].astype(np.int64)


def uniform_grid(n_train: int, n_steps: int) -> np.ndarray:
    """Descending, evenly spaced: [975, ..., 0] for 1000 / 25."""
    return (np.arange(n_steps) * (n_train // n_steps))[::-1].astype(np.int64)


def start_points(grid: np.ndarray, skip: int) -> np.ndarray:
    """Ascending start timesteps: the reversed grid from its second entry,
    every `skip`-th."""
    return np.ascontiguousarray(grid[::-1][1::skip])


class PLMS:
    """One trajectory's state: its epsilon history, counter, saved sample."""

    def __init__(self, acp: torch.Tensor, ratio: int):
        self.acp, self.ratio = acp, ratio
        self.ets: List[torch.Tensor] = []
        self.counter = 0
        self.cur = None

    def _alpha(self, t: int) -> torch.Tensor:
        return self.acp[t] if t >= 0 else self.acp[0]

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor) -> torch.Tensor:
        prev = t - self.ratio
        if self.counter != 1:
            self.ets = self.ets[-3:] + [eps]
        else:
            prev, t = t, t + self.ratio
        e = self.ets
        if len(e) == 1 and self.counter == 0:
            out, self.cur = eps, x
        elif len(e) == 1 and self.counter == 1:
            out, x, self.cur = (eps + e[-1]) / 2, self.cur, None
        elif len(e) == 2:
            out = (3 * e[-1] - e[-2]) / 2
        elif len(e) == 3:
            out = (23 * e[-1] - 16 * e[-2] + 5 * e[-3]) / 12
        else:
            out = (55 * e[-1] - 59 * e[-2] + 37 * e[-3] - 9 * e[-4]) / 24
        self.counter += 1
        a_t, a_prev = self._alpha(t), self._alpha(prev)
        b_t, b_prev = 1 - a_t, 1 - a_prev
        coeff = (a_prev / a_t) ** 0.5
        denom = a_t * b_prev ** 0.5 + (a_t * b_t * a_prev) ** 0.5
        return coeff * x - (a_prev - a_t) * out / denom


class DPMSolver2M:
    """DPM-Solver++(2M), data prediction: first order at a trajectory's first
    step and at the last (to t < 0, where acp is 1)."""

    def __init__(self, acp: torch.Tensor, ratio: int):
        self.acp, self.ratio = acp, ratio
        self.prev_x0 = None

    def _a_s(self, t: int):
        a = self.acp[t] if t >= 0 else torch.ones((), dtype=self.acp.dtype,
                                                   device=self.acp.device)
        return a.sqrt(), (1 - a).sqrt()

    def _lam(self, t: int):
        a, s = self._a_s(t)
        return torch.log(a) - torch.log(torch.clamp(s, min=1e-20))

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor) -> torch.Tensor:
        u = t - self.ratio
        a_t, s_t = self._a_s(t)
        a_u, s_u = self._a_s(u)
        x0 = (x - s_t * eps) / a_t
        d = x0
        if self.prev_x0 is not None and u >= 0:
            h = self._lam(u) - self._lam(t)
            r = (self._lam(t) - self._lam(t + self.ratio)) / h
            d = (1 + 1 / (2 * r)) * x0 - 1 / (2 * r) * self.prev_x0
        self.prev_x0 = x0
        exp_neg_h = (a_t * s_u) / (s_t * a_u)
        return (s_u / s_t) * x - a_u * (exp_neg_h - 1) * d


SAMPLERS = {"plms": (PLMS, plms_grid), "dpm": (DPMSolver2M, uniform_grid)}


def sweep(model: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], acp: torch.Tensor,
          x0: torch.Tensor, noise: torch.Tensor, sampler: str, n_steps: int, skip: int,
          b_scale: float = 1.0) -> torch.Tensor:
    """Reconstructions (K, B, ...) of x0 (B, ...) from every start point,
    the k-th from noise[k]. `model(x (N, ...), t (N,))` returns epsilon."""
    cls, grid_fn = SAMPLERS[sampler]
    grid = grid_fn(len(acp), n_steps)
    starts = start_points(grid, skip)
    ratio = len(acp) // n_steps
    b = x0.shape[0]
    xs, states = [], []
    for k, s in enumerate(starts):
        a = acp[int(s)]
        xs.append(a.sqrt() * (x0 * b_scale) + (1 - a).sqrt() * noise[k])
        states.append(cls(acp, ratio))
    for t in grid:
        live = [k for k, s in enumerate(starts) if t <= s]
        if not live:
            continue
        x = torch.cat([xs[k] for k in live])
        eps = model(x, torch.full((x.shape[0],), int(t), dtype=torch.long, device=x.device))
        for i, k in enumerate(live):
            xs[k] = states[k].step(eps[i * b:(i + 1) * b], int(t), xs[k])
    return torch.stack(xs)


def lane_steps(sampler: str, n_train: int, n_steps: int, skip: int) -> List[int]:
    """The model calls each start point's own trajectory makes."""
    _, grid_fn = SAMPLERS[sampler]
    grid = grid_fn(n_train, n_steps)
    return [int((grid <= s).sum()) for s in start_points(grid, skip)]
