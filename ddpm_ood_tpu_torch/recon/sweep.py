"""Batched multi-start-point PLMS reconstruction sweep: the scoring hot path.

Port of ``ddpm_ood_tpu/recon/sweep.py`` (``plms_sweep``, ``group_t_starts``
and ``ReconProgram`` for ``sampler="plms"``). All K start points ("lanes") of
a lane group move down one descending PLMS grid together; a lane joins once
the grid reaches its start timestep (``t <= t_start``). Every grid step calls
the UNet once on the flattened (K*B) batch. The JAX package compiles each
group into one ``lax.scan``; here each group is a Python loop of eager
launches whose per-step state stays on the device, so no step waits for
the host.

Public edges keep the JAX layout, images and noise as (B, *spatial, C) and
(K, B, *spatial, C); the UNet itself takes (N, C, *spatial) in channels_last,
which is a free permute of the same memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..diffusion.plms import plms_init_state, plms_step, pndm_start_points, pndm_timesteps
from ..diffusion.schedules import NoiseSchedule, add_noise

# model_fn(x (N, C, *spatial), t (N,) int) -> fp32 (N, C, *spatial)
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _lane_major_to_model(x: torch.Tensor) -> torch.Tensor:
    """(K, B, *spatial, C) -> (K*B, C, *spatial), a view."""
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    nd = flat.dim()
    return flat.permute((0, nd - 1) + tuple(range(1, nd - 1)))


def _model_to_lane_major(y: torch.Tensor, k: int) -> torch.Tensor:
    """(K*B, C, *spatial) -> (K, B, *spatial, C); contiguous input for
    channels_last model outputs, so a view."""
    nd = y.dim()
    y = y.permute((0,) + tuple(range(2, nd)) + (1,))
    return y.reshape((k, -1) + tuple(y.shape[1:]))


def plms_sweep(
    sched: NoiseSchedule,
    model_fn: ModelFn,
    x0: torch.Tensor,
    noise: torch.Tensor,
    timesteps_desc: torch.Tensor,
    t_starts: torch.Tensor,
    num_inference_steps: int,
    b_scale: float = 1.0,
) -> torch.Tensor:
    """Denoise `x0` (B, *spatial, C) from K start points in one loop.

    noise: (K, B, *spatial, C) fresh noise per lane; timesteps_desc and
    t_starts (K,) ascending are int tensors on x0's device. Returns the
    (K, B, *spatial, C) reconstructions (still b_scaled)."""
    k = t_starts.shape[0]
    step_ratio = sched.num_train_timesteps // num_inference_steps
    x_start = add_noise(sched, (x0 * b_scale)[None], noise, t_starts)  # (K, B, ...)
    state = plms_init_state(x_start)
    n_imgs = k * x0.shape[0]
    for t in timesteps_desc:
        out = model_fn(_lane_major_to_model(state.x), t.expand(n_imgs))
        state = plms_step(sched, state, _model_to_lane_major(out, k), t, step_ratio,
                          active=t <= t_starts)
    return state.x


def group_t_starts(timesteps_desc: np.ndarray, t_starts: np.ndarray,
                   num_groups: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split ascending t_starts into contiguous groups, each with the
    descending timestep suffix it needs."""
    num_groups = max(1, min(num_groups, len(t_starts)))
    out = []
    for chunk in np.array_split(np.asarray(t_starts), num_groups):
        if len(chunk) == 0:
            continue
        suffix = timesteps_desc[timesteps_desc <= int(chunk.max())]
        out.append((suffix.astype(np.int32), chunk.astype(np.int32)))
    return out


@dataclasses.dataclass
class ReconProgram:
    """Scoring program: noise -> PLMS sweep per lane group -> metrics.

    ``__call__(images, generator)`` maps one batch (B, *spatial, C) in [0, 1]
    to (t_starts (K,), mse (K, B), perceptual (K, B)); the highest-start
    lane's reconstructions of up to 8 images are kept on ``last_preview``.
    ``model_evals`` counts the UNet forwards made."""

    sched: NoiseSchedule
    model_fn: ModelFn
    device: torch.device = torch.device("cpu")
    num_inference_steps: int = 100
    inference_skip_factor: int = 1
    b_scale: float = 1.0
    num_groups: int = 8
    # the trainer passes bf16 on CUDA (fp32 params, bf16 compute); the whole
    # call runs under one autocast region, so each weight is cast once per
    # call rather than once per UNet forward. None computes in fp32.
    autocast_dtype: Optional[torch.dtype] = None
    # host_noise_fn((K, B, *latent), t_starts) -> np.ndarray replaces the
    # generator's Gaussian draw; tests use it to feed both packages one draw
    host_noise_fn: Optional[Callable] = None

    def __post_init__(self):
        self.timesteps_desc = pndm_timesteps(self.sched.num_train_timesteps,
                                             self.num_inference_steps)
        self.t_starts = pndm_start_points(self.timesteps_desc, self.inference_skip_factor)
        self._groups = [
            (torch.as_tensor(ts, device=self.device), torch.as_tensor(st, device=self.device))
            for ts, st in group_t_starts(self.timesteps_desc, self.t_starts, self.num_groups)
        ]
        self.model_evals = 0
        self.last_preview = None

    def _model(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        self.model_evals += 1
        return self.model_fn(x, t)

    def _noise(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.host_noise_fn is not None:
            arr = np.asarray(self.host_noise_fn(shape, self.t_starts), dtype=np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(f"host noise shape {arr.shape} != expected {tuple(shape)}")
            return torch.from_numpy(arr).to(self.device)
        return torch.randn(shape, generator=generator, device=self.device)

    def _score(self, images: torch.Tensor, recon: torch.Tensor):
        """/b_scale, clamp to [0, 1], per-(lane, image) MSE, preview. LPIPS is
        not ported: the perceptual scores are zeros, the JAX program's own
        output when it has no perceptual function."""
        recon = torch.clamp(recon / self.b_scale, 0.0, 1.0)
        diff = torch.square(images[None] - recon)
        mse = diff.mean(dim=tuple(range(2, diff.dim())))  # (K, B)
        preview = recon[-1, : min(8, recon.shape[1])]
        return mse, torch.zeros_like(mse), preview

    def __call__(self, images, generator: Optional[torch.Generator] = None):
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        noise_full = self._noise((len(self.t_starts),) + tuple(images.shape), generator)
        autocast = (torch.autocast(self.device.type, dtype=self.autocast_dtype)
                    if self.autocast_dtype is not None else contextlib.nullcontext())
        mses, percs, offset = [], [], 0
        with torch.no_grad(), autocast:
            for ts_desc, t_starts in self._groups:
                k = t_starts.shape[0]
                recon = plms_sweep(self.sched, self._model, images,
                                   noise_full[offset: offset + k], ts_desc, t_starts,
                                   self.num_inference_steps, self.b_scale)
                offset += k
                mse, perc, preview = self._score(images, recon)
                mses.append(mse)
                percs.append(perc)
        self.last_preview = preview  # from the highest-start group
        return self.t_starts, torch.cat(mses), torch.cat(percs)
