"""Noise schedules and forward-process math on fp32 tables.

Port of ``ddpm_ood_tpu/diffusion/schedules.py``. The beta tables are built on
the host in float64 and stored as float32, exactly as in the JAX package;
``NoiseSchedule.to(device)`` moves them to the device that gathers from them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SCHEDULE_ALIASES = {
    "linear": "linear_beta",
    "scaled_linear": "scaled_linear_beta",
    "cosine": "cosine_beta",
}


def make_beta_schedule(
    schedule: str,
    num_train_timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
) -> np.ndarray:
    """Beta table for the named schedule (float64 on the host, then float32).

    ``cosine_beta`` is the Improved-DDPM schedule (s=0.008, betas clipped at
    0.999); beta_start/beta_end are ignored for it."""
    schedule = _SCHEDULE_ALIASES.get(schedule, schedule)
    if schedule == "linear_beta":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif schedule == "scaled_linear_beta":
        betas = np.linspace(
            beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64
        ) ** 2
    elif schedule == "cosine_beta":
        s = 0.008
        t = np.arange(num_train_timesteps + 1, dtype=np.float64)
        f = np.cos((t / num_train_timesteps + s) / (1.0 + s) * np.pi / 2.0) ** 2
        acp = f / f[0]
        betas = np.clip(1.0 - acp[1:] / acp[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"Unknown beta schedule: {schedule!r}")
    return betas.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """fp32 schedule tables (T,) plus the prediction-type tag."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str = "epsilon"

    def to(self, device: torch.device) -> "NoiseSchedule":
        return dataclasses.replace(
            self,
            betas=self.betas.to(device),
            alphas=self.alphas.to(device),
            alphas_cumprod=self.alphas_cumprod.to(device),
        )


def make_schedule(
    schedule: str = "linear_beta",
    num_train_timesteps: int = 1000,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
    prediction_type: str = "epsilon",
    snr_shift: float = 1.0,
    device: torch.device = torch.device("cpu"),
) -> NoiseSchedule:
    betas = make_beta_schedule(schedule, num_train_timesteps, beta_start, beta_end)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, dtype=np.float64).astype(np.float32)
    sched = NoiseSchedule(
        betas=torch.from_numpy(betas),
        alphas=torch.from_numpy(alphas),
        alphas_cumprod=torch.from_numpy(alphas_cumprod),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )
    if snr_shift != 1.0:
        sched = apply_snr_shift(sched, snr_shift)
    return sched.to(device)


def apply_snr_shift(sched: NoiseSchedule, factor: float) -> NoiseSchedule:
    """SNR-shifted schedule: acp' = factor*acp / (1 - acp + factor*acp), alphas'
    the ratio of consecutive cumprods, betas' = 1 - alphas' (float64 math)."""
    acp = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
    new_acp = factor * acp / (1.0 - acp + factor * acp)
    new_alphas = np.empty_like(new_acp)
    new_alphas[0] = new_acp[0]
    new_alphas[1:] = new_acp[1:] / new_acp[:-1]
    new_betas = 1.0 - new_alphas
    device = sched.alphas_cumprod.device
    return NoiseSchedule(
        betas=torch.from_numpy(new_betas.astype(np.float32)).to(device),
        alphas=torch.from_numpy(new_alphas.astype(np.float32)).to(device),
        alphas_cumprod=torch.from_numpy(new_acp.astype(np.float32)).to(device),
        num_train_timesteps=sched.num_train_timesteps,
        prediction_type=sched.prediction_type,
    )


def _gather(table: torch.Tensor, t, ndim: int) -> torch.Tensor:
    """table[t] broadcast against a sample of rank `ndim` with leading batch dim(s)."""
    t = torch.as_tensor(t, device=table.device)
    vals = table[t.long()]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))


def add_noise(sched: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """Forward process x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps; `t` is a
    scalar or a per-sample int tensor over the leading dim(s)."""
    acp = _gather(sched.alphas_cumprod, t, x0.dim())
    return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise


def pred_x0_from_model_output(sched: NoiseSchedule, model_output: torch.Tensor,
                              x_t: torch.Tensor, t,
                              prediction_type: str | None = None) -> torch.Tensor:
    ptype = prediction_type or sched.prediction_type
    acp = _gather(sched.alphas_cumprod, t, x_t.dim())
    if ptype == "epsilon":
        return (x_t - torch.sqrt(1.0 - acp) * model_output) / torch.sqrt(acp)
    if ptype == "sample":
        return model_output
    if ptype == "v_prediction":
        return torch.sqrt(acp) * x_t - torch.sqrt(1.0 - acp) * model_output
    raise ValueError(f"Unknown prediction type: {ptype!r}")


def epsilon_from_model_output(sched: NoiseSchedule, model_output: torch.Tensor,
                              x_t: torch.Tensor, t,
                              prediction_type: str | None = None) -> torch.Tensor:
    """Any model output converted to its implied epsilon (used by PLMS)."""
    ptype = prediction_type or sched.prediction_type
    acp = _gather(sched.alphas_cumprod, t, x_t.dim())
    if ptype == "epsilon":
        return model_output
    if ptype == "sample":
        return (x_t - torch.sqrt(acp) * model_output) / torch.sqrt(1.0 - acp)
    if ptype == "v_prediction":
        return torch.sqrt(acp) * model_output + torch.sqrt(1.0 - acp) * x_t
    raise ValueError(f"Unknown prediction type: {ptype!r}")
