"""DDPM training step: noising, loss, backward, Adam, weight EMA.

Port of ``ddpm_ood_tpu/train/ddpm.py``, 2D and 3D, in pixel space or on
the latents of a frozen VQ-VAE. ``prepare`` turns a batch of images into
what the UNet trains on: the images themselves, or (latent diffusion)
their quantized latents from ``encode_fn`` under no_grad, in fp32, padded
by ``latent_pad`` (torch's ``F.pad`` tuple, last spatial axis first). One
step on that x0 is: x_t = add_noise(x0 * b_scale), the UNet's prediction,
an fp32 MSE to the prediction type's target, gradients (optionally
accumulated over equal microbatches), one Adam update, then the weight EMA.
The JAX package fuses it into one jitted program; here it is eager PyTorch
whose attention and GroupNorm go through the hand-written kernels on CUDA,
backward included.

Parity choices:
  - Adam with optax's defaults (beta 0.9 / 0.999, eps 1e-8, no eps_root).
  - ``lr_warmup_steps`` > 0 follows ``optax.linear_schedule(0, lr, W)``: the
    update with index c (0 for the first) uses lr * min(c, W) / W, so the
    first update has lr 0. The index is the number of updates Adam has made,
    read from its own state, so a resumed run continues the ramp exactly.
  - ``grad_accum`` k > 1 splits the batch into ``_effective_accum(k, B)``
    equal microbatches and uses the mean of their mean-loss gradients, which
    equals the full batch's gradient; one microbatch's activations are live
    at a time.
  - The EMA ``d * e + (1 - d) * p`` is taken after the update.

Data parallel: ``runner`` is the module that runs the training forward, the
model's ``DistributedDataParallel`` wrapper (whose gradient all-reduce
averages the processes' mean-loss gradients, the global batch's gradient
when their batches are equal) or the FSDP2-sharded model itself;
``sync_grads`` runs after the last backward (FSDP2's replicated parameters).
With ``grad_accum`` > 1, DDP skips the all-reduce of every microbatch but
the last (``no_sync``). The EMA and evaluation use ``model``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.schedules import NoiseSchedule, add_noise, training_target
from ..parallel import fsdp


def _effective_accum(k: int, batch: int) -> int:
    """Largest divisor of `batch` that is <= k: nominal batches split into k
    microbatches; a ragged loader tail into the most it evenly can, keeping
    its microbatch no larger than the nominal one."""
    if k <= 1 or batch <= 1:
        return 1
    return max(d for d in range(1, min(k, batch) + 1) if batch % d == 0)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """A (B, C, H, W) or (B, C, D, H, W) tensor in the UNet's channels-last
    layout."""
    if x.dim() == 4:
        return x.contiguous(memory_format=torch.channels_last)
    if x.dim() == 5:
        return x.contiguous(memory_format=torch.channels_last_3d)
    return x


@dataclasses.dataclass
class DDPMTrainStep:
    """Training state and step for one UNet: the model, torch Adam, and the
    weight EMA (``ema`` is None when ``ema_decay`` is 0). Inputs are
    (B, C, *spatial); t is (B,) int. ``forwards`` and ``backwards`` count
    UNet forwards and microbatch backwards."""

    model: nn.Module
    sched: NoiseSchedule
    b_scale: float = 1.0
    learning_rate: float = 2.5e-5
    lr_warmup_steps: int = 0
    ema_decay: float = 0.0
    grad_accum: int = 1
    # bf16 on CUDA (fp32 params, bf16 compute); None computes in fp32
    autocast_dtype: Optional[torch.dtype] = None
    # latent diffusion: the frozen VQ-VAE's encode_stage_2_inputs on
    # (B, C, *spatial) images, and the pad of its latents
    encode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    latent_pad: Optional[Tuple[int, ...]] = None
    # data parallel: the module of the training forward, and the gradient
    # sync after the last backward
    runner: Optional[nn.Module] = None
    sync_grads: Optional[Callable[[], None]] = None

    def __post_init__(self):
        self.runner = self.runner if self.runner is not None else self.model
        self.optimizer = fsdp.adam(self.model.parameters(), self.learning_rate)
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if self.ema_decay > 0.0:
            self.ema = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.forwards = 0
        self.backwards = 0

    def autocast(self, device: torch.device):
        """The step's autocast region (a no-op context in fp32)."""
        if self.autocast_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.autocast_dtype)

    @torch.no_grad()
    def prepare(self, images: torch.Tensor) -> torch.Tensor:
        """x0 for the UNet from (B, C, *spatial) images: the images, or their
        latents (fp32, padded), channels-last."""
        x = images
        if self.encode_fn is not None:
            with self.autocast(images.device):
                x = self.encode_fn(x)
            x = x.float()
        if self.latent_pad:
            x = F.pad(x, tuple(self.latent_pad))
        return channels_last(x)

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``prepare``'s pad on (B, C, *spatial) latents."""
        return F.pad(x, tuple(-p for p in self.latent_pad)) if self.latent_pad else x

    def loss(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """fp32 MSE of the UNet's prediction on add_noise(x0 * b_scale); the
        forward runs through ``runner`` when it takes a gradient."""
        x_scaled = x0 * self.b_scale
        x_t = add_noise(self.sched, x_scaled, noise, t)
        target = training_target(self.sched, x_scaled, noise, t)
        net = self.runner if torch.is_grad_enabled() else self.model
        with self.autocast(x0.device):
            pred = net(channels_last(x_t), t)
        self.forwards += 1
        return torch.mean(torch.square(pred.float() - target))

    def grads(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Fill every parameter's .grad with the batch's loss gradient; returns
        the (detached) loss."""
        self.optimizer.zero_grad(set_to_none=True)
        k = _effective_accum(self.grad_accum, x0.shape[0])
        total = torch.zeros((), device=x0.device)
        for i, (x0_i, noise_i, t_i) in enumerate(zip(x0.chunk(k), noise.chunk(k), t.chunk(k))):
            with self._no_sync(i < k - 1):
                loss_i = self.loss(x0_i, noise_i, t_i)
                (loss_i / k).backward()
            self.backwards += 1
            total += loss_i.detach()
        if self.sync_grads is not None:
            self.sync_grads()
        return total / k

    def _no_sync(self, skip: bool):
        """DDP's ``no_sync`` for a microbatch whose all-reduce is skipped."""
        if skip and hasattr(self.runner, "no_sync"):
            return self.runner.no_sync()
        return contextlib.nullcontext()

    @property
    def updates(self) -> int:
        """Adam updates made so far (its per-parameter step count)."""
        for state in self.optimizer.state.values():
            return int(state["step"])
        return 0

    def lr_at(self, update: int) -> float:
        if self.lr_warmup_steps > 0:
            return self.learning_rate * min(update, self.lr_warmup_steps) / self.lr_warmup_steps
        return self.learning_rate

    def update(self) -> None:
        """One Adam update from the parameters' .grad, then the EMA."""
        lr = self.lr_at(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    self.ema[n].mul_(d).add_(p, alpha=1.0 - d)

    def step(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One optimizer step on (x0, t, noise); returns the loss on the device."""
        loss = self.grads(x0, noise, t)
        self.update()
        return loss

    @torch.no_grad()
    def eval_loss(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return self.loss(x0, noise, t)

    def draw(self, x0: torch.Tensor, generator: Optional[torch.Generator]):
        """t ~ U[0, T) per sample and Gaussian noise of x0's shape."""
        t = torch.randint(0, self.sched.num_train_timesteps, (x0.shape[0],),
                          generator=generator, device=x0.device)
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        return t, noise
