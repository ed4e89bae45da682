"""VQ-VAE + PatchGAN training steps: generator, discriminator and eval.

Port of ``ddpm_ood_tpu/train/vqvae.py`` (the reference trainer's per-step
pipeline), on one device or one process per device:
  G: (recon, q_loss) = VQVAE(images); logits_fake = D(recon)[-1] with D in
     eval mode (its running BatchNorm statistics); total = L1 + q_loss +
     0.001 * LPIPS + jukebox + adv_weight * LSGAN(logits_fake);
     Adam(vqvae_lr). D's parameters take no gradient from it.
  D: LSGAN on the detached recon (fake, first) and the images (real, second)
     with D in train mode, so its running statistics are updated twice, in
     that order; loss adv_weight * d_loss; Adam(5e-4).
  adversarial_weight: the linear 50-epoch warm-up.

Data parallel: ``g_runner`` and ``d_runner`` run the forwards that take a
gradient (the models' ``DistributedDataParallel`` wrappers, or the
FSDP2-sharded models themselves); ``sync_g`` and ``sync_d`` run after their
step's last backward (FSDP2's replicated parameters). The G step calls the
unwrapped D, whose parameters take no gradient there, so D's DDP reducer
expects no all-reduce from it; the D step runs D's wrapper twice (fake, then
real) before its one backward.

``grad_accum`` k > 1 splits the G step's batch into
``_effective_accum(k, B)`` equal microbatches: the gradients and the scalar
metrics are the mean over microbatches, every microbatch quantizes against
the codebook the step started with, and the EMA codebook update is applied
once, from the counts and sums of all of them, as for the whole batch (the
JAX package reconstructs the same update in ``_combine_ema``). The D step
takes the whole batch.

Precision: fp32 parameters; on CUDA the convolutions of the VQ-VAE and of D
run under bf16 autocast, while the quantizer, BatchNorm statistics, the
losses, LPIPS and the FFT compute in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..losses.gan import discriminator_loss, generator_adversarial_loss
from ..losses.spectral import jukebox_loss
from ..parallel import fsdp
from .ddpm import _effective_accum

SCALAR_TAGS = ("l1_loss", "quantization_loss", "perceptual_loss", "jukebox_loss",
               "adversarial_loss", "generator_loss")
PERCEPTUAL_WEIGHT = 0.001  # the reference trainer's, as the JAX package's
DISC_LR = 5e-4


def adversarial_weight(adv_weight: float, epoch: int, warmup: bool) -> float:
    """The adversarial weight, warmed linearly over the first 50 epochs."""
    if warmup:
        return adv_weight * min(epoch, 50) / 50
    return adv_weight


@dataclasses.dataclass
class VQVAETrainStep:
    """The G, D and eval steps of one VQ-VAE and its discriminator, and
    their Adam optimizers. Images are (B, C, *spatial); ``perceptual`` is a
    ``losses.lpips.PerceptualLoss`` (None scores 0). ``g_backwards`` counts
    microbatch backwards of the G step."""

    model: nn.Module
    discriminator: nn.Module
    spatial_dims: int = 2
    perceptual: Optional[nn.Module] = None
    vqvae_lr: float = 3e-4
    grad_accum: int = 1
    # bf16 on CUDA (fp32 params, bf16 convolutions); None computes in fp32
    autocast_dtype: Optional[torch.dtype] = None
    # data parallel: the modules of the forwards that take a gradient, and
    # the gradient syncs after each step's last backward
    g_runner: Optional[nn.Module] = None
    d_runner: Optional[nn.Module] = None
    sync_g: Optional[Callable[[], None]] = None
    sync_d: Optional[Callable[[], None]] = None

    def __post_init__(self):
        self.g_runner = self.g_runner if self.g_runner is not None else self.model
        self.d_runner = self.d_runner if self.d_runner is not None else self.discriminator
        self.opt_g = fsdp.adam(self.model.parameters(), self.vqvae_lr)
        self.opt_d = fsdp.adam(self.discriminator.parameters(), DISC_LR)
        self.quantizer = self.model.quantizer.quantizer
        self.g_backwards = 0

    def autocast(self, device: torch.device):
        if self.autocast_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.autocast_dtype)

    def _perceptual(self, images: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        if self.perceptual is None:
            return torch.zeros((), device=images.device)
        with torch.autocast(images.device.type, enabled=False):
            return torch.mean(self.perceptual(images.movedim(1, -1), recon.movedim(1, -1)))

    def _losses(self, images: torch.Tensor, adv_weight: float
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """(total G loss, metrics, fp32 recon) of one (micro)batch; the
        VQ-VAE runs through ``g_runner`` when it takes a gradient."""
        g = self.g_runner if torch.is_grad_enabled() else self.model
        with self.autocast(images.device):
            recon, q_loss = g(images)
            recon = recon.to(torch.promote_types(recon.dtype, torch.float32))
            logits_fake = self.discriminator(recon)[-1]
        l1 = torch.mean(torch.abs(recon - images))
        p_loss = self._perceptual(images, recon)
        jb = jukebox_loss(recon, images, self.spatial_dims)
        adv = generator_adversarial_loss(logits_fake)
        total = l1 + q_loss + PERCEPTUAL_WEIGHT * p_loss + jb + adv_weight * adv
        metrics = {"l1_loss": l1, "quantization_loss": q_loss, "perceptual_loss": p_loss,
                   "jukebox_loss": jb, "adversarial_loss": adv, "generator_loss": total}
        return total, metrics, recon

    def generator_step(self, images: torch.Tensor, adv_weight: float
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One Adam update of the VQ-VAE and its EMA codebook update; returns
        the metrics (0-dim tensors on the device) and the detached fp32
        reconstruction of the whole batch."""
        self.model.train()
        self.discriminator.eval()
        self.opt_g.zero_grad(set_to_none=True)
        k = _effective_accum(self.grad_accum, images.shape[0])
        sums = {tag: torch.zeros((), device=images.device) for tag in SCALAR_TAGS}
        recons = []
        self.discriminator.requires_grad_(False)
        try:
            for i, images_i in enumerate(images.chunk(k)):
                skip_sync = i < k - 1 and hasattr(self.g_runner, "no_sync")
                with self.g_runner.no_sync() if skip_sync else contextlib.nullcontext():
                    total, metrics, recon = self._losses(images_i, adv_weight)
                    (total / k).backward()
                self.g_backwards += 1
                for tag in SCALAR_TAGS:
                    sums[tag] += metrics[tag].detach()
                recons.append(recon.detach())
        finally:
            self.discriminator.requires_grad_(True)
        if self.sync_g is not None:
            self.sync_g()
        self.opt_g.step()
        self.quantizer.ema_update()
        return {tag: v / k for tag, v in sums.items()}, torch.cat(recons)

    def discriminator_step(self, recon: torch.Tensor, images: torch.Tensor,
                           adv_weight: float) -> torch.Tensor:
        """One Adam update of D on the detached recon (fake) and the images
        (real); returns the unweighted D loss on the device."""
        self.discriminator.train()
        self.opt_d.zero_grad(set_to_none=True)
        with self.autocast(images.device):
            logits_fake = self.d_runner(recon.detach())[-1]
            logits_real = self.d_runner(images)[-1]
        d_loss = discriminator_loss(logits_fake, logits_real)
        (adv_weight * d_loss).backward()
        if self.sync_d is not None:
            self.sync_d()
        self.opt_d.step()
        return d_loss.detach()

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The metrics of the eval-mode models on one batch (generator_loss
        without the adversarial term) and the fp32 reconstruction."""
        self.model.eval()
        self.discriminator.eval()
        _, metrics, recon = self._losses(images, 0.0)
        return metrics, recon
