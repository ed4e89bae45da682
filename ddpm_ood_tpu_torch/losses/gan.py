"""Least-squares (LSGAN) patch-adversarial losses.

Port of ``ddpm_ood_tpu/losses/gan.py`` (monai-generative's
``PatchAdversarialLoss(criterion="least_squares")`` as the reference VQ-VAE
trainer drives it): the mean squared distance of the logits to the real (1)
or fake (0) target, in fp32; the discriminator's loss halves the sum of its
fake and real terms.
"""

from __future__ import annotations

import torch


def _ls(logits: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    target = 1.0 if target_is_real else 0.0
    return torch.mean(torch.square(logits.to(torch.promote_types(logits.dtype, torch.float32))
                                   - target))


def generator_adversarial_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """The generator wants D(fake) -> real."""
    return _ls(logits_fake, True)


def discriminator_loss(logits_fake: torch.Tensor, logits_real: torch.Tensor) -> torch.Tensor:
    """0.5 * (LS(fake -> 0) + LS(real -> 1))."""
    return 0.5 * (_ls(logits_fake, False) + _ls(logits_real, True))
