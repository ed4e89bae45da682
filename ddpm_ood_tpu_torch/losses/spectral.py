"""Jukebox spectral loss: the MSE between FFT magnitudes over the spatial dims.

Port of ``ddpm_ood_tpu/losses/spectral.py`` (monai-generative's
``JukeboxLoss(spatial_dims, fft_norm="ortho", reduction="mean")``) on
channels-first (B, C, *spatial) tensors, so the transform runs over dims 2
onwards. It always runs ``torch.fft.fftn`` in fp32 with autocast off: cuFFT
in half precision is inexact and takes power-of-two sizes only. The JAX
package's real-arithmetic DFT, for TPU runtimes without an FFT, is not
ported.
"""

from __future__ import annotations

import torch


def fft_amplitude(x: torch.Tensor, spatial_dims: int, norm: str = "ortho") -> torch.Tensor:
    """|FFT(x)| over the spatial dims of (B, C, *spatial), in fp32."""
    with torch.autocast(x.device.type, enabled=False):
        dims = tuple(range(2, 2 + spatial_dims))
        f = torch.fft.fftn(x.to(torch.promote_types(x.dtype, torch.float32)), dim=dims,
                           norm=norm)
        return f.abs()  # its gradient at a zero coefficient is 0, where sqrt's is not finite


def jukebox_loss(recon: torch.Tensor, target: torch.Tensor, spatial_dims: int,
                 norm: str = "ortho") -> torch.Tensor:
    a = fft_amplitude(recon, spatial_dims, norm)
    b = fft_amplitude(target, spatial_dims, norm)
    return torch.mean(torch.square(a - b))
