"""Structural similarity (SSIM) for OOD scoring.

Port of ``ddpm_ood_tpu/ops/ssim.py``: Wang et al. 2004 SSIM with
Gaussian-weighted local statistics between images in [0, 1], channel-last
(B, H, W, C) or (B, D, H, W, C). The Gaussian blur is separable, one
depthwise 1-D convolution per spatial axis, over 'VALID' windows only. The
JAX package computes it with XLA convolutions outside any Pallas kernel, and
so does the port, with grouped ``torch`` convolutions: the five blurred
statistics go through one grouped convolution per axis.

Constants: window 11, sigma 1.5, k1 0.01, k2 0.03; the window is clamped to
the smallest spatial dimension and kept odd. The statistics are fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_CONV = {2: F.conv2d, 3: F.conv3d}
WINDOW, SIGMA = 11, 1.5
K1, K2 = 0.01, 0.03  # data range 1


def _gaussian_1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(a: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Separable depthwise blur over the spatial axes of (N, C, *spatial)."""
    nd, c = a.dim() - 2, a.shape[1]
    for ax in range(nd):
        shape = [c, 1] + [1] * nd
        shape[2 + ax] = kern.numel()
        a = _CONV[nd](a, kern.view(shape[2:]).expand(shape), groups=c)
    return a


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-image mean SSIM between x and y, both (B, *spatial, C) in [0, 1].
    Returns (B,) in fp32."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.dim() not in (4, 5):
        raise ValueError(f"expected (B, *spatial, C) with 2 or 3 spatial dims, got "
                         f"{tuple(x.shape)}")
    ws = min(WINDOW, min(x.shape[1:-1]))
    ws -= (ws + 1) % 2  # keep odd
    kern = torch.from_numpy(_gaussian_1d(ws, SIGMA)).to(x.device)

    x = x.float().movedim(-1, 1)
    y = y.float().movedim(-1, 1)
    # x, y, x^2, y^2, xy blurred together: each channel is its own group
    mu_x, mu_y, e_xx, e_yy, e_xy = _blur(torch.cat([x, y, x * x, y * y, x * y], dim=1),
                                         kern).chunk(5, dim=1)
    # E[a^2] - E[a]^2: the Gaussian-weighted (biased) local variance
    var_x = e_xx - mu_x * mu_x
    var_y = e_yy - mu_y * mu_y
    cov = e_xy - mu_x * mu_y

    c1, c2 = K1 ** 2, K2 ** 2
    ssim_map = ((2.0 * mu_x * mu_y + c1) * (2.0 * cov + c2)) / (
        (mu_x * mu_x + mu_y * mu_y + c1) * (var_x + var_y + c2))
    return ssim_map.mean(dim=tuple(range(1, ssim_map.dim())))


def ssim_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - SSIM per image: higher = more dissimilar, the same direction as
    the mse and perceptual_difference columns."""
    return 1.0 - ssim(x, y)
