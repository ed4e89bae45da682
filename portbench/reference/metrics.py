"""The scores of a reconstruction against its image: MSE, LPIPS v0.1 with
AlexNet (2D, or "fake 3D": the mean over a volume's slices along its last
axis), and 1 - SSIM (Wang et al. 2004: Gaussian window 11, sigma 1.5, k1
0.01, k2 0.03, valid windows, the window clamped to the smallest axis and
kept odd). Images are (B, C, *spatial) in [0, 1]; the reconstruction is
divided by b_scale and clamped to [0, 1] first. float32 throughout.

``FAULTS`` are scores computed wrong on purpose, to show that a check of
the scores sees them: a volume's LPIPS over its slices along the first
axis instead of the last.

LPIPS weights come from an npz in the key schema ``params/net/conv{0,3,6,8,
10}/{kernel,bias}`` (kernels HWIO) and ``params/lin{0..4}`` ((C, 1)).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .ops import FP32, Ops

ALEX = (("conv0", 4, 2, True), ("conv3", 1, 2, True), ("conv6", 1, 1, False),
        ("conv8", 1, 1, False), ("conv10", 1, 1, False))  # name, stride, pad, pool after
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
FAULTS = ("lpips_axis",)


def lpips_weights(npz_path, device) -> Dict[str, torch.Tensor]:
    z = np.load(npz_path)
    p = {}
    for name, *_ in ALEX:
        p[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(z[f"params/net/{name}/kernel"].transpose(3, 2, 0, 1)))
        p[f"{name}.bias"] = torch.from_numpy(z[f"params/net/{name}/bias"])
    for i in range(5):
        p[f"lin{i}"] = torch.from_numpy(z[f"params/lin{i}"]).reshape(1, -1, 1, 1)
    return {k: v.float().to(device) for k, v in p.items()}


def _features(p, x: torch.Tensor, ops: Ops) -> List[torch.Tensor]:
    """Unit-normalised AlexNet taps of (N, C, H, W) images in [0, 1]."""
    pad = [max(0, 32 - s) for s in x.shape[-2:]]  # zeros up to 32x32 for AlexNet's chain
    if any(pad):
        x = F.pad(x, (pad[1] // 2, pad[1] - pad[1] // 2, pad[0] // 2, pad[0] - pad[0] // 2))
    if x.shape[1] == 1:
        x = x.expand(-1, 3, -1, -1)
    shift = torch.tensor(SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=x.device).view(1, 3, 1, 1)
    x = ((2 * x - 1) - shift) / scale
    taps = []
    for name, stride, padding, pool in ALEX:
        x = F.relu(ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride, padding))
        taps.append(x / (torch.sqrt((x * x).sum(1, keepdim=True)) + 1e-10))
        if pool:
            x = F.max_pool2d(x, 3, 2)
    return taps


def lpips(p, x: torch.Tensor, y: torch.Tensor, ops: Ops = FP32) -> torch.Tensor:
    """(N,) distances between (N, C, H, W) images x and y."""
    total = 0.0
    for i, (a, b) in enumerate(zip(_features(p, x, ops), _features(p, y, ops))):
        total = total + (((a - b) ** 2) * p[f"lin{i}"].clamp_min(0)).sum(1).mean((1, 2))
    return total


def perceptual(p, images: torch.Tensor, recon: torch.Tensor, ops: Ops = FP32,
               axis: int = 4) -> torch.Tensor:
    """(B,) LPIPS of 2D images, or of 3D volumes the mean over their slices
    along `axis` (the last)."""
    if images.dim() == 4:
        return lpips(p, images, recon, ops)
    b, c = images.shape[:2]
    rest = [a for a in (2, 3, 4) if a != axis]

    def slices(v):
        return v.permute(0, axis, 1, *rest).reshape(-1, c, v.shape[rest[0]], v.shape[rest[1]])

    return lpips(p, slices(images), slices(recon), ops).view(b, -1).mean(1)


def _gaussian(size: int, sigma: float = 1.5) -> torch.Tensor:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B,) mean SSIM of (B, C, *spatial) images."""
    nd = x.dim() - 2
    ws = min(11, min(x.shape[2:]))
    ws -= (ws + 1) % 2
    g = _gaussian(ws).to(x.device)
    conv = {2: F.conv2d, 3: F.conv3d}[nd]

    def blur(a):
        c = a.shape[1]
        for ax in range(nd):
            shape = [1] * nd
            shape[ax] = ws
            a = conv(a, g.view(1, 1, *shape).expand(c, 1, *shape), groups=c)
        return a

    mx, my = blur(x), blur(y)
    vx, vy = blur(x * x) - mx * mx, blur(y * y) - my * my
    cxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return m.flatten(1).mean(1)


def scores(lp, images: torch.Tensor, recon: torch.Tensor, b_scale: float = 1.0,
           score_ssim: bool = False, ops: Ops = FP32,
           fault: str = None) -> Dict[str, torch.Tensor]:
    """{"mse", "perceptual_difference"[, "ssim_distance"]}, each (B,), of
    one start point's reconstructions (B, C, *spatial); `fault` is None or
    one of FAULTS."""
    assert fault is None or fault in FAULTS, fault
    recon = torch.clamp(recon / b_scale, 0.0, 1.0)
    axis = 2 if fault == "lpips_axis" else 4
    out = {"mse": ((images - recon) ** 2).flatten(1).mean(1),
           "perceptual_difference": perceptual(lp, images, recon, ops, axis)}
    if score_ssim:
        out["ssim_distance"] = 1.0 - ssim(images, recon)
    return out
