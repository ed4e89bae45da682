"""LPIPS perceptual distance (AlexNet backbone), 2D and fake 3D, for OOD scoring.

Port of ``ddpm_ood_tpu/losses/lpips.py`` (``AlexNetFeatures``, ``LPIPS``,
``pad_to_min_32`` and ``PerceptualLoss``, 2D and fake 3D): the forward of
``lpips.LPIPS(net="alex", version="0.1")`` as the reference's scoring
wrapper builds it. The public edges keep the JAX layout, images as
(B, H, W, C) in [0, 1]; the convolutions run in (N, C, H, W). Everything is
fp32: the JAX package computes LPIPS in fp32 (``PerceptualLoss(dtype=float32)``),
so callers inside an autocast region switch it off around this module.

Weights come from the ``.npz`` that the JAX package's ``save_lpips_npz``
writes (keys ``params/net/conv0/kernel`` in HWIO, ``params/lin0`` as (C, 1);
read by ``utils/convert.py:load_params_npz``), found through
``LPIPS_WEIGHTS_NPZ`` as the JAX package finds it. Without one, the port
draws a seeded init with Flax's default distributions. JAX draws its own
from ``jax.random.PRNGKey(0)``, which torch cannot redraw, so the two
packages agree only when both read one npz.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.convert import jax_lpips_params_to_state_dict, load_params_npz

log = logging.getLogger(__name__)

# AlexNet feature taps: channels after each of the five ReLU stages.
ALEX_CHANNELS = (64, 192, 384, 256, 256)
# torchvision AlexNet `features` convs: (name, in, out, kernel, stride, padding);
# a max-pool (3, stride 2, floor) follows conv0 and conv3
ALEX_CONVS = (("conv0", 3, 64, 11, 4, 2), ("conv3", 64, 192, 5, 1, 2),
              ("conv6", 192, 384, 3, 1, 1), ("conv8", 384, 256, 3, 1, 1),
              ("conv10", 256, 256, 3, 1, 1))
# lpips ScalingLayer constants (applied to inputs in [-1, 1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# Flax's truncated-normal initialisers divide the std by the std of a unit
# normal truncated to [-2, 2], so the drawn values have the asked-for variance
_TRUNC_STD = 0.87962566103423978


class AlexNetFeatures(nn.Module):
    """torchvision-AlexNet `features` trunk on (N, 3, H, W), returning the
    five ReLU taps."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, p in ALEX_CONVS:
            self.add_module(name, nn.Conv2d(cin, cout, k, stride=s, padding=p))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for name, *_ in ALEX_CONVS:
            x = F.relu(getattr(self, name)(x))
            taps.append(x)
            if name in ("conv0", "conv3"):
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPS(nn.Module):
    """lpips.LPIPS(net='alex') forward: unit-normalize taps, squared diff,
    learned 1x1 'lin' calibration (weights clamped at 0), spatial mean, sum
    over taps. ``forward(x, y)`` on (B, H, W, C) returns (B,) distances."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, c in enumerate(ALEX_CHANNELS):
            self.add_module(f"lin{i}", nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The five unit-normalized taps of (N, H, W, C) images in [0, 1],
        C in {1, 3}."""
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)  # grayscale -> RGB, before the [-1, 1] map
        x = 2.0 * x.permute(0, 3, 1, 2) - 1.0  # lpips_normalize=True in the reference
        x = (x - self.shift) / self.scale
        # published lpips v0.1 normalize_tensor: the epsilon is OUTSIDE the sqrt
        return [f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)
                for f in self.net(x)]

    def distance(self, fx: List[torch.Tensor], fy: List[torch.Tensor]) -> torch.Tensor:
        """Distances between the taps of B images and of L*B images (lane
        major): (L*B,), each against its image of ``fx``."""
        total = 0.0
        for i, (ax, ay) in enumerate(zip(fx, fy)):
            diff = (ay.view((-1,) + tuple(ax.shape)) - ax).square().flatten(0, 1)
            w = getattr(self, f"lin{i}").weight.clamp_min(0.0)
            total = total + F.conv2d(diff, w).mean(dim=(1, 2, 3))
        return total

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape != y.shape:
            raise ValueError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
        return self.distance(self.features(x), self.features(y))


def pad_to_min_32(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad (..., H, W, C) up to at least 32x32: AlexNet's conv/pool chain
    collapses to zero size below that. The reference's 28->32 rule, for any
    small input; larger inputs pass through unchanged."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = max(0, 32 - h), max(0, 32 - w)
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def seeded_lpips_state_dict() -> Dict[str, torch.Tensor]:
    """The port's deterministic fallback weights: Flax's default
    distributions (lecun_normal convs with zero biases; ``lin`` from
    variance_scaling(0.2, fan_in, truncated normal)) drawn from a
    ``torch.Generator`` seeded with 0, in ALEX_CONVS order, then lin0-4."""
    gen = torch.Generator().manual_seed(0)

    def trunc(shape, scale: float, fan_in: int) -> torch.Tensor:
        std = math.sqrt(scale / fan_in) / _TRUNC_STD
        return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                     generator=gen)

    sd = {}
    for name, cin, cout, k, _, _ in ALEX_CONVS:
        sd[f"net.{name}.weight"] = trunc((cout, cin, k, k), 1.0, cin * k * k)
        sd[f"net.{name}.bias"] = torch.zeros(cout)
    for i, c in enumerate(ALEX_CHANNELS):
        sd[f"lin{i}.weight"] = trunc((1, c, 1, 1), 0.2, c)
    return sd


def load_lpips_state_dict(weights_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The LPIPS state_dict from `weights_path`, else from the npz that
    ``LPIPS_WEIGHTS_NPZ`` names, else the seeded fallback (logged)."""
    path = weights_path or os.environ.get("LPIPS_WEIGHTS_NPZ")
    if weights_path or (path and os.path.exists(path)):
        return jax_lpips_params_to_state_dict(load_params_npz(path))
    log.warning(
        "LPIPS: no weights npz (LPIPS_WEIGHTS_NPZ=%r), so the port draws its own seeded init; "
        "perceptual_difference then equals the JAX package's only when both packages read "
        "one npz: write the JAX package's fallback with "
        "`ddpm_ood_tpu.losses.lpips.save_lpips_npz(load_lpips_params(), path)` on a host "
        "with JAX and point LPIPS_WEIGHTS_NPZ at it", path)
    return seeded_lpips_state_dict()


# fake-3D views of (B, X, Y, Z, C): the permutation that puts the sliced axis
# after the batch, as the JAX package orders them (the last one is scored)
_VIEWS_3D = ((0, 1, 2, 3, 4), (0, 2, 1, 3, 4), (0, 3, 1, 2, 4))


class PerceptualLoss(nn.Module):
    """The reference's perceptual wrapper, one score per image.

    2D: LPIPS on inputs zero-padded to at least 32x32 (the reference's 28->32
    rule). 3D ("fake 3D", the JAX package's ``PerceptualLoss(dimensions=3,
    is_fake_3d=True)``): each volume is cut into 2D slices along one axis,
    LPIPS runs on every slice, and a volume's score is the mean over its own
    slices. The reference computes the three views (slices along X, Y and Z)
    and keeps only the last, a quirk the JAX package keeps; so the port
    computes only the last view, slices along Z, unless ``average_views``
    asks for the mean of all three. ``drop_ratio`` keeps every
    ``n // keep``-th slice of n, ``keep = max(1, int(n * (1 - drop_ratio)))``
    of them, as the JAX package subsamples.

    ``forward(y, y_pred)``: y is (B, *spatial, C); y_pred is
    (*lanes, B, *spatial, C), each lane scored against y. Returns
    (*lanes, B). The features of y are computed once for every lane, or
    passed in as `y_features` (``image_features(y)``). Weights:
    `state_dict`, else ``load_lpips_state_dict(weights_path)``."""

    def __init__(self, weights_path: Optional[str] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 spatial_dims: int = 2, drop_ratio: float = 0.0, average_views: bool = False):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise NotImplementedError("Perceptual loss is implemented only in 2D and 3D.")
        self.spatial_dims, self.average_views = spatial_dims, average_views
        self.keep_ratio = 1.0 - drop_ratio
        self.lpips = LPIPS()
        self.lpips.load_state_dict(
            state_dict if state_dict is not None else load_lpips_state_dict(weights_path))
        self.requires_grad_(False)

    def _views(self) -> tuple:
        """The fake-3D views scored (None: the 2D images themselves)."""
        if self.spatial_dims == 2:
            return (None,)
        return _VIEWS_3D if self.average_views else _VIEWS_3D[-1:]

    def _slices(self, v: torch.Tensor, perm) -> torch.Tensor:
        """The 2D slices of one fake-3D view of (*lanes, B, X, Y, Z, C), the
        sliced axis after the batch and subsampled by ``drop_ratio``:
        (*lanes, B * slices, h, w, C)."""
        lead = v.dim() - 5
        v = v.permute(tuple(range(lead)) + tuple(p + lead for p in perm))
        if self.keep_ratio < 1.0:
            n = v.shape[lead + 1]
            keep = max(1, int(n * self.keep_ratio))
            v = v[(slice(None),) * (lead + 1) + (slice(None, None, max(1, n // keep)),)]
            v = v.narrow(lead + 1, 0, min(keep, v.shape[lead + 1]))
        return v.flatten(lead, lead + 1)

    def image_features(self, y: torch.Tensor) -> List[List[torch.Tensor]]:
        """The LPIPS taps of y (B, *spatial, C), per scored view: what
        ``forward`` takes as `y_features` to score several calls' lanes
        against one batch."""
        return [self._taps(y, perm) for perm in self._views()]

    def _taps(self, v: torch.Tensor, perm) -> List[torch.Tensor]:
        """The LPIPS taps of one view of (*lanes, B, *spatial, C)."""
        v = v if perm is None else self._slices(v, perm)
        return self.lpips.features(pad_to_min_32(v.flatten(0, v.dim() - 4)))

    def forward(self, y: torch.Tensor, y_pred: torch.Tensor,
                y_features: Optional[List[List[torch.Tensor]]] = None) -> torch.Tensor:
        lanes = tuple(y_pred.shape[: y_pred.dim() - y.dim()])
        if tuple(y_pred.shape[len(lanes):]) != tuple(y.shape):
            raise ValueError(f"y_pred {tuple(y_pred.shape)} is not (*lanes, *{tuple(y.shape)})")
        if y.dim() != self.spatial_dims + 2:
            raise ValueError(f"expected (B, *spatial, C) with {self.spatial_dims} spatial dims, "
                             f"got {tuple(y.shape)}")
        y_pred = y_pred.reshape((-1,) + tuple(y.shape))  # (L, B, *spatial, C)
        views = []
        for i, perm in enumerate(self._views()):
            fy = self._taps(y, perm) if y_features is None else y_features[i]
            d = self.lpips.distance(fy, self._taps(y_pred, perm))
            views.append(d.view(y_pred.shape[0], y.shape[0], -1).mean(dim=-1))  # slice mean
        out = views[0] if len(views) == 1 else torch.stack(views).mean(dim=0)
        return out.view(lanes + (y.shape[0],))
