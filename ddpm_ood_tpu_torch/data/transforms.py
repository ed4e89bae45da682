"""Deterministic host-side image transform chain.

A copy of ``ddpm_ood_tpu/data/transforms.py`` (the port imports nothing of
the JAX package), so both packages see identical inputs. Parity with the
reference's MONAI chain: LoadImaged -> EnsureChannelFirstd (grayscale) ->
Lambdad x[0,None] -> CenterSpatialCropD(image_roi) -> ResizeD(image_size^dim)
-> ScaleIntensityd [0,1] -> RandFlipD(prob=1.0, axis 0=vflip / 1=hflip for
near-OOD sets). The reference's `augmentation` flag is a documented no-op;
all transforms are pure numpy, channel-first (C, *spatial), deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from .nifti import load_nifti


def load_image(path: str) -> np.ndarray:
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".nii") or path.endswith(".nii.gz"):
        return load_nifti(path)
    if path.endswith((".png", ".jpg", ".jpeg", ".bmp")):
        from PIL import Image

        return np.asarray(Image.open(path), dtype=np.float32)
    raise ValueError(f"Unsupported image format: {path}")


def ensure_channel_first(x: np.ndarray, spatial_dimension: int, is_grayscale: bool) -> np.ndarray:
    """Match LoadImaged+EnsureChannelFirstd+Lambdad semantics for our file formats."""
    if x.ndim == spatial_dimension:  # (H, W) or (X, Y, Z): add channel axis
        x = x[None]
    elif x.ndim == spatial_dimension + 1:
        if x.shape[-1] in (1, 3, 4) and x.shape[0] not in (1, 3, 4):
            # channel-last raster (e.g. PIL HWC) -> channel-first
            x = np.moveaxis(x, -1, 0)
        # else: already channel-first (reference prep scripts save CHW npy)
    else:
        raise ValueError(f"Unexpected image rank {x.ndim} for spatial dim {spatial_dimension}")
    if is_grayscale:
        # reference quirk: select modality 0 (needed for BraTS 4-modality NIfTI)
        x = x[0:1]
    return np.ascontiguousarray(x, dtype=np.float32)


def center_spatial_crop(x: np.ndarray, roi_size: Sequence[int]) -> np.ndarray:
    """Center crop of the spatial dims; -1 leaves a dim uncropped (MONAI semantics)."""
    spatial = x.shape[1:]
    slices = [slice(None)]
    for dim, roi in zip(spatial, roi_size):
        if roi is None or roi < 0 or roi >= dim:
            slices.append(slice(None))
        else:
            start = max((dim - roi) // 2, 0)
            slices.append(slice(start, start + roi))
    return x[tuple(slices)]


def resize(x: np.ndarray, spatial_size: Sequence[int]) -> np.ndarray:
    """Linear resize of spatial dims of a channel-first array."""
    spatial = x.shape[1:]
    if tuple(spatial) == tuple(spatial_size):
        return x
    zoom = [1.0] + [t / s for t, s in zip(spatial_size, spatial)]
    return ndimage.zoom(x, zoom, order=1).astype(np.float32)


def scale_intensity(x: np.ndarray, minv: float = 0.0, maxv: float = 1.0) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.zeros_like(x) + minv
    return ((x - lo) / (hi - lo) * (maxv - minv) + minv).astype(np.float32)


def flip(x: np.ndarray, spatial_axis: int) -> np.ndarray:
    """Flip one spatial axis of a channel-first array (axis 0 = vflip, 1 = hflip)."""
    return np.ascontiguousarray(np.flip(x, axis=spatial_axis + 1))


@dataclasses.dataclass(frozen=True)
class TransformChain:
    spatial_dimension: int = 2
    is_grayscale: bool = False
    image_size: Optional[int] = None
    image_roi: Optional[Sequence[int]] = None
    add_vflip: bool = False
    add_hflip: bool = False

    def __call__(self, path: str) -> np.ndarray:
        x = load_image(path)
        x = ensure_channel_first(x, self.spatial_dimension, self.is_grayscale)
        if self.image_roi:
            x = center_spatial_crop(x, self.image_roi)
        if self.image_size:
            x = resize(x, (int(self.image_size),) * self.spatial_dimension)
        x = scale_intensity(x, 0.0, 1.0)
        if self.add_vflip:
            x = flip(x, 0)
        if self.add_hflip:
            x = flip(x, 1)
        return x
