"""Weights and inputs made from a run's seed. The same seed gives the same
weights, images and noise, on any card; both the program and the
reference are handed them.

Weights are drawn on the device in one call a model (a unit normal of the
model's size, cut into its leaves and scaled by kind); images and noise are
host arrays, as the scoring CLI reads them."""

from __future__ import annotations

import math
import re
from typing import Dict, Sequence

import numpy as np
import torch


def substream(seed: int, *tags: int) -> int:
    """A 63-bit seed for the stream `tags` of `seed`."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(2, np.uint32)
               .astype(np.uint64).view(np.uint64)[0] & np.uint64(2**63 - 1))


_UPSAMPLER = re.compile(r"decoder\.blocks\.[1-9][0-9]*\.conv\.weight")


def _scale(name: str, shape: tuple, kind: str, last: bool) -> tuple:
    """(std, mean) of a leaf. UNet: fan-in-scaled kernels, GroupNorm scales
    near 1, small biases. VQ-VAE: He-scaled kernels (a stride-2 transposed
    convolution's fan-in is the taps one output sees), the last layer's
    output centred in [0, 1], a unit-normal codebook."""
    if kind == "unet":
        if len(shape) > 1:
            return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
        return (0.1, 1.0) if name.endswith("weight") else (0.1, 0.0)
    if name.startswith("quantizer."):
        return (0.0, 0.0) if name.endswith("ema_cluster_size") else (1.0, 0.0)
    if len(shape) == 1:
        return (0.0, 0.5) if last else (0.02, 0.0)
    if _UPSAMPLER.fullmatch(name):
        fan = shape[0] * math.prod(shape[2:]) / 2 ** (len(shape) - 2)
        return (0.25 if last else math.sqrt(2.0)) / math.sqrt(fan), 0.0
    return math.sqrt(2.0 / math.prod(shape[1:])), 0.0


def make_weights(shapes: Dict[str, tuple], kind: str, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 leaves of `shapes` ("unet" or "vqvae" rules) from one draw on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    last_decoder = [k for k in shapes if k.startswith("decoder.")][-2:] if kind == "vqvae" else []
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        std, mean = _scale(name, shape, kind, name in last_decoder)
        out[name] = (flat[at:at + n] * std + mean).view(shape)
        at += n
    if kind == "vqvae":
        out["quantizer.quantizer.ema_w"] = out["quantizer.quantizer.embedding.weight"].clone()
    return out


def images(shape: Sequence[int], seed: int, index: int) -> np.ndarray:
    """(B, *spatial, 1) float32 in [0, 1]: per image a sum of one random
    sinusoid along each axis."""
    rng = np.random.default_rng([int(seed), 1, int(index)])
    b, spatial = int(shape[0]), tuple(int(s) for s in shape[1:-1])
    out = np.full((b,) + spatial, 0.5, np.float32)
    for ax, n in enumerate(spatial):
        freq = rng.uniform(0.5, 3.0, (b, 1)) * 2 * np.pi / n
        phase = rng.uniform(0, 2 * np.pi, (b, 1))
        wave = (0.4 / len(spatial)) * np.sin(freq * np.arange(n)[None] + phase)
        view = [b] + [1] * len(spatial)
        view[1 + ax] = n
        out += wave.reshape(view).astype(np.float32)
    return np.clip(out, 0.0, 1.0)[..., None]


class HostNoise:
    """The program's host noise function: the j-th call draws a unit normal
    from stream (seed, 2, j); ``draw(j, shape)`` gives it again."""

    def __init__(self, seed: int):
        self.seed, self.calls = int(seed), 0

    def draw(self, j: int, shape) -> np.ndarray:
        return np.random.default_rng([self.seed, 2, int(j)]).standard_normal(
            tuple(shape), dtype=np.float32)

    def __call__(self, shape, t_starts) -> np.ndarray:
        j, self.calls = self.calls, self.calls + 1
        return self.draw(j, shape)


def lpips_npz(path, seed: int) -> str:
    """LPIPS weights in the npz key schema the port reads
    (``params/net/conv*/kernel`` HWIO, ``params/lin*`` (C, 1))."""
    rng = np.random.default_rng([int(seed), 3])
    convs = (("conv0", 3, 64, 11), ("conv3", 64, 192, 5), ("conv6", 192, 384, 3),
             ("conv8", 384, 256, 3), ("conv10", 256, 256, 3))
    arrays = {}
    for name, cin, cout, k in convs:
        arrays[f"params/net/{name}/kernel"] = (
            rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
        arrays[f"params/net/{name}/bias"] = (0.01 * rng.standard_normal(cout)).astype(np.float32)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        arrays[f"params/lin{i}"] = (rng.standard_normal((c, 1)) / np.sqrt(c)).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)
