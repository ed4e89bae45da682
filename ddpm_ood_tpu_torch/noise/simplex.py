"""Structured (simplex-family) noise for diffusion training and scoring.

Port of ``ddpm_ood_tpu/noise/simplex.py``, the reference's AnoDDPM-style
``--simplex_noise`` option:

  - ``Simplex`` holds one OpenSimplex seed. ``newSeed()`` draws it from
    numpy's global RNG, ``np.random.randint(-1e10, 1e10)``, as the reference
    does, so a run's noise is fixed by ``np.random.seed`` and by the order of
    the draws. Its fractal compositions run in the host library
    (``noise/_native.py``).
  - ``generate_simplex_noise`` draws one freshly seeded z = t plane per
    (channel, batch item), channel outermost, and returns channel-last
    (B, *spatial, C) float32 noise; a 3D volume gets its last-two-axes plane
    broadcast over the leading axis. The batched path draws the seeds in the
    same order and renders every plane in one OpenMP call, bit-identical to
    the serial loop.
  - ``simplex_noise_device`` is the on-device alternative
    (``--simplex_noise_mode=device``): multi-octave gradient noise from a
    counter-based hash, standardised per sample. It is not OpenSimplex and
    not bit-exact to the host path. Its per-lane ``seed0`` comes from the
    caller's ``torch.Generator`` (the JAX package draws it from a PRNG key).
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
import torch

from . import _native


class Simplex:
    """Host-side OpenSimplex fractal noise source."""

    def __init__(self, seed: Optional[int] = None):
        self.newSeed(seed)

    def newSeed(self, seed: Optional[int] = None) -> None:
        if seed is None:
            # the reference's np.random.randint(-1e10, 1e10), on the global RNG
            seed = int(np.random.randint(-10000000000, 10000000000))
        self.seed = int(seed)

    def rand_3d_fixed_T_octaves(self, shape: Sequence[int], T, octaves: int = 1,
                                persistence: float = 0.5, frequency: float = 32) -> np.ndarray:
        """(1, H, W) fractal noise on the z = T plane."""
        t = float(np.asarray(T).reshape(-1)[0])
        return _native.noise3_fixed_t_grid(self.seed, t, shape, octaves, persistence,
                                           frequency)[None]

    def rand_2d_octaves(self, shape: Sequence[int], octaves: int = 1,
                        persistence: float = 0.5, frequency: float = 32) -> np.ndarray:
        return _native.noise2_grid(self.seed, shape, octaves, persistence, frequency)

    def rand_3d_octaves(self, shape: Sequence[int], octaves: int = 1,
                        persistence: float = 0.5, frequency: float = 32) -> np.ndarray:
        return _native.noise3_grid(self.seed, shape, octaves, persistence, frequency)


# the reference's random_param table of (octaves, persistence, frequency),
# drawn with python's `random`
_RANDOM_PARAMS = [
    (2, 0.6, 16), (6, 0.6, 32), (7, 0.7, 32), (10, 0.8, 64), (5, 0.8, 16),
    (4, 0.6, 16), (1, 0.6, 64), (7, 0.8, 128), (6, 0.9, 64), (2, 0.85, 128),
    (2, 0.85, 64), (2, 0.85, 32), (2, 0.85, 16), (2, 0.85, 8), (2, 0.85, 4),
    (2, 0.85, 2), (1, 0.85, 128), (1, 0.85, 64), (1, 0.85, 32), (1, 0.85, 16),
    (1, 0.85, 8), (1, 0.85, 4), (1, 0.85, 2),
]


def generate_simplex_noise(simplex: Simplex, x_shape: Sequence[int], t, random_param: bool = False,
                           octave: int = 6, persistence: float = 0.8,
                           frequency: float = 64) -> np.ndarray:
    """Per-(item, channel) reseeded fixed-t planes of x_shape (B, *spatial, C),
    float32; t is (B,). The seeds come from the global numpy RNG in
    (channel, batch item) order."""
    b, c = int(x_shape[0]), int(x_shape[-1])
    spatial = tuple(int(s) for s in x_shape[1:-1])
    plane = spatial[-2:]  # 3D volumes: the last two axes, broadcast over the first
    t = np.asarray(t).reshape(-1)
    noise = np.empty((b,) + spatial + (c,), dtype=np.float32)

    if not random_param and b * c > 1:
        seeds = np.empty(c * b, dtype=np.int64)
        ts = np.empty(c * b, dtype=np.float64)
        for i in range(c):
            for j in range(b):
                simplex.newSeed()
                seeds[i * b + j] = simplex.seed
                ts[i * b + j] = float(t[j])
        planes = _native.noise3_fixed_t_grid_batch(seeds, ts, plane, octave, persistence,
                                                   frequency).astype(np.float32)
        for i in range(c):
            for j in range(b):
                noise[j, ..., i] = np.broadcast_to(planes[i * b + j], spatial)
        return noise

    for i in range(c):
        for j in range(b):
            simplex.newSeed()
            if random_param:
                octave, persistence, frequency = random.choice(_RANDOM_PARAMS)
            plane_noise = simplex.rand_3d_fixed_T_octaves(plane, t[j], octave, persistence,
                                                          frequency)[0].astype(np.float32)
            noise[j, ..., i] = np.broadcast_to(plane_noise, spatial)
    return noise


# ---------------------------------------------------------------------------
# On-device path: counter-based multi-octave gradient noise
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
# the 12 Perlin gradient directions (edges of a cube)
_GRADS = ((1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0), (1, 0, 1), (-1, 0, 1), (1, 0, -1),
          (-1, 0, -1), (0, 1, 1), (0, -1, 1), (0, 1, -1), (0, -1, -1))


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a uint32 constant c,
    without an int64 overflow: a's two 16-bit halves multiply apart."""
    hi, lo = a >> 16, a & 0xFFFF
    return ((((hi * c) & _U32) << 16) + lo * c) & _U32


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
           seed: torch.Tensor) -> torch.Tensor:
    """The JAX package's uint32 lattice hash (murmur3 finaliser style), in
    int64 tensors that hold uint32 values."""
    h = (_mul_u32(ix & _U32, 0x8DA6B343) ^ _mul_u32(iy & _U32, 0xD8163841)
         ^ _mul_u32(iz & _U32, 0xCB1AB31F) ^ (seed & _U32))
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _gradient_noise3(p: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Gradient lattice noise at points p (..., 3) float32, seed broadcast
    against p[..., 0]; quintic fade, trilinear blend."""
    grads = torch.tensor(_GRADS, dtype=torch.float32, device=p.device)
    pi = torch.floor(p)
    pf = p - pi
    pi = pi.to(torch.int64)

    def corner(dx, dy, dz):
        h = _hash3(pi[..., 0] + dx, pi[..., 1] + dy, pi[..., 2] + dz, seed) % 12
        off = torch.tensor((dx, dy, dz), dtype=torch.float32, device=p.device)
        return torch.sum(grads[h] * (pf - off), dim=-1)

    u = pf * pf * pf * (pf * (pf * 6.0 - 15.0) + 10.0)

    def lerp(a, b, w):
        return a + w * (b - a)

    x00 = lerp(corner(0, 0, 0), corner(1, 0, 0), u[..., 0])
    x10 = lerp(corner(0, 1, 0), corner(1, 1, 0), u[..., 0])
    x01 = lerp(corner(0, 0, 1), corner(1, 0, 1), u[..., 0])
    x11 = lerp(corner(0, 1, 1), corner(1, 1, 1), u[..., 0])
    return lerp(lerp(x00, x10, u[..., 1]), lerp(x01, x11, u[..., 1]), u[..., 2])


def fractal_planes(seed: torch.Tensor, tz: torch.Tensor, plane: Sequence[int], octaves: int,
                   persistence: float, frequency: float) -> torch.Tensor:
    """(N, H, W) float32: plane n sums `octaves` octaves of gradient noise at
    (x, y, z) = (column, row, tz[n]) / freq, freq halving and the amplitude
    falling by `persistence` each octave, octave o hashed with seed[n] + o
    (the JAX package's ``one_plane``, before standardisation)."""
    h, w = (int(s) for s in plane)
    n, device = seed.shape[0], seed.device
    seed, tz = seed.reshape(n, 1, 1), tz.to(torch.float32).reshape(n, 1, 1)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    total = torch.zeros((n, h, w), dtype=torch.float32, device=device)
    freq, amp = float(frequency), 1.0
    for o in range(octaves):
        gy, gx = torch.meshgrid(ys / freq, xs / freq, indexing="ij")
        p = torch.stack([gx.expand(n, h, w), gy.expand(n, h, w), (tz / freq).expand(n, h, w)],
                        dim=-1)
        total = total + amp * _gradient_noise3(p, (seed + o) & _U32)
        freq /= 2.0
        amp *= persistence
    return total


def simplex_noise_device(seed0, shape: Sequence[int], t, octaves: int = 6,
                         persistence: float = 0.8, frequency: float = 64.0,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """Multi-octave structured noise of `shape` (B, *spatial, C), made on the
    device, standardised per sample so that it can stand in for N(0, 1).

    seed0: an int or an int tensor of shape L (a stack of lanes, e.g. (K,));
    t: (B,) or L + (B,) timesteps picking each item's z-plane. Item j and
    channel i hash with seed0 + 7919 j + 104729 i (mod 2^32), the JAX
    package's decorrelation. Returns float32 of L + shape; a 3D volume gets
    its last-two-axes plane broadcast over the leading axis."""
    shape = tuple(int(s) for s in shape)
    b, c, spatial = shape[0], shape[-1], shape[1:-1]
    if len(spatial) < 2:
        raise ValueError(f"simplex_noise_device needs 2 or 3 spatial axes, got shape {shape}")
    h, w = spatial[-2:]
    if device is None:
        device = seed0.device if isinstance(seed0, torch.Tensor) else torch.device("cpu")
    seed0 = torch.as_tensor(seed0, dtype=torch.int64, device=device)
    lead = tuple(seed0.shape)
    t = torch.as_tensor(t, device=device).to(torch.int64).expand(lead + (b,))
    j = torch.arange(b, dtype=torch.int64, device=device)
    i = torch.arange(c, dtype=torch.int64, device=device)
    seed = (seed0[..., None, None] + 7919 * j[:, None] + 104729 * i[None, :]) & _U32  # L+(B, C)
    tz = t.to(torch.float32)[..., :, None].expand(seed.shape)
    total = fractal_planes(seed.reshape(-1), tz.reshape(-1), (h, w), octaves, persistence,
                           frequency)
    planes = total.reshape(lead + (b, c, h, w)).movedim(len(lead) + 1, -1)  # L+(B, H, W, C)
    if len(spatial) > 2:
        planes = planes.reshape(lead + (b,) + (1,) * (len(spatial) - 2) + (h, w, c))
        planes = planes.expand(lead + shape)
    axes = tuple(range(len(lead) + 1, planes.dim()))
    mean = planes.mean(dim=axes, keepdim=True)
    std = planes.std(dim=axes, keepdim=True, correction=0)
    return (planes - mean) / (std + 1e-8)
