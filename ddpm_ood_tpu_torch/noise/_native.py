"""ctypes binding of the OpenSimplex host library (``csrc/opensimplex.cpp``).

The library is the C++/OpenMP rebuild of the reference's numba kernels, bit
for bit, including its int64-LCG permutation init. ``library()`` builds it
with g++ on first use (``utils/native_build.py``) and raises
``NativeBuildError`` when it cannot. Each wrapper checks its arguments
before it hands native code a pointer.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from ..utils.native_build import NativeBuildError, build_and_load

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "csrc" / "opensimplex.cpp"
LIB_PATH = PKG_DIR / "_build" / "libopensimplex.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The bound library, built on first use."""
    try:
        lib = build_and_load(SRC, LIB_PATH)
    except NativeBuildError as e:
        raise NativeBuildError(
            f"the OpenSimplex library that exact simplex noise needs did not build: {e}\n"
            "--simplex_noise_mode=device draws the on-device noise instead") from e
    i64, f64 = ctypes.c_int64, ctypes.c_double
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    sptr = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    signatures = {
        "opensimplex3_fixed_t_grid": [i64, f64, i64, i64, i64, f64, f64, dptr],
        "opensimplex3_fixed_t_grid_batch": [iptr, dptr, i64, i64, i64, i64, f64, f64, dptr],
        "opensimplex3_grid": [i64, i64, i64, i64, i64, f64, f64, dptr],
        "opensimplex2_grid": [i64, i64, i64, i64, f64, f64, dptr],
        "opensimplex_perm": [i64, sptr, sptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _shape(shape, ndim: int) -> tuple:
    shape = tuple(int(s) for s in shape)
    if len(shape) != ndim or min(shape) < 1:
        raise ValueError(f"expected {ndim} positive extents, got {shape}")
    return shape


def noise3_fixed_t_grid(seed: int, t: float, shape, octaves: int, persistence: float,
                        frequency: float) -> np.ndarray:
    """(H, W) fractal noise on the z = t plane, float64."""
    h, w = _shape(shape, 2)
    out = np.empty((h, w), dtype=np.float64)
    library().opensimplex3_fixed_t_grid(int(seed), float(t), h, w, int(octaves),
                                        float(persistence), float(frequency), out)
    return out


def noise3_fixed_t_grid_batch(seeds, ts, shape, octaves: int, persistence: float,
                              frequency: float) -> np.ndarray:
    """(n, H, W): n fixed-t planes in one OpenMP call, bit-identical to n
    ``noise3_fixed_t_grid`` calls with the same (seed, t) pairs."""
    h, w = _shape(shape, 2)
    seeds = np.ascontiguousarray(seeds, dtype=np.int64).reshape(-1)
    ts = np.ascontiguousarray(ts, dtype=np.float64).reshape(-1)
    if seeds.shape != ts.shape:
        raise ValueError(f"{seeds.shape[0]} seeds for {ts.shape[0]} planes")
    out = np.empty((seeds.shape[0], h, w), dtype=np.float64)
    library().opensimplex3_fixed_t_grid_batch(seeds, ts, seeds.shape[0], h, w, int(octaves),
                                              float(persistence), float(frequency), out)
    return out


def noise3_grid(seed: int, shape, octaves: int, persistence: float,
                frequency: float) -> np.ndarray:
    """(D, H, W) 3D fractal noise, float64."""
    d, h, w = _shape(shape, 3)
    out = np.empty((d, h, w), dtype=np.float64)
    library().opensimplex3_grid(int(seed), d, h, w, int(octaves), float(persistence),
                                float(frequency), out)
    return out


def noise2_grid(seed: int, shape, octaves: int, persistence: float,
                frequency: float) -> np.ndarray:
    """(H, W) 2D fractal noise, float64."""
    h, w = _shape(shape, 2)
    out = np.empty((h, w), dtype=np.float64)
    library().opensimplex2_grid(int(seed), h, w, int(octaves), float(persistence),
                                float(frequency), out)
    return out


def perm_tables(seed: int) -> tuple:
    """The (perm, perm_grad3) tables a seed initialises, as int64 arrays."""
    perm = np.empty(256, dtype=np.int16)
    grad3 = np.empty(256, dtype=np.int16)
    library().opensimplex_perm(int(seed), perm, grad3)
    return perm.astype(np.int64), grad3.astype(np.int64)
