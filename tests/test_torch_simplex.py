"""The port's simplex noise against the JAX package's, on the CPU.

- The OpenSimplex library: the port builds its own copy of
  ``csrc/opensimplex.cpp`` with g++; its permutation tables and its planes
  (fixed-t, 2D, 3D) equal the JAX package's library's bit for bit.
- ``generate_simplex_noise`` after one ``np.random.seed``: the port's
  batched path equals the JAX function and a serial loop of freshly seeded
  planes in (channel, batch item) order, bit for bit, in 2D and 3D
  (the last-two-axes plane broadcast), and leaves numpy's global RNG where
  the JAX function leaves it; the one-plane path (B * C = 1) too.
- ``simplex_noise_device`` for the seed0 that JAX's draws from its key:
  its planes before standardisation against the JAX function's own
  composition (``one_plane`` per item and channel, octave by octave), atol
  1e-6 (both fp32 programs of the same arithmetic; equal on this CPU); the
  standardised noise against JAX's planes standardised in float64, atol
  1e-6, and against the JAX function's output, atol 2e-6 (JAX's own fp32
  mean and std differ from float64 by up to 1.4e-6 at 32x32); in 2D and
  3D. The lattice hash equal, integer for integer; a stack of lanes equal
  to one call per lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.noise import _native as jax_native
from ddpm_ood_tpu.noise import simplex as jax_simplex
from ddpm_ood_tpu_torch.noise import _native
from ddpm_ood_tpu_torch.noise import simplex
from ddpm_ood_tpu_torch.noise.simplex import (Simplex, _hash3, _mul_u32, fractal_planes,
                                              generate_simplex_noise, simplex_noise_device)

DEVICE_ATOL = 1e-6  # planes, and the port's standardisation against float64's
JAX_STD_ATOL = 2e-6  # against JAX's output, whose fp32 standardisation is off by 1.4e-6
SEEDS = (0, 1, 12345, -987654321, 9999999999, -10000000000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_builds_its_own_library():
    lib = _native.library()
    assert _native.LIB_PATH.is_file() and _native.LIB_PATH.parent.name == "_build"
    assert _native.SRC.read_bytes() == (
        jax_native._SRC.read_bytes())  # the port's copy of the source, byte for byte
    assert lib is _native.library()


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_tables_equal_jax(seed):
    for got, want in zip(_native.perm_tables(seed), jax_native.perm_tables(seed)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_planes_equal_jax(seed):
    got = _native.noise3_fixed_t_grid(seed, 417.0, (12, 20), 6, 0.8, 64)
    want = jax_native.noise3_fixed_t_grid(seed, 417.0, (12, 20), 6, 0.8, 64)
    assert got.tobytes() == want.tobytes()
    got = _native.noise2_grid(seed, (9, 7), 3, 0.5, 16)
    assert got.tobytes() == jax_native.noise2_grid(seed, (9, 7), 3, 0.5, 16).tobytes()
    got = _native.noise3_grid(seed, (4, 6, 5), 2, 0.6, 8)
    assert got.tobytes() == jax_native.noise3_grid(seed, (4, 6, 5), 2, 0.6, 8).tobytes()
    seeds, ts = np.array([seed, seed + 7, -seed - 3]), np.array([0.0, 500.0, 999.0])
    batch = _native.noise3_fixed_t_grid_batch(seeds, ts, (12, 20), 6, 0.8, 64)
    for k in range(3):  # the batched call equals one call per plane
        one = _native.noise3_fixed_t_grid(seeds[k], ts[k], (12, 20), 6, 0.8, 64)
        assert batch[k].tobytes() == one.tobytes()


def _serial_reference(shape, t) -> np.ndarray:
    """A freshly seeded plane per (channel, item), channel outermost."""
    b, c, spatial = shape[0], shape[-1], shape[1:-1]
    out = np.empty(shape, np.float32)
    s = Simplex()
    for i in range(c):
        for j in range(b):
            s.newSeed()
            plane = s.rand_3d_fixed_T_octaves(spatial[-2:], t[j], 6, 0.8, 64)[0]
            out[j, ..., i] = np.broadcast_to(plane.astype(np.float32), spatial)
    return out


@pytest.mark.parametrize("shape", [(3, 16, 16, 2), (2, 4, 8, 8, 3), (1, 16, 12, 1),
                                   (4, 8, 8, 1)], ids=["2d", "3d", "one_plane", "2d_gray"])
def test_generate_simplex_noise_equals_jax_and_the_serial_loop(shape):
    t = (np.arange(shape[0]) * 331 + 7) % 1000
    np.random.seed(11)
    jax_simplex.Simplex()  # each package's constructor draws one seed first
    want = jax_simplex.generate_simplex_noise(jax_simplex.Simplex(), shape, t)
    jax_state = np.random.get_state()[1].copy()
    np.random.seed(11)
    Simplex()
    got = generate_simplex_noise(Simplex(), shape, t)
    assert (np.random.get_state()[1] == jax_state).all()  # as many draws, in order
    np.random.seed(11)
    Simplex()
    serial = _serial_reference(shape, t)
    assert got.dtype == np.float32 and got.shape == tuple(shape)
    assert got.tobytes() == want.tobytes() == serial.tobytes()
    assert np.isfinite(got).all() and got.std() > 0.05


def test_random_param_draws_as_jax():
    import random

    shape, t = (2, 8, 8, 1), np.array([3, 900])
    random.seed(0)
    np.random.seed(2)
    want = jax_simplex.generate_simplex_noise(jax_simplex.Simplex(), shape, t, random_param=True)
    random.seed(0)
    np.random.seed(2)
    got = generate_simplex_noise(Simplex(), shape, t, random_param=True)
    assert got.tobytes() == want.tobytes()


def test_mul_u32_is_the_uint32_product():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=10000, dtype=np.uint64)
    for c in (0x8DA6B343, 0xD8163841, 0xCB1AB31F, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        want = (a * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = _mul_u32(torch.from_numpy(a.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_lattice_hash_equals_jax():
    rng = np.random.default_rng(1)
    ix, iy, iz = (rng.integers(-2**31, 2**31, size=4096).astype(np.int32) for _ in range(3))
    for seed in (0, 7919, 4000000000):
        want = np.asarray(jax_simplex._hash3(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz),
                                             jnp.uint32(seed)))
        got = _hash3(*(torch.from_numpy(a.astype(np.int64)) for a in (ix, iy, iz)),
                     torch.tensor(seed))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert ((got % 12).numpy() == want % 12).all()


def _jax_seed0(key) -> int:
    """The seed0 JAX's simplex_noise_device draws from `key`."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1, dtype=jnp.int32))


def _jax_planes(seed0: int, shape, t) -> np.ndarray:
    """(B, C, H, W) planes of JAX's simplex_noise_device before
    standardisation: its one_plane composition, in JAX."""
    b, c, (h, w) = shape[0], shape[-1], shape[-3:-1]
    ys, xs = jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32)
    out = np.empty((b, c, h, w), np.float32)
    for j in range(b):
        for i in range(c):
            seed = (jnp.uint32(seed0) + jnp.uint32(j) * jnp.uint32(7919)
                    + jnp.uint32(i) * jnp.uint32(104729))
            total, freq, amp = jnp.zeros((h, w), jnp.float32), 64.0, 1.0
            for o in range(6):
                gy, gx = jnp.meshgrid(ys / freq, xs / freq, indexing="ij")
                gz = jnp.full_like(gy, jnp.float32(t[j]) / freq)
                p = jnp.stack([gx, gy, gz], axis=-1)
                total = total + amp * jax_simplex._gradient_noise3(p, seed + jnp.uint32(o))
                freq, amp = freq / 2.0, amp * 0.8
            out[j, i] = np.asarray(total)
    return out


@pytest.mark.parametrize("shape", [(3, 16, 16, 2), (2, 4, 8, 8, 3), (2, 32, 32, 1)],
                         ids=["2d", "3d", "2d_32"])
def test_device_noise_matches_jax(shape):
    key = jax.random.PRNGKey(shape[1])
    t = np.array([5, 999, 431])[:shape[0]]
    b, c, spatial = shape[0], shape[-1], shape[1:-1]
    seed0 = _jax_seed0(key)
    want_planes = _jax_planes(seed0, shape, t)
    seeds = torch.tensor([(seed0 + 7919 * j + 104729 * i) & 0xFFFFFFFF
                          for j in range(b) for i in range(c)])
    planes = fractal_planes(seeds, torch.as_tensor(t).repeat_interleave(c), spatial[-2:], 6,
                            0.8, 64.0)
    np.testing.assert_allclose(planes.numpy().reshape(want_planes.shape), want_planes,
                               atol=DEVICE_ATOL, rtol=0)

    got = simplex_noise_device(seed0, shape, torch.as_tensor(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    p64 = np.broadcast_to(np.moveaxis(want_planes, 1, -1).reshape(
        (b,) + (1,) * (len(spatial) - 2) + want_planes.shape[2:] + (c,)), shape).astype(np.float64)
    axes = tuple(range(1, len(shape)))
    f64 = (p64 - p64.mean(axis=axes, keepdims=True)) / (p64.std(axis=axes, keepdims=True) + 1e-8)
    np.testing.assert_allclose(got.numpy(), f64, atol=DEVICE_ATOL, rtol=0)
    want = np.asarray(jax.jit(jax_simplex.simplex_noise_device, static_argnums=1)(
        key, tuple(shape), jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_STD_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy().mean(axis=axes), 0.0, atol=1e-5)
    np.testing.assert_allclose(got.numpy().std(axis=axes), 1.0, atol=1e-5)


def test_device_noise_stacks_lanes():
    seeds = torch.tensor([17, 2**31 - 2, 123456])
    t = torch.tensor([[10, 10], [400, 400], [990, 990]])
    stacked = simplex_noise_device(seeds, (2, 8, 8, 3), t)
    assert tuple(stacked.shape) == (3, 2, 8, 8, 3)
    for k in range(3):
        torch.testing.assert_close(stacked[k], simplex_noise_device(int(seeds[k]), (2, 8, 8, 3),
                                                                     t[k]), atol=0, rtol=0)
    assert not torch.equal(stacked[0], stacked[1])


def test_device_noise_refuses_one_spatial_axis():
    with pytest.raises(ValueError, match="spatial"):
        simplex_noise_device(0, (2, 16, 1), torch.tensor([1, 2]))


def test_module_imports_no_jax():
    assert "jax" not in simplex.__dict__ and "jax" not in _native.__dict__
