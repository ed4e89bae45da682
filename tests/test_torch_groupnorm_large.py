"""The large-sample GroupNorm forward (csrc/groupnorm.cu): its plan, its dispatch, its sum order.

Plan and dispatch: ``ops/groupnorm.py:kernel_for`` gives every sample over 8
blocks' shared memory (``chip_smoke.GN_LARGE``: the 3D small UNet's level 0
on 20x20x16 latents, the 2D one at 64x64), x off a 16-byte boundary and rows
that are not whole 16-byte vectors (``chip_smoke.GN_EDGE``) to the
large-sample kernel, on the widest loads the row and the address allow. With
a stand-in for the ctypes library (the CPU tests have no card) each reaches
``ddpm_groupnorm_act`` with the arguments ``_kernels.SIGNATURES`` declares
and a work buffer of B arrival counters and B x tiles x 2G partials.
``large_plan`` keeps each sample's tiles within MAX_TILES and every block
within its share of an SM's shared memory.

Sum order: the CUDA kernel runs only on the card, so ``_emulate_large``
repeats its fp32 sums here in numpy, in the kernel's order: per channel over
each thread's row lane of a tile, over the lanes in lane order, per group
channel by channel, over the sample's tiles in tile order; then
var = E[x^2] - mean^2 and the affine. It is held to the JAX
``_xla_reference`` at atol 2e-5 (the fp32 tolerance of
tests/test_torch_groupnorm.py: both keep fp32 statistics by the same formula,
only the order of the sums differs) at C/G = 4, 8, 12 and 16, for every load
width (row lanes from 256 / vectors a row, one lane where a row has more
vectors than a block has threads), with tiles that leave the last one short,
and at the real plans of the level-0 shapes for one sample.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddpm_ood_tpu.ops.groupnorm import _xla_reference
from ddpm_ood_tpu_torch.ops import _kernels
from ddpm_ood_tpu_torch.ops import groupnorm as gn_mod
# the stand-in library (fixture `lib`) and the ctypes argument check
from test_torch_attention_tc import STREAM, _assert_signature, lib  # noqa: F401

ATOL = 2e-5
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# (B, N, C, G, element offset of x, {dtype: load bytes, None for the cluster kernel})
CASES = ([(b, n, c, 32, 0, {"bf16": 16, "fp32": 16}) for b, n, c in chip_smoke.GN_LARGE]
         + [edge[1:] for edge in chip_smoke.GN_EDGE])
IDS = [f"{b}x{n}x{c}" for b, n, c in chip_smoke.GN_LARGE] + [e[0] for e in chip_smoke.GN_EDGE]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters():
    fn = gn_mod.groupnorm_act
    return fn.launches, fn.cluster_launches, fn.large_launches


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_large_and_edge_shapes_reach_the_large_kernel(lib, monkeypatch, case, dtype):
    b, n, c, g, offset, want = case
    vec_bytes, dtype = want[dtype], DTYPES[dtype]
    itemsize = torch.finfo(dtype).bits // 8
    x = torch.empty(b * n * c + offset, dtype=dtype)[offset:].view(b, n, c)
    gamma, beta = torch.ones(c), torch.zeros(c)
    works, empty = [], torch.empty

    def spy(*shape, **kw):  # the work buffer the wrapper allocates
        t = empty(*shape, **kw)
        if kw.get("dtype") == torch.int32:
            works.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy)
    before = _counters()
    out = gn_mod._launch(x, gamma, beta, g, 1e-6, "silu")
    moved = tuple(a - b0 for a, b0 in zip(_counters(), before))
    assert out.shape == x.shape and out.dtype == dtype
    if vec_bytes is None:  # fp32's 144-byte rows: whole vectors, the cluster kernel's
        assert moved == (1, 1, 0)
        assert [name for name, _ in lib.calls] == ["ddpm_groupnorm_act_cluster"]
        return
    assert moved == (1, 0, 1)
    assert [name for name, _ in lib.calls] == ["ddpm_groupnorm_act"]
    args = lib.calls[0][1]
    _assert_signature("ddpm_groupnorm_act", args)
    kernel, plan = gn_mod.kernel_for(n, c, g, itemsize, x.data_ptr())
    assert kernel == "large" and plan == gn_mod.large_plan(n, c, g, itemsize, vec_bytes)
    (work,) = works
    assert work.numel() == b + b * plan.tiles * 2 * g
    assert args == (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                    work.data_ptr(), b, n, c, g, 1e-6, 1, _kernels.DTYPE_CODES[dtype],
                    vec_bytes, plan.rows, plan.resident, plan.smem, 0, STREAM)
    if (b, n, c) in chip_smoke.GN_LARGE:  # every main-path sample lives in shared memory
        assert plan.resident == 1


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,c,g", [(6400, 384, 32), (6400, 256, 32), (4096, 256, 32),
                                   (4096, 384, 32), (6400, 128, 32), (2000, 33, 3),
                                   (16384, 384, 32), (1, 4104, 8)])
def test_large_plan_fits_the_card(n, c, g, itemsize):
    vec_bytes = gn_mod.large_vector_bytes(c, itemsize, 0)
    plan = gn_mod.large_plan(n, c, g, itemsize, vec_bytes)
    budget = gn_mod.BLOCK_MAX_SHARED_BYTES  # one block to an SM
    assert plan.smem <= budget
    assert 1 <= plan.tiles <= gn_mod.MAX_TILES
    assert (plan.tiles - 1) * plan.rows < n <= plan.tiles * plan.rows  # no empty tile
    assert plan.threads <= gn_mod.MAX_THREADS and plan.threads % min(c * itemsize // vec_bytes,
                                                                      256) == 0
    assert (plan.threads, plan.tiles, plan.smem) == gn_mod.large_layout(
        n, c, g, itemsize, vec_bytes, plan.rows, bool(plan.resident))
    # the fewest tiles: one fewer would not fit (when it is not streamed)
    if plan.resident and plan.tiles > 1:
        rows = -(-n // (plan.tiles - 1))
        assert gn_mod.large_layout(n, c, g, itemsize, vec_bytes, rows, True)[2] > budget


def test_large_plan_of_the_3d_level_0_sample():
    """(6400, 384) bf16, worked by hand: 240 threads (48 vectors x 5 lanes);
    one block to an SM may take 232,448 bytes; 23 tiles of 279 rows need
    16 + 214,272 + 15,360 + 48 x 128 = 235,792 bytes, 24 of 267 need
    226,832."""
    want = gn_mod.LargePlan(16, 267, 24, 1, 240, 226_832)
    assert gn_mod.large_plan(6400, 384, 32, 2) == want


@pytest.mark.parametrize("c,itemsize,address,want", [
    (384, 2, 0, 16), (384, 2, 2, 2), (384, 4, 4, 4), (384, 2, 8, 8), (36, 2, 0, 8),
    (33, 2, 0, 2), (33, 4, 0, 4), (36, 4, 0, 16), (6, 2, 0, 4)])
def test_large_vector_bytes(c, itemsize, address, want):
    assert gn_mod.large_vector_bytes(c, itemsize, address) == want


def test_no_cuda_no_launch():
    """A CPU tensor takes the plain version and moves no counter."""
    x = torch.randn(2, 64, 32)
    before = _counters()
    gn_mod.groupnorm_act(x, torch.ones(32), torch.zeros(32), 4)
    assert _counters() == before


# --- the kernel's sum order, emulated on the CPU -------------------------------------------

def _emulate_large(x, gamma, beta, groups, eps, act, rows, lanes):
    """csrc/groupnorm.cu's fp32 arithmetic in its order, in numpy, for x
    (B, N, C) fp32, tiles of `rows` rows and `lanes` row lanes."""
    b, n, c = x.shape
    cpg = c // groups
    tiles = -(-n // rows)
    parts = np.zeros((tiles, 2, b, groups), np.float32)
    for t in range(tiles):
        xt = x[:, t * rows:(t + 1) * rows]
        # each thread: its row lane, in row order (a sequential fp32 scan; the
        # zero rows that pad the last pass leave every sum as it was)
        k = -(-xt.shape[1] // lanes)
        xt = np.pad(xt, ((0, 0), (0, k * lanes - xt.shape[1]), (0, 0))).reshape(b, k, lanes, c)
        s1 = np.add.accumulate(xt, axis=1)[:, -1]
        s2 = np.add.accumulate(xt * xt, axis=1)[:, -1]
        c1 = np.zeros((b, c), np.float32)
        c2 = np.zeros((b, c), np.float32)
        for lane in range(lanes):  # the lanes, in lane order
            c1 += s1[:, lane]
            c2 += s2[:, lane]
        for i in range(cpg):  # the group, channel by channel
            parts[t, 0] += c1.reshape(b, groups, cpg)[..., i]
            parts[t, 1] += c2.reshape(b, groups, cpg)[..., i]
    g1 = np.zeros((b, groups), np.float32)
    g2 = np.zeros((b, groups), np.float32)
    for t in range(tiles):  # the sample's tiles, in tile order
        g1 += parts[t, 0]
        g2 += parts[t, 1]
    inv_count = np.float32(1.0) / np.float32(n * cpg)
    mean = g1 * inv_count
    rstd = np.float32(1.0) / np.sqrt(g2 * inv_count - mean * mean + np.float32(eps))
    mu = np.repeat(mean, cpg, axis=1)[:, None]
    rs = np.repeat(rstd, cpg, axis=1)[:, None]
    y = (x - mu) * rs * gamma + beta
    if act == "silu":
        y = y / (np.float32(1.0) + np.exp(-y))
    return y


def _hold_to_jax(x, gamma, beta, groups, rows, lanes):
    for act in ("none", "silu"):
        got = _emulate_large(x, gamma, beta, groups, 1e-6, act, rows, lanes)
        want = _xla_reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups,
                              1e-6, act)
        assert math.isfinite(float(np.abs(got).max()))
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=act)


def _draw(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("rows", [7, 50], ids=["8_tiles_last_short", "one_tile"])
@pytest.mark.parametrize("vec_bytes,itemsize", [(16, 2), (16, 4), (8, 2), (4, 4), (2, 2)],
                         ids=["bf16x8", "fp32x4", "bf16x4", "fp32x1", "bf16x1"])
@pytest.mark.parametrize("cpg", [4, 8, 12, 16])
def test_large_sum_order_matches_jax(cpg, vec_bytes, itemsize, rows):
    groups = 4
    c = groups * cpg
    threads, _, _ = gn_mod.large_layout(50, c, groups, itemsize, vec_bytes, rows, True)
    lanes = threads // min(c * itemsize // vec_bytes, gn_mod.MAX_THREADS)
    x, gamma, beta = _draw(cpg + vec_bytes, (2, 50, c))
    _hold_to_jax(x, gamma, beta, groups, rows, lanes)


def test_large_sum_order_one_lane_past_256_vectors():
    """264 channels on 2-byte loads: more vectors than threads, so each
    thread takes two of a row and the block has one row lane."""
    threads, _, _ = gn_mod.large_layout(40, 264, 8, 2, 2, 6, True)
    assert threads == 256
    x, gamma, beta = _draw(3, (1, 40, 264))
    _hold_to_jax(x, gamma, beta, 8, 6, 1)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", [384, 256])
def test_large_sum_order_at_the_level_0_plan(c, itemsize):
    """One sample of the 3D level-0 shape, at the tiles and lanes its plan
    gives on the card."""
    plan = gn_mod.large_plan(6400, c, 32, itemsize)
    lanes = plan.threads // (c * itemsize // 16)
    x, gamma, beta = _draw(c + itemsize, (1, 6400, c))
    _hold_to_jax(x, gamma, beta, 32, plan.rows, lanes)
