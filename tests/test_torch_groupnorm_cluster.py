"""The GroupNorm forward on thread-block clusters: its plan, its dispatch, its sum order.

Plan and dispatch: ``ops/groupnorm.py:cluster_plan`` picks, by shape, the
cluster size S (blocks per sample) and each block's shared memory for
``csrc/groupnorm_cluster.cu``. Every GroupNorm shape of the small UNet's main
paths (``chip_smoke.GN_SHAPES``, at the scoring and training batches, bf16
and fp32) gets a cluster of at most 8 blocks within a block's 227 KB and, with
a stand-in for the ctypes library (the CPU tests have no card), reaches
``ddpm_groupnorm_act_cluster`` with the arguments ``_kernels.SIGNATURES``
declares. A sample over 8 blocks' shared memory reaches the
one-block-per-group ``ddpm_groupnorm_act`` and leaves ``cluster_launches``
where it was.

Sum order: the CUDA kernel runs only on the card, so ``_emulate_cluster``
repeats its fp32 sums here in the kernel's order: per channel over each
thread's row lane, over the lanes in lane order, per group channel by channel,
over the cluster's blocks in rank order; then var = E[x^2] - mean^2 and the
affine. It is held to the JAX ``_xla_reference`` at atol 2e-5 (the fp32
tolerance of tests/test_torch_groupnorm.py: both keep fp32 statistics by the
same formula, only the order of the sums differs) at C/G = 4, 8, 12 and 16,
for the vector widths of both dtypes (8 bf16 or 4 fp32 channels), with a row
count that leaves the cluster's last block short or empty.
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
BATCHES = (64, 128)  # scoring's UNet batch (K x B of a lane group), training's
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _launch(b, n, c, dtype, act="silu", x=None):
    """One ``_launch`` as the autograd Function makes it; x is left
    uninitialised (only its pointer reaches the stand-in)."""
    x = torch.empty((b, n, c), dtype=dtype) if x is None else x
    gamma, beta = torch.ones(c), torch.zeros(c)
    before = (gn_mod.groupnorm_act.launches, gn_mod.groupnorm_act.cluster_launches)
    out = gn_mod._launch(x, gamma, beta, 32, 1e-6, act)
    moved = (gn_mod.groupnorm_act.launches - before[0],
             gn_mod.groupnorm_act.cluster_launches - before[1])
    return x, gamma, beta, out, moved


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,c", chip_smoke.GN_SHAPES, ids=str)
def test_main_path_shapes_reach_the_cluster_kernel(lib, n, c, dtype, b):
    dtype = DTYPES[dtype]
    itemsize = torch.finfo(dtype).bits // 8
    plan = gn_mod.cluster_plan(n, c, 32, itemsize)
    assert plan is not None
    s, smem = plan
    assert s in (1, 2, 4, 8) and smem <= 232_448  # a block's 227 KB
    assert smem == gn_mod.cluster_smem_bytes(n, c, 32, s, itemsize)
    x, gamma, beta, out, moved = _launch(b, n, c, dtype)
    assert moved == (1, 1)
    assert [name for name, _ in lib.calls] == ["ddpm_groupnorm_act_cluster"]
    args = lib.calls[0][1]
    _assert_signature("ddpm_groupnorm_act_cluster", args)
    assert args == (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), b, n, c, 32,
                    1e-6, 1, _kernels.DTYPE_CODES[dtype], s, smem, 0, STREAM)
    assert out.shape == x.shape and out.dtype == dtype


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_oversized_sample_takes_the_per_group_kernel(lib, dtype):
    dtype = DTYPES[dtype]
    (n, c), = chip_smoke.GN_OVERSIZED
    assert gn_mod.cluster_plan(n, c, 32, torch.finfo(dtype).bits // 8) is None
    x, gamma, beta, out, moved = _launch(2, n, c, dtype, act="none")
    assert moved == (1, 0)
    assert [name for name, _ in lib.calls] == ["ddpm_groupnorm_act"]
    args = lib.calls[0][1]
    _assert_signature("ddpm_groupnorm_act", args)
    assert args == (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), 2, n, c, 32,
                    1e-6, 0, _kernels.DTYPE_CODES[dtype], 0, STREAM)


def test_x_off_a_16_byte_boundary_takes_the_per_group_kernel(lib):
    x = torch.empty(64 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 64, 128)
    *_, moved = _launch(1, 64, 128, torch.bfloat16, x=x)
    assert moved == (1, 0)
    assert [name for name, _ in lib.calls] == ["ddpm_groupnorm_act"]


@pytest.mark.parametrize("n,c,itemsize,want", [
    (1024, 384, 2, (8, 114_176)),  # 768 KB a sample: 8 blocks of 96 KB, two to an SM
    (1024, 384, 4, (8, 203_264)),  # 1.5 MB: 8 blocks of 192 KB, one to an SM
    (64, 512, 2, (1, 82_432)),     # 64 KB: one block
    (1024, 128, 2, (4, 82_432)),   # 256 KB: the smallest cluster that fits two to an SM
    (4096, 128, 4, None),          # 2 MB: over 8 blocks' shared memory
    (64, 36, 2, None),             # 72-byte rows: not a whole number of vectors
    (64, 4104, 4, None),           # 1026 vectors a row: over 256 threads
])
def test_cluster_plan(n, c, itemsize, want):
    assert gn_mod.cluster_plan(n, c, 32, itemsize) == want


# --- the kernel's sum order, emulated on the CPU -------------------------------------------

def _emulate_cluster(x, gamma, beta, groups, eps, act, s, itemsize):
    """csrc/groupnorm_cluster.cu's fp32 arithmetic in its order, for x (B, N, C)
    fp32 and a cluster of s blocks whose threads own 16 / itemsize channels."""
    b, n, c = x.shape
    lanes = gn_mod.cluster_lanes(c, itemsize)
    rows = -(-n // s)
    cpg = c // groups
    # rows past n are zeros, which leave every fp32 sum as it was
    xb = torch.zeros((b, s * rows, c))
    xb[:, :n] = x
    k = -(-rows // lanes)
    xb = torch.nn.functional.pad(xb.reshape(b, s, rows, c), (0, 0, 0, k * lanes - rows))
    xb = xb.reshape(b, s, k, lanes, c)
    part1 = torch.zeros((b, s, groups))
    part2 = torch.zeros((b, s, groups))
    s1 = torch.zeros((b, s, lanes, c))
    s2 = torch.zeros((b, s, lanes, c))
    for i in range(k):  # each thread: its row lane, in row order
        s1 = s1 + xb[:, :, i]
        s2 = s2 + xb[:, :, i] * xb[:, :, i]
    c1 = torch.zeros((b, s, c))
    c2 = torch.zeros((b, s, c))
    for lane in range(lanes):  # the lanes, in lane order
        c1 = c1 + s1[:, :, lane]
        c2 = c2 + s2[:, :, lane]
    c1 = c1.reshape(b, s, groups, cpg)
    c2 = c2.reshape(b, s, groups, cpg)
    for i in range(cpg):  # the group, channel by channel
        part1 = part1 + c1[..., i]
        part2 = part2 + c2[..., i]
    g1 = torch.zeros((b, groups))
    g2 = torch.zeros((b, groups))
    for rank in range(s):  # the cluster, in rank order
        g1 = g1 + part1[:, rank]
        g2 = g2 + part2[:, rank]
    inv_count = torch.tensor(1.0 / (n * cpg), dtype=torch.float32)
    mean = g1 * inv_count
    rstd = torch.rsqrt(g2 * inv_count - mean * mean + eps)
    mu = mean.repeat_interleave(cpg, dim=1)[:, None]
    rs = rstd.repeat_interleave(cpg, dim=1)[:, None]
    y = (x - mu) * rs * gamma + beta
    if act == "silu":
        y = y / (1 + torch.exp(-y))
    return y


@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16_vectors", "fp32_vectors"])
@pytest.mark.parametrize("cpg", [4, 8, 12, 16])
def test_cluster_sum_order_matches_jax(cpg, itemsize, s):
    groups = 4
    c = groups * cpg
    vec = 16 // itemsize
    if cpg == 12 and vec == 8:  # the case the channel-by-channel fold is for
        assert any((v * vec) // cpg != (v * vec + vec - 1) // cpg for v in range(c // vec))
    rng = np.random.default_rng(cpg)
    x = rng.standard_normal((2, 50, c)).astype(np.float32)  # 8 blocks of 7 rows: the last 1
    gamma = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    for act in ("none", "silu"):
        got = _emulate_cluster(torch.from_numpy(x), torch.from_numpy(gamma),
                               torch.from_numpy(beta), groups, 1e-6, act, s, itemsize)
        want = _xla_reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups,
                              1e-6, act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=act)


def test_emulation_leaves_an_empty_block_alone():
    """N = 9 over 8 blocks of 2 rows: blocks 5-7 own no row and add zeros."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 9, 32)).astype(np.float32)
    gamma, beta = np.ones(32, np.float32), np.zeros(32, np.float32)
    got = _emulate_cluster(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                           4, 1e-6, "none", 8, 2)
    want = _xla_reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 4, 1e-6, "none")
    assert math.isfinite(float(got.abs().max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
