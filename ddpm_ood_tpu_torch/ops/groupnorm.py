"""Fused GroupNorm (+ optional SiLU) over channel-last activations.

Port of ``ddpm_ood_tpu/ops/groupnorm.py``. ``groupnorm_act`` takes the JAX
package's layout, x of shape (B, *spatial, C), and gamma/beta of shape (C,)
in fp32. On a CUDA tensor it launches a hand-written kernel (or raises); on
a CPU tensor it runs ``groupnorm_act_reference``, the plain PyTorch version
of the same math. Which kernel is chosen by shape, before the launch
(``kernel_for``): ``cluster_plan`` gives the thread-block cluster kernel
``csrc/groupnorm_cluster.cu`` (one cluster of 1-8 blocks per sample, the
sample read once into shared memory; counted in ``.cluster_launches`` as well
as ``.launches``) every shape whose sample fits 8 blocks' shared memory, and
the rest (C not a whole number of 16-byte vectors, x off a 16-byte boundary,
larger samples) take the large-sample kernel ``csrc/groupnorm.cu``: row tiles
of a persistent, co-resident grid that meet at a per-sample arrival counter,
planned by ``large_plan`` and counted in ``.large_launches``. Nothing falls
back on a failure: a kernel that does not build or launch raises.
On CUDA the kernel sits in a ``torch.autograd.Function`` whose backward is
the VJP of the plain version, as in the JAX package.
The UNet runs in ``torch.channels_last`` (``channels_last_3d`` in 3D), so
its (B, C, *spatial) activations permuted to (B, *spatial, C) are already
contiguous and reach the kernel without a copy.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _kernels

# The cluster kernel's shared-memory plan (csrc/groupnorm_cluster.cu `layout`
# computes the same bytes). An H100 SM has 233,472 bytes of shared memory and
# reserves 1,024 of them for each resident block; one block may use 232,448.
VECTOR_BYTES = 16  # a thread's channels in a row: 8 bf16 or 4 fp32
MAX_THREADS = 256
CLUSTER_SIZES = (1, 2, 4, 8)  # 8 is the portable cluster limit
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024
BLOCK_MAX_SHARED_BYTES = 232_448
# tried in turn: two blocks to an SM, then one
SHARED_BUDGETS = (SM_SHARED_BYTES // 2 - BLOCK_RESERVED_BYTES, BLOCK_MAX_SHARED_BYTES)


def cluster_lanes(c: int, itemsize: int) -> int:
    """Row lanes of a cluster-kernel block: each of its threads owns one
    16-byte vector of a row (vectors x lanes threads), and the lanes split the
    rows; 0 where a row has more vectors than a block has threads."""
    vecs = c * itemsize // VECTOR_BYTES
    return MAX_THREADS // vecs if vecs else 0


def cluster_smem_bytes(n: int, c: int, g: int, s: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of an s-block cluster: its slice of
    ceil(n / s) rows x c channels, the per-lane channel sums of x and x^2,
    and the group sums and statistics (fp32)."""
    return -(-n // s) * c * itemsize + 2 * cluster_lanes(c, itemsize) * c * 4 + 4 * g * 4


def cluster_plan(n: int, c: int, g: int, itemsize: int) -> Optional[Tuple[int, int]]:
    """(cluster size, shared-memory bytes per block) of the cluster kernel for
    samples of n rows x c channels in g groups, or None where it does not
    take the shape: c not a whole number of 16-byte vectors, more than 256
    vectors a row, or a sample over 8 blocks' shared memory. The smallest
    cluster whose blocks fit two to an SM, else the smallest that fits one."""
    if (c * itemsize) % VECTOR_BYTES or cluster_lanes(c, itemsize) < 1:
        return None
    for budget in SHARED_BUDGETS:
        for s in CLUSTER_SIZES:
            smem = cluster_smem_bytes(n, c, g, s, itemsize)
            if smem <= budget:
                return s, smem
    return None


# The large-sample kernel's plan (csrc/groupnorm.cu `layout` computes the
# same bytes). A sample's tiles must all be resident at once, so a sample
# has at most MAX_TILES of them: fewer than an H100 PCIe card's 114 SMs. A
# block takes up to all of an SM's shared memory: one block to an SM beat
# two at the 3D level-0 shapes on an H100 (bench_groupnorm.py; PERF.md).
MAX_TILES = 112
LARGE_VECTOR_BYTES = (16, 8, 4, 2)  # the widest that the row and x's address allow
BARRIER_BYTES = 16


class LargePlan(NamedTuple):
    """The arguments of one large-sample kernel launch past the tensors: the
    vector width, rows per tile, tiles per sample, whether the tiles live in
    shared memory (else they stream from device memory twice), threads per
    block and dynamic shared-memory bytes."""
    vec_bytes: int
    rows: int
    tiles: int
    resident: int
    threads: int
    smem: int


def large_vector_bytes(c: int, itemsize: int, address: int) -> int:
    """The widest load of the large-sample kernel: a whole number of them in a
    row, on a boundary of their size at x's address, and at least one
    element."""
    return next(v for v in LARGE_VECTOR_BYTES
                if v >= itemsize and (c * itemsize) % v == 0 and address % v == 0)


def large_layout(n: int, c: int, g: int, itemsize: int, vec_bytes: int, rows: int,
                 resident: bool) -> Tuple[int, int, int]:
    """(threads, tiles, shared-memory bytes) of a large-sample kernel block:
    one thread per vector of a row, up to MAX_THREADS, times the row lanes;
    the barrier, the tile (resident only), per-lane channel sums of x and
    x^2, the sample's partials (2G a tile) and its statistics (fp32)."""
    cols = min(c * itemsize // vec_bytes, MAX_THREADS)
    lanes = MAX_THREADS // cols
    tiles = -(-n // rows)
    tile = -(-rows * c * itemsize // 16) * 16 if resident else 0
    return cols * lanes, tiles, BARRIER_BYTES + tile + 2 * lanes * c * 4 + (2 * tiles + 2) * g * 4


def large_plan(n: int, c: int, g: int, itemsize: int, vec_bytes: int = 16) -> LargePlan:
    """The large-sample kernel's launch for samples of n rows x c channels in
    g groups: the fewest tiles of whole rows (rows spread evenly) whose
    blocks fit an SM's shared memory with the tile in it; a sample that needs
    more than MAX_TILES such tiles streams MAX_TILES tiles (or one a row) from
    device memory instead."""
    tiles = max(1, -(-n * c * itemsize // BLOCK_MAX_SHARED_BYTES))
    while tiles <= min(n, MAX_TILES):
        rows = -(-n // tiles)
        threads, real, smem = large_layout(n, c, g, itemsize, vec_bytes, rows, True)
        if smem <= BLOCK_MAX_SHARED_BYTES:
            return LargePlan(vec_bytes, rows, real, 1, threads, smem)
        tiles += 1
    rows = -(-n // min(n, MAX_TILES))
    threads, real, smem = large_layout(n, c, g, itemsize, vec_bytes, rows, False)
    return LargePlan(vec_bytes, rows, real, 0, threads, smem)


def kernel_for(n: int, c: int, g: int, itemsize: int, address: int):
    """("cluster", (cluster size, shared-memory bytes)) or ("large",
    LargePlan): the kernel that takes samples of n rows x c channels in g
    groups with x at `address`, a function of the shape alone."""
    plan = cluster_plan(n, c, g, itemsize)
    if plan is not None and address % VECTOR_BYTES == 0:
        return "cluster", plan
    return "large", large_plan(n, c, g, itemsize, large_vector_bytes(c, itemsize, address))


def groupnorm_act_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    act: str = "none",
) -> torch.Tensor:
    """The JAX ``_xla_reference`` math: fp32 statistics, var = E[x^2] - mean^2,
    fp32 affine, optional SiLU, output in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(b, -1, c) * gamma.float() + beta.float()
    y = y.reshape(x.shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _check_cuda_args(x, gamma, beta, num_groups, act):
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"groupnorm_act: x dtype {x.dtype} not in (float32, bfloat16)")
    if x.dim() < 3:
        raise ValueError(f"groupnorm_act: x must be (B, *spatial, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"groupnorm_act: C={c} is not divisible by {num_groups} groups")
    if act not in ("none", "silu"):
        raise ValueError(f"groupnorm_act: unknown act {act!r}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.dtype != torch.float32 or tuple(p.shape) != (c,):
            raise ValueError(f"groupnorm_act: {name} must be float32 ({c},), "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.device != x.device or not p.is_contiguous():
            raise ValueError(f"groupnorm_act: {name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_act: x must be contiguous channel-last (B, *spatial, C)")


def _launch(x, gamma, beta, num_groups, eps, act):
    """One launch of the kernel ``kernel_for`` picks for x's shape; counts it
    in ``groupnorm_act.launches``, and also in
    ``groupnorm_act.cluster_launches`` or ``groupnorm_act.large_launches``."""
    b, c = x.shape[0], x.shape[-1]
    n = math.prod(x.shape[1:-1])
    kernel, plan = kernel_for(n, c, num_groups, x.element_size(), x.data_ptr())
    out = torch.empty_like(x)
    target = _kernels.cuda_target(x, "groupnorm_act")
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr())
    shape = (b, n, c, num_groups, float(eps), int(act == "silu"), _kernels.DTYPE_CODES[x.dtype])
    if kernel == "cluster":
        _kernels.call("ddpm_groupnorm_act_cluster", *args, *shape, *plan, *target)
        groupnorm_act.cluster_launches += 1
    else:
        # the samples' arrival counters, then their tiles' partial sums
        work = torch.empty(b + b * plan.tiles * 2 * num_groups, dtype=torch.int32,
                           device=x.device)
        _kernels.call("ddpm_groupnorm_act", *args, work.data_ptr(), *shape, plan.vec_bytes,
                      plan.rows, plan.resident, plan.smem, *target)
        groupnorm_act.large_launches += 1
    groupnorm_act.launches += 1
    return out


class _GroupNormAct(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the VJP of
    ``groupnorm_act_reference``, recomputed from the saved x, gamma, beta, as
    the JAX package's ``_fused_bwd`` does; there is no backward kernel to
    port."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (num_groups, eps, act)
        return _launch(x, gamma, beta, num_groups, eps, act)

    @staticmethod
    def backward(ctx, grad):
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad(), torch.autocast(device_type=x.device.type, enabled=False):
            inputs = [t.detach().requires_grad_() for t in (x, gamma, beta)]
            y = groupnorm_act_reference(*inputs, *ctx.cfg)
            grads = torch.autograd.grad(y, inputs, grad)
        return (*grads, None, None, None)


def groupnorm_act(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm (+ SiLU) over channel-last x (B, *spatial, C).

    CPU tensors take the plain version; CUDA tensors a kernel (see the module
    docstring), which counts its launches in ``groupnorm_act.launches`` (the
    cluster kernel's also in ``groupnorm_act.cluster_launches``, the
    large-sample kernel's in ``groupnorm_act.large_launches``) and is
    differentiable in x, gamma and beta. Anything else raises."""
    if x.device.type == "cpu":
        return groupnorm_act_reference(x, gamma, beta, num_groups, eps, act)
    if x.device.type != "cuda":
        raise RuntimeError(f"groupnorm_act: no kernel for device {x.device}")
    _check_cuda_args(x, gamma, beta, num_groups, act)
    return _GroupNormAct.apply(x, gamma, beta, num_groups, eps, act)


groupnorm_act.launches = 0
groupnorm_act.cluster_launches = 0
groupnorm_act.large_launches = 0
