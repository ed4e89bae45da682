"""Fused GroupNorm (+ optional SiLU) over channel-last activations.

Port of ``ddpm_ood_tpu/ops/groupnorm.py``. ``groupnorm_act`` takes the JAX
package's layout, x of shape (B, *spatial, C), and gamma/beta of shape (C,)
in fp32. On a CUDA tensor it launches a hand-written kernel (or raises); on
a CPU tensor it runs ``groupnorm_act_reference``, the plain PyTorch version
of the same math. Which kernel is chosen by shape, before the launch:
``cluster_plan`` gives the thread-block cluster kernel
``csrc/groupnorm_cluster.cu`` (one cluster of 1-8 blocks per sample, the
sample read once into shared memory; counted in ``.cluster_launches`` as well
as ``.launches``) every shape whose sample fits 8 blocks' shared memory, and
the rest (and x off a 16-byte boundary) take the one-block-per-group kernel
``csrc/groupnorm.cu``. Nothing falls back on a failure: a kernel that does
not build or launch raises.
On CUDA the kernel sits in a ``torch.autograd.Function`` whose backward is
the VJP of the plain version, as in the JAX package.
The UNet runs in ``torch.channels_last``, so its (B, C, H, W) activations
permuted to (B, H, W, C) are already contiguous and reach the kernel without
a copy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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
    """One launch of a CUDA kernel, chosen by ``cluster_plan``; counts it in
    ``groupnorm_act.launches``, and the cluster kernel's also in
    ``groupnorm_act.cluster_launches``."""
    b, c = x.shape[0], x.shape[-1]
    n = math.prod(x.shape[1:-1])
    out = torch.empty_like(x)
    target = _kernels.cuda_target(x, "groupnorm_act")
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), b, n, c,
            num_groups, float(eps), int(act == "silu"), _kernels.DTYPE_CODES[x.dtype])
    plan = cluster_plan(n, c, num_groups, x.element_size())
    if plan is not None and x.data_ptr() % VECTOR_BYTES == 0:
        _kernels.call("ddpm_groupnorm_act_cluster", *args, *plan, *target)
        groupnorm_act.cluster_launches += 1
    else:
        _kernels.call("ddpm_groupnorm_act", *args, *target)
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
    cluster kernel's also in ``groupnorm_act.cluster_launches``) and is
    differentiable in x, gamma and beta. Anything else raises."""
    if x.device.type == "cpu":
        return groupnorm_act_reference(x, gamma, beta, num_groups, eps, act)
    if x.device.type != "cuda":
        raise RuntimeError(f"groupnorm_act: no kernel for device {x.device}")
    _check_cuda_args(x, gamma, beta, num_groups, act)
    return _GroupNormAct.apply(x, gamma, beta, num_groups, eps, act)


groupnorm_act.launches = 0
groupnorm_act.cluster_launches = 0
