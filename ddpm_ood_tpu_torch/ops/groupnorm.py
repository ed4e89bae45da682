"""Fused GroupNorm (+ optional SiLU) over channel-last activations.

Port of ``ddpm_ood_tpu/ops/groupnorm.py``. ``groupnorm_act`` takes the JAX
package's layout, x of shape (B, *spatial, C), and gamma/beta of shape (C,)
in fp32. On a CUDA tensor it launches the hand-written kernel
``csrc/groupnorm.cu`` (or raises); on a CPU tensor it runs
``groupnorm_act_reference``, the plain PyTorch version of the same math.
On CUDA the kernel sits in a ``torch.autograd.Function`` whose backward is
the VJP of the plain version, as in the JAX package.
The UNet runs in ``torch.channels_last``, so its (B, C, H, W) activations
permuted to (B, H, W, C) are already contiguous and reach the kernel without
a copy.
"""

from __future__ import annotations

import math

import torch

from . import _kernels


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
    """One launch of the CUDA kernel; counts it in ``groupnorm_act.launches``."""
    b, c = x.shape[0], x.shape[-1]
    n = math.prod(x.shape[1:-1])
    out = torch.empty_like(x)
    lib = _kernels.library()
    rc = lib.ddpm_groupnorm_act(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        b, n, c, num_groups, float(eps), int(act == "silu"),
        _kernels.DTYPE_CODES[x.dtype], x.device.index, _kernels.stream_of(x),
    )
    _kernels.check_rc(lib, rc, "groupnorm_act")
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

    CPU tensors take the plain version; CUDA tensors the kernel, which counts
    its launches in ``groupnorm_act.launches`` and is differentiable in x,
    gamma and beta. Anything else raises."""
    if x.device.type == "cpu":
        return groupnorm_act_reference(x, gamma, beta, num_groups, eps, act)
    if x.device.type != "cuda":
        raise RuntimeError(f"groupnorm_act: no kernel for device {x.device}")
    _check_cuda_args(x, gamma, beta, num_groups, act)
    return _GroupNormAct.apply(x, gamma, beta, num_groups, eps, act)


groupnorm_act.launches = 0
