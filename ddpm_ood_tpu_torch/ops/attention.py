"""Scaled dot-product attention over (B, H, N, D), forward and backward.

Port of ``ddpm_ood_tpu/ops/attention.py``. On CUDA tensors ``attention`` runs
a ``torch.autograd.Function`` over three hand-written kernels: the flash
forward (which saves the per-row logsumexp) and the two flash backward
kernels, dK/dV then dQ. The wrappers choose the kernel by dtype:

- bf16 runs on tensor cores (``csrc/attention_fwd_tc.cu``,
  ``csrc/attention_bwd_tc.cu``, ``csrc/attention_bwd_dq_tc.cu``: mma.sync,
  counted in ``.tc_launches`` as well as ``.launches``); these take a head
  dim that is a multiple of 8 and tensors on 16-byte boundaries, and any
  other bf16 shape raises ValueError;
- fp32 runs the CUDA-core kernels (``csrc/attention.cu``,
  ``csrc/attention_bwd.cu``).

A kernel that does not build or launch raises; nothing falls back. On CPU
tensors ``attention`` runs ``einsum_attention``, the plain PyTorch version,
under autograd. ``flash_attention_bwd_reference`` is the plain version of the
backward kernels' math, for the tests and the card's checks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

MAX_HEAD_DIM = 256  # the kernel's shared-memory tiles are sized for D <= 256
TC_HEAD_DIM_MULTIPLE = 8  # the bf16 kernels copy rows in 16-byte chunks


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float) -> torch.Tensor:
    """fp32 logits and softmax; probabilities cast to v's dtype before P V,
    as the JAX reference path does."""
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits * sm_scale, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float())
    return out.to(q.dtype)


def einsum_logsumexp(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """(B*H, N) row logsumexp of the scaled logits: what the kernel saves."""
    b, h, n, _ = q.shape
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
        return torch.logsumexp(logits, dim=-1).reshape(b * h, n)


def _check_cuda_args(q, k, v):
    if q.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in (float32, bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, H, N, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} != q {q.dtype} {tuple(q.shape)} on {q.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_tc_layout("flash_attention", q, k, v)


def _check_tc_layout(what, *ts):
    """What the bf16 tensor-core kernels need beyond the common checks."""
    d = ts[0].shape[-1]
    if d % TC_HEAD_DIM_MULTIPLE:
        raise ValueError(f"{what}: the bf16 kernels take a head dim that is a multiple of "
                         f"{TC_HEAD_DIM_MULTIPLE}, got {d}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: bf16 tensors must start on a 16-byte boundary")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA flash kernel: returns O (B, H, N, D) in q's dtype and
    the fp32 row logsumexp (B*H, N). Counts launches in
    ``flash_attention_fwd.launches``, the bf16 tensor-core ones also in
    ``flash_attention_fwd.tc_launches``."""
    target = _kernels.cuda_target(q, "flash_attention_fwd")
    _check_cuda_args(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b * h, n, d, float(sm_scale))
    if q.dtype == torch.bfloat16:
        _kernels.call("ddpm_flash_attn_fwd_tc", *args, *target)
        flash_attention_fwd.tc_launches += 1
    else:
        _kernels.call("ddpm_flash_attn_fwd", *args, *target)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0


def flash_attention_bwd_reference(q, k, v, o, lse, do, sm_scale: float):
    """The backward kernels' math, step by step in fp32: p = exp(s - lse),
    dV = p^T dO, dP = dO V^T, delta = rowsum(dO * O), dS = p (dP - delta)
    scale, dK = dS^T Q, dQ = dS K. Takes the forward's (B*H, N) fp32 lse;
    returns (dq, dk, dv) in q's dtype."""
    b, h, n, d = q.shape
    with torch.autocast(device_type=q.device.type, enabled=False):
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
        p = torch.exp(s - lse.reshape(b, h, n, 1))
        dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
        delta = (dof * o.float()).sum(-1, keepdim=True)
        ds = p * (dp - delta) * sm_scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_bwd_args(q, k, v, do, lse, delta):
    _check_cuda_args(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(f"flash_attention_bwd: dO {do.dtype} {tuple(do.shape)} must be a "
                         f"contiguous {q.dtype} {tuple(q.shape)}")
    if q.dtype == torch.bfloat16:
        _check_tc_layout("flash_attention_bwd", do)
    rows = (q.shape[0] * q.shape[1], q.shape[2])
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != rows or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous float32 {rows} "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _bwd_args(q, k, v, do, lse, delta, outs, sm_scale):
    b, h, n, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), b * h, n, d, float(sm_scale))


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float):
    """Launch the dK/dV kernel: (dk, dv) in q's dtype. lse and delta are the
    (B*H, N) fp32 row logsumexp and rowsum(dO * O). Counts launches in
    ``flash_attention_bwd_dkv.launches``, the bf16 tensor-core ones also in
    ``flash_attention_bwd_dkv.tc_launches``."""
    target = _kernels.cuda_target(q, "flash_attention_bwd_dkv")
    _check_bwd_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = _bwd_args(q, k, v, do, lse, delta, (dk, dv), sm_scale)
    if q.dtype == torch.bfloat16:
        _kernels.call("ddpm_flash_attn_bwd_dkv_tc", *args, *target)
        flash_attention_bwd_dkv.tc_launches += 1
    else:
        _kernels.call("ddpm_flash_attn_bwd_dkv", *args, *target)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, sm_scale: float):
    """Launch the dQ kernel: dq in q's dtype. Counts launches in
    ``flash_attention_bwd_dq.launches``, the bf16 tensor-core ones also in
    ``flash_attention_bwd_dq.tc_launches``."""
    target = _kernels.cuda_target(q, "flash_attention_bwd_dq")
    _check_bwd_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    args = _bwd_args(q, k, v, do, lse, delta, (dq,), sm_scale)
    if q.dtype == torch.bfloat16:
        _kernels.call("ddpm_flash_attn_bwd_dq_tc", *args, *target)
        flash_attention_bwd_dq.tc_launches += 1
    else:
        _kernels.call("ddpm_flash_attn_bwd_dq", *args, *target)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.tc_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float):
    """(dq, dk, dv) through the two backward kernels. delta = rowsum(dO * O)
    stays plain torch, as the JAX package computes it in XLA."""
    b, h, n, _ = q.shape
    do = do.to(q.dtype).contiguous()
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, n)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, sm_scale)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.sm_scale), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """(B, H, N, D) attention: the flash kernels on CUDA (differentiable in
    q, k, v), the plain version on CPU."""
    if q.device.type == "cpu":
        return einsum_attention(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_fwd: no kernel for device {q.device}")
    return _FlashAttention.apply(q, k, v, sm_scale)
