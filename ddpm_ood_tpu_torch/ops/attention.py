"""Scaled dot-product attention over (B, H, N, D).

Port of ``ddpm_ood_tpu/ops/attention.py`` (forward only; the two flash
backward kernels are not ported yet). ``attention`` launches the
hand-written flash kernel ``csrc/attention.cu`` on CUDA tensors, or raises,
and runs ``einsum_attention``, the plain PyTorch version, on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

MAX_HEAD_DIM = 256  # the kernel's shared-memory tiles are sized for D <= 256


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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA flash kernel: returns O (B, H, N, D) in q's dtype and
    the fp32 row logsumexp (B*H, N). Counts launches in
    ``flash_attention_fwd.launches``."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_fwd: no kernel for device {q.device}")
    _check_cuda_args(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    lib = _kernels.library()
    rc = lib.ddpm_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, n, d, float(sm_scale), _kernels.DTYPE_CODES[q.dtype],
        q.device.index, _kernels.stream_of(q),
    )
    _kernels.check_rc(lib, rc, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """(B, H, N, D) attention: the flash kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        return einsum_attention(q, k, v, sm_scale)
    return flash_attention_fwd(q, k, v, sm_scale)[0]
