"""Operators with hand-written CUDA kernels, each beside its plain PyTorch version,
and SSIM (``ssim.py``), which the JAX package also computes outside any kernel."""

from ._kernels import KernelBuildError, KernelLaunchError
from .attention import (
    attention,
    einsum_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_fwd,
)
from .groupnorm import groupnorm_act, groupnorm_act_reference

__all__ = [
    "KernelBuildError",
    "KernelLaunchError",
    "attention",
    "einsum_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "groupnorm_act",
    "groupnorm_act_reference",
]
