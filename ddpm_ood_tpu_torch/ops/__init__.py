"""Operators with hand-written CUDA kernels, each beside its plain PyTorch version."""

from ._kernels import KernelBuildError, KernelLaunchError
from .attention import attention, einsum_attention, flash_attention_fwd
from .groupnorm import groupnorm_act, groupnorm_act_reference

__all__ = [
    "KernelBuildError",
    "KernelLaunchError",
    "attention",
    "einsum_attention",
    "flash_attention_fwd",
    "groupnorm_act",
    "groupnorm_act_reference",
]
