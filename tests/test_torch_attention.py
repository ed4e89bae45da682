"""The port's attention against the JAX package's, on the CPU.

The port's plain version (what ``attention`` runs for CPU tensors) is held
against the JAX Pallas flash kernel in interpret mode and against JAX's
``einsum_attention``; the port's row logsumexp (what its CUDA kernel saves)
against column 0 of the JAX kernel's lane-replicated lse. The CUDA kernel is
checked against the same plain version on the card by chip_smoke.py.

Tolerance: atol 2e-5 in fp32 (fp32 logits and softmax on both sides; the
online softmax only reorders the sums).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.ops.attention import _flash_fwd
from ddpm_ood_tpu.ops.attention import einsum_attention as jax_einsum_attention
from ddpm_ood_tpu.ops.attention import flash_attention as jax_flash_attention
from ddpm_ood_tpu_torch.ops.attention import (
    _check_cuda_args,
    attention,
    einsum_attention,
    einsum_logsumexp,
    flash_attention_fwd,
)

ATOL = 2e-5


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_matches_jax_flash_kernel():
    q, k, v = _qkv((1, 2, 256, 128))
    scale = 1.0 / math.sqrt(128)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale, 128, 128, True)
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_lse_matches_jax_flash_kernel():
    q, k, v = _qkv((1, 2, 256, 128), seed=1)
    scale = 1.0 / math.sqrt(128)
    _, lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 128, 128, True)
    got = einsum_logsumexp(torch.from_numpy(q), torch.from_numpy(k), scale)
    assert got.shape == (2, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[:, :, 0], atol=ATOL, rtol=0)


def test_matches_jax_einsum_at_unet_shape():
    """(B, H, N, D) = (2, 1, 64, 256): the small UNet's attention at 32x32."""
    q, k, v = _qkv((2, 1, 64, 256), seed=2)
    scale = 1.0 / 16.0
    want = jax_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    before = flash_attention_fwd.launches
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert flash_attention_fwd.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bf16_probabilities_cast_like_jax():
    q, k, v = _qkv((1, 1, 16, 64), seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = einsum_attention(tq, tk, tv, 0.125)
    want = jax_einsum_attention(jq, jk, jv, 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=8e-3, rtol=0)  # one bf16 ulp at |o| < 2


def test_other_devices_raise():
    q = torch.empty((1, 1, 8, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        attention(q, q, q, 1.0)


def _bad(kind):
    q = torch.zeros(1, 1, 8, 64)
    return {
        "dtype": (q.half(), q.half(), q.half()),
        "rank": (q[0], q[0], q[0]),
        "shape": (q, torch.zeros(1, 1, 4, 64), q),
        "kv_dtype": (q, q.double(), q),
        "head_dim": (torch.zeros(1, 1, 8, 320),) * 3,
        "strided": (q.transpose(2, 3),) * 3,
    }[kind]


@pytest.mark.parametrize("kind", ["dtype", "rank", "shape", "kv_dtype", "head_dim", "strided"])
def test_kernel_argument_checks_raise(kind):
    """What the CUDA path refuses before it reaches the kernel."""
    with pytest.raises((TypeError, ValueError)):
        _check_cuda_args(*_bad(kind))
