"""The port's attention against the JAX package's, on the CPU.

The port's plain version (what ``attention`` runs for CPU tensors) is held
against the JAX Pallas flash kernel in interpret mode and against JAX's
``einsum_attention``; the port's row logsumexp (what its CUDA kernel saves)
against column 0 of the JAX kernel's lane-replicated lse. The CUDA kernel is
checked against the same plain version on the card by chip_smoke.py.

Tolerance: atol 2e-5 in fp32 (fp32 logits and softmax on both sides; the
online softmax only reorders the sums).

Backward: the port's ``flash_attention_bwd_reference`` (the math of its two
CUDA backward kernels), autograd through ``attention`` on the CPU, and the
autograd Function that the CUDA path runs (with stand-ins for the kernels)
against ``jax.grad`` of the JAX Pallas ``flash_attention`` in interpret mode.
Tolerance 1e-4, as ``tests/test_attention.py`` holds the JAX kernels' own
gradients.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.ops.attention import _flash_fwd
from ddpm_ood_tpu.ops.attention import einsum_attention as jax_einsum_attention
from ddpm_ood_tpu.ops.attention import flash_attention as jax_flash_attention
from ddpm_ood_tpu_torch.ops.attention import (
    _check_bwd_args,
    _check_cuda_args,
    _FlashAttention,
    attention,
    einsum_attention,
    einsum_logsumexp,
    flash_attention_bwd_reference,
    flash_attention_fwd,
)

attn_mod = importlib.import_module("ddpm_ood_tpu_torch.ops.attention")
ATOL = 2e-5
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# (shape, block): the (1, 1, 256, 128) case of tests/test_attention.py with
# blocks of 128, and a ragged N = 100 (one 100-row block on the JAX side; the
# CUDA kernels' 32-row tiles mask its last 4 rows)
BWD_CASES = [((1, 1, 256, 128), 128), ((2, 1, 100, 64), 128)]


def _jax_grads(q, k, v, do, scale, block):
    def loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, scale, block, block, True)
        return jnp.sum(out * jnp.asarray(do))

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("shape,block", BWD_CASES)
def test_bwd_reference_matches_jax_flash_grad(shape, block):
    q, k, v, do = _qkv(shape, seed=4) + [np.random.default_rng(5).standard_normal(shape)
                                          .astype(np.float32)]
    scale = 1.0 / math.sqrt(shape[-1])
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = einsum_attention(tq, tk, tv, scale)
    lse = einsum_logsumexp(tq, tk, scale)
    got = flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, scale)
    for name, g, w in zip("qkv", got, _jax_grads(q, k, v, do, scale, block)):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,block", BWD_CASES)
def test_autograd_on_cpu_matches_jax_flash_grad(shape, block):
    q, k, v, do = _qkv(shape, seed=6) + [np.random.default_rng(7).standard_normal(shape)
                                          .astype(np.float32)]
    scale = 1.0 / math.sqrt(shape[-1])
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    attention(*ts, scale).backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", ts, _jax_grads(q, k, v, do, scale, block)):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


def _stand_in_kernels(monkeypatch):
    """CPU stand-ins with the kernels' signatures: the forward returns (O,
    lse); the backward ones take (q, k, v, dO, lse, delta) and compute what
    csrc/attention_bwd.cu does, with delta given."""
    def fwd(q, k, v, scale):
        return einsum_attention(q, k, v, scale), einsum_logsumexp(q, k, scale)

    def p_ds(q, k, v, do, lse, delta, scale):
        b, h, n, _ = q.shape
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale - lse.reshape(b, h, n, 1))
        dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
        return p, p * (dp - delta.reshape(b, h, n, 1)) * scale

    def dkv(q, k, v, do, lse, delta, scale):
        p, ds = p_ds(q, k, v, do, lse, delta, scale)
        return torch.einsum("bhqk,bhqd->bhkd", ds, q), torch.einsum("bhqk,bhqd->bhkd", p, do)

    def dq(q, k, v, do, lse, delta, scale):
        return torch.einsum("bhqk,bhkd->bhqd", p_ds(q, k, v, do, lse, delta, scale)[1], k)

    monkeypatch.setattr(attn_mod, "flash_attention_fwd", fwd)
    monkeypatch.setattr(attn_mod, "flash_attention_bwd_dkv", dkv)
    monkeypatch.setattr(attn_mod, "flash_attention_bwd_dq", dq)


@pytest.mark.parametrize("shape,block", BWD_CASES)
def test_cuda_autograd_function_matches_jax_flash_grad(monkeypatch, shape, block):
    """The Function the CUDA path runs: saved tensors, delta = rowsum(dO * O),
    a non-contiguous dO made contiguous, the kernels' order and outputs."""
    _stand_in_kernels(monkeypatch)
    q, k, v, do = _qkv(shape, seed=8) + [np.random.default_rng(9).standard_normal(shape)
                                          .astype(np.float32)]
    scale = 1.0 / math.sqrt(shape[-1])
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = _FlashAttention.apply(*ts, scale)
    # dO arrives as a transposed view, as from the UNet's head split
    (out.transpose(1, 2) * torch.from_numpy(do).transpose(1, 2)).sum().backward()
    for name, t, w in zip("qkv", ts, _jax_grads(q, k, v, do, scale, block)):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


def _bad_bwd(kind):
    q = torch.zeros(2, 1, 8, 64)
    lse = torch.zeros(2, 8)
    return {
        "do_shape": (q, q, q, torch.zeros(2, 1, 4, 64), lse, lse),
        "do_dtype": (q, q, q, q.to(torch.bfloat16), lse, lse),
        "do_strided": (q, q, q, torch.zeros(2, 1, 64, 8).transpose(2, 3), lse, lse),
        "lse_shape": (q, q, q, q, torch.zeros(2, 8, 1), lse),
        "delta_dtype": (q, q, q, q, lse, lse.to(torch.bfloat16)),
    }[kind]


@pytest.mark.parametrize("kind", ["do_shape", "do_dtype", "do_strided", "lse_shape",
                                  "delta_dtype"])
def test_bwd_kernel_argument_checks_raise(kind):
    """What the backward kernels' wrappers refuse before they launch."""
    with pytest.raises(ValueError):
        _check_bwd_args(*_bad_bwd(kind))
