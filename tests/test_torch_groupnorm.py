"""The port's GroupNorm(+SiLU) against the JAX package's, on the CPU.

The port's plain version (what its wrapper runs for CPU tensors) is held
against the JAX Pallas kernel run in interpret mode (``force=True``, as
tests/test_groupnorm.py runs it) and against the JAX ``_xla_reference``.
The CUDA kernel itself is checked against the same plain version on the card
by chip_smoke.py.

Tolerance: atol 2e-5 in fp32. Both sides keep fp32 statistics with the same
E[x^2] - mean^2 formula; only the order of the sums differs.

Gradients (x, gamma, beta) against ``jax.vjp`` of ``_xla_reference``, both
of the plain version under autograd (the CPU path) and of the autograd
Function the CUDA path runs, with the plain version standing in for the
kernel's forward: atol 3e-5, the tolerance of tests/test_groupnorm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.ops.groupnorm import _xla_reference
from ddpm_ood_tpu.ops.groupnorm import groupnorm_act as jax_groupnorm_act
from ddpm_ood_tpu_torch.ops import groupnorm as gn_mod
from ddpm_ood_tpu_torch.ops.groupnorm import (
    _check_cuda_args,
    _GroupNormAct,
    groupnorm_act,
    groupnorm_act_reference,
)

ATOL = 2e-5
GRAD_ATOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    beta = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, gamma, beta


# (2, 8, 8, 128) reaches the Pallas kernel; at C = 96 the JAX dispatcher's
# 128-lane gate sends force=True to _xla_reference, so both JAX paths are held
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 128), 32), ((2, 4, 4, 96), 8)])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_matches_jax(shape, groups, act):
    x, gamma, beta = _inputs(shape)
    got = groupnorm_act(torch.from_numpy(x), torch.from_numpy(gamma),
                        torch.from_numpy(beta), groups, 1e-6, act).numpy()
    kernel = jax_groupnorm_act(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                               groups, 1e-6, act, force=True)
    ref = _xla_reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                         groups, 1e-6, act)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_tensor_takes_plain_version_and_keeps_dtype():
    x, gamma, beta = _inputs((2, 4, 4, 64), seed=1)
    before = groupnorm_act.launches
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = groupnorm_act(xb, torch.from_numpy(gamma), torch.from_numpy(beta), 8, act="silu")
    assert got.dtype == torch.bfloat16
    assert groupnorm_act.launches == before  # no kernel launched for a CPU tensor
    want = groupnorm_act_reference(xb, torch.from_numpy(gamma), torch.from_numpy(beta), 8,
                                   act="silu")
    assert torch.equal(got, want)


def test_other_devices_raise():
    x = torch.empty((2, 4, 4, 64), device="meta")
    g = torch.empty(64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        groupnorm_act(x, g, g, 8)


def _bad(kind):
    x = torch.zeros(2, 4, 4, 64)
    g = torch.ones(64)
    return {
        "dtype": (x.double(), g, g, 8, "none"),
        "rank": (x[0, 0], g, g, 8, "none"),
        "groups": (x, g, g, 7, "none"),
        "act": (x, g, g, 8, "gelu"),
        "gamma_dtype": (x, g.half(), g, 8, "none"),
        "beta_shape": (x, g, torch.ones(32), 8, "none"),
        "strided": (x.permute(0, 3, 1, 2), torch.ones(4), torch.ones(4), 2, "none"),
    }[kind]


@pytest.mark.parametrize("kind", ["dtype", "rank", "groups", "act", "gamma_dtype",
                                  "beta_shape", "strided"])
def test_kernel_argument_checks_raise(kind):
    """What the CUDA path refuses before it reaches the kernel."""
    with pytest.raises((TypeError, ValueError)):
        _check_cuda_args(*_bad(kind))


@pytest.mark.parametrize("path", ["cpu", "cuda_function"])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 128), 32), ((2, 4, 4, 96), 8)])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_gradients_match_jax_vjp(monkeypatch, path, shape, groups, act):
    x, gamma, beta = _inputs(shape, seed=2)
    g = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: _xla_reference(a, b, c, groups, 1e-6, act),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    if path == "cpu":
        y = groupnorm_act(*ts, groups, 1e-6, act)
    else:  # the Function of the CUDA path; its forward's kernel stood in for
        monkeypatch.setattr(gn_mod, "_launch", groupnorm_act_reference)
        y = _GroupNormAct.apply(*ts, groups, 1e-6, act)
    y.backward(torch.from_numpy(g))
    for name, t, w in zip(("x", "gamma", "beta"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
