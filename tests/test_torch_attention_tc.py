"""The bf16 tensor-core attention kernels: their dispatch, and their rounding.

Dispatch: with a stand-in for the ctypes library (the CPU tests have no card), bf16
tensors reach ``ddpm_flash_attn_fwd_tc``, ``ddpm_flash_attn_bwd_dkv_tc`` and
``ddpm_flash_attn_bwd_dq_tc``, fp32 tensors the CUDA-core entry points, each
with the argument order and ctypes types that ``_kernels.SIGNATURES``
declares for ``_kernels.library()``. The tensor-core counters move only for
bf16, and a bf16 shape the tensor-core kernels cannot take raises ValueError
before anything is called.

Rounding: the CUDA kernels run only on the card, so ``_emulate_fwd`` and
``_emulate_bwd`` stand in for them here: they repeat, in plain torch on the
CPU, where the kernels round: the forward's unnormalised probabilities to
bf16 before P V (per 64-key tile of the online softmax), the backward's P and
dS to bf16 before dV = P^T dO, dK = dS^T Q and dQ = dS K, every output to
bf16. From bf16 inputs of std 0.5 each
output tensor stays within 1e-2 of the fp32 JAX ``einsum_attention`` and of
``jax.grad`` of the JAX Pallas ``flash_attention`` in interpret mode on the
same values, relative to the JAX tensor's largest |value|: chip_smoke.py's
bf16 rule (``ATTN_TOL``), which holds the kernels to the port's plain
versions. The port's plain versions (``einsum_attention``,
``flash_attention_bwd_reference``) are held to JAX by the same rule, which
closes the chain from kernel to JAX. The outputs are far below 1, so an
absolute bound would pass a dK of 0. Rounding to bf16 moves a value by at
most half an ulp, 2^-8 = 3.9e-3 of the tensor's largest value; each rounding
of P or dS adds 2^-9 relative error that the sums over keys or queries
average out. Readings on this file's inputs: at most 4.11e-3 (emulation) and
3.84e-3 (plain versions); a dK 2% off reads 2.1e-2 and fails.
"""

import ctypes
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.ops.attention import einsum_attention as jax_einsum_attention
from ddpm_ood_tpu.ops.attention import flash_attention as jax_flash_attention
from ddpm_ood_tpu_torch.ops import _kernels

attn_mod = importlib.import_module("ddpm_ood_tpu_torch.ops.attention")
BF16_REL_TOL = 1e-2  # chip_smoke.py ATTN_TOL[bfloat16], relative to the largest |value|
STREAM = 0xC0FFEE  # stand-in stream handle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StandInLibrary:
    """Records each C entry point call; every call returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in _kernels.SIGNATURES:
            raise AttributeError(name)

        def entry_point(*args):
            self.calls.append((name, args))
            return 0

        return entry_point


@pytest.fixture
def lib(monkeypatch):
    stand_in = _StandInLibrary()
    monkeypatch.setattr(_kernels, "library", lambda: stand_in)
    monkeypatch.setattr(_kernels, "cuda_target", lambda t, what: (0, STREAM))
    # the stand-in's launches are counted; put every counter back afterwards,
    # so that later tests in the process read the CPU path's counts
    from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

    for fn in (groupnorm_act, attn_mod.flash_attention_fwd, attn_mod.flash_attention_bwd_dkv,
               attn_mod.flash_attention_bwd_dq):
        for counter in ("launches", "cluster_launches", "large_launches", "tc_launches"):
            if hasattr(fn, counter):
                monkeypatch.setattr(fn, counter, getattr(fn, counter))
    return stand_in


def _assert_signature(name, args):
    """args are what ctypes would accept for the declared argtypes, exactly."""
    argtypes = _kernels.SIGNATURES[name]
    assert len(args) == len(argtypes), (name, args)
    for argtype, a in zip(argtypes, args):
        want = float if argtype is ctypes.c_float else int
        assert type(a) is want, (name, argtype, a)
        argtype(a)  # raises if ctypes would refuse it


def _inputs(dtype, shape=(2, 1, 64, 256)):
    b, h, n, _ = shape
    q, k, v, do = (torch.zeros(shape, dtype=dtype) for _ in range(4))
    lse, delta = torch.zeros(b * h, n), torch.zeros(b * h, n)
    return q, k, v, do, lse, delta


def _call(kernel, q, k, v, do, lse, delta):
    if kernel == "fwd":
        return attn_mod.flash_attention_fwd(q, k, v, 0.0625)
    if kernel == "dkv":
        return attn_mod.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.0625)
    return attn_mod.flash_attention_bwd_dq(q, k, v, do, lse, delta, 0.0625)


# (kernel, dtype) -> (entry point, dtype code or None where the entry point takes none)
DISPATCH = {
    ("fwd", torch.bfloat16): ("ddpm_flash_attn_fwd_tc", None),
    ("fwd", torch.float32): ("ddpm_flash_attn_fwd", None),
    ("dkv", torch.bfloat16): ("ddpm_flash_attn_bwd_dkv_tc", None),
    ("dkv", torch.float32): ("ddpm_flash_attn_bwd_dkv", None),
    ("dq", torch.bfloat16): ("ddpm_flash_attn_bwd_dq_tc", None),
    ("dq", torch.float32): ("ddpm_flash_attn_bwd_dq", None),
}


@pytest.mark.parametrize("kernel,dtype", list(DISPATCH), ids=lambda x: str(x).split(".")[-1])
def test_dtype_chooses_the_entry_point(lib, kernel, dtype):
    q, k, v, do, lse, delta = _inputs(dtype)
    outs = _call(kernel, q, k, v, do, lse, delta)
    outs = outs if isinstance(outs, tuple) else (outs,)
    name, code = DISPATCH[(kernel, dtype)]
    assert [c[0] for c in lib.calls] == [name]
    args = lib.calls[0][1]
    _assert_signature(name, args)
    ins = (q, k, v) if kernel == "fwd" else (q, k, v, do, lse, delta)
    n_ptr = len(ins) + len(outs)
    assert args[:n_ptr] == tuple(t.data_ptr() for t in (*ins, *outs))
    assert args[n_ptr:n_ptr + 4] == (2, 64, 256, 0.0625)
    assert args[n_ptr + 4:] == ((code,) if code is not None else ()) + (0, STREAM)
    assert all(t.dtype == dtype for t in outs if t.dim() == 4)


WRAPPERS = {"fwd": attn_mod.flash_attention_fwd, "dkv": attn_mod.flash_attention_bwd_dkv,
            "dq": attn_mod.flash_attention_bwd_dq}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_tensor_core_counters_move_only_for_bf16(lib, kernel):
    fn = WRAPPERS[kernel]
    launches, tc = fn.launches, fn.tc_launches
    _call(kernel, *_inputs(torch.float32))
    assert (fn.launches, fn.tc_launches) == (launches + 1, tc)
    _call(kernel, *_inputs(torch.bfloat16))
    assert (fn.launches, fn.tc_launches) == (launches + 2, tc + 1)


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous view that starts 2 bytes past a 16-byte boundary."""
    return torch.zeros(math.prod(shape) + 1, dtype=dtype)[1:].view(shape)


REFUSALS = [(kernel, case) for kernel in ("fwd", "dkv", "dq")
            for case in ("head_dim", "q_misaligned", "do_misaligned")
            if (kernel, case) != ("fwd", "do_misaligned")]  # the forward takes no dO


@pytest.mark.parametrize("kernel,case", REFUSALS)
def test_bf16_shapes_the_kernels_refuse_raise_before_any_call(lib, kernel, case):
    shape = (2, 1, 64, 36) if case == "head_dim" else (2, 1, 64, 64)
    q, k, v, do, lse, delta = _inputs(torch.bfloat16, shape)
    if case == "q_misaligned":
        q = _misaligned(shape)
    if case == "do_misaligned":
        do = _misaligned(shape)
    counts = [(fn.launches, fn.tc_launches) for fn in WRAPPERS.values()]
    with pytest.raises(ValueError, match="bf16"):
        _call(kernel, q, k, v, do, lse, delta)
    assert lib.calls == []
    assert counts == [(fn.launches, fn.tc_launches) for fn in WRAPPERS.values()]


def test_fp32_takes_any_head_dim(lib):
    """The CUDA-core kernels have no width or alignment limit below 256."""
    _call("fwd", *_inputs(torch.float32, (2, 1, 64, 36)))
    assert [c[0] for c in lib.calls] == ["ddpm_flash_attn_fwd"]


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, ["ddpm_flash_attn_fwd_tc", "ddpm_flash_attn_bwd_dkv_tc",
                      "ddpm_flash_attn_bwd_dq_tc"]),
    (torch.float32, ["ddpm_flash_attn_fwd", "ddpm_flash_attn_bwd_dkv",
                     "ddpm_flash_attn_bwd_dq"]),
], ids=["bf16", "fp32"])
def test_autograd_function_reaches_the_entry_points(lib, dtype, want):
    """The training path: the autograd Function's forward, then its backward."""
    q, k, v = (torch.zeros((2, 1, 64, 256), dtype=dtype, requires_grad=True) for _ in range(3))
    out = attn_mod._FlashAttention.apply(q, k, v, 0.0625)
    out.backward(torch.zeros_like(out))
    assert [c[0] for c in lib.calls] == want
    for name, args in lib.calls:
        _assert_signature(name, args)


# --- the kernels' rounding, emulated on the CPU ---------------------------------------------

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
BK = 64  # keys per tile of the forward kernel


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, scale):
    """(O bf16, lse (B*H, N) fp32) of bf16 q, k, v as csrc/attention_fwd_tc.cu
    computes them: fp32 logits in log2 units, online softmax over 64-key
    tiles, unnormalised probabilities rounded to bf16 before P V."""
    b, h, n, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = torch.full((b, h, n), -1e30)
    l = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, d))
    for k0 in range(0, n, BK):
        blk = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, blk.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(blk - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", _bf16(p),
                                                    v[..., k0:k0 + BK, :].float())
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16), ((m + torch.log2(l)) * LN2).reshape(b * h, n)


def _emulate_bwd(q, k, v, o, lse, do, scale):
    """(dq, dk, dv) in bf16 as the card's backward computes them: delta in
    torch, dK/dV from P and dS rounded to bf16 (csrc/attention_bwd_tc.cu), dQ
    from dS rounded to bf16 (csrc/attention_bwd_dq_tc.cu)."""
    b, h, n, _ = q.shape
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * (scale * LOG2E) - lse.reshape(b, h, n, 1) * LOG2E)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", _bf16(p), dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", _bf16(ds), qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", _bf16(ds), kf)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _assert_within_rel_tol(got, want, what):
    """max |got - want| <= BF16_REL_TOL * max |want|, for one output tensor."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BF16_REL_TOL, f"{what}: {err:.3e} of its largest |value| > {BF16_REL_TOL}"


def _bf16_inputs(shape, seed):
    """q, k, v, dO of std 0.5 (as chip_smoke.py draws them), rounded to bf16:
    numpy float32 arrays of exactly the bf16 values, for both packages."""
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(0.5 * rng.standard_normal(shape).astype(np.float32))).numpy()
            for _ in range(4)]


# the small UNet's attention at 32x32, and a ragged N over two key tiles
EMULATION_SHAPES = [(2, 1, 64, 256), (2, 1, 100, 64)]


@pytest.mark.parametrize("shape", EMULATION_SHAPES, ids=str)
def test_forward_rounding_within_tolerance_of_jax(shape):
    q, k, v, _ = _bf16_inputs(shape, seed=10)
    scale = 1.0 / math.sqrt(shape[-1])
    got, lse = _emulate_fwd(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), scale)
    want = np.asarray(jax_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    _assert_within_rel_tol(got.float().numpy(), want, "O")
    logits = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64) * scale
    want_lse = np.log(np.exp(logits).sum(-1)).reshape(lse.shape)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", EMULATION_SHAPES, ids=str)
def test_backward_rounding_within_tolerance_of_jax_flash_grad(shape):
    q, k, v, do = _bf16_inputs(shape, seed=11)
    scale = 1.0 / math.sqrt(shape[-1])
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o, lse = _emulate_fwd(tq, tk, tv, scale)
    got = _emulate_bwd(tq, tk, tv, o, lse, tdo, scale)
    for name, g, w in zip("qkv", got, _jax_flash_grads(q, k, v, do, scale)):
        _assert_within_rel_tol(g.float().numpy(), w, f"d{name}")


def _jax_flash_grads(q, k, v, do, scale):
    """jax.grad of the JAX Pallas flash_attention (interpret mode) against dO."""
    def loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, scale, 128, 128, True)
        return jnp.sum(out * jnp.asarray(do))

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("shape", EMULATION_SHAPES, ids=str)
def test_plain_versions_in_bf16_within_tolerance_of_jax(shape):
    """The port's plain versions, which chip_smoke.py holds the kernels to, on
    the same bf16 values: O against the fp32 JAX einsum, the gradients against
    jax.grad of the JAX flash kernel."""
    q, k, v, do = _bf16_inputs(shape, seed=12)
    scale = 1.0 / math.sqrt(shape[-1])
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o = attn_mod.einsum_attention(tq, tk, tv, scale)
    want = jax_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    _assert_within_rel_tol(o.float().numpy(), want, "O")
    lse = attn_mod.einsum_logsumexp(tq, tk, scale)
    got = attn_mod.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, scale)
    for name, g, w in zip("qkv", got, _jax_flash_grads(q, k, v, do, scale)):
        assert g.dtype == torch.bfloat16
        _assert_within_rel_tol(g.float().numpy(), w, f"d{name}")
