"""The port's int8 primitives (``ddpm_ood_tpu_torch/ops/quant.py``) against the
JAX package's ``ops/quant.py``, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; PyTorch
weights (Cout, Cin, *window) and (O, I) go to JAX transposed to its
(*window, Cin, Cout) and (I, O) kernels. The JAX functions run jitted, as
the JAX package's scoring program runs them: there XLA computes each scale
as max|x| times float32(1 / 127), which differs from max|x| / 127 (eager
JAX) in the last bit for ~4% of values, and the port follows the jitted
program (``ops/quant.py:RECIP_127``).

Tolerances:
- int8 codes, scales and int32 sums: exact (the same IEEE division and
  half-to-even rounding; integer sums below 2^31).
- qconv and qdot fp32 outputs: 1e-6 of the largest |output| (the same sums
  and scales; XLA may fuse the dequantising multiply and the bias add).
- JAX's wconv against the model's WeightOnlyQuantConv (the port's w8), fp32:
  1e-5 of the largest |output| (two fp32 convolution algorithms, oneDNN and
  XLA, over the same dequantised weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ddpm_ood_tpu.ops import quant as jquant
from ddpm_ood_tpu_torch.models import unet
from ddpm_ood_tpu_torch.ops import quant

OUT_RTOL, WCONV_RTOL = 1e-6, 1e-5
# one compile per case rather than one per eager op
jquantize = jax.jit(jquant.quantize_int8, static_argnums=1)
jqconv = jax.jit(jquant.qconv, static_argnums=(3, 4))
jqdot = jax.jit(jquant.qdot)
jwconv = jax.jit(jquant.wconv, static_argnums=(3, 4, 5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _static(padding):
    """Explicit padding as a hashable tuple, for a static jit argument."""
    return padding if isinstance(padding, str) else tuple(tuple(p) for p in padding)


# (x shape (B, *spatial, Cin), Cout, window, strides, padding)
CONV_CASES = [
    ((2, 9, 7, 12), 10, 3, 1, "SAME"),
    ((2, 8, 8, 16), 24, 1, 1, "SAME"),
    ((3, 9, 8, 8), 8, 3, 2, [(1, 1), (1, 1)]),
    ((2, 8, 9, 8), 6, 3, 2, "SAME"),
    ((2, 5, 6, 4, 8), 12, 3, 1, "SAME"),
    ((2, 6, 4, 6, 16), 8, 3, 2, [(1, 1)] * 3),
]


def _ids(case):
    shape, cout, k, s, pad = case
    return f"{len(shape) - 2}d-k{k}-s{s}-{'same' if pad == 'SAME' else 'explicit'}"


def to_jax_kernel(w: np.ndarray) -> np.ndarray:
    """(Cout, Cin, *window) -> (*window, Cin, Cout)."""
    return np.ascontiguousarray(np.moveaxis(np.moveaxis(w, 0, -1), 0, -2))


def with_ties(rng, shape) -> np.ndarray:
    """Values of absmax exactly 127 (so the scale is 1.0) with a share of
    them on exact .5 ties, both signs, and a few out to the clamp."""
    x = rng.uniform(-127, 127, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    idx = rng.choice(n, size=n // 3, replace=False)
    flat[idx] = (rng.integers(-127, 127, size=idx.size) + 0.5).astype(np.float32)
    flat[0], flat[1] = 127.0, -126.5
    return x


@pytest.mark.parametrize("kind", ["uniform", "ties", "zeros"])
def test_quantize_int8_per_tensor_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = {"uniform": rng.normal(size=(4, 7, 5)).astype(np.float32) * 3,
         "ties": with_ties(rng, (4, 7, 5)),
         "zeros": np.zeros((3, 4), np.float32)}[kind]
    q, s = quant.quantize_int8(torch.from_numpy(x))
    jq, js = jquantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)  # bit for bit
    if kind == "ties":  # half to even: 2.5 -> 2, 3.5 -> 4; the clamp at -127
        assert s.item() == 1.0
        halves = (np.abs(x - np.trunc(x)) == 0.5)
        assert halves.sum() > 30
        assert np.all(q.numpy()[halves] % 2 == 0)
    if kind == "zeros":
        assert s.item() == 1.0 and not q.any()


@pytest.mark.parametrize("window", [(3, 3), (1, 1), (3, 3, 3), ()])
def test_quantize_int8_per_output_channel_matches_jax(window):
    """Per output channel over a PyTorch weight (dims 1 and up) against JAX
    over its kernel (all but the last axis); channel 0 is all zero (scale
    1), channel 1 holds exact .5 ties at scale 1."""
    rng = np.random.default_rng(1)
    cout, cin = 6, 5
    w = (rng.normal(size=(cout, cin) + window) * 0.2).astype(np.float32)
    w[0] = 0.0
    w[1] = with_ties(rng, (cin,) + window)
    q, s = quant.quantize_int8(torch.from_numpy(w), axes=tuple(range(1, w.ndim)))
    jk = to_jax_kernel(w) if window else w.T.copy()
    jq, js = jquantize(jnp.asarray(jk), tuple(range(jk.ndim - 1)))
    want_q = np.asarray(jq)
    want_q = np.moveaxis(np.moveaxis(want_q, -1, 0), -1, 1) if window else want_q.T
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0].item() == 1.0 and not q[0].any() and s[1].item() == 1.0


@pytest.mark.parametrize("kind", ["uniform", "ties", "zeros"])
def test_quantize_codes_plain_matches_jax(kind):
    """``quantize_codes``' plain version (the codes csrc/quant_codes.cu makes,
    channels zero-padded to a multiple of 16) on ``quant_absmax``'s scalar:
    the real channels bit for bit JAX's jitted per-tensor codes, the scale
    JAX's, the padding zero; half to even on .5 ties, 0 codes at scale 1 on
    zeros."""
    rng = np.random.default_rng(5)
    shape = (2, 3, 5, 24)  # Cin 24: padded to 32
    x = {"uniform": rng.normal(size=shape).astype(np.float32) * 3,
         "ties": with_ties(rng, shape),
         "zeros": np.zeros(shape, np.float32)}[kind]
    xt = torch.from_numpy(x)
    before = quant.quantize_codes.launches
    codes = quant.quantize_codes(xt, quant.quant_absmax(xt))
    assert quant.quantize_codes.launches == before  # the plain version on the CPU
    jq, js = jquantize(jnp.asarray(x))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == shape[:-1] + (32,)
    np.testing.assert_array_equal(codes[..., :24].numpy(), np.asarray(jq))
    assert not codes[..., 24:].any()
    assert quant.scale_of(quant.quant_absmax(xt)).item() == float(js)
    if kind == "ties":
        halves = np.abs(x - np.trunc(x)) == 0.5
        assert halves.sum() > 30 and np.all(codes[..., :24].numpy()[halves] % 2 == 0)
    if kind == "zeros":
        assert not codes.any()


def _unpack(packed: np.ndarray, cout: int, cin: int, taps: int) -> np.ndarray:
    """csrc/qconv_s8.cu's weight blocks back to (Cout, Cin, taps) codes: the
    row-r 16-byte chunk stored at position p is chunk p ^ (r % 8); each tap
    holds Cin channels padded to a multiple of 128."""
    cq, n = -(-cin // 128) * 128, -(-cout // 128) * 128
    blocks = packed.reshape(n // 128, taps * cq // 128, 128, 8, 16)
    r = np.arange(128)[:, None]
    blocks = np.take_along_axis(blocks, (np.arange(8)[None, :] ^ (r % 8))[None, None, :, :, None],
                                axis=3)
    rows = blocks.transpose(0, 2, 1, 3, 4).reshape(n, taps, cq)
    return rows[:cout, :, :cin].transpose(0, 2, 1)


@pytest.mark.parametrize("window", [(3, 3), (1, 1), (3, 3, 3), ()])
def test_packed_weight_decodes_to_jax_codes(window):
    """``quantize_weight``'s codes as ``pack_weight`` packs them for
    csrc/qconv_s8.cu on a card (each tap's channels zero-padded to 128, 128
    x 128-byte blocks in the 128-byte swizzle), decoded back, are JAX's
    per-output-channel codes; one code is found where the kernel's
    shared-memory layout puts it, and every padding byte is zero. Cout 130
    and Cin 136 cross a block edge."""
    rng = np.random.default_rng(6)
    cout, cin = 130, 136
    w = (rng.normal(size=(cout, cin) + window) * 0.2).astype(np.float32)
    wq = quant.quantize_weight(torch.from_numpy(w))
    packed = quant.pack_weight(wq.codes if window else wq.codes.unsqueeze(-1)).numpy()
    jk = to_jax_kernel(w) if window else w.T.copy()
    jq, _ = jquantize(jnp.asarray(jk), tuple(range(jk.ndim - 1)))
    want = np.asarray(jq)
    want = np.moveaxis(np.moveaxis(want, -1, 0), -1, 1) if window else want.T
    taps = int(np.prod(window)) if window else 1
    assert packed.dtype == np.int8 and packed.size == 256 * taps * 256
    np.testing.assert_array_equal(_unpack(packed, cout, cin, taps),
                                  want.reshape(cout, cin, taps))
    # output channel 5, tap 0, channel 17: K byte 17 of row 5 of block (0, 0),
    # 16-byte chunk 1 stored at chunk 1 ^ (5 % 8) = 4
    assert packed[5 * 128 + 4 * 16 + 1] == want.reshape(cout, cin, -1)[5, 17, 0]
    assert int(np.abs(packed.astype(np.int64)).sum()) == int(np.abs(want).sum())


def _conv_inputs(case, seed=2):
    shape, cout, k, stride, padding = case
    nd = len(shape) - 2
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(cout, shape[-1]) + (k,) * nd) / np.sqrt(shape[-1] * k ** nd))
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    return x, w.astype(np.float32), b, (stride,) * nd, padding


@pytest.mark.parametrize("case", CONV_CASES, ids=_ids)
def test_qconv_codes_sums_and_output_match_jax(case):
    x, w, b, strides, padding = _conv_inputs(case)
    nd = x.ndim - 2
    jk = to_jax_kernel(w)
    # codes and scales of both operands
    xq, sx = quant.quantize_int8(torch.from_numpy(x))
    jxq, jsx = jquantize(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert sx.item() == float(jsx)
    wq = quant.quantize_weight(torch.from_numpy(w))
    jwq, jsw = jquantize(jnp.asarray(jk), tuple(range(nd + 1)))
    np.testing.assert_array_equal(to_jax_kernel(wq.codes.numpy()), np.asarray(jwq))
    np.testing.assert_array_equal(wq.scale.numpy(), np.asarray(jsw))
    # exact int32 sums
    pads = quant.conv_padding(x.shape[1:-1], w.shape[2:], strides, padding)
    got = quant.s8_conv_sum(xq, wq.codes, strides, pads)
    want = jax.jit(lambda a, b: lax.conv_general_dilated(
        a, b, window_strides=strides, padding=padding,
        dimension_numbers=jquant._channel_last_dn(x.ndim),
        preferred_element_type=jnp.int32))(jxq, jwq)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the fp32 outputs, with and without a bias
    for bias in (b, None):
        out = quant.qconv(torch.from_numpy(x), torch.from_numpy(w),
                          None if bias is None else torch.from_numpy(bias), strides, padding)
        ref = np.asarray(jqconv(jnp.asarray(x), jnp.asarray(jk),
                                None if bias is None else jnp.asarray(bias),
                                strides, _static(padding)))
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=OUT_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(4, 16), (2, 9, 24)])
def test_qdot_codes_sums_and_output_match_jax(shape):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(12, shape[-1])) / np.sqrt(shape[-1])).astype(np.float32)
    b = (0.1 * rng.normal(size=12)).astype(np.float32)
    xq, _ = quant.quantize_int8(torch.from_numpy(x))
    wq = quant.quantize_weight(torch.from_numpy(w))
    jxq, _ = jquantize(jnp.asarray(x))
    jwq, jsw = jquantize(jnp.asarray(w.T.copy()), (0,))
    np.testing.assert_array_equal(wq.codes.numpy().T, np.asarray(jwq))
    np.testing.assert_array_equal(wq.scale.numpy(), np.asarray(jsw))
    want = lax.dot_general(jxq, jwq, (((x.ndim - 1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(quant.s8_dot_sum(xq, wq.codes).numpy(), np.asarray(want))
    out = quant.qdot(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    ref = np.asarray(jqdot(jnp.asarray(x), jnp.asarray(w.T.copy()), jnp.asarray(b)))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=OUT_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("case", [CONV_CASES[0], CONV_CASES[2], CONV_CASES[4]], ids=_ids)
def test_wconv_matches_jax(case):
    """The model's ``--quantize=w8`` convolution, ``WeightOnlyQuantConv``, in
    fp32 against JAX's ``wconv``: 3x3 at stride 1 ("SAME", pads 1) and at
    stride 2 with (1, 1) pads, as the UNet's sites use them, 2D and 3D."""
    x, w, b, strides, padding = _conv_inputs(case, seed=4)
    nd = x.ndim - 2
    conv = unet.WeightOnlyQuantConv(nd, w.shape[1], w.shape[0], w.shape[-1], strides[0])
    conv.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        out = conv(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    ref = np.asarray(jwconv(jnp.asarray(x), jnp.asarray(to_jax_kernel(w)),
                            jnp.asarray(b), strides, _static(padding), jnp.float32))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=WCONV_RTOL * np.abs(ref).max())


def test_plain_versions_on_the_cpu_launch_no_kernel():
    """On CPU tensors the wrappers take their plain versions: the launch
    counters stay put, and qconv_s8's int32 mode returns the exact sums."""
    x, w, b, strides, padding = _conv_inputs(CONV_CASES[0])
    before = (quant.quant_absmax.launches, quant.quantize_codes.launches,
              quant.qconv_s8.launches)
    xt = torch.from_numpy(x)
    absmax = quant.quant_absmax(xt)
    assert absmax.item() == np.abs(x).max()
    wq = quant.quantize_weight(torch.from_numpy(w))
    assert wq.packed is None  # packed for the kernel only on a card
    pads = quant.conv_padding(x.shape[1:-1], w.shape[2:], strides, padding)
    sums = quant.qconv_s8(xt, absmax, wq, None, strides, pads, torch.int32)
    xq, _ = quant.quantize_int8(xt)
    assert torch.equal(sums, quant.s8_conv_sum(xq, wq.codes, strides, pads))
    y = quant.qconv_s8(xt, absmax, wq, torch.from_numpy(b), strides, pads, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert (quant.quant_absmax.launches, quant.quantize_codes.launches,
            quant.qconv_s8.launches) == before


def test_weight_cache_follows_in_place_writes_and_new_storage():
    """``WeightCache`` rebuilds after ``copy_`` (load_state_dict's write)
    and after a parameter takes new storage, and not otherwise."""
    p = torch.nn.Parameter(torch.randn(4, 3))
    cache, calls = quant.WeightCache(), []

    def make(t):
        calls.append(1)
        return t.clone()

    first = cache.get(p, make)
    assert cache.get(p, make) is first and len(calls) == 1
    with torch.no_grad():
        p.copy_(torch.randn(4, 3))
    assert torch.equal(cache.get(p, make), p.detach()) and len(calls) == 2
    p.data = torch.randn(4, 3)
    assert torch.equal(cache.get(p, make), p.detach()) and len(calls) == 3
