"""Dynamic int8 quantisation of the scoring UNet's convolutions and dense layers.

Port of ``ddpm_ood_tpu/ops/quant.py``. Weights are quantised symmetrically
per output channel, activations per tensor with a dynamic (per-call) absmax
scale, and the product runs s8 x s8 -> s32 with an fp32 dequantising
epilogue: ``y = float(sum) * (sx * sw) + bias``. No calibration: any
checkpoint scores quantised as it is, because the quantised modules hold the
unquantised model's parameters (``models/unet.py``).

Layouts are the JAX package's for activations: x is channels-last, (B,
*spatial, Cin) with 1 to 3 spatial dims. Weights keep PyTorch's layouts,
(Cout, Cin, *window) for a convolution and (O, I) for ``nn.Linear``, so
their per-output-channel scales reduce over dims 1 and up (JAX's kernels are
(*window, Cin, Cout) and (I, O), reduced over all but the last axis).

Three kernels serve ``qconv`` and ``qdot`` on the card, each beside its
plain PyTorch version and counting its launches in ``.launches``:

- ``quant_absmax`` (``csrc/quant_absmax.cu``): max|x| into a device scalar,
  so that the scale never leaves the card;
- ``quantize_codes`` (``csrc/quant_codes.cu``): the activation's int8 codes
  under that scale (``x / sx`` rounded half to even, clamped to +-127), made
  once a call, channels zero-padded to a multiple of 16;
- ``qconv_s8`` (``csrc/qconv_s8.cu``): the implicit-GEMM convolution of those
  codes with the packed weight codes on the warpgroup s8 tensor cores
  (``wgmma``), dequantised in its epilogue. It launches ``quantize_codes``
  first. ``qdot`` is a 1x1 convolution over a (1, tokens, C) view.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. The plain s8 x s8 sum is exact: a float64
convolution or matmul of the integer codes, cast to int32 (every partial sum
is an integer below 2^31, exact in float64). JAX's ``wconv``
(``--quantize=w8``) is the model's ``WeightOnlyQuantConv``, plain PyTorch on
every device as JAX's is XLA work: the codes dequantised in the compute
dtype (``dequantize_weight``), then an ordinary convolution.

A scoring batch spread over the ranks of a torchrun launch quantises with
the global activation absmax, as JAX's GSPMD program does: inside
``absmax_over_processes`` each ``quant_absmax`` is all-reduced with MAX
over the process group, on the card's stream under NCCL and through a host
copy under gloo. ``QuantConv``, ``QuantDense``, ``qconv`` and ``qdot`` call
it without knowing of ranks; ``--quantize=w8`` has no activation scale and
no collective.

``quantize_weight`` is the O(params) weight side, done once per load of the
weights by the modules (``WeightCache``) where JAX re-quantises per call and
XLA hoists it out of the sampler's scan.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import math
from typing import Callable, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..parallel import mesh as pmesh
from . import _kernels

Padding = Union[str, Sequence[Tuple[int, int]]]

# csrc/qconv_s8.cu's tiles: packed weights are zero-padded to these multiples
TILE_N, TILE_K = 128, 128
# the codes' channels are zero-padded to this multiple (its 16-byte copies)
CHANNEL_ALIGN = 16
# the kernel's exactness limit on K = window x Cin: K * 127^2 < 2^31
MAX_K = 133_000
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


# float32(1 / 127), 0x1.020408p-7: the JAX package's scales are
# max|x| * RECIP_127, not max|x| / 127. Its program runs jitted, and XLA
# rewrites a division by a constant as a product with the constant's
# reciprocal (the two differ in the last bit for ~4% of values); the
# division of x by its scale stays a division.
RECIP_127 = 0.007874015718698502


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """The fp32 scale of a max |x|: amax * float32(1 / 127), each product
    rounded once (a tensor operand: PyTorch may keep a Python float in
    float64), 1 where it is 0."""
    scale = amax.float() * torch.full_like(amax, RECIP_127, dtype=torch.float32)
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale), the IEEE quotient rounded half to even (a tensor
    divisor: PyTorch multiplies a CUDA tensor by the reciprocal of a Python
    float), clamped to +-127, as int8."""
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor, axes: Optional[Tuple[int, ...]] = None):
    """Symmetric absmax int8 quantisation, JAX's ``quantize_int8`` as its
    jitted program computes it (scale = max|x| * RECIP_127).

    axes=None: one scale for the whole tensor; axes=tuple: reduce over those
    dims (per output channel: dims 1 and up of a PyTorch weight). Returns
    (q int8, scale float32) with x ~= q * scale: q = round(x / scale), the
    IEEE quotient rounded half to even, clamped to +-127; a zero scale
    becomes 1."""
    xf = x.float()
    scale = scale_of(xf.abs().amax() if axes is None else xf.abs().amax(dim=axes))
    if axes is None:
        return _codes(xf, scale), scale
    # broadcast the kept dims' scale back over the reduced ones
    shape = [1 if i in axes else s for i, s in enumerate(x.shape)]
    return _codes(xf, scale.reshape(shape)), scale


def conv_padding(spatial: Sequence[int], window: Sequence[int],
                 strides: Sequence[int], padding: Padding) -> list:
    """Per-axis (lo, hi) padding: XLA's "SAME" (out = ceil(in / stride), the
    odd pixel on the high side), "VALID", or explicit pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return [(0, 0)] * len(spatial)
        if padding != "SAME":
            raise ValueError(f"padding must be 'SAME', 'VALID' or (lo, hi) pairs, got {padding!r}")
        pads = []
        for n, k, s in zip(spatial, window, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    return [tuple(int(p) for p in pair) for pair in padding]


def _out_spatial(spatial, window, strides, pads) -> tuple:
    return tuple((n + lo + hi - k) // s + 1
                 for n, k, s, (lo, hi) in zip(spatial, window, strides, pads))


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute((0, x.dim() - 1) + tuple(range(1, x.dim() - 1)))


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    return y.permute((0,) + tuple(range(2, y.dim())) + (1,))


def _conv(x: torch.Tensor, w: torch.Tensor, strides, pads) -> torch.Tensor:
    """Channels-last x (B, *spatial, Cin) by w (Cout, Cin, *window) with
    (lo, hi) pads: F.conv1d/2d/3d on a channels-first view, the result
    channels-last (a view)."""
    fn = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[x.dim() - 2]
    xc = _channels_first(x)
    if all(lo == hi for lo, hi in pads):
        out = fn(xc, w, stride=tuple(strides), padding=tuple(lo for lo, _ in pads))
    else:  # asymmetric: pad first (F.pad takes the last axis first)
        xc = F.pad(xc, [p for lo, hi in reversed(pads) for p in (lo, hi)])
        out = fn(xc, w, stride=tuple(strides))
    return _channels_last(out)


def s8_conv_sum(xq: torch.Tensor, wq: torch.Tensor, strides, pads) -> torch.Tensor:
    """Exact int32 sums of int8 codes: xq (B, *spatial, Cin), wq (Cout, Cin,
    *window), as a float64 convolution (integer partial sums below 2^31 are
    exact there) cast to int32; (B, *out, Cout) contiguous."""
    with torch.autocast(xq.device.type, enabled=False):
        out = _conv(xq.to(torch.float64), wq.to(torch.float64), strides, pads)
    return torch.round(out).to(torch.int32).contiguous()  # round: a library may sum by FFT


def s8_dot_sum(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of xq (..., I) by wq (O, I), in float64."""
    with torch.autocast(xq.device.type, enabled=False):
        out = xq.to(torch.float64) @ wq.to(torch.float64).T
    return torch.round(out).to(torch.int32)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """JAX's epilogue: float32(acc) * (sx * sw) (+ bias), each op rounded."""
    out = acc.to(torch.float32) * (sx * sw)
    if bias is not None:
        out = out + bias.float()
    return out


@dataclasses.dataclass(frozen=True)
class Int8Weight:
    """A weight quantised per output channel: ``codes`` in its PyTorch layout
    ((Cout, Cin, *window), or (O, I) for a dense layer), ``scale`` (Cout,)
    fp32, and on CUDA ``packed``, the codes as the kernel reads them
    (``pack_weight``)."""

    codes: torch.Tensor
    scale: torch.Tensor
    packed: Optional[torch.Tensor] = None

    @property
    def window(self) -> tuple:
        return tuple(self.codes.shape[2:])


def padded_channels(cin: int) -> int:
    """The codes' channel count for Cin channels: a multiple of CHANNEL_ALIGN."""
    return -(-cin // CHANNEL_ALIGN) * CHANNEL_ALIGN


def tap_channels(cin: int) -> int:
    """The packed weight's K run a window tap: Cin padded to a multiple of
    TILE_K, so that each K slice the kernel loads is one tap's channels."""
    return -(-cin // TILE_K) * TILE_K


def pack_weight(codes: torch.Tensor) -> torch.Tensor:
    """Weight codes (Cout, Cin, *window) as csrc/qconv_s8.cu reads them: rows
    (Cout, *window, Cq) with each tap's channels zero-padded to Cq =
    ``tap_channels(Cin)``, flattened to (Cout, Kp) and zero-padded to Np
    rows, a multiple of TILE_N; then cut into (Np / TILE_N, Kp / TILE_K)
    blocks of TILE_N rows by TILE_K bytes, each block contiguous with its
    rows' 16-byte chunks in the 128-byte swizzle (chunk j of row r at chunk j
    ^ (r % 8)): the shared-memory layout wgmma reads, placed by one bulk
    copy. Returns the flat int8 tensor of Np * Kp bytes."""
    cout, cin = codes.shape[:2]
    rows = codes.permute((0,) + tuple(range(2, codes.dim())) + (1,))  # (Cout, *window, Cin)
    rows = F.pad(rows, (0, tap_channels(cin) - cin)).reshape(cout, -1)
    n, k = -(-cout // TILE_N) * TILE_N, rows.shape[1]
    rows = F.pad(rows, (0, 0, 0, n - cout))
    blocks = rows.reshape(n // TILE_N, TILE_N, k // TILE_K, 8, 16).permute(0, 2, 1, 3, 4)
    # chunk p of swizzled row r holds chunk p ^ (r % 8)
    r = torch.arange(TILE_N, device=codes.device)[:, None]
    idx = (torch.arange(8, device=codes.device)[None, :] ^ (r % 8))[None, None, :, :, None]
    return torch.gather(blocks, 3, idx.expand(blocks.shape)).contiguous().reshape(-1)


def quantize_weight(weight: torch.Tensor) -> Int8Weight:
    """Per-output-channel int8 codes and scales of a conv or linear weight,
    packed for the kernel (``pack_weight``; a dense layer as a width-1
    convolution) when the weight lies on a CUDA card."""
    codes, scale = quantize_int8(weight.detach(), axes=tuple(range(1, weight.dim())))
    packed = None
    if codes.device.type == "cuda":
        packed = pack_weight(codes if codes.dim() > 2 else codes.unsqueeze(-1))
    return Int8Weight(codes, scale, packed)


def dequantize_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``--quantize=w8``'s weight: the per-output-channel codes times their scales,
    both first cast to `dtype` (JAX: wq.astype(dtype) * sw.astype(dtype))."""
    codes, scale = quantize_int8(weight.detach(), axes=tuple(range(1, weight.dim())))
    return codes.to(dtype) * scale.to(dtype).reshape((-1,) + (1,) * (weight.dim() - 1))


class WeightCache:
    """The value ``make(param)`` for one parameter, rebuilt when the
    parameter changes: another storage (``model.to``, ``load_state_dict(...,
    assign=True)``) or an in-place write (``load_state_dict``'s ``copy_``, an
    optimizer step), which moves the version counter that ``detach()``
    shares. The cache holds the storage it was built from, so that its
    address cannot be reused by another tensor while it is cached. It is a
    plain attribute, not a buffer: ``state_dict`` stays the unquantised
    model's."""

    def __init__(self):
        self._src: Optional[torch.Tensor] = None
        self._version = -1
        self._key = None
        self._value = None

    def get(self, param: torch.Tensor, make: Callable, *key):
        src = self._src
        if (src is None or param.data_ptr() != src.data_ptr() or param.device != src.device
                or param._version != self._version or key != self._key):
            self._src = param.detach()
            self._version, self._key = param._version, key
            with torch.no_grad():
                self._value = make(self._src, *key)
        return self._value


def quant_absmax_reference(x: torch.Tensor) -> torch.Tensor:
    """max |x| in fp32, a 0-dim tensor on x's device."""
    return x.float().abs().amax()


_OVER_PROCESSES: contextvars.ContextVar = contextvars.ContextVar("absmax_over_processes",
                                                                 default=False)


@contextlib.contextmanager
def absmax_over_processes() -> Iterator[None]:
    """For the length of a sharded call (``recon.sweep.ReconProgram``), every
    ``quant_absmax`` of this thread is the max over the process group: the
    call's batch is spread over the ranks, and JAX's GSPMD program takes
    each activation scale over the whole batch. Every rank must then make
    the same quantised calls in the same order. The identity for one
    process."""
    token = _OVER_PROCESSES.set(True)
    try:
        yield
    finally:
        _OVER_PROCESSES.reset(token)


def quant_absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| of a bf16 or fp32 tensor as a 0-dim fp32 tensor on its device:
    the plain version on the CPU, ``csrc/quant_absmax.cu`` on a CUDA card
    (counted in ``quant_absmax.launches``), which raises on anything else.
    Inside ``absmax_over_processes`` the result is then all-reduced with MAX
    over the process group (``parallel.mesh.all_reduce_max_``)."""
    if x.device.type == "cpu":
        out = quant_absmax_reference(x)
    else:
        device, stream = _kernels.cuda_target(x, "quant_absmax")
        if x.dtype not in _kernels.DTYPE_CODES:
            raise TypeError(f"quant_absmax: dtype {x.dtype} not in (float32, bfloat16)")
        if not x.is_contiguous() or x.numel() == 0:
            raise ValueError("quant_absmax: x must be contiguous and not empty")
        out = torch.empty((), dtype=torch.float32, device=x.device)  # zeroed by the call
        _kernels.call("ddpm_quant_absmax", x.data_ptr(), x.numel(),
                      _kernels.DTYPE_CODES[x.dtype], out.data_ptr(), device, stream)
        quant_absmax.launches += 1
    if _OVER_PROCESSES.get():
        pmesh.all_reduce_max_(out)
    return out


quant_absmax.launches = 0


def quantize_codes_reference(x: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """The plain version of ``quantize_codes``: ``_codes`` under
    ``scale_of(absmax)``, the channels zero-padded to ``padded_channels``."""
    q = _codes(x, scale_of(absmax))
    return F.pad(q, (0, padded_channels(x.shape[-1]) - x.shape[-1]))


def quantize_codes(x: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """The int8 codes of channels-last x (B, *spatial, Cin) under the
    per-tensor scale of `absmax` (max|x|, a 0-dim fp32 tensor on x's device),
    (B, *spatial, Cp) with the channels zero-padded to ``padded_channels``:
    the plain version on the CPU, ``csrc/quant_codes.cu`` on a CUDA card
    (counted in ``quantize_codes.launches``), which raises on anything else,
    Cin not a multiple of 8 or x off a 16-byte boundary among it."""
    if x.device.type == "cpu":
        return quantize_codes_reference(x, absmax)
    device, stream = _kernels.cuda_target(x, "quantize_codes")
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"quantize_codes: x dtype {x.dtype} not in (float32, bfloat16)")
    _check_loads(x, "quantize_codes")
    _check_scalar(absmax, "absmax", 1, x.device, "quantize_codes")
    cin = x.shape[-1]
    codes = torch.empty(x.shape[:-1] + (padded_channels(cin),), dtype=torch.int8,
                        device=x.device)
    _kernels.call("ddpm_quant_codes", x.data_ptr(), _kernels.DTYPE_CODES[x.dtype],
                  absmax.data_ptr(), codes.data_ptr(), x.numel() // cin, cin, codes.shape[-1],
                  device, stream)
    quantize_codes.launches += 1
    return codes


quantize_codes.launches = 0


def qconv_s8_reference(x: torch.Tensor, absmax: torch.Tensor, w: Int8Weight,
                       bias: Optional[torch.Tensor], strides: Sequence[int], pads,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of ``qconv_s8``: quantise x with sx =
    ``scale_of(absmax)``, sum exactly, dequantise; the int32 sums themselves
    for out_dtype int32."""
    sx = scale_of(absmax)
    acc = s8_conv_sum(_codes(x, sx), w.codes, strides, pads)
    if out_dtype == torch.int32:
        return acc
    return dequantize(acc, sx, w.scale, bias).to(out_dtype)


def _check_loads(x: torch.Tensor, what: str) -> None:
    """The codes kernel's 16-byte loads: 8 channels a load, from a
    contiguous channels-last x on a 16-byte boundary."""
    cin = x.shape[-1]
    if cin % 8 != 0 or x.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: Cin ({cin}) must be a multiple of 8 and x must start "
                         "on a 16-byte boundary")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{what}: x must be contiguous channel-last (B, *spatial, C), not empty")


def _check_scalar(t: Optional[torch.Tensor], name: str, n: int, device, what: str) -> None:
    if t is not None and (t.dtype != torch.float32 or t.numel() != n or t.device != device
                          or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be {n} contiguous float32 on {device}")


def _check_cuda_args(x, absmax, w, bias, strides, pads, out_dtype) -> None:
    nd = x.dim() - 2
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"qconv_s8: x dtype {x.dtype} not in (float32, bfloat16)")
    if not 1 <= nd <= 3 or len(w.window) != nd or len(strides) != nd or len(pads) != nd:
        raise ValueError(f"qconv_s8: x {tuple(x.shape)}, window {w.window}, strides "
                         f"{tuple(strides)} and pads {pads} disagree on the spatial rank (1-3)")
    if out_dtype not in OUT_CODES:
        raise TypeError(f"qconv_s8: out_dtype {out_dtype} not in {tuple(OUT_CODES)}")
    cout, cin = w.codes.shape[:2]
    if x.shape[-1] != cin:
        raise ValueError(f"qconv_s8: x has {x.shape[-1]} channels, the weight {cin}")
    _check_loads(x, "qconv_s8")
    if math.prod(w.window) * cin >= MAX_K:
        raise ValueError(f"qconv_s8: K = {math.prod(w.window) * cin} would overflow int32 sums")
    if w.packed is None or w.packed.device != x.device:
        raise ValueError("qconv_s8: the weight is not packed on x's card (quantize_weight)")
    for name, t, n in (("absmax", absmax, 1), ("scale", w.scale, cout), ("bias", bias, cout)):
        _check_scalar(t, name, n, x.device, "qconv_s8")


def qconv_s8(x: torch.Tensor, absmax: torch.Tensor, w: Int8Weight,
             bias: Optional[torch.Tensor], strides: Sequence[int], pads,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 convolution of channels-last x (B, *spatial, Cin), 1 to 3
    spatial dims, by a quantised weight, with the activation scale taken from
    `absmax` (max|x|, a 0-dim fp32 tensor) and (lo, hi) `pads` per axis.
    Returns (B, *out, Cout) in out_dtype (float32, bfloat16, or int32 for the
    raw sums). The plain version on the CPU; on a CUDA card
    ``quantize_codes`` and then ``csrc/qconv_s8.cu`` (counted in
    ``qconv_s8.launches``), which raise on anything else, Cin not a multiple
    of 8 or x off a 16-byte boundary among it."""
    if x.device.type == "cpu":
        return qconv_s8_reference(x, absmax, w, bias, strides, pads, out_dtype)
    device, stream = _kernels.cuda_target(x, "qconv_s8")
    _check_cuda_args(x, absmax, w, bias, strides, pads, out_dtype)
    nd = x.dim() - 2
    spatial, window = tuple(x.shape[1:-1]), w.window
    out = _out_spatial(spatial, window, strides, pads)
    if min(out) < 1:
        raise ValueError(f"qconv_s8: no output positions for {spatial} by {window}")
    cout = w.codes.shape[0]
    codes = quantize_codes(x, absmax)
    y = torch.empty((x.shape[0],) + out + (cout,), dtype=out_dtype, device=x.device)
    pad3 = lambda v, fill: (fill,) * (3 - nd) + tuple(v)  # noqa: E731 (2D as D = 1)
    kp = w.packed.numel() // (-(-cout // TILE_N) * TILE_N)
    geo = ((x.shape[0],) + pad3(spatial, 1) + (codes.shape[-1],) + pad3(out, 1) + (cout,)
           + pad3(window, 1) + pad3(strides, 1) + pad3([lo for lo, _ in pads], 0) + (kp,))
    _kernels.call("ddpm_qconv_s8", codes.data_ptr(), absmax.data_ptr(), w.packed.data_ptr(),
                  w.scale.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
                  OUT_CODES[out_dtype], (ctypes.c_int * len(geo))(*geo), device, stream)
    qconv_s8.launches += 1
    return y


qconv_s8.launches = 0


def _as_conv(w: Int8Weight) -> Int8Weight:
    """A dense layer's weight as a width-1 convolution's: codes (O, I, 1)."""
    return dataclasses.replace(w, codes=w.codes.unsqueeze(-1))


def qdot_s8_reference(x: torch.Tensor, absmax: torch.Tensor, w: Int8Weight,
                      bias: Optional[torch.Tensor],
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of ``qdot_s8``: quantise, ``s8_dot_sum``, dequantise."""
    sx = scale_of(absmax)
    acc = s8_dot_sum(_codes(x, sx), w.codes)
    if out_dtype == torch.int32:
        return acc
    return dequantize(acc, sx, w.scale, bias).to(out_dtype)


def qdot_s8(x: torch.Tensor, absmax: torch.Tensor, w: Int8Weight,
            bias: Optional[torch.Tensor], out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 dense layer x (..., I) by a quantised (O, I) weight: on a CUDA
    card ``qconv_s8`` as a 1x1 convolution over a (1, tokens, I) view, on
    the CPU ``qdot_s8_reference``; (..., O)."""
    if x.device.type == "cpu":
        return qdot_s8_reference(x, absmax, w, bias, out_dtype)
    lead, i = x.shape[:-1], x.shape[-1]
    y = qconv_s8(x.reshape(1, -1, i), absmax, _as_conv(w), bias, (1,), [(0, 0)], out_dtype)
    return y.reshape(lead + (w.codes.shape[0],))


def qconv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
          strides: Optional[Sequence[int]] = None, padding: Padding = "SAME") -> torch.Tensor:
    """int8 x int8 -> int32 channels-last convolution with fp32 dequant, JAX's
    ``qconv``: x (B, *spatial, Cin), weight (Cout, Cin, *window); activation
    scale per tensor, weight scale per output channel. Returns fp32."""
    strides = tuple(strides) if strides else (1,) * (x.dim() - 2)
    pads = conv_padding(x.shape[1:-1], weight.shape[2:], strides, padding)
    x = x.contiguous()
    return qconv_s8(x, quant_absmax(x), quantize_weight(weight), bias, strides, pads)


def qdot(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """int8 x int8 -> int32 dense layer, JAX's ``qdot``: x (..., I) by an
    ``nn.Linear`` weight (O, I). Returns fp32."""
    x = x.contiguous()
    return qdot_s8(x, quant_absmax(x), quantize_weight(weight), bias)

