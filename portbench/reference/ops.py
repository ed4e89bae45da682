"""The products the reference computes: convolutions, transposed
convolutions, dense layers and matrix products, in float32 with TF32 off.

``Ops(operand_dtype=torch.float8_e4m3fn)`` is the precision control of a
bf16 cell, the reference computed in float8 as the program computes in
bf16 under autocast: every operand of every product is rounded to float8
(activations scaled per sample by their largest magnitude, weights per
tensor), the products summed in float32, and each product's output rounded
to float8 again, as autocast hands a bf16 product's output on in bf16.
``Ops(operand_dtype="int4")`` is the control of an int8 cell, the same with
every operand rounded to the 15 levels of int4 (-7..7 steps of the largest
magnitude over 7). Gradients pass the rounding unchanged (straight
through). ``CONTROLS`` names them for a cell's ``traffic["program"]``."""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def no_tf32() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


INT4_TOP = 7


def round_to(x: torch.Tensor, dtype, per_sample: bool) -> torch.Tensor:
    """x rounded to `dtype` (a float dtype, or "int4") and back, scaled so
    that its largest magnitude (per leading index with `per_sample`) maps to
    the dtype's largest finite value; the gradient is the identity."""
    top = INT4_TOP if dtype == "int4" else torch.finfo(dtype).max
    dims = tuple(range(1, x.dim())) if per_sample and x.dim() > 1 else None
    amax = x.detach().abs().amax(dim=dims, keepdim=True) if dims else x.detach().abs().amax()
    scale = torch.clamp(amax, min=1e-30) / top
    q = x.detach() / scale
    q = torch.round(q).clamp(-top, top) if dtype == "int4" else q.to(dtype).to(x.dtype)
    return x + (q * scale - x).detach()


@dataclasses.dataclass(frozen=True)
class Ops:
    operand_dtype: Union[torch.dtype, str, None] = None

    def _act(self, x):
        return x if self.operand_dtype is None else round_to(x, self.operand_dtype, True)

    def _w(self, w):
        return w if self.operand_dtype is None else round_to(w, self.operand_dtype, False)

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return self._act(_CONV[x.dim() - 2](self._act(x), self._w(w), b, stride, padding,
                                            dilation))

    def conv_t(self, x, w, b=None, stride=1, padding=0, output_padding=0, dilation=1):
        return self._act(_CONV_T[x.dim() - 2](self._act(x), self._w(w), b, stride, padding,
                                              output_padding, 1, dilation))

    def linear(self, x, w, b=None):
        return self._act(F.linear(self._act(x), self._w(w), b))

    def matmul(self, a, b):
        """a @ b, both activations (attention's two products)."""
        return self._act(torch.matmul(self._act(a), self._act(b)))


FP32 = Ops()

CONTROLS = {"reference_fp8": Ops(torch.float8_e4m3fn), "reference_int4": Ops("int4")}
