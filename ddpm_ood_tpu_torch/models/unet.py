"""Time-conditioned diffusion UNet (2D or 3D) with monai-generative state_dict names.

Port of ``ddpm_ood_tpu/models/unet.py``. Module names follow
monai-generative's ``DiffusionModelUNet`` (``conv_in.conv``,
``down_blocks.{L}.resnets.{j}.conv1.conv``, ``middle_block.resnet_1``,
``out.2.conv``, ...), so a reference ``.pth`` loads with ``strict=True``; the
key sets equal ``tests/fixtures/monai_generative_unet_keys_{small,big}_2d.txt``.

Layout: tensors are (B, C, *spatial) in ``torch.channels_last`` memory format
(2D) or ``torch.channels_last_3d`` (3D), ``memory_format(spatial_dims)``.
Such a tensor permuted to (B, *spatial, C) is contiguous, which is the layout
the GroupNorm kernel and the attention block read, so neither pays a
transpose. Attention runs over the flattened spatial tokens in 2D and 3D.
Parameters stay fp32; on CUDA the trainer runs the forward under
``torch.autocast(bfloat16)``, so convolutions and projections compute in
bf16 while GroupNorm keeps fp32 statistics, as the JAX package does on its
accelerator.

Numerics that differ from torch defaults on purpose: GroupNorm eps is 1e-6,
the downsample pads (1, 1) at stride 2 (torch ``padding=1``), the timestep
embedding puts sin before cos with width ``num_channels[0]``.

``remat=True`` recomputes every res and attention block in the backward
pass (``torch.utils.checkpoint``, non-reentrant), as the JAX package wraps
them in ``nn.remat``: a block keeps only its inputs for the backward, and
runs its forward again there, GroupNorm and flash kernels included. It
changes memory and time, never values, and does nothing without gradients.

``quant`` (scoring-time post-training quantisation, ``ops/quant.py``):
``"int8"`` runs every res-block, downsample and upsample convolution and
the attention projections s8 x s8 -> s32 (``QuantConv``, ``QuantDense``);
``"w8"`` the same convolutions with per-channel int8 weights dequantised in
the compute dtype (``WeightOnlyQuantConv``; the attention projections stay
unquantised); ``"mixed"`` quantises only the convolutions with
min(cin, cout) >= ``MIXED_QUANT_MIN_CH`` and the projections of at least
that width (none in the tiny and small presets). ``conv_in``, ``conv_out``,
``time_emb_proj`` and the time MLP stay unquantised in every mode. The
quantised modules hold the same parameters, under the same names and
shapes, as the unquantised ones, so every checkpoint loads unchanged. Each
computes in the autocast dtype where autocast is on (bf16 on the card), as
the JAX modules compute in ``self.dtype``, and returns that dtype.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.groupnorm import groupnorm_act
from ..ops.quant import (WeightCache, dequantize_weight, qconv_s8, qdot_s8, quant_absmax,
                         quantize_weight)

QUANT_MODES = ("none", "int8", "w8", "mixed")


def memory_format(spatial_dims: int) -> torch.memory_format:
    """The channels-last format of (B, C, *spatial) activations."""
    return torch.channels_last_3d if spatial_dims == 3 else torch.channels_last


def _to_channels_last_dims(x: torch.Tensor) -> torch.Tensor:
    """(B, C, *spatial) -> (B, *spatial, C), a view."""
    return x.permute((0,) + tuple(range(2, x.dim())) + (1,))


def _to_channels_first_dims(y: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, C) -> (B, C, *spatial), a view."""
    return y.permute((0, y.dim() - 1) + tuple(range(1, y.dim() - 1)))


class FusedGroupNormAct(nn.Module):
    """GroupNorm (+ SiLU) over a (B, C, *spatial) tensor through
    ``ops.groupnorm_act``; parameters named like ``nn.GroupNorm``'s."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 act: str = "none"):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, *spatial, C): a free view of a channels-last tensor, else a copy
        y = groupnorm_act(_to_channels_last_dims(x).contiguous(), self.weight, self.bias,
                          self.num_groups, self.eps, self.act)
        return _to_channels_first_dims(y)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, sin then cos (monai-generative's convention)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def PlainConv(dims: int, cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Module:
    """The unquantised convolution: ``nn.Conv2d`` or ``nn.Conv3d``, padding
    kernel // 2 on both sides of every axis (JAX's Downsample pads (1, 1) at
    stride 2, and "SAME" is (1, 1) or (0, 0) at stride 1)."""
    return {2: nn.Conv2d, 3: nn.Conv3d}[dims](cin, cout, kernel, stride=stride,
                                              padding=kernel // 2)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a layer computes in: autocast's where autocast is on for x's
    device (bf16 on the card), else x's (fp32 on the CPU)."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


class _QuantConvBase(nn.Module):
    """``weight`` (Cout, Cin, *window) and ``bias`` (Cout,) taken from a
    fresh ``PlainConv``, so names, shapes and default init are nn.Conv's, and
    a cache of their quantised form (``ops.quant.WeightCache``)."""

    def __init__(self, dims: int, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        plain = PlainConv(dims, cin, cout, kernel, stride)
        self.weight, self.bias = plain.weight, plain.bias
        self.strides = (stride,) * dims
        self.pads = [(kernel // 2, kernel // 2)] * dims
        self._cache = WeightCache()


class QuantConv(_QuantConvBase):
    """``--quantize=int8`` (JAX ``QuantConv``): per-output-channel int8
    weights, quantised once per load of the weights; the activation
    quantised per tensor, per call, on the card inside ``qconv_s8`` after one
    ``quant_absmax``; int32 sums dequantised in fp32, returned in the compute
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(x)
        xl = _to_channels_last_dims(x.to(dtype)).contiguous()  # free for channels-last x
        w = self._cache.get(self.weight, quantize_weight)
        return _to_channels_first_dims(
            qconv_s8(xl, quant_absmax(xl), w, self.bias, self.strides, self.pads, dtype))


class WeightOnlyQuantConv(_QuantConvBase):
    """``--quantize=w8`` (JAX ``WeightOnlyQuantConv``): the per-output-channel
    int8 weight dequantised in the compute dtype (kept until the weights
    change), then an ordinary convolution in that dtype with the bias, as
    the unquantised layers run under autocast. Plain PyTorch, as JAX's
    ``wconv`` is XLA work. In fp32 this is JAX's ``wconv`` arithmetic; in
    bf16 the bias is added inside the convolution before its output is
    rounded, where XLA adds it in fp32 after."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(x)
        w = self._cache.get(self.weight, dequantize_weight, dtype)
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        return conv(x.to(dtype), w, self.bias.to(dtype), self.strides,
                    [lo for lo, _ in self.pads])


class QuantDense(nn.Linear):
    """``--quantize=int8`` attention projections (JAX ``QuantDense``):
    ``nn.Linear``'s parameters, the product as ``qdot_s8``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        self._cache = WeightCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(x)
        x = x.to(dtype).contiguous()
        w = self._cache.get(self.weight, quantize_weight)
        return qdot_s8(x, quant_absmax(x), w, self.bias, dtype)


# s8 x s8 won over bf16 only at wide convolutions in the JAX package's TPU
# measurements (models/unet.py there); "mixed" quantises exactly the convs
# and projections at or above this width. Not re-tuned on the card.
MIXED_QUANT_MIN_CH = int(os.environ.get("DDPM_OOD_TPU_MIXED_MIN_CH", "512"))


def _pick_conv(quant: str | None, cin: int, cout: int):
    if quant == "int8":
        return QuantConv
    if quant == "w8":
        return WeightOnlyQuantConv
    if quant == "mixed":
        return QuantConv if min(cin, cout) >= MIXED_QUANT_MIN_CH else PlainConv
    return PlainConv


def _pick_dense(quant: str | None, ch: int):
    if quant == "int8":
        return QuantDense
    if quant == "mixed" and ch >= MIXED_QUANT_MIN_CH:
        return QuantDense
    return nn.Linear  # w8: the attention projections stay unquantised


class _Conv(nn.Module):
    """A 2D or 3D conv wrapped one level deep, for monai's ``.conv`` key
    segment; ``quant`` picks its class (``_pick_conv``)."""

    def __init__(self, dims: int, cin: int, cout: int, kernel: int, stride: int = 1,
                 quant: str | None = None):
        super().__init__()
        self.conv = _pick_conv(quant, cin, cout)(dims, cin, cout, kernel, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _Remat(nn.Module):
    """A block whose forward is recomputed in the backward pass when
    ``remat`` is set and gradients are on (``make_unet(..., remat=True)``)."""

    remat = False

    def __call__(self, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(super().__call__, *args, use_reentrant=False)
        return super().__call__(*args)


class ResnetBlock(_Remat):
    def __init__(self, dims: int, in_ch: int, out_ch: int, temb_ch: int, norm_num_groups: int,
                 quant: str | None = None):
        super().__init__()
        self.norm1 = FusedGroupNormAct(norm_num_groups, in_ch, act="silu")
        self.conv1 = _Conv(dims, in_ch, out_ch, 3, quant=quant)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = FusedGroupNormAct(norm_num_groups, out_ch, act="silu")
        # out -> out: under "mixed" each conv's own shape decides
        self.conv2 = _Conv(dims, out_ch, out_ch, 3, quant=quant)
        self.skip_connection = (_Conv(dims, in_ch, out_ch, 1, quant=quant)
                                if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb.float()))  # SiLU in fp32, as JAX
        h = h + t.view(t.shape + (1,) * (h.dim() - 2))
        h = self.conv2(self.norm2(h))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class AttentionBlock(_Remat):
    def __init__(self, ch: int, num_head_channels: int, norm_num_groups: int,
                 quant: str | None = None):
        super().__init__()
        self.num_heads = max(ch // num_head_channels, 1)
        self.head_dim = ch // self.num_heads
        self.norm = FusedGroupNormAct(norm_num_groups, ch)
        dense = _pick_dense(quant, ch)
        self.to_q = dense(ch, ch)
        self.to_k = dense(ch, ch)
        self.to_v = dense(ch, ch)
        self.proj_attn = dense(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        spatial = tuple(x.shape[2:])
        n = math.prod(spatial)
        h = _to_channels_last_dims(self.norm(x)).reshape(b, n, c)  # free for channels-last

        def heads(a):  # (B, N, C) -> (B, heads, N, head_dim)
            return a.reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

        out = attention(heads(self.to_q(h)), heads(self.to_k(h)), heads(self.to_v(h)),
                        1.0 / math.sqrt(self.head_dim))
        out = self.proj_attn(out.transpose(1, 2).reshape(b, n, c))
        return x + _to_channels_first_dims(out.reshape((b,) + spatial + (c,)))


class Downsample(nn.Module):
    def __init__(self, dims: int, ch: int, quant: str | None = None):
        super().__init__()
        # padding 1 both sides, as JAX's (1, 1)
        self.op = _Conv(dims, ch, ch, 3, stride=2, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, dims: int, ch: int, quant: str | None = None):
        super().__init__()
        self.conv = _Conv(dims, ch, ch, 3, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # autocast would run nearest upsampling in fp32; it is exact in any dtype
        with torch.autocast(device_type=x.device.type, enabled=False):
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x)


class _Level(nn.Module):
    """One down or up level: ``resnets``, ``attentions`` and an optional
    ``downsampler`` / ``upsampler`` (monai-generative's block layout)."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class _Middle(nn.Module):
    def __init__(self, dims: int, ch: int, temb_ch: int, heads_ch: int, groups: int,
                 quant: str | None = None):
        super().__init__()
        self.resnet_1 = ResnetBlock(dims, ch, ch, temb_ch, groups, quant)
        self.attention = AttentionBlock(ch, heads_ch, groups, quant)
        self.resnet_2 = ResnetBlock(dims, ch, ch, temb_ch, groups, quant)

    def forward(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        return self.resnet_2(self.attention(self.resnet_1(h, temb)), temb)


class DiffusionModelUNet(nn.Module):
    """2D or 3D epsilon-network. x: (B, C, *spatial), best in
    ``memory_format(spatial_dims)``; t: (B,) int. Returns fp32
    (B, out_channels, *spatial)."""

    def __init__(
        self,
        spatial_dims: int = 2,
        in_channels: int = 1,
        out_channels: int = 1,
        num_channels: Sequence[int] = (128, 256, 256),
        attention_levels: Sequence[bool] = (False, False, True),
        num_res_blocks: int = 1,
        num_head_channels: int = 256,
        norm_num_groups: int = 32,
        quant: str | None = None,
    ):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        chs = tuple(num_channels)
        self.num_channels = chs
        self.spatial_dims = d = spatial_dims
        temb_ch = chs[0] * 4
        g = norm_num_groups
        self.time_embed = nn.Sequential(nn.Linear(chs[0], temb_ch), nn.SiLU(),
                                        nn.Linear(temb_ch, temb_ch))
        self.conv_in = _Conv(d, in_channels, chs[0], 3)

        skip_chs: List[int] = [chs[0]]
        ch = chs[0]
        self.down_blocks = nn.ModuleList()
        for level, out_ch in enumerate(chs):
            blk = _Level()
            for _ in range(num_res_blocks):
                blk.resnets.append(ResnetBlock(d, ch, out_ch, temb_ch, g, quant))
                ch = out_ch
                if attention_levels[level]:
                    blk.attentions.append(AttentionBlock(ch, num_head_channels, g, quant))
                skip_chs.append(ch)
            if level != len(chs) - 1:
                blk.downsampler = Downsample(d, ch, quant)
                skip_chs.append(ch)
            self.down_blocks.append(blk)

        self.middle_block = _Middle(d, ch, temb_ch, num_head_channels, g, quant)

        self.up_blocks = nn.ModuleList()
        for level in reversed(range(len(chs))):
            blk = _Level()
            for _ in range(num_res_blocks + 1):
                blk.resnets.append(ResnetBlock(d, ch + skip_chs.pop(), chs[level], temb_ch, g,
                                               quant))
                ch = chs[level]
                if attention_levels[level]:
                    blk.attentions.append(AttentionBlock(ch, num_head_channels, g, quant))
            if level != 0:
                blk.upsampler = Upsample(d, ch, quant)
            self.up_blocks.append(blk)

        # out.1 is the SiLU, fused into out.0's GroupNorm kernel
        self.out = nn.Sequential(FusedGroupNormAct(g, ch, act="silu"), nn.Identity(),
                                 _Conv(d, ch, out_channels, 3))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = self.time_embed(timestep_embedding(t, self.num_channels[0]))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for i, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[i](h)
                skips.append(h)
            if hasattr(blk, "downsampler"):
                h = blk.downsampler(h)
                skips.append(h)
        h = self.middle_block(h, temb)
        for blk in self.up_blocks:
            for i, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[i](h)
            if hasattr(blk, "upsampler"):
                h = blk.upsampler(h)
        return self.out(h).float()


PRESETS = {
    # the reference's configs (its base.py:65-88)
    "small": dict(num_channels=(128, 256, 256), attention_levels=(False, False, True),
                  num_res_blocks=1, num_head_channels=256, norm_num_groups=32),
    "big": dict(num_channels=(256, 512, 768), attention_levels=(True, True, True),
                num_res_blocks=2, num_head_channels=256, norm_num_groups=32),
    # framework extension: same topology as "small", for CPU tests and smoke runs
    "tiny": dict(num_channels=(32, 64, 64), attention_levels=(False, False, True),
                 num_res_blocks=1, num_head_channels=64, norm_num_groups=8),
}


def make_unet(model_type: str, spatial_dims: int, in_channels: int, out_channels: int,
              remat: bool = False, quant: str | None = None) -> DiffusionModelUNet:
    """The tiny / small / big presets of the JAX package, 2D or 3D, with
    every res and attention block recomputed in the backward pass when
    `remat`, and quantised for scoring by `quant` (None or one of
    ``QUANT_MODES``; see the module docstring)."""
    if (quant or "none") not in QUANT_MODES:
        raise ValueError(f"quant must be None or one of {QUANT_MODES}, got {quant!r}")
    if model_type not in PRESETS:
        raise ValueError(f"Do not recognise model type {model_type}")
    model = DiffusionModelUNet(spatial_dims=spatial_dims, in_channels=in_channels,
                               out_channels=out_channels, **PRESETS[model_type],
                               quant=None if quant in (None, "none") else quant)
    for block in model.modules():
        if isinstance(block, _Remat):
            block.remat = bool(remat)
    return model


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights drawn on the CPU: fan-in-scaled normal kernels,
    small normal biases, GroupNorm scales near 1. Unlike the JAX init, the
    output conv is NOT zeroed, so the model's output depends on every layer."""
    for name, p in model.named_parameters():
        if p.dim() > 1:
            fan_in = math.prod(p.shape[1:])
            v = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        elif name.endswith("weight"):  # GroupNorm scale
            v = 1.0 + 0.1 * torch.randn(p.shape, generator=generator)
        else:
            v = 0.1 * torch.randn(p.shape, generator=generator)
        p.copy_(v)
    return model


@torch.no_grad()
def jax_like_init_(model: DiffusionModelUNet, generator: torch.Generator) -> DiffusionModelUNet:
    """The JAX package's flax initialisation, drawn from a torch generator:
    conv and linear weights lecun_normal (a normal of std sqrt(1 / fan_in),
    truncated at two standard deviations and rescaled as flax does), biases
    0, GroupNorm scales 1, and the output conv's weight 0, so a fresh model
    predicts 0. The draws differ from JAX's; the distribution is the same."""
    std_correction = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    for name, p in model.named_parameters():
        if p.dim() > 1:
            std = math.sqrt(1.0 / math.prod(p.shape[1:])) / std_correction
            u = lo + (hi - lo) * torch.rand(p.shape, generator=generator)  # inverse CDF
            p.copy_(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std)
        elif name.endswith("weight"):  # GroupNorm scale
            p.fill_(1.0)
        else:
            p.zero_()
    model.out[2].conv.weight.zero_()
    return model
