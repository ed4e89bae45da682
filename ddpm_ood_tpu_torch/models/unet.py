"""Time-conditioned diffusion UNet (2D) with monai-generative state_dict names.

Port of ``ddpm_ood_tpu/models/unet.py``. Module names follow
monai-generative's ``DiffusionModelUNet`` (``conv_in.conv``,
``down_blocks.{L}.resnets.{j}.conv1.conv``, ``middle_block.resnet_1``,
``out.2.conv``, ...), so a reference ``.pth`` loads with ``strict=True``; the
key sets equal ``tests/fixtures/monai_generative_unet_keys_{small,big}_2d.txt``.

Layout: tensors are (B, C, H, W) in ``torch.channels_last`` memory format.
A channels-last (B, C, H, W) tensor permuted to (B, H, W, C) is contiguous,
which is the layout the GroupNorm kernel and the attention block read, so
neither pays a transpose. Parameters stay fp32; on CUDA the trainer runs the
forward under ``torch.autocast(bfloat16)``, so convolutions and projections
compute in bf16 while GroupNorm keeps fp32 statistics, as the JAX package
does on its accelerator.

Numerics that differ from torch defaults on purpose: GroupNorm eps is 1e-6,
the downsample pads (1, 1) at stride 2 (torch ``padding=1``), the timestep
embedding puts sin before cos with width ``num_channels[0]``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.groupnorm import groupnorm_act


class FusedGroupNormAct(nn.Module):
    """GroupNorm (+ SiLU) over a (B, C, H, W) tensor through
    ``ops.groupnorm_act``; parameters named like ``nn.GroupNorm``'s."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 act: str = "none"):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, H, W, C): a free view of a channels_last tensor, else a copy
        y = groupnorm_act(x.permute(0, 2, 3, 1).contiguous(), self.weight, self.bias,
                          self.num_groups, self.eps, self.act)
        return y.permute(0, 3, 1, 2)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, sin then cos (monai-generative's convention)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class _Conv(nn.Module):
    """A conv wrapped one level deep, for monai's ``.conv`` key segment."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, norm_num_groups: int):
        super().__init__()
        self.norm1 = FusedGroupNormAct(norm_num_groups, in_ch, act="silu")
        self.conv1 = _Conv(in_ch, out_ch, 3)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = FusedGroupNormAct(norm_num_groups, out_ch, act="silu")
        self.conv2 = _Conv(out_ch, out_ch, 3)
        self.skip_connection = _Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb.float()))  # SiLU in fp32, as JAX
        h = h + t[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, num_head_channels: int, norm_num_groups: int):
        super().__init__()
        self.num_heads = max(ch // num_head_channels, 1)
        self.head_dim = ch // self.num_heads
        self.norm = FusedGroupNormAct(norm_num_groups, ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n = hh * ww
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, n, c)  # free for channels_last

        def heads(a):  # (B, N, C) -> (B, heads, N, head_dim)
            return a.reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

        out = attention(heads(self.to_q(h)), heads(self.to_k(h)), heads(self.to_v(h)),
                        1.0 / math.sqrt(self.head_dim))
        out = self.proj_attn(out.transpose(1, 2).reshape(b, n, c))
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = _Conv(ch, ch, 3, stride=2)  # padding 1 both sides, as JAX's (1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _Conv(ch, ch, 3)

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
    def __init__(self, ch: int, temb_ch: int, heads_ch: int, groups: int):
        super().__init__()
        self.resnet_1 = ResnetBlock(ch, ch, temb_ch, groups)
        self.attention = AttentionBlock(ch, heads_ch, groups)
        self.resnet_2 = ResnetBlock(ch, ch, temb_ch, groups)

    def forward(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        return self.resnet_2(self.attention(self.resnet_1(h, temb)), temb)


class DiffusionModelUNet(nn.Module):
    """2D epsilon-network. x: (B, C, H, W), best in channels_last; t: (B,) int.
    Returns fp32 (B, out_channels, H, W)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        num_channels: Sequence[int] = (128, 256, 256),
        attention_levels: Sequence[bool] = (False, False, True),
        num_res_blocks: int = 1,
        num_head_channels: int = 256,
        norm_num_groups: int = 32,
    ):
        super().__init__()
        chs = tuple(num_channels)
        self.num_channels = chs
        temb_ch = chs[0] * 4
        g = norm_num_groups
        self.time_embed = nn.Sequential(nn.Linear(chs[0], temb_ch), nn.SiLU(),
                                        nn.Linear(temb_ch, temb_ch))
        self.conv_in = _Conv(in_channels, chs[0], 3)

        skip_chs: List[int] = [chs[0]]
        ch = chs[0]
        self.down_blocks = nn.ModuleList()
        for level, out_ch in enumerate(chs):
            blk = _Level()
            for _ in range(num_res_blocks):
                blk.resnets.append(ResnetBlock(ch, out_ch, temb_ch, g))
                ch = out_ch
                if attention_levels[level]:
                    blk.attentions.append(AttentionBlock(ch, num_head_channels, g))
                skip_chs.append(ch)
            if level != len(chs) - 1:
                blk.downsampler = Downsample(ch)
                skip_chs.append(ch)
            self.down_blocks.append(blk)

        self.middle_block = _Middle(ch, temb_ch, num_head_channels, g)

        self.up_blocks = nn.ModuleList()
        for level in reversed(range(len(chs))):
            blk = _Level()
            for _ in range(num_res_blocks + 1):
                blk.resnets.append(ResnetBlock(ch + skip_chs.pop(), chs[level], temb_ch, g))
                ch = chs[level]
                if attention_levels[level]:
                    blk.attentions.append(AttentionBlock(ch, num_head_channels, g))
            if level != 0:
                blk.upsampler = Upsample(ch)
            self.up_blocks.append(blk)

        # out.1 is the SiLU, fused into out.0's GroupNorm kernel
        self.out = nn.Sequential(FusedGroupNormAct(g, ch, act="silu"), nn.Identity(),
                                 _Conv(ch, out_channels, 3))

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
    """The tiny / small / big presets of the JAX package. Only 2D is ported;
    there is no rematerialisation and no quantised variant yet."""
    if remat:
        raise NotImplementedError("remat is not ported to the PyTorch UNet")
    if quant not in (None, "none"):
        raise NotImplementedError(f"quantized UNet ({quant!r}) is not ported")
    if spatial_dims != 2:
        raise NotImplementedError(f"{spatial_dims}D UNet is not ported (2D only)")
    if model_type not in PRESETS:
        raise ValueError(f"Do not recognise model type {model_type}")
    return DiffusionModelUNet(in_channels=in_channels, out_channels=out_channels,
                              **PRESETS[model_type])


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
