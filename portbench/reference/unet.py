"""monai-generative's DiffusionModelUNet (2D or 3D), forward only, as a
function of its state dict.

x (N, C, *spatial) float32, t (N,) int -> epsilon (N, C, *spatial) float32.
GroupNorm eps 1e-6; the time embedding is sin then cos of width
num_channels[0]; the downsample is a stride-2 3x3 convolution padded by 1;
the upsample is nearest x2 then a 3x3 convolution; attention is one head of
num_head_channels per 256 channels over the flattened positions.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .ops import FP32, Ops

EPS = 1e-6


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class _Net:
    """The forward, walking the state dict `p` by key."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: dict, ops: Ops):
        self.p, self.cfg, self.ops = p, cfg, ops
        self.groups = int(cfg["norm_num_groups"])

    def conv(self, name, x, stride=1):
        w = self.p[f"{name}.weight"]
        return self.ops.conv(x, w, self.p[f"{name}.bias"], stride, w.shape[-1] // 2)

    def linear(self, name, x):
        return self.ops.linear(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"])

    def norm(self, name, x, silu: bool):
        y = F.group_norm(x, self.groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"], EPS)
        return F.silu(y) if silu else y

    def resnet(self, name, x, temb):
        h = self.conv(f"{name}.conv1.conv", self.norm(f"{name}.norm1", x, True))
        t = self.linear(f"{name}.time_emb_proj", F.silu(temb))
        h = h + t.view(t.shape + (1,) * (h.dim() - 2))
        h = self.conv(f"{name}.conv2.conv", self.norm(f"{name}.norm2", h, True))
        if f"{name}.skip_connection.conv.weight" in self.p:
            x = self.conv(f"{name}.skip_connection.conv", x)
        return x + h

    def attention(self, name, x):
        b, c = x.shape[:2]
        heads = max(c // int(self.cfg["num_head_channels"]), 1)
        d = c // heads
        h = self.norm(f"{name}.norm", x, False).flatten(2).transpose(1, 2)  # (B, N, C)

        def split(a):
            return a.reshape(b, -1, heads, d).transpose(1, 2)  # (B, heads, N, d)

        q, k, v = (split(self.linear(f"{name}.{n}", h)) for n in ("to_q", "to_k", "to_v"))
        probs = torch.softmax(self.ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        out = self.ops.matmul(probs, v).transpose(1, 2).reshape(b, -1, c)
        out = self.linear(f"{name}.proj_attn", out)
        return x + out.transpose(1, 2).reshape(x.shape)

    def forward(self, x, t):
        chs = list(self.cfg["num_channels"])
        attn = list(self.cfg["attention_levels"])
        n_res = int(self.cfg["num_res_blocks"])
        temb = self.linear("time_embed.2", F.silu(self.linear(
            "time_embed.0", timestep_embedding(t, chs[0]))))
        h = self.conv("conv_in.conv", x)
        skips: List[torch.Tensor] = [h]
        for level in range(len(chs)):
            for j in range(n_res):
                h = self.resnet(f"down_blocks.{level}.resnets.{j}", h, temb)
                if attn[level]:
                    h = self.attention(f"down_blocks.{level}.attentions.{j}", h)
                skips.append(h)
            if level != len(chs) - 1:
                h = self.conv(f"down_blocks.{level}.downsampler.op.conv", h, stride=2)
                skips.append(h)
        h = self.resnet("middle_block.resnet_1", h, temb)
        h = self.attention("middle_block.attention", h)
        h = self.resnet("middle_block.resnet_2", h, temb)
        for i, level in enumerate(reversed(range(len(chs)))):
            for j in range(n_res + 1):
                h = self.resnet(f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], 1),
                                temb)
                if attn[level]:
                    h = self.attention(f"up_blocks.{i}.attentions.{j}", h)
            if level != 0:
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = self.conv(f"up_blocks.{i}.upsampler.conv.conv", h)
        return self.conv("out.2.conv", self.norm("out.0", h, True))


def unet_forward(p: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, t: torch.Tensor,
                 ops: Ops = FP32) -> torch.Tensor:
    """The UNet of configuration `cfg` (num_channels, attention_levels,
    num_res_blocks, num_head_channels, norm_num_groups) with weights `p`."""
    return _Net(p, cfg, ops).forward(x, t)


def unet_param_shapes(cfg: dict, spatial_dims: int, channels: int) -> Dict[str, tuple]:
    """Every parameter's name and shape, in monai-generative's key names."""
    chs = list(cfg["num_channels"])
    attn = list(cfg["attention_levels"])
    n_res = int(cfg["num_res_blocks"])
    k3 = (3,) * spatial_dims
    out: Dict[str, tuple] = {}
    temb = chs[0] * 4

    def conv(name, cin, cout, k=k3):
        out[f"{name}.weight"] = (cout, cin) + k
        out[f"{name}.bias"] = (cout,)

    def norm(name, c):
        out[f"{name}.weight"] = (c,)
        out[f"{name}.bias"] = (c,)

    def linear(name, cin, cout):
        out[f"{name}.weight"] = (cout, cin)
        out[f"{name}.bias"] = (cout,)

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1.conv", cin, cout)
        linear(f"{name}.time_emb_proj", temb, cout)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2.conv", cout, cout)
        if cin != cout:
            conv(f"{name}.skip_connection.conv", cin, cout, (1,) * spatial_dims)

    def attention(name, c):
        norm(f"{name}.norm", c)
        for n in ("to_q", "to_k", "to_v", "proj_attn"):
            linear(f"{name}.{n}", c, c)

    linear("time_embed.0", chs[0], temb)
    linear("time_embed.2", temb, temb)
    conv("conv_in.conv", channels, chs[0])
    skip, ch = [chs[0]], chs[0]
    for level, c in enumerate(chs):
        for j in range(n_res):
            resnet(f"down_blocks.{level}.resnets.{j}", ch, c)
            ch = c
            if attn[level]:
                attention(f"down_blocks.{level}.attentions.{j}", ch)
            skip.append(ch)
        if level != len(chs) - 1:
            conv(f"down_blocks.{level}.downsampler.op.conv", ch, ch)
            skip.append(ch)
    resnet("middle_block.resnet_1", ch, ch)
    attention("middle_block.attention", ch)
    resnet("middle_block.resnet_2", ch, ch)
    for i, level in enumerate(reversed(range(len(chs)))):
        for j in range(n_res + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", ch + skip.pop(), chs[level])
            ch = chs[level]
            if attn[level]:
                attention(f"up_blocks.{i}.attentions.{j}", ch)
        if level != 0:
            conv(f"up_blocks.{i}.upsampler.conv.conv", ch, ch)
    norm("out.0", ch)
    conv("out.2.conv", ch, channels)
    return out
