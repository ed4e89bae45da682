"""monai-generative's VQVAE (2D or 3D) stage-2 hooks as functions of its
state dict: encode (convolutions, residual units, the nearest code of an EMA
codebook) and decode (the nearest code again, residual units, transposed
convolutions).

Encoder, per level: a strided convolution (stride, kernel, dilation,
padding) and ReLU, then ``num_res_layers`` units relu(x + conv2(relu(conv1
(x)))); last a 3x3 convolution to ``embedding_dim``. Decoder: a 3x3
convolution and ReLU, then per level in reverse the units and a transposed
convolution (stride, kernel, dilation, padding, output padding), with a ReLU
after each but the last. The code of a latent vector is the argmin of
|x|^2 - 2 x.e + |e|^2 over the codebook, in float32, ties to the lowest
index.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .ops import FP32, Ops


def _conv(p, ops, name, x, stride=1, padding=1, dilation=1):
    return ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride, padding, dilation)


def _units(p, ops, prefix, first, n, x):
    for b in range(first, first + n):
        h = F.relu(_conv(p, ops, f"{prefix}.{b}.conv1.conv", x))
        x = F.relu(x + _conv(p, ops, f"{prefix}.{b}.conv2.conv", h))
    return x


def quantize(p: Dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    """Each latent vector of z (B, E, *spatial) replaced by its nearest
    code."""
    e = p["quantizer.quantizer.embedding.weight"].float()
    zl = z.float().movedim(1, -1)
    flat = zl.reshape(-1, e.shape[1])
    dist = (flat ** 2).sum(1, keepdim=True) - 2.0 * flat @ e.t() + (e ** 2).sum(1)[None]
    return e[dist.argmin(1)].view(zl.shape).movedim(-1, 1)


def encode(p: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, ops: Ops = FP32):
    """Images (B, C, *spatial) -> quantized latents (B, E, *latent)."""
    n_res = int(cfg["num_res_layers"])
    b = 0
    for stride, kernel, dilation, pad in cfg["downsample_parameters"]:
        x = F.relu(_conv(p, ops, f"encoder.blocks.{b}.conv", x, stride, pad, dilation))
        x = _units(p, ops, "encoder.blocks", b + 1, n_res, x)
        b += n_res + 1
    return quantize(p, _conv(p, ops, f"encoder.blocks.{b}.conv", x))


def decode(p: Dict[str, torch.Tensor], cfg: dict, z: torch.Tensor, ops: Ops = FP32):
    """Latents (B, E, *latent) -> images (B, C, *spatial), after the
    nearest code of every latent vector."""
    n_res = int(cfg["num_res_layers"])
    x = F.relu(_conv(p, ops, "decoder.blocks.0.conv", quantize(p, z)))
    ups = list(reversed(cfg["upsample_parameters"]))
    b = 1
    for i, (stride, kernel, dilation, pad, out_pad) in enumerate(ups):
        x = _units(p, ops, "decoder.blocks", b, n_res, x)
        b += n_res
        name = f"decoder.blocks.{b}.conv"
        x = ops.conv_t(x, p[f"{name}.weight"], p[f"{name}.bias"], stride, pad, out_pad,
                       dilation)
        if i != len(ups) - 1:
            x = F.relu(x)
        b += 1
    return x


def vqvae_param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter and buffer of the VQVAE, in monai-generative's key
    names."""
    d = int(cfg["spatial_dims"])
    n_res = int(cfg["num_res_layers"])
    chs, res_chs = list(cfg["num_channels"]), list(cfg["num_res_channels"])
    emb, n_emb = int(cfg["embedding_dim"]), int(cfg["num_embeddings"])
    out: Dict[str, tuple] = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"] = (cout, cin) + (k,) * d
        out[f"{name}.bias"] = (cout,)

    def units(prefix, first, c, rc):
        for b in range(first, first + n_res):
            conv(f"{prefix}.{b}.conv1.conv", c, rc, 3)
            conv(f"{prefix}.{b}.conv2.conv", rc, c, 3)

    b, ch = 0, int(cfg["in_channels"])
    for i, (stride, kernel, dilation, pad) in enumerate(cfg["downsample_parameters"]):
        conv(f"encoder.blocks.{b}.conv", ch, chs[i], kernel)
        units("encoder.blocks", b + 1, chs[i], res_chs[i])
        ch = chs[i]
        b += n_res + 1
    conv(f"encoder.blocks.{b}.conv", ch, emb, 3)
    rev, rev_res = chs[::-1], res_chs[::-1]
    ups = list(reversed(cfg["upsample_parameters"]))
    conv("decoder.blocks.0.conv", emb, rev[0], 3)
    b = 1
    for i, (stride, kernel, dilation, pad, out_pad) in enumerate(ups):
        units("decoder.blocks", b, rev[i], rev_res[i])
        b += n_res
        cout = int(cfg["out_channels"]) if i == len(ups) - 1 else rev[i + 1]
        out[f"decoder.blocks.{b}.conv.weight"] = (rev[i], cout) + (kernel,) * d
        out[f"decoder.blocks.{b}.conv.bias"] = (cout,)
        b += 1
    out["quantizer.quantizer.embedding.weight"] = (n_emb, emb)
    out["quantizer.quantizer.ema_cluster_size"] = (n_emb,)
    out["quantizer.quantizer.ema_w"] = (n_emb, emb)
    return out
