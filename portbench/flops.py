"""Operations and bytes of the work a cell asks for, from the
configuration's shapes: the reference models run on the meta device under
``torch.utils.flop_counter.FlopCounterMode`` (2 per multiply-add of every
convolution, transposed convolution and matrix product), and their
GroupNorm layers' inputs counted by a dispatch mode. No kernel of the
program is consulted, so a count does not move when the program fuses,
splits or drops a kernel.

``peak(device_name)`` reads ``peaks.json``: the card's published dense
rates and memory bandwidth."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .reference import metrics as ref_metrics
from .reference import vqvae as ref_vqvae
from .reference.train import ddpm_loss
from .reference.unet import unet_forward, unet_param_shapes

META = torch.device("meta")
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def peak(device_name: str) -> Optional[dict]:
    table = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    return table.get(device_name)


def _meta(shapes: Dict[str, tuple], grad: bool = False) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, device=META, requires_grad=grad) for k, s in shapes.items()}


def count_flops(fn: Callable[[], object]) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


class _GroupNormInputs(TorchDispatchMode):
    """Sums the elements of every GroupNorm input dispatched."""

    def __init__(self):
        super().__init__()
        self.elements = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.native_group_norm.default:
            self.elements += args[0].numel()
        return func(*args, **(kwargs or {}))


def _unet_inputs(cfg: dict, rows: int):
    spatial, channels = unet_input(cfg)
    x = torch.empty((rows, channels) + spatial, device=META)
    return x, torch.zeros((rows,), dtype=torch.long, device=META)


def unet_input(cfg: dict):
    """(spatial, channels) of what the UNet takes: the image, or the
    latent of the VQ-VAE."""
    spatial = tuple(cfg["image_shape"][:-1])
    if cfg.get("vqvae"):
        factor = 1
        for stride, *_ in cfg["vqvae"]["downsample_parameters"]:
            factor *= stride
        return tuple(s // factor for s in spatial), int(cfg["vqvae"]["embedding_dim"])
    return spatial, int(cfg["image_shape"][-1])


def unet_shapes(cfg: dict) -> Dict[str, tuple]:
    spatial, channels = unet_input(cfg)
    return unet_param_shapes(cfg["unet"], len(spatial), channels)


def unet_forward_flops(cfg: dict) -> int:
    """One UNet forward of one row (image or latent)."""
    p = _meta(unet_shapes(cfg))
    x, t = _unet_inputs(cfg, 1)
    return count_flops(lambda: unet_forward(p, cfg["unet"], x, t))


def unet_train_flops(cfg: dict) -> int:
    """Forward and backward of the DDPM loss, one row."""
    p = _meta(unet_shapes(cfg), grad=True)
    x, t = _unet_inputs(cfg, 1)
    acp = torch.empty(1000, device=META)
    return count_flops(lambda: ddpm_loss(p, cfg["unet"], acp, x, t, x).backward())


def groupnorm_bytes(cfg: dict) -> int:
    """Bytes one UNet forward of one row reads and writes in its GroupNorms,
    x read once and y written once, in the configuration's compute dtype."""
    p = _meta(unet_shapes(cfg))
    x, t = _unet_inputs(cfg, 1)
    with _GroupNormInputs() as mode:
        unet_forward(p, cfg["unet"], x, t)
    return 2 * mode.elements * ITEMSIZE[cfg["compute_dtype"]]


def lpips_flops(cfg: dict) -> int:
    """LPIPS features of one image (every slice of a volume)."""
    lp = {k: torch.empty(s, device=META) for k, s in (
        ("conv0.weight", (64, 3, 11, 11)), ("conv0.bias", (64,)),
        ("conv3.weight", (192, 64, 5, 5)), ("conv3.bias", (192,)),
        ("conv6.weight", (384, 192, 3, 3)), ("conv6.bias", (384,)),
        ("conv8.weight", (256, 384, 3, 3)), ("conv8.bias", (256,)),
        ("conv10.weight", (256, 256, 3, 3)), ("conv10.bias", (256,)))}
    spatial = tuple(cfg["image_shape"][:-1])
    if len(spatial) == 3:  # slices along the last axis
        x = torch.empty((spatial[2], 3) + spatial[:2], device=META)
    else:
        x = torch.empty((1, 3) + spatial, device=META)
    return count_flops(lambda: ref_metrics._features(lp, x, ref_metrics.FP32))


def vqvae_flops(cfg: dict) -> Dict[str, int]:
    """{"encode", "decode"} of one image."""
    v = cfg["vqvae"]
    p = _meta(ref_vqvae.vqvae_param_shapes(v))
    spatial, emb = unet_input(cfg)
    img = torch.empty((1, int(cfg["image_shape"][-1])) + tuple(cfg["image_shape"][:-1]),
                      device=META)
    z = torch.empty((1, emb) + spatial, device=META)
    return {"encode": count_flops(lambda: ref_vqvae.encode(p, v, img)),
            "decode": count_flops(lambda: ref_vqvae.decode(p, v, z))}
