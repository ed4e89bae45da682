"""--fsdp=1 static device-memory accounting at the production configs.

    python -m ddpm_ood_tpu_torch.bench_fsdp_hbm [--devices 8]

The twin of the JAX package's ``scripts/bench_fsdp_hbm.py``, with its JSON
keys. Parameters, Adam's two moments and the weight EMA (the UNet's) stay on
the device for the whole run; their bytes per device are arithmetic over the
parameter shapes and the sharding policy that ``parallel/fsdp.py:apply_fsdp``
uses (``shard_axis``), so this needs no card and no process group: the
models are built on the ``meta`` device. Adam's step counters live on the
host in PyTorch and are not counted. Activations depend on the workload and
are not counted either.

Configs: the big UNet in 2D (RGB) and in 3D (one channel), with Adam and the
EMA, and the production 3D pixel-space VQ-VAE and its PatchGAN
discriminator, with Adam.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Sequence

import torch

from .models.discriminator import PatchDiscriminator
from .models.unet import make_unet
from .models.vqvae import VQVAE
from .parallel.fsdp import DEFAULT_MIN_SIZE, planned_bytes_per_device

# the production 3D pixel-space VQ-VAE (the reference README's flags)
VQVAE_3D = dict(spatial_dims=3, in_channels=1, out_channels=1, num_res_layers=3,
                downsample_parameters=((2, 4, 1, 1),) * 4,
                upsample_parameters=((2, 4, 1, 1, 0),) * 4,
                num_channels=(128, 128, 128, 256), num_res_channels=(128, 128, 128, 256),
                num_embeddings=256, embedding_dim=256)


def account(name: str, shapes: Sequence[Sequence[int]], copies: int, devices: int,
            min_size: int = DEFAULT_MIN_SIZE) -> dict:
    """One row: `copies` fp32 tensors of every shape (parameter, moments,
    EMA) replicated, and as the FSDP policy leaves them on one device."""
    replicated = copies * planned_bytes_per_device(shapes, 1, min_size=2**62)
    sharded = copies * planned_bytes_per_device(shapes, devices, min_size)
    return {"config": name,
            "replicated_MiB_per_device": round(replicated / 2**20, 1),
            "fsdp_MiB_per_device": round(sharded / 2**20, 1),
            "reduction": round(replicated / max(sharded, 1), 2),
            "devices": devices}


def rows(devices: int) -> List[dict]:
    with torch.device("meta"):
        unet2d = make_unet("big", 2, 3, 3)
        unet3d = make_unet("big", 3, 1, 1)
        vq = VQVAE(**VQVAE_3D)
        disc = PatchDiscriminator(spatial_dims=3, num_layers_d=3, num_channels=64,
                                  in_channels=1)

    def shapes(m):
        return [tuple(p.shape) for p in m.parameters()]

    # params + 2 Adam moments + EMA = 4 copies; G and D: params + 2 moments
    return [account("big 2D UNet (+Adam, +EMA)", shapes(unet2d), 4, devices),
            account("big 3D UNet (+Adam, +EMA)", shapes(unet3d), 4, devices),
            account("3D VQVAE G (+Adam)", shapes(vq), 3, devices),
            account("3D PatchDiscriminator D (+Adam)", shapes(disc), 3, devices)]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=8)
    args = p.parse_args(argv)
    out = {"bench": "fsdp_static_hbm", "rows": rows(args.devices)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
