"""Reconstruction sweep CLI of the PyTorch port.

    python -m ddpm_ood_tpu_torch.reconstruct [reconstruct.py flags] [--device=cuda|cpu]
    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m ddpm_ood_tpu_torch.reconstruct [the same flags]

It takes the JAX package's ``reconstruct.py`` flags
(``config.parse_args_reconstruct``, a copy of the JAX package's parser) plus ``--device``
(default ``cuda``, which raises when there is no card). Under torchrun each
process scores its partition of every dataset on its card, and rank 0
merges the processes' CSVs. ``--quantize=int8|w8|mixed`` scores with the
quantised UNet (``ops/quant.py``; int8 on the card's s8 kernels, the plain
versions with ``--device=cpu``); under torchrun each int8 activation scale
is taken over every rank's images of that UNet call. ``--aot_cache``
(TPU-only) raises NotImplementedError naming the flag.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .config import parse_args_reconstruct
from .parallel.mesh import distributed
from .trainers.base import resolve_device
from .trainers.reconstruct import Reconstruct, refuse_unported_flags


def parse_args(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    own, rest = pre.parse_known_args(sys.argv[1:] if argv is None else argv)
    args = parse_args_reconstruct(rest)
    args.device = own.device
    return args


def main(argv=None) -> Reconstruct:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    refuse_unported_flags(args)  # before joining a process group
    device = resolve_device(args.device)
    with distributed(device):
        recon = Reconstruct(args, device)
        recon.reconstruct(args)
    return recon


if __name__ == "__main__":
    main()
