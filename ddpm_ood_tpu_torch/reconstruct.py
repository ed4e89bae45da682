"""Reconstruction sweep CLI of the PyTorch port.

    python -m ddpm_ood_tpu_torch.reconstruct [reconstruct.py flags] [--device=cuda|cpu]

It takes the JAX package's ``reconstruct.py`` flags
(``ddpm_ood_tpu.config.parse_args_reconstruct``) plus ``--device``
(default ``cuda``, which raises when there is no card). Flags the port does
not serve yet raise NotImplementedError naming the flag.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ddpm_ood_tpu.config import parse_args_reconstruct

from .trainers.base import resolve_device
from .trainers.reconstruct import Reconstruct


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
    recon = Reconstruct(args, resolve_device(args.device))
    recon.reconstruct(args)
    return recon


if __name__ == "__main__":
    main()
