"""DDPM training CLI of the PyTorch port.

    python -m ddpm_ood_tpu_torch.train_ddpm [train_ddpm.py flags] [--device=cuda|cpu]

It takes the JAX package's ``train_ddpm.py`` flags
(``config.parse_args_train_ddpm``, a copy of the JAX package's parser) plus
``--device`` (default ``cuda``, which raises when there is no card). It
writes reference-schema ``checkpoint.pth`` / ``checkpoint_{N}.pth`` files
that ``python -m ddpm_ood_tpu_torch.reconstruct`` loads, and resumes from
them. Flags the port does not serve yet raise NotImplementedError naming the
flag.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .config import parse_args_train_ddpm
from .trainers.base import resolve_device
from .trainers.ddpm_trainer import DDPMTrainer, refuse_unported_train_flags


def parse_args(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    own, rest = pre.parse_known_args(sys.argv[1:] if argv is None else argv)
    args = parse_args_train_ddpm(rest)
    args.device = own.device
    return args


def main(argv=None) -> DDPMTrainer:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    refuse_unported_train_flags(args)  # before the device is asked for
    trainer = DDPMTrainer(args, resolve_device(args.device))
    trainer.train(args)
    return trainer


if __name__ == "__main__":
    main()
