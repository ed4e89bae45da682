"""DDPM training CLI of the PyTorch port.

    python -m ddpm_ood_tpu_torch.train_ddpm [train_ddpm.py flags] [--device=cuda|cpu]
    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m ddpm_ood_tpu_torch.train_ddpm [the same flags]

It takes the JAX package's ``train_ddpm.py`` flags
(``config.parse_args_train_ddpm``, a copy of the JAX package's parser) plus
``--device`` (default ``cuda``, which raises when there is no card). It
writes reference-schema ``checkpoint.pth`` / ``checkpoint_{N}.pth`` files
that ``python -m ddpm_ood_tpu_torch.reconstruct`` loads, and resumes from
them. Under torchrun each process trains on its card (``cuda:LOCAL_RANK``,
NCCL; gloo with ``--device=cpu``) with DistributedDataParallel, or FSDP2
with ``--fsdp=1``, and the process group is destroyed on the way out.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .config import parse_args_train_ddpm
from .parallel.mesh import distributed
from .trainers.base import resolve_device
from .trainers.ddpm_trainer import DDPMTrainer


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
    device = resolve_device(args.device)
    with distributed(device, need_group=bool(args.fsdp)):
        trainer = DDPMTrainer(args, device)
        trainer.train(args)
    return trainer


if __name__ == "__main__":
    main()
