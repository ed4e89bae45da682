"""VQ-VAE training CLI of the PyTorch port (stage 1 of latent diffusion).

    python -m ddpm_ood_tpu_torch.train_vqvae [train_vqvae.py flags] [--device=cuda|cpu]
    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m ddpm_ood_tpu_torch.train_vqvae [the same flags]

It takes the JAX package's ``train_vqvae.py`` flags
(``config.parse_args_train_vqvae``, a copy of the JAX package's parser) plus
``--device`` (default ``cuda``, which raises when there is no card). It
writes ``vqvae_config.json`` and ``checkpoint.pth`` / ``checkpoint_{N}.pth``
into ``<output_dir>/<model_name>``; ``--vqvae_checkpoint=<that
checkpoint.pth>`` hands the model to ``python -m
ddpm_ood_tpu_torch.train_ddpm`` and ``python -m
ddpm_ood_tpu_torch.reconstruct``. A rerun resumes. Under torchrun each
process trains on its card with DistributedDataParallel, or FSDP2 with
``--fsdp=1``. ``--vqvae_dropout`` > 0 raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .config import parse_args_train_vqvae
from .parallel.mesh import distributed
from .trainers.base import resolve_device
from .trainers.vqvae_trainer import VQVAETrainer, refuse_unported_vqvae_flags


def parse_args(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (cuDNN, bf16 autocast) or cpu (fp32)")
    own, rest = pre.parse_known_args(sys.argv[1:] if argv is None else argv)
    args = parse_args_train_vqvae(rest)
    args.device = own.device
    return args


def main(argv=None) -> VQVAETrainer:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    refuse_unported_vqvae_flags(args)  # before the device is asked for
    device = resolve_device(args.device)
    with distributed(device, need_group=bool(args.fsdp)):
        trainer = VQVAETrainer(args, device)
        trainer.train(args)
    return trainer


if __name__ == "__main__":
    main()
