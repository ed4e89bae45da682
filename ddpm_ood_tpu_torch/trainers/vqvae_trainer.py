"""VQ-VAE + PatchGAN trainer: stage 1 of latent diffusion.

Port of ``ddpm_ood_tpu/trainers/vqvae_trainer.py``, on one device or one
process per device under torchrun (``parallel/mesh.py``):
  - the VQ-VAE from the ``--vqvae_*`` flags and a PatchGAN discriminator
    (3 layers, 64 base channels), both initialised with Flax's default
    distributions drawn from ``--seed`` (the codebook a unit normal);
  - ``vqvae_config.json`` (the JAX trainer's keys) written into the run
    directory at start;
  - per step the G step, then the D step (``train/vqvae.py``), with the
    adversarial weight warmed over 50 epochs under
    ``--adversarial_warmup``; ``global_step`` counts images; the six G
    metrics and ``discriminator_loss`` are logged per step, read from the
    device 16 steps at a time;
  - the epoch loop of the reference: the rolling ``checkpoint.pth`` is the
    best on train G loss, ``checkpoint_{N}.pth`` is written every
    ``--checkpoint_every`` epochs, validation every ``--eval_freq``;
    SIGTERM finishes the epoch, checkpoints and stops;
  - checkpoints hold ``model_state_dict`` in monai-generative's VQVAE keys
    (what ``utils/checkpoint.py:load_vqvae_checkpoint`` and the scoring
    and LDM training CLIs read), ``discriminator_state_dict``, both Adam
    states, ``epoch``, ``global_step`` and ``best_loss``, written
    atomically; a rerun resumes from them;
  - under torchrun each process trains on its partition of the data; G and
    D are wrapped in ``DistributedDataParallel``, or sharded by FSDP2 under
    ``--fsdp=1`` (``parallel/fsdp.py``); the codebook statistics and D's
    BatchNorm statistics are the global batch's (``models/vqvae.py``,
    ``models/discriminator.py``); rank 0 logs the metrics' means over the
    processes and writes the checkpoints;
  - validation logs the mean metrics and saves the last batch's
    reconstructions as ``val/RECONSTRUCTIONS_<step>.npy``: (n, 2, *spatial,
    C) image / reconstruction pairs of up to 4 items in [0, 1], the middle
    slice along the first axis for volumes (the JAX trainer draws the same
    as a figure).

LPIPS reads the npz ``LPIPS_WEIGHTS_NPZ`` names, else a seeded fallback that
differs from the JAX package's ``PRNGKey(0)`` draw, and says so.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.loader import get_training_data_loader
from ..losses.lpips import PerceptualLoss
from ..models.discriminator import PatchDiscriminator, init_like_flax_
from ..models.unet import memory_format
from ..models.vqvae import VQVAE
from ..parallel import fsdp
from ..parallel import mesh as pmesh
from ..train.ddpm import channels_last
from ..train.vqvae import SCALAR_TAGS, VQVAETrainStep, adversarial_weight
from ..utils import checkpoint as ckpt
from ..utils.logging import Logger
from ..utils.preemption import PreemptionGuard, checkpoint_if_preempted
from .base import refuse_flags

log = logging.getLogger(__name__)

LOSS_CHUNK = 16  # steps of device metrics read per host sync


def refuse_unported_vqvae_flags(args) -> None:
    refuse_flags(args, [
        ("--vqvae_dropout", float(args.vqvae_dropout) > 0.0,
         "the training step draws no dropout mask, as the JAX package's"),
    ])


def _tuples(v) -> tuple:
    return tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in v)


def vqvae_config_from_args(args) -> dict:
    """The constructor arguments that ``vqvae_config.json`` records, with
    the JAX trainer's keys and order."""
    return dict(
        spatial_dims=int(args.spatial_dimension),
        in_channels=int(args.vqvae_in_channels),
        out_channels=int(args.vqvae_out_channels),
        num_res_layers=int(args.vqvae_num_res_layers),
        downsample_parameters=_tuples(args.vqvae_downsample_parameters),
        upsample_parameters=_tuples(args.vqvae_upsample_parameters),
        num_channels=tuple(args.vqvae_num_channels),
        num_res_channels=tuple(args.vqvae_num_res_channels),
        num_embeddings=int(args.vqvae_num_embeddings),
        embedding_dim=int(args.vqvae_embedding_dim),
        decay=float(args.vqvae_decay),
        commitment_cost=float(args.vqvae_commitment_cost),
        epsilon=float(args.vqvae_epsilon),
        dropout=float(args.vqvae_dropout),
        ddp_sync=bool(args.vqvae_ddp_sync),
    )


class VQVAETrainer:
    def __init__(self, args, device: torch.device,
                 init_state: Optional[Tuple[Mapping, Mapping]] = None):
        """`init_state`: (VQ-VAE state_dict, discriminator state_dict) to
        start from in place of the seeded draw (a resumed run ignores it)."""
        refuse_unported_vqvae_flags(args)
        log.info(f"Arguments: {args}")
        self.device = device
        self.spatial_dimension = int(args.spatial_dimension)
        self.image_size = int(args.image_size) if args.image_size else None
        self.image_roi = tuple(args.image_roi) if args.image_roi else None
        self.autocast_dtype = torch.bfloat16 if device.type == "cuda" else None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.vqvae_config = vqvae_config_from_args(args)
        self.model = VQVAE(**self.vqvae_config, remat=bool(args.remat))
        self.discriminator = PatchDiscriminator(
            spatial_dims=self.spatial_dimension, num_layers_d=3, num_channels=64,
            in_channels=self.vqvae_config["in_channels"], out_channels=1)
        if init_state is not None:
            self.model.load_state_dict(init_state[0], strict=True)
            self.discriminator.load_state_dict(init_state[1], strict=True)
        else:
            gen = torch.Generator().manual_seed(int(args.seed))
            init_like_flax_(self.model, gen)
            quantizer = self.model.quantizer.quantizer
            quantizer.embedding.weight.copy_(
                torch.randn(quantizer.embedding.weight.shape, generator=gen))
            quantizer.ema_w.copy_(quantizer.embedding.weight)
            init_like_flax_(self.discriminator, gen)
        self.fsdp = bool(args.fsdp)
        pmesh.check_joined()
        self.rank = pmesh.process_index()
        self.run_dir = Path(args.output_dir) / args.model_name
        path = ckpt.find_checkpoint(self.run_dir)
        payload = ckpt.load_checkpoint(path) if path is not None else None
        if payload is not None:
            self.model.load_state_dict(payload["model_state_dict"], strict=True)
            self.discriminator.load_state_dict(payload["discriminator_state_dict"], strict=True)
        fmt = memory_format(self.spatial_dimension)
        self.model = self.model.to(device, memory_format=fmt)
        self.discriminator = self.discriminator.to(device, memory_format=fmt)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info(f"{n_params:,} vqvae parameters on {device}")

        self.adv_weight = float(args.adversarial_weight)
        self.adversarial_warmup = bool(int(args.adversarial_warmup))
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.logger_train = Logger(self.run_dir / "train", enabled=self.rank == 0)
        self.logger_val = Logger(self.run_dir / "val", enabled=self.rank == 0)
        self.quick_test = bool(args.quick_test)
        self.train_loader, self.val_loader = get_training_data_loader(
            batch_size=args.batch_size,
            training_ids=args.training_ids,
            validation_ids=args.validation_ids,
            augmentation=bool(args.augmentation),
            num_workers=args.num_workers,
            cache_data=bool(args.cache_data),
            is_grayscale=bool(args.is_grayscale),
            image_size=self.image_size,
            image_roi=self.image_roi,
            spatial_dimension=self.spatial_dimension,
            num_processes=pmesh.process_count(),
            process_index=self.rank,
        )

        grad_accum = int(args.grad_accum_steps or 1)
        if grad_accum > 1 and args.batch_size % grad_accum != 0:
            raise ValueError(f"--batch_size {args.batch_size} is not divisible by "
                             f"--grad_accum_steps {grad_accum}")
        self.step = VQVAETrainStep(
            model=self.model, discriminator=self.discriminator,
            spatial_dims=self.spatial_dimension,
            perceptual=PerceptualLoss(spatial_dims=self.spatial_dimension).to(device),
            vqvae_lr=float(args.vqvae_learning_rate), grad_accum=grad_accum,
            autocast_dtype=self.autocast_dtype, **self._wrap(device))
        if self.fsdp:
            log.info(f"FSDP: G/D params + optimizer state sharded {pmesh.process_count()}-way "
                     f"({fsdp.sharded_bytes_per_device(self.model.parameters()) / 2**20:.1f} "
                     "MiB G params/device)")
        self.epoch_times: List[Tuple[int, float]] = []  # (images, seconds) per train epoch

        if self.rank == 0:
            ckpt.write_vqvae_config(self.run_dir, self.vqvae_config)
        self.start_epoch, self.global_step, self.best_loss = 0, 0, 1000.0
        if payload is not None:
            self._resume(path, payload)

    def _wrap(self, device: torch.device) -> dict:
        """VQVAETrainStep's runners and gradient syncs: FSDP2 under
        ``--fsdp=1``, DDP for more than one process, else none."""
        if self.fsdp:
            rep_g = fsdp.apply_fsdp(self.model, fsdp.min_size_from_env())
            rep_d = fsdp.apply_fsdp(self.discriminator, fsdp.min_size_from_env())
            return {"sync_g": lambda: fsdp.sync_replicated_grads(rep_g),
                    "sync_d": lambda: fsdp.sync_replicated_grads(rep_d)}
        if pmesh.process_count() > 1:
            return {name: pmesh.wrap_ddp(m, device)
                    for name, m in (("g_runner", self.model), ("d_runner", self.discriminator))}
        return {}

    def _resume(self, path: Path, payload: dict) -> None:
        """Both Adam states, epoch, step count and best loss from `path`'s
        payload (the models' weights are loaded before they are wrapped)."""
        fsdp.load_optimizer_state(self.step.opt_g, payload["optimizer_g_state_dict"])
        fsdp.load_optimizer_state(self.step.opt_d, payload["optimizer_d_state_dict"])
        self.start_epoch = int(payload["epoch"])
        self.global_step = int(payload["global_step"])
        self.best_loss = float(payload["best_loss"])
        log.info(f"Resuming using checkpoint {path} at epoch {self.start_epoch}")

    def save_checkpoint(self, name: str, epoch: int, save_message: Optional[str] = None) -> Path:
        """``<run>/<name>.pth``; epoch + 1, so a resume starts on the next
        epoch. Every process calls it: shards are gathered on all, rank 0
        writes, and all wait until the file is there."""
        if save_message:
            log.info(save_message)
        payload = {
            "epoch": int(epoch) + 1,
            "global_step": int(self.global_step),
            "best_loss": float(self.best_loss),
            "model_state_dict": fsdp.full_state_dict(self.model.state_dict()),
            "discriminator_state_dict": fsdp.full_state_dict(self.discriminator.state_dict()),
            "optimizer_g_state_dict": fsdp.full_optimizer_state(self.step.opt_g.state_dict()),
            "optimizer_d_state_dict": fsdp.full_optimizer_state(self.step.opt_d.state_dict()),
        }
        target = self.run_dir / f"{name}.pth"
        if self.rank == 0:
            ckpt.save_vqvae_checkpoint(target, self.vqvae_config, payload)
        pmesh.coordination_barrier(f"checkpoint {name}")
        return target

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        return channels_last(torch.from_numpy(images).to(self.device, non_blocking=True))

    # ------------------------------------------------------------------ train --
    def train(self, args) -> None:
        guard = PreemptionGuard().install()
        try:
            for epoch in range(self.start_epoch, args.n_epochs):
                epoch_loss = self.train_epoch(epoch)
                if epoch_loss < self.best_loss:
                    self.best_loss = epoch_loss
                    self.save_checkpoint("checkpoint", epoch,
                                         f"Saving checkpoint for model with best loss {epoch_loss}")
                if (epoch + 1) % args.checkpoint_every == 0:
                    self.save_checkpoint(f"checkpoint_{epoch + 1}", epoch,
                                         f"Saving checkpoint at epoch {epoch + 1}")
                if checkpoint_if_preempted(guard, self, epoch, args):
                    break
                if (epoch + 1) % args.eval_freq == 0:
                    self.val_epoch(epoch)
        finally:
            guard.uninstall()
            self.logger_train.close()
            self.logger_val.close()
        log.info("Training completed.")

    def train_epoch(self, epoch: int) -> float:
        adv_w = adversarial_weight(self.adv_weight, epoch, self.adversarial_warmup)
        sums = {"generator_loss": 0.0, "discriminator_loss": 0.0, "l1_loss": 0.0}
        images_seen = 0
        t0 = time.perf_counter()
        pending = []  # (global_step, batch size, {tag: 0-dim device tensor})

        def flush():
            if not pending:
                return
            tags = SCALAR_TAGS + ("discriminator_loss",)
            values = pmesh.all_reduce_mean(torch.stack([  # one sync: the process means
                torch.stack([m[t] for t in tags]) for _, _, m in pending])).tolist()
            for (gstep, bsz, _), row in zip(pending, values):
                for tag, value in zip(tags, row):
                    self.logger_train.add_scalar(tag, value, gstep)
                    if tag in sums:
                        sums[tag] += value * bsz
            pending.clear()

        for batch in self.train_loader:
            images = self._to_device(batch["image"])
            metrics, recon = self.step.generator_step(images, adv_w)
            metrics["discriminator_loss"] = self.step.discriminator_step(recon, images, adv_w)
            bsz = images.shape[0]
            self.global_step += bsz
            images_seen += bsz
            pending.append((self.global_step, bsz, metrics))
            if len(pending) >= LOSS_CHUNK:
                flush()
            if self.quick_test:
                break
        flush()
        self.logger_train.flush()
        dt = time.perf_counter() - t0
        self.epoch_times.append((images_seen, dt))
        n = max(images_seen, 1)
        log.info(f"Epoch {epoch}: G {sums['generator_loss'] / n:.5f} "
                 f"D {sums['discriminator_loss'] / n:.5f} L1 {sums['l1_loss'] / n:.5f} "
                 f"({images_seen} images in {dt:.1f}s, {images_seen / max(dt, 1e-9):.2f} img/s)")
        return sums["generator_loss"] / n

    # -------------------------------------------------------------------- val --
    def val_epoch(self, epoch: int) -> None:
        sums = {tag: 0.0 for tag in SCALAR_TAGS}
        count, last = 0, None
        for batch in self.val_loader:
            images = self._to_device(batch["image"])
            metrics, recon = self.step.eval_step(images)
            values = torch.stack([metrics[t] for t in SCALAR_TAGS]).tolist()
            bsz = images.shape[0]
            count += bsz
            for tag, value in zip(SCALAR_TAGS, values):
                sums[tag] += value * bsz
            last = (images, recon)
            if self.quick_test:
                break
        # the means over every process's images
        *totals, count = pmesh.all_reduce_sum_(torch.tensor(
            [*sums.values(), count], dtype=torch.float64, device=self.device)).tolist()
        sums = dict(zip(sums, totals))
        for tag, total in sums.items():
            self.logger_val.add_scalar(tag, total / max(count, 1), self.global_step)
        log.info(f"Epoch {epoch}: val G loss {sums['generator_loss'] / max(count, 1):.5f}")
        if last is not None and self.rank == 0:
            path = self.logger_val.add_figure("RECONSTRUCTIONS", self._recon_grid(*last),
                                              self.global_step)
            log.info(f"Wrote the reconstructions {path}")
        self.logger_val.flush()

    def _recon_grid(self, images: torch.Tensor, recon: torch.Tensor) -> np.ndarray:
        n = min(4, images.shape[0])
        pair = torch.stack([images[:n].float(), recon[:n]], dim=1).movedim(2, -1)
        if self.spatial_dimension == 3:  # (n, 2, X, Y, Z, C) -> the middle X slice
            pair = pair[:, :, pair.shape[2] // 2]
        return np.clip(pair.cpu().numpy(), 0.0, 1.0)
