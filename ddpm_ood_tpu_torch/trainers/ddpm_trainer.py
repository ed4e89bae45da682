"""DDPM trainer: epoch loop, checkpoint policy, logged metrics.

Port of ``ddpm_ood_tpu/trainers/ddpm_trainer.py`` for 2D and 3D models, in
pixel space or on the latents of a frozen VQ-VAE (``--vqvae_checkpoint``,
``--latent_pad``), on one device or one process per device under torchrun
(``parallel/mesh.py``; ``--fsdp=1`` shards the UNet with FSDP2):
  - the epoch loop keeps the reference's policy: the rolling ``checkpoint``
    is the best on TRAIN loss, ``checkpoint_{N}`` is written every
    ``--checkpoint_every`` epochs, validation runs every ``--eval_freq``;
  - per step: the batch's x0 (``DDPMTrainStep.prepare``: the images, or
    their padded latents), t ~ U[0, T) and Gaussian noise of x0's shape
    from the trainer's generator (with ``--simplex_noise=1``: t from numpy's
    global RNG and OpenSimplex planes, ``_simplex_batch``, as the JAX
    trainer draws them, in training and validation alike), then
    ``DDPMTrainStep.step`` (noising, MSE on the prediction type's target,
    backward, Adam, EMA); ``global_step`` counts this process's images, as
    the JAX trainer's does;
  - under torchrun each process trains on its partition of the data with
    its own noise stream (``NOISE_SEED + rank``); the logged train and
    validation losses are means over all processes, as the JAX package's
    global-batch step gives them, and the sample grid is rank 0's;
  - ``--remat=1`` recomputes the UNet's res and attention blocks in the
    backward pass; ``--profile_dir`` writes a ``torch.profiler`` trace of
    warm steps 2-4 of the first epoch;
  - per-step train losses stay on the device and are read 32 at a time, so
    the host does not wait for the device at every step;
  - validation logs the mean loss and an ancestral sample grid
    (``diffusion/ddpm.py:ddpm_sample``; 2 samples in 3D, else up to 8; a
    latent model's samples are un-padded and decoded) saved as
    ``val/samples_<step>.npy``;
  - ``--quick_test`` runs one batch of each loop; SIGTERM finishes the epoch,
    checkpoints and stops (``utils/preemption.py``).
"""

from __future__ import annotations

import logging
import time
from typing import List, Tuple

import numpy as np
import torch

from ..data.loader import get_training_data_loader
from ..diffusion.ddpm import ddpm_sample
from ..noise import _native
from ..noise.simplex import Simplex, generate_simplex_noise
from ..parallel import mesh as pmesh
from ..train.ddpm import channels_last
from ..utils.logging import Logger
from ..utils.preemption import PreemptionGuard, checkpoint_if_preempted
from ..utils.profiling import start_trace, stop_trace
from .base import BaseTrainer

log = logging.getLogger(__name__)

NOISE_SEED = 1234  # the JAX trainer's PRNGKey(1234 + process_index), plus the rank
LOSS_CHUNK = 32  # device losses read per host sync


class DDPMTrainer(BaseTrainer):
    def __init__(self, args, device: torch.device, init_weights=None):
        grad_accum = int(args.grad_accum_steps or 1)
        if grad_accum > 1 and args.batch_size % grad_accum != 0:
            raise ValueError(f"--batch_size {args.batch_size} is not divisible by "
                             f"--grad_accum_steps {grad_accum}")
        self.simplex_noise = bool(args.simplex_noise)
        if self.simplex_noise:
            _native.library()  # before the model: no g++ is an error
        super().__init__(args, device, training=True, init_weights=init_weights)
        self.rank = pmesh.process_index()
        self.logger_train = Logger(self.run_dir / "train", enabled=self.rank == 0)
        self.logger_val = Logger(self.run_dir / "val", enabled=self.rank == 0)
        self.train_loader, self.val_loader = get_training_data_loader(
            batch_size=args.batch_size,
            training_ids=args.training_ids,
            validation_ids=args.validation_ids,
            augmentation=bool(args.augmentation),
            num_workers=args.num_workers,
            cache_data=bool(args.cache_data),
            is_grayscale=self.is_grayscale,
            image_size=self.image_size,
            image_roi=self.image_roi,
            spatial_dimension=self.spatial_dimension,
            num_processes=pmesh.process_count(),
            process_index=pmesh.process_index(),
        )
        if self.simplex_noise:
            self.simplex = Simplex()  # a draw from numpy's global RNG, as the JAX trainer's
        self.generator = torch.Generator(device=device).manual_seed(NOISE_SEED + self.rank)
        self.profile_dir = getattr(args, "profile_dir", None)
        self.profile_path = None  # the trace, once written
        self.quick_test = bool(args.quick_test)
        self.sample_forwards = 0  # UNet forwards of the validation sampler
        self.epoch_times: List[Tuple[int, float]] = []  # (images, seconds) per train epoch

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        return channels_last(torch.from_numpy(images).to(self.device, non_blocking=True))

    def _simplex_batch(self, b: int, sample_shape) -> Tuple[np.ndarray, np.ndarray]:
        """t (b,) int32 from numpy's global RNG, then (b, *sample_shape)
        OpenSimplex noise on those planes: the JAX trainer's host draw.
        `sample_shape` is channel-last (*spatial, C)."""
        t = np.random.randint(0, self.sched.num_train_timesteps, size=(b,))
        noise = generate_simplex_noise(self.simplex, (b,) + tuple(sample_shape), t)
        return t.astype(np.int32), noise

    def _draw(self, x0: torch.Tensor):
        """(t, noise) for x0 (B, C, *spatial): Gaussian from the generator,
        or the host's simplex draw."""
        if not self.simplex_noise:
            return self.step.draw(x0, self.generator)
        t, noise = self._simplex_batch(x0.shape[0], tuple(x0.shape[2:]) + (x0.shape[1],))
        noise = torch.from_numpy(noise).to(self.device).movedim(-1, 1)
        return torch.from_numpy(t).to(self.device, torch.int64), channels_last(noise)

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
        self.unet.train()
        epoch_loss, epoch_images = 0.0, 0
        t0 = time.perf_counter()
        pending = []  # (global_step, batch size, loss on the device)

        def flush():
            nonlocal epoch_loss
            if not pending:
                return
            # one sync: the means over processes
            values = pmesh.all_reduce_mean(torch.stack([loss for _, _, loss in pending])).tolist()
            for (gstep, bsz, _), val in zip(pending, values):
                epoch_loss += val * bsz
                self.logger_train.add_scalar("loss", val, gstep)
            pending.clear()

        profiler = None
        for i, batch in enumerate(self.train_loader):
            if self.profile_dir and epoch == self.start_epoch and i == 2 and self.rank == 0:
                profiler = start_trace(self.device)  # warm steps 2-4
            x0 = self.step.prepare(self._to_device(batch["image"]))
            t, noise = self._draw(x0)
            loss = self.step.step(x0, t, noise)
            bsz = x0.shape[0]
            self.global_step += bsz
            epoch_images += bsz
            pending.append((self.global_step, bsz, loss))
            if profiler is not None and i >= 4:
                self.profile_path = stop_trace(profiler, self.device, self.profile_dir,
                                               "train_steps_2_4")
                profiler = None
            if len(pending) >= LOSS_CHUNK:
                flush()
            if self.quick_test:
                break
        if profiler is not None:  # an epoch of under 5 steps
            self.profile_path = stop_trace(profiler, self.device, self.profile_dir,
                                           "train_steps_2_4")
        flush()
        self.logger_train.flush()
        dt = time.perf_counter() - t0
        self.epoch_times.append((epoch_images, dt))
        mean = epoch_loss / max(epoch_images, 1)
        log.info(f"Epoch {epoch}: train loss {mean:.6f} ({epoch_images} images in {dt:.1f}s, "
                 f"{epoch_images / max(dt, 1e-9):.1f} img/s)")
        return mean

    # -------------------------------------------------------------------- val --
    def val_epoch(self, epoch: int) -> None:
        self.unet.eval()
        total, count = 0.0, 0
        last_batch = None
        for batch in self.val_loader:
            x0 = self.step.prepare(self._to_device(batch["image"]))
            t, noise = self._draw(x0)
            total += float(self.step.eval_loss(x0, t, noise)) * x0.shape[0]
            count += x0.shape[0]
            last_batch = x0
            if self.quick_test:
                break
        # the mean over every process's images
        total, count = pmesh.all_reduce_sum_(
            torch.tensor([total, count], dtype=torch.float64, device=self.device)).tolist()
        log.info(f"Epoch {epoch}: val loss {total / max(count, 1):.6f}")
        self.logger_val.add_scalar("loss", total / max(count, 1), self.global_step)
        # rank 0's grid; under FSDP2 every rank samples, since each forward
        # gathers the shards from all
        if last_batch is not None and (self.rank == 0 or self.fsdp):
            self.sample_grid(last_batch)
        self.logger_val.flush()

    @torch.no_grad()
    def sample_grid(self, x0: torch.Tensor) -> np.ndarray:
        """Ancestral samples shaped like x0's items (2 in 3D, else up to 8),
        un-padded and decoded by a latent model's VQ-VAE, /b_scale and
        clipped to [0, 1], saved as (num, *spatial, C) float32 beside the
        val scalars (by rank 0)."""
        num = 2 if self.spatial_dimension == 3 else min(8, x0.shape[0])
        noise = channels_last(torch.randn((num,) + tuple(x0.shape[1:]),
                                          generator=self.generator, device=self.device))

        def model_fn(x, t):
            self.sample_forwards += 1
            return self.unet(x, t)

        with self.step.autocast(self.device):
            samples = self.step.unpad(ddpm_sample(self.sched, model_fn, noise, self.generator))
            if self.vqvae is not None:
                samples = self.vqvae.decode_stage_2_outputs(channels_last(samples))
        grid = np.clip(np.moveaxis((samples / self.b_scale).float().cpu().numpy(), 1, -1), 0, 1)
        path = self.logger_val.add_figure("samples", grid, self.global_step)
        if path is not None:
            log.info(f"Wrote the sample grid {path}")
        return grid
