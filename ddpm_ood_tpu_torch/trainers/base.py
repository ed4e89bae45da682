"""BaseTrainer: model, schedule, checkpoint and training-state wiring.

Port of ``ddpm_ood_tpu/trainers/base.py``:
the UNet preset (2D or 3D), the frozen VQ-VAE of a latent diffusion model
(``--vqvae_checkpoint``, a ``.pth`` with ``vqvae_config.json`` beside it;
the UNet then works on ``embedding_dim`` channels; none in pixel space), the
latent pad, the stage-2 hooks ``encode_fn`` / ``decode_fn``, the noise
schedule, checkpoint discovery and loading (``--use_ema`` included) for
scoring, and for training (``training=True``)
the state the JAX package keeps in its ``TrainState``: Adam, the weight-EMA
slot, ``start_epoch``, ``global_step`` (counted in images, as the
reference), ``best_loss`` (1000.0 on a fresh run), resume from the
checkpoint ``find_checkpoint`` picks, and ``save_checkpoint`` in the
reference schema; ``reload_params`` re-reads a checkpoint into the model in
place (the serving hot reload).

Under torchrun (``parallel/mesh.py``) a process takes ``cuda:LOCAL_RANK``;
the CLI joins the process group, and the trainer reads its size and this
process's rank. Training wraps the UNet in
``DistributedDataParallel`` when there is more than one process, or shards
it with FSDP2 under ``--fsdp=1`` (``parallel/fsdp.py``). ``self.unet`` stays
the unwrapped module, which the EMA, ``reload_params`` and checkpoints use.
Rank 0 writes a checkpoint (every rank gathers its shards first under
FSDP2), and every rank waits for the file before it goes on, so all resume
from rank 0's file.

Precision: on CUDA the UNet and the VQ-VAE compute in bf16
(``torch.autocast``) with their parameters in fp32 and GroupNorm statistics
and the codebook search in fp32, as the JAX package does on its
accelerator; on the CPU everything is fp32. TF32 is switched off
for fp32 matmuls and convolutions alike, so fp32 means fp32.
"""

from __future__ import annotations

import logging
import math
import os
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..diffusion.schedules import make_schedule
from ..models.unet import jax_like_init_, make_unet, memory_format
from ..models.vqvae import VQVAE
from ..parallel import fsdp
from ..parallel import mesh as pmesh
from ..train.ddpm import DDPMTrainStep
from ..utils import checkpoint as ckpt
from ..utils.convert import jax_unet_params_to_state_dict, load_params_npz
from ..utils.padding import padded_shape

log = logging.getLogger(__name__)


def resolve_device(name: str) -> torch.device:
    """A torch.device for `name`: ``cuda`` is this process's card
    (``cuda:LOCAL_RANK`` under torchrun). Asking for CUDA without a card
    raises."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device={name} but torch.cuda.is_available() is false; "
                               "pass --device=cpu to run the plain PyTorch path on the CPU")
        if device.index is None:
            device = torch.device("cuda", pmesh.local_device_index())
    elif device.type != "cpu":
        raise ValueError(f"unsupported --device={name} (cuda or cpu)")
    return device


def refuse_flags(args, refused: Sequence[Tuple[str, bool, str]]) -> None:
    """Raise NotImplementedError naming the first (flag, is_set, why) that is
    set."""
    for name, on, why in refused:
        if on:
            raise NotImplementedError(
                f"{name}={getattr(args, name[2:], None)} is not ported to ddpm_ood_tpu_torch"
                + (f" ({why})" if why else ""))


def refuse_multi_process(what: str) -> None:
    """Raise NotImplementedError under a launch of more than one process:
    `what` runs one process (training, scoring and the service run under
    torchrun)."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise NotImplementedError(
            f"more than one process (WORLD_SIZE={world}) is not ported to {what}: run one "
            "process")


class BaseTrainer:
    def __init__(self, args, device: torch.device, training: bool = False,
                 init_weights: Optional[Path] = None):
        """`init_weights` (training only): an npz of JAX-tree UNet params
        (``utils.convert.load_params_npz``) to start from, in place of
        ``jax_like_init_``'s draw from ``--seed``."""
        log.info(f"Arguments: {args}")
        self.fsdp = training and bool(getattr(args, "fsdp", 0))
        pmesh.check_joined()
        self.device = device
        self.spatial_dimension = int(args.spatial_dimension)
        self.image_size = int(args.image_size) if args.image_size else None
        roi = getattr(args, "image_roi", None)  # parsed by ast.literal_eval
        self.image_roi = tuple(roi) if roi else None
        self.is_grayscale = bool(getattr(args, "is_grayscale", False))
        self.autocast_dtype = torch.bfloat16 if device.type == "cuda" else None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # frozen VQ-VAE (latent diffusion), or none (pixel space)
        self.vqvae_checkpoint = getattr(args, "vqvae_checkpoint", None)
        if self.vqvae_checkpoint:
            self.vqvae_config, state = ckpt.load_vqvae_checkpoint(self.vqvae_checkpoint)
            self.vqvae = VQVAE(**self.vqvae_config)
            self.vqvae.load_state_dict(state, strict=True)
            self.vqvae = self.vqvae.to(
                device, memory_format=memory_format(self.spatial_dimension)).eval()
            log.info(f"Loaded VQ-VAE {self.vqvae_checkpoint} with config {self.vqvae_config}")
            self.ddpm_channels = int(self.vqvae_config["embedding_dim"])
        else:
            self.vqvae, self.vqvae_config = None, None
            self.ddpm_channels = 1 if self.is_grayscale else 3
        pad = getattr(args, "latent_pad", None)  # parsed by ast.literal_eval
        self.latent_pad = tuple(int(p) for p in pad) if pad else None

        quantize = getattr(args, "quantize", "none")
        self.unet = make_unet(
            args.model_type, self.spatial_dimension, self.ddpm_channels, self.ddpm_channels,
            remat=bool(getattr(args, "remat", 0)), quant=quantize,
        )
        if quantize not in (None, "none"):
            log.info(f"Quantized scoring enabled: {quantize} block convolutions")
        self.b_scale = float(args.b_scale)
        self.sched = make_schedule(
            schedule=args.beta_schedule,
            num_train_timesteps=1000,
            beta_start=float(args.beta_start),
            beta_end=float(args.beta_end),
            prediction_type=args.prediction_type,
            snr_shift=float(getattr(args, "snr_shift", 1)),
            device=device,
        )

        self.run_dir = Path(args.output_dir) / args.model_name
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.use_ema = bool(getattr(args, "use_ema", 0))
        epoch = getattr(args, "ddpm_checkpoint_epoch", None)
        path = ckpt.find_checkpoint(self.run_dir, int(epoch) if epoch else None)
        if training:
            if init_weights is not None:
                self.unet.load_state_dict(
                    jax_unet_params_to_state_dict(load_params_npz(init_weights)), strict=True)
                log.info(f"Initial weights from {init_weights}")
            else:
                jax_like_init_(self.unet, torch.Generator().manual_seed(int(args.seed)))
            payload = ckpt.load_checkpoint(path) if path is not None else None
            if payload is not None:
                self.unet.load_state_dict(payload["model_state_dict"], strict=True)
            self.unet = self.unet.to(device, memory_format=memory_format(self.spatial_dimension))
            runner, sync_grads = self._wrap(device)
            self.step = DDPMTrainStep(
                model=self.unet, sched=self.sched, b_scale=self.b_scale,
                learning_rate=float(args.learning_rate),
                lr_warmup_steps=int(args.lr_warmup_steps),
                ema_decay=float(args.ema_decay),
                grad_accum=int(args.grad_accum_steps or 1),
                autocast_dtype=self.autocast_dtype,
                encode_fn=self.vqvae.encode_stage_2_inputs if self.vqvae is not None else None,
                latent_pad=self.latent_pad,
                runner=runner, sync_grads=sync_grads,
            )
            self.start_epoch, self.global_step, self.best_loss = 0, 0, 1000.0
            if payload is not None:
                self._resume(path, payload)
            if self.fsdp:
                log.info(f"FSDP: params + optimizer state sharded {pmesh.process_count()}-way "
                         f"({fsdp.sharded_bytes_per_device(self.unet.parameters()) / 2**20:.1f} "
                         "MiB params/device)")
        else:
            if path is not None:
                self._load(path)
            self.unet = self.unet.to(
                device, memory_format=memory_format(self.spatial_dimension)).eval()
        n_params = sum(p.numel() for p in self.unet.parameters())
        log.info(f"{n_params:,} model parameters on {device}")

    def _load(self, path: Path) -> None:
        """The checkpoint's weights (its EMA slot with --use_ema), copied into
        the model's existing parameters wherever they live."""
        payload = ckpt.load_checkpoint(path)
        key = "model_state_dict"
        if self.use_ema:
            if "ema_model_state_dict" not in payload:
                raise RuntimeError(f"--use_ema requested but checkpoint {path} has no "
                                   "ema_model_state_dict (was it trained with --ema_decay > 0?)")
            key = "ema_model_state_dict"
            log.info("Using EMA weights (ema_model_state_dict) for the model")
        self.unet.load_state_dict(payload[key], strict=True)
        self.start_epoch = int(payload.get("epoch", 0))
        log.info(f"Loaded checkpoint {path} (epoch {payload.get('epoch')})")

    def reload_params(self, epoch: Optional[int] = None) -> Path:
        """Re-read the run's checkpoint (an explicit epoch's, else the one
        ``find_checkpoint`` picks) into the model in place: the serving
        hot-reload hook. The UNet, ``model_fn`` and every program holding it
        stay the same objects. Returns the checkpoint's path."""
        path = ckpt.find_checkpoint(self.run_dir, int(epoch) if epoch is not None else None)
        if path is None:
            raise FileNotFoundError(f"No checkpoint under {self.run_dir}"
                                    + (f" for epoch {epoch}" if epoch is not None else ""))
        self._load(path)
        log.info(f"Hot-reloaded weights from {path} (epoch {self.start_epoch})")
        return path

    def _wrap(self, device: torch.device):
        """(the module that runs the training forward, the gradient sync
        after the backward): FSDP2 under ``--fsdp=1``, DDP for more than one
        process, else the UNet itself."""
        if self.fsdp:
            replicated = fsdp.apply_fsdp(self.unet, fsdp.min_size_from_env())
            return self.unet, lambda: fsdp.sync_replicated_grads(replicated)
        if pmesh.process_count() > 1:
            return pmesh.wrap_ddp(self.unet, device), None
        return self.unet, None

    def _resume(self, path: Path, payload: dict) -> None:
        """Adam, EMA, epoch, step count and best loss from `path`'s payload
        (the model's weights are loaded before it is wrapped). A checkpoint
        without an EMA slot seeds the EMA from its weights."""
        fsdp.load_optimizer_state(self.step.optimizer, payload["optimizer_state_dict"])
        if self.step.ema is not None:
            ema = payload.get("ema_model_state_dict", payload["model_state_dict"])
            for name, t in self.step.ema.items():
                fsdp.load_full_(t, ema[name])
        self.start_epoch = int(payload["epoch"])
        self.global_step = int(payload["global_step"])
        self.best_loss = float(payload["best_loss"])
        log.info(f"Resuming training using checkpoint {path} at epoch {self.start_epoch}")

    def save_checkpoint(self, name: str, epoch: int, save_message: Optional[str] = None) -> Path:
        """``<run>/<name>.pth`` in the reference schema; epoch + 1, so a resume
        starts on the next epoch. Every process calls it: shards are gathered
        on all, rank 0 writes, and all wait until the file is there."""
        if save_message:
            log.info(save_message)
        payload = {
            "epoch": int(epoch) + 1,
            "global_step": int(self.global_step),
            "model_state_dict": fsdp.full_state_dict(self.unet.state_dict()),
            "optimizer_state_dict": fsdp.full_optimizer_state(self.step.optimizer.state_dict()),
            "best_loss": float(self.best_loss),
        }
        if self.step.ema is not None:
            payload["ema_model_state_dict"] = fsdp.full_state_dict(self.step.ema)
        target = self.run_dir / f"{name}.pth"
        if pmesh.process_index() == 0:
            ckpt.write_checkpoint(target, payload)
        pmesh.coordination_barrier(f"checkpoint {name}")
        return target

    def _latent_sample_shape(self) -> Tuple[int, ...]:
        """(*spatial, C) of the tensor the UNet consumes: the image size, over
        the VQ-VAE's total stride, plus the latent pad."""
        size = self.image_size or 32
        spatial = (size,) * self.spatial_dimension
        if self.image_roi and not self.image_size:
            spatial = tuple(self.image_roi)
        if self.vqvae_config is not None:
            factor = math.prod(p[0] for p in self.vqvae_config["downsample_parameters"])
            spatial = tuple(max(1, s // factor) for s in spatial)
        if self.latent_pad:
            spatial = padded_shape(spatial, self.latent_pad)
        return spatial + (self.ddpm_channels,)

    @property
    def encode_fn(self) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """images (B, *spatial, C) -> quantized latents (B, *latent, E), or
        None in pixel space."""
        if self.vqvae_config is None:
            return None
        return lambda x: self.vqvae.encode_stage_2_inputs(x.movedim(-1, 1)).movedim(1, -1)

    @property
    def decode_fn(self) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """latents (N, *latent, E) -> re-quantized and decoded (N, *spatial, C),
        or None in pixel space."""
        if self.vqvae_config is None:
            return None
        return lambda z: self.vqvae.decode_stage_2_outputs(z.movedim(-1, 1)).movedim(1, -1)

    def model_fn(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """UNet forward on (N, C, *spatial) channels-last input."""
        return self.unet(x, t)
