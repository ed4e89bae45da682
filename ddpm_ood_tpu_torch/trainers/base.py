"""BaseTrainer: model, schedule and checkpoint wiring for scoring.

Port of the parts of ``ddpm_ood_tpu/trainers/base.py`` that ``Reconstruct``
needs: the UNet preset, the noise schedule, checkpoint discovery and
loading (``--use_ema`` included). There is no mesh, no FSDP and no
optimizer state: the port runs one process on one device.

Precision: on CUDA the UNet computes in bf16 (``torch.autocast``) with its
parameters in fp32 and GroupNorm statistics in fp32, as the JAX package
does on its accelerator; on the CPU everything is fp32. TF32 is switched off
for fp32 matmuls and convolutions alike, so fp32 means fp32.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from ..diffusion.schedules import make_schedule
from ..models.unet import make_unet
from ..utils import checkpoint as ckpt

log = logging.getLogger(__name__)


def resolve_device(name: str) -> torch.device:
    """A torch.device for `name`; asking for CUDA without a card raises."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device={name} but torch.cuda.is_available() is false; "
                               "pass --device=cpu to run the plain PyTorch path on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported --device={name} (cuda or cpu)")
    return device


class BaseTrainer:
    def __init__(self, args, device: torch.device):
        log.info(f"Arguments: {args}")
        self.device = device
        self.spatial_dimension = int(args.spatial_dimension)
        self.image_size = int(args.image_size) if args.image_size else None
        roi = getattr(args, "image_roi", None)  # parsed by ast.literal_eval
        self.image_roi = tuple(roi) if roi else None
        self.is_grayscale = bool(getattr(args, "is_grayscale", False))
        self.ddpm_channels = 1 if self.is_grayscale else 3
        self.autocast_dtype = torch.bfloat16 if device.type == "cuda" else None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.unet = make_unet(
            args.model_type, self.spatial_dimension, self.ddpm_channels, self.ddpm_channels,
            remat=bool(getattr(args, "remat", 0)), quant=getattr(args, "quantize", "none"),
        )
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
        if path is not None:
            self._load(path)
        self.unet = self.unet.to(device, memory_format=torch.channels_last).eval()
        n_params = sum(p.numel() for p in self.unet.parameters())
        log.info(f"{n_params:,} model parameters on {device}")

    def _load(self, path: Path) -> None:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        key = "model_state_dict"
        if self.use_ema:
            if "ema_model_state_dict" not in payload:
                raise RuntimeError(f"--use_ema requested but checkpoint {path} has no "
                                   "ema_model_state_dict (was it trained with --ema_decay > 0?)")
            key = "ema_model_state_dict"
            log.info("Using EMA weights (ema_model_state_dict) for the model")
        self.unet.load_state_dict(payload[key], strict=True)
        log.info(f"Loaded checkpoint {path} (epoch {payload.get('epoch')})")

    def model_fn(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """UNet forward on (N, C, *spatial) channels_last input."""
        return self.unet(x, t)
