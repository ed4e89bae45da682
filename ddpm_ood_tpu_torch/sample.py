"""Unconditional sample generation from a trained checkpoint.

Port of the JAX package's ``scripts/sample.py``:

    python -m ddpm_ood_tpu_torch.sample --output_dir=... --model_name=... \\
        --model_type=small [--n_samples 16] [--sampler dpm --num_inference_steps 25] \\
        [--seed 0] [--device=cuda|cpu] [the usual model/schedule flags]

It loads a pixel-space DDPM or a latent one (``--vqvae_checkpoint``,
``--latent_pad``, ``--b_scale``: the trainer's own sampling path) and runs
``ddpm`` (full-T ancestral, ``diffusion/ddpm.py:ddpm_sample``) or one of the
grid samplers ``plms`` / ``ddim`` / ``dpm`` from the grid's first entry
(``plms_denoise``, ``ddim_denoise``, ``dpm_denoise``), then un-pads, decodes,
divides by b_scale and clips to [0, 1]. It writes
``<out or run/samples>/samples_<sampler>_<steps>_seed<seed>.npy``,
(n, *spatial, C) float32. The JAX CLI also draws a PNG grid with
matplotlib, which the port does not use, so it writes the ``.npy`` only.

The noise comes from a ``torch.Generator`` seeded with ``--seed``, so the
samples differ from the JAX CLI's ``PRNGKey(seed)`` draws. On CUDA the UNet
runs under bf16 autocast, as in scoring and training. ``--device`` defaults
to cuda, which raises without a card.
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path

import numpy as np
import torch

from .config import parse_args_sample
from .diffusion.ddim import ddim_denoise, ddim_timesteps
from .diffusion.ddpm import ddpm_sample
from .diffusion.dpm_solver import dpm_denoise, dpm_timesteps
from .diffusion.plms import plms_denoise, pndm_timesteps
from .utils.padding import unpad_torch_style

log = logging.getLogger(__name__)

GRID_SAMPLERS = {"plms": (pndm_timesteps, plms_denoise), "ddim": (ddim_timesteps, ddim_denoise),
                 "dpm": (dpm_timesteps, dpm_denoise)}


def main(argv=None) -> Path:
    """Returns the path of the written ``.npy``."""
    from .trainers.base import BaseTrainer, refuse_multi_process, resolve_device
    from .utils.checkpoint import find_checkpoint, missing_checkpoint_error

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args_sample(argv)
    refuse_multi_process("the sample CLI")
    device = resolve_device(args.device)
    run_dir = Path(args.output_dir) / args.model_name
    epoch = getattr(args, "ddpm_checkpoint_epoch", None)
    if find_checkpoint(run_dir, int(epoch) if epoch else None) is None:
        raise missing_checkpoint_error(run_dir)
    trainer = BaseTrainer(args, device)

    def model_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The UNet on (n, *spatial, C) samples: a free permute to its
        channels-last (n, C, *spatial) and back."""
        nd = x.dim()
        out = trainer.model_fn(x.permute((0, nd - 1) + tuple(range(1, nd - 1))), t)
        return out.permute((0,) + tuple(range(2, nd)) + (1,))

    n = int(args.n_samples)
    gen = torch.Generator(device=device).manual_seed(int(args.seed))
    noise = torch.randn((n,) + tuple(trainer._latent_sample_shape()), generator=gen,
                        device=device)
    autocast = (torch.autocast(device.type, dtype=trainer.autocast_dtype)
                if trainer.autocast_dtype is not None else contextlib.nullcontext())
    with torch.no_grad(), autocast:
        if args.sampler == "ddpm":
            latents = ddpm_sample(trainer.sched, model_fn, noise, gen)
        else:
            make_ts, denoise = GRID_SAMPLERS[args.sampler]
            steps = int(args.num_inference_steps)
            ts = make_ts(trainer.sched.num_train_timesteps, steps)
            latents = denoise(trainer.sched, model_fn, noise, ts, int(ts[0]), steps)
        if trainer.latent_pad:
            latents = unpad_torch_style(latents, trainer.latent_pad)
        decode = trainer.decode_fn
        samples = decode(latents) if decode is not None else latents
    samples = np.clip((samples.float() / trainer.b_scale).cpu().numpy(), 0.0, 1.0)

    out_dir = Path(args.out) if args.out else trainer.run_dir / "samples"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"samples_{args.sampler}_{args.num_inference_steps}_seed{args.seed}.npy"
    np.save(path, samples)
    print(f"Wrote {n} samples to {path} (.npy only: the port draws no PNG grid)")
    return path


if __name__ == "__main__":
    main()
