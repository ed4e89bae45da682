"""The port as a library (no CLIs): train a DDPM, score OOD inputs.

    python -m ddpm_ood_tpu_torch.minimal_library_usage [--device=cuda|cpu]

The twin of ``examples/minimal_library_usage.py``: the same data, epochs
and printed lines through the port's pieces that the CLIs wrap (the
schedule, ``make_unet("tiny", ...)``, ``DDPMTrainStep``, ``ReconProgram``
and ``ood.score.auroc``), useful when embedding the scorer in a larger
system or experimenting in a notebook. Torch generators take the place of
JAX's ``PRNGKey``s, so the numbers are not JAX's; the checkerboards still
separate from the sines. On the card the UNet computes in bf16 under
autocast, as the CLIs do; on the CPU in fp32.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .diffusion.schedules import make_schedule
from .models.unet import jax_like_init_, make_unet
from .ood.score import auroc
from .recon.sweep import ReconProgram
from .train.ddpm import DDPMTrainStep
from .trainers.base import resolve_device

EPOCHS = 60


def main(argv=None) -> float:
    """Prints the losses, the mean Z-scores and the AUROC; returns the AUROC."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    device = resolve_device(ap.parse_args(argv).device)
    autocast_dtype = torch.bfloat16 if device.type == "cuda" else None
    size, channels = 16, 1
    rng = np.random.default_rng(0)

    def sines(n, freq):
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        out = []
        for _ in range(n):
            f = rng.uniform(0.8, 1.2) * freq
            ph = rng.uniform(0, 2 * np.pi)
            out.append(0.5 + 0.5 * np.sin(f * xx + ph) * np.cos(f * yy))
        return np.stack(out)[..., None].astype(np.float32)  # (n, H, W, 1)

    def checkers(n):
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        return np.stack(
            [((xx // 2 + yy // 2 + i) % 2).astype(np.float32) for i in range(n)]
        )[..., None]

    train, val = sines(64, 0.5), sines(16, 0.5)
    in_dist, out_dist = sines(16, 0.5), checkers(16)  # OOD = wrong structure

    # -- model + schedule (reference defaults: scaled_linear 0.0015..0.0195) ----
    unet = jax_like_init_(make_unet("tiny", 2, channels, channels),
                          torch.Generator().manual_seed(0))
    unet = unet.to(device, memory_format=torch.channels_last)
    sched = make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device)

    # -- the train step: noising + fwd/bwd + Adam -------------------------------
    step = DDPMTrainStep(model=unet, sched=sched, autocast_dtype=autocast_dtype)
    shuffle = torch.Generator().manual_seed(1)
    noise_gen = torch.Generator(device=device).manual_seed(1)
    images = torch.from_numpy(train).permute(0, 3, 1, 2).to(device)  # (n, C, H, W)
    for epoch in range(EPOCHS):
        perm = torch.randperm(train.shape[0], generator=shuffle)
        for i in range(0, train.shape[0], 16):
            x0 = step.prepare(images[perm[i:i + 16].to(device)])
            t, noise = step.draw(x0, noise_gen)
            loss = step.step(x0, t, noise)
        if epoch % 20 == 0:
            print(f"epoch {epoch}: loss {float(loss):.4f}")

    # -- the batched multi-t_start reconstruction sweep -------------------------
    unet.eval()
    program = ReconProgram(
        sched=sched, model_fn=unet, device=device,
        num_inference_steps=20, inference_skip_factor=2, num_groups=4,
        autocast_dtype=autocast_dtype,
    )

    def scores(images):
        t_starts, mse, _ = program(images, torch.Generator(device=device).manual_seed(7))
        return mse.float().cpu().numpy()  # (K, B) per-(t_start, image) errors

    # -- per-t Z-score against the validation set, mean over t ------------------
    val_mse = scores(val)
    mu, sd = val_mse.mean(axis=1, keepdims=True), val_mse.std(axis=1, keepdims=True) + 1e-8
    z = lambda m: ((m - mu) / sd).mean(axis=0)  # noqa: E731 — (B,) per-image score
    z_in, z_out = z(scores(in_dist)), z(scores(out_dist))

    labels = np.concatenate([np.zeros_like(z_in), np.ones_like(z_out)])
    result = auroc(labels, np.concatenate([z_in, z_out]))
    print(f"mean Z in-dist {z_in.mean():.2f}  out-dist {z_out.mean():.2f}")
    print(f"AUROC: {result:.3f}")
    return result


if __name__ == "__main__":
    main()
