"""End-to-end 3D latent-diffusion smoke through the port's four CLIs:
synthetic 32-cubed NIfTI volumes -> 3D VQ-VAE + PatchGAN (train_vqvae) ->
latent DDPM (train_ddpm --vqvae_checkpoint) -> 3D latent reconstruction
sweep (reconstruct) -> AUROC (ood_detection), the reference Decathlon recipe
(README.md:141-190) at smoke scale.

    python -m ddpm_ood_tpu_torch.smoke_3d_ldm [workspace] [--device=cuda|cpu]
    SAMPLER=dpm STEPS=25 SKIP=1 python -m ddpm_ood_tpu_torch.smoke_3d_ldm  # sweep variants

The twin of ``scripts/smoke_3d_ldm.sh``: the same volumes and CSVs, the same
flags, each stage in a fresh interpreter with the shell script's 2400 s
limit. The workspace (default /tmp/ldm3d_smoke) is emptied first, as there.
The port's VQ-VAE trainer writes ``checkpoint.pth`` beside
``vqvae_config.json``, which is what ``--vqvae_checkpoint`` names here (the
JAX script names an Orbax ``checkpoint`` directory). ``--device`` (default
cuda) goes to the three device stages.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Tuple

from .data.csv_splits import write_split_csv
from .data.nifti import save_nifti

REPO = Path(__file__).resolve().parent.parent
STAGE_TIMEOUT = 2400  # seconds, the shell script's `timeout 2400` per stage
# the nine held-out Decathlon tasks (the registry requires every CSV, parity
# with reference ood_detection.py)
HELD_OUT = ("Task02_Heart", "Task03_Liver", "Task04_Hippocampus", "Task05_Prostate",
            "Task06_Lung", "Task07_Pancreas", "Task08_HepaticVessel", "Task09_Spleen",
            "Task10_Colon")


def make_dataset(root: Path) -> None:
    """The shell script's heredoc: sine volumes in distribution, 3D
    checkerboards of varied period out of it, as .nii.gz with split CSVs."""
    import numpy as np

    rng = np.random.default_rng(0)
    zz, yy, xx = np.meshgrid(*[np.arange(32)] * 3, indexing="ij")

    def make(name, n, ood=False):
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        paths = []
        for i in range(n):
            if ood:
                vol = (((xx // 4 + yy // 4 + zz // 4) + i) % 2).astype(np.float32)
            else:
                ph = rng.uniform(0, 2 * np.pi)
                vol = (0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy + zz) / 32 + ph)).astype(
                    np.float32)
            p = d / f"{name.split('.')[0]}_{i}.nii.gz"
            save_nifti(str(p), vol)
            paths.append(str(p))
        write_split_csv(paths, str(root / f"{name}.csv"))

    make("train", 8)
    make("val", 4)
    make("Task01_BrainTumour_test", 4)
    for j, nm in enumerate(HELD_OUT):
        k = 2 + (j % 4)
        d = root / f"{nm}_test"
        d.mkdir(parents=True, exist_ok=True)
        paths = []
        for i in range(4):
            vol = (((xx // k + yy // k + zz // k) + i) % 2).astype(np.float32)
            p2 = d / f"{nm}_test_{i}.nii.gz"
            save_nifti(str(p2), vol)
            paths.append(str(p2))
        write_split_csv(paths, str(root / f"{nm}_test.csv"))


def stages(ws: Path, sampler: str, steps: str, skip: str,
           device: str) -> List[Tuple[str, List[str]]]:
    """(port CLI module, its argv) of each stage, in order."""
    vqvae = f"--vqvae_checkpoint={ws}/output/vqvae_decathlon/checkpoint.pth"
    schedule = ["--beta_schedule=scaled_linear_beta", "--beta_start=0.0015",
                "--beta_end=0.0195"]
    volumes = ["--spatial_dimension=3", "--image_size=32", "--is_grayscale=0"]
    out_ids = ",".join(f"{ws}/{nm}_test.csv" for nm in HELD_OUT)
    return [
        # stage 1: 3D VQ-VAE + PatchGAN (32-cubed, 2 levels -> latent 8-cubed)
        ("train_vqvae", [f"--output_dir={ws}/output", "--model_name=vqvae_decathlon",
                         f"--training_ids={ws}/train.csv", f"--validation_ids={ws}/val.csv",
                         *volumes, "--vqvae_num_channels=[32,32]",
                         "--vqvae_num_res_channels=[32,32]", "--vqvae_num_res_layers=1",
                         "--vqvae_downsample_parameters=[[2,4,1,1],[2,4,1,1]]",
                         "--vqvae_upsample_parameters=[[2,4,1,1,0],[2,4,1,1,0]]",
                         "--vqvae_embedding_dim=8", "--vqvae_num_embeddings=64",
                         "--batch_size=2", "--n_epochs=2", "--eval_freq=2",
                         "--checkpoint_every=2", f"--device={device}"]),
        # stage 2: latent DDPM against the frozen VQ-VAE
        ("train_ddpm", [f"--output_dir={ws}/output", "--model_name=ldm_decathlon", vqvae,
                        f"--training_ids={ws}/train.csv", f"--validation_ids={ws}/val.csv",
                        *volumes, "--model_type=tiny", *schedule, "--batch_size=2",
                        "--n_epochs=2", "--eval_freq=2", "--checkpoint_every=2",
                        f"--device={device}"]),
        # stage 3: 3D latent reconstruction sweep
        ("reconstruct", [f"--output_dir={ws}/output", "--model_name=ldm_decathlon", vqvae,
                         f"--validation_ids={ws}/val.csv",
                         f"--in_ids={ws}/Task01_BrainTumour_test.csv", f"--out_ids={out_ids}",
                         *volumes, "--model_type=tiny", *schedule, "--batch_size=2",
                         f"--sampler={sampler}", f"--num_inference_steps={steps}",
                         f"--inference_skip_factor={skip}", f"--device={device}"]),
        # stage 4: score
        ("ood_detection", [f"--output_dir={ws}/output", "--model_name=ldm_decathlon"]),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("workspace", nargs="?", default="/tmp/ldm3d_smoke")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    ws = Path(args.workspace).resolve()
    sampler = os.environ.get("SAMPLER", "plms")
    steps = os.environ.get("STEPS", "10")
    skip = os.environ.get("SKIP", "3")
    shutil.rmtree(ws, ignore_errors=True)
    ws.mkdir(parents=True)
    make_dataset(ws)
    for module, flags in stages(ws, sampler, steps, skip, args.device):
        print(f"== {module} {' '.join(flags[:2])} ...", flush=True)
        subprocess.run([sys.executable, "-m", f"ddpm_ood_tpu_torch.{module}", *flags],
                       cwd=REPO, check=True, timeout=STAGE_TIMEOUT)
    print("LDM3D_ALL_OK")


if __name__ == "__main__":
    main()
