"""Five-minute end-to-end demo of the port on synthetic data, no downloads.

    python -m ddpm_ood_tpu_torch.demo [--workdir=/tmp/ddpm_ood_demo] [--device=cuda|cpu]

The twin of ``scripts/demo.py``. It writes a tiny in-distribution set (sine
textures) and an OOD set (checkerboards), then drives the port's three CLIs
as a real run would, each in a fresh interpreter:

    train_ddpm  ->  reconstruct  ->  ood_detection

and prints the resulting AUCs (checkerboard-OOD should be ~100 even after
two epochs; flip-OOD needs real training). ``--device`` (default cuda,
which raises without a card) replaces the JAX script's ``--backend``; it
goes to the training and scoring CLIs, and ood_detection is numpy only.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
from typing import List, Tuple

from .data.csv_splits import write_split_csv

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = 16
MODEL = "demo_fashionmnist"


def make_dataset(ws: pathlib.Path):
    import numpy as np

    rng = np.random.default_rng(0)

    def sine(i):
        x = np.linspace(0, 2 * np.pi, SIZE)
        f = 1 + (i % 4)
        img = 0.5 + 0.45 * np.sin(f * x[None, :] + i) * np.cos(f * x[:, None])
        return (img + rng.normal(0, 0.02, (SIZE, SIZE))).astype(np.float32)[None]

    def checker(i):
        t = 2 + (i % 3)
        img = np.indices((SIZE, SIZE)).sum(0) // t % 2
        return (
            img.astype(np.float32)
            + rng.normal(0, 0.02, (SIZE, SIZE)).astype(np.float32)
        )[None]

    sets = [
        ("train", sine, 32),
        ("val", sine, 8),
        ("FashionMNIST_test", sine, 8),   # "in" set (registry-named)
        ("MNIST_test", checker, 8),       # structural OOD
    ]
    for name, gen, n in sets:
        d = ws / name
        d.mkdir(parents=True, exist_ok=True)
        paths = []
        for i in range(n):
            p = d / f"{name}_{i}.npy"
            np.save(p, gen(i + (100 if "test" in name else 0)))
            paths.append(str(p))
        write_split_csv(paths, str(ws / f"{name}.csv"))


def stages(ws: pathlib.Path, epochs: int, device: str) -> List[Tuple[str, List[str]]]:
    """(port CLI module, its argv) of each stage, in order."""
    common = [
        f"--output_dir={ws}/output", f"--model_name={MODEL}",
        f"--validation_ids={ws}/val.csv", f"--image_size={SIZE}",
        "--model_type=tiny", "--beta_schedule=scaled_linear_beta",
        "--beta_start=0.0015", "--beta_end=0.0195", "--batch_size=4",
        "--is_grayscale=1",
    ]
    return [
        ("train_ddpm", [*common, f"--training_ids={ws}/train.csv", f"--n_epochs={epochs}",
                        "--eval_freq=2", "--checkpoint_every=2", f"--device={device}"]),
        ("reconstruct", [*common, f"--in_ids={ws}/FashionMNIST_test.csv",
                         f"--out_ids={ws}/MNIST_test.csv,"
                         f"{ws}/FashionMNIST_test.csv_vflip,{ws}/FashionMNIST_test.csv_hflip",
                         "--num_inference_steps=10", "--inference_skip_factor=3",
                         f"--device={device}"]),
        ("ood_detection", [f"--output_dir={ws}/output", f"--model_name={MODEL}"]),
    ]


def run(module: str, flags: List[str]) -> None:
    """A port CLI in a fresh interpreter, from the repository root."""
    print(f"== {module} {' '.join(flags[:4])} ...", flush=True)
    subprocess.run([sys.executable, "-m", f"ddpm_ood_tpu_torch.{module}", *flags],
                   cwd=REPO, check=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/ddpm_ood_demo")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args(argv)

    ws = pathlib.Path(args.workdir).resolve()
    ws.mkdir(parents=True, exist_ok=True)
    make_dataset(ws)
    for module, flags in stages(ws, args.epochs, args.device):
        run(module, flags)
    print(f"\ndemo artifacts under {ws}/output/{MODEL}/")


if __name__ == "__main__":
    main()
