"""The headline 2D parity pipeline through the port: FashionMNIST
(in-distribution) against MNIST / SVHN / CIFAR10 and the vflip/hflip
near-OOD sets, flag for flag with the reference README.md:61-135.

    python -m ddpm_ood_tpu_torch.parity_run [data_root] [output_root] [--device=cuda|cpu]

The twin of ``scripts/parity_run.sh``. Four stages, each in a fresh
interpreter through ``python -m``, each skipped when its output exists, so
an interrupted run picks up where it stopped:

  1. datasets     ``ddpm_ood_tpu_torch.data.get_computer_vision_datasets``,
                  skipped when the six split CSVs exist;
  2. train        ``ddpm_ood_tpu_torch.train_ddpm`` (300 epochs,
                  scaled_linear_beta 0.0015-0.0195), skipped when
                  ``checkpoint_300.pth`` exists; a partial run leaves the
                  rolling ``checkpoint.pth``, which the trainer resumes;
  3. reconstruct  ``ddpm_ood_tpu_torch.reconstruct`` (100-step PLMS, skip
                  4) on the sets whose results CSV is missing;
  4. report       ``ddpm_ood_tpu_torch.parity_report``.

Relative paths are taken from the repository root, where the stages run, as
the shell script ``cd``s there. ``--device`` (default cuda) goes to the
training and scoring stages. With network access the datasets download;
offline, place the raw archives under ``<data_root>/<Dataset>/raw/``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

REPO = Path(__file__).resolve().parent.parent
SPLITS = ("FashionMNIST_train", "FashionMNIST_val", "FashionMNIST_test", "MNIST_test",
          "SVHN_test", "CIFAR10_test")
# (split CSV, results CSV name) of each OOD set, in the shell script's order
OUT_SETS = (("MNIST_test.csv", "MNIST"), ("SVHN_test.csv", "SVHN"),
            ("CIFAR10_test.csv", "CIFAR10"),
            ("FashionMNIST_test.csv_vflip", "FashionMNIST_vflip"),
            ("FashionMNIST_test.csv_hflip", "FashionMNIST_hflip"))
MODEL = "fashionmnist"
SCHEDULE = ["--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195"]


def _cli(module: str, *flags: str) -> List[str]:
    return [sys.executable, "-m", f"ddpm_ood_tpu_torch.{module}", *flags]


def prep_command(data_root: str) -> List[str]:
    return _cli("data.get_computer_vision_datasets", f"--data_root={data_root}")


def train_command(data_root: str, output_root: str, device: str) -> List[str]:
    splits = f"{data_root}/data_splits"
    return _cli("train_ddpm", f"--output_dir={output_root}", f"--model_name={MODEL}",
                f"--training_ids={splits}/FashionMNIST_train.csv",
                f"--validation_ids={splits}/FashionMNIST_val.csv", "--is_grayscale=1",
                "--n_epochs=300", "--checkpoint_every=300", *SCHEDULE, f"--device={device}")


def reconstruct_command(data_root: str, output_root: str, device: str) -> Optional[List[str]]:
    """The scoring stage on the sets whose results CSV is missing, or None
    when every one exists."""
    splits = f"{data_root}/data_splits"
    ood_dir = REPO / output_root / MODEL / "ood"
    run_val = int(not (ood_dir / "results_val.csv").exists())
    run_in = int(not (ood_dir / "results_in.csv").exists())
    out_ids = ",".join(f"{splits}/{csv}" for csv, result in OUT_SETS
                       if not (ood_dir / f"results_{result}.csv").exists())
    if not (run_val or run_in or out_ids):
        return None
    return _cli("reconstruct", f"--output_dir={output_root}", f"--model_name={MODEL}",
                f"--validation_ids={splits}/FashionMNIST_val.csv",
                f"--in_ids={splits}/FashionMNIST_test.csv", f"--out_ids={out_ids}",
                "--is_grayscale=1", *SCHEDULE, "--num_inference_steps=100",
                "--inference_skip_factor=4", f"--run_val={run_val}", f"--run_in={run_in}",
                f"--run_out={int(bool(out_ids))}", f"--device={device}")


def report_command(output_root: str) -> List[str]:
    return _cli("parity_report", f"--output_dir={output_root}", f"--model_name={MODEL}")


def run(cmd: List[str]) -> None:
    """One stage in a fresh interpreter, from the repository root."""
    subprocess.run(cmd, cwd=REPO, check=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("data_root", nargs="?", default="data")
    ap.add_argument("output_root", nargs="?", default="output")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    data_root, output_root = args.data_root, args.output_root
    splits = REPO / data_root / "data_splits"

    missing = [f for f in SPLITS if not (splits / f"{f}.csv").is_file()]
    if missing:
        run(prep_command(data_root))
    else:
        print("[parity] stage 1 (datasets): already prepared — skipping")
    missing = [f for f in SPLITS if not (splits / f"{f}.csv").is_file()]
    if missing:
        sys.exit(f"missing {splits}/{missing[0]}.csv (no egress and no raw archives?)")

    if (REPO / output_root / MODEL / "checkpoint_300.pth").exists():
        print("[parity] stage 2 (train): checkpoint_300.pth exists — skipping")
    else:
        run(train_command(data_root, output_root, args.device))

    cmd = reconstruct_command(data_root, output_root, args.device)
    if cmd is None:
        print("[parity] stage 3 (reconstruct): all results CSVs exist — skipping")
    else:
        run(cmd)

    run(report_command(output_root))


if __name__ == "__main__":
    main()
