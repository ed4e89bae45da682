"""CROMIS dataset prep (private CT dataset) — structural parity stub.

    python -m ddpm_ood_tpu_torch.data.get_cromis_dataset --data_root=DIR --source_dir=DIR

The port's copy of ``ddpm_ood_tpu/data/get_cromis_dataset.py``:
the same files, from numpy alone.

The reference's src/data/get_cromis_dataset.py is a symlinker over the authors'
private hospital data with hardcoded local paths (mostly commented out) and is
explicitly out of scope for a rebuild (SURVEY.md §2.1 #18). This stub preserves
the CLI surface: given a directory of NIfTI volumes you control, it writes the
same style of single-row split CSVs (80/10/10, seed 0).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .csv_splits import write_split_csv


def prepare_data(data_root: str, source_dir: str) -> None:
    root = Path(data_root)
    src = Path(source_dir)
    files = sorted(str(p) for p in src.glob("**/*.nii*"))
    if not files:
        print(f"No NIfTI volumes found under {src}.")
        return
    rng = np.random.RandomState(0)
    draws = rng.random_sample(len(files))
    splits = {
        "train": [f for f, d in zip(files, draws) if d >= 0.2],
        "val": [f for f, d in zip(files, draws) if d < 0.1],
        "test": [f for f, d in zip(files, draws) if 0.1 <= d < 0.2],
    }
    splits_dir = root / "data_splits"
    splits_dir.mkdir(exist_ok=True, parents=True)
    for split_name, paths in splits.items():
        write_split_csv(paths, str(splits_dir / f"CROMIS_{split_name}.csv"))
    print({k: len(v) for k, v in splits.items()})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--source_dir", type=str, required=True,
                        help="Directory containing the (private) NIfTI volumes.")
    args = parser.parse_args(argv)
    prepare_data(args.data_root, args.source_dir)


if __name__ == "__main__":
    main()
