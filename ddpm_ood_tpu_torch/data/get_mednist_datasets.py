"""MedNIST dataset prep: per-class split CSVs.

    python -m ddpm_ood_tpu_torch.data.get_mednist_datasets --data_root=DIR

The port's copy of ``ddpm_ood_tpu/data/get_mednist_datasets.py``:
the same files, from numpy alone.

Capability parity with reference src/data/get_mednist_datasets.py (which drives
monai.apps.MedNISTDataset): download + extract the MedNIST archive, reproduce
MONAI's deterministic split (seed 0: 10% val, 10% test via per-item random
draws), and write one single-row CSV per (class, split) to
`<data_root>/data_splits/<Class>_{train,val,test}.csv` — the names the OOD
registry expects (reference ood_detection.py:92-120).

Offline: place `MedNIST.tar.gz` (or the extracted `MedNIST/` folder with
AbdomenCT/BreastMRI/ChestCT/CXR/Hand/HeadCT subfolders) under <data_root>.
"""

from __future__ import annotations

import argparse
import tarfile
import urllib.request
from pathlib import Path

import numpy as np

from .csv_splits import write_split_csv

URL = (
    "https://github.com/Project-MONAI/MONAI-extra-test-data/releases/download/"
    "0.8.1/MedNIST.tar.gz"
)
CLASSES = ("AbdomenCT", "BreastMRI", "CXR", "ChestCT", "Hand", "HeadCT")


def _monai_style_split(n: int, seed: int = 0):
    """MONAI MedNISTDataset: per-item uniform draw; <0.1 val, <0.2 test, else
    train (monai.apps.datasets semantics with val_frac=test_frac=0.1)."""
    rng = np.random.RandomState(seed)
    draws = rng.random_sample(n)
    return draws


def download_data(data_root: str) -> None:
    root = Path(data_root)
    mednist = root / "MedNIST"
    archive = root / "MedNIST.tar.gz"
    if not mednist.exists():
        if not archive.exists():
            try:
                print(f"Downloading {URL} ...")
                root.mkdir(parents=True, exist_ok=True)
                urllib.request.urlretrieve(URL, archive)
            except Exception as e:
                print(f"  download failed ({e}); place MedNIST.tar.gz or the "
                      f"extracted MedNIST/ under {root}.")
                return
        with tarfile.open(archive) as tf:
            tf.extractall(root, filter="data")

    splits_dir = root / "data_splits"
    splits_dir.mkdir(exist_ok=True, parents=True)
    for cls in CLASSES:
        cls_dir = mednist / cls
        if not cls_dir.exists():
            print(f"{cls}: missing under {mednist}, skipping")
            continue
        files = sorted(str(p) for p in cls_dir.glob("*"))
        draws = _monai_style_split(len(files))
        splits = {
            "train": [f for f, d in zip(files, draws) if d >= 0.2],
            "val": [f for f, d in zip(files, draws) if d < 0.1],
            "test": [f for f, d in zip(files, draws) if 0.1 <= d < 0.2],
        }
        for split_name, paths in splits.items():
            write_split_csv(paths, str(splits_dir / f"{cls}_{split_name}.csv"))
        print(f"{cls}: {len(splits['train'])}/{len(splits['val'])}/{len(splits['test'])}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True,
                        help="Directory data will be stored.")
    args = parser.parse_args(argv)
    download_data(args.data_root)


if __name__ == "__main__":
    main()
