"""3D MedMNIST prep: per-volume `.npy` + split CSVs.

    python -m ddpm_ood_tpu_torch.data.get_3dmedmnist --data_root=DIR [--tasks=organmnist3d,...]

The port's copy of ``ddpm_ood_tpu/data/get_3dmedmnist.py``:
the same files, from numpy alone.

Capability parity with reference src/data/get_3dmedmnist.py (which drives the
`medmnist` package): for each of the six 3D MedMNIST tasks, load the `.npz`
archive (downloaded from Zenodo when egress allows, else pre-placed under
<data_root>), save each volume as `<data_root>/<task>/numpy/<split>/<task>_<i>.npy`
(uint8, (28, 28, 28)) and write single-row split CSVs to
`<data_root>/data_splits/<task>3d_{train,val,test}.csv`.
"""

from __future__ import annotations

import argparse
import urllib.request
from pathlib import Path

import numpy as np

from .csv_splits import write_split_csv

TASKS = (
    "organmnist3d", "nodulemnist3d", "adrenalmnist3d",
    "fracturemnist3d", "vesselmnist3d", "synapsemnist3d",
)
ZENODO = "https://zenodo.org/records/10519652/files/{}.npz?download=1"


def download_data(data_root: str, tasks=None) -> None:
    root = Path(data_root)
    splits_dir = root / "data_splits"
    splits_dir.mkdir(exist_ok=True, parents=True)
    for task in tasks or TASKS:
        npz_path = root / f"{task}.npz"
        if not npz_path.exists():
            try:
                print(f"Downloading {task} ...")
                root.mkdir(parents=True, exist_ok=True)
                urllib.request.urlretrieve(ZENODO.format(task), npz_path)
            except Exception as e:
                print(f"  {task}: download failed ({e}); place {task}.npz under "
                      f"{root}. Skipping.")
                continue
        data = np.load(npz_path)
        for split in ("train", "val", "test"):
            images = data[f"{split}_images"]  # (N, 28, 28, 28)
            out_dir = root / task / "numpy" / split
            out_dir.mkdir(parents=True, exist_ok=True)
            paths = []
            for i in range(len(images)):
                p = out_dir / f"{task}_{i}.npy"
                np.save(p, images[i].astype(np.uint8))
                paths.append(str(p))
            write_split_csv(paths, str(splits_dir / f"{task}_{split}.csv"))
        print(f"{task}: done")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--tasks", default=None,
                        help="Comma-separated subset of the six 3D tasks.")
    args = parser.parse_args(argv)
    tasks = args.tasks.split(",") if args.tasks else None
    download_data(args.data_root, tasks)


if __name__ == "__main__":
    main()
