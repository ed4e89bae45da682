"""Medical Segmentation Decathlon prep: per-task per-split NIfTI path CSVs.

    python -m ddpm_ood_tpu_torch.data.get_decathlon_datasets --data_root=DIR [--tasks=Task01,Task02]

The port's copy of ``ddpm_ood_tpu/data/get_decathlon_datasets.py``:
the same files, from numpy alone.

Capability parity with reference src/data/get_decathlon_datasets.py (which drives
monai.apps.DecathlonDataset): download/extract the requested MSD tasks and write
`<data_root>/data_splits/Decathlon_Task<NN>_<split>.csv` single-row CSVs of image
paths, reproducing MONAI's deterministic split of the `training` section
(seed 0: 20% val+test carved per-item like MedNIST).

Offline: place the extracted `Task<NN>_<Name>/imagesTr` folders (or the
`.tar` archives) under <data_root>.
"""

from __future__ import annotations

import argparse
import tarfile
import urllib.request
from pathlib import Path

import numpy as np

from .csv_splits import write_split_csv

TASKS = {
    "Task01_BrainTumour": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task01_BrainTumour.tar",
    "Task02_Heart": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task02_Heart.tar",
    "Task03_Liver": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task03_Liver.tar",
    "Task04_Hippocampus": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task04_Hippocampus.tar",
    "Task05_Prostate": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task05_Prostate.tar",
    "Task06_Lung": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task06_Lung.tar",
    "Task07_Pancreas": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task07_Pancreas.tar",
    "Task08_HepaticVessel": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task08_HepaticVessel.tar",
    "Task09_Spleen": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task09_Spleen.tar",
    "Task10_Colon": "https://msd-for-monai.s3-us-west-2.amazonaws.com/Task10_Colon.tar",
}


def _split(files, seed: int = 0):
    rng = np.random.RandomState(seed)
    draws = rng.random_sample(len(files))
    return {
        "train": [f for f, d in zip(files, draws) if d >= 0.2],
        "val": [f for f, d in zip(files, draws) if d < 0.1],
        "test": [f for f, d in zip(files, draws) if 0.1 <= d < 0.2],
    }


def download_data(data_root: str, tasks=None) -> None:
    root = Path(data_root)
    splits_dir = root / "data_splits"
    splits_dir.mkdir(exist_ok=True, parents=True)
    for task, url in TASKS.items():
        if tasks and task not in tasks and task.split("_")[0] not in tasks:
            continue
        task_dir = root / task
        if not task_dir.exists():
            archive = root / f"{task}.tar"
            if not archive.exists():
                try:
                    print(f"Downloading {url} ...")
                    urllib.request.urlretrieve(url, archive)
                except Exception as e:
                    print(f"  {task}: download failed ({e}); place the archive or "
                          f"extracted folder under {root}. Skipping.")
                    continue
            with tarfile.open(archive) as tf:
                tf.extractall(root, filter="data")
        images = sorted(
            str(p) for p in (task_dir / "imagesTr").glob("*.nii.gz")
            if not p.name.startswith("._")
        )
        if not images:
            print(f"{task}: no images found, skipping")
            continue
        task_short = task.split("_")[0]
        for split_name, paths in _split(images).items():
            write_split_csv(
                paths, str(splits_dir / f"Decathlon_{task_short}_{split_name}.csv")
            )
        print(f"{task}: {len(images)} volumes")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument(
        "--tasks", default=None,
        help="Comma-separated task subset (e.g. Task01,Task02); default all 10.",
    )
    args = parser.parse_args(argv)
    tasks = args.tasks.split(",") if args.tasks else None
    download_data(args.data_root, tasks)


if __name__ == "__main__":
    main()
