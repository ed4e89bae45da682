"""Computer-vision dataset prep: MNIST / FashionMNIST / CIFAR10 / SVHN / CelebA.

    python -m ddpm_ood_tpu_torch.data.get_computer_vision_datasets --data_root=DIR

The port's copy of ``ddpm_ood_tpu/data/get_computer_vision_datasets.py``
(reference src/data/get_computer_vision_datasets.py): every image is saved as
a channel-first `.npy` under
`<data_root>/<Dataset>/numpy/<split>/<Dataset>_<i>.npy` (CelebA resized
32x32), and single-row comma-separated split CSVs go to
`<data_root>/data_splits/` (`<Dataset>_{train,val,test}.csv`; a 95/5
train/val split, seed 42 — reference :95-117). The files are the JAX
module's, byte for byte.

The raw archives are parsed directly with numpy/scipy (and Pillow for
CelebA alone):
  - MNIST/FashionMNIST: IDX ubyte format (optionally gzipped),
  - CIFAR-10: the python pickle batches,
  - SVHN: the cropped-digits .mat files (scipy.io.loadmat),
  - CelebA: img_align_celeba JPEG folder + list_eval_partition.txt.
A missing archive is downloaded with urllib; place pre-downloaded archives
under `<data_root>/<Dataset>/raw/` to run fully offline.

Differences from the JAX module, for hosts without sklearn or Pillow:
  - the 95/5 split is ``train_val_split``, numpy's equal of sklearn's
    ``train_test_split(test_size=0.05, random_state=42)``;
  - ``prep_celeba`` imports Pillow only once it has found CelebA's raw
    files, and raises a ModuleNotFoundError naming Pillow when it is
    missing, so the other datasets prepare on a host without it.
"""

from __future__ import annotations

import argparse
import gzip
import math
import pickle
import struct
import tarfile
import urllib.request
from pathlib import Path

import numpy as np

from .csv_splits import write_split_csv

URLS = {
    "MNIST": [
        ("https://ossci-datasets.s3.amazonaws.com/mnist/train-images-idx3-ubyte.gz",
         "train-images-idx3-ubyte.gz"),
        ("https://ossci-datasets.s3.amazonaws.com/mnist/t10k-images-idx3-ubyte.gz",
         "t10k-images-idx3-ubyte.gz"),
    ],
    "FashionMNIST": [
        ("http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/train-images-idx3-ubyte.gz",
         "train-images-idx3-ubyte.gz"),
        ("http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/t10k-images-idx3-ubyte.gz",
         "t10k-images-idx3-ubyte.gz"),
    ],
    "CIFAR10": [
        ("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
         "cifar-10-python.tar.gz"),
    ],
    "SVHN": [
        ("http://ufldl.stanford.edu/housenumbers/train_32x32.mat", "train_32x32.mat"),
        ("http://ufldl.stanford.edu/housenumbers/test_32x32.mat", "test_32x32.mat"),
    ],
}


def _fetch(url: str, dest: Path) -> bool:
    if dest.exists():
        return True
    dest.parent.mkdir(parents=True, exist_ok=True)
    try:
        print(f"Downloading {url} ...")
        urllib.request.urlretrieve(url, dest)
        return True
    except Exception as e:  # no egress / mirror down: proceed with what exists
        print(f"  download failed ({e}); place the file at {dest} manually.")
        return False


def _read_idx_images(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        header = f.read(16)
        if len(header) != 16:
            raise ValueError(f"truncated IDX header in {path}")
        magic, n, rows, cols = struct.unpack(">IIII", header)
        if magic != 2051:
            raise ValueError(f"bad IDX magic {magic} in {path}")
        data = f.read(n * rows * cols)
        if len(data) != n * rows * cols:
            raise ValueError(
                f"truncated IDX file {path}: header promises {n}x{rows}x{cols}"
                f" = {n * rows * cols} bytes, got {len(data)}"
            )
    return np.frombuffer(data, dtype=np.uint8).reshape(n, rows, cols)


def _save_set(images: np.ndarray, out_dir: Path, dataset_name: str) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(images)):
        np.save(out_dir / f"{dataset_name}_{i}.npy", images[i])


def prep_mnist_like(data_root: Path, name: str) -> None:
    raw = data_root / name / "raw"
    for url, fname in URLS[name]:
        _fetch(url, raw / fname)
    files = {"train": "train-images-idx3-ubyte", "test": "t10k-images-idx3-ubyte"}
    for split, stem in files.items():
        src = raw / f"{stem}.gz"
        if not src.exists():
            src = raw / stem
        if not src.exists():
            print(f"{name}/{split}: raw file missing, skipping")
            continue
        images = _read_idx_images(src)  # (N, 28, 28) uint8, saved 2D like PIL->np
        _save_set(images, data_root / name / "numpy" / split, name)


def prep_cifar10(data_root: Path) -> None:
    raw = data_root / "CIFAR10" / "raw"
    url, fname = URLS["CIFAR10"][0]
    archive = raw / fname
    _fetch(url, archive)
    extracted = raw / "cifar-10-batches-py"
    if archive.exists() and not extracted.exists():
        with tarfile.open(archive) as tf:
            tf.extractall(raw, filter="data")
    if not extracted.exists():
        print("CIFAR10: raw batches missing, skipping")
        return
    for split, names in {
        "train": [f"data_batch_{i}" for i in range(1, 6)],
        "test": ["test_batch"],
    }.items():
        chunks = []
        for n in names:
            with open(extracted / n, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            chunks.append(np.asarray(batch[b"data"], dtype=np.uint8))
        data = np.concatenate(chunks).reshape(-1, 3, 32, 32)  # already CHW
        _save_set(data, data_root / "CIFAR10" / "numpy" / split, "CIFAR10")


def prep_svhn(data_root: Path) -> None:
    from scipy.io import loadmat

    raw = data_root / "SVHN" / "raw"
    for url, fname in URLS["SVHN"]:
        _fetch(url, raw / fname)
    for split, fname in {"train": "train_32x32.mat", "test": "test_32x32.mat"}.items():
        src = raw / fname
        if not src.exists():
            print(f"SVHN/{split}: raw file missing, skipping")
            continue
        mat = loadmat(src)
        # (32, 32, 3, N) -> (N, 3, 32, 32)
        data = np.transpose(mat["X"], (3, 2, 0, 1)).astype(np.uint8)
        _save_set(data, data_root / "SVHN" / "numpy" / split, "SVHN")


def prep_celeba(data_root: Path) -> None:
    """CelebA cannot be auto-downloaded without gdrive auth (same caveat as
    torchvision); expects `img_align_celeba/` + `list_eval_partition.txt` under
    <data_root>/CelebA/raw. Images are resized to 32x32 (reference :84)."""
    raw = data_root / "CelebA" / "raw"
    img_dir = raw / "img_align_celeba"
    partition = raw / "list_eval_partition.txt"
    if not img_dir.exists() or not partition.exists():
        print("CelebA: raw images/partition missing, skipping "
              f"(expected {img_dir} and {partition})")
        return
    try:
        from PIL import Image
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "prep_celeba needs Pillow to decode CelebA's JPEGs; install it or "
            f"remove {raw}", name="PIL") from e
    split_names = {0: "train", 1: "valid", 2: "test"}
    counters = {v: 0 for v in split_names.values()}
    with open(partition) as f:
        for line in f:
            fname, part = line.split()
            split = split_names[int(part)]
            out_dir = data_root / "CelebA" / "numpy" / split
            out_dir.mkdir(parents=True, exist_ok=True)
            img = Image.open(img_dir / fname).resize((32, 32))
            arr = np.asarray(img, dtype=np.uint8).transpose(2, 0, 1)
            np.save(out_dir / f"CelebA_{counters[split]}.npy", arr)
            counters[split] += 1


def train_val_split(items: list):
    """(train, val) lists: sklearn's ``train_test_split(items,
    test_size=0.05, random_state=42)`` without sklearn. Its ShuffleSplit
    takes ceil(0.05 * n) items for the held-out part from the front of
    ``RandomState(42).permutation(n)`` and the rest for training, in
    permutation order; an empty training part raises sklearn's ValueError."""
    n = len(items)
    n_val = math.ceil(0.05 * n)
    if n - n_val <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size=0.05 and train_size=None, the resulting train "
            "set will be empty. Adjust any of the aforementioned parameters.")
    perm = np.random.RandomState(42).permutation(n)
    return [items[i] for i in perm[n_val:]], [items[i] for i in perm[:n_val]]


def create_train_test_splits(data_root: Path) -> None:
    """95/5 train/val from the train set (seed 42), test passthrough
    (reference :95-117)."""
    splits_dir = data_root / "data_splits"
    splits_dir.mkdir(exist_ok=True, parents=True)

    for dataset in ["FashionMNIST", "MNIST", "CIFAR10", "SVHN"]:
        numpy_root = data_root / dataset / "numpy"
        if not (numpy_root / "train").exists():
            continue
        train_and_val = sorted(str(p) for p in (numpy_root / "train").glob("*.npy"))
        train_list, val_list = train_val_split(train_and_val)
        test_list = sorted(str(p) for p in (numpy_root / "test").glob("*.npy"))
        for split_name, split in (
            ("train", train_list), ("val", val_list), ("test", test_list)
        ):
            write_split_csv(split, str(splits_dir / f"{dataset}_{split_name}.csv"))

    numpy_root = data_root / "CelebA" / "numpy"
    if (numpy_root / "train").exists():
        for split_name, sub in (("train", "train"), ("val", "valid"), ("test", "test")):
            split = sorted(str(p) for p in (numpy_root / sub).glob("*.npy"))
            write_split_csv(split, str(splits_dir / f"CelebA_{split_name}.csv"))


def download_data(data_root: str) -> None:
    root = Path(data_root)
    prep_mnist_like(root, "MNIST")
    prep_mnist_like(root, "FashionMNIST")
    prep_cifar10(root)
    prep_svhn(root)
    prep_celeba(root)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, required=True,
                        help="Directory data will be stored.")
    args = parser.parse_args(argv)
    download_data(args.data_root)
    create_train_test_splits(Path(args.data_root))


if __name__ == "__main__":
    main()
