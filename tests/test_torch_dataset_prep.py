"""The port's dataset prep (``ddpm_ood_tpu_torch/data/get_*.py``) against
the JAX package's, on the raw-archive fixtures of ``test_dataset_prep.py``.

Each fixture is built once and copied, so both trees start byte-equal; the
JAX prep runs on one copy and the port's on the other. Every file written
must then be equal bit for bit, and every split CSV equal once its root
prefix is swapped. The negative cases raise the same named errors, and the
port's 95/5 split equals sklearn's ``train_test_split(test_size=0.05,
random_state=42)``. Downloads are stubbed to fail: nothing is fetched.
"""

from __future__ import annotations

import gzip
import importlib
import io
import pickle
import shutil
import struct
import sys
import tarfile
import urllib.request
from pathlib import Path

import numpy as np
import pytest


def _modules(name: str):
    """(JAX module, port module) of one prep script."""
    return (importlib.import_module(f"ddpm_ood_tpu.data.{name}"),
            importlib.import_module(f"ddpm_ood_tpu_torch.data.{name}"))


@pytest.fixture(autouse=True)
def no_downloads(monkeypatch):
    def refuse(url, dest):
        raise OSError(f"downloads are disabled in this test (tried {url})")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def _idx_bytes(images: np.ndarray) -> bytes:
    n, rows, cols = images.shape
    return struct.pack(">IIII", 2051, n, rows, cols) + images.tobytes()


def _idx_gz(path: Path, images: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wb") as f:
        f.write(_idx_bytes(images))


def build_mnist(root: Path, name: str = "MNIST", seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    _idx_gz(root / name / "raw" / "train-images-idx3-ubyte.gz",
            rng.integers(0, 256, size=(40, 28, 28), dtype=np.uint8))
    _idx_gz(root / name / "raw" / "t10k-images-idx3-ubyte.gz",
            rng.integers(0, 256, size=(10, 28, 28), dtype=np.uint8))


def build_fashion_raw(root: Path) -> None:
    """FashionMNIST as pre-decompressed raw IDX files (the other branch)."""
    rng = np.random.default_rng(6)
    raw = root / "FashionMNIST" / "raw"
    raw.mkdir(parents=True)
    (raw / "train-images-idx3-ubyte").write_bytes(
        _idx_bytes(rng.integers(0, 256, size=(48, 28, 28), dtype=np.uint8)))
    (raw / "t10k-images-idx3-ubyte").write_bytes(
        _idx_bytes(rng.integers(0, 256, size=(8, 28, 28), dtype=np.uint8)))


def build_cifar_batches(root: Path) -> None:
    rng = np.random.default_rng(1)
    extracted = root / "CIFAR10" / "raw" / "cifar-10-batches-py"
    extracted.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, size=(4, 3072), dtype=np.uint8)
        with open(extracted / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": [0] * 4}, f)


def build_cifar_tarball(root: Path) -> None:
    rng = np.random.default_rng(7)
    path = root / "CIFAR10" / "raw" / "cifar-10-python.tar.gz"
    path.parent.mkdir(parents=True)
    with tarfile.open(path, "w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            blob = pickle.dumps({b"data": rng.integers(0, 256, size=(2, 3072), dtype=np.uint8),
                                 b"labels": [0, 1]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def build_svhn(root: Path) -> None:
    from scipy.io import savemat

    rng = np.random.default_rng(2)
    raw = root / "SVHN" / "raw"
    raw.mkdir(parents=True)
    savemat(raw / "train_32x32.mat",
            {"X": rng.integers(0, 256, size=(32, 32, 3, 5), dtype=np.uint8),
             "y": np.ones((5, 1))})
    savemat(raw / "test_32x32.mat",
            {"X": rng.integers(0, 256, size=(32, 32, 3, 2), dtype=np.uint8),
             "y": np.ones((2, 1))})


def build_celeba(root: Path) -> None:
    from PIL import Image

    raw = root / "CelebA" / "raw"
    img_dir = raw / "img_align_celeba"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    lines = []
    for i, part in enumerate([0, 0, 1, 2]):  # 2 train, 1 valid, 1 test
        name = f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 256, size=(218, 178, 3), dtype=np.uint8)).save(
            img_dir / name)
        lines.append(f"{name} {part}\n")
    (raw / "list_eval_partition.txt").write_text("".join(lines))


def build_mednist(root: Path) -> None:
    from ddpm_ood_tpu_torch.data.get_mednist_datasets import CLASSES

    src = root.parent / f"{root.name}_stage" / "MedNIST"
    for cls in CLASSES:
        d = src / cls
        d.mkdir(parents=True)
        for i in range(30):
            (d / f"{i:06d}.jpeg").write_bytes(b"\xff\xd8fake")
    root.mkdir(parents=True)
    with tarfile.open(root / "MedNIST.tar.gz", "w:gz") as tf:
        tf.add(src, arcname="MedNIST")
    shutil.rmtree(src.parent)


def build_decathlon(root: Path) -> None:
    from ddpm_ood_tpu_torch.data.nifti import save_nifti

    images = root / "Task09_Spleen" / "imagesTr"
    images.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(25):
        save_nifti(str(images / f"spleen_{i}.nii.gz"),
                   rng.uniform(size=(4, 4, 4)).astype(np.float32))
    (images / "._spleen_0.nii.gz").write_bytes(b"junk")  # macOS resource fork


def build_medmnist3d(root: Path) -> None:
    rng = np.random.default_rng(5)
    arrays = {}
    for split, n in (("train", 6), ("val", 2), ("test", 2)):
        arrays[f"{split}_images"] = rng.integers(0, 256, size=(n, 28, 28, 28), dtype=np.uint8)
        arrays[f"{split}_labels"] = np.zeros((n, 1))
    root.mkdir(parents=True)
    np.savez(root / "organmnist3d.npz", **arrays)


def build_cromis(root: Path) -> None:
    """A source tree of NIfTI volumes, nested and flat, .nii and .nii.gz."""
    from ddpm_ood_tpu_torch.data.nifti import save_nifti

    rng = np.random.default_rng(8)
    for i in range(23):
        sub = root / "cromis_src" / f"site{i % 3}"
        sub.mkdir(parents=True, exist_ok=True)
        ext = ".nii.gz" if i % 2 else ".nii"
        save_nifti(str(sub / f"ct_{i}{ext}"), rng.uniform(size=(4, 4, 4)).astype(np.float32))


def build_all_archives(root: Path) -> None:
    """Every computer-vision dataset at once, for the CLI's main()."""
    build_mnist(root)
    build_fashion_raw(root)
    build_cifar_tarball(root)
    build_svhn(root)
    build_celeba(root)


def _cv(fn_names):
    def run(mod, root: Path):
        for name, *args in fn_names:
            getattr(mod, name)(root, *args)
    return run


CASES = {
    # fixture -> (prep script, its build function, run(mod, root))
    "mnist_idx": ("get_computer_vision_datasets", build_mnist,
                  _cv([("prep_mnist_like", "MNIST"), ("create_train_test_splits",)])),
    "cifar_pickle": ("get_computer_vision_datasets", build_cifar_batches,
                     _cv([("prep_cifar10",), ("create_train_test_splits",)])),
    "svhn_mat": ("get_computer_vision_datasets", build_svhn,
                 _cv([("prep_svhn",), ("create_train_test_splits",)])),
    "celeba": ("get_computer_vision_datasets", build_celeba,
               _cv([("prep_celeba",), ("create_train_test_splits",)])),
    "cv_main_all_archives": ("get_computer_vision_datasets", build_all_archives,
                             lambda mod, root: mod.main(["--data_root", str(root)])),
    "mednist": ("get_mednist_datasets", build_mednist,
                lambda mod, root: mod.main(["--data_root", str(root)])),
    "decathlon": ("get_decathlon_datasets", build_decathlon,
                  lambda mod, root: mod.main(["--data_root", str(root), "--tasks", "Task09"])),
    "medmnist3d": ("get_3dmedmnist", build_medmnist3d,
                   lambda mod, root: mod.main(["--data_root", str(root),
                                               "--tasks", "organmnist3d"])),
    "cromis": ("get_cromis_dataset", build_cromis,
               lambda mod, root: mod.main(["--data_root", str(root),
                                           "--source_dir", str(root / "cromis_src")])),
}


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", list(CASES))
def test_port_prep_writes_the_jax_files(case, tmp_path):
    script, build, run = CASES[case]
    jax_mod, port_mod = _modules(script)
    build(tmp_path / "src")
    roots = {}
    for side, mod in (("jax", jax_mod), ("port", port_mod)):
        roots[side] = tmp_path / side
        shutil.copytree(tmp_path / "src", roots[side])
        run(mod, roots[side])
    jax_tree, port_tree = _tree(roots["jax"]), _tree(roots["port"])
    assert sorted(port_tree) == sorted(jax_tree)
    new = [f for f in jax_tree if not (tmp_path / "src" / f).exists()]
    npys = [f for f in new if f.endswith(".npy")]
    csvs = [f for f in new if f.startswith("data_splits/")]
    assert csvs and (npys or case in ("mednist", "decathlon", "cromis")), new
    for f in new:
        want = jax_tree[f].read_bytes()
        if f in csvs:
            want = want.replace(str(roots["jax"]).encode(), str(roots["port"]).encode())
        assert port_tree[f].read_bytes() == want, f
    # every split row names files that exist, each in one split only
    for prefix in {f.rsplit("_", 1)[0] for f in csvs}:
        rows = [port_tree[f].read_text().split(",") for f in csvs
                if f.rsplit("_", 1)[0] == prefix]
        paths = [p for row in rows for p in row if p]
        assert all(Path(p).exists() for p in paths)
        assert len(paths) == len(set(paths)), prefix


@pytest.mark.parametrize("n", [0, 1, 2, 3, 19, 20, 21, 40, 48, 1000, 60000])
def test_train_val_split_equals_sklearn(n):
    from ddpm_ood_tpu_torch.data.get_computer_vision_datasets import train_val_split

    train_test_split = pytest.importorskip("sklearn.model_selection").train_test_split
    items = [f"img_{i}.npy" for i in range(n)]
    if n < 2:  # the training part would be empty
        with pytest.raises(ValueError) as want:
            train_test_split(items, test_size=0.05, random_state=42)
        with pytest.raises(ValueError) as got:
            train_val_split(items)
        assert str(got.value) == str(want.value)
        return
    assert list(train_val_split(items)) == train_test_split(items, test_size=0.05,
                                                            random_state=42)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 25])
def test_seed0_splits_equal_jax_at_the_edges(n):
    """The MONAI-style seed-0 per-item draws (MedNIST, Decathlon, CROMIS) at
    the sizes where a split comes out empty or single."""
    jax_mednist, port_mednist = _modules("get_mednist_datasets")
    jax_dec, port_dec = _modules("get_decathlon_datasets")
    files = [f"v{i}" for i in range(n)]
    np.testing.assert_array_equal(port_mednist._monai_style_split(n),
                                  jax_mednist._monai_style_split(n))
    assert port_dec._split(files) == jax_dec._split(files)


def _write(path: Path, data: bytes) -> Path:
    path.write_bytes(data)
    return path


def _imgs(n: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, 256, size=(n, 28, 28), dtype=np.uint8)


IDX_ERRORS = {
    # name -> (file name, its bytes, the exception type)
    "truncated_payload": ("train-images-idx3-ubyte",
                          _idx_bytes(_imgs(10))[: 16 + 5 * 28 * 28 + 100], ValueError),
    "truncated_header": ("train-images-idx3-ubyte", b"\x00\x00\x08", ValueError),
    "bad_magic": ("t10k-images-idx3-ubyte",
                  struct.pack(">IIII", 2049, 1, 28, 28) + b"\x00" * 784, ValueError),
    "raw_bytes_named_gz": ("not-actually.gz", _idx_bytes(_imgs(4)), gzip.BadGzipFile),
}


@pytest.mark.parametrize("case", list(IDX_ERRORS))
def test_idx_reader_raises_the_jax_errors(case, tmp_path):
    name, data, exc = IDX_ERRORS[case]
    messages = []
    for side, mod in zip(("jax", "port"), _modules("get_computer_vision_datasets")):
        (tmp_path / side).mkdir()
        path = _write(tmp_path / side / name, data)
        with pytest.raises(exc) as info:
            mod._read_idx_images(path)
        messages.append(str(info.value).replace(str(tmp_path / side), "<dir>"))
    assert messages[0] == messages[1]
    if exc is ValueError:
        assert messages[1].startswith(("truncated IDX file", "truncated IDX header",
                                       "bad IDX magic 2049"))


def test_idx_raw_equals_gzipped(tmp_path):
    jax_mod, port_mod = _modules("get_computer_vision_datasets")
    imgs = _imgs(4)
    raw = _write(tmp_path / "train-images-idx3-ubyte", _idx_bytes(imgs))
    gz = tmp_path / "imgs.gz"
    with gzip.open(gz, "wb") as f:
        f.write(_idx_bytes(imgs))
    for path in (raw, gz):
        got = port_mod._read_idx_images(path)
        np.testing.assert_array_equal(got, jax_mod._read_idx_images(path))
        np.testing.assert_array_equal(got, imgs)


def test_cifar_truncated_pickle_raises_as_jax(tmp_path):
    payload = pickle.dumps({b"data": np.zeros((2, 3072), np.uint8)}, protocol=2)
    errors = []
    for side, mod in zip(("jax", "port"), _modules("get_computer_vision_datasets")):
        extracted = tmp_path / side / "CIFAR10" / "raw" / "cifar-10-batches-py"
        extracted.mkdir(parents=True)
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            (extracted / name).write_bytes(payload[: len(payload) // 2])
        with pytest.raises((pickle.UnpicklingError, EOFError)) as info:
            mod.prep_cifar10(tmp_path / side)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_celeba_without_pillow(tmp_path, monkeypatch):
    """With Pillow missing, CelebA alone fails, by name, and only once its raw
    files are there: the other datasets prepare on such a host."""
    from ddpm_ood_tpu_torch.data import get_computer_vision_datasets as prep

    build_mnist(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    prep.main(["--data_root", str(tmp_path)])  # no CelebA raw: skipped
    assert (tmp_path / "data_splits" / "MNIST_train.csv").is_file()
    assert not (tmp_path / "data_splits" / "CelebA_train.csv").exists()
    (tmp_path / "CelebA" / "raw" / "img_align_celeba").mkdir(parents=True)
    (tmp_path / "CelebA" / "raw" / "list_eval_partition.txt").write_text("000000.jpg 0\n")
    with pytest.raises(ModuleNotFoundError, match="prep_celeba needs Pillow"):
        prep.prep_celeba(tmp_path)
