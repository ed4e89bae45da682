"""CSV split-file reading and writing.

A copy of ``get_data_dicts``, ``write_split_csv`` and
``partition_for_process`` from ``ddpm_ood_tpu/data/csv_splits.py``: the port
imports nothing of the JAX package. Splits are a SINGLE comma-separated row
(the reference reads it with pandas, so the paths become the column header);
the first line is the path list. Under torchrun each process loads its own
partition of a split (``partition_for_process``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def get_data_dicts(
    ids_path: str,
    shuffle: bool = False,
    first_n: Optional[int] = None,
) -> List[Dict[str, str]]:
    with open(ids_path) as f:
        first_line = f.readline().strip()
    paths = [p.strip() for p in first_line.split(",") if p.strip()]
    if shuffle:
        # reference shuffles via pandas sample(random_state=1); deterministic here too
        rng = np.random.default_rng(1)
        paths = [paths[i] for i in rng.permutation(len(paths))]
    data_dicts = [{"image": p} for p in paths]
    if first_n:
        data_dicts = data_dicts[: int(first_n)]
    print(f"Found {len(data_dicts)} subjects.")
    return data_dicts


def write_split_csv(paths: List[str], out_path: str) -> None:
    """Write the single-row comma-separated split format the reference uses
    (src/data/get_computer_vision_datasets.py:89-92)."""
    with open(out_path, "w") as f:
        f.write(",".join(str(p) for p in paths))


def partition_for_process(
    data: List[Dict[str, str]],
    num_partitions: int,
    index: int,
    shuffle: bool = True,
    seed: int = 0,
    even_divisible: bool = True,
) -> List[Dict[str, str]]:
    """Partition `index` of `num_partitions`, as MONAI's partition_dataset
    cuts them: the items shuffled by ``RandomState(seed)``, wrap-padded with
    the leading ones to a multiple of the partition count (so every process
    takes as many steps on equal batches), then cut by ``array_split``."""
    if num_partitions <= 1:
        return data
    indices = np.arange(len(data))
    if shuffle:
        np.random.RandomState(seed).shuffle(indices)
    if even_divisible and len(indices) % num_partitions != 0:
        pad = num_partitions - (len(indices) % num_partitions)
        indices = np.concatenate([indices, indices[:pad]])
    chunks = np.array_split(indices, num_partitions)
    return [data[i] for i in chunks[index]]
