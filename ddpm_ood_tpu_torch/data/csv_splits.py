"""CSV split-file reading and writing.

A copy of ``get_data_dicts`` and ``write_split_csv`` from
``ddpm_ood_tpu/data/csv_splits.py``: the port imports nothing of the JAX
package. Splits are a SINGLE comma-separated row (the reference reads it with
pandas, so the paths become the column header); the first line is the path
list. The port runs one process, so the per-process partitioning is not
carried over.
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
