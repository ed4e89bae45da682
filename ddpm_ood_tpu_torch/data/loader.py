"""Evaluation-set loader: split CSV -> transformed images -> batches.

Built on the JAX package's two JAX-free data modules,
``ddpm_ood_tpu.data.csv_splits.get_data_dicts`` (the single-row split CSV) and
``ddpm_ood_tpu.data.transforms.TransformChain`` (load, crop, resize, min-max
scale, fixed flips), so both packages see identical inputs. It does not use
the JAX package's ``CachedDataset``/``DataLoader``: their native fast path
imports JAX at first use.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional

import numpy as np

from ddpm_ood_tpu.data.csv_splits import get_data_dicts
from ddpm_ood_tpu.data.transforms import TransformChain


class EvalLoader:
    """Yields {"image": (B, C, *spatial) float32, "filename": [str]} in split
    order. Every item is transformed once, when the loader is built."""

    def __init__(self, ids_path: str, batch_size: int, transform: TransformChain,
                 first_n: Optional[int] = None, drop_last: bool = False,
                 num_workers: int = 1):
        self.filenames: List[str] = [d["image"] for d in
                                     get_data_dicts(ids_path, shuffle=False, first_n=first_n)]
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        workers = max(1, min(int(num_workers), len(self.filenames) or 1))
        with cf.ThreadPoolExecutor(workers) as pool:
            self.items = list(pool.map(transform, self.filenames))

    def __len__(self) -> int:
        n = len(self.filenames)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
            yield {"image": np.stack(self.items[sl]).astype(np.float32),
                   "filename": self.filenames[sl]}

