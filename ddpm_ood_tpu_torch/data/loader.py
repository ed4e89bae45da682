"""Host-side loaders: split CSV -> transformed images -> batches.

Port of ``ddpm_ood_tpu/data/loader.py`` on the port's own copies of
``csv_splits.get_data_dicts`` (the single-row split CSV) and
``transforms.TransformChain`` (load, crop, resize, min-max scale, fixed
flips), so both packages see identical inputs. The JAX package's native C++
cache fill is not carried over: items are transformed by a thread pool.

``DataLoader`` yields {"image": (B, C, *spatial) float32, "filename": [str]}
in split order, or shuffled with ``np.random.default_rng(seed + epoch)`` for
training, optionally without the ragged last batch, with the next batch
assembled on a thread while the caller works on the current one. Under
torchrun (``num_processes`` > 1) a loader holds its process's partition of
the split (``partition_for_process``), cut before any item is transformed.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .csv_splits import get_data_dicts, partition_for_process
from .transforms import TransformChain


class DataLoader:
    """Batches of one split, or of process `process_index`'s partition of
    it. With ``cache`` every item is transformed once, when the loader is
    built; without it, at every epoch."""

    def __init__(self, ids_path: str, batch_size: int, transform: TransformChain,
                 first_n: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 1,
                 cache: bool = True, prefetch: bool = False, num_processes: int = 1,
                 process_index: int = 0):
        dicts = get_data_dicts(ids_path, shuffle=False, first_n=first_n)
        if num_processes > 1:
            dicts = partition_for_process(dicts, num_processes, process_index)
        self.filenames: List[str] = [d["image"] for d in dicts]
        self.batch_size = int(batch_size)
        self.transform = transform
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, int(seed)
        self.prefetch = prefetch
        self.epoch = 0
        self.items: Optional[List[np.ndarray]] = None
        if cache and self.filenames:
            workers = max(1, min(int(num_workers), len(self.filenames)))
            with cf.ThreadPoolExecutor(workers) as pool:
                self.items = list(pool.map(transform, self.filenames))

    def __len__(self) -> int:
        n = len(self.filenames)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> List[np.ndarray]:
        idx = np.arange(len(self.filenames))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [idx[i * self.batch_size: (i + 1) * self.batch_size] for i in range(len(self))]

    def _assemble(self, indices: np.ndarray) -> Dict:
        names = [self.filenames[int(i)] for i in indices]
        images = ([self.items[int(i)] for i in indices] if self.items is not None
                  else [self.transform(f) for f in names])
        return {"image": np.stack(images).astype(np.float32), "filename": names}

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batch_indices()
        self.epoch += 1
        if not self.prefetch:
            for b in batches:
                yield self._assemble(b)
            return
        with cf.ThreadPoolExecutor(1, thread_name_prefix="loader-prefetch") as pool:
            future = pool.submit(self._assemble, batches[0]) if batches else None
            for i in range(len(batches)):
                current = future.result()
                future = pool.submit(self._assemble, batches[i + 1]) if i + 1 < len(batches) else None
                yield current


def get_training_data_loader(
    batch_size: int,
    training_ids: str,
    validation_ids: str,
    augmentation: bool = True,
    drop_last: bool = False,
    num_workers: int = 8,
    num_val_workers: int = 3,
    cache_data: bool = True,
    is_grayscale: bool = False,
    image_size: Optional[int] = None,
    image_roi: Optional[Sequence[int]] = None,
    spatial_dimension: int = 2,
    num_processes: int = 1,
    process_index: int = 0,
    seed: int = 0,
):
    """(train_loader, val_loader), as ``ddpm_ood_tpu/data/loader.py``'s
    factory builds them: the training split shuffled per epoch with
    prefetch, the validation split in order, each the partition of process
    `process_index` of `num_processes`."""
    del augmentation  # a documented no-op in the reference, as in the JAX package
    transform = TransformChain(spatial_dimension=spatial_dimension, is_grayscale=is_grayscale,
                               image_size=image_size, image_roi=image_roi)
    part = dict(num_processes=num_processes, process_index=process_index)
    val_loader = DataLoader(validation_ids, batch_size, transform, drop_last=drop_last,
                            num_workers=num_val_workers, cache=cache_data, **part)
    train_loader = DataLoader(training_ids, batch_size, transform, shuffle=True,
                              drop_last=drop_last, seed=seed, num_workers=num_workers,
                              cache=cache_data, prefetch=True, **part)
    return train_loader, val_loader
