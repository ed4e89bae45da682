"""Training logs without TensorBoard.

Stands in for ``ddpm_ood_tpu/utils/logging.py``'s tensorboardX ``Logger``,
which the GPU host cannot import (it has neither tensorboardX, tensorboard nor
matplotlib). Each log directory (``<run>/train``, ``<run>/val``) gets a
``scalars.jsonl`` with one {"tag", "value", "step", "wall_time"} object per
line, and each figure is saved as ``<tag>_<step>.npy`` beside it: the
validation sample grid is a (num, *spatial, C) float32 array in [0, 1].
Under torchrun rank 0 logs and the other ranks' loggers write nothing: the
logged values are means over all processes. Nothing here imports a package
the host lacks.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from typing import Optional

import numpy as np


class Logger:
    def __init__(self, log_dir: str | Path, enabled: bool = True):
        self.log_dir = Path(log_dir)
        self.enabled = enabled
        self._fh = None

    def _file(self):
        if self._fh is None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.log_dir / "scalars.jsonl", "a")
        return self._fh

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        rec = {"tag": tag, "value": float(value), "step": int(step), "wall_time": time.time()}
        self._file().write(json.dumps(rec) + "\n")

    def add_figure(self, tag: str, images: np.ndarray, step: int) -> Optional[Path]:
        """The figure's path, or None from a logger that writes nothing."""
        if not self.enabled:
            return None
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / f"{tag}_{int(step)}.npy"
        np.save(path, np.asarray(images, dtype=np.float32))
        return path

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
