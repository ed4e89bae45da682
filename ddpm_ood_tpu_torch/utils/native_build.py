"""Build and load the port's host C++ library (``csrc/opensimplex.cpp``).

The source is compiled by ``g++ -O3 -fopenmp`` into ``ddpm_ood_tpu_torch/_build/``
the first time it is used, and again when the source is newer than the
library. The build writes a temporary file and renames it into place, so a
process that loads the library never sees a half-written one. A failed build
raises ``NativeBuildError`` carrying the compiler's stderr: the port has no
silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

COMPILER = "g++"
FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing, or refused the source (message holds its stderr)."""


def build_and_load(src: Path, lib_path: Path) -> ctypes.CDLL:
    """``lib_path`` built from ``src`` if it is missing or older, then loaded."""
    if not lib_path.exists() or src.stat().st_mtime > lib_path.stat().st_mtime:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f".{lib_path.name}.{os.getpid()}.tmp")
        cmd = [COMPILER, *FLAGS, str(src), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise NativeBuildError(f"{COMPILER} not found: cannot build {src.name}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
