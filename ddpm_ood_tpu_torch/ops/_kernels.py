"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

All sources under ``ddpm_ood_tpu_torch/csrc`` are compiled by ``nvcc`` into
one shared library with a plain C interface, ``_build/libddpm_ood_kernels.so``,
and bound with ctypes. The library is built at first use from the checkout's
own sources, and rebuilt when a source is newer than it. ``nvcc`` takes a
few seconds for these files because none of them includes PyTorch's headers.

This module imports no CUDA code and runs no compiler when it is imported:
the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_PATH = BUILD_DIR / "libddpm_ood_kernels.so"
BUILD_LOG = BUILD_DIR / "build.log"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or refused the kernel sources (message holds its stderr)."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def find_nvcc() -> Optional[str]:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def build(force: bool = False) -> float:
    """Compile the kernel library if it is missing or stale. Returns the
    seconds nvcc took (0.0 when the library was current)."""
    if not force and not _stale():
        return 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built here"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(tmp),
           *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees a torn file
    return seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ddpm_groupnorm_act.argtypes = [p, p, p, p, i, i, i, i, f, i, i, i, p]
    lib.ddpm_groupnorm_act.restype = i
    lib.ddpm_flash_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, f, i, i, p]
    lib.ddpm_flash_attn_fwd.restype = i
    lib.ddpm_flash_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
    lib.ddpm_flash_attn_bwd_dkv.restype = i
    lib.ddpm_flash_attn_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, f, i, i, p]
    lib.ddpm_flash_attn_bwd_dq.restype = i
    lib.ddpm_cuda_error_string.argtypes = [i]
    lib.ddpm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ddpm_cuda_error_string(rc).decode()
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
