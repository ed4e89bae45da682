"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source under ``ddpm_ood_tpu_torch/csrc`` is compiled by its own
``nvcc``, all started together, and the objects are linked into one shared
library with a plain C interface, ``_build/libddpm_ood_kernels.so``, bound
with ctypes (argument types in ``SIGNATURES``). The library is built at first
use from the checkout's own sources, and rebuilt when a source is newer than
it. None of the sources includes PyTorch's headers, which keeps ``nvcc`` fast.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every C entry point's argument types, in order; all return a cudaError_t
SIGNATURES = {
    # x, gamma, beta, y, B, HW, C, G, eps, act, dtype, device, stream
    "ddpm_groupnorm_act": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # x, gamma, beta, y, B, HW, C, G, eps, act, dtype, cluster, smem bytes, device, stream
    "ddpm_groupnorm_act_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, lse, BH, N, D, scale, device, stream (fp32, CUDA cores)
    "ddpm_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, lse, BH, N, D, scale, device, stream (bf16, tensor cores)
    "ddpm_flash_attn_fwd_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # q, k, v, dO, lse, delta, dk, dv, BH, N, D, scale, device, stream (fp32, CUDA cores)
    "ddpm_flash_attn_bwd_dkv": [_P] * 8 + [_I, _I, _I, _F, _I, _P],
    # q, k, v, dO, lse, delta, dk, dv, BH, N, D, scale, device, stream (bf16, tensor cores)
    "ddpm_flash_attn_bwd_dkv_tc": [_P] * 8 + [_I, _I, _I, _F, _I, _P],
    # q, k, v, dO, lse, delta, dq, BH, N, D, scale, device, stream (fp32, CUDA cores)
    "ddpm_flash_attn_bwd_dq": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
    # q, k, v, dO, lse, delta, dq, BH, N, D, scale, device, stream (bf16, tensor cores)
    "ddpm_flash_attn_bwd_dq_tc": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
}


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
    """Compile the kernel library if it is missing or stale: one ``nvcc`` per
    source, all at once, then one link. Returns the seconds that took (0.0
    when the library was current). ``BUILD_LOG`` keeps every command and
    its output, ptxas' register and spill lines included."""
    if not force and not _stale():
        return 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built here"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f".{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for obj, cmd, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[-1]).name} (exit {proc.returncode}):\n{err}")
    tmp = BUILD_DIR / f".{LIB_PATH.name}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj, _, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr}")
    seconds = time.perf_counter() - t0
    BUILD_LOG.write_text("\n".join(log))
    for obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees a torn file
    return seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.ddpm_cuda_error_string.argtypes = [_I]
    lib.ddpm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ddpm_cuda_error_string(rc).decode()
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cuda_target(t: torch.Tensor, what: str) -> tuple:
    """(device index, current stream) for a launch on t's card; raises for a
    tensor anywhere else."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {t.device}")
    return t.device.index, stream_of(t)


def call(name: str, *args) -> None:
    """Run the C entry point ``name`` with ``args`` (as ``SIGNATURES``
    declares them); raises KernelLaunchError when it returns a CUDA error."""
    lib = library()
    check_rc(lib, getattr(lib, name)(*args), name)
