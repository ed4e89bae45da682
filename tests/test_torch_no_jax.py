"""The port runs where JAX does not exist.

In a fresh interpreter whose import system refuses jax, flax, orbax, optax,
pandas and matplotlib (as on the GPU host, which has none of them), every
module of ddpm_ood_tpu_torch imports, the tiny scoring CLI runs on the CPU
without launching a kernel, and building the CUDA kernels where there is no
nvcc raises KernelBuildError instead of returning.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from test_torch_reconstruct import make_synthetic_run

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax", "pandas", "matplotlib")

CHILD = r"""
import importlib, importlib.abc, json, pkgutil, sys

BLOCKED = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import ddpm_ood_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(ddpm_ood_tpu_torch.__path__, "ddpm_ood_tpu_torch.")]
for m in mods:
    importlib.import_module(m)

from ddpm_ood_tpu_torch import reconstruct
from ddpm_ood_tpu_torch.ops import KernelBuildError, _kernels
from ddpm_ood_tpu_torch.ops.attention import flash_attention_fwd
from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

recon = reconstruct.main(json.loads(sys.argv[2]))
build = "not run: nvcc present"
if _kernels.find_nvcc() is None:
    try:
        _kernels.build(force=True)
        build = "returned"
    except KernelBuildError as e:
        build = "KernelBuildError: " + str(e)
print(json.dumps({
    "modules": mods,
    "evals": sum(p.model_evals for p in recon._programs.values()),
    "launches": [groupnorm_act.launches, flash_attention_fwd.launches],
    "csvs": sorted(p.name for p in recon.out_dir.glob("results_*.csv")),
    "build": build,
    "leaked": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED),
}))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    argv = make_synthetic_run(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, ",".join(BLOCKED), json.dumps(argv)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see test_torch_reconstruct.py
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "ddpm_ood_tpu_torch.trainers.reconstruct" in got["modules"]
    assert "ddpm_ood_tpu_torch.ops._kernels" in got["modules"]
    assert got["leaked"] == []
    assert got["evals"] > 0 and got["launches"] == [0, 0]
    assert len(got["csvs"]) == 5
    assert got["build"].startswith("KernelBuildError: nvcc not found"), got["build"]
