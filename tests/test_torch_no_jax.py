"""The port runs where JAX does not exist.

In a fresh interpreter whose import system refuses jax, flax, orbax, optax,
pandas and matplotlib (as on the GPU host, which has none of them) and the
JAX package itself (the port keeps its own copies of what it needs), every
module of ddpm_ood_tpu_torch imports, the tiny scoring and training CLIs run
on the CPU without launching a kernel, and building the CUDA kernels where
there is no nvcc raises KernelBuildError instead of returning.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from test_torch_reconstruct import make_synthetic_run
from test_torch_train_cli import train_argv

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax", "pandas", "matplotlib", "tensorboardX",
           "ddpm_ood_tpu")

CHILD = r"""
import importlib, json, pkgutil, sys

# None in sys.modules is how Python spells "not installed": import raises
# ModuleNotFoundError and importlib.util.find_spec returns None (torch probes
# optional packages that way, e.g. when torch.optim first loads torch._dynamo)
BLOCKED = set(sys.argv[1].split(","))
for name in BLOCKED:
    sys.modules[name] = None

import ddpm_ood_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(ddpm_ood_tpu_torch.__path__, "ddpm_ood_tpu_torch.")]
for m in mods:
    importlib.import_module(m)

from ddpm_ood_tpu_torch import reconstruct, train_ddpm
from ddpm_ood_tpu_torch.ops import KernelBuildError, _kernels
from ddpm_ood_tpu_torch.ops.attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
)
from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

recon = reconstruct.main(json.loads(sys.argv[2]))
trainer = train_ddpm.main(json.loads(sys.argv[3]))
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
    "launches": [groupnorm_act.launches, flash_attention_fwd.launches,
                 flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches],
    "trained": [trainer.global_step, trainer.step.backwards,
                sorted(p.name for p in trainer.run_dir.glob("*.pth"))],
    "csvs": sorted(p.name for p in recon.out_dir.glob("results_*.csv")),
    "build": build,
    "leaked": sorted(m for m, mod in sys.modules.items()
                     if mod is not None and m.split(".")[0] in BLOCKED),
}))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    argv = make_synthetic_run(tmp_path / "score")
    train = train_argv(tmp_path / "train", "--n_epochs=1", "--eval_freq=100",
                       "--checkpoint_every=1")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, ",".join(BLOCKED), json.dumps(argv), json.dumps(train)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # see test_torch_reconstruct.py
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("trainers.reconstruct", "trainers.ddpm_trainer", "train_ddpm", "config",
                "data.transforms", "ops._kernels"):
        assert f"ddpm_ood_tpu_torch.{mod}" in got["modules"]
    assert got["leaked"] == []
    assert got["evals"] > 0 and got["launches"] == [0, 0, 0, 0]
    assert got["trained"] == [10, 3, ["checkpoint.pth", "checkpoint_1.pth"]]
    assert len(got["csvs"]) == 5
    assert got["build"].startswith("KernelBuildError: nvcc not found"), got["build"]
