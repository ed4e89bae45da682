"""The port's pipeline scripts against the JAX package's originals.

- ``ddpm_ood_tpu_torch.demo``: its ``make_dataset`` writes what
  ``scripts/demo.py``'s does, bit for bit, and its three stages take the
  same flags; one ``--device=cpu`` run end to end separates the
  checkerboards (AUROC >= 0.9).
- ``ddpm_ood_tpu_torch.smoke_3d_ldm``: its volumes and CSVs are those of
  ``scripts/smoke_3d_ldm.sh``'s heredoc, bit for bit, and its four stages
  take the shell script's flags, at its defaults and with SAMPLER, STEPS
  and SKIP set.
- ``ddpm_ood_tpu_torch.parity_run``: on each state of pre-placed outputs it
  runs and skips the stages that ``scripts/parity_run.sh`` does, flag for
  flag; on a tree whose training and scoring outputs exist it skips stages
  1-3 and writes ``auroc_table.json``.
- ``ddpm_ood_tpu_torch.minimal_library_usage`` at 2 epochs, with JAX and
  the JAX package unimportable, prints its lines and a finite AUROC.

The shell scripts run under bash with a ``python`` first on PATH that logs
its argv and exits, except for ``python -`` (the smoke's heredoc), which it
hands to the real interpreter. Every argv is parsed by the JAX parser and by
the port's, and the namespaces compared (the port's adds ``device``).
"""

from __future__ import annotations

import csv
import gzip
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ddpm_ood_tpu import config as jax_config
from ddpm_ood_tpu_torch import (
    config as port_config, demo, parity_run, reconstruct, smoke_3d_ldm, train_ddpm, train_vqvae,
)

REPO = Path(__file__).resolve().parents[1]
# stage name -> (JAX parser, the port CLI's parser)
PARSERS = {
    "train_ddpm": (jax_config.parse_args_train_ddpm, train_ddpm.parse_args),
    "train_vqvae": (jax_config.parse_args_train_vqvae, train_vqvae.parse_args),
    "reconstruct": (jax_config.parse_args_reconstruct, reconstruct.parse_args),
    "ood_detection": (jax_config.parse_args_ood_detection, port_config.parse_args_ood_detection),
}
DEVICE_STAGES = ("train_ddpm", "train_vqvae", "reconstruct")
# one thread a child: under the suite's parallel workers, a child on every
# core oversubscribes the host (the library example's took over 300 s so)
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stage(argv: list) -> tuple:
    """(stage name, flags) of an argv the JAX scripts give python."""
    if argv[0] == "-m":
        return argv[1].removeprefix("ddpm_ood_tpu."), argv[2:]
    return Path(argv[0]).stem, argv[1:]


def _port_stage(cmd: list) -> tuple:
    """(stage name, flags) of a port command ``[python, -m, module, ...]``."""
    assert cmd[:2] == [sys.executable, "-m"], cmd
    return cmd[2].removeprefix("ddpm_ood_tpu_torch."), cmd[3:]


def _hold(port: tuple, jax: tuple, swap=lambda flag: flag) -> None:
    """The port's stage equals the JAX one flag for flag (``swap`` maps a JAX
    flag to the port's: workspace roots, checkpoint paths), its CLI is told
    ``--device=cpu``, and both parsers read the same namespace."""
    (name, flags), (jax_name, jax_flags) = port, jax
    assert name == jax_name
    want = [swap(f) for f in jax_flags]
    if name in DEVICE_STAGES:
        assert flags[-1] == "--device=cpu", flags
        flags = flags[:-1]
    assert flags == want
    if name in PARSERS:
        jax_parse, port_parse = PARSERS[name]
        got = vars(port_parse(flags + (["--device=cpu"] if name in DEVICE_STAGES else [])))
        assert got.pop("device", "cpu") == "cpu"
        assert got == vars(jax_parse(want))


def _fake_python(tmp: Path) -> tuple:
    """(PATH with a logging ``python`` first, the log's path)."""
    bin_dir, log = tmp / "bin", tmp / "python_calls.jsonl"
    bin_dir.mkdir()
    exe = bin_dir / "python"
    exe.write_text(
        f"#!{sys.executable}\nimport json, os, sys\n"
        "if sys.argv[1:2] == ['-']:\n"
        f"    os.execv({sys.executable!r}, [{sys.executable!r}] + sys.argv[1:])\n"
        f"with open({str(log)!r}, 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    exe.chmod(0o755)
    return f"{bin_dir}{os.pathsep}{os.environ['PATH']}", log


def _run_shell(tmp: Path, script: str, *args: str, env: dict = None) -> tuple:
    """(exit code, the argv lists python was given) of a shell script."""
    path, log = _fake_python(tmp)
    proc = subprocess.run(["bash", str(REPO / "scripts" / script), *args], capture_output=True,
                          text=True, timeout=300, env={**ENV, **(env or {}), "PATH": path})
    calls = [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []
    return proc.returncode, calls, proc.stderr


def _same_tree(port_root: Path, jax_root: Path) -> int:
    """Every file equal: .nii.gz decompressed (gzip stamps the time), split
    CSVs with the root swapped, the rest byte for byte. Returns the count."""
    files = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(port_root) for p in port_root.rglob("*") if p.is_file())
    for f in files:
        got, want = (port_root / f).read_bytes(), (jax_root / f).read_bytes()
        if f.name.endswith(".gz"):
            got, want = gzip.decompress(got), gzip.decompress(want)
        elif f.suffix == ".csv":
            want = want.replace(str(jax_root).encode(), str(port_root).encode())
        assert got == want, f
    return len(files)


# --- demo -------------------------------------------------------------------


def test_demo_dataset_and_stages_equal_the_jax_demo(tmp_path, monkeypatch):
    jax_demo = _load_script("demo")
    calls = []
    monkeypatch.setattr(jax_demo, "run", lambda script, backend, *flags: calls.append(
        (Path(script).stem, list(flags))))
    monkeypatch.setattr(sys, "argv", ["demo.py", "--workdir", str(tmp_path / "jax"),
                                      "--epochs", "3"])
    jax_demo.main()  # its make_dataset, then the three stages, logged
    demo.make_dataset(tmp_path / "port")
    assert _same_tree(tmp_path / "port", tmp_path / "jax") == 4 + 56
    stages = demo.stages(tmp_path / "port", 3, "cpu")
    assert [s for s, _ in stages] == ["train_ddpm", "reconstruct", "ood_detection"]
    for (name, flags), jax in zip(stages, calls, strict=True):
        _hold((name, flags), jax,
              lambda f: f.replace(str(tmp_path / "jax"), str(tmp_path / "port")))


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """The demo on the CPU at one epoch. The scored checkpoint.pth is the
    best-loss one, which is epoch 0's here at one epoch and at the default
    two alike; two would add the 1000-step validation sample grid
    (--eval_freq=2), 27 s of the CPU run, which chip_smoke.py's run of the
    demo at its defaults covers on the card."""
    ws = tmp_path_factory.mktemp("demo")
    proc = subprocess.run([sys.executable, "-m", "ddpm_ood_tpu_torch.demo", "--device=cpu",
                           f"--workdir={ws}", "--epochs=1"], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=ENV)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ws, proc.stdout


def _rows(path: Path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_demo_runs_end_to_end_on_the_cpu(demo_run):
    ws, out = demo_run
    run = ws / "output" / demo.MODEL
    assert (run / "checkpoint.pth").is_file()
    for name in ("val", "in", "MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"):
        rows = _rows(run / "ood" / f"results_{name}.csv")
        assert len(rows) == 8 * 4  # 8 images x 4 start points (10-step PLMS, skip 3)
        assert all(math.isfinite(float(r[c])) for r in rows
                   for c in ("mse", "perceptual_difference"))
    aucs = {r["ood_data"]: float(r["Zscore_mse"])
            for r in _rows(run / "ood" / "ood_scores_mse.csv")}
    assert list(aucs) == ["MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"]
    assert aucs["MNIST"] >= 0.9, aucs  # structural OOD separates at once
    assert re.search(r"^AUC for demo_fashionmnist vs MNIST: [\d.]+$", out, re.M), out
    assert f"demo artifacts under {run}/" in out


# --- smoke_3d_ldm -----------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"SAMPLER": "dpm", "STEPS": "25", "SKIP": "1"}],
                         ids=["defaults", "dpm"])
def test_smoke_3d_ldm_equals_the_shell_script(env, tmp_path, monkeypatch):
    jax_ws, port_ws = tmp_path / "jax_ws", tmp_path / "port_ws"
    rc, calls, err = _run_shell(tmp_path, "smoke_3d_ldm.sh", str(jax_ws), env=env)
    assert rc == 0, err[-4000:]
    for key in ("SAMPLER", "STEPS", "SKIP"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port_calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: port_calls.append(cmd))
    smoke_3d_ldm.main([str(port_ws), "--device=cpu"])  # the volumes; the stages logged
    assert _same_tree(port_ws, jax_ws) == 52 + 12  # volumes and split CSVs

    def swap(flag):
        flag = flag.replace(str(jax_ws), str(port_ws))
        if flag.startswith("--vqvae_checkpoint="):
            return flag + ".pth"  # the port's VQ-VAE trainer writes checkpoint.pth
        return flag

    assert len(calls) == len(port_calls) == 4
    for cmd, jax in zip(port_calls, calls):
        _hold(_port_stage(cmd), _jax_stage(jax), swap)
    recon = _port_stage(port_calls[2])[1]
    assert f"--sampler={env.get('SAMPLER', 'plms')}" in recon
    assert f"--num_inference_steps={env.get('STEPS', '10')}" in recon


# --- parity_run -------------------------------------------------------------

# pre-placed outputs -> (split CSVs, checkpoint_300, results CSVs present)
STATES = {
    "no_splits": (False, False, ()),
    "fresh": (True, False, ()),
    "partly_scored": (True, True, ("val", "MNIST", "CIFAR10")),
    "scored_untrained": (True, False, ("val", "in", "MNIST", "SVHN", "CIFAR10",
                                       "FashionMNIST_vflip", "FashionMNIST_hflip")),
    "done": (True, True, ("val", "in", "MNIST", "SVHN", "CIFAR10", "FashionMNIST_vflip",
                          "FashionMNIST_hflip")),
}


def _place(data: Path, out: Path, state: str, checkpoint: str) -> None:
    splits, trained, results = STATES[state]
    if splits:
        (data / "data_splits").mkdir(parents=True)
        for name in parity_run.SPLITS:
            (data / "data_splits" / f"{name}.csv").write_text("x.npy")
    ood = out / parity_run.MODEL / "ood"
    ood.mkdir(parents=True)
    if trained:
        (out / parity_run.MODEL / checkpoint).mkdir()
    for name in results:
        (ood / f"results_{name}.csv").write_text("")


@pytest.mark.parametrize("state", list(STATES))
def test_parity_run_stages_equal_the_shell_script(state, tmp_path, monkeypatch):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _place(jax_root / "data", jax_root / "out", state, "checkpoint_300")
    _place(port_root / "data", port_root / "out", state, "checkpoint_300.pth")
    rc, calls, err = _run_shell(tmp_path, "parity_run.sh", str(jax_root / "data"),
                                str(jax_root / "out"))
    port_calls = []
    monkeypatch.setattr(parity_run, "run", port_calls.append)
    try:
        parity_run.main([str(port_root / "data"), str(port_root / "out"), "--device=cpu"])
        port_rc = 0
    except SystemExit as e:
        port_rc = e.code
    assert bool(rc) == bool(port_rc) == (state == "no_splits"), err[-4000:]
    assert len(port_calls) == len(calls), (port_calls, calls)
    for cmd, jax in zip(port_calls, calls):
        _hold(_port_stage(cmd), _jax_stage(jax),
              lambda f: f.replace(str(jax_root), str(port_root)))
    want = {"no_splits": ["data.get_computer_vision_datasets"],
            "fresh": ["train_ddpm", "reconstruct", "parity_report"],
            "partly_scored": ["reconstruct", "parity_report"],
            "scored_untrained": ["train_ddpm", "parity_report"],
            "done": ["parity_report"]}[state]
    assert [_port_stage(c)[0] for c in port_calls] == want
    if state == "partly_scored":
        flags = _port_stage(port_calls[0])[1]
        assert "--run_val=0" in flags and "--run_in=1" in flags and "--run_out=1" in flags
        out_ids = next(f for f in flags if f.startswith("--out_ids=")).split(",")
        assert [Path(p).name for p in out_ids] == ["SVHN_test.csv", "FashionMNIST_test.csv_vflip",
                                                   "FashionMNIST_test.csv_hflip"]


def test_parity_run_skips_to_the_report(demo_run, tmp_path):
    """On the demo's scoring CSVs (MNIST's standing in for SVHN and CIFAR10)
    and a placed checkpoint_300.pth, the run skips stages 1-3 and the report
    writes auroc_table.json."""
    ws, _ = demo_run
    _place(tmp_path / "data", tmp_path / "out", "done", "checkpoint_300.pth")
    ood = tmp_path / "out" / parity_run.MODEL / "ood"
    src = ws / "output" / demo.MODEL / "ood"
    for name in ("val", "in", "MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"):
        shutil.copy(src / f"results_{name}.csv", ood / f"results_{name}.csv")
    for name in ("SVHN", "CIFAR10"):
        shutil.copy(src / "results_MNIST.csv", ood / f"results_{name}.csv")
    proc = subprocess.run([sys.executable, "-m", "ddpm_ood_tpu_torch.parity_run",
                           str(tmp_path / "data"), str(tmp_path / "out"), "--device=cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for stage in ("stage 1 (datasets)", "stage 2 (train)", "stage 3 (reconstruct)"):
        assert f"[parity] {stage}" in proc.stdout
    table = json.loads((ood / "auroc_table.json").read_text())
    # the registry's OOD sets of a fashionmnist model
    assert list(table["comparison"]) == ["MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"]
    assert table["comparison"]["MNIST"]["measured_auroc"] >= 90.0


# --- the library example ----------------------------------------------------


LIBRARY_CHILD = r"""
import json, sys

BLOCKED = set(sys.argv[1].split(","))
for name in BLOCKED:
    sys.modules[name] = None
from ddpm_ood_tpu_torch import minimal_library_usage

minimal_library_usage.EPOCHS = 2
result = minimal_library_usage.main(["--device=cpu"])
print(json.dumps({"auroc": result, "leaked": sorted(
    m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED)}))
"""


def test_library_example_at_two_epochs():
    """In a fresh interpreter where JAX, the JAX package, sklearn, pandas and
    Pillow are unimportable (test_torch_no_jax.py's list)."""
    from test_torch_no_jax import BLOCKED

    proc = subprocess.run([sys.executable, "-c", LIBRARY_CHILD, ",".join(BLOCKED)], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-4000:]
    *lines, last = proc.stdout.splitlines()
    got = json.loads(last)
    assert got["leaked"] == []
    assert re.fullmatch(r"epoch 0: loss \d+\.\d{4}", lines[0]), lines
    assert re.fullmatch(r"mean Z in-dist -?\d+\.\d\d  out-dist -?\d+\.\d\d", lines[1]), lines
    assert lines[2] == f"AUROC: {got['auroc']:.3f}" and len(lines) == 3
    assert math.isfinite(got["auroc"]) and 0.0 <= got["auroc"] <= 1.0
