"""Every cell through its driver at the rehearsal sizes on the CPU, where
the port runs float32: ``correct`` holds with the cell's limits and no
metric is written; then with the timed path broken underneath, ``correct``
comes out false for each fault the cell can have, and for each of its
controls (a lower precision, a planted fault in the scores); a witness
(the program in float32) holds. On the card: each cell's controls at its
own sizes, one batch or the checked steps."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import run as bench
from portbench import spec

CHECKOUT = Path(__file__).resolve().parents[2]
# every cell file, also one that BENCHMARK.json does not run yet
CELLS = sorted(p.stem for p in (spec.PKG / "workloads").glob("*.json"))
SCORE = [c for c in CELLS if spec.cell(c)["driver"] == "score"]


def _run(cell, seed=2**31 + 7, variant=None, rehearse=True):
    return bench.execute(argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=0,
                                            rehearse=rehearse, variant=variant))


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_writes_no_metric(cell):
    out = _run(cell)
    assert out["correct"], out["check"]
    assert out["metrics"] == {} and out["device"]["platform"] == "cpu"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert any(c["limit"] is not None for c in out["check"].values())


def test_rehearsal_command_runs_without_jax():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                        "--seed", "5", "--seconds", "0.5", "--trace", "0", "--rehearse"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("cell", SCORE)
def test_a_sampler_step_that_returns_its_state_fails(cell, monkeypatch):
    from ddpm_ood_tpu_torch.recon import sweep

    step = {"plms": "plms_step", "dpm": "dpm_step"}[spec.cell(cell)["traffic"]["sampler"]]
    monkeypatch.setattr(sweep, step, lambda sched, state, *a, **k: state)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", SCORE)
def test_an_altered_score_fails(cell, monkeypatch):
    from ddpm_ood_tpu_torch.recon import sweep

    real = sweep.metrics_tail

    def altered(*a, **k):
        mse, *rest = real(*a, **k)
        return (mse * 1.02, *rest)

    monkeypatch.setattr(sweep, "metrics_tail", altered)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", SCORE)
def test_half_the_batch_left_out_fails(cell, monkeypatch):
    from ddpm_ood_tpu_torch.recon import sweep

    real = sweep.ReconProgram._call

    def half(self, images, generator, noise_batch, global_batch):
        b = len(images)
        t, *scores = real(self, images[: b // 2], generator, noise_batch, global_batch)
        return (t, *(s.repeat(1, 2)[:, :b] for s in scores))

    monkeypatch.setattr(sweep.ReconProgram, "_call", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("variant", ["half_batch", "frozen"])
def test_training_faults_fail(variant):
    out = _run("train2d-b512", variant=variant)
    assert not out["correct"], out["check"]
    if variant == "half_batch":  # the number that sees every row reads one half alone
        assert abs(out["check"]["grad_half"]["value"] - 1) < 0.05, out["check"]


PROGRAM_CONTROLS = [(c, v) for c in CELLS for v in spec.cell(c)["controls"]
            if not v.startswith("reference_") and v not in ("half_batch", "frozen")]


@pytest.mark.parametrize("cell,variant", PROGRAM_CONTROLS)
def test_int8_path_and_metric_faults_fail(cell, variant):
    """A bf16 cell on the program's own int8 path, or with its scores
    computed wrong (SSIM's window, LPIPS's slicing axis), is not correct."""
    out = _run(cell, variant=variant)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell,variant", [(c, v) for c in CELLS
                                          for v in spec.cell(c).get("witnesses", {})])
def test_witness_is_correct(cell, variant):
    out = _run(cell, variant=variant)
    assert out["correct"], out["check"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_on_the_card(card, cell):
    """At the cell's own sizes, one batch or the checked steps."""
    sound = _run(cell, rehearse=False)
    assert sound["correct"], sound["check"]


@pytest.mark.card
@pytest.mark.parametrize("cell,variant", [(c, v) for c in CELLS for v in spec.cell(c)["controls"]])
def test_precision_control_fails_on_the_card(card, cell, variant):
    """At the cell's own sizes: each control of the cell (the reference in
    a lower precision or the program's int8 path in its place, a planted
    fault) is not correct."""
    control = _run(cell, variant=variant, rehearse=False)
    assert not control["correct"], control["check"]
    assert np.isfinite([c["value"] for c in control["check"].values()]).all()
