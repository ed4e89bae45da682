"""``python -m ddpm_ood_tpu_torch.parity_report`` against the JAX package's
``scripts/parity_report.py`` on the same fixture ``results_*.csv``: the
``auroc_table.json`` agrees at 1e-12 and the report's own printed lines are
the same, with the published tables untranscribed (the repo's
``BASELINE.json``) and transcribed so that the 0.5-pt gate passes or fails.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from ddpm_ood_tpu_torch import parity_report

REPO = Path(__file__).resolve().parents[1]
OUT_SETS = ("MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip")


def _load_jax_report(baseline_dir: Path):
    """scripts/parity_report.py as a module whose ``__file__`` lies under
    ``baseline_dir/scripts``, so that it reads ``baseline_dir/BASELINE.json``."""
    spec = importlib.util.spec_from_file_location("_jax_parity_report",
                                                  REPO / "scripts" / "parity_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.__file__ = str(baseline_dir / "scripts" / "parity_report.py")
    return mod


def _write_results(ood: Path, seed: int) -> None:
    """val / in / three OOD sets, two start points, one duplicated row (the
    multi-process pad the scorer dedups) and a tie between sets."""
    ood.mkdir(parents=True)
    rng = np.random.default_rng(seed)

    def frame(prefix, kind, n, lo, hi):
        mse = rng.uniform(lo, hi, (2, n))
        mse[:, 0] = 0.3  # the same value in every set
        names = [f"{prefix}{i}" for i in range(n)] * 2
        rows = {"filename": names, "type": [kind] * (2 * n), "t": [100] * n + [300] * n,
                "perceptual_difference": mse.ravel()[::-1], "mse": mse.ravel()}
        df = pd.DataFrame(rows)
        return pd.concat([df, df.iloc[:1]], ignore_index=True)

    frame("v", "val", 7, 0.1, 0.3).to_csv(ood / "results_val.csv")
    frame("i", "in", 6, 0.1, 0.35).to_csv(ood / "results_in.csv")
    for j, name in enumerate(OUT_SETS):
        frame(f"o{j}_", "out", 5 + j, 0.2 + 0.05 * j, 0.6).to_csv(ood / f"results_{name}.csv")


def _close(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, (int, float)):
        return abs(a - b) <= 1e-12
    return a == b and type(a) is type(b)


TABLES = {
    "untranscribed": None,  # the repo's BASELINE.json
    "gate_pass": "measured",  # published = measured AUROCs: delta 0, PASS
    "gate_fail": {"MNIST": 12.5, "FashionMNIST_vflip": 99.9},
}


@pytest.mark.parametrize("case", list(TABLES))
@pytest.mark.parametrize("seed", [0, 1])
def test_port_report_equals_jax(case, seed, tmp_path, capsys, monkeypatch):
    _write_results(tmp_path / "jax" / "fashionmnist" / "ood", seed)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    baseline = json.loads((REPO / "BASELINE.json").read_text())
    tables = TABLES[case]
    if tables == "measured":
        parity_report.main(["--output_dir", str(tmp_path / "port")])
        comparison = json.loads((tmp_path / "port" / "fashionmnist" / "ood" /
                                 "auroc_table.json").read_text())["comparison"]
        tables = {k: v["measured_auroc"] for k, v in comparison.items()}
    if tables is not None:
        baseline["published"]["tables"] = tables
    (tmp_path / "BASELINE.json").write_text(json.dumps(baseline))
    monkeypatch.setattr(parity_report, "BASELINE", tmp_path / "BASELINE.json")
    jax_report = _load_jax_report(tmp_path)

    printed = {}
    for side, run in (("jax", jax_report.main), ("port", parity_report.main)):
        capsys.readouterr()
        run(["--output_dir", str(tmp_path / side), "--model_name", "fashionmnist"])
        printed[side] = [line.replace(str(tmp_path / side), "<out>")
                         for line in capsys.readouterr().out.splitlines()
                         if line.startswith(("wrote ", "published ", "parity gate"))]
    got, want = (json.loads((tmp_path / side / "fashionmnist" / "ood" /
                             "auroc_table.json").read_text()) for side in ("port", "jax"))
    assert _close(got, want), (got, want)
    assert list(got["comparison"]) == list(OUT_SETS)
    assert printed["port"] == printed["jax"]
    verdict = {"untranscribed": "published paper tables not yet transcribed",
               "gate_pass": "-> PASS", "gate_fail": "-> FAIL"}[case]
    assert verdict in printed["port"][-1]
