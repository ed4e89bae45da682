"""Finding a cell, its configuration, its driver and its metrics by name.

A cell is ``workloads/<cell>.json``: {"config", "driver", "traffic",
"controls", "check", "rehearsal"}, and "witnesses" where it has them. A configuration is ``configs/<config>.json``. A
driver is ``drivers/<driver>.py`` with ``run(run)``. A metric is
``metrics/<metric>.py`` with ``read(run)``, returning a number or None when
the run holds nothing to read it from. Which metrics a cell reports, with
their units, comes from ``BENCHMARK.json`` at the root of the checkout."""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PKG = Path(__file__).resolve().parent
CHECKOUT = PKG.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(name: str, rehearsal: bool = False, variant: str = None, root: Path = PKG) -> dict:
    """The cell `name` with its configuration under "config_spec"; with
    `rehearsal`, both with their "rehearsal" overrides applied; with
    `variant`, its traffic changed by the cell's "controls" entry of that
    name (a lower precision, or a planted fault) or its "witnesses" entry
    (a run that has to agree with the reference, such as the program in
    float32)."""
    c = load_json(root / "workloads" / f"{name}.json")
    cfg = load_json(root / "configs" / f"{c['config']}.json")
    if rehearsal:
        c = _merge(c, c.get("rehearsal", {}))
        cfg = _merge(cfg, cfg.get("rehearsal", {}))
    if variant:
        c["traffic"].update({**c.get("controls", {}), **c.get("witnesses", {})}[variant])
    c["name"], c["config_spec"] = name, cfg
    return c


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = PKG) -> ModuleType:
    return _module(root / "drivers" / f"{name}.py")


def reader(metric: str, root: Path = PKG) -> ModuleType:
    return _module(root / "metrics" / f"{metric}.py")


def metrics_for(cell_name: str, trace: bool, benchmark: Path = CHECKOUT / "BENCHMARK.json"
                ) -> List[Dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones:
    those whose "workloads" list it, or that have none (a per-layer metric
    without one goes wherever its "moves" metric goes)."""
    bench = load_json(benchmark)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
