"""What one run of a cell carries from its driver to the metric readers
and the result line, and the checks every run makes: a card to run on,
caches inside the checkout, no JAX in the process."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional

from . import spec

# top-level module names that may not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ddpm_ood_tpu")
CACHE = spec.CHECKOUT / ".portbench_cache"


def fixed_caches() -> None:
    """Compiler caches at fixed paths inside the checkout, so that only a
    checkout's first run builds. The port's own kernel library builds into
    ``ddpm_ood_tpu_torch/_build``, inside the checkout; these catch a
    Triton kernel or a PyTorch extension a later change may add."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``ddpm_ood_tpu_torch`` is not ``ddpm_ood_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """One run of a cell: its inputs, then what its driver measured."""

    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float  # perf_counter at process start
    rehearsal: bool = False
    setup_s: Optional[float] = None
    window: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    traced: Optional[object] = None  # trace.Trace of the stretch after the window
    traced_s: float = 0.0  # host seconds of that stretch
    attempted: int = 0
    failed: int = 0
    check: Dict[str, dict] = dataclasses.field(default_factory=dict)
    correct: bool = False

    @property
    def config(self) -> dict:
        return self.cell["config_spec"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    def peak(self) -> Optional[dict]:
        from .flops import peak
        if self.rehearsal:
            return None
        import torch
        return peak(torch.cuda.get_device_name(self.device))

    def judge(self, numbers: Dict[str, float]) -> None:
        """`numbers` held to the cell's limits: correct when each with a
        limit is finite and at most its limit (a number without one is
        printed, not compared)."""
        limits = self.cell.get("check", {}).get("limits", {})
        self.check = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
        held = [c for c in self.check.values() if c["limit"] is not None]
        self.correct = bool(held) and all(
            c["value"] == c["value"] and c["value"] <= c["limit"] for c in held)


def device_info(run: Run) -> dict:
    if run.rehearsal:
        return {"platform": "cpu", "kind": "cpu rehearsal", "count": 1,
                "memory_peak_bytes": 0}
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
           "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": int(run.peak_bytes)}
    if run.trace and run.traced is not None:
        out["busy_s"] = run.traced.busy_us() / 1e6
        out["window_s"] = run.traced_s
    return out


def result(run: Run) -> dict:
    """The result line: the cell's metrics (end-to-end, or per-layer with
    --trace 1) that found something to read, and the numbers compared last."""
    metrics = {}
    if not run.rehearsal:
        for m in spec.metrics_for(run.cell["name"], run.trace):
            value = spec.reader(m["name"]).read(run)
            if value is None and m in spec.metrics_for(run.cell["name"], False):
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(run.correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device_info(run)}
    if run.trace and run.traced is not None:
        out["breakdown"] = {"device_ops": run.traced.top_kernels(),
                            "idle_gaps": run.traced.idle_gaps()}
    out["check"] = run.check
    return out


def print_result(out: dict) -> None:
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
