"""Run one cell once and print its result as the last line of stdout.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell asks for and exits non-zero,
printing no result, without them. ``--rehearse`` runs the same driver at
the cell's tiny rehearsal sizes on the CPU instead, for the tests: it
reports no metric.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # noqa: E402  (set-up is counted from here)

import argparse  # noqa: E402
import sys  # noqa: E402

from . import harness, spec  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def execute(args, t0: float = None) -> dict:
    """The run's result (raises where it cannot give one)."""
    harness.fixed_caches()
    import torch

    cell = spec.cell(args.workload, rehearsal=args.rehearse, variant=args.variant)
    if args.rehearse:
        device = torch.device("cpu")
    else:
        chips = int(cell.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"portbench: cell {args.workload} needs {chips} CUDA card(s); "
                             f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                             f"device_count={torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=device, t0=T0 if t0 is None else t0, rehearsal=args.rehearse)
    spec.driver(cell["driver"]).run(run)
    out = harness.result(run)
    loaded = harness.forbidden_modules()
    if loaded:
        raise SystemExit(f"portbench: the run loaded {', '.join(loaded)}")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    out = execute(args)
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
