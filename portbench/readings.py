"""The readings the limits of ``correct`` are set from: runs of a cell on
several seeds, as it stands, as one of its "controls" (a lower precision
in the program's place, or a planted fault) or as one of its "witnesses"
(the program in float32), in one process.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \
        [--variant <control or witness>] [--seconds 1] [--json readings.jsonl]

Prints one JSON line a run: the seed, the variant, every number the check
compares, and the run's end-to-end metrics; appends them to ``--json``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from . import run as bench


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default=None)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        run_args = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                      trace=args.trace, rehearse=False, variant=args.variant)
        t0 = time.perf_counter()
        out = bench.execute(run_args, t0=t0)
        line = {"workload": args.workload, "variant": args.variant or "none", "seed": seed,
                "numbers": {k: v["value"] for k, v in out["check"].items()},
                "correct": out["correct"], "metrics": out["metrics"],
                "device": out["device"], "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            with open(args.json, "a") as fh:
                fh.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
