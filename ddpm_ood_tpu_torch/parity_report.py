"""The AUROC parity table of a finished scoring run, compared with
``BASELINE.json``'s ``published`` tables once they are transcribed.

    python -m ddpm_ood_tpu_torch.parity_report --output_dir=DIR [--model_name=fashionmnist]

The twin of ``scripts/parity_report.py``: the same flags, printed lines and
``<output_dir>/<model>/ood/auroc_table.json``, from the port's numpy
``ood.score.run_ood_detection`` with the DeLong 95% interval. It reads the
repo-root ``BASELINE.json`` and exits 0 whether the 0.5-pt gate passes or
not, so the unattended parity pipeline (``python -m
ddpm_ood_tpu_torch.parity_run``) completes and leaves the table behind. It
touches no device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .ood.score import run_ood_detection

BASELINE = Path(__file__).resolve().parent.parent / "BASELINE.json"
GATE_POINTS = 0.5  # the parity gate: |measured - published| AUROC, in percent


def main(argv=None) -> dict:
    """Writes and returns the auroc_table.json contents."""
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name", default="fashionmnist")
    args = p.parse_args(argv)

    # auroc_ci adds the DeLong 95% interval, so the gate can be read against
    # sampling uncertainty
    results = run_ood_detection(output_dir=args.output_dir, model_name=args.model_name,
                                report="auroc,auroc_ci")
    published = json.loads(BASELINE.read_text()).get("published", {})
    table = published.get("tables", {})  # absent until transcribed from the papers

    comparison = {}
    for i, dataset in enumerate(results["ood_data"]):
        measured = round(results["Zscore_mse"][i] * 100, 1)  # percent, as printed
        ref = table.get(dataset)
        # containment is judged on the unrounded interval; rounding is for display
        lo_exact = results["auroc_ci_lo"][i] * 100
        hi_exact = results["auroc_ci_hi"][i] * 100
        comparison[dataset] = {
            "measured_auroc": measured,
            "measured_ci95": [round(lo_exact, 1), round(hi_exact, 1)],
            "published_auroc": ref,
            "delta": None if ref is None else round(measured - float(ref), 2),
            "published_within_ci": (
                None if ref is None else bool(lo_exact <= float(ref) <= hi_exact)
            ),
        }

    out = {"model": args.model_name, "comparison": comparison,
           "published_status": published.get("transcription_status")}
    out_path = Path(args.output_dir) / args.model_name / "ood" / "auroc_table.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    print(f"wrote {out_path}")
    if not table:
        print(
            "published paper tables not yet transcribed "
            "(BASELINE.json.published.transcription_status) — add them under "
            "published.tables as {dataset: auroc} to gate on the 0.5-pt rule"
        )
    else:
        worst = max(
            (abs(c["delta"]) for c in comparison.values() if c["delta"] is not None),
            default=None,
        )
        if worst is not None:
            verdict = "PASS" if worst <= GATE_POINTS else "FAIL"
            print(f"parity gate (0.5 AUROC pts): worst |delta| = {worst} -> {verdict}")
    return out


if __name__ == "__main__":
    main()
