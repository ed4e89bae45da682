"""OOD detection CLI of the PyTorch port: z-score AUROCs from the
reconstruction CSVs.

    python -m ddpm_ood_tpu_torch.ood_detection --output_dir=... --model_name=a,b \\
        [--plot_target=mse] [--report=auroc,aupr,fpr95,auroc_ci]

The twin of the root-level ``ood_detection.py`` (the same flags,
``config.parse_args_ood_detection``, and the comma-separated multi-model
loop), in numpy only. It is host analytics and touches no device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .config import parse_args_ood_detection
from .ood import run_ood_detection


def main(argv=None) -> Dict[str, Dict[str, List]]:
    """Scores every model of --model_name; returns {model: result table}."""
    args = parse_args_ood_detection(argv)
    np.random.seed(args.seed)
    return {
        model: run_ood_detection(output_dir=args.output_dir, model_name=model,
                                 max_t=args.max_t, min_t=args.min_t,
                                 plot_target=args.plot_target, report=args.report)
        for model in args.model_name.split(",")
    }


if __name__ == "__main__":
    main()
