from .score import (
    OOD_DATASET_REGISTRY,
    aupr,
    auroc,
    auroc_delong_ci,
    compute_ood_scores,
    fpr_at_95_tpr,
    out_datasets_for_model,
    read_results_csv,
    run_ood_detection,
    zscore_against_val,
)

__all__ = [
    "OOD_DATASET_REGISTRY",
    "aupr",
    "auroc",
    "auroc_delong_ci",
    "compute_ood_scores",
    "fpr_at_95_tpr",
    "out_datasets_for_model",
    "read_results_csv",
    "run_ood_detection",
    "zscore_against_val",
]
