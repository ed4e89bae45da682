"""OOD scoring analytics: z-scores and AUROCs over the reconstruction CSVs.

Port of ``ddpm_ood_tpu/ood/score.py`` in numpy, ``csv`` and ``statistics``
only: the host that runs the port has neither pandas nor sklearn nor
matplotlib. A table is a dict of equal-length numpy columns, read from the
``results_*.csv`` files that both packages write (an unnamed index column
first, then filename, type, t, perceptual_difference, mse and the optional
elbo / ssim_distance). Each pandas or sklearn step of the JAX module has an
exact equivalent here:

- ``drop_duplicates(["filename", "t"], keep="first")`` -> ``dedup``;
- the per-t validation mean and std (ddof 1, NaN for a single row, NaN values
  skipped) merged ``how="left"`` -> ``zscore_against_val``;
- ``groupby(["filename", "type"]).mean()`` (NaN skipped, keys sorted) ->
  ``_group_mean``;
- ``roc_auc_score``, ``average_precision_score`` and ``roc_curve`` (with its
  dropping of collinear points) -> ``auroc``, ``aupr`` and ``fpr_at_95_tpr``
  over the same distinct-threshold curve (``_clf_curve``), summed in the same
  order, so that the floats are the same. The AUROC is the midrank
  Mann-Whitney statistic, which ``auroc_delong_ci`` computes from ranks.

The z-vs-t figures of the JAX package need matplotlib and are not drawn.
"""

from __future__ import annotations

import csv
import statistics
import warnings
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..diffusion.plms import pndm_timesteps

Table = Dict[str, np.ndarray]

_MEDNIST = ("AbdomenCT", "BreastMRI", "ChestCT", "CXR", "Hand", "HeadCT")

# model-name substring -> held-out OOD datasets (reference ood_detection.py:92-135)
OOD_DATASET_REGISTRY: Dict[str, Tuple[str, ...]] = {
    "fashionmnist": ("MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"),
    "mnist": ("FashionMNIST", "MNIST_vflip", "MNIST_hflip"),
    "cifar10": ("SVHN", "CelebA", "CIFAR10_vflip", "CIFAR10_hflip"),
    "celeba": ("CIFAR10", "SVHN", "CelebA_vflip", "CelebA_hflip"),
    "svhn": ("CIFAR10", "CelebA", "SVHN_vflip", "SVHN_hflip"),
    "abdomenct": tuple(d for d in _MEDNIST if d != "AbdomenCT"),
    "breastmri": tuple(d for d in _MEDNIST if d != "BreastMRI"),
    "cxr": tuple(d for d in _MEDNIST if d != "CXR"),
    "chestct": tuple(d for d in _MEDNIST if d != "ChestCT"),
    "hand": tuple(d for d in _MEDNIST if d != "Hand"),
    "headct": tuple(d for d in _MEDNIST if d != "HeadCT"),
    "decathlon": tuple(f"Task{i:02d}" for i in range(2, 11)),
}
# text columns of the results CSVs; "t" is an integer, every other column a float
_TEXT_COLUMNS = ("filename", "type")


def out_datasets_for_model(model_name: str) -> Tuple[str, ...]:
    """Registry lookup by substring; 'fashionmnist' must win over 'mnist'
    (reference's if/elif ordering, ood_detection.py:95-135)."""
    name = model_name.lower()
    order = [
        "fashionmnist", "mnist", "cifar10", "celeba", "svhn",
        "abdomenct", "breastmri", "cxr", "chestct", "hand", "headct",
    ]
    for key in order:
        if key in name:
            return OOD_DATASET_REGISTRY[key]
    if "decathlon" in name or "Task01" in model_name:
        return OOD_DATASET_REGISTRY["decathlon"]
    raise ValueError(f"Unknown dataset to select for run_dir {model_name}")


# -- tables -------------------------------------------------------------------

def read_results_csv(path) -> Table:
    """A results CSV as a table; the unnamed index column is dropped and an
    empty numeric field reads as NaN, as in pandas."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = list(reader)
    table = {}
    for j, name in enumerate(header):
        if name == "":
            continue
        vals = [r[j] for r in rows]
        if name in _TEXT_COLUMNS:
            table[name] = np.array(vals, dtype=object)
        elif name == "t":
            table[name] = np.array([int(v) for v in vals], dtype=np.int64)
        else:
            table[name] = np.array([float(v) if v else np.nan for v in vals], dtype=np.float64)
    return table


def _n_rows(table: Table) -> int:
    return len(next(iter(table.values())))


def _take(table: Table, index) -> Table:
    return {name: col[index] for name, col in table.items()}


def _concat(a: Table, b: Table) -> Table:
    """Rows of a, then of b; a column missing from one side is NaN there."""
    out = {}
    for name in list(a) + [n for n in b if n not in a]:
        cols = [t[name] if name in t else np.full(_n_rows(t), np.nan) for t in (a, b)]
        out[name] = np.concatenate(cols)
    return out


def _group_mean(table: Table, keys: Sequence[str]) -> Table:
    """Mean of every numeric column per distinct key tuple, NaN skipped (NaN
    where a group has no value), groups in sorted key order."""
    tuples = list(zip(*(table[k] for k in keys)))
    groups = sorted(set(tuples))
    where = {g: i for i, g in enumerate(groups)}
    inv = np.array([where[g] for g in tuples], dtype=np.int64)
    out: Table = {k: np.array([g[i] for g in groups], dtype=table[k].dtype)
                  for i, k in enumerate(keys)}
    for name, col in table.items():
        if name in keys or col.dtype == object:
            continue
        v = col.astype(np.float64)
        ok = ~np.isnan(v)
        sums = np.bincount(inv, weights=np.where(ok, v, 0.0), minlength=len(groups))
        counts = np.bincount(inv, weights=ok, minlength=len(groups))
        with np.errstate(invalid="ignore", divide="ignore"):
            out[name] = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    return out


def dedup(table: Table) -> Table:
    """Drop duplicate (filename, t) rows, keeping the first (DDP even-divisible
    padding artifact)."""
    seen, keep = set(), []
    for i, key in enumerate(zip(table["filename"], table["t"])):
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return _take(table, np.asarray(keep, dtype=np.int64))


def select_t(table: Table, t_values: Iterable[int]) -> Table:
    return _take(table, np.isin(table["t"], list(t_values)))


def model_evaluations(t_values: Sequence[int], num_inference_steps: int = 100) -> int:
    """Total UNet evaluations implied by the start points (reference :64-79)."""
    ts = pndm_timesteps(1000, num_inference_steps)
    return int(sum(int((ts <= t).sum()) for t in t_values))


def zscore_against_val(results: Table, val: Table,
                       targets: Sequence[str] = ("perceptual_difference", "mse")) -> Table:
    """Per-t val mean/std -> val_mean_/val_std_/z_score_<target> columns
    (reference :150-161); a t missing from val gives NaN."""
    df = dict(results)
    ts, counts = np.unique(val["t"], return_counts=True)
    thin = ts[counts < 2]
    if len(thin):
        # ddof=1 std is NaN for single-row t-groups (the reference behaves the
        # same); downstream AUROCs then silently degrade — warn loudly instead
        print(
            "WARNING: validation has <2 rows for t="
            f"{sorted(int(t) for t in thin)} — per-t std is undefined "
            "(NaN z-scores); add validation images or widen t filters"
        )
    # each result row's t among the val ts, or NaN statistics (a left merge)
    pos = np.minimum(np.searchsorted(ts, results["t"]), max(len(ts) - 1, 0))
    found = (ts[pos] == results["t"]) if len(ts) else np.zeros(len(pos), dtype=bool)
    for target in targets:
        mean = np.full(len(ts) + 1, np.nan)  # the last slot stays NaN for missing ts
        std = np.full(len(ts) + 1, np.nan)
        for i, t in enumerate(ts):
            v = val[target][val["t"] == t]
            v = v[~np.isnan(v)]
            if len(v):
                mean[i] = v.mean()
            if len(v) > 1:
                std[i] = v.std(ddof=1)
        row = np.where(found, pos, len(ts))
        df[f"val_mean_{target}"] = mean[row]
        df[f"val_std_{target}"] = std[row]
        with np.errstate(invalid="ignore", divide="ignore"):
            df[f"z_score_{target}"] = ((results[target] - df[f"val_mean_{target}"])
                                       / df[f"val_std_{target}"])
    return df


# -- metrics --------------------------------------------------------------------

def _checked(labels: Sequence[int], scores: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """(labels as 0/1 ints, scores as float64); raises like sklearn on
    non-finite scores or a missing class."""
    labels = np.asarray(labels).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    if labels.shape != scores.shape or labels.ndim != 1:
        raise ValueError(f"labels {labels.shape} and scores {scores.shape} must be 1-D and equal")
    if not np.isfinite(scores).all():
        raise ValueError("Input contains NaN or infinity.")
    if len(np.unique(labels)) != 2:
        raise ValueError("Only one class present in y_true: the metric is not defined then.")
    return labels, scores


def _clf_curve(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(false positives, true positives) at each distinct score, thresholds
    descending (sklearn's confusion_matrix_at_thresholds)."""
    order = np.argsort(scores, kind="stable")[::-1]
    s, y = scores[order], labels[order].astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(s))[0], [len(y) - 1]])
    tps = np.cumsum(y)[idx]
    return 1.0 + idx - tps, tps


def _midrank(x: np.ndarray) -> np.ndarray:
    """Midranks (average rank over ties), 1-based — the DeLong building block."""
    _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    return (np.cumsum(counts) - (counts - 1) / 2.0)[inv.reshape(-1)]


def _roc(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) of sklearn's roc_curve with drop_intermediate: points
    collinear with their neighbours dropped, (0, 0) prepended."""
    fps, tps = _clf_curve(labels, scores)
    if len(fps) > 2:
        keep = np.concatenate([[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]])
        fps, tps = fps[keep], tps[keep]
    return np.concatenate([[0.0], fps]) / fps[-1], np.concatenate([[0.0], tps]) / tps[-1]


def auroc(labels: Sequence[int], scores: Sequence[float]) -> float:
    """Area under the ROC curve, OOD (label 1) positive: the Mann-Whitney
    statistic, ties counted as 1/2. Summed as sklearn's roc_auc_score sums it,
    by trapezoids over the ROC curve, so that the float is the same."""
    fpr, tpr = _roc(*_checked(labels, scores))
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())  # numpy's trapezoid


def aupr(labels: Sequence[int], scores: Sequence[float]) -> float:
    """Average precision with OOD (label 1) as the positive class:
    sum over distinct thresholds, descending, of (R_n - R_{n-1}) P_n."""
    labels, scores = _checked(labels, scores)
    fps, tps = _clf_curve(labels, scores)
    precision = np.concatenate([(tps / (tps + fps))[::-1], [1.0]])
    recall = np.concatenate([(tps / tps[-1])[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def fpr_at_95_tpr(labels: Sequence[int], scores: Sequence[float]) -> float:
    """False-positive rate at the first point of the ROC curve reaching 95%
    true-positive rate on OOD (label 1). The curve is sklearn's roc_curve
    with drop_intermediate, so with 20 or more positives the point read can
    lie past the full curve's."""
    fpr, tpr = _roc(*_checked(labels, scores))
    return float(fpr[np.argmax(tpr >= 0.95)])


def auroc_delong_ci(labels: Sequence[int], scores: Sequence[float],
                    alpha: float = 0.05) -> Tuple[float, float, float]:
    """AUROC with a DeLong (1988) asymptotic confidence interval, computed via
    the Sun & Xu midrank formulation. Returns (auc, lo, hi) with the interval
    clipped to [0, 1].

    With perfect separation (or a single-sample class) both component
    variances are 0 and the interval degenerates to zero width; a warning
    says so, so that it is not read as zero uncertainty."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    pos = scores[labels == 1]  # OOD
    neg = scores[labels == 0]  # in-distribution
    m, n = len(pos), len(neg)
    if m == 0 or n == 0:
        raise ValueError("DeLong CI needs at least one in and one out score")
    tz = _midrank(np.concatenate([pos, neg]))
    v10 = (tz[:m] - _midrank(pos)) / n
    v01 = 1.0 - (tz[m:] - _midrank(neg)) / m
    auc = float(v10.mean())
    s10 = float(v10.var(ddof=1)) if m > 1 else 0.0
    s01 = float(v01.var(ddof=1)) if n > 1 else 0.0
    se = float(np.sqrt(s10 / m + s01 / n))
    if se == 0.0:
        warnings.warn(
            "DeLong variance is 0 (perfect separation or single-sample class):"
            f" the CI degenerates to zero width at m={m}, n={n} and understates"
            " uncertainty — do not read it as exact",
            stacklevel=2,
        )
    z = statistics.NormalDist().inv_cdf(1.0 - alpha / 2.0)
    return auc, max(0.0, auc - z * se), min(1.0, auc + z * se)


OOD_METRICS = {"auroc": auroc, "aupr": aupr, "fpr95": fpr_at_95_tpr}
# report keys with non-scalar outputs, handled specially by run_ood_detection
EXTENDED_REPORTS = ("auroc_ci",)
_LABELS = {"aupr": "AUPR", "fpr95": "FPR@95TPR"}


def compute_ood_scores(val: Table, in_df: Table, out_df: Table, plot_target: str = "mse",
                       min_t: int = 0, max_t: int = 1000) -> Dict[str, object]:
    """Full scoring for one (in, out) pair. Returns the AUROC, AUPR and
    FPR@95TPR plus the per-image mean-z table and the z-scored rows."""
    val = dedup(val)
    t_values = np.unique(val["t"])
    t_values = t_values[(t_values < max_t) & (t_values > min_t)]
    val = select_t(val, t_values)

    in_df = select_t(dedup(in_df), t_values)
    out_df = select_t(dedup(out_df), t_values)
    combined = _concat(in_df, out_df)
    # the optional likelihood and SSIM columns ride the same per-t z-score
    # machinery when present in both val and test CSVs
    targets = ["perceptual_difference", "mse"]
    if "elbo" in combined and "elbo" in val:
        targets.append("elbo")
    elif plot_target in ("elbo", "mse+elbo"):
        raise ValueError(
            f"plot_target={plot_target!r} needs an 'elbo' column in the result "
            "CSVs — rerun reconstruct.py with --score_elbo=1"
        )
    if "ssim_distance" in combined and "ssim_distance" in val:
        targets.append("ssim_distance")
    elif plot_target in ("ssim_distance", "mse+ssim"):
        raise ValueError(
            f"plot_target={plot_target!r} needs an 'ssim_distance' column in "
            "the result CSVs — rerun reconstruct.py with --score_ssim=1"
        )
    combined = zscore_against_val(combined, val, targets=targets)

    target = f"z_score_{plot_target}"
    second = {"mse+perceptual": "perceptual_difference", "mse+elbo": "elbo",
              "mse+ssim": "ssim_distance"}.get(plot_target)
    if second is not None:
        combined[target] = combined["z_score_mse"] + combined[f"z_score_{second}"]
    per_image = _group_mean(combined, ("filename", "type"))
    in_scores = per_image[target][per_image["type"] == "in"]
    out_scores = per_image[target][per_image["type"] == "out"]
    labels = np.asarray([0] * len(in_scores) + [1] * len(out_scores))
    scores = np.concatenate([in_scores, out_scores])
    return {
        "auroc": auroc(labels, scores),
        "aupr": aupr(labels, scores),
        "fpr95": fpr_at_95_tpr(labels, scores),
        "labels": labels,
        "scores": scores,
        "per_image": per_image,
        "rows": combined,
        "t_values": t_values,
        "n_in": len(set(in_df["filename"])),
        "n_out": len(set(out_df["filename"])),
        "n_val": len(set(val["filename"])),
    }


def _write_scores_csv(results: Dict[str, List], path: Path) -> None:
    """The score table as pandas' to_csv(index=False) writes it: floats in
    their shortest repr, NaN as an empty field."""
    def text(v):
        if isinstance(v, str):
            return v
        return "" if np.isnan(v) else repr(float(v))

    names = list(results)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(names)
        w.writerows([text(results[n][i]) for n in names] for i in range(len(results[names[0]])))


def run_ood_detection(
    output_dir: str,
    model_name: str,
    max_t: int = 1000,
    min_t: int = 0,
    plot_target: str = "mse",
    out_datasets: Optional[Sequence[str]] = None,
    report: str = "auroc",
) -> Dict[str, List]:
    """Driver for one model: mirrors reference main() (ood_detection.py:40-223).
    Prints the AUROCs (and the --report extras), writes
    ``ood/ood_scores_{plot_target}.csv`` and returns the same table."""
    run_dir = Path(output_dir) / model_name
    out_dir = run_dir / "ood"
    out_dir.mkdir(exist_ok=True, parents=True)
    print(f"Run directory: {run_dir}")

    val = dedup(read_results_csv(out_dir / "results_val.csv"))
    t_values = np.unique(val["t"])
    t_sel = t_values[(t_values < max_t) & (t_values > min_t)]
    total_evals = model_evaluations(t_sel)
    print(
        f"SETTING MAX_T to {max_t} with a total of {len(t_sel)} starting points "
        f"{total_evals} model evaluations"
    )
    print(f"Plot target is {plot_target}")

    if out_datasets is None:
        out_datasets = out_datasets_for_model(model_name)
    metrics = [m.strip() for m in report.split(",") if m.strip()]
    unknown = [m for m in metrics if m not in OOD_METRICS and m not in EXTENDED_REPORTS]
    if unknown:
        raise ValueError(
            f"unknown --report metric(s) {unknown}; choose from "
            f"{sorted(OOD_METRICS) + list(EXTENDED_REPORTS)}"
        )
    with_ci = "auroc_ci" in metrics
    extra = [m for m in metrics if m != "auroc" and m in OOD_METRICS]
    results = {"ood_data": [], f"Zscore_{plot_target}": []}
    for m in extra:
        results[m] = []
    if with_ci:
        results["auroc_ci_lo"] = []
        results["auroc_ci_hi"] = []
    print("z-vs-t figures are not drawn: the port does not use matplotlib")
    for out_name in out_datasets:
        in_df = read_results_csv(out_dir / "results_in.csv")
        out_df = read_results_csv(out_dir / f"results_{out_name}.csv")
        scored = compute_ood_scores(val, in_df, out_df, plot_target=plot_target,
                                    min_t=min_t, max_t=max_t)
        print(f"n_val={scored['n_val']} n_in={scored['n_in']} n_out={scored['n_out']}")
        results["ood_data"].append(out_name)
        results[f"Zscore_{plot_target}"].append(scored["auroc"])
        for m in extra:
            results[m].append(scored[m])
        if with_ci:
            _, lo, hi = auroc_delong_ci(scored["labels"], scored["scores"])
            results["auroc_ci_lo"].append(lo)
            results["auroc_ci_hi"].append(hi)

    for i, o in enumerate(results["ood_data"]):
        ci = (
            f" (95% CI [{results['auroc_ci_lo'][i] * 100:.1f}, "
            f"{results['auroc_ci_hi'][i] * 100:.1f}])"
            if with_ci
            else ""
        )
        print(f"AUC for {model_name} vs {o}: {results[f'Zscore_{plot_target}'][i] * 100:.1f}{ci}")
        for m in extra:
            print(f"{_LABELS[m]} for {model_name} vs {o}: {results[m][i] * 100:.1f}")
    print(f"Average AUC: {np.mean(results[f'Zscore_{plot_target}']) * 100:.1f}")
    for m in extra:
        print(f"Average {_LABELS[m]}: {np.mean(results[m]) * 100:.1f}")
    _write_scores_csv(results, out_dir / f"ood_scores_{plot_target}.csv")
    return results
