"""The port's OOD analytics (numpy only) against the JAX package's (pandas and
sklearn), on the CPU.

- The goldens of tests/test_ood_score.py and tests/test_auroc_ci.py, through
  the port.
- auroc, aupr and fpr_at_95_tpr against sklearn on scores with heavy ties:
  1e-12 absolute (both sum the same curve in float64; equal floats are read).
- compute_ood_scores and run_ood_detection of both packages on the same
  results CSVs (duplicates, single-row validation t-groups, t filters, the
  elbo and ssim_distance targets): the same AUROC, AUPR and FPR@95 to 1e-12,
  the same DeLong CI to 1e-12, the same per-image scores to 1e-12 relative
  (pandas sums a group's mean with Kahan summation and its std by Welford's
  method, the port in plain float64 order), and the same
  ``ood_scores_*.csv`` text.
"""

import shutil

import numpy as np
import pandas as pd
import pytest
from sklearn.metrics import average_precision_score, roc_auc_score, roc_curve

from ddpm_ood_tpu.ood import score as jscore
from ddpm_ood_tpu_torch import ood_detection as cli
from ddpm_ood_tpu_torch.ood import score

ATOL = 1e-12
OUT_NAMES = ("MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip")


def _table(filenames, types, ts, mses, percs=None, **extra):
    percs = percs if percs is not None else [0.0] * len(mses)
    cols = {"filename": np.array(filenames, dtype=object), "type": np.array(types, dtype=object),
            "t": np.array(ts, dtype=np.int64), "mse": np.array(mses, dtype=np.float64),
            "perceptual_difference": np.array(percs, dtype=np.float64)}
    cols.update({k: np.array(v, dtype=np.float64) for k, v in extra.items()})
    return cols


# -- the goldens of tests/test_ood_score.py and tests/test_auroc_ci.py ----------

def test_zscore_hand_computed():
    val = _table(["a", "b", "a", "b"], ["val"] * 4, [10, 10, 20, 20], [1.0, 3.0, 2.0, 6.0])
    rows = _table(["x", "y"], ["in", "out"], [10, 20], [3.0, 8.0])
    out = score.zscore_against_val(rows, val, targets=("mse",))
    np.testing.assert_allclose(out["z_score_mse"][0], 1.0 / np.sqrt(2.0))
    np.testing.assert_allclose(out["z_score_mse"][1], np.sqrt(2.0))


def test_dedup_keeps_first():
    out = score.dedup(_table(["a", "a", "a"], ["in"] * 3, [10, 10, 20], [1.0, 9.0, 2.0]))
    assert len(out["t"]) == 2 and out["mse"][0] == 1.0


def test_auroc_perfect_separation():
    assert score.auroc([0, 0, 1, 1], [0.1, 0.2, 0.8, 0.9]) == 1.0
    assert score.auroc([0, 0, 1, 1], [0.9, 0.8, 0.1, 0.2]) == 0.0


def test_compute_ood_scores_end_to_end():
    rng = np.random.default_rng(0)
    ts = [100, 300, 500]

    def rows(prefix, typ, n, mu):
        r = [(f"{prefix}{i}", typ, t, rng.normal(mu, 0.1)) for i in range(n) for t in ts]
        return _table(*zip(*r))

    result = score.compute_ood_scores(rows("v", "val", 20, 1.0), rows("i", "in", 10, 1.0),
                                      rows("o", "out", 10, 3.0))
    assert result["auroc"] == 1.0
    assert (result["n_in"], result["n_out"], result["n_val"]) == (10, 10, 20)


def test_max_t_filter():
    ts = [100, 900]
    val = _table(["a", "a", "b", "b"], ["val"] * 4, ts * 2, [1.0, 1.0, 1.5, 1.5])
    res = score.compute_ood_scores(val, _table(["i"] * 2, ["in"] * 2, ts, [1.0, 1.0]),
                                   _table(["o"] * 2, ["out"] * 2, ts, [2.0, 2.0]), max_t=500)
    assert list(res["t_values"]) == [100]


@pytest.mark.parametrize("model,first", [("fashionmnist_run", "MNIST"),
                                         ("mnist_run", "FashionMNIST"),
                                         ("FashionMNIST_big", "MNIST"), ("cifar10_big", "SVHN")])
def test_registry_precedence(model, first):
    assert score.out_datasets_for_model(model)[0] == first
    assert score.out_datasets_for_model(model) == jscore.out_datasets_for_model(model)


def test_registry_contents():
    assert score.OOD_DATASET_REGISTRY == jscore.OOD_DATASET_REGISTRY
    assert "CelebA" in score.out_datasets_for_model("cifar10_big")
    assert len(score.out_datasets_for_model("decathlon_task01")) == 9
    assert "AbdomenCT" not in score.out_datasets_for_model("abdomenct_x")
    with pytest.raises(ValueError, match="Unknown dataset"):
        score.out_datasets_for_model("unknown_model")


def test_model_evaluations_counting():
    assert score.model_evaluations([990]) == 101
    assert score.model_evaluations([0]) == 1
    assert score.model_evaluations([10]) == 2


def test_aupr_and_fpr95_hand_computed():
    labels = [0, 0, 0, 1, 1, 1]
    assert score.aupr(labels, [0.1, 0.2, 0.3, 0.7, 0.8, 0.9]) == 1.0
    assert score.fpr_at_95_tpr(labels, [0.1, 0.2, 0.3, 0.7, 0.8, 0.9]) == 0.0
    assert score.fpr_at_95_tpr([0, 0, 1, 1], [0.5, 0.6, 0.9, 0.1]) == 1.0
    np.testing.assert_allclose(score.aupr([0, 0, 1, 1], [0.5, 0.6, 0.9, 0.1]), 0.75)


def _naive_delong(labels, scores, alpha=0.05):
    """Direct double-loop DeLong (tests/test_auroc_ci.py)."""
    import statistics

    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    pos, neg = scores[labels == 1], scores[labels == 0]
    psi = (pos[:, None] > neg[None]) + 0.5 * (pos[:, None] == neg[None])
    var = psi.mean(axis=1).var(ddof=1) / len(pos) + psi.mean(axis=0).var(ddof=1) / len(neg)
    z = statistics.NormalDist().inv_cdf(1 - alpha / 2)
    auc = psi.mean()
    return float(auc), max(0.0, auc - z * np.sqrt(var)), min(1.0, auc + z * np.sqrt(var))


@pytest.mark.parametrize("trial", range(3))
def test_delong_matches_naive_transcription(trial):
    rng = np.random.default_rng(trial)
    scores = np.round(np.concatenate([rng.normal(0, 1, 17), rng.normal(1.2, 1.5, 23)]), 1)
    labels = np.array([0] * 17 + [1] * 23)
    got = score.auroc_delong_ci(labels, scores)
    np.testing.assert_allclose(got, _naive_delong(labels, scores), atol=ATOL)
    np.testing.assert_allclose(got, jscore.auroc_delong_ci(labels, scores), atol=ATOL)


def test_delong_perfect_separation_warns_and_needs_both_classes():
    with pytest.warns(UserWarning, match="zero width"):
        auc, lo, hi = score.auroc_delong_ci([0, 0, 0, 1, 1, 1], [0.0, 0.1, 0.2, 5.0, 6.0, 7.0])
    assert auc == lo == hi == 1.0
    with pytest.raises(ValueError, match="at least one"):
        score.auroc_delong_ci([1, 1], [0.1, 0.2])


def test_thin_validation_t_group_warns(capsys):
    val = _table(["v1", "v2", "v3"], ["val"] * 3, [100, 100, 200], [0.1, 0.2, 0.15])
    out = score.zscore_against_val(_table(["i1"], ["in"], [200], [0.5]), val, targets=("mse",))
    captured = capsys.readouterr().out
    assert "t=[200]" in captured and "WARNING" in captured
    assert np.isnan(out["z_score_mse"]).all()


# -- the metrics against sklearn -------------------------------------------------

def _tied_scores(seed):
    """Heavy ties: scores on a grid of 6 values (of 2 at seed 3), 12 to 92
    of them (from seed 2 on, over 20 positives: FPR@95 can fall between
    thresholds)."""
    rng = np.random.default_rng(seed)
    n = 12 + 20 * seed
    labels = (rng.uniform(size=n) > 0.4).astype(int)
    labels[:2] = [0, 1]
    grid = 6 if seed != 3 else 2
    scores = np.round(rng.uniform(size=n) * (grid - 1)) / (grid - 1) + 0.3 * labels
    return labels, np.round(scores, 1)


@pytest.mark.parametrize("seed", range(5))
def test_metrics_match_sklearn_on_ties(seed):
    labels, scores = _tied_scores(seed)
    assert abs(score.auroc(labels, scores) - roc_auc_score(labels, scores)) <= ATOL
    assert abs(score.aupr(labels, scores) - average_precision_score(labels, scores)) <= ATOL
    fpr, tpr, _ = roc_curve(labels, scores)
    assert score.fpr_at_95_tpr(labels, scores) == fpr[np.argmax(tpr >= 0.95)]


def test_fpr95_reads_the_curve_with_collinear_points_dropped():
    """40 positives, 20 negatives: 37 positives on top, then three thresholds
    each adding one positive and one negative. Those points are collinear, so
    sklearn's roc_curve drops the two inner ones and 95% TPR is first reached
    at FPR 0.15; the full curve would reach it at 0.05."""
    labels = np.array([1] * 37 + [1, 0] * 3 + [0] * 17)
    scores = np.array([10.0] * 37 + [9, 9, 8, 8, 7, 7] + [1.0] * 17)
    fpr, tpr, _ = roc_curve(labels, scores)
    assert fpr[np.argmax(tpr >= 0.95)] == 0.15
    assert score.fpr_at_95_tpr(labels, scores) == 0.15
    assert jscore.fpr_at_95_tpr(labels, scores) == 0.15


@pytest.mark.parametrize("bad", [[0.1, np.nan, 0.3, 0.4], [0.1, np.inf, 0.3, 0.4]])
def test_non_finite_scores_raise_like_sklearn(bad):
    with pytest.raises(ValueError):
        roc_auc_score([0, 0, 1, 1], bad)
    for fn in (score.auroc, score.aupr, score.fpr_at_95_tpr):
        with pytest.raises(ValueError, match="NaN or infinity"):
            fn([0, 0, 1, 1], bad)


# -- both packages on the same CSVs ------------------------------------------------

def _rows(rng, prefix, typ, n, ts, mu, dup=0, ssim=True, elbo=True):
    rows = []
    for i in range(n):
        for t in ts:
            r = {"filename": f"{prefix}{i}", "type": typ, "t": t,
                 # perceptual rounded to 2 decimals: ties between images
                 "perceptual_difference": round(float(rng.normal(mu, 0.3)), 2),
                 "mse": float(rng.gamma(2.0, mu / 2))}
            if elbo:
                r["elbo"] = float(rng.normal(mu, 1.0))
            if ssim:
                r["ssim_distance"] = float(rng.uniform(0.1, 0.2) * mu)
            rows.append(r)
    rows += [dict(rows[j], mse=99.0) for j in range(dup)]  # duplicates: the first is kept
    return pd.DataFrame(rows)


def _write_run(root, model="cmp_fashionmnist", thin_t=None, missing_t=None, seed=0):
    """Results CSVs as the JAX package writes them (DataFrame.to_csv with
    its index): val with one single-row t-group (`thin_t`) and one t absent
    from the test sets' val (`missing_t`), in/out with duplicates."""
    rng = np.random.default_rng(seed)
    ts = [40, 120, 200, 480, 760]
    ood = root / model / "ood"
    ood.mkdir(parents=True)
    val = _rows(rng, "v", "val", 6, [t for t in ts if t != missing_t], 1.0)
    if thin_t is not None:
        val = pd.concat([val[val["t"] != thin_t], val[val["t"] == thin_t].iloc[:1]])
    val.to_csv(ood / "results_val.csv")
    _rows(rng, "i", "in", 7, ts, 1.0, dup=3).to_csv(ood / "results_in.csv")
    for k, name in enumerate(OUT_NAMES):
        _rows(rng, "o", "out", 5 + k, ts, 1.0 + 0.4 * k, dup=2).to_csv(ood / f"results_{name}.csv")
    return model


TARGETS = ["mse", "perceptual_difference", "mse+perceptual", "elbo", "mse+elbo",
           "ssim_distance", "mse+ssim"]


@pytest.mark.parametrize("target", TARGETS)
def test_compute_ood_scores_matches_jax(tmp_path, target):
    model = _write_run(tmp_path, thin_t=120, missing_t=760)
    ood = tmp_path / model / "ood"
    read = {n: score.read_results_csv(ood / f"results_{n}.csv") for n in ("val", "in", "MNIST")}
    frames = {n: pd.read_csv(ood / f"results_{n}.csv") for n in read}
    for kw in ({}, {"min_t": 40, "max_t": 700}):
        got = score.compute_ood_scores(read["val"], read["in"], read["MNIST"], target, **kw)
        want = jscore.compute_ood_scores(frames["val"], frames["in"], frames["MNIST"], target,
                                         **kw)
        for key in ("auroc", "aupr", "fpr95"):
            assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])
        np.testing.assert_array_equal(got["t_values"], want["t_values"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=ATOL, atol=0)
        assert [got[k] for k in ("n_in", "n_out", "n_val")] == [
            want[k] for k in ("n_in", "n_out", "n_val")]
        rows = want["rows"]
        np.testing.assert_allclose(got["rows"][f"z_score_{target}"],
                                   rows[f"z_score_{target}"].to_numpy(), rtol=1e-12, atol=0)


def test_missing_column_targets_raise(tmp_path):
    val = _table(["a", "b"], ["val"] * 2, [10, 10], [1.0, 2.0])
    for target, flag in (("elbo", "--score_elbo"), ("mse+ssim", "--score_ssim")):
        with pytest.raises(ValueError, match=flag):
            score.compute_ood_scores(val, val, val, target)


@pytest.mark.parametrize("target", ["mse", "mse+perceptual", "ssim_distance"])
def test_run_ood_detection_matches_jax(tmp_path, capsys, target):
    model = _write_run(tmp_path, thin_t=200, seed=1)
    report = "auroc,aupr,fpr95,auroc_ci"
    want = jscore.run_ood_detection(str(tmp_path), model, plot_target=target, save_plots=False,
                                    report=report)
    csv_path = tmp_path / model / "ood" / f"ood_scores_{target}.csv"
    want_csv = csv_path.read_text()
    jax_out = capsys.readouterr().out
    got = cli.main([f"--output_dir={tmp_path}", f"--model_name={model}",
                    f"--plot_target={target}", f"--report={report}"])[model]
    port_out = capsys.readouterr().out
    assert list(got) == list(want) and got["ood_data"] == want["ood_data"] == list(OUT_NAMES)
    for key in list(want)[1:]:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0)
    assert csv_path.read_text() == want_csv
    # the printed lines agree wherever the JAX package prints the same thing
    assert [ln for ln in port_out.splitlines() if "AUC" in ln or "AUPR" in ln] == [
        ln for ln in jax_out.splitlines() if "AUC" in ln or "AUPR" in ln]
    assert "t=[200]" in port_out


def test_cli_loops_over_models_and_checks_csvs_first(tmp_path):
    a = _write_run(tmp_path, model="a_fashionmnist", seed=2)
    b = _write_run(tmp_path, model="b_fashionmnist", seed=3)
    got = cli.main([f"--output_dir={tmp_path}", f"--model_name={a},{b}"])
    assert list(got) == [a, b] and all(len(r["Zscore_mse"]) == 3 for r in got.values())
    # the CSV existence check runs before the registry lookup
    with pytest.raises(FileNotFoundError, match="results_val.csv"):
        cli.main([f"--output_dir={tmp_path}", "--model_name=unknown_model"])
    shutil.rmtree(tmp_path / "unknown_model")
    shutil.copytree(tmp_path / a, tmp_path / "unknown_model")
    with pytest.raises(ValueError, match="Unknown dataset"):
        cli.main([f"--output_dir={tmp_path}", "--model_name=unknown_model"])
    with pytest.raises(ValueError, match="unknown --report"):
        cli.main([f"--output_dir={tmp_path}", f"--model_name={b}", "--report=f1"])
