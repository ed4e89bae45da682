"""The port's quality gate (``python -m ddpm_ood_tpu_torch.quality_check``)
against the JAX package's ``scripts/quality_check.py``, on the CPU.

- ``compare_quality``: the regression rule with injected AUROC drops, as in
  tests/test_quality_gate.py, and the same printed lines as the JAX script's
  on the same inputs;
- ``make_dataset``: the same images (bit for bit) and split files from the
  same numpy generator;
- a tiny end-to-end run (2 epochs of 32 8x8 images, 8 images per evaluation
  set, a 10-step grid, PLMS and DPM-Solver++) writes the JSON schema of the
  JAX script, with finite AUROCs in [0, 1];
- the flags that are not ported raise NotImplementedError naming the flag.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch import quality_check as qc

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "quality_check_jax_twin", REPO / "scripts" / "quality_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _payload(hard_auroc: float, half: float, label: str = "plms") -> dict:
    return {"per_sampler": {label: {
        "easy": {"auroc": 1.0, "auroc_ci": [1.0, 1.0]},
        "hard": {"auroc": hard_auroc, "auroc_ci": [hard_auroc - half, hard_auroc + half]}}}}


@pytest.mark.parametrize("prev,cur,trips", [
    ((0.96, 0.01), (0.94, 0.01), True),       # a 2-point drop at the pinned precision
    ((0.96, 0.01), (0.95, 0.01), False),      # 1 point < hypot(1, 1) = 1.41 points
    ((0.90, 0.01), (0.99, 0.01), False),      # an improvement never trips
    ((0.9658, 0.0266), (0.9158, 0.01), True),  # against a wide r4 CI, a 5-point drop
    ((0.9483, 0.0090), (0.9400, 0.0090), False),  # QUALITY_r05 plms/hard, within its band
])
def test_compare_quality_flags_injected_drops_as_the_jax_script(prev, cur, trips):
    lines, regressions = qc.compare_quality(_payload(*prev), _payload(*cur)["per_sampler"])
    assert bool(regressions) == trips, lines
    assert all("hard" in r for r in regressions)
    assert len(lines) == 2
    assert (lines, regressions) == _jax_script().compare_quality(
        _payload(*prev), _payload(*cur)["per_sampler"])


def test_compare_quality_without_an_old_ci_uses_the_current_width():
    prev = {"per_sampler": {"plms": {"easy": {"auroc": 1.0}, "hard": {"auroc": 0.96}}}}
    _, regressions = qc.compare_quality(prev, _payload(0.93, 0.01)["per_sampler"])
    assert regressions


def test_make_dataset_draws_the_jax_scripts_images(tmp_path):
    jax_make = _jax_script().make_dataset
    for root, make in ((tmp_path / "jax", jax_make), (tmp_path / "port", qc.make_dataset)):
        rng = np.random.default_rng(0)
        make(root, "train", 6, 16, rng)
        make(root, "outset", 3, 16, rng, kind="ood")
        make(root, "nearset", 3, 16, rng, kind="near", near_freq=3.0)
    for name, n in (("train", 6), ("outset", 3), ("nearset", 3)):
        got = (tmp_path / "port" / f"{name}.csv").read_text()
        want = (tmp_path / "jax" / f"{name}.csv").read_text()
        assert got == want.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
        for i in range(n):
            a = np.load(tmp_path / "port" / name / f"{name}_{i}.npy")
            b = np.load(tmp_path / "jax" / name / f"{name}_{i}.npy")
            assert a.dtype == b.dtype == np.float32 and a.shape == (1, 16, 16)
            np.testing.assert_array_equal(a, b)


def test_pinned_settings_and_sampler_subsets():
    args = qc.parse_args(["--pinned", "--epochs=3", "--n_eval=5"])
    assert (args.epochs, args.size, args.n_train, args.steps, args.skip) == (80, 16, 32, 100, 4)
    assert (args.near_freq, args.n_eval, args.samplers) == (3.0, 1024, "plms,dpm@25/1,ddim@25/1")
    assert not (args.simplex or args.elbo or args.ssim) and args.quantize == "none"
    assert qc.parse_args(["--pinned", "--samplers=dpm@25/1"]).samplers == "dpm@25/1"
    assert qc.parse_args([]).samplers == "plms"
    with pytest.raises(SystemExit):
        qc.parse_args(["--pinned", "--samplers=plms_ref"])


@pytest.mark.parametrize("flag,name", [("--quantize=int8", "--quantize")])
def test_unported_flags_raise(flag, name, monkeypatch):
    """--quantize in more than one process: the quality gate runs one
    process, as its JAX script does (tests/test_torch_quant_cli.py runs the
    quantised variant in one)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="more than one process .*quality gate"):
        qc.main(["--device=cpu", flag])


@pytest.mark.parametrize("flag", ["--simplex"])
def test_simplex_is_served(flag):
    """The gate trains and scores with exact simplex noise
    (tests/test_torch_simplex_train.py runs it at a tiny size)."""
    args = qc.parse_args(["--device=cpu", flag])
    assert args.simplex and not qc.parse_args(["--pinned", flag]).simplex


def test_tiny_run_writes_the_jax_schema(tmp_path, capsys):
    out = tmp_path / "quality.json"
    payload = qc.main(["--device=cpu", "--epochs=2", "--size=8", "--n_eval=8", "--steps=10",
                       "--skip=2", "--samplers=plms,dpm@10/1", f"--workdir={tmp_path / 'w'}",
                       f"--out={out}"])
    assert json.loads(out.read_text()) == payload
    printed = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert json.loads(printed[-1]) == payload
    pinned = json.loads((REPO / "QUALITY_r05.json").read_text())
    assert set(pinned) <= set(payload)
    assert set(pinned["config"]) <= set(payload["config"])
    assert payload["backend"] == "cpu" and payload["config"]["recon_groups"] == "auto"
    assert list(payload["per_sampler"]) == ["plms", "dpm@10/1"]
    for label, entry in payload["per_sampler"].items():
        assert set(entry) == {"easy", "hard"}
        for task in entry.values():
            assert set(task) == set(pinned["per_sampler"]["plms"]["hard"])
            assert 0.0 <= task["auroc"] <= 1.0 and len(task["auroc_ci"]) == 2
        timing = payload["timing"][label]
        assert timing["batches"] == 4 and timing["recons_per_s"] > 0
    # 5 start points of the 10-step PLMS grid at skip 2; 9 of the DPM grid at skip 1
    assert payload["timing"]["plms"]["recons"] == 4 * 8 * 5
    assert payload["timing"]["dpm@10/1"]["recons"] == 4 * 8 * 9
    assert payload["value"] == payload["per_sampler"]["plms"]["hard"]["auroc"]


def test_checkpoint_is_scored_instead_of_trained(tmp_path):
    from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "given.pth", model.state_dict())
    payload = qc.main(["--device=cpu", "--size=8", "--n_eval=4", "--steps=10", "--skip=5",
                       "--samplers=dpm@10/5", f"--checkpoint={tmp_path / 'given.pth'}",
                       f"--workdir={tmp_path / 'w'}"])
    run = tmp_path / "w" / "output" / "quality_fashionmnist"
    assert sorted(p.name for p in run.glob("*.pth")) == ["checkpoint.pth"]  # nothing trained
    assert payload["timing"]["train_s"] is None
    assert payload["config"]["checkpoint"] == str(tmp_path / "given.pth")
    assert 0.0 <= payload["per_sampler"]["dpm@10/5"]["hard"]["auroc"] <= 1.0
