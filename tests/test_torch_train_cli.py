"""The port's training CLI on the CPU, end to end, and its refusals.

``python -m ddpm_ood_tpu_torch.train_ddpm --device=cpu`` on a synthetic
16x16 set with the tiny preset: 2 epochs of 3 batches (the last one ragged),
validation with the sample grid at epoch 2, then a resume. Checked: the
reference checkpoint schema, the best-on-train-loss / periodic policy,
``epoch`` and ``global_step`` (images) across the resume, the logs, the
scoring CLI loading the trained checkpoint, SIGTERM's graceful stop, and
every flag the port does not serve raising NotImplementedError (latent
diffusion training is tests/test_torch_ldm_train.py's).
"""

import json
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch import reconstruct as score_cli
from ddpm_ood_tpu_torch import train_ddpm as cli
from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv
from ddpm_ood_tpu_torch.trainers.ddpm_trainer import DDPMTrainer

MODEL = "train_fashionmnist"
SCHEMA = {"epoch", "global_step", "model_state_dict", "optimizer_state_dict", "best_loss"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_train_set(root: Path, n_train: int = 10, n_val: int = 4) -> dict:
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    csvs = {}
    for name, n in (("train", n_train), ("val", n_val)):
        d = root / name
        d.mkdir(parents=True)
        paths = []
        for i in range(n):
            phase = rng.uniform(0, 2 * np.pi)
            img = (0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) / 16 + phase)).astype(np.float32)
            paths.append(str(d / f"{name}_{i}.npy"))
            np.save(paths[-1], img[None])
        csvs[name] = str(root / f"{name}.csv")
        write_split_csv(paths, csvs[name])
    return csvs


def train_argv(root: Path, *extra) -> list:
    csvs = make_train_set(root) if not (root / "train.csv").exists() else {
        "train": str(root / "train.csv"), "val": str(root / "val.csv")}
    return ["--device=cpu", f"--output_dir={root / 'output'}", f"--model_name={MODEL}",
            f"--training_ids={csvs['train']}", f"--validation_ids={csvs['val']}",
            "--image_size=16", "--model_type=tiny", "--is_grayscale=1", "--batch_size=4",
            "--n_epochs=2", "--eval_freq=2", "--checkpoint_every=2", "--num_workers=2",
            "--learning_rate=1e-3", "--beta_schedule=scaled_linear_beta",
            "--beta_start=0.0015", "--beta_end=0.0195", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    trainer = cli.main(train_argv(root))
    return root, trainer


def test_checkpoints_in_the_reference_schema(trained):
    root, trainer = trained
    run = root / "output" / MODEL
    assert sorted(p.name for p in run.glob("*.pth")) == ["checkpoint.pth", "checkpoint_2.pth"]
    periodic = torch.load(run / "checkpoint_2.pth", weights_only=True)
    assert set(periodic) == SCHEMA
    assert periodic["epoch"] == 2 and periodic["global_step"] == 20  # 10 images x 2 epochs
    opt = periodic["optimizer_state_dict"]
    assert {int(s["step"]) for s in opt["state"].values()} == {6}  # 3 batches x 2 epochs
    assert opt["param_groups"][0]["betas"] == (0.9, 0.999) and opt["param_groups"][0]["eps"] == 1e-8
    best = torch.load(run / "checkpoint.pth", weights_only=True)
    assert set(best) == SCHEMA and best["best_loss"] == pytest.approx(trainer.best_loss)
    state = trainer.unet.state_dict()
    assert all(torch.equal(periodic["model_state_dict"][k], state[k]) for k in state)


def test_logs_and_sample_grid(trained):
    root, trainer = trained
    run = root / "output" / MODEL
    train = [json.loads(line) for line in (run / "train" / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in train] == [4, 8, 10, 14, 18, 20]  # images, ragged last batch
    assert all(r["tag"] == "loss" and np.isfinite(r["value"]) for r in train)
    val = [json.loads(line) for line in (run / "val" / "scalars.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["step"]) for r in val] == [("loss", 20)]
    grid = np.load(run / "val" / "samples_20.npy")
    assert grid.shape == (4, 16, 16, 1) and grid.min() >= 0.0 and grid.max() <= 1.0
    assert trainer.sample_forwards == 1000
    assert trainer.step.forwards == 6 + 1 and trainer.step.backwards == 6


def test_resume_continues_epoch_and_step(trained, tmp_path):
    root, _ = trained
    resumed = cli.main(train_argv(root, "--n_epochs=3", "--eval_freq=100",
                                  "--ddpm_checkpoint_epoch=2"))
    assert resumed.start_epoch == 2
    assert resumed.global_step == 30 and resumed.step.updates == 9
    assert resumed.step.backwards == 3  # one epoch of training after the resume


def test_scoring_cli_loads_the_trained_checkpoint(trained):
    root, trainer = trained
    args = score_cli.parse_args([
        "--device=cpu", f"--output_dir={root / 'output'}", f"--model_name={MODEL}",
        f"--validation_ids={root / 'val.csv'}", f"--in_ids={root / 'val.csv'}",
        "--image_size=16", "--model_type=tiny", "--is_grayscale=1", "--batch_size=4",
        "--ddpm_checkpoint_epoch=2"])
    recon = score_cli.Reconstruct(args, torch.device("cpu"))
    want = torch.load(root / "output" / MODEL / "checkpoint_2.pth", weights_only=True)
    got = recon.unet.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want["model_state_dict"].items())


def test_ema_slot_and_quick_test(tmp_path):
    trainer = cli.main(train_argv(tmp_path, "--ema_decay=0.9", "--quick_test=1", "--n_epochs=1",
                                  "--eval_freq=100", "--checkpoint_every=1"))
    assert trainer.global_step == 4  # one batch
    payload = torch.load(tmp_path / "output" / MODEL / "checkpoint_1.pth", weights_only=True)
    assert set(payload) == SCHEMA | {"ema_model_state_dict"}
    assert sorted(payload["ema_model_state_dict"]) == sorted(payload["model_state_dict"])


def test_sigterm_checkpoints_the_epoch_and_stops(tmp_path, monkeypatch):
    epoch_fn = DDPMTrainer.train_epoch

    def preempted(self, epoch):
        os.kill(os.getpid(), signal.SIGTERM)  # arrives mid-epoch; the epoch finishes
        return epoch_fn(self, epoch)

    monkeypatch.setattr(DDPMTrainer, "train_epoch", preempted)
    before = signal.getsignal(signal.SIGTERM)
    trainer = cli.main(train_argv(tmp_path, "--n_epochs=5", "--eval_freq=100",
                                  "--checkpoint_every=100"))
    assert trainer.global_step == 10  # one epoch
    payload = torch.load(tmp_path / "output" / MODEL / "checkpoint_1.pth", weights_only=True)
    assert payload["epoch"] == 1
    assert signal.getsignal(signal.SIGTERM) == before  # the guard put the old handler back


@pytest.mark.parametrize("flag", ["--simplex_noise=1", "--remat=1", "--profile_dir=prof",
                                  "--fsdp=1"])
def test_simplex_remat_and_profile_flags_are_served(flag):
    """The CLI refuses none of them: tests/test_torch_simplex_train.py,
    test_torch_remat.py and test_torch_fsdp.py run them."""
    name, value = flag[2:].split("=")
    assert str(getattr(cli.parse_args(["--device=cpu", "--model_name=m", flag]), name)) == value


def test_more_than_one_process_raises(tmp_path, monkeypatch):
    """More than one process is served under torchrun (tests/test_torch_ddp.py);
    WORLD_SIZE without torchrun's rendezvous environment is an error that
    names the launcher, not a silent single-process run."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for key in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="more than one process .*torch.distributed.run"):
        cli.main(["--device=cpu", f"--output_dir={tmp_path}", "--model_name=m"])


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([f"--output_dir={tmp_path}", "--model_name=m"])  # --device defaults to cuda


def test_batch_not_divisible_by_grad_accum_raises(tmp_path):
    with pytest.raises(ValueError, match="not divisible"):
        cli.main(train_argv(tmp_path, "--grad_accum_steps=3"))
