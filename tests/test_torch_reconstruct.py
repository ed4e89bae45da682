"""The port's scoring CLI on the CPU, end to end, and its refusals.

``python -m ddpm_ood_tpu_torch.reconstruct --device=cpu`` on a synthetic
16x16 set with a tiny-preset checkpoint writes the five results CSVs that
the JAX pipeline writes; ``pd.read_csv`` reads them with the JAX column set,
and ``ddpm_ood_tpu.ood.run_ood_detection`` scores them unchanged. Flags the
slice does not serve raise NotImplementedError naming the flag.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from ddpm_ood_tpu.data.csv_splits import write_split_csv
from ddpm_ood_tpu.ood import run_ood_detection
from ddpm_ood_tpu_torch import reconstruct as cli
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.trainers.reconstruct import COLUMNS, _CsvSink
from ddpm_ood_tpu_torch.utils.checkpoint import find_checkpoint, save_checkpoint

MODEL = "port_fashionmnist"
OUT_NAMES = ["MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(root: Path, name: str, n: int, ood: bool, rng) -> str:
    """In-distribution: smooth sine fields; OOD: checkerboards (the
    generator of tests/test_e2e.py)."""
    d = root / name
    d.mkdir(parents=True)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    paths = []
    for i in range(n):
        if ood:
            img = ((xx + yy + i) % 2).astype(np.float32)[None]
        else:
            phase = rng.uniform(0, 2 * np.pi)
            img = (0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) / 16 + phase)).astype(np.float32)[None]
        paths.append(str(d / f"{name}_{i}.npy"))
        np.save(paths[-1], img)
    write_split_csv(paths, str(root / f"{name}.csv"))
    return str(root / f"{name}.csv")


def make_synthetic_run(root: Path) -> list:
    """Data splits plus a seeded tiny checkpoint.pth; returns the CLI argv."""
    rng = np.random.default_rng(0)
    val = _split(root, "val", 4, False, rng)
    ins = _split(root, "FashionMNIST_test", 4, False, rng)
    out = _split(root, "MNIST_test", 4, True, rng)
    run = root / "output" / MODEL
    run.mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(run / "checkpoint.pth", model.state_dict(), epoch=3)
    return [
        "--device=cpu", f"--output_dir={root / 'output'}", f"--model_name={MODEL}",
        f"--validation_ids={val}", f"--in_ids={ins}",
        f"--out_ids={out},{ins}_vflip,{ins}_hflip",
        "--image_size=16", "--model_type=tiny", "--is_grayscale=1", "--batch_size=4",
        "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195",
        "--num_inference_steps=10", "--inference_skip_factor=3", "--num_workers=2",
    ]


@pytest.fixture(scope="module")
def scored_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    argv = make_synthetic_run(root)
    recon = cli.main(argv)
    return root, argv, recon


def test_cli_writes_the_jax_results_csvs(scored_run):
    root, _, recon = scored_run
    ood = root / "output" / MODEL / "ood"
    names = sorted(p.name for p in ood.glob("results_*.csv"))
    assert names == sorted(f"results_{n}.csv" for n in ["val", "in"] + OUT_NAMES)
    assert not list(ood.glob(".*partial*"))
    for name in names:
        df = pd.read_csv(ood / name)
        assert list(df.columns) == ["Unnamed: 0", *COLUMNS]  # the JAX files' layout
        assert len(df) == 4 * 4 and df["filename"].nunique() == 4
        assert sorted(df["t"].unique()) == sorted(recon._program(3).t_starts)
        assert np.isfinite(df["mse"]).all() and (df["perceptual_difference"] == 0.0).all()


def test_ood_detection_scores_the_port_csvs(scored_run):
    root, _, _ = scored_run
    results = run_ood_detection(str(root / "output"), MODEL, plot_target="mse",
                                save_plots=False, out_datasets=OUT_NAMES)
    aurocs = results["Zscore_mse"]
    assert results["ood_data"] == OUT_NAMES
    assert len(aurocs) == 3 and all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aurocs)


def test_kernels_not_launched_on_cpu(scored_run):
    from ddpm_ood_tpu_torch.ops.attention import flash_attention_fwd
    from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

    _, _, recon = scored_run
    assert sum(p.model_evals for p in recon._programs.values()) > 0
    assert groupnorm_act.launches == 0 and flash_attention_fwd.launches == 0


def test_csv_sink_output_equals_pandas_to_csv(tmp_path):
    rows = [{"filename": f"img_{i}", "type": "out", "t": 10 * i,
             "perceptual_difference": 0.0, "mse": 0.1 / (i + 3)} for i in range(5)]
    sink = _CsvSink(tmp_path, "x")
    sink.append(rows[:2])
    sink.append(rows[2:])
    path = sink.finalize()
    pd.DataFrame(rows).to_csv(tmp_path / "pandas.csv")
    assert path.read_text() == (tmp_path / "pandas.csv").read_text()


REFUSED = [
    ("--sampler=ddim", "--sampler"), ("--sampler=plms_ref", "--sampler"),
    ("--score_elbo=1", "--score_elbo"), ("--score_ssim=1", "--score_ssim"),
    ("--save_error_maps=1", "--save_error_maps"), ("--simplex_noise=1", "--simplex_noise"),
    ("--quantize=int8", "--quantize"), ("--aot_cache=/tmp/aot", "--aot_cache"),
    ("--profile_dir=prof", "--profile_dir"), ("--resume=1", "--resume"),
    ("--spatial_dimension=3", "--spatial_dimension"),
    ("--vqvae_checkpoint=vq/checkpoint.pth", "--vqvae_checkpoint"),
    ("--latent_pad=(0,0,1,1)", "--latent_pad"), ("--remat=1", "--remat"),
]


@pytest.mark.parametrize("flag,name", REFUSED)
def test_unported_flags_raise(tmp_path, flag, name):
    argv = ["--device=cpu", f"--output_dir={tmp_path}", "--model_name=m", flag]
    with pytest.raises(NotImplementedError, match=name):
        cli.main(argv)


def test_more_than_one_process_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="more than one process"):
        cli.main(["--device=cpu", f"--output_dir={tmp_path}", "--model_name=m"])


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([f"--output_dir={tmp_path}", "--model_name=m"])  # --device defaults to cuda


def test_missing_checkpoint_names_orbax_dirs(tmp_path):
    (tmp_path / "m" / "checkpoint").mkdir(parents=True)  # a JAX package Orbax checkpoint
    with pytest.raises(FileNotFoundError, match="Orbax"):
        cli.main(["--device=cpu", f"--output_dir={tmp_path}", "--model_name=m"])


@pytest.mark.parametrize("present,epoch,want", [
    (["checkpoint.pth", "checkpoint_5.pth", "checkpoint_12.pth"], None, "checkpoint.pth"),
    (["checkpoint_5.pth", "checkpoint_12.pth"], None, "checkpoint_12.pth"),
    (["checkpoint.pth", "checkpoint_5.pth"], 5, "checkpoint_5.pth"),
    (["checkpoint.pth"], 7, None),
    ([], None, None),
])
def test_find_checkpoint_order(tmp_path, present, epoch, want):
    for name in present:
        (tmp_path / name).write_bytes(b"")
    got = find_checkpoint(tmp_path, epoch)
    assert (got.name if got else None) == want


def test_use_ema_loads_the_ema_weights(tmp_path):
    argv = make_synthetic_run(tmp_path)
    ckpt = tmp_path / "output" / MODEL / "checkpoint.pth"
    payload = torch.load(ckpt, weights_only=True)
    ema = {k: v + 1.0 for k, v in payload["model_state_dict"].items()}
    save_checkpoint(ckpt, payload["model_state_dict"], ema_model_state_dict=ema)
    args = cli.parse_args(argv + ["--use_ema=1"])
    recon = cli.Reconstruct(args, torch.device("cpu"))
    got = recon.unet.state_dict()
    assert all(torch.equal(got[k], ema[k]) for k in ema)

    save_checkpoint(ckpt, payload["model_state_dict"])  # no EMA slot
    with pytest.raises(RuntimeError, match="ema_model_state_dict"):
        cli.Reconstruct(args, torch.device("cpu"))
