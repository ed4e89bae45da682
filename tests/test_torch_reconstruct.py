"""The port's scoring CLI on the CPU, end to end, against the JAX CLI, and
its refusals.

``ddpm_ood_tpu_torch.reconstruct`` on a synthetic 16x16 set with a tiny-preset
checkpoint, an LPIPS npz in the JAX package's key schema and
``--score_ssim=1 --save_error_maps=1`` writes the five results CSVs and the
error maps that the JAX pipeline writes. The JAX package's ``Reconstruct``
scores the same images with the same weights (the checkpoint converted by
its ``torch_to_flax_unet``), the same npz and the same noise draw (both
programs take it from one host function), and the two agree column for
column. ``pd.read_csv`` reads the port's CSVs with the JAX column set, and
``ddpm_ood_tpu.ood.run_ood_detection`` scores them unchanged. A second pair
of runs adds ``--sampler=dpm --score_elbo=1``: the DPM-Solver++ sweep and the
``elbo`` column. Flags the port does not serve raise NotImplementedError
naming the flag.

Tolerances, fp32 on both sides: t exact; mse rtol 1e-5 (the sweep's,
tests/test_torch_plms_sweep.py); perceptual_difference atol 1e-6 on values
~0.05 and ssim_distance atol 1e-6 on values ~0.5 (LPIPS and SSIM of
reconstructions that agree to ~1e-6, tests/test_torch_lpips.py and
test_torch_ssim.py); elbo rtol 1e-5 (tests/test_torch_elbo.py); the error
maps atol 1e-4 (single pixels, each a mean of 4 squared errors below 1: the
preview's tolerance in tests/test_torch_plms_sweep.py; 4.0e-6 observed).
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from ddpm_ood_tpu.ood import run_ood_detection
from ddpm_ood_tpu_torch import reconstruct as cli
from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv
from ddpm_ood_tpu_torch.losses.lpips import ALEX_CHANNELS, ALEX_CONVS
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.trainers.reconstruct import COLUMNS, ELBO_COLUMN, SSIM_COLUMN, _CsvSink
from ddpm_ood_tpu_torch.utils.checkpoint import find_checkpoint, save_checkpoint

MODEL = "port_fashionmnist"
OUT_NAMES = ["MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"]
NAMES = ["val", "in"] + OUT_NAMES
METRIC_ATOL, MAP_ATOL = 1e-6, 1e-4


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


def write_lpips_npz(path: Path, seed: int = 0) -> Path:
    """LPIPS weights in the key schema of the JAX package's save_lpips_npz
    (HWIO kernels, (C, 1) lin weights, some of them negative), drawn with
    numpy from a seed."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, cin, cout, k, _, _ in ALEX_CONVS:
        arrays[f"params/net/{name}/kernel"] = (
            rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
        arrays[f"params/net/{name}/bias"] = (0.01 * rng.standard_normal(cout)).astype(np.float32)
    for i, c in enumerate(ALEX_CHANNELS):
        arrays[f"params/lin{i}"] = (rng.standard_normal((c, 1)) / np.sqrt(c)).astype(np.float32)
    np.savez(path, **arrays)
    return path


def host_noise(shape, t_starts):
    """One noise draw for every batch, handed to both packages' programs.
    Each image's noise depends on its place in the batch only: the JAX
    program wrap-pads a batch of 4 to the 8 virtual devices of the test
    backend and reads back the first 4 columns."""
    k, b = shape[:2]
    full = np.random.default_rng(5).standard_normal((k, 8) + tuple(shape[2:]))
    return full[:, :b].astype(np.float32)


def make_synthetic_run(root: Path) -> list:
    """Data splits, a seeded tiny checkpoint.pth and an LPIPS npz
    (``root/lpips.npz``); returns the CLI argv."""
    rng = np.random.default_rng(0)
    val = _split(root, "val", 4, False, rng)
    ins = _split(root, "FashionMNIST_test", 4, False, rng)
    out = _split(root, "MNIST_test", 4, True, rng)
    run = root / "output" / MODEL
    run.mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(run / "checkpoint.pth", model.state_dict(), epoch=3)
    write_lpips_npz(root / "lpips.npz")
    return [
        "--device=cpu", f"--output_dir={root / 'output'}", f"--model_name={MODEL}",
        f"--validation_ids={val}", f"--in_ids={ins}",
        f"--out_ids={out},{ins}_vflip,{ins}_hflip",
        "--image_size=16", "--model_type=tiny", "--is_grayscale=1", "--batch_size=4",
        "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195",
        "--num_inference_steps=10", "--inference_skip_factor=3", "--num_workers=2",
        "--recon_groups=2", "--score_ssim=1", "--save_error_maps=1",
    ]


def _jax_reconstruct(root: Path, argv: list, host_noise_fn=host_noise) -> Path:
    """The JAX package's Reconstruct on the same data, weights, npz and noise
    (`host_noise_fn`; None keeps the noise the flags ask for); returns its
    ood directory."""
    import jax

    from ddpm_ood_tpu.config import parse_args_reconstruct
    from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
    from ddpm_ood_tpu.trainers import base as jax_base
    from ddpm_ood_tpu.trainers.reconstruct import Reconstruct as JaxReconstruct
    from ddpm_ood_tpu.utils import checkpoint as jckpt
    from ddpm_ood_tpu.utils.convert_torch import torch_to_flax_unet
    from test_torch_ldm_reconstruct import shaped_make_ddpm_state

    out = root / "jax_output"
    # the state only carries the checkpoint's tree: zeros of its shapes (the
    # eager init takes ~20 s on the CPU), as the JAX CLI restores over it
    state = shaped_make_ddpm_state(jax_make_unet("tiny", 2, 1, 1), jax.random.PRNGKey(0),
                                   (16, 16, 1))
    weights = torch.load(root / "output" / MODEL / "checkpoint.pth", weights_only=True)
    params, report = torch_to_flax_unet(weights["model_state_dict"], state.params)
    assert not report["missing"] and not report["unused"], report
    jckpt.save_checkpoint(out / MODEL, "checkpoint", {
        "epoch": 3, "global_step": 0, "best_loss": 0.0, "model_state_dict": params,
        "optimizer_state_dict": state.opt_state})
    jckpt.wait_for_checkpoints()
    args = parse_args_reconstruct([a.replace(str(root / "output"), str(out)) for a in argv
                                   if a != "--device=cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base, "make_ddpm_state", shaped_make_ddpm_state)
        recon = JaxReconstruct(args)
    if host_noise_fn is not None:
        program = recon._program(args.inference_skip_factor)
        program.host_noise_fn, program.overlap_host_noise = host_noise_fn, False
    recon.reconstruct(args)
    return out / MODEL / "ood"


def _both_clis(root: Path, extra=()):
    """The port's scoring run and the JAX package's on the same inputs."""
    argv = make_synthetic_run(root) + list(extra)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
        args = cli.parse_args(argv)
        recon = cli.Reconstruct(args, torch.device("cpu"))
        recon._program(args.inference_skip_factor).host_noise_fn = host_noise
        recon.reconstruct(args)
        jax_ood = _jax_reconstruct(root, argv)
    return root, argv, recon, jax_ood


@pytest.fixture(scope="module")
def scored_run(tmp_path_factory):
    return _both_clis(tmp_path_factory.mktemp("port_cli"))


@pytest.fixture(scope="module")
def dpm_elbo_run(tmp_path_factory):
    return _both_clis(tmp_path_factory.mktemp("port_cli_dpm"),
                      ["--sampler=dpm", "--score_elbo=1"])


def _sorted_csv(path: Path) -> pd.DataFrame:
    return pd.read_csv(path).sort_values(["filename", "t"]).reset_index(drop=True)


def _assert_csvs_match_jax(run, extra_columns):
    root, _, recon, jax_ood = run
    ood = root / "output" / MODEL / "ood"
    names = sorted(p.name for p in ood.glob("results_*.csv"))
    assert names == sorted(f"results_{n}.csv" for n in NAMES)
    assert not list(ood.glob(".*partial*"))
    scores = ["mse", "perceptual_difference", *extra_columns]
    for name in names:
        df = pd.read_csv(ood / name)
        assert list(df.columns) == ["Unnamed: 0", *COLUMNS, *extra_columns]  # the JAX layout
        t_starts = recon._program(3).t_starts  # 4 start points for plms, 3 for dpm
        assert len(df) == 4 * len(t_starts) and df["filename"].nunique() == 4
        assert sorted(df["t"].unique()) == sorted(t_starts)
        assert np.isfinite(df[scores]).all().all()
        assert (df[scores[1:]] > 0).all().all()
        want = _sorted_csv(jax_ood / name)
        got = _sorted_csv(ood / name)
        assert list(got.columns) == list(want.columns)
        for col in ("filename", "type", "t"):
            assert list(got[col]) == list(want[col]), (name, col)
        for col in ("mse", ELBO_COLUMN):
            if col in scores:
                np.testing.assert_allclose(got[col], want[col], rtol=1e-5, atol=0,
                                           err_msg=f"{name} {col}")
        for col in ("perceptual_difference", SSIM_COLUMN):
            np.testing.assert_allclose(got[col], want[col], atol=METRIC_ATOL, rtol=0,
                                       err_msg=f"{name} {col}")


def test_cli_writes_the_jax_results_csvs(scored_run):
    _assert_csvs_match_jax(scored_run, [SSIM_COLUMN])


def test_cli_dpm_with_elbo_writes_the_jax_results_csvs(dpm_elbo_run):
    """--sampler=dpm --score_elbo=1: the elbo column sits between mse and
    ssim_distance, as the JAX CLI writes it."""
    _assert_csvs_match_jax(dpm_elbo_run, [ELBO_COLUMN, SSIM_COLUMN])
    _, _, recon, _ = dpm_elbo_run
    assert recon._program(3).sampler == "dpm"


def test_cli_writes_the_jax_error_maps(scored_run):
    root, _, _, jax_ood = scored_run
    maps = root / "output" / MODEL / "ood" / "error_maps"
    assert sorted(p.name for p in maps.iterdir()) == sorted(NAMES)
    for name in NAMES:
        got = sorted(maps.glob(f"{name}/*"))
        assert len(got) == 4 and all(p.suffix == ".npy" for p in got)  # no figures
        for path in got:
            m = np.load(path)
            assert m.shape == (16, 16, 1) and np.isfinite(m).all() and m.max() > 0
            np.testing.assert_allclose(m, np.load(jax_ood / "error_maps" / name / path.name),
                                       atol=MAP_ATOL, rtol=0)


def test_ood_detection_scores_the_port_csvs(scored_run):
    root, _, _, _ = scored_run
    results = run_ood_detection(str(root / "output"), MODEL, plot_target="mse",
                                save_plots=False, out_datasets=OUT_NAMES)
    aurocs = results["Zscore_mse"]
    assert results["ood_data"] == OUT_NAMES
    assert len(aurocs) == 3 and all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aurocs)


@pytest.mark.parametrize("target", ["perceptual_difference", "mse+perceptual", "ssim_distance"])
def test_both_ood_detections_score_the_port_csvs_alike(scored_run, target):
    """The targets that read LPIPS and SSIM give finite AUROCs, the same in
    both packages' run_ood_detection (no more 0/0 z-scores)."""
    from ddpm_ood_tpu_torch.ood import run_ood_detection as port_run_ood_detection

    root, _, _, _ = scored_run
    want = run_ood_detection(str(root / "output"), MODEL, plot_target=target,
                             save_plots=False, out_datasets=OUT_NAMES)
    got = port_run_ood_detection(str(root / "output"), MODEL, plot_target=target,
                                 out_datasets=OUT_NAMES)
    key = f"Zscore_{target}"
    assert all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in got[key])
    np.testing.assert_allclose(got[key], want[key], atol=1e-12, rtol=0)


def test_kernels_not_launched_on_cpu(scored_run):
    from ddpm_ood_tpu_torch.ops.attention import flash_attention_fwd
    from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

    _, _, recon, _ = scored_run
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


REFUSED = [("--aot_cache=/tmp/aot", "--aot_cache")]


@pytest.mark.parametrize("flag", ["--simplex_noise=1", "--profile_dir=prof", "--resume=1",
                                  "--remat=1"])
def test_noise_resume_profile_and_remat_flags_are_served(flag):
    """Simplex noise, --resume, --profile_dir and --remat
    (tests/test_torch_simplex_recon.py, test_torch_recon_resume.py,
    test_torch_remat.py)."""
    from ddpm_ood_tpu_torch.trainers.reconstruct import refuse_unported_flags

    refuse_unported_flags(cli.parse_args(["--device=cpu", "--model_name=m", flag]))


@pytest.mark.parametrize("flag", ["--score_ssim=1", "--save_error_maps=1"])
def test_metrics_tail_flags_are_served(flag):
    from ddpm_ood_tpu_torch.trainers.reconstruct import refuse_unported_flags

    refuse_unported_flags(cli.parse_args(["--device=cpu", "--model_name=m", flag]))


@pytest.mark.parametrize("flag", ["--sampler=ddim", "--sampler=plms_ref", "--sampler=dpm",
                                  "--score_elbo=1"])
def test_sampler_and_elbo_flags_are_served(flag):
    from ddpm_ood_tpu_torch.trainers.reconstruct import refuse_unported_flags

    refuse_unported_flags(cli.parse_args(["--device=cpu", "--model_name=m", flag]))


@pytest.mark.parametrize("flag", ["--spatial_dimension=3",
                                  "--vqvae_checkpoint=vq/checkpoint.pth",
                                  "--latent_pad=(0,0,1,1)"])
def test_latent_diffusion_flags_are_served(flag):
    """3D and latent-diffusion scoring (tests/test_torch_ldm_reconstruct.py)."""
    from ddpm_ood_tpu_torch.trainers.reconstruct import refuse_unported_flags

    refuse_unported_flags(cli.parse_args(["--device=cpu", "--model_name=m", flag]))


@pytest.mark.parametrize("flag,name", REFUSED)
def test_unported_flags_raise(tmp_path, monkeypatch, flag, name):
    """--aot_cache (TPU-only). --quantize is scored in one process
    (tests/test_torch_quant_cli.py) and under torchrun, each absmax over
    every rank (tests/test_torch_ddp_quant.py)."""
    argv = ["--device=cpu", f"--output_dir={tmp_path}", "--model_name=m", flag]
    with pytest.raises(NotImplementedError, match=name):
        cli.main(argv)


def test_more_than_one_process_raises(tmp_path, monkeypatch):
    """More than one process is served under torchrun
    (tests/test_torch_ddp_reconstruct.py); WORLD_SIZE without torchrun's
    rendezvous environment is an error that names the launcher."""
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
