"""The port runs where JAX does not exist.

In a fresh interpreter whose import system refuses jax, flax, orbax, optax,
pandas, sklearn, matplotlib and Pillow (as on the GPU host, which has none of them)
and the JAX package itself (the port keeps its own copies of what it needs),
every module of ddpm_ood_tpu_torch imports, the tiny scoring CLI (with LPIPS
from an npz, --score_ssim and --save_error_maps, and exact simplex noise,
--resume and --remat) and training CLI (simplex noise and remat) run on the
CPU without launching a kernel (the port's own OpenSimplex library built),
``python -m ddpm_ood_tpu_torch.ood_detection``
prints the AUROCs of the scoring CLI's CSVs, ``python -m
ddpm_ood_tpu_torch.quality_check --device=cpu`` trains, scores with DPM-Solver++
and the ELBO, and prints its JSON, the online scoring service built from the
scoring CLI's run scores one request through ``make_server`` in a thread,
``python -m ddpm_ood_tpu_torch.sample --device=cpu`` writes its ``.npy``, and
building the CUDA kernels where there
is no nvcc raises KernelBuildError instead of returning. The same holds for
scoring a 3D latent diffusion model (``--spatial_dimension=3
--vqvae_checkpoint --latent_pad``) with fake-3D LPIPS, SSIM and error maps,
and for training one: ``python -m ddpm_ood_tpu_torch.train_vqvae`` on 3D
volumes, then the training CLI on its checkpoint; and for quantised scoring,
``reconstruct --quantize=int8`` on the plain int8 versions, and ``python -m
ddpm_ood_tpu_torch.bench_quant_micro --device=cpu`` at a tiny shape.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_reconstruct import MODEL, OUT_NAMES, make_synthetic_run
from test_torch_train_cli import train_argv

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax", "pandas", "sklearn", "matplotlib",
           "tensorboardX", "PIL", "ddpm_ood_tpu")

CHILD = r"""
import contextlib, importlib, io, json, pkgutil, runpy, sys, threading, urllib.request

# None in sys.modules is how Python spells "not installed": import raises
# ModuleNotFoundError and importlib.util.find_spec returns None (torch probes
# optional packages that way, e.g. when torch.optim first loads torch._dynamo)
BLOCKED = set(sys.argv[1].split(","))
for name in BLOCKED:
    sys.modules[name] = None

import ddpm_ood_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(ddpm_ood_tpu_torch.__path__, "ddpm_ood_tpu_torch.")]
for m in mods:
    importlib.import_module(m)

from ddpm_ood_tpu_torch import reconstruct, train_ddpm
from ddpm_ood_tpu_torch.ops import KernelBuildError, _kernels
from ddpm_ood_tpu_torch.ops.attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
)
from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

recon = reconstruct.main(json.loads(sys.argv[2]))
trainer = train_ddpm.main(json.loads(sys.argv[3]))
quality_argv = json.loads(sys.argv[5])
ood_argv, serve_argv, sample_argv = (json.loads(sys.argv[i]) for i in (4, 6, 7))

import numpy as np
from ddpm_ood_tpu_torch import serve
from ddpm_ood_tpu_torch.config import parse_args_serve

server = serve.make_server(serve.build_service(parse_args_serve(serve_argv)), "127.0.0.1", 0)
threading.Thread(target=server.serve_forever, daemon=True).start()
body = io.BytesIO()
np.save(body, np.zeros((1, 16, 16, 1), np.float32))
request = urllib.request.Request(f"http://127.0.0.1:{server.server_port}/score",
                                 data=body.getvalue())
with urllib.request.urlopen(request) as r:
    served = json.loads(r.read())["scores"]
server.shutdown()
server.server_close()
sys.argv = ["sample"] + sample_argv  # python -m ddpm_ood_tpu_torch.sample
with contextlib.redirect_stdout(io.StringIO()):
    runpy.run_module("ddpm_ood_tpu_torch.sample", run_name="__main__")
sys.argv = ["ood_detection"] + ood_argv  # python -m ddpm_ood_tpu_torch.ood_detection
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    runpy.run_module("ddpm_ood_tpu_torch.ood_detection", run_name="__main__")
sys.argv = ["quality_check"] + quality_argv  # python -m ddpm_ood_tpu_torch.quality_check
quality = io.StringIO()
with contextlib.redirect_stdout(quality):
    runpy.run_module("ddpm_ood_tpu_torch.quality_check", run_name="__main__")
build = "not run: nvcc present"
if _kernels.find_nvcc() is None:
    try:
        _kernels.build(force=True)
        build = "returned"
    except KernelBuildError as e:
        build = "KernelBuildError: " + str(e)
print(json.dumps({
    "modules": mods,
    "evals": sum(p.model_evals for p in recon._programs.values()),
    "launches": [groupnorm_act.launches, flash_attention_fwd.launches,
                 flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches],
    "trained": [trainer.global_step, trainer.step.backwards,
                sorted(p.name for p in trainer.run_dir.glob("*.pth"))],
    "noise": [type(recon._programs[3].host_noise_fn).__name__, trainer.simplex_noise,
              trainer.unet.middle_block.resnet_1.remat],
    "csvs": sorted(p.name for p in recon.out_dir.glob("results_*.csv")),
    "ssim_header": (recon.out_dir / "results_val.csv").read_text().splitlines()[0],
    "error_maps": sorted(str(p.relative_to(recon.out_dir))
                         for p in recon.out_dir.glob("error_maps/*/*.npy")),
    "previews": sorted(p.name for p in recon.out_dir.glob("preview_*.npy")),
    "ood_detection": printed.getvalue().splitlines(),
    "scores_csv": (recon.out_dir / "ood_scores_mse+perceptual.csv").is_file(),
    "quality": [json.loads(line) for line in quality.getvalue().splitlines()
                if line.startswith("{")],
    "build": build,
    "served": [sorted(served[0]), len(served[0]["per_t"])],
    "samples": [list(a.shape) for a in map(np.load, sorted(
        (recon.run_dir / "samples").glob("samples_*.npy")))],
    "leaked": sorted(m for m, mod in sys.modules.items()
                     if mod is not None and m.split(".")[0] in BLOCKED),
}))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    argv = make_synthetic_run(tmp_path / "score") + ["--simplex_noise=1", "--resume=1",
                                                     "--remat=1"]
    train = train_argv(tmp_path / "train", "--n_epochs=1", "--eval_freq=100",
                       "--checkpoint_every=1", "--simplex_noise=1", "--remat=1")
    ood = [f"--output_dir={tmp_path / 'score' / 'output'}", f"--model_name={MODEL}",
           "--plot_target=mse+perceptual", "--report=auroc,aupr,fpr95,auroc_ci"]
    quality = ["--device=cpu", "--epochs=1", "--size=8", "--n_train=8", "--n_eval=4",
               "--steps=10", "--skip=5", "--samplers=dpm@10/5", "--elbo",
               f"--workdir={tmp_path / 'quality'}"]
    model = [f"--output_dir={tmp_path / 'score' / 'output'}", f"--model_name={MODEL}",
             "--device=cpu", "--model_type=tiny", "--image_size=16", "--is_grayscale=1",
             "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195"]
    serve = model + ["--num_inference_steps=10", "--inference_skip_factor=3", "--batch_size=4",
                     "--recon_groups=2", "--host=127.0.0.1"]
    sample = model + ["--sampler=dpm", "--num_inference_steps=10", "--n_samples=2"]
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, ",".join(BLOCKED), json.dumps(argv), json.dumps(train),
         json.dumps(ood), json.dumps(quality), json.dumps(serve), json.dumps(sample)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",  # see test_torch_reconstruct.py
             "LPIPS_WEIGHTS_NPZ": str(tmp_path / "score" / "lpips.npz")},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("trainers.reconstruct", "trainers.ddpm_trainer", "train_ddpm", "config",
                "data.transforms", "ops._kernels", "diffusion.ddim", "diffusion.dpm_solver",
                "diffusion.elbo", "quality_check", "noise.simplex", "noise._native",
                "utils.native_build", "utils.profiling", "serve", "sample", "bench_serve"):
        assert f"ddpm_ood_tpu_torch.{mod}" in got["modules"]
    assert got["leaked"] == []
    assert got["evals"] > 0 and got["launches"] == [0, 0, 0, 0]
    assert got["trained"] == [10, 3, ["checkpoint.pth", "checkpoint_1.pth"]]
    assert got["noise"] == ["method", True, True]  # the exact host noise, simplex, remat
    assert len(got["csvs"]) == 5
    assert got["ssim_header"] == ",filename,type,t,perceptual_difference,mse,ssim_distance"
    assert len(got["error_maps"]) == 5 * 4 and all(
        p.startswith("error_maps/") for p in got["error_maps"])
    assert got["previews"] == ["preview_in.npy", "preview_out_3.npy", "preview_out_4.npy",
                               "preview_out_5.npy", "preview_val.npy"]
    aucs = [line for line in got["ood_detection"] if line.startswith("AUC for")]
    assert [line.split(" vs ")[1].split(":")[0] for line in aucs] == OUT_NAMES
    for line in aucs:  # "AUC for <model> vs <name>: 62.5 (95% CI [30.1, 94.9])"
        auc = float(line.split(": ")[1].split()[0])
        assert 0.0 <= auc <= 100.0 and "95% CI [" in line
    assert any(line.startswith("Average AUC: ") for line in got["ood_detection"])
    assert got["scores_csv"]
    assert len(got["quality"]) == 1
    quality = got["quality"][0]
    assert quality["backend"] == "cpu" and list(quality["per_sampler"]) == ["dpm@10/5"]
    entry = quality["per_sampler"]["dpm@10/5"]
    assert set(entry) == {"easy", "hard", "easy_elbo", "hard_elbo", "easy_mse+elbo",
                          "hard_mse+elbo"}
    assert all(0.0 <= task["auroc"] <= 1.0 for task in entry.values())
    assert got["build"].startswith("KernelBuildError: nvcc not found"), got["build"]
    assert got["served"] == [["per_t", "z_score_mse", "z_score_perceptual"], 4]
    assert got["samples"] == [[2, 16, 16, 1]]


CHILD_QUANT = r"""
import contextlib, io, json, runpy, sys

BLOCKED = set(sys.argv[1].split(","))
for name in BLOCKED:
    sys.modules[name] = None

from ddpm_ood_tpu_torch import reconstruct
from ddpm_ood_tpu_torch.models.unet import QuantConv, QuantDense
from ddpm_ood_tpu_torch.ops.quant import qconv_s8, quant_absmax

recon = reconstruct.main(json.loads(sys.argv[2]))
sys.argv = ["bench_quant_micro"] + json.loads(sys.argv[3])
printed = io.StringIO()
with contextlib.redirect_stdout(printed):  # python -m ddpm_ood_tpu_torch.bench_quant_micro
    runpy.run_module("ddpm_ood_tpu_torch.bench_quant_micro", run_name="__main__")
print(json.dumps({
    "evals": sum(p.model_evals for p in recon._programs.values()),
    "sites": sum(isinstance(m, (QuantConv, QuantDense)) for m in recon.unet.modules()),
    "launches": [quant_absmax.launches, qconv_s8.launches],
    "csvs": sorted(p.name for p in recon.out_dir.glob("results_*.csv")),
    "mse": [float(line.split(",")[5]) for line in
            (recon.out_dir / "results_val.csv").read_text().splitlines()[1:]],
    "bench": [json.loads(line) for line in printed.getvalue().splitlines()],
    "leaked": sorted(m for m, mod in sys.modules.items()
                     if mod is not None and m.split(".")[0] in BLOCKED),
}))
"""


def test_quantised_scoring_runs_without_jax(tmp_path):
    argv = make_synthetic_run(tmp_path) + ["--quantize=int8", "--run_in=0", "--run_out=0"]
    micro = ["--device=cpu", "--batch=2", "--hw=4", "--cin=16", "--cout=8", "--iters=2",
             "--repeats=1"]
    proc = subprocess.run(
        [sys.executable, "-c", CHILD_QUANT, ",".join(BLOCKED), json.dumps(argv),
         json.dumps(micro)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "LPIPS_WEIGHTS_NPZ": str(tmp_path / "lpips.npz")},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    assert got["evals"] > 0 and got["sites"] == 49 and got["launches"] == [0, 0]
    assert got["csvs"] == ["results_val.csv"]
    assert len(got["mse"]) == 4 * 4 and all(m > 0 for m in got["mse"])
    assert [b["variant"] for b in got["bench"]] == ["bf16", "int8dyn", "int8pre"]
    assert all(b["backend"] == "cpu" and b["shape"] == [2, 4, 4, 16, 8] and b["best_s"] > 0
               for b in got["bench"])


CHILD_LDM = r"""
import json, sys

BLOCKED = set(sys.argv[1].split(","))
for name in BLOCKED:
    sys.modules[name] = None

from ddpm_ood_tpu_torch import reconstruct
from ddpm_ood_tpu_torch.ops.attention import flash_attention_fwd
from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

recon = reconstruct.main(json.loads(sys.argv[2]))
print(json.dumps({
    "evals": sum(p.model_evals for p in recon._programs.values()),
    "launches": [groupnorm_act.launches, flash_attention_fwd.launches],
    "channels": recon.ddpm_channels,
    "csvs": sorted(p.name for p in recon.out_dir.glob("results_*.csv")),
    "header": (recon.out_dir / "results_val.csv").read_text().splitlines()[0],
    "error_maps": sorted(str(p.relative_to(recon.out_dir))
                         for p in recon.out_dir.glob("error_maps/*/*.npy")),
    "previews": sorted(p.name for p in recon.out_dir.glob("preview_*.npy")),
    "leaked": sorted(m for m, mod in sys.modules.items()
                     if mod is not None and m.split(".")[0] in BLOCKED),
}))
"""


def test_ldm_3d_scoring_runs_without_jax(tmp_path):
    """A seeded tiny 3D VQ-VAE (.pth and vqvae_config.json) and UNet on its
    latents, written by the port alone, scored by the port's CLI."""
    import numpy as np
    import torch

    from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv
    from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
    from ddpm_ood_tpu_torch.models.vqvae import VQVAE
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
    from test_torch_reconstruct import write_lpips_npz

    config = dict(spatial_dims=3, in_channels=1, out_channels=1, num_res_layers=1,
                  downsample_parameters=[[2, 4, 1, 1], [2, 4, 1, 1]],
                  upsample_parameters=[[2, 4, 1, 1, 0], [2, 4, 1, 1, 0]],
                  num_channels=[8, 8], num_res_channels=[8, 8], num_embeddings=16,
                  embedding_dim=4)
    torch.manual_seed(0)
    (tmp_path / "vq").mkdir()
    save_checkpoint(tmp_path / "vq" / "checkpoint.pth", VQVAE(**config).state_dict())
    (tmp_path / "vq" / "vqvae_config.json").write_text(json.dumps(config))
    unet = random_init_(make_unet("tiny", 3, 4, 4), torch.Generator().manual_seed(0))
    (tmp_path / "output" / "ldm").mkdir(parents=True)
    save_checkpoint(tmp_path / "output" / "ldm" / "checkpoint.pth", unet.state_dict())
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"vol_{i}.npy"))
        np.save(paths[-1], rng.uniform(size=(1, 16, 16, 16)).astype(np.float32))
    write_split_csv(paths, str(tmp_path / "val.csv"))
    write_lpips_npz(tmp_path / "lpips.npz")
    argv = ["--device=cpu", f"--output_dir={tmp_path / 'output'}", "--model_name=ldm",
            f"--validation_ids={tmp_path / 'val.csv'}", f"--in_ids={tmp_path / 'val.csv'}",
            "--run_in=0", "--run_out=0",
            "--spatial_dimension=3", f"--vqvae_checkpoint={tmp_path / 'vq' / 'checkpoint.pth'}",
            "--latent_pad=(2,2,0,4,4,0)", "--image_size=16", "--model_type=tiny",
            "--is_grayscale=1", "--batch_size=2", "--num_inference_steps=10",
            "--inference_skip_factor=5", "--num_workers=1", "--score_ssim=1",
            "--save_error_maps=1"]
    proc = subprocess.run(
        [sys.executable, "-c", CHILD_LDM, ",".join(BLOCKED), json.dumps(argv)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "LPIPS_WEIGHTS_NPZ": str(tmp_path / "lpips.npz")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["leaked"] == [] and got["channels"] == 4
    assert got["evals"] > 0 and got["launches"] == [0, 0]
    assert got["csvs"] == ["results_val.csv"]
    assert got["header"] == ",filename,type,t,perceptual_difference,mse,ssim_distance"
    assert got["error_maps"] == ["error_maps/val/vol_0.npy", "error_maps/val/vol_1.npy"]
    assert got["previews"] == ["preview_val.npy"]


CHILD_TRAIN_LDM = r"""
import json, sys

BLOCKED = set(sys.argv[1].split(","))
for name in BLOCKED:
    sys.modules[name] = None

from ddpm_ood_tpu_torch import train_ddpm, train_vqvae
from ddpm_ood_tpu_torch.ops.attention import flash_attention_fwd
from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

vq = train_vqvae.main(json.loads(sys.argv[2]))
ldm = train_ddpm.main(json.loads(sys.argv[3]))
print(json.dumps({
    "vq": [vq.global_step, vq.step.g_backwards, sorted(p.name for p in vq.run_dir.glob("*"))],
    "ldm": [ldm.global_step, ldm.step.backwards, ldm.ddpm_channels,
            sorted(p.name for p in ldm.run_dir.glob("*.pth"))],
    "launches": [groupnorm_act.launches, flash_attention_fwd.launches],
    "leaked": sorted(m for m, mod in sys.modules.items()
                     if mod is not None and m.split(".")[0] in BLOCKED),
}))
"""


def test_ldm_3d_training_runs_without_jax(tmp_path):
    """``python -m ddpm_ood_tpu_torch.train_vqvae`` on 3D volumes, then
    ``train_ddpm --vqvae_checkpoint --spatial_dimension=3 --latent_pad`` on
    its checkpoint, with the JAX package and JAX itself unimportable."""
    import numpy as np

    from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv

    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"vol_{i}.npy"))
        np.save(paths[-1], rng.uniform(size=(1, 16, 16, 16)).astype(np.float32))
    write_split_csv(paths, str(tmp_path / "vols.csv"))
    common = ["--device=cpu", f"--output_dir={tmp_path / 'output'}",
              f"--training_ids={tmp_path / 'vols.csv'}",
              f"--validation_ids={tmp_path / 'vols.csv'}",
              "--spatial_dimension=3", "--image_size=16", "--is_grayscale=1", "--batch_size=2",
              "--n_epochs=1", "--checkpoint_every=1", "--num_workers=1"]
    vq = [*common, "--model_name=vq", "--eval_freq=1", "--vqvae_num_res_layers=1",
          "--vqvae_downsample_parameters=((2,4,1,1),(2,4,1,1))",
          "--vqvae_upsample_parameters=((2,4,1,1,0),(2,4,1,1,0))", "--vqvae_num_channels=[8,8]",
          "--vqvae_num_res_channels=[8,8]", "--vqvae_num_embeddings=16",
          "--vqvae_embedding_dim=4"]
    ldm = [*common, "--model_name=ldm", "--eval_freq=100", "--model_type=tiny",
           f"--vqvae_checkpoint={tmp_path / 'output' / 'vq' / 'checkpoint.pth'}",
           "--latent_pad=(2,2,0,4,4,0)"]
    proc = subprocess.run(
        [sys.executable, "-c", CHILD_TRAIN_LDM, ",".join(BLOCKED), json.dumps(vq),
         json.dumps(ldm)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["leaked"] == [] and got["launches"] == [0, 0]
    assert got["vq"] == [2, 1, ["checkpoint.pth", "checkpoint_1.pth", "train", "val",
                                "vqvae_config.json"]]
    assert got["ldm"] == [2, 1, 4, ["checkpoint.pth", "checkpoint_1.pth"]]


CHILD_PIPELINES = r"""
import contextlib, io, json, runpy, subprocess, sys
from pathlib import Path

BLOCKED = set(sys.argv[1].split(","))
for name in BLOCKED:
    sys.modules[name] = None
root = Path(sys.argv[2])

printed = io.StringIO()
real_run = subprocess.run


def is_stage(cmd):
    return list(cmd[:2]) == [sys.executable, "-m"] and cmd[2].startswith("ddpm_ood_tpu_torch.")


def python_m(cmd, **kwargs):
    # a stage's fresh interpreter would not inherit the block: run it here
    if not is_stage(cmd):  # (torch asks lscpu once)
        return real_run(cmd, **kwargs)
    sys.argv = cmd[2:]
    with contextlib.redirect_stdout(printed):
        runpy.run_module(cmd[2], run_name="__main__")


def hand(cmd, **kwargs):
    if not is_stage(cmd):
        return real_run(cmd, **kwargs)
    handed.append(cmd[2])


handed = []
subprocess.run = python_m
for mod, args in (("get_computer_vision_datasets", ["--data_root", str(root / "cv")]),
                  ("get_mednist_datasets", ["--data_root", str(root / "mednist")]),
                  ("get_decathlon_datasets", ["--data_root", str(root / "decathlon"),
                                              "--tasks", "Task09"]),
                  ("get_3dmedmnist", ["--data_root", str(root / "medmnist3d"),
                                      "--tasks", "organmnist3d"]),
                  ("get_cromis_dataset", ["--data_root", str(root / "cromis"),
                                          "--source_dir", str(root / "cromis" / "cromis_src")])):
    python_m([sys.executable, "-m", f"ddpm_ood_tpu_torch.data.{mod}", *args])
python_m([sys.executable, "-m", "ddpm_ood_tpu_torch.parity_run", str(root / "parity" / "data"),
          str(root / "parity" / "out"), "--device=cpu"])
subprocess.run = hand
from ddpm_ood_tpu_torch import demo, smoke_3d_ldm

demo.main([f"--workdir={root / 'demo'}", "--device=cpu"])
smoke_3d_ldm.main([str(root / "ldm3d"), "--device=cpu"])
print(json.dumps({
    "splits": sorted(p.name for p in root.glob("*/data_splits/*.csv")),
    "table": json.loads((root / "parity" / "out" / "fashionmnist" / "ood" /
                         "auroc_table.json").read_text())["model"],
    "handed": handed,
    "volumes": len(list((root / "ldm3d").glob("*/*.nii.gz"))),
    "leaked": sorted(m for m, mod in sys.modules.items()
                     if mod is not None and m.split(".")[0] in BLOCKED),
}))
"""


def test_pipeline_scripts_run_without_jax(tmp_path):
    """The dataset prep modules on raw archives, the parity run (stages 1-3
    found done) and its report, and the demo's and the 3D smoke's data and
    the CLIs they hand their stages to, with JAX, the JAX package, sklearn,
    pandas and Pillow unimportable. (The library example runs so in
    test_torch_pipeline_scripts.py, once, as it takes ~25 s.)"""
    import shutil

    from test_torch_dataset_prep import (
        build_cifar_tarball, build_cromis, build_decathlon, build_fashion_raw, build_medmnist3d,
        build_mednist, build_mnist, build_svhn,
    )
    from test_torch_parity_report import _write_results

    for build in (build_mnist, build_fashion_raw, build_cifar_tarball, build_svhn):
        build(tmp_path / "cv")
    build_mednist(tmp_path / "mednist")
    build_decathlon(tmp_path / "decathlon")
    build_medmnist3d(tmp_path / "medmnist3d")
    build_cromis(tmp_path / "cromis")
    parity = tmp_path / "parity"
    _write_results(parity / "out" / "fashionmnist" / "ood", seed=0)
    for name in ("SVHN", "CIFAR10"):
        shutil.copy(parity / "out" / "fashionmnist" / "ood" / "results_MNIST.csv",
                    parity / "out" / "fashionmnist" / "ood" / f"results_{name}.csv")
    (parity / "out" / "fashionmnist" / "checkpoint_300.pth").write_bytes(b"")
    (parity / "data" / "data_splits").mkdir(parents=True)
    for name in ("FashionMNIST_train", "FashionMNIST_val", "FashionMNIST_test", "MNIST_test",
                 "SVHN_test", "CIFAR10_test"):
        (parity / "data" / "data_splits" / f"{name}.csv").write_text("x.npy")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD_PIPELINES, ",".join(BLOCKED), str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    cv = [f"{d}_{s}.csv" for d in ("CIFAR10", "FashionMNIST", "MNIST", "SVHN")
          for s in ("test", "train", "val")]
    mednist = [f"{c}_{s}.csv" for c in ("AbdomenCT", "BreastMRI", "CXR", "ChestCT", "Hand",
                                         "HeadCT") for s in ("test", "train", "val")]
    assert got["splits"] == sorted(cv + mednist + [
        f"{p}_{s}.csv" for p in ("CROMIS", "Decathlon_Task09", "organmnist3d")
        for s in ("test", "train", "val")])
    assert got["table"] == "fashionmnist"
    assert got["handed"] == ["ddpm_ood_tpu_torch.train_ddpm", "ddpm_ood_tpu_torch.reconstruct",
                             "ddpm_ood_tpu_torch.ood_detection",
                             "ddpm_ood_tpu_torch.train_vqvae", "ddpm_ood_tpu_torch.train_ddpm",
                             "ddpm_ood_tpu_torch.reconstruct", "ddpm_ood_tpu_torch.ood_detection"]
    assert got["volumes"] == 52


def _ddp_clis(root):
    """The training, VQ-VAE and scoring CLIs in 2 gloo ranks, JAX and the JAX
    package unimportable in every rank (tests/torch_ddp_worker.py):
    train_ddpm under DDP, alone under ``python -m torch.distributed.run
    --standalone --nproc_per_node=2`` (it joins torchrun's group and
    destroys it); then in 2
    ranks given torchrun's environment, one group for all, train_ddpm
    resumed with --fsdp=1 from the DDP run's checkpoint, train_vqvae with
    --fsdp=1, train_vqvae resumed under DDP, and the scoring CLI on the DDPM
    run. Returns the ranks' output."""
    import numpy as np

    from test_torch_fsdp import VQ_ARGV
    from test_torch_reconstruct import _split
    from torch_ddp_worker import launch

    rng = np.random.default_rng(0)
    train, val = _split(root, "train", 8, False, rng), _split(root, "val", 4, False, rng)
    out = root / "output"
    common = [f"--output_dir={out}", f"--validation_ids={val}", "--device=cpu",
              "--num_workers=2"]
    ddpm = [*common, "--model_name=ddp_fashionmnist", f"--training_ids={train}",
            "--image_size=16", "--model_type=tiny", "--is_grayscale=1", "--batch_size=2",
            "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195",
            "--eval_freq=10", "--checkpoint_every=1"]
    vq = [*common, "--model_name=vq", f"--training_ids={train}", "--checkpoint_every=1",
          *(a for a in VQ_ARGV if not a.startswith(("--n_epochs", "--fsdp")))]
    score = [a for a in ddpm if not a.startswith(("--training_ids", "--eval_freq",
                                                   "--checkpoint_every"))]
    score += [f"--in_ids={val}", "--run_out=0", "--num_inference_steps=10",
              "--inference_skip_factor=3", "--recon_groups=2"]
    (root / "first.json").write_text(json.dumps([("train_ddpm", ddpm + ["--n_epochs=1"])]))
    log = launch("cli", root / "first.json", torchrun=True)
    clis = [("train_ddpm", ddpm + ["--n_epochs=2", "--fsdp=1"]),
            ("train_vqvae", vq + ["--n_epochs=1", "--fsdp=1"]),
            ("train_vqvae", vq + ["--n_epochs=2"]),
            ("reconstruct", score)]
    (root / "clis.json").write_text(json.dumps(clis))
    return log + launch("cli", root / "clis.json")


@pytest.fixture(scope="module", autouse=True)
def ddp_clis(tmp_path_factory):
    """``_ddp_clis`` on a thread from the start of the module, beside the
    other tests' interpreters; (its directory, a future of its output)."""
    from concurrent.futures import ThreadPoolExecutor

    root = tmp_path_factory.mktemp("ddp_clis")
    with ThreadPoolExecutor(1) as pool:
        yield root, pool.submit(_ddp_clis, root)


def test_ddp_clis_run_without_jax(ddp_clis):
    """Each CLI resumed where the one before it stopped: checkpoints of
    epoch 2 counting 4 images a process an epoch; each rank wrote its shard
    of the scores and rank 0 merged them."""
    import torch

    root, future = ddp_clis
    log = future.result()
    out = root / "output"
    assert "Resuming training using checkpoint" in log and "Resuming using checkpoint" in log
    for name, epoch, images in (("ddp_fashionmnist", 2, 8), ("vq", 2, 8)):  # 4 a process
        payload = torch.load(out / name / f"checkpoint_{epoch}.pth", weights_only=True)
        assert (payload["epoch"], payload["global_step"]) == (epoch, images), name
    ood = out / "ddp_fashionmnist" / "ood"
    for name in ("val", "in"):
        lines = (ood / f"results_{name}.csv").read_text().splitlines()
        shards = [(ood / f".results_{name}.shard{r}.csv").read_text().splitlines()
                  for r in range(2)]
        assert len(lines) - 1 == sum(len(s) - 1 for s in shards) == 4 * 4  # 4 images, 4 t
