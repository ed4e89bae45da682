"""The port's scoring CLI on a latent diffusion model, against the JAX CLI,
on the CPU, in 3D and 2D.

``python -m ddpm_ood_tpu_torch.reconstruct --spatial_dimension=3
--vqvae_checkpoint=<vq>/checkpoint.pth --latent_pad=...`` on synthetic
8-voxel volumes (16-pixel images in 2D) with a tiny VQ-VAE (a quarter of
the side in latents, 4-wide codes) and a tiny UNet on its padded latents
(4 voxels, 8 pixels a side), an LPIPS npz in
the JAX package's key schema (fake-3D LPIPS on volumes), and
``--score_ssim=1 --save_error_maps=1`` writes the five results CSVs and the
error maps that the JAX CLI writes on the same weights, npz and noise draw.
The weights are seeded JAX params: the JAX CLI reads them from Orbax
checkpoints, the port from reference-schema ``.pth`` files written with its
converter (``jax_vqvae_params_to_state_dict``, ``jax_unet_params_to_state_dict``).

Tolerances, fp32 on both sides: t exact; mse rtol 1e-4 and
perceptual_difference / ssim_distance atol 1e-5 (tests/test_torch_ldm_sweep.py's:
the decoder's convolutions after the sweep, summed in different orders);
error maps atol 1e-4 (tests/test_torch_reconstruct.py's). Quantizer
near-ties of the re-quantization are counted in the sweep test; the seeded
data here is not chosen to avoid them, and none of its rows needs an
exception.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ddpm_ood_tpu_torch import reconstruct as cli
from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv
from ddpm_ood_tpu_torch.trainers.reconstruct import COLUMNS, SSIM_COLUMN
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from ddpm_ood_tpu_torch.utils.convert import (jax_unet_params_to_state_dict,
                                              jax_vqvae_params_to_state_dict)
from test_torch_reconstruct import host_noise, write_lpips_npz
from test_torch_unet3d import seeded_jax_params_nd
from test_torch_vqvae import CONFIG, seeded_vqvae

MODEL = "ldm_fashionmnist"
NAMES = ["val", "in", "MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip"]
SIZE = {2: 16, 3: 8}  # XLA's CPU convolutions in 3D are slow: volumes stay small
LATENT_PAD = {2: "(2,2,0,4)", 3: "(1,1,0,2,2,0)"}  # latent sides 4 -> 8 (2D), 2 -> 4 (3D)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shaped_make_ddpm_state(unet, rng, sample_shape, **kwargs):
    """The JAX package's ``make_ddpm_state`` as zeros of its shapes and
    dtypes. The JAX trainer builds this state only to restore the checkpoint
    over it, and ``make_ddpm_state``'s own eager ``unet.init`` takes ~15 s in
    3D on the CPU (~8 s to compile under ``jax.jit``)."""
    from ddpm_ood_tpu.train.ddpm import make_ddpm_state

    shapes = jax.eval_shape(lambda r: make_ddpm_state(unet, r, sample_shape, **kwargs), rng)
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _split(root: Path, name: str, dims: int, n: int, rng) -> str:
    d = root / name
    d.mkdir(parents=True)
    paths = []
    for i in range(n):
        paths.append(str(d / f"{name}_{i}.npy"))
        np.save(paths[-1], rng.uniform(size=(1,) + (SIZE[dims],) * dims).astype(np.float32))
    write_split_csv(paths, str(root / f"{name}.csv"))
    return str(root / f"{name}.csv")


def _write_runs(root: Path, dims: int):
    """Both packages' checkpoints of one seeded VQ-VAE and UNet; returns the
    port's VQ-VAE .pth and the JAX package's Orbax directory."""
    from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
    from ddpm_ood_tpu.utils import checkpoint as jckpt

    _, vq_params, vq_ema = seeded_vqvae(dims, size=SIZE[dims])
    unet = jax_make_unet("tiny", dims, 4, 4)
    latent = (1,) + (SIZE[dims] // 2,) * dims + (4,)
    params = seeded_jax_params_nd(unet, latent, seed=dims)
    config = json.dumps(dict(CONFIG, spatial_dims=dims))

    vq_port, vq_jax = root / "vq_port", root / "vq_jax"
    for d in (vq_port, vq_jax):
        d.mkdir()
        (d / "vqvae_config.json").write_text(config)
    save_checkpoint(vq_port / "checkpoint.pth", jax_vqvae_params_to_state_dict(vq_params, vq_ema))
    save_checkpoint(root / "output" / MODEL / "checkpoint.pth",
                    jax_unet_params_to_state_dict(params), epoch=3)

    jckpt.save_checkpoint(vq_jax, "checkpoint", {
        "epoch": 1, "global_step": 0, "best_loss": 0.0,
        "model_state_dict": {"params": vq_params, "ema": vq_ema}})
    state = shaped_make_ddpm_state(unet, jax.random.PRNGKey(0), latent[1:])
    jckpt.save_checkpoint(root / "jax_output" / MODEL, "checkpoint", {
        "epoch": 3, "global_step": 0, "best_loss": 0.0, "model_state_dict": params,
        "optimizer_state_dict": state.opt_state})
    jckpt.wait_for_checkpoints()
    return vq_port / "checkpoint.pth", vq_jax / "checkpoint"


def _both_clis(root: Path, dims: int):
    rng = np.random.default_rng(dims)
    val, ins, out = (_split(root, n, dims, 2, rng)
                     for n in ("val", "FashionMNIST_test", "MNIST_test"))
    (root / "output" / MODEL).mkdir(parents=True)
    vq_port, vq_jax = _write_runs(root, dims)
    write_lpips_npz(root / "lpips.npz")
    common = [
        f"--model_name={MODEL}", f"--validation_ids={val}", f"--in_ids={ins}",
        f"--out_ids={out},{ins}_vflip,{ins}_hflip", f"--spatial_dimension={dims}",
        f"--latent_pad={LATENT_PAD[dims]}", f"--image_size={SIZE[dims]}", "--model_type=tiny",
        "--is_grayscale=1", "--batch_size=2", "--beta_schedule=scaled_linear_beta",
        "--beta_start=0.0015", "--beta_end=0.0195", "--num_inference_steps=10",
        "--inference_skip_factor=3", "--num_workers=1", "--recon_groups=1",
        "--score_ssim=1", "--save_error_maps=1",
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
        args = cli.parse_args(["--device=cpu", f"--output_dir={root / 'output'}",
                               f"--vqvae_checkpoint={vq_port}"] + common)
        recon = cli.Reconstruct(args, torch.device("cpu"))
        recon._program(args.inference_skip_factor).host_noise_fn = host_noise
        recon.reconstruct(args)

        from ddpm_ood_tpu.config import parse_args_reconstruct
        from ddpm_ood_tpu.trainers import base as jax_base
        from ddpm_ood_tpu.trainers.reconstruct import Reconstruct as JaxReconstruct

        mp.setattr(jax_base, "make_ddpm_state", shaped_make_ddpm_state)

        jargs = parse_args_reconstruct([f"--output_dir={root / 'jax_output'}",
                                        f"--vqvae_checkpoint={vq_jax}"] + common)
        jrecon = JaxReconstruct(jargs)
        program = jrecon._program(jargs.inference_skip_factor)
        program.host_noise_fn, program.overlap_host_noise = host_noise, False
        jrecon.reconstruct(jargs)
    return root / "output" / MODEL / "ood", root / "jax_output" / MODEL / "ood", recon


@pytest.fixture(scope="module", params=[3, 2], ids=["3d", "2d"])
def scored(request, tmp_path_factory):
    dims = request.param
    return (dims,) + _both_clis(tmp_path_factory.mktemp(f"ldm_cli_{dims}d"), dims)


def _sorted_csv(path: Path) -> pd.DataFrame:
    return pd.read_csv(path).sort_values(["filename", "t"]).reset_index(drop=True)


def test_ldm_cli_writes_the_jax_results_csvs(scored):
    _, ood, jax_ood, recon = scored
    names = sorted(p.name for p in ood.glob("results_*.csv"))
    assert names == sorted(f"results_{n}.csv" for n in NAMES)
    t_starts = recon._program(3).t_starts
    for name in names:
        got, want = _sorted_csv(ood / name), _sorted_csv(jax_ood / name)
        assert list(got.columns) == list(want.columns) == ["Unnamed: 0", *COLUMNS, SSIM_COLUMN]
        assert len(got) == 2 * len(t_starts)
        for col in ("filename", "type", "t"):
            assert list(got[col]) == list(want[col]), (name, col)
        scores = got[["mse", "perceptual_difference", SSIM_COLUMN]]
        assert np.isfinite(scores).all().all() and (scores > 0).all().all()
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-4, atol=0, err_msg=name)
        for col in ("perceptual_difference", SSIM_COLUMN):
            np.testing.assert_allclose(got[col], want[col], atol=1e-5, rtol=0,
                                       err_msg=f"{name} {col}")


def test_ldm_cli_writes_the_jax_error_maps(scored):
    dims, ood, jax_ood, _ = scored
    for name in NAMES:
        got = sorted((ood / "error_maps" / name).glob("*"))
        assert len(got) == 2 and all(p.suffix == ".npy" for p in got)
        for path in got:
            m = np.load(path)
            assert m.shape == (SIZE[dims],) * dims + (1,) and np.isfinite(m).all() and m.max() > 0
            np.testing.assert_allclose(m, np.load(jax_ood / "error_maps" / name / path.name),
                                       atol=1e-4, rtol=0)


def test_ldm_cli_builds_the_latent_geometry(scored):
    """The UNet works on embedding_dim channels of the padded latent, the
    scoring groups default as in the JAX package."""
    dims, _, _, recon = scored
    assert recon.ddpm_channels == 4
    assert recon._latent_sample_shape() == (SIZE[dims] // 2,) * dims + (4,)
    program = recon._program(3)
    assert program.latent_pad == tuple(int(v) for v in LATENT_PAD[dims][1:-1].split(","))
    assert program.encode_fn is not None and program.decode_fn is not None


@pytest.mark.parametrize("dims,want", [(2, 16), (3, 3)])
def test_recon_groups_auto_by_dimension(dims, want):
    from ddpm_ood_tpu.serve import resolve_recon_groups as jax_resolve
    from ddpm_ood_tpu_torch.trainers.reconstruct import resolve_recon_groups

    assert resolve_recon_groups("auto", dims) == jax_resolve("auto", dims) == want
    assert resolve_recon_groups("5", dims) == 5
