"""The port's VQ-VAE training CLI against the JAX package's trainer, on the CPU.

Both trainers run the same flags on one synthetic 16x16 grayscale set
(8 training images, batch 8: one G+D step an epoch, each a mean over the
whole set, so the loader's per-epoch shuffle cannot change a value; 8 is
also the test backend's device count, so the JAX trainer's ``shard_batch``
pads nothing, where a wrap-pad would count duplicated images in the
codebook's EMA), read
LPIPS from one seeded npz, and start from the same weights: JAX's
``VQVAETrainer`` draws them from ``PRNGKey(seed)``, and the port's
``VQVAETrainer`` takes them through the converters (``init_state``). JAX
trains 3 epochs straight; the port trains 2, stops, and a second run of
the CLI resumes from its ``checkpoint.pth`` for the third.

Held: the per-step losses (the G metrics and the D loss) of all three
steps, rtol 2e-4 (one step's metrics agree to ~1e-6,
tests/test_torch_vqvae_train.py; Adam's first updates turn the rounding
of near-zero gradient elements into steps of up to lr = 3e-4 on a few
weights, which the later losses feel at ~1e-5); ``vqvae_config.json``
equal; the resumed run's epoch, step count and Adam step; and the port's
``checkpoint.pth`` read back by the JAX package's own
``utils/convert_torch.py:torch_to_flax_vqvae``: the JAX model then
encodes and reconstructs as the port does (rtol 1e-5, atol 1e-5).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_ood_tpu import config as jax_config
from ddpm_ood_tpu.models.vqvae import VQVAE as JaxVQVAE
from ddpm_ood_tpu.train.vqvae import DiscState, VQVAEState
from ddpm_ood_tpu.trainers import VQVAETrainer as JaxVQVAETrainer
from ddpm_ood_tpu.trainers import vqvae_trainer as jax_vqvae_trainer
from ddpm_ood_tpu.utils.convert_torch import torch_to_flax_vqvae
from ddpm_ood_tpu_torch import train_vqvae as cli
from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv
from ddpm_ood_tpu_torch.models.vqvae import VQVAE
from ddpm_ood_tpu_torch.trainers.vqvae_trainer import VQVAETrainer
from ddpm_ood_tpu_torch.utils.checkpoint import load_vqvae_checkpoint
from ddpm_ood_tpu_torch.utils.convert import (
    jax_discriminator_params_to_state_dict, jax_vqvae_params_to_state_dict,
)
from test_torch_reconstruct import write_lpips_npz

MODEL = "vqvae_fashionmnist"
LOSS_RTOL = 2e-4
TAGS = ("l1_loss", "perceptual_loss", "jukebox_loss", "adversarial_loss", "generator_loss",
        "discriminator_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jitted_vqvae_states(vqvae, discriminator, rng, sample_shape, vqvae_lr=3e-4, disc_lr=5e-4):
    """``train/vqvae.py:make_vqvae_states`` with each model's init jitted (one
    XLA program, not hundreds of eager ones): the same draws from `rng`."""
    g_rng, d_rng = jax.random.split(rng)
    dummy = jnp.zeros((1,) + tuple(sample_shape), dtype=jnp.float32)
    g_vars = jax.jit(lambda r, x: vqvae.init({"params": r}, x, False))(g_rng, dummy)
    d_vars = jax.jit(lambda r, x: discriminator.init({"params": r}, x, False))(d_rng, dummy)
    return (VQVAEState.create(apply_fn=vqvae.apply, params=g_vars["params"],
                              tx=optax.adam(vqvae_lr), ema=g_vars.get("ema", {})),
            DiscState.create(apply_fn=discriminator.apply, params=d_vars["params"],
                             tx=optax.adam(disc_lr), batch_stats=d_vars.get("batch_stats", {})))


def flags(root, *extra) -> list:
    return [f"--training_ids={root / 'train.csv'}", f"--validation_ids={root / 'val.csv'}",
            "--model_name=" + MODEL, "--spatial_dimension=2", "--image_size=16",
            "--is_grayscale=1", "--vqvae_num_res_layers=1",
            "--vqvae_downsample_parameters=((2,4,1,1),(2,4,1,1))",
            "--vqvae_upsample_parameters=((2,4,1,1,0),(2,4,1,1,0))",
            "--vqvae_num_channels=[8,8]", "--vqvae_num_res_channels=[8,8]",
            "--vqvae_num_embeddings=16", "--vqvae_embedding_dim=4", "--vqvae_decay=0.9",
            "--batch_size=8", "--eval_freq=100", "--checkpoint_every=100",
            "--adversarial_weight=0.1", "--num_workers=1", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_vqvae_cli")
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    for name, n in (("train", 8), ("val", 2)):
        (root / name).mkdir()
        paths = []
        for i in range(n):
            img = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + 2 * yy) / 16 + rng.uniform(0, 2 * np.pi))
            paths.append(str(root / name / f"{name}_{i}.npy"))
            np.save(paths[-1], img.astype(np.float32)[None])
        write_split_csv(paths, str(root / f"{name}.csv"))
    npz = write_lpips_npz(root / "lpips.npz")

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPIPS_WEIGHTS_NPZ", str(npz))
        mp.setenv("DDPM_OOD_COMPILE_CACHE", "")  # no persistent JAX cache from this test
        mp.setattr(jax_vqvae_trainer, "make_vqvae_states", jitted_vqvae_states)
        jargs = jax_config.parse_args_train_vqvae(
            flags(root, f"--output_dir={root / 'jax'}", "--n_epochs=3"))
        jtrainer = JaxVQVAETrainer(jargs)
        init = (jax_vqvae_params_to_state_dict(jtrainer.g_state.params, jtrainer.g_state.ema),
                jax_discriminator_params_to_state_dict(jtrainer.d_state.params,
                                                       jtrainer.d_state.batch_stats))
        # host copies: the JAX steps donate their state's buffers
        template = jax.tree_util.tree_map(np.asarray, (jtrainer.g_state.params,
                                                       jtrainer.g_state.ema))
        want = {}
        jtrainer.logger_train.add_scalar = (
            lambda tag, value, step: want.setdefault(tag, {}).__setitem__(step, float(value)))
        jtrainer.train(jargs)

        argv = ["--device=cpu", f"--output_dir={root / 'torch'}"]
        pargs = cli.parse_args(flags(root, *argv, "--n_epochs=2"))
        first = VQVAETrainer(pargs, torch.device("cpu"), init_state=init)
        first.train(pargs)
        resumed = cli.main(flags(root, *argv, "--n_epochs=3"))
    return dict(root=root, want=want, first=first, resumed=resumed, template=template)


def port_losses(run_dir) -> dict:
    got = {}
    for line in (run_dir / "train" / "scalars.jsonl").read_text().splitlines():
        rec = json.loads(line)
        got.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return got


def test_per_step_losses_match_jax(runs):
    got = port_losses(runs["root"] / "torch" / MODEL)
    assert set(got) == set(TAGS) | {"quantization_loss"}
    worst = max(abs(got[t][k] / v - 1) for t in TAGS for k, v in runs["want"][t].items())
    print(f"per-step losses: worst relative difference {worst:.2e}")
    for tag in TAGS:
        assert sorted(got[tag]) == sorted(runs["want"][tag]) == [8, 16, 24], tag
        for step, want in runs["want"][tag].items():
            np.testing.assert_allclose(got[tag][step], want, rtol=LOSS_RTOL,
                                       err_msg=f"{tag} at step {step}")
    assert got["adversarial_loss"][8] > 0 and got["discriminator_loss"][8] > 0


def test_vqvae_config_json_equals_jax(runs):
    root = runs["root"]
    want = json.loads((root / "jax" / MODEL / "vqvae_config.json").read_text())
    got_text = (root / "torch" / MODEL / "vqvae_config.json").read_text()
    assert json.loads(got_text) == want
    assert got_text == (root / "jax" / MODEL / "vqvae_config.json").read_text()


def test_resume_continues_epoch_step_and_adam(runs):
    first, resumed = runs["first"], runs["resumed"]
    assert first.start_epoch == 0 and first.global_step == 16
    assert resumed.start_epoch == 2 and resumed.global_step == 24
    assert resumed.step.g_backwards == 1  # one step after the resume
    payload = torch.load(runs["root"] / "torch" / MODEL / "checkpoint.pth", weights_only=True)
    assert payload["epoch"] == 3 and payload["global_step"] == 24
    for opt in ("optimizer_g_state_dict", "optimizer_d_state_dict"):
        assert {int(s["step"]) for s in payload[opt]["state"].values()} == {3}, opt


def test_jax_converter_reads_the_port_checkpoint(runs):
    """torch_to_flax_vqvae on the port's checkpoint.pth: the JAX model then
    encodes and reconstructs as the port's does."""
    config, state = load_vqvae_checkpoint(runs["root"] / "torch" / MODEL / "checkpoint.pth")
    params, ema, report = torch_to_flax_vqvae({k: v.numpy() for k, v in state.items()},
                                              *runs["template"])
    jmodel = JaxVQVAE(**config)
    port = VQVAE(**config)
    port.load_state_dict(state, strict=True)
    port.eval()
    x = np.random.default_rng(4).uniform(size=(2, 16, 16, 1)).astype(np.float32)
    variables = {"params": params, "ema": ema}
    with torch.no_grad():
        xt = torch.from_numpy(x).movedim(-1, 1)
        z = port.encode(xt).movedim(1, -1).numpy()
        recon = port.reconstruct(xt).movedim(1, -1).numpy()
    np.testing.assert_allclose(np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                                       method=JaxVQVAE.encode)),
                               z, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                                       method=JaxVQVAE.reconstruct)),
                               recon, rtol=1e-5, atol=1e-5)
    trained = np.asarray(jax.tree_util.tree_leaves(ema)[0])
    assert np.isfinite(trained).all()
