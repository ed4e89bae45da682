"""Simplex-noise training: the port's trainer against the JAX package's.

- ``DDPMTrainer._simplex_batch``: after one ``np.random.seed`` the port's t
  and noise equal the JAX trainer's bit for bit, for 2D images and for 3D
  latents, and leave numpy's global RNG in the same state.
- The training CLI: both trainers with ``--simplex_noise=1`` on one
  synthetic 16x16 set (16 images, batch 8: the test backend's device count,
  so the JAX trainer pads nothing), 2 epochs and a validation pass, after
  the same ``np.random.seed``, from the same weights (the JAX trainer's
  ``PRNGKey(2)`` init, which the port keeps as an npz). The loaders shuffle alike, the
  trainers draw t and the planes from the global RNG in the same order, so
  every per-step training loss and the validation loss agree within rtol
  2e-5 (the VQ-VAE training CLI's losses agree to ~1.7e-5: Adam's first
  updates turn rounding of near-zero gradients into steps of lr on a few
  weights).
- ``python -m ddpm_ood_tpu_torch.quality_check --simplex`` trains and
  scores with simplex noise at a tiny size and says so in its JSON.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu import config as jax_config
from ddpm_ood_tpu.noise.simplex import Simplex as JaxSimplex
from ddpm_ood_tpu.trainers import DDPMTrainer as JaxDDPMTrainer
from ddpm_ood_tpu.trainers import base as jax_base
from ddpm_ood_tpu.train import ddpm as jax_train
from ddpm_ood_tpu_torch import quality_check as qc
from ddpm_ood_tpu_torch import train_ddpm as cli
from ddpm_ood_tpu_torch.noise.simplex import Simplex
from ddpm_ood_tpu_torch.quality_check import QUALITY_INIT
from ddpm_ood_tpu_torch.trainers.ddpm_trainer import DDPMTrainer
from ddpm_ood_tpu_torch.utils.convert import load_params_npz
from test_torch_train_cli import make_train_set

LOSS_RTOL = 2e-5
MODEL = "simplex_fashionmnist"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sample_shape", [(16, 16, 1), (4, 4, 4, 3)], ids=["2d", "3d_latent"])
def test_simplex_batch_equals_jax(sample_shape):
    sched = types.SimpleNamespace(num_train_timesteps=1000)
    np.random.seed(21)
    jax_self = types.SimpleNamespace(sched=sched, simplex=JaxSimplex(),
                                     _latent_sample_shape=lambda: sample_shape)
    want_t, want = JaxDDPMTrainer._simplex_batch(jax_self, np.zeros((5,) + sample_shape))
    state = np.random.get_state()[1].copy()
    np.random.seed(21)
    port_self = types.SimpleNamespace(sched=sched, simplex=Simplex())
    got_t, got = DDPMTrainer._simplex_batch(port_self, 5, sample_shape)
    assert (np.random.get_state()[1] == state).all()
    assert got_t.dtype == want_t.dtype == np.int32 and (got_t == want_t).all()
    assert got.shape == (5,) + sample_shape and got.tobytes() == want.tobytes()


def _asset_make_ddpm_state(unet, rng, sample_shape, learning_rate=2.5e-5, with_ema=False,
                           lr_warmup_steps=0):
    """``make_ddpm_state`` for the tiny UNet on 16x16x1 from PRNGKey(2), read
    from the port's copy of that init (tests/test_torch_quality_init.py holds
    it equal to a fresh draw) instead of drawn eagerly (~10 s)."""
    import optax

    assert (tuple(sample_shape), lr_warmup_steps, with_ema) == ((16, 16, 1), 0, False)
    assert np.array_equal(jax.random.key_data(rng), jax.random.key_data(jax.random.PRNGKey(2)))
    params = jax.tree_util.tree_map(jnp.asarray, load_params_npz(QUALITY_INIT))
    return jax_train.TrainState.create(apply_fn=unet.apply, params=params,
                                       tx=optax.adam(learning_rate), ema_params=None)


def _flags(root, *extra) -> list:
    return [f"--training_ids={root / 'train.csv'}", f"--validation_ids={root / 'val.csv'}",
            f"--model_name={MODEL}", "--image_size=16", "--model_type=tiny", "--is_grayscale=1",
            "--batch_size=8", "--n_epochs=2", "--eval_freq=2", "--checkpoint_every=2",
            "--num_workers=1", "--learning_rate=1e-3", "--beta_schedule=scaled_linear_beta",
            "--beta_start=0.0015", "--beta_end=0.0195", "--simplex_noise=1", *extra]


def _port_scalars(path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        out[rec["step"]] = rec["value"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("simplex_train")
    make_train_set(root, n_train=16, n_val=8)
    want = {"train": {}, "val": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDPM_OOD_COMPILE_CACHE", "")
        mp.setattr(jax_base, "make_ddpm_state", _asset_make_ddpm_state)
        mp.setattr(JaxDDPMTrainer, "_sample_figure", lambda self, images: None)
        mp.setattr(DDPMTrainer, "sample_grid", lambda self, x0: None)
        jargs = jax_config.parse_args_train_ddpm(_flags(root, f"--output_dir={root / 'jax'}"))
        np.random.seed(7)
        jtrainer = JaxDDPMTrainer(jargs)
        for split, logger in (("train", jtrainer.logger_train), ("val", jtrainer.logger_val)):
            logger.add_scalar = (lambda tag, value, step, split=split:
                                 want[split].__setitem__(int(step), float(value)))
        jtrainer.train(jargs)

        pargs = cli.parse_args(_flags(root, "--device=cpu", f"--output_dir={root / 'torch'}"))
        np.random.seed(7)
        trainer = DDPMTrainer(pargs, torch.device("cpu"), init_weights=QUALITY_INIT)
        trainer.train(pargs)
    return root, want, trainer


def test_per_step_losses_match_the_jax_cli(runs):
    root, want, trainer = runs
    got = _port_scalars(root / "torch" / MODEL / "train" / "scalars.jsonl")
    assert sorted(got) == sorted(want["train"]) == [8, 16, 24, 32]
    worst = max(abs(got[s] / v - 1) for s, v in want["train"].items())
    print(f"per-step losses: worst relative difference {worst:.2e}")
    for step, value in want["train"].items():
        np.testing.assert_allclose(got[step], value, rtol=LOSS_RTOL, err_msg=f"step {step}")
    assert trainer.simplex_noise and trainer.step.backwards == 4


def test_validation_loss_matches_the_jax_cli(runs):
    root, want, _ = runs
    got = _port_scalars(root / "torch" / MODEL / "val" / "scalars.jsonl")
    assert sorted(got) == sorted(want["val"]) == [32]
    np.testing.assert_allclose(got[32], want["val"][32], rtol=LOSS_RTOL)


def test_quality_gate_trains_and_scores_with_simplex_noise(tmp_path):
    payload = qc.main(["--device=cpu", "--simplex", "--epochs=1", "--size=8", "--n_train=8",
                       "--n_eval=4", "--steps=10", "--skip=5", "--samplers=dpm@10/5",
                       f"--workdir={tmp_path}"])
    assert payload["simplex"] is True
    assert 0.0 <= payload["per_sampler"]["dpm@10/5"]["hard"]["auroc"] <= 1.0
