"""Checkpoint hot reload in the port: ``BaseTrainer.reload_params`` and
``ScoringService.reload``, on the CPU.

A long-lived BaseTrainer (the serving view of a run) re-reads the run's
checkpoint after the port's trainer (``BaseTrainer.save_checkpoint``) or
``utils/checkpoint.py:save_checkpoint`` wrote a newer one, and then equals a
fresh BaseTrainer on that file. The weights are copied into the model's
existing parameters: every parameter stays the same tensor. An explicit
epoch that has no file raises FileNotFoundError; --use_ema on a checkpoint
without an EMA slot raises RuntimeError.

The JAX package's reload test holds that a reload adds no compiled program.
The port compiles none; its analogue is that the program and its model_fn
stay the same objects, no kernel library is built or loaded, and the
reloaded service scores exactly as a fresh service on the new checkpoint
given the same noise (its generator set to the same state).
"""

import argparse

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.ops import _kernels
from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act
from ddpm_ood_tpu_torch.serve import ScoringService, build_recon_program
from ddpm_ood_tpu_torch.trainers.base import BaseTrainer
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

CPU = torch.device("cpu")
SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(root, **over):
    ns = argparse.Namespace(
        seed=2, output_dir=str(root / "output"), model_name="reload_run", spatial_dimension=2,
        image_size=SIZE, image_roi=None, latent_pad=None, vqvae_checkpoint=None,
        prediction_type="epsilon", model_type="tiny", beta_schedule="scaled_linear_beta",
        beta_start=0.0015, beta_end=0.0195, b_scale=1.0, snr_shift=1, is_grayscale=1,
        use_ema=0, ddpm_checkpoint_epoch=None, learning_rate=2.5e-5, lr_warmup_steps=0,
        ema_decay=0.0, grad_accum_steps=1, num_inference_steps=10, inference_skip_factor=3,
        recon_groups=2)
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _seeded(seed: int) -> dict:
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(seed))
    return model.state_dict()


def _state(trainer) -> dict:
    return {k: v.clone() for k, v in trainer.unet.state_dict().items()}


def test_reload_params_picks_up_new_checkpoint(tmp_path):
    args = _args(tmp_path)
    writer = BaseTrainer(args, CPU, training=True)  # "another process" that trains
    writer.save_checkpoint("checkpoint", 0)
    server = BaseTrainer(args, CPU)
    before = _state(server)
    params = {name: (p, p.data_ptr()) for name, p in server.unet.named_parameters()}

    writer.unet.load_state_dict(_seeded(1))  # training moved the weights
    writer.save_checkpoint("checkpoint", 1)
    path = server.reload_params()
    assert path.name == "checkpoint.pth" and server.start_epoch == 2
    after = _state(server)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    # in place: the same parameter tensors, the same storage
    for name, p in server.unet.named_parameters():
        assert params[name][0] is p and params[name][1] == p.data_ptr()
    # the reloaded weights equal what a fresh restore sees
    fresh = BaseTrainer(args, CPU)
    for k, v in fresh.unet.state_dict().items():
        assert torch.equal(after[k], v), k

    # an explicit epoch, written by utils/checkpoint.py
    save_checkpoint(server.run_dir / "checkpoint_5.pth", _seeded(5), epoch=5)
    assert server.reload_params(5).name == "checkpoint_5.pth"
    for k, v in _seeded(5).items():
        assert torch.equal(server.unet.state_dict()[k], v), k
    # explicit-epoch misses fail loudly
    with pytest.raises(FileNotFoundError, match="epoch 999"):
        server.reload_params(epoch=999)


def test_reload_params_use_ema_needs_the_slot(tmp_path):
    args = _args(tmp_path, use_ema=1)
    run = tmp_path / "output" / "reload_run"
    run.mkdir(parents=True)
    save_checkpoint(run / "checkpoint.pth", _seeded(0), ema_model_state_dict=_seeded(1))
    server = BaseTrainer(args, CPU)
    for k, v in _seeded(1).items():  # the EMA slot is served
        assert torch.equal(server.unet.state_dict()[k], v), k
    save_checkpoint(run / "checkpoint.pth", _seeded(2))  # no EMA slot
    with pytest.raises(RuntimeError, match="ema_model_state_dict"):
        server.reload_params()


def _val_stats(program) -> dict:
    t = np.repeat(np.asarray(program.t_starts, np.int64), 4)
    return {"filename": np.array([f"v{i % 4}" for i in range(len(t))], dtype=object),
            "t": t, "mse": 0.1 + 0.01 * (np.arange(len(t)) % 4),
            "perceptual_difference": np.zeros(len(t))}


def test_service_reload_swaps_weights_in_place(tmp_path):
    args = _args(tmp_path)
    run = tmp_path / "output" / "reload_run"
    run.mkdir(parents=True)
    save_checkpoint(run / "checkpoint.pth", _seeded(0))
    trainer = BaseTrainer(args, CPU)
    program = build_recon_program(trainer, args)
    model_fn = program.model_fn
    svc = ScoringService(program, _val_stats(program), batch_size=4, model_name="t",
                         reload_fn=lambda: str(trainer.reload_params()))
    imgs = np.random.default_rng(0).uniform(size=(2, SIZE, SIZE, 1)).astype("float32")
    before = svc.score(imgs)
    misses = _kernels.library.cache_info().misses  # a build or a load would be a miss

    save_checkpoint(run / "checkpoint.pth", _seeded(1))
    assert svc.reload().endswith("checkpoint.pth")
    noise_state = svc.generator.get_state()
    after = svc.score(imgs)
    # the same program and model_fn, no kernel library built or loaded,
    # different weights -> different scores
    assert svc.program is program and program.model_fn == model_fn
    assert program.model_fn.__self__ is trainer
    assert _kernels.library.cache_info().misses == misses and groupnorm_act.launches == 0
    assert any(b["z_score_mse"] != a["z_score_mse"] for b, a in zip(before, after))
    assert svc.stats["reloads"] == 1

    # a fresh service on the new checkpoint, given the same noise, scores the same
    fresh_trainer = BaseTrainer(args, CPU)
    fresh = ScoringService(build_recon_program(fresh_trainer, args), _val_stats(program),
                           batch_size=4, model_name="t")
    fresh.generator.set_state(noise_state)
    for a, f in zip(after, fresh.score(imgs)):
        assert a["per_t"] == f["per_t"] and a["z_score_mse"] == f["z_score_mse"]

    # no hook -> a loud error (the HTTP layer maps it to 409)
    svc2 = ScoringService(program, _val_stats(program), batch_size=4, model_name="t")
    with pytest.raises(RuntimeError, match="reload hook"):
        svc2.reload()
