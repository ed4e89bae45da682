"""Data-parallel training of the port in 2 gloo processes on the CPU,
against the JAX package and against the port in one process.

- One DDP step of the tiny UNet on a global batch of 8 (4 a rank, t and
  noise passed in), with grad_accum 1 and 2, against JAX's step on the whole
  batch sharded over the test backend's 8 virtual devices: the loss at rtol
  1e-5 and every gradient at tests/test_torch_train_step.py's tolerance
  (per tensor, 1e-4 of its largest value + 1e-7); both ranks' parameters
  after Adam are bit-identical. The same under ``--fsdp=1``'s FSDP2 wrap,
  whose next two steps' losses equal DDP's at rtol 1e-5.
- The training CLI's trainer in 2 processes (the twin of the JAX package's
  tests/test_multiprocess.py::test_two_process_ddpm_training_with_resume):
  at a vanishing learning rate and (t, noise) a function of each image, the
  epoch's train loss and the validation loss (the mean over both processes'
  images) equal one process's to 1e-5; the replicas are bit-identical after
  two epochs and after a resume from rank 0's checkpoint_2; ``global_step``
  counts each process's images (32 after 4 epochs of 16 images over 2);
  a split of 7 images gives both processes 4.
"""

import argparse
import json

import jax
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.parallel.mesh import make_mesh, replicate
from ddpm_ood_tpu.parallel.mesh import shard_batch as jax_shard_batch
from ddpm_ood_tpu.train.ddpm import DDPMTrainStep as JaxTrainStep
from ddpm_ood_tpu_torch.config import parse_args_train_ddpm
from ddpm_ood_tpu_torch.trainers import DDPMTrainer
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_reconstruct import _split
from test_torch_train_step import (
    GRAD_ATOL, GRAD_RTOL, LR, SCHED_ARGS, assert_tree_close, jax_state, make_inputs, to_torch,
)
from test_torch_unet import seeded_jax_params
from torch_ddp_worker import deterministic_draw, finish, results, start

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("accum", [1, 2])
def test_ddp_step_matches_jax_global_batch(ddp, accum):
    want_loss, want_grads, ranks = ddp["jax_loss"], ddp["jax_grads"], ddp["step"]
    for r in ranks:
        got = r[accum]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        assert_tree_close(got["grads"], want_grads, what=f"grad (accum {accum})")
        assert got["backwards"] == 3 * accum  # three steps
    for key, value in ranks[0][accum]["params"].items():
        assert torch.equal(value, ranks[1][accum]["params"][key]), key
    assert GRAD_RTOL == 1e-4 and GRAD_ATOL == 1e-7  # the tolerance this file states


@pytest.mark.parametrize("accum", [1, 2])
def test_fsdp_step_matches_jax_global_batch(ddp, accum):
    """``--fsdp=1``'s step (``parallel/fsdp.py``: FSDP2's reduce-scatter for
    the sharded parameters, ``sync_replicated_grads`` for the rest) on the
    same inputs: the loss and every gathered gradient against JAX's
    whole-batch step at the DDP test's tolerance. Adam's update does not
    see a uniform scale of the gradients, so this is what holds their
    magnitude; the losses of the next two steps equal DDP's at rtol 1e-5,
    and both ranks' parameters are bit-identical."""
    want_loss, want_grads = ddp["jax_loss"], ddp["jax_grads"]
    for r in ddp["step"]:
        got = r[("fsdp", accum)]
        assert 0 < got["sharded"] < len(got["grads"])  # some sharded, some replicated
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        assert_tree_close(got["grads"], want_grads, what=f"fsdp grad (accum {accum})")
        assert got["backwards"] == 3 * accum
        np.testing.assert_allclose(got["losses"], r[accum]["losses"], rtol=1e-5)
        assert len(set(got["losses"])) == 3  # the updates move the loss
    a, b = (r[("fsdp", accum)]["params"] for r in ddp["step"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def train_args(root, n_train=16) -> dict:
    rng = np.random.default_rng(0)
    argv = ["--output_dir", str(root / "output"), "--model_name", "m",
            "--training_ids", _split(root, "train", n_train, False, rng),
            "--validation_ids", _split(root, "val", 4, False, rng),
            "--image_size=16", "--model_type=tiny", "--is_grayscale=1", "--batch_size=4",
            "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195",
            "--n_epochs=2", "--eval_freq=10", "--checkpoint_every=2", "--num_workers=2"]
    args = vars(parse_args_train_ddpm(argv))
    args["ragged_ids"] = _split(root, "ragged", 7, False, rng)
    return args


def jax_global_step(unet, params, images, t, noise):
    """JAX's loss and gradients on the whole batch, sharded over the 8
    virtual devices."""
    mesh = make_mesh()
    jstep = JaxTrainStep(sched=jax_make_schedule(*SCHED_ARGS), external_noise=True)
    with mesh:
        loss, grads = jax.jit(jstep._grads)(
            jax.device_put(jax_state(unet, params), replicate(mesh)),
            *(jax_shard_batch(mesh, a) for a in (images, noise, t)))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)  # on the host once


def single_process_parity(args: dict) -> tuple:
    """One process's frozen-parameter epoch and validation loss with the
    content-determined draws."""
    a = argparse.Namespace(**{**args, "model_name": "sp_parity", "learning_rate": 1e-30})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = DDPMTrainer(a, torch.device("cpu"))
        single._draw = deterministic_draw(single.sched.num_train_timesteps)
        loss = single.train_epoch(0)
        single.sample_grid = lambda x0: None
        single.val_epoch(0)
    finally:
        torch.set_num_threads(n)
    val = json.loads((single.run_dir / "val" / "scalars.jsonl").read_text().splitlines()[-1])
    return loss, val["value"]


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """The 2 ranks' step and trainer phases in one launch; JAX's step and
    one process's frozen epoch are computed while the ranks run."""
    root = tmp_path_factory.mktemp("ddp")
    (root / "step").mkdir()
    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=3)
    images, t, noise = make_inputs(b=8, seed=4)
    x0, tt, eps = to_torch(images, t, noise)
    torch.save({"state_dict": jax_unet_params_to_state_dict(params), "x0": x0, "t": tt,
                "noise": eps, "sched_args": SCHED_ARGS, "lr": LR}, root / "step" / "in.pt")
    args = train_args(root)
    (root / "args.json").write_text(json.dumps(args))
    ranks = start("ddpm_step", root / "step" / "in.pt", root / "step",
                  "trainer", root / "args.json", root)
    jax_loss, jax_grads = jax_global_step(unet, params, images, t, noise)
    single_loss, single_val = single_process_parity(args)
    output = finish(ranks)
    return dict(step=results(root / "step"), jax_loss=jax_loss, jax_grads=jax_grads,
                ranks=results(root), single_loss=single_loss, single_val=single_val, root=root,
                output=output)


def test_ddp_buckets_take_the_channels_last_gradients_as_they_are(ddp):
    """DDP wraps the channels-last UNet (``parallel/mesh.py:wrap_ddp``)
    without the reducer's warning that a gradient's strides differ from its
    bucket view's, which DDP lays out as the parameter is: a strided copy of
    that gradient every step. (On the card, where cuDNN gives the one-input-
    channel ``conv_in`` weight's gradient standard strides, chip_smoke.py's
    phase_ddp fails on the warning.)"""
    assert "Grad strides do not match bucket view strides" not in ddp["output"]


def test_frozen_epoch_and_validation_losses_match_one_process(ddp):
    for r in ddp["ranks"]:
        assert abs(r["parity_loss"] - ddp["single_loss"]) < 1e-5, r["parity_loss"]
    (val,) = ddp["ranks"][0]["parity_val"]  # rank 0 logs; the value is over both
    assert val["tag"] == "loss" and abs(val["value"] - ddp["single_val"]) < 1e-5
    parts = [r["partition"] for r in ddp["ranks"]]
    assert len(parts[0]) == len(parts[1]) == 8 and not set(parts[0]) & set(parts[1])


def test_replicas_stay_identical_through_training_and_resume(ddp):
    r0, r1 = ddp["ranks"]
    assert r0["digest_b"] == r1["digest_b"] and r0["digest_c"] == r1["digest_c"]
    assert r0["digest_b"] != r0["digest_c"], "the resumed training did not change the weights"
    run = ddp["root"] / "output" / "mp_resume"
    assert (run / "checkpoint_2.pth").is_file() and (run / "checkpoint_4.pth").is_file()
    lines = (run / "train" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 4 * 2  # rank 0 alone logs: 2 steps an epoch, 4 epochs


def test_resume_starts_at_rank0_checkpoint_and_counts_process_images(ddp):
    for r in ddp["ranks"]:
        assert r["resume_start"] == 2
        assert r["global_step"] == 32  # 4 epochs x 16 images / 2 processes
    payload = torch.load(ddp["root"] / "output" / "mp_resume" / "checkpoint_4.pth",
                         weights_only=True)
    assert payload["epoch"] == 4 and payload["global_step"] == 32


def test_ragged_split_gives_equal_partitions(ddp):
    r0, r1 = ddp["ranks"]
    assert len(r0["ragged_partition"]) == len(r1["ragged_partition"]) == 4
    assert len(set(r0["ragged_partition"]) | set(r1["ragged_partition"])) == 7
    assert r0["ragged_step"] == r1["ragged_step"] == 4
    assert r0["ragged_loss"] == r1["ragged_loss"]  # the mean over both processes


def _tiny_unet():
    from ddpm_ood_tpu_torch.models.unet import make_unet

    return make_unet("tiny", 2, 1, 1)


def _small_vqvae():
    from ddpm_ood_tpu_torch.models.vqvae import VQVAE

    return VQVAE(spatial_dims=2, in_channels=1, out_channels=1, num_res_layers=1,
                 downsample_parameters=[[2, 4, 1, 1]] * 2,
                 upsample_parameters=[[2, 4, 1, 1, 0]] * 2, num_channels=[8, 8],
                 num_res_channels=[8, 8], num_embeddings=16, embedding_dim=4)


@pytest.mark.parametrize("model,restrided", [
    (_tiny_unet, {"conv_in.conv.weight"}),
    (_small_vqvae, {"encoder.blocks.0.conv.weight"}),
], ids=["unet", "vqvae"])
def test_wrap_ddp_gives_one_channel_weights_the_standard_strides(model, restrided):
    """``wrap_ddp`` gives the weight of a convolution over one input channel
    (the UNet's ``conv_in``, the VQ-VAE encoder's first) the standard
    strides, as cuDNN strides its gradient; its values, and every other
    parameter's layout (the decoder's last, transposed, convolution to one
    channel included), stay as they were."""
    import torch.distributed as dist

    from ddpm_ood_tpu_torch.parallel import mesh as pmesh

    module = model().to(memory_format=torch.channels_last)
    before = {n: (p.detach().clone(), p.stride()) for n, p in module.named_parameters()}
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        pmesh.wrap_ddp(module, torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    for name, p in module.named_parameters():
        value, stride = before[name]
        assert torch.equal(p.detach(), value), name
        if name in restrided:
            standard = torch.empty(p.shape, device="meta").stride()
            assert stride != standard and p.stride() == standard, name
        else:
            assert p.stride() == stride, name


@pytest.mark.parametrize("module,argv", [
    ("sample", ["--device=cpu", "--output_dir=o", "--model_name=m"]),
    ("quality_check", ["--device=cpu"]),
    ("bench_serve", ["--device=cpu", "--quick"]),
], ids=["sample", "quality_check", "bench_serve"])
def test_single_process_clis_refuse_more_than_one_process(module, argv, monkeypatch):
    """The service's CLIs, the sample CLI and the quality gate run one
    process: a launch of more than one raises a named error before any
    work (the serve CLI's own case is in test_torch_serve_cli.py)."""
    import importlib

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="more than one process"):
        importlib.import_module(f"ddpm_ood_tpu_torch.{module}").main(argv)
