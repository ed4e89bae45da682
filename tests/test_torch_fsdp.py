"""``--fsdp=1`` on FSDP2, in 2 gloo processes on the CPU: the cases of the
JAX package's tests/test_fsdp.py.

With every parameter that 2 divides sharded (``DDPM_OOD_TPU_FSDP_MIN_SIZE=1``,
as JAX's test forces): some parameters, some of Adam's state and the EMA
are sharded and the rest replicated; one epoch's loss equals DDP's at rtol
1e-5 and the parameters at atol 2e-5; a checkpoint written by the sharded
run resumes into a sharded run at epoch 1 with the same parameters and EMA
at atol 1e-6, and loads into a plain model; the per-device bytes of the
parameters and Adam's moments are what ``planned_bytes_per_device`` (the
arithmetic of ``bench_fsdp_hbm``) gives; ``train_vqvae --fsdp=1`` shards G
and D and runs an epoch. ``bench_fsdp_hbm --devices=8`` prints its rows with
the JAX script's keys, and the sharding policy leaves the same bytes on a
device as JAX's ``fsdp_shardings`` for every parameter of the tiny UNet.
The sharded step's loss and gradients against JAX's whole-batch step are
held in tests/test_torch_ddp.py, whose ranks and JAX reference they share.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.parallel.fsdp import fsdp_shardings
from ddpm_ood_tpu.parallel.mesh import make_mesh
from ddpm_ood_tpu_torch import bench_fsdp_hbm
from ddpm_ood_tpu_torch.config import parse_args_train_ddpm, parse_args_train_vqvae
from ddpm_ood_tpu_torch.models.unet import make_unet
from ddpm_ood_tpu_torch.parallel import fsdp
from test_torch_ddp import train_args
from test_torch_reconstruct import _split
from torch_ddp_worker import finish, results, start

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

VQ_ARGV = ["--spatial_dimension=2", "--image_size=16", "--vqvae_num_res_layers=1",
           "--vqvae_downsample_parameters=((2,4,1,1),(2,4,1,1))",
           "--vqvae_upsample_parameters=((2,4,1,1,0),(2,4,1,1,0))",
           "--vqvae_num_channels=[8,8]", "--vqvae_num_res_channels=[8,8]",
           "--vqvae_num_embeddings=16", "--vqvae_embedding_dim=4", "--batch_size=2",
           "--is_grayscale=1", "--n_epochs=1", "--eval_freq=1", "--num_workers=2", "--fsdp=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """The 2 ranks start with the module; the tests that need no rank run
    while they do."""
    root = tmp_path_factory.mktemp("fsdp")
    args = train_args(root, n_train=8)
    rng = np.random.default_rng(1)
    args["vqvae"] = vars(parse_args_train_vqvae(
        ["--output_dir", str(root / "output"), "--model_name", "vqf",
         "--training_ids", _split(root, "vq_train", 4, False, rng),
         "--validation_ids", _split(root, "vq_val", 2, False, rng), *VQ_ARGV]))
    (root / "args.json").write_text(json.dumps(args))
    return root, start("fsdp", root / "args.json", root)


@pytest.fixture(scope="module")
def ranks(launched):
    root, proc = launched
    finish(proc)
    return results(root), root


@pytest.fixture(scope="module")
def tiny_param_shapes():
    """The JAX tiny UNet's param tree, shapes only."""
    unet = jax_make_unet("tiny", 2, 1, 1)
    return jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)),
                          jnp.zeros((1,), jnp.int32))["params"]


@pytest.mark.parametrize("min_size", [1, fsdp.DEFAULT_MIN_SIZE])
def test_policy_bytes_match_jax_fsdp_shardings(tiny_param_shapes, min_size):
    params = tiny_param_shapes
    mesh = make_mesh()
    shardings = fsdp_shardings(mesh, params, min_size)
    want = sum(int(np.prod(s.shard_shape(np.shape(x)))) * 4 for x, s in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(shardings)))
    shapes = [tuple(p.shape) for p in make_unet("tiny", 2, 1, 1).parameters()]
    assert fsdp.planned_bytes_per_device(shapes, 8, min_size) == want


def test_bench_fsdp_hbm_prints_its_rows(capsys):
    out = bench_fsdp_hbm.main(["--devices=8"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and out["bench"] == "fsdp_static_hbm"
    assert [r["config"] for r in out["rows"]] == [
        "big 2D UNet (+Adam, +EMA)", "big 3D UNet (+Adam, +EMA)", "3D VQVAE G (+Adam)",
        "3D PatchDiscriminator D (+Adam)"]
    for row in out["rows"]:
        assert set(row) == {"config", "replicated_MiB_per_device", "fsdp_MiB_per_device",
                            "reduction", "devices"}
        assert row["devices"] == 8 and 1 < row["reduction"] <= 8


def test_config_exposes_fsdp_flag():
    base = ["--output_dir", "o", "--model_name", "m", "--training_ids", "t",
            "--validation_ids", "v", "--fsdp", "1"]
    assert parse_args_train_ddpm(base).fsdp == 1
    assert parse_args_train_vqvae(base).fsdp == 1


def test_fsdp_shards_params_optimizer_state_and_ema(ranks):
    for r in ranks[0]:
        assert r["fsdp_sharded_params"] > 0 and r["fsdp_replicated_params"] > 0
        assert r["fsdp_sharded_opt"] > 0
        assert r["fsdp_sharded_ema"] == r["fsdp_sharded_params"]
        assert r["fsdp_resumed_sharded"] == r["fsdp_sharded_params"]


def test_fsdp_epoch_matches_ddp(ranks):
    for r in ranks[0]:
        np.testing.assert_allclose(r["fsdp_loss"], r["ddp_loss"], rtol=1e-5)
        for key, want in r["ddp_params"].items():
            np.testing.assert_allclose(r["fsdp_params"][key].numpy(), want.numpy(), atol=2e-5,
                                       err_msg=key)
    a, b = ranks[0]
    assert all(torch.equal(a["fsdp_params"][k], b["fsdp_params"][k]) for k in a["fsdp_params"])


def test_fsdp_checkpoint_resumes_and_loads_into_a_plain_model(ranks):
    rank_results, root = ranks
    for r in rank_results:
        assert r["fsdp_resume_start"] == 1
        for key, want in r["fsdp_params"].items():
            np.testing.assert_allclose(r["fsdp_resumed_params"][key].numpy(), want.numpy(),
                                       atol=1e-6, err_msg=key)
        for key, want in r["fsdp_saved_ema"].items():
            np.testing.assert_allclose(r["fsdp_resumed_ema"][key].numpy(), want.numpy(),
                                       atol=1e-6, err_msg=key)
    payload = torch.load(root / "output" / "fsdp" / "checkpoint_1.pth", weights_only=True)
    plain = make_unet("tiny", 2, 1, 1)
    plain.load_state_dict(payload["model_state_dict"], strict=True)
    plain.load_state_dict(payload["ema_model_state_dict"], strict=True)
    moments = payload["optimizer_state_dict"]["state"]
    assert all(s["exp_avg"].shape == p.shape for s, p in zip(moments.values(),
                                                             plain.parameters()))


def test_fsdp_bytes_per_device_follow_the_policy(ranks):
    for r in ranks[0]:
        planned = fsdp.planned_bytes_per_device(r["fsdp_shapes"], 2, min_size=1)
        assert r["fsdp_local_bytes"] == 3 * planned  # parameters and Adam's two moments
        assert r["fsdp_local_bytes"] < 3 * fsdp.planned_bytes_per_device(
            r["fsdp_shapes"], 1, min_size=1)


def test_vqvae_trainer_fsdp_flag(ranks):
    rank_results, root = ranks
    for r in rank_results:
        assert all(n > 0 for n in r["vq_sharded"])
        assert np.isfinite(r["vq_loss"])
    assert (root / "output" / "vqf" / "checkpoint.pth").is_file()
