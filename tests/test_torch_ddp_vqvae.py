"""The VQ-VAE + PatchGAN step under DDP in 2 gloo processes on the CPU,
against the JAX package's unsharded step on the whole batch (the twin of
tests/test_vqvae_multichip.py, which holds JAX's sharded step to its
unsharded one).

The tiny VQ-VAE and discriminator of tests/test_torch_vqvae_train.py, batch
8 (4 a rank), LPIPS from one seeded npz. The G step's metrics (means over
both ranks), every VQ-VAE gradient, the codebook and its EMA statistics
after the update (counts and sums all-reduced: the global batch's), then the
D step on one seeded batch of fakes: its loss, every gradient (BatchNorm's mean
and E[x^2] all-reduced, differentiably) and the running statistics. The
tolerances are test_torch_vqvae_train.py's: metrics rtol 1e-5, gradients
1e-4 of each tensor's largest value + 1e-7, EMA state and BatchNorm
statistics rtol 1e-5 / atol 1e-6. Both ranks hold the same codebook and
statistics bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.losses.gan import discriminator_loss as jax_d_loss
from ddpm_ood_tpu.losses.lpips import PerceptualLoss as JaxPerceptual
from ddpm_ood_tpu.losses.lpips import load_lpips_npz
from ddpm_ood_tpu_torch.utils.convert import jax_discriminator_params_to_state_dict
from test_torch_discriminator import port_disc, seeded_disc
from test_torch_reconstruct import write_lpips_npz
from test_torch_vqvae import CONFIG, port_vqvae, seeded_vqvae
from test_torch_vqvae_train import (
    ADV_W, LR, LOSS_RTOL, PORT_QUANT, QUANT_KEYS, STATE_TOL, assert_grads, jax_states,
    jax_steps, nchw, seeded_ema, vq_tree,
)
from torch_ddp_worker import finish, results, start

BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_vqvae")
    npz = write_lpips_npz(tmp / "lpips.npz")
    vq, params, ema = seeded_vqvae(2)
    ema = seeded_ema(ema)
    disc, d_params, d_stats = seeded_disc(2)
    rng = np.random.default_rng(3)
    images, fake = (rng.uniform(size=(BATCH, 16, 16, 1)).astype(np.float32) for _ in range(2))
    torch.save({"config": dict(CONFIG), "vq_state": port_vqvae(2, params, ema).state_dict(),
                "disc_state": port_disc(2, d_params, d_stats).state_dict(),
                "images": nchw(images), "d_fake": nchw(fake), "lr": LR, "adv_w": ADV_W,
                "lpips": str(npz)}, tmp / "in.pt")
    ranks = start("vqvae_step", tmp / "in.pt", tmp)  # JAX's steps are computed meanwhile
    s = dict(npz=npz, vq=vq, params=params, ema=ema, disc=disc, d_params=d_params,
             d_stats=d_stats, images=images,
             jax_perceptual=JaxPerceptual(dimensions=2, params=load_lpips_npz(str(npz))))
    g_state, d_state = jax_states(s)
    steps = jax_steps(s)
    x = jnp.asarray(images)
    # the G and D steps' own value_and_grad on the whole batch (one
    # microbatch): their gradients, metrics, EMA statistics and BatchNorm
    # statistics, before Adam
    loss_fn = steps._g_loss_fn(g_state, d_state, None, ADV_W)
    (_, (new_ema, metrics)), want_g_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(g_state.params, x)
    recon = jnp.asarray(fake)

    def d_loss_fn(p):
        lf, new = disc.apply({"params": p, "batch_stats": d_stats}, recon, True,
                             mutable=["batch_stats"])
        lr_, new = disc.apply({"params": p, "batch_stats": new["batch_stats"]}, x, True,
                              mutable=["batch_stats"])
        d_loss = jax_d_loss(lf[-1], lr_[-1])
        return ADV_W * d_loss, (new["batch_stats"], d_loss)

    (_, (new_stats, want_d_loss)), want_d_grads = jax.jit(
        jax.value_and_grad(d_loss_fn, has_aux=True))(d_params)
    finish(ranks)
    zeros = jax.tree_util.tree_map(np.zeros_like, d_stats)
    return dict(ranks=results(tmp), ema=ema, metrics=metrics, new_ema=new_ema,
                g_grads=vq_tree(want_g_grads, ema), d_loss=float(want_d_loss),
                d_grads={k: v for k, v in jax_discriminator_params_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, want_d_grads), zeros).items()
                    if "running" not in k},
                d_stats=jax_discriminator_params_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, d_params),
                    jax.tree_util.tree_map(np.asarray, new_stats)))


def test_generator_step_metrics_and_gradients_match_jax(pair):
    for r in pair["ranks"]:
        for tag, got in r["metrics"].items():
            np.testing.assert_allclose(got, float(pair["metrics"][tag]), rtol=LOSS_RTOL,
                                       err_msg=tag)
        assert sorted(r["g_grads"]) == sorted(pair["g_grads"])
        assert_grads(r["g_grads"], pair["g_grads"], "G grad")


def test_codebook_ema_is_the_global_batch_update(pair):
    want = pair["new_ema"]["quantizer"]
    for r in pair["ranks"]:
        for key in QUANT_KEYS:
            np.testing.assert_allclose(r["quantizer"][PORT_QUANT[key]].numpy(),
                                       np.asarray(want[key]), err_msg=key, **STATE_TOL)
    a, b = (r["quantizer"] for r in pair["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not np.allclose(a["embedding.weight"].numpy(), pair["ema"]["quantizer"]["embedding"])


def test_discriminator_step_with_global_batchnorm_matches_jax(pair):
    for r in pair["ranks"]:
        np.testing.assert_allclose(r["d_loss"], pair["d_loss"], rtol=LOSS_RTOL)
        assert_grads(r["d_grads"], pair["d_grads"], "D grad")
        for key in (k for k in pair["d_stats"] if "running" in k):
            np.testing.assert_allclose(r["d_state"][key].numpy(), pair["d_stats"][key].numpy(),
                                       err_msg=key, **STATE_TOL)
    a, b = (r["d_state"] for r in pair["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a if "running" in k)
