"""The port's VQ-VAE + PatchGAN training against the JAX package's, on the CPU.

The tiny VQ-VAE of tests/test_torch_vqvae.py (channels [8, 8], two levels,
16 codes of width 4) and a discriminator of 8 base channels, 2D at 16x16,
batch 4, seeded params, codebook, EMA statistics and BatchNorm statistics
carried into the port by the converters; LPIPS from one seeded npz read by
both packages. Inputs are numpy draws from a seed.

Tolerances, fp32 on both sides:
- losses and metrics: rtol 1e-5 (one VQ-VAE forward agrees to ~1e-6);
- gradients: per tensor max|got - want| <= 1e-4 * max|want| + 1e-7 (the
  backward sums in another order, XLA against oneDNN);
- params after one Adam update: atol 2e-6 at lr 1e-3. Adam's first update
  is lr * g / (|g| + eps), so a gradient element with a relative error e
  moves by lr * e; 2e-6 is lr * 2e-3. The G step is held after its own
  gradients. D's convolutions before a train-mode BatchNorm have gradient
  elements ~1e-4 of the largest whose relative rounding error is of order
  1, which that first update turns into up to lr, so D's Adam is held on
  JAX's gradients (its own are held above);
- the EMA statistics and codebook after the update, and BatchNorm running
  statistics: rtol 1e-5, atol 1e-6;
- the quantizer's indices: equal outside near-ties (tests/test_torch_vqvae.py's
  ``TIE_MARGIN``), which the test names with their margins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_ood_tpu.losses.gan import discriminator_loss as jax_d_loss
from ddpm_ood_tpu.losses.gan import generator_adversarial_loss as jax_g_adv
from ddpm_ood_tpu.losses.lpips import PerceptualLoss as JaxPerceptual
from ddpm_ood_tpu.losses.lpips import load_lpips_npz
from ddpm_ood_tpu.losses.spectral import jukebox_loss as jax_jukebox
from ddpm_ood_tpu.models.vqvae import EMAQuantizer as JaxQuantizer
from ddpm_ood_tpu.train.vqvae import DiscState, VQVAEState, VQVAETrainSteps
from ddpm_ood_tpu.train.vqvae import adversarial_weight as jax_adversarial_weight
from ddpm_ood_tpu_torch.losses.gan import discriminator_loss, generator_adversarial_loss
from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
from ddpm_ood_tpu_torch.losses.spectral import jukebox_loss
from ddpm_ood_tpu_torch.models.vqvae import EMAQuantizer
from ddpm_ood_tpu_torch.train.vqvae import VQVAETrainStep, adversarial_weight
from ddpm_ood_tpu_torch.utils.convert import (
    jax_discriminator_params_to_state_dict, jax_vqvae_params_to_state_dict,
)
from test_torch_discriminator import port_disc, seeded_disc
from test_torch_reconstruct import write_lpips_npz
from test_torch_vqvae import CONFIG, TIE_MARGIN, _nearest_two, port_vqvae, seeded_vqvae

LR = 1e-3
ADV_W = 0.5  # large, so the adversarial term moves the G gradients visibly
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
ADAM_ATOL = 2e-6
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
QUANT_KEYS = ("embedding", "cluster_size", "embed_avg")
PORT_QUANT = {"embedding": "embedding.weight", "cluster_size": "ema_cluster_size",
              "embed_avg": "ema_w"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def seeded_ema(ema, seed: int = 5):
    """Positive cluster sizes and the matching embedding sums, as training
    leaves them (test_torch_vqvae's draw gives unit normals everywhere)."""
    rng = np.random.default_rng(seed)
    q = dict(ema["quantizer"])
    n = q["embedding"].shape[0]
    q["cluster_size"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    q["embed_avg"] = (q["embedding"] * q["cluster_size"][:, None]).astype(np.float32)
    return {"quantizer": q}


def assert_grads(got: dict, want: dict, what: str):
    for name, w in want.items():
        g = got[name]
        assert g is not None, f"{what} {name}: no gradient"
        err = (g.detach() - w).abs().max().item()
        tol = GRAD_RTOL * w.abs().max().item() + GRAD_ATOL
        assert err <= tol, f"{what} {name}: max abs err {err:.3e} > {tol:.3e}"


def assert_params(got: dict, want: dict, what: str):
    for name, w in want.items():
        err = (got[name].detach() - w).abs().max().item()
        assert err <= ADAM_ATOL, f"{what} {name}: max abs err {err:.3e} > {ADAM_ATOL:.0e}"


def assert_ema(quantizer: EMAQuantizer, want_ema):
    for key in QUANT_KEYS:
        got = quantizer.state_dict()[PORT_QUANT[key]].numpy()
        np.testing.assert_allclose(got, np.asarray(want_ema["quantizer"][key]), err_msg=key,
                                   **STATE_TOL)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded weights for both packages, images, LPIPS in both."""
    npz = write_lpips_npz(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    vq, params, ema = seeded_vqvae(2)
    ema = seeded_ema(ema)
    disc, d_params, d_stats = seeded_disc(2)
    images = np.random.default_rng(3).uniform(size=(4, 16, 16, 1)).astype(np.float32)
    return dict(npz=npz, vq=vq, params=params, ema=ema, disc=disc, d_params=d_params,
                d_stats=d_stats, images=images,
                jax_perceptual=JaxPerceptual(dimensions=2, params=load_lpips_npz(str(npz))))


def jax_states(s):
    g = VQVAEState.create(apply_fn=s["vq"].apply, params=s["params"], tx=optax.adam(LR),
                          ema=s["ema"])
    d = DiscState.create(apply_fn=s["disc"].apply, params=s["d_params"], tx=optax.adam(5e-4),
                         batch_stats=s["d_stats"])
    return g, d


def jax_steps(s, grad_accum=1):
    return VQVAETrainSteps(spatial_dims=2, perceptual_weight=0.001,
                           perceptual_fn=s["jax_perceptual"], grad_accum=grad_accum,
                           quant_decay=CONFIG["decay"], quant_epsilon=CONFIG["epsilon"])


def port_step(s, grad_accum=1) -> VQVAETrainStep:
    return VQVAETrainStep(
        model=port_vqvae(2, s["params"], s["ema"]),
        discriminator=port_disc(2, s["d_params"], s["d_stats"]), spatial_dims=2,
        perceptual=PerceptualLoss(weights_path=str(s["npz"]), spatial_dims=2),
        vqvae_lr=LR, grad_accum=grad_accum)


def vq_tree(tree, ema) -> dict:
    """A JAX VQ-VAE params-shaped tree in the port's keys, conv leaves only."""
    sd = jax_vqvae_params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), ema)
    return {k: v for k, v in sd.items() if not k.startswith("quantizer.")}


@pytest.fixture(scope="module")
def g_step_pair(setup):
    """One G step in each package from the same state (grad_accum 1)."""
    s = setup
    g_state, d_state = jax_states(s)
    steps = jax_steps(s)
    loss_fn = steps._g_loss_fn(g_state, d_state, None, ADV_W)
    (_, (_, want_metrics)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(g_state.params, jnp.asarray(s["images"]))
    new_g, metrics = steps.make_generator_step()(g_state, d_state, jnp.asarray(s["images"]),
                                                  jnp.float32(ADV_W))
    step = port_step(s)
    got_metrics, recon = step.generator_step(nchw(s["images"]), ADV_W)
    return dict(want_metrics=want_metrics, want_grads=want_grads, new_g=new_g,
                metrics=metrics, step=step, got_metrics=got_metrics, recon=recon)


@pytest.mark.parametrize("dims", [2, 3])
def test_gan_losses_match_jax(dims):
    rng = np.random.default_rng(dims)
    fake, real = (rng.standard_normal((2,) + (5,) * dims + (1,)).astype(np.float32)
                  for _ in range(2))
    np.testing.assert_allclose(generator_adversarial_loss(nchw(fake)).item(),
                               float(jax_g_adv(jnp.asarray(fake))), rtol=1e-6)
    np.testing.assert_allclose(discriminator_loss(nchw(fake), nchw(real)).item(),
                               float(jax_d_loss(jnp.asarray(fake), jnp.asarray(real))),
                               rtol=1e-6)


@pytest.mark.parametrize("dims", [2, 3])
def test_jukebox_loss_and_its_gradient_match_jax(dims):
    """|FFT| over the spatial dims (2 onwards of channels-first), ortho."""
    rng = np.random.default_rng(10 + dims)
    shape = (2,) + (16,) * dims + (1,) if dims == 2 else (2, 8, 12, 16, 1)
    recon, target = (rng.uniform(size=shape).astype(np.float32) for _ in range(2))
    want, want_g = jax.value_and_grad(lambda r: jax_jukebox(r, jnp.asarray(target), dims))(
        jnp.asarray(recon))
    r = nchw(recon).requires_grad_()
    got = jukebox_loss(r, nchw(target), dims)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    g = np.moveaxis(r.grad.numpy(), 1, -1)
    np.testing.assert_allclose(g, np.asarray(want_g), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_g)).max())


def test_quantizer_ema_update_matches_jax(setup):
    """One train-mode forward and update against EMAQuantizer(train=True):
    quantized output, commitment loss, indices, and the new cluster sizes,
    sums and codebook."""
    q = setup["ema"]["quantizer"]
    z = np.random.default_rng(7).standard_normal((3, 4, 4, 4)).astype(np.float32)
    jq = JaxQuantizer(16, 4, commitment_cost=0.25, decay=0.9, epsilon=1e-5)
    (want_q, want_loss, want_idx), new = jq.apply({"ema": {k: q[k] for k in QUANT_KEYS}},
                                                  jnp.asarray(z), True, mutable=["ema"])
    port = EMAQuantizer(16, 4, commitment_cost=0.25, decay=0.9, epsilon=1e-5)
    port.load_state_dict({PORT_QUANT[k]: torch.from_numpy(np.asarray(q[k])) for k in QUANT_KEYS})
    port.train()
    got_q, got_loss, got_idx = port(nchw(z))
    port.ema_update()
    _, _, gap = _nearest_two(z, np.asarray(q["embedding"]))
    ties = gap <= TIE_MARGIN
    print(f"quantizer: {int(ties.sum())} of {gap.size} positions within {TIE_MARGIN} of a tie"
          + (f" (margins {gap[ties]})" if ties.any() else ""))
    np.testing.assert_array_equal(got_idx.numpy().reshape(-1), np.asarray(want_idx).reshape(-1))
    np.testing.assert_allclose(np.moveaxis(got_q.detach().numpy(), 1, -1), np.asarray(want_q),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    assert_ema(port, {"quantizer": new["ema"]})
    port.ema_update()  # nothing gathered since: a no-op
    assert_ema(port, {"quantizer": new["ema"]})


def test_quantizer_gradients_are_the_straight_through_ones():
    """d(loss)/dz = 2 * cc * (z - e[idx]) / numel, and the quantized
    output passes its gradient to z unchanged; the codebook is no
    parameter."""
    port = EMAQuantizer(16, 4).train()
    assert list(port.named_parameters()) == []
    assert set(port.state_dict()) == {"embedding.weight", "ema_cluster_size", "ema_w"}
    z = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0), requires_grad=True)
    out, loss, idx = port(z)
    (g_loss,) = torch.autograd.grad(loss, z, retain_graph=True)
    e = port.embedding.weight[idx].movedim(-1, 1)
    torch.testing.assert_close(g_loss, 2 * 0.25 * (z - e).detach() / z.numel())
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (g_out,) = torch.autograd.grad((out * w).sum(), z)
    torch.testing.assert_close(g_out, w)


def test_straight_through_gives_the_encoder_a_gradient(setup):
    """The reconstruction's L1 alone reaches every encoder weight through
    the quantizer."""
    model = port_vqvae(2, setup["params"], setup["ema"]).train()
    x = nchw(setup["images"])
    recon, _ = model(x)
    torch.mean(torch.abs(recon - x)).backward()
    for name, p in model.encoder.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name


def test_generator_step_metrics_match_jax(g_step_pair):
    r = g_step_pair
    for tag, got in r["got_metrics"].items():
        for want in (r["want_metrics"][tag], r["metrics"][tag]):
            np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, err_msg=tag)
    assert r["got_metrics"]["adversarial_loss"].item() > 0
    np.testing.assert_allclose(np.moveaxis(r["recon"].numpy(), 1, -1),
                               np.asarray(r["metrics"]["recon"]), rtol=1e-5, atol=1e-5)


def test_generator_step_gradients_match_jax(g_step_pair, setup):
    """Every VQ-VAE gradient; the discriminator takes none."""
    r = g_step_pair
    step = r["step"]
    got = {n: p.grad for n, p in step.model.named_parameters()}
    assert sorted(got) == sorted(vq_tree(r["want_grads"], setup["ema"]))
    assert_grads(got, vq_tree(r["want_grads"], setup["ema"]), "G grad")
    assert all(p.grad is None for p in step.discriminator.parameters())
    assert all(p.requires_grad for p in step.discriminator.parameters())


def test_generator_step_adam_and_ema_match_jax(g_step_pair, setup):
    r = g_step_pair
    step = r["step"]
    assert_params(dict(step.model.named_parameters()), vq_tree(r["new_g"].params, setup["ema"]),
                  "G param")
    assert_ema(step.quantizer, r["new_g"].ema)
    assert not np.allclose(step.quantizer.embedding.weight.numpy(),
                           setup["ema"]["quantizer"]["embedding"])


def test_discriminator_step_matches_jax(g_step_pair, setup):
    """Loss, every gradient (adv_weight times the D loss's), the params after
    Adam and the running statistics after the fake then real passes."""
    s, r = setup, g_step_pair
    g_state, d_state = jax_states(s)
    recon = r["metrics"]["recon"]
    images = jnp.asarray(s["images"])

    def loss_fn(p):
        lf, new = s["disc"].apply({"params": p, "batch_stats": s["d_stats"]}, recon, True,
                                  mutable=["batch_stats"])
        lr, _ = s["disc"].apply({"params": p, "batch_stats": new["batch_stats"]}, images,
                                True, mutable=["batch_stats"])
        return ADV_W * jax_d_loss(lf[-1], lr[-1])

    want_grads = jax.jit(jax.grad(loss_fn))(s["d_params"])
    new_d, want_loss = jax_steps(s).make_discriminator_step()(d_state, recon, images,
                                                              jnp.float32(ADV_W))
    step = port_step(s)
    got_loss = step.discriminator_step(nchw(np.array(recon)), nchw(s["images"]), ADV_W)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=LOSS_RTOL)
    zeros = jax.tree_util.tree_map(np.zeros_like, s["d_stats"])
    want = jax_discriminator_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_grads), zeros)
    assert_grads({n: p.grad for n, p in step.discriminator.named_parameters()},
                 {k: v for k, v in want.items() if "running" not in k}, "D grad")
    new = jax_discriminator_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, new_d.params),
        jax.tree_util.tree_map(np.asarray, new_d.batch_stats))
    sd = step.discriminator.state_dict()
    for key in (k for k in new if "running" in k):
        np.testing.assert_allclose(sd[key].numpy(), new[key].numpy(), err_msg=key, **STATE_TOL)
    injected = port_step(s)  # Adam on JAX's gradients
    for name, p in injected.discriminator.named_parameters():
        p.grad = want[name].clone()
    injected.opt_d.step()
    assert_params(dict(injected.discriminator.named_parameters()),
                  {k: v for k, v in new.items() if "running" not in k}, "D param")


def test_grad_accum_matches_jax_scan(setup):
    """grad_accum=2 against the JAX package's lax.scan path: the mean metrics,
    the params after Adam, and the EMA update from both microbatches'
    statistics against the original codebook."""
    s = setup
    g_state, d_state = jax_states(s)
    new_g, metrics = jax_steps(s, grad_accum=2).make_generator_step()(
        g_state, d_state, jnp.asarray(s["images"]), jnp.float32(ADV_W))
    step = port_step(s, grad_accum=2)
    got, recon = step.generator_step(nchw(s["images"]), ADV_W)
    assert step.g_backwards == 2 and recon.shape == (4, 1, 16, 16)
    for tag, value in got.items():
        np.testing.assert_allclose(value.item(), float(metrics[tag]), rtol=LOSS_RTOL, err_msg=tag)
    assert_params(dict(step.model.named_parameters()), vq_tree(new_g.params, s["ema"]),
                  "G param (accum 2)")
    assert_ema(step.quantizer, new_g.ema)


def test_grad_accum_gradients_equal_the_whole_batch(setup):
    """Two microbatches' mean gradient is the whole batch's, within fp32
    rounding, and so is the EMA update."""
    s = setup
    whole, halves = port_step(s), port_step(s, grad_accum=2)
    whole.generator_step(nchw(s["images"]), ADV_W)
    halves.generator_step(nchw(s["images"]), ADV_W)
    want = {n: p.grad for n, p in whole.model.named_parameters()}
    assert_grads({n: p.grad for n, p in halves.model.named_parameters()}, want, "accum grad")
    for key in PORT_QUANT.values():
        torch.testing.assert_close(halves.quantizer.state_dict()[key],
                                   whole.quantizer.state_dict()[key], rtol=1e-5, atol=1e-6)


def test_eval_step_matches_jax(setup):
    s = setup
    g_state, d_state = jax_states(s)
    want = jax_steps(s).make_eval_step()(g_state, d_state, jnp.asarray(s["images"]))
    step = port_step(s)
    before = step.quantizer.embedding.weight.clone()
    got, recon = step.eval_step(nchw(s["images"]))
    for tag, value in got.items():
        np.testing.assert_allclose(value.item(), float(want[tag]), rtol=LOSS_RTOL, err_msg=tag)
    assert torch.equal(step.quantizer.embedding.weight, before)  # eval gathers nothing
    assert step.quantizer._stats is None


def test_adversarial_weight_matches_jax():
    for warmup in (True, False):
        for epoch in range(0, 120, 7):
            assert adversarial_weight(0.01, epoch, warmup) == jax_adversarial_weight(
                0.01, epoch, warmup)
    assert adversarial_weight(0.01, 25, True) == pytest.approx(0.005)
