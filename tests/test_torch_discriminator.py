"""The port's PatchGAN discriminator against the JAX package's, on the CPU.

A discriminator of 8 base channels (8 -> 16 -> 32, three layers, as the
VQ-VAE trainer builds it at 64) in 2D at 16x16 and 3D at 16^3, with seeded
params and BatchNorm statistics in the JAX tree carried into the port by
``utils/convert.py:jax_discriminator_params_to_state_dict``.

Tolerances, fp32 on both sides:
- every feature map, in eval mode and in train mode: rtol 1e-5, atol 1e-5
  on values of magnitude ~1 (XLA and oneDNN sum the convolutions in
  different orders; train mode adds the batch statistics' sums);
- the running mean and variance after two train-mode calls (the second on
  the first one's statistics, as the D step chains fake then real):
  rtol 1e-5, atol 1e-6;
- the input gradient and every parameter gradient of the LSGAN D loss in
  train mode: per tensor max|got - want| <= 1e-4 * max|want| + 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.losses.gan import discriminator_loss as jax_discriminator_loss
from ddpm_ood_tpu.models.discriminator import PatchDiscriminator as JaxDisc
from ddpm_ood_tpu_torch.losses.gan import discriminator_loss
from ddpm_ood_tpu_torch.models.discriminator import (
    FlaxBatchNorm, PatchDiscriminator, init_like_flax_,
)
from ddpm_ood_tpu_torch.models.unet import memory_format
from ddpm_ood_tpu_torch.utils.convert import jax_discriminator_params_to_state_dict

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_disc(dims: int, seed: int = 0, size: int = 16):
    """(JAX model, params, batch_stats) with seeded fan-in-scaled kernels,
    small biases, BatchNorm scales near 1 and non-trivial running stats."""
    model = JaxDisc(spatial_dims=dims, num_layers_d=3, num_channels=8, in_channels=1)
    shapes = jax.eval_shape(lambda r, x: model.init(r, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((1,) + (size,) * dims + (1,)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # biases and running means
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, filled["params"], filled["batch_stats"]


def port_disc(dims, params, batch_stats) -> PatchDiscriminator:
    model = PatchDiscriminator(spatial_dims=dims, num_layers_d=3, num_channels=8, in_channels=1)
    model.load_state_dict(jax_discriminator_params_to_state_dict(params, batch_stats),
                          strict=True)
    return model.to(memory_format=memory_format(dims))


def to_port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).movedim(-1, 1)


def from_port(y: torch.Tensor) -> np.ndarray:
    return y.movedim(1, -1).detach().numpy()


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def pair(request):
    dims = request.param
    jmodel, params, stats = seeded_disc(dims)
    rng = np.random.default_rng(40 + dims)
    images = [rng.uniform(size=(2,) + (16,) * dims + (1,)).astype(np.float32) for _ in range(2)]
    return dims, jmodel, params, stats, images


def _assert_features(got, want):
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1:] != () and from_port(g).shape == w.shape, i
        np.testing.assert_allclose(from_port(g), np.asarray(w), err_msg=f"feature {i}",
                                   **FWD_TOL)


def test_feature_list_in_eval_mode_matches_jax(pair):
    dims, jmodel, params, stats, images = pair
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(images[0]), False)
    model = port_disc(dims, params, stats).eval()
    with torch.no_grad():
        got = model(to_port(images[0]))
    assert got[-1].dtype == torch.float32 and got[-1].shape[1] == 1
    _assert_features(got, want)


def test_train_mode_features_and_running_stats_after_two_calls(pair):
    """Batch statistics normalise; the running ones follow Flax's momentum
    0.9 with the biased variance, chained over two calls."""
    dims, jmodel, params, stats, images = pair
    model = port_disc(dims, params, stats).train()
    bs = stats
    for x in images:
        want, new = jmodel.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), True,
                                 mutable=["batch_stats"])
        bs = new["batch_stats"]
        with torch.no_grad():
            got = model(to_port(x))
        _assert_features(got, want)
    for name in ("norm_1", "norm_2"):
        norm = getattr(model, name)
        np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(bs[name]["mean"]),
                                   err_msg=name, **STATS_TOL)
        np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(bs[name]["var"]),
                                   err_msg=name, **STATS_TOL)
        assert not np.allclose(np.asarray(bs[name]["var"]), np.asarray(stats[name]["var"]))


def test_train_mode_gradients_match_jax(pair):
    """The D loss on (fake, real) in train mode: its gradient in every
    parameter and in the fake input (what the G step backpropagates
    through, there in eval mode)."""
    dims, jmodel, params, stats, (fake, real) = pair

    def loss_fn(p, x):
        lf, new = jmodel.apply({"params": p, "batch_stats": stats}, x, True,
                               mutable=["batch_stats"])
        lr, _ = jmodel.apply({"params": p, "batch_stats": new["batch_stats"]},
                             jnp.asarray(real), True, mutable=["batch_stats"])
        return jax_discriminator_loss(lf[-1], lr[-1])

    want_loss, (g_params, g_x) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        params, jnp.asarray(fake))
    model = port_disc(dims, params, stats).train()
    x = to_port(fake).clone().requires_grad_()
    loss = discriminator_loss(model(x)[-1], model(to_port(real))[-1])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = jax_discriminator_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, g_params),
        jax.tree_util.tree_map(np.zeros_like, stats))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(k for k in want if "running" not in k)
    for name, g in grads.items():
        w = want[name]
        err = (g - w).abs().max().item()
        assert err <= GRAD_RTOL * w.abs().max().item() + GRAD_ATOL, (name, err)
    gx = from_port(x.grad)
    np.testing.assert_allclose(gx, np.asarray(g_x), rtol=0,
                               atol=GRAD_RTOL * np.abs(np.asarray(g_x)).max() + GRAD_ATOL)


@pytest.mark.parametrize("dims", [2, 3])
def test_converter_keys_are_the_port_modules(dims):
    _, params, stats = seeded_disc(dims)
    sd = jax_discriminator_params_to_state_dict(params, stats)
    model = PatchDiscriminator(spatial_dims=dims, num_layers_d=3, num_channels=8, in_channels=1)
    assert sorted(sd) == sorted(model.state_dict())
    assert sd["layer_0.weight"].shape == (8, 1) + (4,) * dims
    assert "layer_1.bias" not in sd and "final_conv.bias" in sd


def test_channels_double_up_to_512():
    model = PatchDiscriminator(spatial_dims=2, num_layers_d=4, num_channels=256)
    assert [getattr(model, f"layer_{i}").out_channels for i in range(4)] == [256, 512, 512, 512]
    assert [getattr(model, f"layer_{i}").stride for i in range(4)] == [(2, 2)] * 3 + [(1, 1)]


def test_flax_like_init():
    """lecun-normal kernels (std sqrt(1 / fan_in), truncated at 2 std), zero
    biases, BatchNorm scale 1 and offset 0, as JAX's init draws them."""
    jmodel = JaxDisc(spatial_dims=2, num_layers_d=3, num_channels=64, in_channels=1)
    want = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, 32, 32, 1)), False)["params"])(
        jax.random.PRNGKey(0))
    model = init_like_flax_(PatchDiscriminator(spatial_dims=2, num_channels=64),
                            torch.Generator().manual_seed(0))
    for name in ("layer_1", "layer_2"):
        w = getattr(model, name).weight.detach().numpy()
        k = np.asarray(want[name]["kernel"])
        fan_in = np.prod(k.shape[:-1])
        assert w.shape[1] * 16 == fan_in
        np.testing.assert_allclose(w.std(), k.std(), rtol=0.05)
        np.testing.assert_allclose(w.std(), np.sqrt(1.0 / fan_in), rtol=0.05)
        assert np.abs(w).max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.8796256610342398 + 1e-6
    assert float(model.layer_0.bias.detach().abs().max()) == 0.0
    norms = [m for m in model.modules() if isinstance(m, FlaxBatchNorm)]
    assert len(norms) == 2 and all(float((n.weight.detach() - 1).abs().max()) == 0 for n in norms)
