"""The port's 3D UNet against the JAX package's, on the CPU.

A tiny-preset 3D UNet (channels 32/64/64, attention at the deepest level
over its 2x2x2 = 8 tokens) with seeded random params in the JAX tree,
carried into the port by ``utils/convert.py`` (DHWIO -> OIDHW kernels),
gives the JAX forward on one seeded (2, 8, 8, 8, 3) input.

Tolerance: rtol 1e-5 with atol 2e-5 on outputs of magnitude ~1, fp32 on
both sides (the 2D forward's, tests/test_torch_unet.py: XLA and oneDNN sum
the ~30 convolutions in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.utils.convert_torch import flax_to_torch_unet
from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict

SHAPE = (2, 8, 8, 8, 3)  # (B, X, Y, Z, C)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_jax_params_nd(unet, shape, seed=0):
    """Seeded random params of `unet` for inputs of `shape`: fan-in-scaled
    kernels, GroupNorm scales near 1, small biases (the output conv is not
    zeroed, so every layer reaches the output)."""
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1,) + shape[1:]),
                            jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    unet = jax_make_unet("tiny", 3, 3, 3)
    params = seeded_jax_params_nd(unet, SHAPE)
    model = make_unet("tiny", 3, 3, 3)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    return unet, params, model.to(memory_format=memory_format(3)).eval()


def test_3d_forward_matches_jax(pair):
    unet, params, model = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([3, 850], np.int32)
    want = np.asarray(jax.jit(unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(memory_format=memory_format(3))
    with torch.no_grad():
        got = model(xt, torch.from_numpy(t)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == SHAPE and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_3d_converter_matches_the_jax_export(pair):
    """The port's converter gives the JAX package's flax_to_torch_unet, key for
    key and array for array, on 3D kernels (kD, kH, kW, I, O) -> (O, I, kD, kH, kW)."""
    _, params, model = pair
    want = flax_to_torch_unet(params)
    got = jax_unet_params_to_state_dict(params)
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert got["conv_in.conv.weight"].shape == (32, 3, 3, 3, 3)


def test_small_3d_latent_unet_has_the_jax_param_count():
    """The Decathlon LDM's UNet: the small preset in 3D on 128-channel latents."""
    shapes = jax.eval_shape(jax_make_unet("small", 3, 128, 128).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 8, 128)), jnp.zeros((1,), jnp.int32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    got = sum(p.numel() for p in make_unet("small", 3, 128, 128).parameters())
    assert got == want == 47_493_888
