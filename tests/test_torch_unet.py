"""The port's UNet and weight converter against the JAX package, on the CPU.

- The state_dict key sets equal the monai-generative fixtures, so reference
  ``.pth`` checkpoints load with strict=True.
- The port's converter equals the JAX package's ``flax_to_torch_unet`` key
  for key and array for array.
- A tiny-preset forward equals ``make_unet("tiny")``'s with the same seeded
  random params, converted by the port's converter.

Forward tolerance: atol 2e-5 on outputs of magnitude ~1 in fp32 (2.6e-6
observed). The two frameworks run different convolution algorithms (XLA vs
oneDNN) through ~30 layers, so results differ by accumulated fp32 rounding.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.utils.convert_torch import flax_to_torch_unet
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict

FIXTURES = Path(__file__).parent / "fixtures"
FWD_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_jax_params(unet, seed=0, size=16):
    """Seeded random params in the JAX tree: fan-in-scaled kernels, GroupNorm
    scales near 1, small biases. Not the JAX init, which zeroes conv_out and
    would hide every layer behind a zero output."""
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)),
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
def tiny_jax():
    unet = jax_make_unet("tiny", 2, 1, 1)
    return unet, seeded_jax_params(unet)


@pytest.mark.parametrize("model_type", ["small", "big"])
def test_state_dict_keys_match_monai_fixture(model_type):
    with torch.device("meta"):
        model = make_unet(model_type, 2, 1, 1)
    want = (FIXTURES / f"monai_generative_unet_keys_{model_type}_2d.txt").read_text().split()
    assert sorted(model.state_dict()) == sorted(want)


def test_converter_matches_flax_to_torch_unet(tiny_jax):
    _, params = tiny_jax
    want = flax_to_torch_unet(params)
    got = jax_unet_params_to_state_dict(params)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


def test_tiny_forward_matches_jax(tiny_jax):
    unet, params = tiny_jax
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 16, 1)).astype(np.float32)
    t = np.array([0, 370, 990], np.int32)
    want = np.asarray(jax.jit(unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))

    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model(xt, torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    assert np.abs(want).max() > 0.1  # conv_out is live
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def test_memory_format_does_not_change_the_result():
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 1, 16, 16, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([5, 500])
    with torch.no_grad():
        a = model(x, t)
        b = model.to(memory_format=torch.channels_last)(
            x.contiguous(memory_format=torch.channels_last), t)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(quant="mixed"), dict(quant="int8"), dict(quant="w8")])
def test_unported_variants_raise(kw):
    """The quantised variants are ported (tests/test_torch_quant_unet.py):
    each builds with the unquantised model's state_dict, and a mode the JAX
    package does not have raises."""
    args = dict(model_type="tiny", spatial_dims=2, in_channels=1, out_channels=1)
    with torch.device("meta"):
        want = {k: v.shape for k, v in make_unet(**args).state_dict().items()}
        got = {k: v.shape for k, v in make_unet(**args, **kw).state_dict().items()}
    assert got == want
    with pytest.raises(ValueError, match="quant"):
        make_unet(**args, quant=kw["quant"] + "_fp8")


def test_unknown_model_type():
    with pytest.raises(ValueError, match="Do not recognise model type huge"):
        make_unet("huge", 2, 1, 1)
