"""The port's VQ-VAE and its converter against the JAX package, on the CPU.

Tiny 2D and 3D VQ-VAEs (channels [8, 8], two stride-2 levels, one residual
unit a level, 16 codes of width 4: the geometry of tests/test_ldm_3d.py)
with seeded random params and codebook in the JAX tree, carried into the
port by ``utils/convert.py:jax_vqvae_params_to_state_dict``; and a 3D one of
three stride-2 levels on 24x24x16 volumes, the proportions of the BraTS ROI
that is scored unresized (160x160x128 to 20x20x16 latents; here 3x3x2).

Tolerances, fp32 on both sides:
- encoder output, and decoder output on one quantized input: rtol 1e-5,
  atol 1e-5 on values of magnitude ~1 (XLA and oneDNN sum ~10 convolutions
  in different orders);
- ``ConvTransposeTorchLike`` against ``nn.ConvTranspose``, at an
  output_padding of 1: rtol 1e-5, atol 1e-6;
- quantizer indices: equal wherever the runner-up code's distance exceeds
  the best by more than ``TIE_MARGIN`` (1e-4, against fp32 distances of
  magnitude ~10 that the two packages round differently by ~1e-6). Inside
  the margin the port's index must be one of JAX's two nearest codes; the
  test prints how many positions that was. The latents are seeded draws,
  not chosen to avoid ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.models.vqvae import VQVAE as JaxVQVAE
from ddpm_ood_tpu.models.vqvae import ConvTransposeTorchLike
from ddpm_ood_tpu.utils.convert_torch import flax_to_torch_vqvae
from ddpm_ood_tpu_torch.models.unet import memory_format
from ddpm_ood_tpu_torch.models.vqvae import VQVAE
from ddpm_ood_tpu_torch.utils.checkpoint import load_vqvae_checkpoint, save_checkpoint
from ddpm_ood_tpu_torch.utils.convert import jax_vqvae_params_to_state_dict

CONFIG = dict(in_channels=1, out_channels=1, num_res_layers=1,
              downsample_parameters=((2, 4, 1, 1), (2, 4, 1, 1)),
              upsample_parameters=((2, 4, 1, 1, 0), (2, 4, 1, 1, 0)),
              num_channels=(8, 8), num_res_channels=(8, 8), num_embeddings=16,
              embedding_dim=4, decay=0.99, commitment_cost=0.25, epsilon=1e-5,
              dropout=0.0, ddp_sync=True)
# three levels, as the BraTS-ROI geometry's VQ-VAE (chip_smoke.BRATS_VQVAE)
CONFIG_THREE_LEVELS = dict(CONFIG, downsample_parameters=((2, 4, 1, 1),) * 3,
                           upsample_parameters=((2, 4, 1, 1, 0),) * 3, num_channels=(8, 8, 8),
                           num_res_channels=(8, 8, 8))
# the `pair` fixture's cases: (dims, config, image side(s))
GEOMETRIES = {"2d": (2, CONFIG, (16, 16)), "3d": (3, CONFIG, (16, 16, 16)),
              "3d_three_levels_roi": (3, CONFIG_THREE_LEVELS, (24, 24, 16))}
TIE_MARGIN = 1e-4
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_vqvae(dims: int, seed: int = 0, size=16, config: dict = CONFIG):
    """(JAX model, params, ema) with seeded fan-in-scaled kernels, small
    biases and a unit-normal codebook; `size` one side or a tuple of sides."""
    model = JaxVQVAE(spatial_dims=dims, **config)
    sides = (size,) * dims if isinstance(size, int) else tuple(size)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1,) + sides + (1,)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1].key == "bias":
            v = 0.1 * rng.standard_normal(s.shape)
        else:  # the codebook and its EMA statistics
            v = rng.standard_normal(s.shape)
        return v.astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, filled["params"], filled["ema"]


def port_vqvae(dims, params, ema, config: dict = CONFIG) -> VQVAE:
    model = VQVAE(spatial_dims=dims, **config)
    model.load_state_dict(jax_vqvae_params_to_state_dict(params, ema), strict=True)
    return model.to(memory_format=memory_format(dims)).eval()


def to_port(x: np.ndarray) -> torch.Tensor:
    """(B, *spatial, C) numpy -> (B, C, *spatial) channels-last tensor."""
    return torch.from_numpy(x).movedim(-1, 1)


def from_port(y: torch.Tensor) -> np.ndarray:
    return y.movedim(1, -1).detach().numpy()


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def pair(request):
    """(dims, JAX model, its variables, the port's model, images, config)."""
    dims, config, sides = GEOMETRIES[request.param]
    jmodel, params, ema = seeded_vqvae(dims, size=sides, config=config)
    images = np.random.default_rng(10 + dims if config is CONFIG else 40).uniform(
        size=(2,) + sides + (1,)).astype(np.float32)
    return (dims, jmodel, {"params": params, "ema": ema}, port_vqvae(dims, params, ema, config),
            images, config)


def latent_sides(images: np.ndarray, config: dict) -> tuple:
    """The encoder's latent sides: each image side over 2 a level."""
    return tuple(s >> len(config["num_channels"]) for s in images.shape[1:-1])


def test_encoder_matches_jax(pair):
    dims, jmodel, variables, model, images, config = pair
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), method=JaxVQVAE.encode))
    with torch.no_grad():
        got = from_port(model.encode(to_port(images)))
    assert got.shape == (2,) + latent_sides(images, config) + (4,) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_decoder_matches_jax_on_one_quantized_input(pair):
    dims, jmodel, variables, model, images, config = pair
    codes = np.random.default_rng(20 + dims).integers(
        0, 16, size=(2,) + latent_sides(images, config))
    z = np.asarray(variables["ema"]["quantizer"]["embedding"])[codes]
    want = np.asarray(jmodel.apply(variables, jnp.asarray(z), method=JaxVQVAE.decode))
    with torch.no_grad():
        got = from_port(model.decode(to_port(z)))
    assert got.shape == images.shape
    np.testing.assert_allclose(got, want, **FWD_TOL)
    with torch.no_grad():  # the stage-2 decode re-quantizes codebook vectors to themselves
        staged = from_port(model.decode_stage_2_outputs(to_port(z)))
    np.testing.assert_allclose(staged, want, **FWD_TOL)


def _nearest_two(z: np.ndarray, codebook: np.ndarray):
    """(best, runner-up, gap) per latent vector, in float64."""
    flat = z.reshape(-1, z.shape[-1]).astype(np.float64)
    d = ((flat[:, None, :] - codebook[None].astype(np.float64)) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    best, second = order[:, 0], order[:, 1]
    rows = np.arange(len(flat))
    return best, second, d[rows, second] - d[rows, best]


def test_quantizer_indices_match_jax_outside_near_ties(pair):
    dims, jmodel, variables, model, images, _ = pair
    z = np.asarray(jmodel.apply(variables, jnp.asarray(images), method=JaxVQVAE.encode))
    # seeded latents at the encoder's scale, plus the encoder's own output
    z = np.concatenate([z, np.random.default_rng(30 + dims).standard_normal(
        (6,) + z.shape[1:]).astype(np.float32)])
    _, _, want = jmodel.apply(variables, jnp.asarray(z),
                              method=lambda m, x: m.quantizer(x, False))
    want = np.asarray(want).reshape(-1)
    with torch.no_grad():
        q, _, got = model.quantizer(to_port(z))
    got = got.numpy().reshape(-1)
    codebook = np.asarray(variables["ema"]["quantizer"]["embedding"])
    best, second, gap = _nearest_two(z, codebook)
    clear = gap > TIE_MARGIN
    print(f"{dims}D quantizer: {int((~clear).sum())} of {len(gap)} positions within "
          f"{TIE_MARGIN} of a tie")
    np.testing.assert_array_equal(got[clear], want[clear])
    assert np.all((got[~clear] == best[~clear]) | (got[~clear] == second[~clear]))
    np.testing.assert_array_equal(want[clear], best[clear])
    # the quantized latents are the chosen codes
    np.testing.assert_allclose(from_port(q).reshape(-1, 4), codebook[got], atol=1e-6)


@pytest.mark.parametrize("dims", [2, 3])
def test_conv_transpose_torch_like_with_output_padding(dims):
    """stride 2, kernel 3, padding 1, output_padding 1: 5 -> 10 per axis."""
    layer = ConvTransposeTorchLike(out_channels=3, kernel_size=3, stride=2, padding=1,
                                   output_padding=1)
    x = np.random.default_rng(dims).standard_normal((2,) + (5,) * dims + (4,)).astype(np.float32)
    variables = layer.init(jax.random.PRNGKey(dims), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])
    bias = np.random.default_rng(7).standard_normal(3).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))

    from ddpm_ood_tpu_torch.utils.convert import _to_torch

    conv = {2: torch.nn.ConvTranspose2d, 3: torch.nn.ConvTranspose3d}[dims](
        4, 3, 3, stride=2, padding=1, output_padding=1)
    conv.load_state_dict({"weight": torch.from_numpy(_to_torch(kernel, "convtranspose").copy()),
                          "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = from_port(conv(to_port(x)))
    assert got.shape == (2,) + (10,) * dims + (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_converter_matches_the_jax_export(pair):
    """Key for key and array for array the JAX package's flax_to_torch_vqvae,
    and the port's module takes the keys with strict=True."""
    _, _, variables, model, _, _ = pair
    want = flax_to_torch_vqvae(variables["params"], variables["ema"])
    got = jax_vqvae_params_to_state_dict(variables["params"], variables["ema"])
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_reference_pth_round_trip(pair, tmp_path):
    """A reference-schema .pth with vqvae_config.json beside it loads back into
    an equal model."""
    import json

    dims, _, _, model, images, config = pair
    save_checkpoint(tmp_path / "checkpoint.pth", model.state_dict(), epoch=5)
    cfg = dict(config, spatial_dims=dims)
    (tmp_path / "vqvae_config.json").write_text(json.dumps(cfg))
    config, state = load_vqvae_checkpoint(tmp_path / "checkpoint.pth")
    assert config == cfg
    loaded = VQVAE(**config)
    loaded.load_state_dict(state, strict=True)
    x = to_port(images)
    with torch.no_grad():
        torch.testing.assert_close(loaded.reconstruct(x), model.reconstruct(x), rtol=0, atol=0)


def test_missing_vqvae_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="VQ-VAE checkpoint"):
        load_vqvae_checkpoint(tmp_path / "checkpoint.pth")
    (tmp_path / "checkpoint.pth").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="vqvae_config.json"):
        load_vqvae_checkpoint(tmp_path / "checkpoint.pth")

