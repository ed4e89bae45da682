"""The port's data transforms and latent geometry against the JAX package's, on the CPU.

The BraTS-ROI geometry scores volumes cropped to ``--image_roi`` and not
resized (no ``--image_size``): ``TransformChain`` crops and scales them only,
and the UNet's sample shape is the ROI over the VQ-VAE's total stride
(160x160x128 over three stride-2 levels: (20, 20, 16, 128)) with no
``--latent_pad``. Both are held equal to the JAX package's: the transforms
are numpy in both, so exactly; the geometry is arithmetic.
"""

import types

import numpy as np
import pytest

from ddpm_ood_tpu.data.transforms import TransformChain as JaxTransformChain
from ddpm_ood_tpu.trainers.base import BaseTrainer as JaxBaseTrainer
from ddpm_ood_tpu_torch.data.transforms import TransformChain
from ddpm_ood_tpu_torch.trainers.base import BaseTrainer

# a raw volume larger than the ROI on every axis, with odd margins, and one the
# ROI leaves whole on its last axis
CASES = [((1, 30, 27, 21), (20, 20, 16)), ((1, 24, 24, 16), (20, 20, 16))]


@pytest.mark.parametrize("raw,roi", CASES, ids=["cropped", "last_axis_whole"])
@pytest.mark.parametrize("flip", [None, "vflip", "hflip"])
def test_unresized_roi_chain_matches_jax(tmp_path, raw, roi, flip):
    path = tmp_path / "volume.npy"
    np.save(path, np.random.default_rng(sum(raw)).standard_normal(raw).astype(np.float32) * 7)
    kw = dict(spatial_dimension=3, is_grayscale=True, image_size=None, image_roi=roi,
              add_vflip=flip == "vflip", add_hflip=flip == "hflip")
    got, want = TransformChain(**kw)(str(path)), JaxTransformChain(**kw)(str(path))
    assert got.shape == want.shape == (1,) + roi
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() == 1.0


LEVELS = {2: [[2, 4, 1, 1]] * 2, 3: [[2, 4, 1, 1]] * 3, 4: [[2, 4, 1, 1]] * 4}


@pytest.mark.parametrize("image_size,roi,levels,pad,want", [
    (None, (160, 160, 128), 3, None, (20, 20, 16, 128)),     # the BraTS ROI, unresized
    (128, (160, 160, 128), 4, None, (8, 8, 8, 128)),         # the Decathlon recipe, resized
    (None, (160, 160, 128), 4, (0, 0, 1, 1, 1, 1), (12, 12, 8, 128)),  # a pad on two axes
])
def test_latent_sample_shape_matches_jax(image_size, roi, levels, pad, want):
    common = dict(image_size=image_size, image_roi=roi, spatial_dimension=3,
                  vqvae_config={"downsample_parameters": LEVELS[levels]}, latent_pad=pad,
                  ddpm_channels=128)
    port = types.SimpleNamespace(**common)
    jax_self = types.SimpleNamespace(**common, vqvae_vars=object(), do_latent_pad=bool(pad))
    got = BaseTrainer._latent_sample_shape(port)
    assert got == tuple(JaxBaseTrainer._latent_sample_shape(jax_self)) == want
