"""The port's torch-style latent padding against the JAX package's, on the CPU.

``--latent_pad`` is a flat torch ``pad`` tuple, (before, after) pairs from
the last spatial axis back; both packages apply it to channel-last
(B, *spatial, C) tensors. Pad and un-pad are data movement: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.utils import padding as jpad
from ddpm_ood_tpu_torch.utils.padding import padded_shape, pad_torch_style, unpad_torch_style

CASES = [
    ((2, 4, 4, 3), (2, 2, 0, 4)),           # 2D: both axes, asymmetric
    ((2, 4, 5, 3), (1, 0)),                 # 2D: the last axis only
    ((2, 4, 4, 4, 2), (2, 2, 0, 4, 4, 0)),  # 3D: every axis
    ((1, 3, 4, 5, 2), (0, 1, 2, 0)),        # 3D: the last two axes
    ((2, 2, 3, 4, 1), (0, 0, 0, 0, 0, 0)),  # a zero pad
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,pad", CASES)
def test_pad_and_unpad_match_jax(shape, pad):
    x = np.random.default_rng(len(shape) + sum(pad)).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpad.pad_torch_style(jnp.asarray(x), pad))
    got = pad_torch_style(torch.from_numpy(x), pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape[1:-1]) == padded_shape(shape[1:-1], pad)
    np.testing.assert_array_equal(unpad_torch_style(got, pad).numpy(),
                                  np.asarray(jpad.unpad_torch_style(jnp.asarray(want), pad)))
    np.testing.assert_array_equal(unpad_torch_style(got, pad).numpy(), x)


@pytest.mark.parametrize("shape,pad", CASES[::2])
def test_unpad_of_a_lane_stack(shape, pad):
    """(K, B, *spatial, C) stacks un-pad lane by lane, given the spatial rank."""
    x = torch.randn((3,) + shape)
    padded = torch.stack([pad_torch_style(lane, pad) for lane in x])
    torch.testing.assert_close(unpad_torch_style(padded, pad, len(shape) - 2), x, rtol=0, atol=0)


def test_pad_longer_than_the_rank_raises():
    with pytest.raises(ValueError, match="longer than spatial rank"):
        pad_torch_style(torch.zeros(1, 4, 4, 1), (1, 1, 1, 1, 1, 1))
