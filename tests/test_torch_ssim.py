"""The port's SSIM (ops/ssim.py) against the JAX package's, on the CPU.

Inputs are numpy draws from a seed in [0, 1]. Tolerance: atol 1e-6 on
1 - SSIM of ~1 (2.4e-7 observed): fp32 statistics on both sides, the same
separable 'VALID' blur, summed by XLA and by oneDNN in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.ops import ssim as jssim
from ddpm_ood_tpu_torch.ops import ssim

ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, *spatial, C): 7x7 and 8x8 clamp the window to 7; 16x16 and 32x32 keep 11
@pytest.mark.parametrize("shape", [(2, 7, 7, 1), (2, 8, 8, 1), (3, 16, 16, 1), (2, 32, 32, 1),
                                   (2, 32, 32, 3), (2, 12, 12, 12, 1)])
def test_ssim_distance_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.uniform(size=shape).astype(np.float32)
    # a noisy copy: SSIM well inside (0, 1), not just two independent draws
    y = np.clip(x + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    want = np.asarray(jssim.ssim_distance(jnp.asarray(x), jnp.asarray(y)))
    got = ssim.ssim_distance(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_identical_images_have_zero_distance():
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 16, 16, 1)).astype(np.float32))
    np.testing.assert_allclose(ssim.ssim_distance(x, x).numpy(), 0.0, atol=1e-6)


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="mismatch"):
        ssim.ssim(torch.zeros(1, 8, 8, 1), torch.zeros(1, 8, 9, 1))
    with pytest.raises(ValueError, match="spatial"):
        ssim.ssim(torch.zeros(8, 8, 1), torch.zeros(8, 8, 1))
