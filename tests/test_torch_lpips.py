"""The port's LPIPS (losses/lpips.py) against the JAX package's, on the CPU.

The JAX package's LPIPS params (its seeded init, whose ``lin`` weights have
negative entries that the clamp must zero) are carried to the port by
``utils.convert.jax_lpips_params_to_state_dict`` or through an npz that the
JAX package's ``save_lpips_npz`` writes; inputs are numpy draws from a seed.

Tolerances, fp32 on both sides (XLA and oneDNN convolutions sum in
different orders):
- AlexNet taps: atol 2e-5 (4.3e-6 observed; taps reach ~3 after conv0).
- LPIPS distances: atol 1e-6 on values ~0.04 (7.5e-9 observed): the taps
  are unit-normalized before they are differenced.
- fake-3D volumes (means of slice distances): atol 1e-6, as the distances.
- padding and weight conversion: exact.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.losses import lpips as jl
from ddpm_ood_tpu_torch.losses import lpips as pl
from ddpm_ood_tpu_torch.utils.convert import jax_lpips_params_to_state_dict, load_params_npz

TAP_ATOL, DIST_ATOL = 2e-5, 1e-6
# the JAX package's seeded LPIPS init as one jitted program: bit-equal to the
# eager init, whose op-by-op compiles take ~12 s the first time in a process
# (~4 s here); the other LPIPS parity tests import it
jax_lpips_init = jax.jit(functools.partial(jl.init_lpips_params, image_hw=32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return jax_lpips_init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port(jax_params):
    return pl.PerceptualLoss(state_dict=jax_lpips_params_to_state_dict(jax_params))


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=shape).astype(np.float32) for _ in range(2)]


def test_lin_weights_exercise_the_clamp(jax_params):
    lins = [np.asarray(jax_params["params"][f"lin{i}"]) for i in range(5)]
    assert all((w < 0).any() and (w > 0).any() for w in lins)


@pytest.mark.parametrize("channels", [1, 3])
def test_alexnet_taps_match_jax(jax_params, port, channels):
    (x, _) = _pair((2, 32, 32, channels), seed=channels)
    x3 = np.tile(x, (1, 1, 1, 3 // channels))
    scaled = ((2.0 * x3 - 1.0) - jl._SHIFT) / jl._SCALE  # what LPIPS feeds the trunk
    want = jl.AlexNetFeatures().apply({"params": jax_params["params"]["net"]},
                                      jnp.asarray(scaled))
    got = port.lpips.net(torch.from_numpy(scaled).permute(0, 3, 1, 2))
    assert [tuple(w.shape) for w in want] == [(2, 7, 7, 64), (2, 3, 3, 192), (2, 1, 1, 384),
                                              (2, 1, 1, 256), (2, 1, 1, 256)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=TAP_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(3, 32, 32, 3), (3, 32, 32, 1), (2, 40, 36, 3)])
def test_lpips_distances_match_jax(jax_params, port, shape):
    x, y = _pair(shape, seed=sum(shape))
    want = jax.jit(jl.LPIPS().apply)(jax_params, jnp.asarray(x), jnp.asarray(y))
    got = port.lpips(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DIST_ATOL, rtol=0)


@pytest.mark.parametrize("channels", [1, 3])
def test_perceptual_loss_pads_and_scores_lanes_like_jax(jax_params, port, channels):
    """16x16 images (zero-padded to 32 on both sides), 3 lanes of
    reconstructions each scored against the same images, as the sweep does."""
    x, _ = _pair((2, 16, 16, channels), seed=10 + channels)
    recon = np.random.default_rng(20 + channels).uniform(size=(3,) + x.shape).astype(np.float32)
    jloss = jax.jit(jl.PerceptualLoss(dimensions=2, params=jax_params))
    want = np.stack([np.asarray(jloss(jnp.asarray(x), jnp.asarray(r))) for r in recon])
    got = port(torch.from_numpy(x), torch.from_numpy(recon))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=DIST_ATOL, rtol=0)
    np.testing.assert_allclose(port(torch.from_numpy(x), torch.from_numpy(recon[1])).numpy(),
                               want[1], atol=DIST_ATOL, rtol=0)
    with pytest.raises(ValueError, match="lanes"):
        port(torch.from_numpy(x), torch.from_numpy(recon[..., :8, :]))


@pytest.fixture(scope="module")
def shared_npz(jax_params, tmp_path_factory):
    """One LPIPS npz that both packages read, written by the JAX package."""
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    jl.save_lpips_npz(jax_params, path)
    return path


@pytest.mark.parametrize("average_views,drop_ratio", [(False, 0.0), (True, 0.0), (False, 0.5)],
                         ids=["last_view", "average_views", "drop_half"])
def test_fake_3d_perceptual_loss_matches_jax(shared_npz, average_views, drop_ratio):
    """(2, 12, 10, 8, 1) volumes (a different size per axis, so a wrong view
    permutation shows), 2 lanes of reconstructions; the port computes only
    the last view unless average_views asks for all three."""
    x, _ = _pair((2, 12, 10, 8, 1), seed=40)
    recon = np.random.default_rng(41).uniform(size=(2,) + x.shape).astype(np.float32)
    jloss = jax.jit(jl.PerceptualLoss(dimensions=3, is_fake_3d=True, weights_path=shared_npz,
                                      average_views=average_views, drop_ratio=drop_ratio))
    want = np.stack([np.asarray(jloss(jnp.asarray(x), jnp.asarray(r))) for r in recon])
    port3d = pl.PerceptualLoss(weights_path=shared_npz, spatial_dims=3,
                               average_views=average_views, drop_ratio=drop_ratio)
    slices = []
    port3d.lpips.net.conv0.register_forward_hook(lambda m, i, o: slices.append(o.shape[0]))
    got = port3d(torch.from_numpy(x), torch.from_numpy(recon))
    assert got.shape == (2, 2) and (got > 0).all()
    np.testing.assert_allclose(got.numpy(), want, atol=DIST_ATOL, rtol=0)
    # the images' slices once, then both lanes': Z slices only, unless averaging
    per_view = [12, 10, 8] if average_views else [8]
    keep = [max(1, int(n * (1 - drop_ratio))) for n in per_view]
    assert slices == [n * f for n in keep for f in (2, 4)]


@pytest.mark.parametrize("dims,average_views", [(2, False), (3, False), (3, True)],
                         ids=["2d", "3d_last_view", "3d_average_views"])
def test_image_features_passed_in_give_the_same_scores(shared_npz, dims, average_views):
    """The latent scoring tail computes the images' taps once and scores
    each decoded lane against them: the scores of one call on every lane
    (DIST_ATOL: a different batch may sum the convolutions differently)."""
    x, _ = _pair((2,) + (12, 10, 8)[:dims] + (1,), seed=42)
    recon = torch.from_numpy(np.random.default_rng(43).uniform(size=(3,) + x.shape)
                             .astype(np.float32))
    loss = pl.PerceptualLoss(weights_path=shared_npz, spatial_dims=dims,
                             average_views=average_views)
    x = torch.from_numpy(x)
    feats = loss.image_features(x)
    assert len(feats) == (3 if average_views else 1)
    per_lane = torch.stack([loss(x, r, y_features=feats) for r in recon])
    torch.testing.assert_close(per_lane, loss(x, recon), rtol=0, atol=DIST_ATOL)


@pytest.mark.parametrize("size", [16, 28, 31, 33])
def test_pad_to_min_32_matches_jax(size):
    x, _ = _pair((2, size, size + 3, 1), seed=size)
    want = np.asarray(jl.pad_to_min_32(jnp.asarray(x)))
    got = pl.pad_to_min_32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1:3] == (max(32, size), max(32, size + 3))
    # lanes in front: the same pad per image
    np.testing.assert_array_equal(pl.pad_to_min_32(torch.from_numpy(x)[None])[0].numpy(), want)


def test_npz_round_trip(jax_params, tmp_path, monkeypatch):
    """The JAX package writes the npz, the port reads it: directly, and
    through LPIPS_WEIGHTS_NPZ as the scoring CLI finds it."""
    path = str(tmp_path / "lpips.npz")
    jl.save_lpips_npz(jax_params, path)
    tree = load_params_npz(path)
    assert tree["params"]["net"]["conv0"]["kernel"].shape == (11, 11, 3, 64)
    assert tree["params"]["lin0"].shape == (64, 1)
    want = jax_lpips_params_to_state_dict(jax_params)
    got = jax_lpips_params_to_state_dict(tree)
    assert got.keys() == want.keys() == pl.LPIPS().state_dict().keys()
    assert got["net.conv0.weight"].shape == (64, 3, 11, 11) and got["lin2.weight"].shape == (
        1, 384, 1, 1)
    assert all(torch.equal(got[k], want[k]) for k in want)
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", path)
    loaded = pl.PerceptualLoss().lpips.state_dict()
    assert all(torch.equal(loaded[k], want[k]) for k in want)


def test_seeded_fallback_without_an_npz(monkeypatch, caplog, tmp_path):
    """No npz: the port's own seeded init, Flax's default distributions, and
    one logged line that names the JAX one-liner writing JAX's fallback."""
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "missing.npz"))
    with caplog.at_level(logging.WARNING, logger=pl.__name__):
        sd = pl.PerceptualLoss().lpips.state_dict()
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1 and "save_lpips_npz(load_lpips_params(), path)" in lines[0]
    again = pl.seeded_lpips_state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in again)
    for name, cin, cout, k, _, _ in pl.ALEX_CONVS:
        w, std = sd[f"net.{name}.weight"], (1.0 / (cin * k * k)) ** 0.5
        assert w.abs().max() <= 2 * std / pl._TRUNC_STD
        assert abs(w.std().item() / std - 1.0) < 0.05, name  # lecun_normal's variance
        assert not sd[f"net.{name}.bias"].any()
    lin = torch.cat([sd[f"lin{i}.weight"].flatten() * (c / 0.2) ** 0.5
                     for i, c in enumerate(pl.ALEX_CHANNELS)])
    assert abs(lin.std().item() - 1.0) < 0.1
