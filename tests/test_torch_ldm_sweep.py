"""The port's latent-diffusion ReconProgram against the JAX package's, on the CPU.

Both programs encode a batch with one tiny VQ-VAE (2D or 3D, the geometry
of tests/test_torch_vqvae.py: 16-pixel sides to 4-latent sides, 4-wide
codes), pad the latents with an asymmetric ``latent_pad`` to 8 per side,
sweep them with one tiny UNet, un-pad, decode (re-quantizing), and score
MSE, fake-3D or 2D LPIPS from one npz, and the ELBO (in latent space).
Weights are seeded JAX params carried into the port by ``utils/convert.py``;
images and the (K, B, *latent, 4) noise are numpy draws handed to both.
fp32 on both sides; plms and dpm grids of 10 steps, 2 lane groups.

Tolerances: mse rtol 1e-4 (the 2D pixel sweep's 1e-5, widened for the
decoder's ~10 extra convolutions after the sweep: the two frameworks sum
convolutions in different orders); perceptual atol 1e-5 (values ~0.05 to
0.3); elbo rtol 1e-5 (it is computed on the encoded latents, before any
decode: tests/test_torch_elbo.py's).

Quantizer near-ties: ``decode_stage_2_outputs`` re-quantizes the denoised
latents, where a tie between two codes can fall either way in two
packages whose latents differ by rounding. A (lane, image) whose latents
hold a position within ``TIE_MARGIN`` (1e-3, in float64 distances of
magnitude ~10; the latents of the two packages differ by ~1e-5, which
moves a distance by ~1e-4) of a tie is counted and printed, and its scores
are held only to be finite; every other entry to the tolerances above.
The draws are seeded, not chosen to avoid ties.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.losses import lpips as jl
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.models.vqvae import VQVAE as JaxVQVAE
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch.diffusion import schedules
from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format
from ddpm_ood_tpu_torch.recon import sweep
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_lpips import jax_lpips_init
from test_torch_unet3d import seeded_jax_params_nd
from test_torch_vqvae import port_vqvae, seeded_vqvae

SCHED_ARGS = ("scaled_linear_beta", 1000, 0.0015, 0.0195)
LATENT_PAD = {2: (2, 2, 0, 4), 3: (2, 2, 0, 4, 4, 0)}  # 4 -> 8 on every latent axis
TIE_MARGIN = 1e-3
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ldm_lpips") / "lpips.npz")
    jl.save_lpips_npz(jax_lpips_init(jax.random.PRNGKey(0)), path)
    return path


def near_tie_entries(latents: torch.Tensor, codebook: np.ndarray, margin: float) -> np.ndarray:
    """(K, B) mask of the (lane, image) entries whose (K, B, *latent, E)
    latents hold a vector within `margin` of a tie between two codes."""
    z = latents.double().numpy()
    flat = z.reshape(-1, z.shape[-1])
    d = ((flat[:, None, :] - codebook[None].astype(np.float64)) ** 2).sum(-1)
    d.sort(axis=1)
    near = (d[:, 1] - d[:, 0]) <= margin
    return near.reshape(z.shape[:2] + (-1,)).any(axis=-1)


@functools.lru_cache(maxsize=None)
def seeded_models(dims: int):
    """The seeded JAX VQ-VAE (model, params, ema) and tiny UNet (model,
    params), once per dimension for both samplers."""
    unet = jax_make_unet("tiny", dims, 4, 4)
    return seeded_vqvae(dims), (unet, seeded_jax_params_nd(unet, (1,) + (8,) * dims + (4,),
                                                           seed=dims))


def run_both(dims: int, sampler: str, lpips_npz: str):
    """(JAX outputs, port outputs, port latents before decode, codebook)."""
    (jvq, vq_params, vq_ema), (unet, params) = seeded_models(dims)
    variables = {"params": vq_params, "ema": vq_ema}
    images = np.random.default_rng(50 + dims).uniform(
        size=(B,) + (16,) * dims + (1,)).astype(np.float32)

    def host_noise(shape, t_starts):
        return np.random.default_rng(60 + dims).standard_normal(shape).astype(np.float32)

    common = dict(num_inference_steps=10, inference_skip_factor=3, num_groups=2,
                  sampler=sampler, score_elbo=True, host_noise_fn=host_noise,
                  latent_pad=LATENT_PAD[dims])
    jprog = jsweep.ReconProgram(
        sched=jsched.make_schedule(*SCHED_ARGS),
        model_fn=jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t), params),
        encode_fn=jax.tree_util.Partial(
            lambda v, x: jvq.apply(v, x, method=JaxVQVAE.encode_stage_2_inputs), variables),
        decode_fn=jax.tree_util.Partial(
            lambda v, z: jvq.apply(v, z, method=JaxVQVAE.decode_stage_2_outputs), variables),
        perceptual_fn=jl.PerceptualLoss(dimensions=dims, is_fake_3d=dims == 3,
                                        weights_path=lpips_npz),
        latent_sample_shape=(8,) * dims + (4,), overlap_host_noise=False, **common)
    want = [np.asarray(a) for a in jprog(jnp.asarray(images), jax.random.PRNGKey(0))]

    model = make_unet("tiny", dims, 4, 4)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    vq = port_vqvae(dims, vq_params, vq_ema)
    latents = []

    def decode(z):
        latents.append(z.clone())
        return vq.decode_stage_2_outputs(z.movedim(-1, 1)).movedim(1, -1)

    prog = sweep.ReconProgram(
        sched=schedules.make_schedule(*SCHED_ARGS),
        model_fn=model.to(memory_format=memory_format(dims)).eval(),
        encode_fn=lambda x: vq.encode_stage_2_inputs(x.movedim(-1, 1)).movedim(1, -1),
        decode_fn=decode, perceptual_fn=PerceptualLoss(weights_path=lpips_npz, spatial_dims=dims),
        latent_sample_shape=(8,) * dims + (4,), **common)
    got = [np.asarray(a) for a in prog(images)]
    codebook = np.asarray(vq_ema["quantizer"]["embedding"])
    return want, got, torch.cat(latents).view((len(prog.t_starts), B) + latents[0].shape[1:]), \
        codebook


@pytest.mark.parametrize("dims,sampler", [(2, "plms"), (2, "dpm"), (3, "plms"), (3, "dpm")])
def test_ldm_recon_program_matches_jax(dims, sampler, lpips_npz):
    want, got, latents, codebook = run_both(dims, sampler, lpips_npz)
    t_starts, mse, perc, elbo = got
    np.testing.assert_array_equal(t_starts, want[0])
    k = len(t_starts)
    assert latents.shape == (k, B) + (4,) * dims + (4,)  # decoded un-padded
    for a in (mse, perc, elbo):
        assert a.shape == (k, B) and np.isfinite(a).all()
    assert (perc > 0).all()
    ties = near_tie_entries(latents, codebook, TIE_MARGIN)
    print(f"{dims}D {sampler}: {int(ties.sum())} of {ties.size} (lane, image) entries hold a "
          f"near-tie of the re-quantization")
    clear = ~ties
    np.testing.assert_allclose(mse[clear], want[1][clear], rtol=1e-4, atol=0)
    np.testing.assert_allclose(perc[clear], want[2][clear], atol=1e-5, rtol=0)
    np.testing.assert_allclose(elbo, want[3], rtol=1e-5, atol=0)


def test_decode_runs_one_lane_at_a_time():
    """Each decode call takes one lane of B latents, and the lane-by-lane
    tables equal the metrics tail of every lane decoded at once."""
    _, vq_params, vq_ema = seeded_vqvae(2)
    vq = port_vqvae(2, vq_params, vq_ema)
    model = make_unet("tiny", 2, 4, 4).to(memory_format=memory_format(2)).eval()
    images = np.random.default_rng(70).uniform(size=(B, 16, 16, 1)).astype(np.float32)
    lanes = []

    def decode(z):
        lanes.append(z.clone())
        return vq.decode_stage_2_outputs(z.movedim(-1, 1)).movedim(1, -1)

    prog = sweep.ReconProgram(
        sched=schedules.make_schedule(*SCHED_ARGS), model_fn=model,
        num_inference_steps=10, inference_skip_factor=3, num_groups=1,
        encode_fn=lambda x: vq.encode_stage_2_inputs(x.movedim(-1, 1)).movedim(1, -1),
        decode_fn=decode, latent_pad=LATENT_PAD[2], score_ssim=True, score_error_maps=True)
    got = [a.numpy() for a in prog(images, torch.Generator().manual_seed(0))[1:]]
    k = len(prog.t_starts)
    assert [z.shape for z in lanes] == [(B, 4, 4, 4)] * k
    with torch.no_grad():
        decoded = vq.decode_stage_2_outputs(torch.cat(lanes).movedim(-1, 1)).movedim(1, -1)
        mse, _, _, ssim_d, err = sweep.metrics_tail(
            torch.from_numpy(images), decoded.reshape((k, B, 16, 16, 1)), score_ssim=True,
            score_error_maps=True)
    np.testing.assert_allclose(got[0], mse.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[2], ssim_d.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(prog.last_error_maps.numpy(), err.numpy() / k, rtol=1e-6,
                               atol=1e-7)
