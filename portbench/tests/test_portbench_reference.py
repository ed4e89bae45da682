"""The plain reference against the port at the tiny preset on the CPU, where
the port runs float32 and its kernels' plain versions: the UNet in 2D and
3D, the VQ-VAE's encode and decode, the PLMS and DPM-Solver++ sweeps, LPIPS
and SSIM, and three DDPM training steps with Adam."""

import numpy as np
import pytest
import torch

from portbench import seeds
from portbench.reference import diffusion as rd
from portbench.reference import metrics as rm
from portbench.reference import vqvae as rv
from portbench.reference.train import train_steps
from portbench.reference.unet import unet_forward, unet_param_shapes

TINY = {"num_channels": [32, 64, 64], "attention_levels": [False, False, True],
        "num_res_blocks": 1, "num_head_channels": 64, "norm_num_groups": 8}
VQ = dict(spatial_dims=3, in_channels=1, out_channels=1, num_res_layers=2,
          downsample_parameters=[[2, 4, 1, 1]] * 2, upsample_parameters=[[2, 4, 1, 1, 0]] * 2,
          num_channels=[16, 16], num_res_channels=[16, 16], num_embeddings=32, embedding_dim=8)
CPU = torch.device("cpu")


def _unet(dims, ch, seed=5):
    from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format

    w = seeds.make_weights(unet_param_shapes(TINY, dims, ch), "unet", seed, CPU)
    m = make_unet("tiny", dims, ch, ch).eval()
    m.load_state_dict(w, strict=True)
    return m.to(memory_format=memory_format(dims)), w


@pytest.mark.parametrize("dims,ch", [(2, 1), (3, 8)])
def test_unet_forward_matches_port(dims, ch):
    model, w = _unet(dims, ch)
    x = torch.randn((3, ch) + (16,) * dims, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 500, 990])
    with torch.no_grad():
        got = model(x, t)
        want = unet_forward(w, TINY, x, t)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_vqvae_matches_port():
    from ddpm_ood_tpu_torch.models.vqvae import VQVAE

    w = seeds.make_weights(rv.vqvae_param_shapes(VQ), "vqvae", 3, CPU)
    v = VQVAE(**VQ).eval()
    v.load_state_dict(w, strict=True)
    img = torch.from_numpy(seeds.images((2, 16, 16, 16, 1), 1, 0)).movedim(-1, 1)
    with torch.no_grad():
        z = rv.encode(w, VQ, img)
        # the port's straight-through form z + (code - z) rounds within an ulp
        assert (v.encode_stage_2_inputs(img) - z).abs().max() <= 1e-6
        want = rv.decode(w, VQ, z)
        assert (v.decode_stage_2_outputs(z) - want).abs().max() <= 1e-5
    assert 0.2 < float(want.mean()) < 0.8  # the seeded decoder's output lies inside [0, 1]


@pytest.mark.parametrize("sampler,steps,skip", [("plms", 20, 3), ("dpm", 10, 2)])
def test_sweep_matches_port(sampler, steps, skip):
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram

    model, w = _unet(2, 1)
    sched = make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195)
    images = seeds.images((2, 16, 16, 1), 2, 0)
    noise = seeds.HostNoise(7)
    program = ReconProgram(sched=sched, model_fn=model, num_inference_steps=steps,
                           inference_skip_factor=skip, num_groups=2, sampler=sampler,
                           host_noise_fn=noise)
    with torch.no_grad():
        _, mse, _ = program(images)
    program.close()
    k = len(program.t_starts)
    eps = torch.from_numpy(noise.draw(0, (k, 2, 16, 16, 1))).movedim(-1, 2)
    acp = rd.alphas_cumprod(rd.scaled_linear_betas(0.0015, 0.0195))
    x0 = torch.from_numpy(images).movedim(-1, 1)
    with torch.no_grad():
        recon = rd.sweep(lambda x, t: unet_forward(w, TINY, x, t), acp, x0, eps, sampler,
                         steps, skip)
    want = ((x0[None] - recon.clamp(0, 1)) ** 2).flatten(2).mean(2)
    assert np.allclose(mse.numpy(), want.numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dims", [2, 3])
def test_scores_match_port(dims, tmp_path):
    from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
    from ddpm_ood_tpu_torch.ops.ssim import ssim_distance

    npz = seeds.lpips_npz(tmp_path / "lpips.npz", 4)
    shape = (2,) + (24,) * dims + (1,)
    a = torch.from_numpy(seeds.images(shape, 1, 0))
    b = torch.from_numpy(seeds.images(shape, 1, 1))
    with torch.no_grad():
        perc = PerceptualLoss(weights_path=npz, spatial_dims=dims)(a, b)
        want = rm.scores(rm.lpips_weights(npz, CPU), a.movedim(-1, 1), b.movedim(-1, 1),
                         score_ssim=True)
    assert np.allclose(perc.numpy(), want["perceptual_difference"].numpy(), rtol=1e-4)
    assert np.allclose(ssim_distance(a, b).numpy(), want["ssim_distance"].numpy(), rtol=1e-4)


def test_train_steps_match_port():
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep

    model, w = _unet(2, 1)
    model.train()
    sched = make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195)
    step = DDPMTrainStep(model=model, sched=sched, learning_rate=1e-3)
    gen = torch.Generator().manual_seed(3)
    batches = [(torch.rand((4, 1, 16, 16), generator=gen),
                torch.randint(0, 1000, (4,), generator=gen),
                torch.randn((4, 1, 16, 16), generator=gen)) for _ in range(3)]
    losses = [float(step.step(*b)) for b in batches]
    acp = rd.alphas_cumprod(rd.scaled_linear_betas(0.0015, 0.0195))
    want_losses, g, p3, halves = train_steps(w, TINY, acp, batches, 1e-3, chunk=3)
    assert np.allclose(losses, want_losses, rtol=1e-5)
    for k in g:  # the batch's gradient is the mean of its halves'
        assert torch.allclose((halves[0][k] + halves[1][k]) / 2, g[k], rtol=1e-4, atol=1e-7), k
    # Adam's m / sqrt(v) turns round-off into sign flips where a gradient is
    # near 0, so the leaves are held by the size of their change, and those
    # whose gradient is 0 to round-off (a key's bias under softmax) left out
    g_med = float(np.median([float(v.norm()) for v in g.values()]))
    for k, p in model.named_parameters():
        if float(g[k].norm()) < 1e-3 * g_med:
            continue
        got, want = float((p.detach() - w[k]).norm()), float((p3[k] - w[k]).norm())
        assert abs(got - want) <= 1e-3 * want, k


@pytest.mark.parametrize("control,levels", [("reference_fp8", None), ("reference_int4", 15)])
def test_precision_controls_round_every_operand(control, levels):
    from portbench.reference.ops import CONTROLS, round_to

    x = torch.linspace(-2.0, 2.0, 257).view(1, -1)
    q = round_to(x, CONTROLS[control].operand_dtype, per_sample=True)
    err = (q - x).abs().max().item()
    assert 0 < err <= (2.0 / 14 if levels else 2.0 / 8)  # half a step of int4; e4m3's 3 bits
    if levels:
        assert len(torch.unique(q)) == levels
    x.requires_grad_()
    round_to(x, CONTROLS[control].operand_dtype, per_sample=True).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))  # straight through
