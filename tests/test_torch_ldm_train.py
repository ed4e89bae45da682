"""Latent diffusion training in the port, against the JAX package, on the CPU.

1. The 3D LDM training step: the tiny VQ-VAE of tests/test_torch_vqvae.py
   (16^3 volumes to 4^3 x 4 latents) encodes a batch, ``latent_pad``
   (2, 2, 0, 4, 4, 0) pads the latents to 8^3, and the tiny 3D UNet's
   loss and gradients follow, against JAX's ``DDPMTrainStep(has_encoder=True,
   latent_pad=..., external_noise=True)``. Seeded JAX weights carried across
   by the converters; images, t and noise are numpy draws handed to both.
2. The CLI chain ``train_vqvae -> train_ddpm --vqvae_checkpoint ->
   reconstruct -> run_ood_detection`` in 3D on the CPU, as
   tests/test_ldm_3d.py drives the JAX package's.

Tolerances, fp32 on both sides: latents atol 1e-5 (values ~1, the encoder's
~10 convolutions summed in another order); loss rtol 1e-5; gradients per
tensor max|got - want| <= 1e-4 * max|want| + 1e-7 (tests/test_torch_train_step.py's).
Quantizer near-ties: indices are held equal wherever the runner-up code
lies more than ``TIE_MARGIN`` beyond the best; positions inside it are
counted and printed with their margins, and the loss and gradients are
then compared on the same (JAX's) latents. The draws are seeded, not
chosen to avoid ties.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_ood_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.models.vqvae import VQVAE as JaxVQVAE
from ddpm_ood_tpu.train.ddpm import DDPMTrainStep as JaxTrainStep
from ddpm_ood_tpu.train.ddpm import TrainState
from ddpm_ood_tpu_torch import reconstruct, train_ddpm, train_vqvae
from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv
from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format
from ddpm_ood_tpu_torch.ood import run_ood_detection
from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep
from ddpm_ood_tpu_torch.trainers import ddpm_trainer
from ddpm_ood_tpu_torch.utils.checkpoint import load_vqvae_checkpoint
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_reconstruct import write_lpips_npz
from test_torch_unet3d import seeded_jax_params_nd
from test_torch_vqvae import TIE_MARGIN, _nearest_two, port_vqvae, seeded_vqvae

SCHED_ARGS = ("scaled_linear_beta", 1000, 0.0015, 0.0195)
LATENT_PAD = (2, 2, 0, 4, 4, 0)  # 4^3 latents -> 8^3
B_SCALE = 1.5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.fixture(scope="module")
def ldm():
    jvq, vq_params, vq_ema = seeded_vqvae(3)
    unet = jax_make_unet("tiny", 3, 4, 4)
    params = seeded_jax_params_nd(unet, (1, 8, 8, 8, 4), seed=3)
    rng = np.random.default_rng(11)
    images = rng.uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    t = np.array([40, 730], np.int32)
    noise = rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32)

    variables = {"params": vq_params, "ema": vq_ema}
    encode_fn = jax.tree_util.Partial(
        lambda v, x: jvq.apply(v, x, method=JaxVQVAE.encode_stage_2_inputs), variables)
    jstep = JaxTrainStep(sched=jax_make_schedule(*SCHED_ARGS), b_scale=B_SCALE,
                         has_encoder=True, latent_pad=LATENT_PAD, external_noise=True)
    state = TrainState.create(apply_fn=unet.apply, params=params, tx=optax.adam(1e-3))
    x0 = np.asarray(jax.jit(jstep._prepare)(jnp.asarray(images), encode_fn))
    loss, grads = jax.jit(jstep._grads)(state, jnp.asarray(x0), jnp.asarray(noise),
                                        jnp.asarray(t))
    z = np.asarray(jvq.apply(variables, jnp.asarray(images), method=JaxVQVAE.encode))

    model = make_unet("tiny", 3, 4, 4)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    vq = port_vqvae(3, vq_params, vq_ema)
    step = DDPMTrainStep(model=model.to(memory_format=memory_format(3)),
                         sched=make_schedule(*SCHED_ARGS), b_scale=B_SCALE, learning_rate=1e-3,
                         encode_fn=vq.encode_stage_2_inputs, latent_pad=LATENT_PAD)
    return dict(images=images, t=t, noise=noise, x0=x0, loss=float(loss), grads=grads, z=z,
                codebook=np.asarray(vq_ema["quantizer"]["embedding"]), step=step, vq=vq)


def test_prepare_encodes_and_pads_like_jax(ldm):
    """Encode (fp32 quantizer), then the torch-style pad, channels-last."""
    got = ldm["step"].prepare(nchw(ldm["images"]))
    assert got.shape == (2, 4, 8, 8, 8) and got.is_contiguous(memory_format=torch.channels_last_3d)
    _, _, gap = _nearest_two(ldm["z"], ldm["codebook"])
    ties = gap <= TIE_MARGIN
    print(f"LDM prepare: {int(ties.sum())} of {gap.size} latent positions within "
          f"{TIE_MARGIN} of a tie" + (f" (margins {gap[ties]})" if ties.any() else ""))
    want = ldm["x0"]  # (B, 8, 8, 8, 4); the pad puts the 4^3 latents at [4:, :4, 2:6]
    got_cl = got.movedim(1, -1).numpy()
    inner = (slice(None), slice(4, 8), slice(0, 4), slice(2, 6))
    clear = ~ties.reshape(2, 4, 4, 4)
    np.testing.assert_allclose(got_cl[inner][clear], want[inner][clear], rtol=0, atol=1e-5)
    mask = np.ones(want.shape[:-1], bool)
    mask[inner] = False
    assert np.abs(want[mask]).max() == 0 and np.abs(got_cl[mask]).max() == 0
    # un-padding gives back the quantized latents
    unpadded = ldm["step"].unpad(got)
    with torch.no_grad():
        torch.testing.assert_close(unpadded, ldm["vq"].encode_stage_2_inputs(nchw(ldm["images"])),
                                   rtol=0, atol=0)


def test_ldm_loss_and_every_gradient_match_jax(ldm):
    """The loss on the padded latents and every tiny 3D UNet gradient."""
    step = ldm["step"]
    loss = step.grads(nchw(ldm["x0"]).contiguous(memory_format=torch.channels_last_3d),
                      nchw(ldm["noise"]), torch.from_numpy(ldm["t"]).long())
    np.testing.assert_allclose(loss.item(), ldm["loss"], rtol=1e-5)
    want = jax_unet_params_to_state_dict(jax.tree_util.tree_map(np.asarray, ldm["grads"]))
    got = {n: p.grad for n, p in step.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        tol = GRAD_RTOL * w.abs().max().item() + GRAD_ATOL
        assert err <= tol, f"{name}: max abs err {err:.3e} > {tol:.3e}"


def test_vqvae_takes_no_gradient_and_stays_frozen(ldm):
    """The encode runs under no_grad in eval mode: no VQ-VAE gradient, no
    EMA statistics gathered."""
    vq, step = ldm["vq"], ldm["step"]
    before = {k: v.clone() for k, v in vq.state_dict().items()}
    x0 = step.prepare(nchw(ldm["images"]))
    assert not x0.requires_grad
    step.step(x0, torch.from_numpy(ldm["t"]).long(), nchw(ldm["noise"]))
    assert all(p.grad is None for p in vq.parameters())
    assert all(torch.equal(v, before[k]) for k, v in vq.state_dict().items())
    assert vq.quantizer.quantizer._stats is None


# -- the CLI chain -------------------------------------------------------------

VQ_FLAGS = ["--spatial_dimension=3", "--image_size=16", "--is_grayscale=1",
            "--vqvae_num_res_layers=1", "--vqvae_downsample_parameters=((2,4,1,1),(2,4,1,1))",
            "--vqvae_upsample_parameters=((2,4,1,1,0),(2,4,1,1,0))",
            "--vqvae_num_channels=[8,8]", "--vqvae_num_res_channels=[8,8]",
            "--vqvae_num_embeddings=16", "--vqvae_embedding_dim=4", "--vqvae_decay=0.9",
            "--vqvae_learning_rate=1e-3", "--num_workers=1"]
LDM_FLAGS = ["--spatial_dimension=3", "--image_size=16", "--is_grayscale=1",
             "--model_type=tiny", f"--latent_pad={LATENT_PAD}", "--num_workers=1",
             "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195"]


def write_volumes(root, name: str, n: int, ood: bool, seed: int) -> str:
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.arange(16),) * 3, indexing="ij")
    paths = []
    (root / name).mkdir(parents=True)
    for i in range(n):
        if ood:
            v = (((xx // 4) + (yy // 4) + (zz // 4) + i) % 2).astype(np.float32)
        else:
            v = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy + zz) / 16 + rng.uniform(0, 2 * np.pi))
        paths.append(str(root / name / f"{name}_{i}.npy"))
        np.save(paths[-1], v.astype(np.float32)[None])
    write_split_csv(paths, str(root / f"{name}.csv"))
    return str(root / f"{name}.csv")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldm_chain")
    csv = {"train": write_volumes(root, "train", 4, False, 0),
           "val": write_volumes(root, "val", 2, False, 1),
           "Task02_Heart_test": write_volumes(root, "Task02_Heart_test", 2, True, 2)}
    out = root / "output"
    vq = train_vqvae.main(["--device=cpu", f"--output_dir={out}", "--model_name=vqvae_decathlon",
                           f"--training_ids={csv['train']}", f"--validation_ids={csv['val']}",
                           "--batch_size=2", "--n_epochs=2", "--eval_freq=2",
                           "--checkpoint_every=2", "--grad_accum_steps=2", "--remat=1",
                           *VQ_FLAGS])
    vq_ckpt = out / "vqvae_decathlon" / "checkpoint.pth"
    ldm = train_ddpm.main(["--device=cpu", f"--output_dir={out}", "--model_name=ldm_decathlon",
                           f"--vqvae_checkpoint={vq_ckpt}", f"--training_ids={csv['train']}",
                           f"--validation_ids={csv['val']}", "--batch_size=2", "--n_epochs=2",
                           "--eval_freq=100", "--checkpoint_every=2", "--learning_rate=1e-3",
                           *LDM_FLAGS])
    return dict(root=root, out=out, csv=csv, vq=vq, vq_ckpt=vq_ckpt, ldm=ldm)


def test_train_vqvae_cli_writes_what_stage_2_reads(chain):
    vq, run = chain["vq"], chain["out"] / "vqvae_decathlon"
    assert sorted(p.name for p in run.glob("*.pth")) == ["checkpoint.pth", "checkpoint_2.pth"]
    config, state = load_vqvae_checkpoint(chain["vq_ckpt"])
    assert config == vq.vqvae_config and config["spatial_dims"] == 3
    payload = torch.load(chain["vq_ckpt"], weights_only=True)
    assert set(payload) == {"epoch", "global_step", "best_loss", "model_state_dict",
                            "discriminator_state_dict", "optimizer_g_state_dict",
                            "optimizer_d_state_dict"}
    assert payload["epoch"] == 2 and payload["global_step"] == 8
    assert vq.step.g_backwards == 2 * 2 * 2  # 2 epochs x 2 steps x 2 microbatches
    val = [json.loads(line) for line in (run / "val" / "scalars.jsonl").read_text().splitlines()]
    assert {r["tag"] for r in val} == {"l1_loss", "quantization_loss", "perceptual_loss",
                                       "jukebox_loss", "adversarial_loss", "generator_loss"}
    grid = np.load(run / "val" / "RECONSTRUCTIONS_8.npy")
    assert grid.shape == (2, 2, 16, 16, 1) and 0 <= grid.min() and grid.max() <= 1


def test_train_ddpm_on_the_vqvae_latents(chain):
    ldm = chain["ldm"]
    assert ldm.ddpm_channels == 4 and ldm.spatial_dimension == 3
    assert ldm.step.latent_pad == LATENT_PAD and ldm.step.backwards == 4
    run = chain["out"] / "ldm_decathlon"
    payload = torch.load(run / "checkpoint_2.pth", weights_only=True)
    assert payload["global_step"] == 8
    assert payload["model_state_dict"]["conv_in.conv.weight"].shape[1:] == (4, 3, 3, 3)
    losses = [json.loads(line)["value"] for line in
              (run / "train" / "scalars.jsonl").read_text().splitlines()]
    assert len(losses) == 4 and all(map(math.isfinite, losses))


def test_ldm_sample_grid_is_unpadded_and_decoded(chain, monkeypatch):
    """Validation samples 2 latents of the padded shape in 3D, un-pads and
    decodes them (the 1000-step sampler replaced by its last UNet call)."""
    ldm = chain["ldm"]
    seen = []

    def one_call(sched, model_fn, noise, generator):
        seen.append(tuple(noise.shape))
        return model_fn(noise, torch.zeros(noise.shape[0], dtype=torch.long))

    monkeypatch.setattr(ddpm_trainer, "ddpm_sample", one_call)
    x0 = ldm.step.prepare(torch.rand(2, 1, 16, 16, 16))
    grid = ldm.sample_grid(x0)
    assert seen == [(2, 4, 8, 8, 8)]
    assert grid.shape == (2, 16, 16, 16, 1) and 0 <= grid.min() and grid.max() <= 1
    assert (chain["out"] / "ldm_decathlon" / "val" / f"samples_{ldm.global_step}.npy").is_file()


def test_reconstruct_and_ood_detection_on_the_trained_pair(chain, monkeypatch, capsys):
    out, csv = chain["out"], chain["csv"]
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(write_lpips_npz(chain["root"] / "lpips.npz")))
    recon = reconstruct.main([
        "--device=cpu", f"--output_dir={out}", "--model_name=ldm_decathlon",
        f"--vqvae_checkpoint={chain['vq_ckpt']}", f"--validation_ids={csv['val']}",
        f"--in_ids={csv['val']}", f"--out_ids={csv['Task02_Heart_test']}", "--batch_size=2",
        "--num_inference_steps=10", "--inference_skip_factor=5", *LDM_FLAGS])
    loaded = recon.unet.state_dict()
    want = torch.load(out / "ldm_decathlon" / "checkpoint.pth", weights_only=True)
    assert all(torch.equal(loaded[k], v) for k, v in want["model_state_dict"].items())
    assert sorted(p.name for p in recon.out_dir.glob("results_*.csv")) == [
        "results_Task02.csv", "results_in.csv", "results_val.csv"]
    # the Decathlon registry names nine out sets; this run scored one
    run_ood_detection(str(out), "ldm_decathlon", plot_target="mse", out_datasets=["Task02"])
    printed = capsys.readouterr().out
    aucs = [line for line in printed.splitlines() if line.startswith("AUC for")]
    assert len(aucs) == 1 and "Task02" in aucs[0]
    assert 0.0 <= float(aucs[0].split(": ")[1].split()[0]) <= 100.0


def test_train_vqvae_refusals(tmp_path):
    """--fsdp=1 is served (tests/test_torch_fsdp.py); dropout is not."""
    with pytest.raises(NotImplementedError, match="--vqvae_dropout"):
        train_vqvae.main(["--device=cpu", f"--output_dir={tmp_path}", "--model_name=m",
                          "--vqvae_dropout=0.1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):  # --device defaults to cuda
            train_vqvae.main([f"--output_dir={tmp_path}", "--model_name=m"])
