"""The port's single-trajectory denoisers and sample CLI, on the CPU.

``plms_denoise``, ``ddim_denoise`` and ``dpm_denoise`` of the port against
the JAX package's on one tiny UNet (seeded JAX params carried into the port
by ``utils/convert.py``), a 10-step grid, 2 samples of 16x16 noise drawn
with numpy, from the grid's first entry and from one in the middle. JAX
scans the whole grid with the steps above t_start masked out; the port
loops over the active suffix only. Tolerance in fp32: rtol 1e-5, and atol
1e-5 of the output's scale, max(1, max |x|): from t = 900 the untrained
UNet's trajectories from unit noise reach |x| ~ 120, where one fp32 ulp is
7.6e-6, and up to 11 chained forwards that agree to ~3e-6 each
(tests/test_torch_unet.py) carry a few ulp of it into the small entries
(6.9e-5 observed, 5.9e-7 of the scale; 4.1e-6 from the middle).

Then ``python -m ddpm_ood_tpu_torch.sample --device=cpu`` on a seeded tiny
checkpoint: plms and dpm at 10 steps write (3, 16, 16, 1) samples, finite,
in [0, 1], as ``.npy`` only; without a checkpoint it raises
FileNotFoundError, and with --device=cuda and no card RuntimeError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion import ddim as jddim
from ddpm_ood_tpu.diffusion import dpm_solver as jdpm
from ddpm_ood_tpu.diffusion import plms as jplms
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu_torch import sample as cli
from ddpm_ood_tpu_torch.diffusion import ddim, dpm_solver, plms, schedules
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_unet import seeded_jax_params
from torch_recon_parity import SCHED_ARGS

STEPS = 10
TOL = 1e-5  # rtol, and atol relative to the output's scale
DENOISERS = {  # sampler -> (JAX denoiser, port denoiser, grid)
    "plms": (jplms.plms_denoise, plms.plms_denoise, plms.pndm_timesteps),
    "ddim": (jddim.ddim_denoise, ddim.ddim_denoise, ddim.ddim_timesteps),
    "dpm": (jdpm.dpm_denoise, dpm_solver.dpm_denoise, dpm_solver.dpm_timesteps),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=3)
    jmodel = jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t), params)
    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()

    def model_fn(x, t):  # (B, H, W, C) in and out, as the sample CLI wraps the UNet
        return model(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)

    return jmodel, model_fn


@pytest.fixture(scope="module")
def jax_outputs(models):
    """Each JAX denoiser from ts[0] and from ts[len // 2]: one jit each."""
    jmodel, _ = models
    x = np.random.default_rng(11).standard_normal((2, 16, 16, 1)).astype(np.float32)
    sched = jsched.make_schedule(*SCHED_ARGS)
    out = {}
    for name, (jfn, _, grid) in DENOISERS.items():
        ts = grid(1000, STEPS)
        run = jax.jit(jfn, static_argnums=(5,))
        for t_start in (int(ts[0]), int(ts[len(ts) // 2])):
            out[name, t_start] = np.asarray(run(sched, jmodel, jnp.asarray(x), jnp.asarray(ts),
                                                jnp.asarray(t_start), STEPS))
    return x, out


@pytest.mark.parametrize("name", list(DENOISERS))
@pytest.mark.parametrize("where", ["first", "middle"])
def test_denoiser_matches_jax(models, jax_outputs, name, where):
    _, model_fn = models
    x, want = jax_outputs
    _, fn, grid = DENOISERS[name]
    ts = grid(1000, STEPS)
    t_start = int(ts[0] if where == "first" else ts[len(ts) // 2])
    calls = []

    def counted(xx, t):
        calls.append(t)
        return model_fn(xx, t)

    with torch.no_grad():
        got = fn(schedules.make_schedule(*SCHED_ARGS), counted, torch.from_numpy(x),
                 torch.from_numpy(ts), t_start, STEPS)
    assert len(calls) == int((ts <= t_start).sum())  # the active suffix only
    ref = want[name, t_start]
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got.numpy() - ref).max())
    print(f"{name} from t={t_start}: max abs err {err:.3e}, scale {scale:.3e}")
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * scale)
    if where == "middle":
        assert not np.allclose(want[name, t_start], want[name, int(ts[0])])


def _checkpoint(root):
    run = root / "output" / "sample_run"
    run.mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(run / "checkpoint.pth", model.state_dict())
    return ["--device=cpu", f"--output_dir={root / 'output'}", "--model_name=sample_run",
            "--model_type=tiny", "--image_size=16", "--is_grayscale=1",
            "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195"]


@pytest.mark.parametrize("sampler", ["plms", "dpm"])
def test_sample_cli_writes_npy(tmp_path, sampler):
    argv = _checkpoint(tmp_path)
    out = tmp_path / "gen"
    path = cli.main(argv + ["--n_samples=3", f"--sampler={sampler}",
                            f"--num_inference_steps={STEPS}", f"--out={out}"])
    assert path == out / f"samples_{sampler}_{STEPS}_seed0.npy"
    arr = np.load(path)
    assert arr.shape == (3, 16, 16, 1) and arr.dtype == np.float32
    assert np.isfinite(arr).all() and arr.min() >= 0.0 and arr.max() <= 1.0
    assert sorted(p.name for p in out.iterdir()) == [path.name]  # no PNG grid


def test_sample_cli_requires_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["--device=cpu", f"--output_dir={tmp_path}", "--model_name=nope",
                  "--model_type=tiny", "--image_size=16", "--is_grayscale=1"])


def test_sample_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    argv = _checkpoint(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([a for a in argv if a != "--device=cpu"])  # the default --device=cuda
