"""Simplex-noise scoring: the port's CLI and ReconProgram against the JAX package's.

- Exact mode, the CLI: both packages' scoring CLIs with ``--simplex_noise=1``
  run after the same ``np.random.seed`` on one tiny checkpoint and one LPIPS
  npz, over val and in sets of 10 images at batch 8 (a ragged last batch
  of 2, which the JAX CLI wrap-pads to 8 before it draws, and which the
  port draws at 8 and slices) and an out set of 8. Every host draw of the
  two runs is equal bit for bit, in order, across the three datasets (each
  batch's draw made ahead during the one before), and every CSV column
  agrees within the tolerance of tests/test_torch_reconstruct.py: t exact,
  mse rtol 1e-5, LPIPS atol 1e-6.
  (Every first batch is 8: the JAX CLI also pads a batch to the test
  backend's 8 devices before it draws, which a one-device run does not.)
- The prefetch, the programs: both packages' ``ReconProgram`` with a host
  function on numpy's global RNG, batches of 4, 4, 3, 3 and 4 items after
  one seed: each draw made ahead, a prefetch of another shape drawn and
  discarded, the draws and MSE tables equal.
- Device mode, the programs: each package's ``ReconProgram`` with its
  ``simplex_noise_fn`` given the same per-lane seed0 (the port's from its
  keys' draws, the JAX one's from the keys), one batch of 2 images: the MSE
  tables within rtol 1e-5 (the noise agrees to ~2e-6, tests/test_torch_simplex.py).
  The port's CLI function draws one seed0 per lane from the scoring generator.
- A failed g++ build is an error that names ``--simplex_noise_mode=device``,
  which then runs without it.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.noise.simplex import simplex_noise_device as jax_simplex_noise_device
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch import reconstruct as cli
from ddpm_ood_tpu_torch.diffusion import schedules
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.noise import _native
from ddpm_ood_tpu_torch.noise.simplex import simplex_noise_device
from ddpm_ood_tpu_torch.recon import sweep
from ddpm_ood_tpu_torch.trainers.reconstruct import Reconstruct
from ddpm_ood_tpu_torch.utils import native_build
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_reconstruct import MODEL, _jax_reconstruct, _split, write_lpips_npz
from test_torch_unet import seeded_jax_params

NP_SEED = 1234
N_IMAGES, N_OUT, BATCH = 10, 8, 8
NAMES = ("val", "in", "MNIST")
MSE_RTOL, METRIC_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorder(fn, draws: list):
    def record(shape, t_starts):
        out = fn(shape, t_starts)
        draws.append(np.array(out, np.float32))
        return out
    return record


def _argv(root) -> list:
    rng = np.random.default_rng(0)
    val = _split(root, "val", N_IMAGES, False, rng)
    ins = _split(root, "FashionMNIST_test", N_IMAGES, False, rng)
    out = _split(root, "MNIST_test", N_OUT, True, rng)
    (root / "output" / MODEL).mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(root / "output" / MODEL / "checkpoint.pth", model.state_dict(), epoch=3)
    write_lpips_npz(root / "lpips.npz")
    return ["--device=cpu", f"--output_dir={root / 'output'}", f"--model_name={MODEL}",
            f"--validation_ids={val}", f"--in_ids={ins}", f"--out_ids={out}",
            "--image_size=16", "--model_type=tiny", "--is_grayscale=1",
            f"--batch_size={BATCH}", "--beta_schedule=scaled_linear_beta",
            "--beta_start=0.0015", "--beta_end=0.0195", "--num_inference_steps=10",
            "--inference_skip_factor=5", "--num_workers=2", "--recon_groups=1",
            "--simplex_noise=1"]


def _shaped(make_ddpm_state):
    """``make_ddpm_state`` as zeros of its shapes: the JAX CLI restores the
    checkpoint over this state, and the eager init would take ~10 s."""
    def shaped(unet, rng, sample_shape, **kwargs):
        shapes = jax.eval_shape(lambda r: make_ddpm_state(unet, r, sample_shape, **kwargs), rng)
        return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    return shaped


@pytest.fixture(scope="module")
def exact_runs(tmp_path_factory):
    import ddpm_ood_tpu.train.ddpm as jax_train
    import ddpm_ood_tpu.trainers.base as jax_base
    import ddpm_ood_tpu.trainers.reconstruct as jax_recon_mod

    root = tmp_path_factory.mktemp("simplex_cli")
    argv = _argv(root)
    draws = {"port": [], "jax": []}
    with pytest.MonkeyPatch.context() as mp:
        shaped = _shaped(jax_train.make_ddpm_state)
        mp.setattr(jax_train, "make_ddpm_state", shaped)
        mp.setattr(jax_base, "make_ddpm_state", shaped)
        mp.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
        np.random.seed(NP_SEED)
        args = cli.parse_args(argv)
        recon = Reconstruct(args, torch.device("cpu"))
        prog = recon._program(args.inference_skip_factor)
        prog.host_noise_fn = _recorder(prog.host_noise_fn, draws["port"])
        recon.reconstruct(args)

        # the JAX CLI, the same seed before its Reconstruct; its program's
        # host function is recorded as it is built
        build = jax_recon_mod.Reconstruct._program

        def recording_program(self, skip_factor):
            new = skip_factor not in self._programs
            program = build(self, skip_factor)
            if new:
                program.host_noise_fn = _recorder(program.host_noise_fn, draws["jax"])
            return program

        mp.setattr(jax_recon_mod.Reconstruct, "_program", recording_program)
        np.random.seed(NP_SEED)
        jax_ood = _jax_reconstruct(root, argv, host_noise_fn=None)
    return root, recon, jax_ood, draws


def test_host_draws_equal_jax_in_order(exact_runs):
    _, recon, _, draws = exact_runs
    k = len(recon._program(5).t_starts)
    # 5 batches, each drawn at 8 items during the batch before it (the
    # first at once), and the draw the last one made ahead
    assert [d.shape for d in draws["port"]] == [d.shape for d in draws["jax"]] == [
        (k, BATCH, 16, 16, 1)] * 6
    for i, (got, want) in enumerate(zip(draws["port"], draws["jax"])):
        assert got.tobytes() == want.tobytes(), f"draw {i}"
    assert draws["port"][0].std() > 0.05 and not np.array_equal(draws["port"][0],
                                                                 draws["port"][1])
    prog = recon._program(5)
    assert prog.host_noise_seconds > 0 and prog._noise_executor is None  # closed


def test_cli_csvs_match_jax_across_a_ragged_batch_and_three_datasets(exact_runs):
    root, recon, jax_ood, _ = exact_runs
    ood = root / "output" / MODEL / "ood"
    t_starts = recon._program(5).t_starts
    for name, n in zip(NAMES, (N_IMAGES, N_IMAGES, N_OUT)):
        got = pd.read_csv(ood / f"results_{name}.csv").sort_values(["filename", "t"])
        want = pd.read_csv(jax_ood / f"results_{name}.csv").sort_values(["filename", "t"])
        assert len(got) == n * len(t_starts) == len(want)
        assert list(got.columns) == list(want.columns)
        for col in ("filename", "type", "t"):
            assert list(got[col]) == list(want[col]), (name, col)
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=MSE_RTOL, atol=0,
                                   err_msg=f"{name} mse")
        np.testing.assert_allclose(got["perceptual_difference"], want["perceptual_difference"],
                                   atol=METRIC_ATOL, rtol=0, err_msg=f"{name} LPIPS")
        assert np.isfinite(got[["mse", "perceptual_difference"]]).all().all()


def test_previews_are_named_as_jax_names_them(exact_runs):
    root, _, _, _ = exact_runs
    ood = root / "output" / MODEL / "ood"
    assert sorted(p.name for p in ood.glob("preview_*.npy")) == [
        "preview_in.npy", "preview_out_3.npy", "preview_val.npy"]
    preview = np.load(ood / "preview_val.npy")
    assert preview.shape == (2, BATCH, 16, 16, 1) and np.isfinite(preview).all()
    assert preview.min() >= 0.0 and preview.max() <= 1.0


def _toy_jax(x, t):
    return 0.1 * x + 0.01 * (t.astype(jnp.float32) / 1000.0).reshape((-1,) + (1,) * (x.ndim - 1))


def _toy_torch(x, t):
    return 0.1 * x + 0.01 * (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))


def test_prefetch_draws_in_the_jax_programs_order():
    draws = {"port": [], "jax": []}

    def host(which):
        def fn(shape, t_starts):
            out = np.random.standard_normal(shape).astype(np.float32)  # the global RNG
            draws[which].append(out)
            return out
        return fn

    common = dict(num_inference_steps=10, inference_skip_factor=5, num_groups=1)
    jprog = jsweep.ReconProgram(
        sched=jsched.make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195),
        model_fn=jax.tree_util.Partial(_toy_jax), host_noise_fn=host("jax"),
        latent_sample_shape=(8, 8, 1), **common)
    prog = sweep.ReconProgram(
        sched=schedules.make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195),
        model_fn=_toy_torch, host_noise_fn=host("port"), **common)
    sizes = (4, 4, 3, 3, 4)
    images = [np.random.default_rng(n + i).uniform(size=(n, 8, 8, 1)).astype(np.float32)
              for i, n in enumerate(sizes)]
    np.random.seed(3)
    want = [np.asarray(jprog(jnp.asarray(x), None)[1]) for x in images]
    jprog._pending_noise[1].result()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # the worker and the caller's thread interleave often
    try:
        np.random.seed(3)
        got = [prog(x)[1].numpy() for x in images]
        prog.close()
    finally:
        sys.setswitchinterval(interval)
    # draw, ahead 4, ahead 4 (discarded at 3), 3, ahead 3, ahead 3 (discarded), 4, ahead 4
    assert [d.shape[1] for d in draws["port"]] == [4, 4, 4, 3, 3, 3, 4, 4]
    assert len(draws["jax"]) == len(draws["port"])
    for a, b in zip(draws["port"], draws["jax"]):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=MSE_RTOL, atol=0)
    assert prog.host_noise_wait_seconds >= 0 and prog._noise_executor is None


def _programs(simplex_fns):
    """Both packages' ReconPrograms on one tiny UNet and batch of 2 images."""
    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=5)
    common = dict(num_inference_steps=10, inference_skip_factor=5, num_groups=1)
    jprog = jsweep.ReconProgram(
        sched=jsched.make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195),
        model_fn=jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t), params),
        simplex_noise_fn=simplex_fns[0], **common)
    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    prog = sweep.ReconProgram(
        sched=schedules.make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195),
        model_fn=model.to(memory_format=torch.channels_last).eval(),
        simplex_noise_fn=simplex_fns[1], **common)
    return jprog, prog


def test_device_mode_program_matches_jax_with_the_seeds_passed_in():
    def key(t):
        return jax.random.PRNGKey(1000 + int(t))

    def jax_fn(rng, shape, t_starts):  # lane t's noise from key(t), rng unused
        return jnp.stack([jax_simplex_noise_device(key(t), shape[1:], jnp.full((shape[1],), t))
                          for t in np.asarray(t_starts)])

    def port_fn(generator, shape, t_starts):
        seed0 = [int(jax.random.randint(key(t), (), 0, 2**31 - 1, dtype=jnp.int32))
                 for t in t_starts.tolist()]
        return simplex_noise_device(torch.tensor(seed0), shape[1:],
                                    t_starts[:, None].expand(shape[0], shape[1]))

    jprog, prog = _programs((jax_fn, port_fn))
    images = np.random.default_rng(6).uniform(size=(2, 16, 16, 1)).astype(np.float32)
    want = jprog(jnp.asarray(images), jax.random.PRNGKey(0))
    got = prog(images, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=MSE_RTOL, atol=0)


def test_the_cli_device_function_seeds_each_lane_from_the_generator():
    shape, t_starts = (3, 2, 8, 8, 1), torch.tensor([10, 400, 990])
    got = Reconstruct._device_simplex_noise(torch.Generator().manual_seed(7), shape, t_starts)
    seeds = torch.randint(0, 2**31 - 1, (3,), generator=torch.Generator().manual_seed(7))
    for k in range(3):
        want = simplex_noise_device(int(seeds[k]), shape[1:], t_starts[k].expand(2))
        torch.testing.assert_close(got[k], want, atol=0, rtol=0)


@pytest.fixture
def no_compiler(tmp_path, monkeypatch):
    """g++ renamed away and the library not yet built: the next use builds."""
    monkeypatch.setattr(native_build, "COMPILER", "no-such-g++")
    monkeypatch.setattr(_native, "LIB_PATH", tmp_path / "_build" / "libopensimplex.so")
    _native.library.cache_clear()
    yield
    _native.library.cache_clear()


def test_exact_mode_without_gxx_is_an_error_naming_device_mode(tmp_path, no_compiler):
    root = tmp_path / "run"
    argv = _argv(root)
    with pytest.raises(native_build.NativeBuildError, match="--simplex_noise_mode=device"):
        cli.main(argv)
    assert not (root / "output" / MODEL / "ood").exists()  # before any scoring

    recon = cli.main(argv + ["--simplex_noise_mode=device", "--run_in=0", "--run_out=0",
                             "--first_n_val=2"])
    prog = recon._program(5)
    assert prog.host_noise_fn is None and prog.simplex_noise_fn is not None
    assert len(pd.read_csv(root / "output" / MODEL / "ood" / "results_val.csv")) == 2 * 2
