"""Sharded calls of the port's sweep in 2 gloo processes on the CPU, against
the JAX package on one device: the twins of tests/test_sweep_multichip.py.

Each rank holds its half of JAX's 16 rows (``parallel.mesh.shard_rows``) and
gets the whole result back (``all_gather_rows``); every gathered output is
held to JAX's single-device program at atol 1e-5, JAX's own tolerance:

- the PLMS sweep of ``fake_model`` (10 steps, skip 4), the noise passed in;
- ``ReconProgram`` with ``score_elbo`` (2 lane groups), one host draw of the
  global (K, 16, 8, 8, 1) noise handed to both packages: each rank keeps its
  rows of it (a ``global_batch`` call);
- the int8 tiny UNet (``make_unet("tiny", 2, 1, 1, quant="int8")``, JAX's
  ``0.05 * normal`` draws from ``PRNGKey(7)`` carried across by the
  converter) at 8x8 (the JAX test's 16x16 costs XLA's s8 convolution ~4x
  on the CPU), the noise one host draw as above. Every quantised call takes
  its activation absmax over both ranks (``ReconProgram.sharded``).

The int8 case also holds:
- every quantised call's scale is the whole batch's: both ranks make the
  same calls, and each product receives the larger of the two ranks' own
  max |x| (exact: a max);
- the .5 ties: ~one activation a call sits on a .5 tie that XLA and the
  port's fp32 kernels (~1e-6 apart) round apart, and one flipped code moves
  the sweep by ~1e-3 (tests/test_torch_quant_cli.py). So every quantised
  call of the ranks is held to JAX's input of that call
  (``torch_ddp_worker.TieFeed``: each rank's codes under the global scale
  equal JAX's codes of its rows but within TIE_BAND of a tie), and where a
  code flips on any rank, every rank takes its rows of JAX's input. Held
  the same way (``TieRepair``), the port's one process on the whole batch
  agrees with the ranks at atol 1e-5; the ranks' unfed scores are equal on
  both ranks;
- a control: each half run alone in one process (its own absmax), held to
  JAX's calls the same way, misses JAX's scores and the one process's at
  atol 1e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion.plms import pndm_start_points, pndm_timesteps
from ddpm_ood_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddpm_ood_tpu.models import unet as junet
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
from ddpm_ood_tpu_torch.models import unet
from ddpm_ood_tpu_torch.recon.sweep import ReconProgram
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_quant_cli import TieRepair
from torch_ddp_worker import finish, results, start

SCHED_ARGS = ("scaled_linear_beta", 1000, 0.0015, 0.0195)
ATOL = 1e-5  # tests/test_sweep_multichip.py's
N, SIZE = 16, 8
GRID = dict(num_inference_steps=10, inference_skip_factor=4, num_groups=2)
# the int8 program in one lane group: each of JAX's groups costs a compile
# of the quantised UNet (~4.5 s on the CPU)
INT8_GRID = {**GRID, "num_groups": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_model(x, t):
    return 0.1 * x + 0.01 * (t.astype(jnp.float32) / 1000.0).reshape((-1,) + (1,) * (x.ndim - 1))


def _jax_int8_params(x0):
    """JAX's int8 tiny UNet and the JAX test's weights, ``0.05 *
    jax.random.normal(k, leaf.shape)`` with one key of PRNGKey(7) a leaf.
    Eager, each leaf shape compiles a draw (~13 s for the tree on the CPU);
    a draw of a leaf's size is the prefix of a longer draw with the same
    key, so every leaf is cut from one vmapped draw of the largest size and
    scaled by float32(0.05) as the eager product is (one leaf is checked
    against the eager draw)."""
    model = junet.make_unet("tiny", 2, 1, 1, quant="int8")
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x0[:1]),
                            jnp.zeros((1,), jnp.int32))["params"]  # init's tree, not run
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    size = max(int(np.prod(leaf.shape)) for leaf in leaves)
    flat = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (size,))))(keys))
    params = [np.float32(0.05) * flat[i, :int(np.prod(leaf.shape))].reshape(leaf.shape)
              for i, leaf in enumerate(leaves)]
    np.testing.assert_array_equal(params[5], 0.05 * jax.random.normal(keys[5], leaves[5].shape))
    return model, jax.tree_util.tree_unflatten(treedef, params)


def _jax_int8(model, params, x0, noise, sites: list):
    """JAX's int8 program on the whole batch; the input of every QuantConv
    and QuantDense call appended to `sites` in call order. Returns (mse (K,
    N), perceptual (K, N))."""
    import flax.linen as fnn

    def interceptor(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(
                context.module, (junet.QuantConv, junet.QuantDense)):
            jax.debug.callback(lambda a: sites.append(np.array(a)), args[0], ordered=True)
        return next_fun(*args, **kwargs)

    def model_fn(p, x, t):
        with fnn.intercept_methods(interceptor):
            return model.apply({"params": p}, x, t)

    program = jsweep.ReconProgram(
        sched=jax_make_schedule(*SCHED_ARGS), model_fn=jax.tree_util.Partial(model_fn, params),
        host_noise_fn=lambda shape, t_starts: noise, latent_sample_shape=(SIZE, SIZE, 1),
        overlap_host_noise=False, **INT8_GRID)
    _, mse, perc = program(jnp.asarray(x0), jax.random.PRNGKey(0))
    return np.asarray(mse), np.asarray(perc)


def _publish(obj, path) -> None:
    """`obj` to `path` for the ranks, which wait for the file to appear."""
    tmp = path.with_suffix(".tmp")
    torch.save(obj, tmp)
    tmp.rename(path)


def _port_int8(state, x0, noise):
    model = unet.make_unet("tiny", 2, 1, 1, quant="int8")
    model.load_state_dict(state, strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    program = ReconProgram(sched=make_schedule(*SCHED_ARGS), model_fn=model,
                           host_noise_fn=lambda shape, t_starts: noise, **INT8_GRID)
    return model, program


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_sweep")
    ts = pndm_timesteps(1000, 10)
    t_starts = pndm_start_points(ts, 4)
    k = len(t_starts)
    x0 = np.random.default_rng(0).normal(size=(N, SIZE, SIZE, 1)).astype(np.float32)
    noise = np.random.default_rng(1).normal(size=(k, N, SIZE, SIZE, 1)).astype(np.float32)
    elbo_x0 = np.random.default_rng(2).uniform(size=(N, SIZE, SIZE, 1)).astype(np.float32)
    elbo_noise = np.random.default_rng(3).normal(size=(k, N, SIZE, SIZE, 1)).astype(np.float32)
    int8_x0 = np.random.default_rng(4).uniform(size=(N, SIZE, SIZE, 1)).astype(np.float32)
    int8_noise = np.random.default_rng(5).normal(size=(k, N, SIZE, SIZE, 1)).astype(np.float32)

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = dict(sched_args=SCHED_ARGS, ts=ts, t_starts=t_starts, x0=x0, noise=noise,
                   elbo_x0=elbo_x0, elbo_noise=elbo_noise, int8_x0=int8_x0,
                   int8_noise=int8_noise, state=str(root / "state.pt"),
                   sites=str(root / "sites.pt"))
        torch.save(inp, root / "in.pt")
        ranks = start("sharded", root / "in.pt", root)
        sites = []

        def int8_reference():
            """JAX's weights to the ranks, then JAX's int8 program; its
            input of every quantised call to the ranks."""
            jmodel, params = _jax_int8_params(int8_x0)
            state = jax_unet_params_to_state_dict(params)
            _publish(state, root / "state.pt")
            mse, perc = _jax_int8(jmodel, params, int8_x0, int8_noise, sites)
            _publish(([np.asarray(x) for x in sites], [float(np.abs(x).max()) for x in sites]),
                     root / "sites.pt")
            return state, mse, perc

        with ThreadPoolExecutor(1) as pool:  # the JAX references compile at once
            int8_ref = pool.submit(int8_reference)
            jsched = jax_make_schedule(*SCHED_ARGS)
            ref_sweep = np.asarray(jax.jit(lambda x, n: jsweep.plms_sweep(
                jsched, fake_model, x, n, jnp.asarray(ts), jnp.asarray(t_starts), 10))(
                    jnp.asarray(x0), jnp.asarray(noise)))
            jprog = jsweep.ReconProgram(
                sched=jsched, model_fn=jax.tree_util.Partial(fake_model), score_elbo=True,
                host_noise_fn=lambda shape, t_starts: elbo_noise,
                latent_sample_shape=(SIZE, SIZE, 1), overlap_host_noise=False, **GRID)
            ref_elbo = [np.asarray(a) for a in jprog(jnp.asarray(elbo_x0),
                                                      jax.random.PRNGKey(0))]
            state, jax_mse, jax_perc = int8_ref.result()
        # the port in one process on the whole batch, then each half alone
        # (its own absmax), every call held to JAX's as the ranks' are
        model, program = _port_int8(state, int8_x0, int8_noise)
        repair = TieRepair(model, sites)
        try:
            one = program(int8_x0)[1].numpy()
        finally:
            repair.remove()
        halves = []
        for r in range(2):
            rows = slice(r * N // 2, (r + 1) * N // 2)
            model_r, half = _port_int8(state, int8_x0[rows], int8_noise[:, rows])
            k_rows = [x.reshape((-1, N) + x.shape[1:])[:, rows].reshape((-1,) + x.shape[1:])
                      for x in sites]
            control = TieRepair(model_r, k_rows, strict=False)
            try:
                halves.append(half(int8_x0[rows])[1].numpy())
            finally:
                control.remove()
            assert control.calls == len(sites)
    finally:
        torch.set_num_threads(n_threads)
    finish(ranks)
    print(f"int8 one process: {repair.calls} quantised calls, {repair.flips} codes flipped at a "
          f".5 tie in {repair.repaired} of them")
    return dict(ranks=results(root), ref_sweep=ref_sweep, ref_elbo=ref_elbo,
                jax=(jax_mse, jax_perc), one=one, control=np.concatenate(halves, axis=1),
                sites=len(sites))


def test_sharded_sweep_matches_single_device(sharded):
    for r in sharded["ranks"]:
        got = r["sweep"].numpy()
        assert got.shape == sharded["ref_sweep"].shape
        np.testing.assert_allclose(got, sharded["ref_sweep"], atol=ATOL)


def test_sharded_recon_program_with_elbo_matches_single_device(sharded):
    _, mse_ref, _, elbo_ref = sharded["ref_elbo"]
    for r in sharded["ranks"]:
        t_starts, mse, perc, elbo = (np.asarray(a) for a in r["elbo"])
        assert mse.shape == elbo.shape == (len(t_starts), N)
        np.testing.assert_allclose(mse, mse_ref, atol=ATOL)
        np.testing.assert_allclose(elbo, elbo_ref, atol=ATOL)
        assert (elbo > 0).all() and (perc == 0).all()


def test_sharded_quantized_sweep_matches_single_device(sharded):
    """The ranks, every quantised call held to JAX's input and fed it where
    a code flips at a tie, against JAX's int8 program on one device, and
    against the port's one process held the same way."""
    jax_mse, _ = sharded["jax"]
    for r in sharded["ranks"]:
        feed = r["int8_feed"]
        print(f"rank: {feed}")
        assert feed["calls"] == sharded["sites"] > 0 and feed["off_tie"] == 0
        mse = r["int8_fed"][1].numpy()
        assert np.isfinite(mse).all()
        np.testing.assert_allclose(mse, jax_mse, atol=ATOL)
        np.testing.assert_allclose(mse, sharded["one"], atol=ATOL)


def test_every_absmax_is_the_whole_batch_one(sharded):
    """Each quantised call's scale is the max over both ranks' rows: the
    ranks make the same calls, and each product received the larger of the
    two ranks' own max |x|."""
    (a, b) = (r["int8_absmax"] for r in sharded["ranks"])
    assert len(a) == len(b) == sharded["sites"]
    for (local_a, got_a), (local_b, got_b) in zip(a, b):
        assert got_a == got_b == max(local_a, local_b)
    assert any(local_a != local_b for (local_a, _), (local_b, _) in zip(a, b))
    for r in sharded["ranks"]:
        np.testing.assert_array_equal(r["int8"][1].numpy(), sharded["ranks"][0]["int8"][1])


def test_per_rank_absmax_control_fails(sharded):
    """Each half alone (its own absmax), held to JAX's calls the same way,
    misses JAX's int8 program: the comparisons above can fail."""
    mse = sharded["control"]
    assert np.isfinite(mse).all()
    assert not np.allclose(mse, sharded["jax"][0], atol=ATOL)
    assert not np.allclose(mse, sharded["one"], atol=ATOL)
