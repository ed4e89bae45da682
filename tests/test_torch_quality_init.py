"""The pinned quality gate's initial weights against the JAX package's init.

``ddpm_ood_tpu_torch/assets/quality_init_tiny_seed2.npz`` holds the params
that ``make_ddpm_state(make_unet("tiny", 2, 1, 1), PRNGKey(2), (16, 16, 1))``
draws, one fp32 array per "/"-joined path of the JAX param tree. The card
host has no JAX, so this file is how the port's ``--pinned`` gate starts from
the same weights as the JAX gate.

- The committed file equals a fresh JAX draw, bit for bit.
- The port's UNet, loaded from the file through ``utils/convert.py``, gives
  the JAX model's forward on one seeded input (rtol 1e-5, fp32; the output
  conv is zero at init, so the forward is read before it: the JAX model's
  ``norm_out`` activations against the port's ``out[0]``, and the output,
  exactly 0, with it).
- The port's trainer, given the file, starts from exactly these weights.

Regenerate the file with ``python tests/test_torch_quality_init.py``.
"""

import sys
from pathlib import Path

if __name__ == "__main__":  # as a script: the repo on the path, JAX on the CPU as in the tests
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parent)]
    import conftest  # noqa: F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ddpm_ood_tpu_torch.quality_check import QUALITY_INIT  # noqa: E402
from ddpm_ood_tpu_torch.utils.convert import (  # noqa: E402
    jax_unet_params_to_state_dict, load_params_npz)

N_PARAMS = 1_112_801


def jax_quality_init() -> dict:
    """{"/"-joined JAX param path: fp32 array} of the gate's tiny-UNet init:
    ``make_ddpm_state``'s ``unet.init`` on its (1, 16, 16, 1) dummy from
    PRNGKey(2), as one jitted program (the eager init's bits, a third of its
    time on the CPU)."""
    from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet

    unet = jax_make_unet("tiny", 2, 1, 1)
    params = jax.jit(lambda rng: unet.init(rng, jnp.zeros((1, 16, 16, 1), jnp.float32),
                                           jnp.zeros((1,), jnp.int32))["params"])(
        jax.random.PRNGKey(2))
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}


@pytest.fixture(scope="module")
def fresh():
    return jax_quality_init()


def test_committed_init_equals_the_jax_init_bit_for_bit(fresh):
    with np.load(QUALITY_INIT) as data:
        committed = {k: data[k] for k in data.files}
    assert sorted(committed) == sorted(fresh)
    assert sum(v.size for v in committed.values()) == N_PARAMS
    for key, want in fresh.items():
        got = committed[key]
        assert got.dtype == np.float32 and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


def test_port_forward_from_the_init_equals_jax(fresh):
    from flax import traverse_util

    from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
    from ddpm_ood_tpu_torch.models.unet import make_unet

    params = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in fresh.items()})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    unet = jax_make_unet("tiny", 2, 1, 1)
    want_out, inter = jax.jit(lambda p, x, t: unet.apply(
        {"params": p}, x, t, capture_intermediates=lambda mdl, _: mdl.name == "norm_out",
        mutable=["intermediates"]))(params, jnp.asarray(x), jnp.asarray(t))
    want_norm = np.asarray(inter["intermediates"]["norm_out"]["__call__"][0])

    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(load_params_npz(QUALITY_INIT)),
                          strict=True)
    captured = {}
    model.out[0].register_forward_hook(lambda m, i, o: captured.setdefault("norm", o))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    got_norm = captured["norm"].permute(0, 2, 3, 1).numpy()
    assert np.abs(want_norm).max() > 0.1
    np.testing.assert_allclose(got_norm, want_norm, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), np.asarray(want_out))


def test_trainer_starts_from_the_init_file(tmp_path):
    from ddpm_ood_tpu_torch.config import parse_args_train_ddpm
    from ddpm_ood_tpu_torch.quality_check import make_dataset
    from ddpm_ood_tpu_torch.trainers.ddpm_trainer import DDPMTrainer

    rng = np.random.default_rng(0)
    ns = parse_args_train_ddpm([])
    vars(ns).update(
        output_dir=str(tmp_path / "output"), model_name="quality_fashionmnist",
        training_ids=make_dataset(tmp_path, "train", 4, 16, rng),
        validation_ids=make_dataset(tmp_path, "val", 4, 16, rng), image_size=16,
        model_type="tiny", is_grayscale=1, batch_size=4, seed=2, num_workers=1)
    trainer = DDPMTrainer(ns, torch.device("cpu"), init_weights=QUALITY_INIT)
    want = jax_unet_params_to_state_dict(load_params_npz(QUALITY_INIT))
    got = trainer.unet.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


if __name__ == "__main__":
    arrays = jax_quality_init()
    assert sum(v.size for v in arrays.values()) == N_PARAMS
    np.savez(QUALITY_INIT, **arrays)
    print(f"wrote {QUALITY_INIT} ({len(arrays)} arrays, {N_PARAMS} params)")
