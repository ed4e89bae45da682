"""Gradient accumulation and lr warmup of the port's training step against
the JAX package's, on the CPU (tiny UNet, 16x16, inputs made with numpy).

- ``--grad_accum_steps``: the port's accumulated loss and gradients equal
  JAX's ``DDPMTrainStep(grad_accum=k)._grads`` (the mean of equal-microbatch
  means), for a nominal batch and a ragged tail that re-splits into fewer
  microbatches (``tests/test_grad_accum.py``).
- ``--lr_warmup_steps``: ``optax.linear_schedule(0, lr, W)`` gives the first
  update lr 0; the port's weights after updates 1 and 2 equal JAX's, from
  identical gradients.

Tolerances as in test_torch_train_step.py: loss rtol 1e-5, gradients
1e-4 * max|want| + 1e-7 per tensor, weights after Adam atol 5e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.train.ddpm import DDPMTrainStep as JaxTrainStep
from test_torch_train_step import (
    ADAM_ATOL,
    SCHED_ARGS,
    assert_tree_close,
    inject_grads,
    jax_state,
    make_inputs,
    to_torch,
    torch_step,
)
from test_torch_unet import seeded_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    unet = jax_make_unet("tiny", 2, 1, 1)
    return unet, seeded_jax_params(unet, seed=4)


# (grad_accum, batch, microbatches): nominal, and a ragged tail of 6 images
# that splits into 3 microbatches of 2 under --grad_accum_steps=4
@pytest.fixture(scope="module")
def jax_grads(tiny):
    """JAX's jitted (loss, gradients) under --grad_accum_steps=k on `batch`
    images of seed 5, each compiled once for the module: the accumulation
    tests hold the port to them, the warmup test feeds the (2, 4) ones to
    both packages' updates."""
    unet, params = tiny
    cache = {}

    def get(k, batch):
        if (k, batch) not in cache:
            images, t, noise = make_inputs(b=batch, seed=5)
            jstep = JaxTrainStep(sched=jax_make_schedule(*SCHED_ARGS), external_noise=True,
                                 grad_accum=k)
            cache[k, batch] = jax.jit(jstep._grads)(jax_state(unet, params),
                                                    jnp.asarray(images), jnp.asarray(noise),
                                                    jnp.asarray(t))
        return cache[k, batch]
    return get


@pytest.mark.parametrize("k,batch,micro", [(2, 4, 2), (4, 6, 3)])
def test_accumulated_gradients_match_jax(tiny, jax_grads, k, batch, micro):
    unet, params = tiny
    images, t, noise = make_inputs(b=batch, seed=5)
    want_loss, want_grads = jax_grads(k, batch)
    step = torch_step(params, grad_accum=k)
    x0, tt, eps = to_torch(images, t, noise)
    loss = step.grads(x0, eps, tt)
    assert step.backwards == micro and step.forwards == micro
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert_tree_close({n: p.grad for n, p in step.model.named_parameters()}, want_grads,
                      what="grad")


def test_warmup_first_update_has_lr_zero(tiny, jax_grads):
    """Both packages' updates from the same gradients (JAX's of the (2, 4, 2)
    accumulation case) under a 10-step warmup: the first moves nothing."""
    unet, params = tiny
    sched = jax_make_schedule(*SCHED_ARGS)
    _, grads = jax_grads(2, 4)
    step = torch_step(params, lr_warmup_steps=10)
    assert [step.lr_at(c) for c in (0, 1, 5, 10, 11)] == pytest.approx(
        [0.0, 1e-4, 5e-4, 1e-3, 1e-3])
    before = {n: p.detach().clone() for n, p in step.model.named_parameters()}
    # JAX's jitted update with the loss and backward stubbed out
    # (``jax_steps_with_grads``), compiled once and stepped from the last state
    jstep = JaxTrainStep(sched=sched, external_noise=True)
    jstep._grads = lambda *_: (jnp.zeros((), jnp.float32), grads)
    update, x = jstep.make_train_step(), jnp.zeros((1, 16, 16, 1))
    state = jax_state(unet, params, warmup=10)
    for n_updates in (1, 2):
        inject_grads(step, grads)
        step.update()
        state, _ = update(state, x, jnp.zeros((1,), jnp.int32), x)
        got = dict(step.model.named_parameters())
        if n_updates == 1:  # lr 0: nothing moves, in either package
            assert all(torch.equal(got[n], before[n]) for n in before)
        assert_tree_close(got, state.params, ADAM_ATOL, f"param after {n_updates} updates")
    assert step.updates == 2
