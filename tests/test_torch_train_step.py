"""The port's DDPM training step against the JAX package's, on the CPU.

Identical weights (seeded JAX params converted with
``jax_unet_params_to_state_dict``), batch, t and noise, all made with numpy,
go through JAX's ``DDPMTrainStep(external_noise=True)`` and the port's
``DDPMTrainStep`` with the tiny UNet at 16x16. The JAX gradient tree is
mapped to the port's layout by the same converter (it only renames and
transposes, which commutes with differentiation).

Tolerances (fp32 on both sides):
- loss: rtol 1e-5. One forward agrees to ~3e-6 absolute
  (test_torch_unet.py) and the loss averages 1024 squared errors.
- gradients: per tensor, max|got - want| <= 1e-4 * max|want| + 1e-7. The
  backward runs ~30 layers in another order of sums (XLA vs oneDNN).
- params and EMA after two Adam updates from identical gradients: atol 5e-7,
  four fp32 ulps at 1.0, the size of the GroupNorm scales (optax and torch
  order the bias corrections differently; 2.4e-7 observed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpm_ood_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.train.ddpm import DDPMTrainStep as JaxTrainStep
from ddpm_ood_tpu.train.ddpm import TrainState
from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
from ddpm_ood_tpu_torch.models.unet import make_unet
from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep, _effective_accum
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_unet import seeded_jax_params

SCHED_ARGS = ("linear_beta", 1000, 1e-4, 2e-2)
LR = 1e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
ADAM_ATOL = 5e-7


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
    return unet, seeded_jax_params(unet, seed=3)


@pytest.fixture(scope="module")
def jax_grads(tiny):
    """JAX's jitted (loss, gradients) by prediction type on the inputs of
    seed 1 at b_scale 1.5, each compiled once for the module: the gradient
    tests hold the port to them, and the Adam test feeds the epsilon ones to
    both packages' updates."""
    unet, params = tiny
    cache = {}

    def get(ptype):
        if ptype not in cache:
            images, t, noise = make_inputs(seed=1)
            jstep = JaxTrainStep(sched=jax_make_schedule(*SCHED_ARGS, prediction_type=ptype),
                                 b_scale=1.5, external_noise=True)
            cache[ptype] = jax.jit(jstep._grads)(jax_state(unet, params), jnp.asarray(images),
                                                 jnp.asarray(noise), jnp.asarray(t))
        return cache[ptype]
    return get


def make_inputs(b=4, seed=0):
    """(images, t, noise) in the JAX layout (B, H, W, C)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, 16, 16, 1)).astype(np.float32)
    t = rng.integers(0, 1000, size=(b,)).astype(np.int32)
    noise = rng.standard_normal((b, 16, 16, 1)).astype(np.float32)
    return images, t, noise


def jax_state(unet, params, ema=False, warmup=0):
    lr = optax.linear_schedule(0.0, LR, warmup) if warmup else LR
    return TrainState.create(apply_fn=unet.apply, params=params, tx=optax.adam(lr),
                             ema_params=jax.tree_util.tree_map(jnp.array, params) if ema else None)


def torch_step(params, ptype="epsilon", **kw) -> DDPMTrainStep:
    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    model = model.to(memory_format=torch.channels_last)
    return DDPMTrainStep(model=model, sched=make_schedule(*SCHED_ARGS, prediction_type=ptype),
                         learning_rate=LR, **kw)


def to_torch(images, t, noise):
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    return nchw(images), torch.from_numpy(t).long(), nchw(noise)


def assert_tree_close(got: dict, want_tree, atol=None, what=""):
    want = jax_unet_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].detach().float()
        tol = atol if atol is not None else GRAD_RTOL * w.abs().max().item() + GRAD_ATOL
        err = (g - w).abs().max().item()
        assert err <= tol, f"{what} {key}: max abs err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("ptype", ["epsilon", "sample", "v_prediction"])
def test_loss_and_every_gradient_match_jax(tiny, jax_grads, ptype):
    unet, params = tiny
    images, t, noise = make_inputs(seed=1)
    want_loss, want_grads = jax_grads(ptype)
    step = torch_step(params, ptype, b_scale=1.5)
    x0, tt, eps = to_torch(images, t, noise)
    loss = step.grads(x0, eps, tt)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {n: p.grad for n, p in step.model.named_parameters()}
    assert all(g is not None for g in got.values())
    assert_tree_close(got, want_grads, what="grad")
    assert step.forwards == 1 and step.backwards == 1


def inject_grads(step: DDPMTrainStep, grads_tree) -> None:
    """Replace every .grad with JAX's gradients (converted to the port's layout)."""
    want = jax_unet_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_tree))
    for name, p in step.model.named_parameters():
        p.grad = want[name].clone()


def jax_steps_with_grads(jstep: JaxTrainStep, state, grads, n: int):
    """n jitted JAX train steps whose gradients are `grads`: JAX's own
    apply_gradients and EMA, with the loss and backward stubbed out."""
    jstep._grads = lambda *_: (jnp.zeros((), jnp.float32), grads)
    fn = jstep.make_train_step()
    x = jnp.zeros((1, 16, 16, 1))
    for _ in range(n):
        state, _ = fn(state, x, jnp.zeros((1,), jnp.int32), x)
    return state


def test_adam_update_and_ema_match_jax(tiny, jax_grads):
    """Adam (optax's defaults) and the EMA after the update, from the same
    gradients (JAX's of the epsilon case): a weight whose true gradient is 0
    (a key bias under softmax) has a gradient of rounding noise, and Adam's
    first update turns noise into a step of up to lr, so the update is held
    on identical gradients."""
    unet, params = tiny
    sched = jax_make_schedule(*SCHED_ARGS)
    _, grads = jax_grads("epsilon")
    state = jax_steps_with_grads(JaxTrainStep(sched=sched, external_noise=True, ema_decay=0.9),
                                 jax_state(unet, params, ema=True), grads, 2)
    step = torch_step(params, ema_decay=0.9)
    for _ in range(2):
        inject_grads(step, grads)
        step.update()
    assert step.updates == 2
    assert_tree_close(dict(step.model.named_parameters()), state.params, ADAM_ATOL, "param")
    assert_tree_close(step.ema, state.ema_params, ADAM_ATOL, "ema")


def test_effective_accum_matches_jax():
    from ddpm_ood_tpu.train.ddpm import _effective_accum as jax_effective_accum

    for k in range(1, 9):
        for b in range(1, 17):
            assert _effective_accum(k, b) == jax_effective_accum(k, b), (k, b)


def test_draw_shapes_and_range():
    step = DDPMTrainStep(model=make_unet("tiny", 2, 1, 1), sched=make_schedule(*SCHED_ARGS))
    x0 = torch.zeros(5, 1, 16, 16)
    t, noise = step.draw(x0, torch.Generator().manual_seed(0))
    assert t.shape == (5,) and t.dtype == torch.long and 0 <= t.min() and t.max() < 1000
    assert noise.shape == x0.shape and noise.dtype == torch.float32
