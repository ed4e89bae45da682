"""The port's quantised UNet (``--quantize`` int8, w8, mixed) against the JAX
package's, on the CPU, with the same seeded weights carried across by the
converter and the same numpy inputs.

- ``_pick_conv`` / ``_pick_dense`` choose JAX's class at every (mode, cin,
  cout) of the tiny, small and big presets, and the built models hold those
  classes; the state_dict is the unquantised model's in every mode.
- The tiny UNet, 2D and 3D, in int8 and w8: output within 1e-3 of its
  largest |value| of JAX's same mode. In int8 the activations reaching
  every quantised site are captured on both sides (forward pre-hooks here,
  ``nn.intercept_methods`` in JAX): their int8 codes are equal except
  within TIE_BAND code units of a .5 tie, where the two frameworks' fp32
  convolutions (oneDNN and XLA, ~1e-6 apart) may round either way; those
  near-ties are counted and printed. One flipped code moves the rest of
  the forward by ~1e-3 (a code step of a whole channel's sums), so the
  output is held with every quantised site fed JAX's input (see the test).
- ``mixed`` quantises nothing in the tiny preset: bit-equal to unquantised.
- The quantised sweep against the port's unquantised one, to the bounds
  JAX holds its own int8 sweep to against fp32 (tests/test_quant.py: median
  relative difference < 0.05, correlation > 0.999). The int8 sweep against
  JAX's quantised program is held at 1e-5 in tests/test_torch_quant_cli.py,
  through the scoring CLI.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_ood_tpu.models import unet as junet
from ddpm_ood_tpu_torch.diffusion import schedules
from ddpm_ood_tpu_torch.models import unet
from ddpm_ood_tpu_torch.ops.quant import quantize_int8
from ddpm_ood_tpu_torch.recon import sweep
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict

OUT_RTOL = 1e-3  # of the output's largest |value|
FORCED_RTOL = 1e-5  # the same, every quantised site fed JAX's input (8e-7 read)
TIE_BAND = 1e-3  # code units either side of a .5 tie
# int8 against fp32: tests/test_quant.py's bounds (median relative
# difference, correlation of the (K, B) MSE table)
SWEEP_MEDIAN_REL, SWEEP_CORR = 0.05, 0.999
SCHED_ARGS = ("scaled_linear_beta", 1000, 0.0015, 0.0195)
# the classes of both packages, by role
CONV_NAMES = {unet.PlainConv: "Conv", unet.QuantConv: "QuantConv",
              unet.WeightOnlyQuantConv: "WeightOnlyQuantConv"}
DENSE_NAMES = {torch.nn.Linear: "Dense", unet.QuantDense: "QuantDense"}
QUANT_SITES = (unet.QuantConv, unet.QuantDense)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_params(model, dims: int, size: int, seed: int = 0):
    """Seeded random params in the JAX tree (fan-in-scaled kernels, GroupNorm
    scales near 1, small biases), 2D or 3D; conv_out is not zero."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + (size,) * dims + (1,)),
                            jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_unet(params, dims: int, quant):
    model = unet.make_unet("tiny", dims, 1, 1, quant=quant)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    return model.to(memory_format=unet.memory_format(dims)).eval()


def _to_port(x: np.ndarray, dims: int) -> torch.Tensor:
    return torch.from_numpy(x).movedim(-1, 1).contiguous(memory_format=unet.memory_format(dims))


def conv_shapes(preset: str) -> tuple:
    """((cin, cout) of every block convolution, width of every attention
    projection) of a preset: the res blocks' conv1, conv2 and skip, the
    downsamplers and upsamplers (not conv_in and conv_out, which no mode
    quantises)."""
    with torch.device("meta"):
        model = unet.make_unet(preset, 2, 1, 1)
    convs, dense = set(), set()
    for name, m in model.named_modules():
        if isinstance(m, unet._Conv) and name not in ("conv_in", "out.2"):
            convs.add((m.conv.in_channels, m.conv.out_channels))
        if isinstance(m, unet.AttentionBlock):
            dense.add(m.to_q.in_features)
    return sorted(convs), sorted(dense)


@pytest.mark.parametrize("preset", ["tiny", "small", "big"])
def test_pick_conv_and_dense_match_jax(preset):
    assert unet.MIXED_QUANT_MIN_CH == junet.MIXED_QUANT_MIN_CH == 512
    convs, dense = conv_shapes(preset)
    for mode in (None, "int8", "w8", "mixed"):
        for cin, cout in convs:
            assert CONV_NAMES[unet._pick_conv(mode, cin, cout)] == \
                junet._pick_conv(mode, cin, cout).__name__, (mode, cin, cout)
        for ch in dense:
            assert DENSE_NAMES[unet._pick_dense(mode, ch)] == \
                junet._pick_dense(mode, ch).__name__, (mode, ch)
    # the built models hold the picked classes at every site
    for mode in ("int8", "w8", "mixed"):
        with torch.device("meta"):
            model = unet.make_unet(preset, 2, 1, 1, quant=mode)
        for name, m in model.named_modules():
            if isinstance(m, unet._Conv):
                cin, cout = m.conv.weight.shape[:2]
                want = (unet.PlainConv if name in ("conv_in", "out.2")
                        else unet._pick_conv(mode, cin, cout))
                built = CONV_NAMES.get(type(m.conv), "Conv")  # nn.Conv2d from PlainConv
                assert built == CONV_NAMES[want], (name, mode)
            if isinstance(m, unet.AttentionBlock):
                for proj in (m.to_q, m.to_k, m.to_v, m.proj_attn):
                    assert type(proj) is unet._pick_dense(mode, m.to_q.in_features)
            if isinstance(m, unet.ResnetBlock):
                assert type(m.time_emb_proj) is torch.nn.Linear


@pytest.mark.parametrize("dims", [2, 3])
def test_state_dict_is_the_unquantised_models_in_every_mode(dims):
    with torch.device("meta"):
        sds = {mode: unet.make_unet("small", dims, 1, 1, quant=mode).state_dict()
               for mode in (None, "int8", "w8", "mixed")}
    want = {k: tuple(v.shape) for k, v in sds[None].items()}
    for mode, sd in sds.items():
        assert {k: tuple(v.shape) for k, v in sd.items()} == want, mode


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def tiny_case(request):
    """(dims, JAX params, input, timesteps) of the tiny UNet: 2D at 16x16,
    3D at 8^3 volumes, 3 samples."""
    dims = request.param
    size = 16 if dims == 2 else 8
    params = seeded_params(junet.make_unet("tiny", dims, 1, 1), dims, size)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3,) + (size,) * dims + (1,)).astype(np.float32)
    t = np.array([0, 370, 990], np.int32)
    return dims, params, x, t


def _jax_forward(dims, params, x, t, mode):
    """JAX's tiny UNet in `mode`, jitted: its output, and the input of every
    QuantConv and QuantDense call in call order."""
    model = junet.make_unet("tiny", dims, 1, 1, quant=mode)

    def forward(p, xx, tt):
        seen = []

        def interceptor(next_fun, args, kwargs, context):
            if context.method_name == "__call__" and isinstance(
                    context.module, (junet.QuantConv, junet.QuantDense)):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            return model.apply({"params": p}, xx, tt), seen

    y, seen = jax.jit(forward)(params, jnp.asarray(x), jnp.asarray(t))
    return np.asarray(y), [np.asarray(a) for a in seen]


def _port_forward(dims, params, x, t, mode, forced=None):
    """The port's tiny UNet in `mode`: its output and the input of every
    quantised site in call order (JAX's layout). With `forced` (JAX's site
    inputs, in order) each quantised site takes JAX's input in place of its
    own: the rest of the network then runs on the same quantised outputs."""
    model = port_unet(params, dims, mode)
    seen = []

    def hook(mod, args):
        x = args[0]
        seen.append((unet._to_channels_last_dims(x) if x.dim() > 3 else x).numpy())
        if forced is None:
            return None
        f = torch.from_numpy(np.array(forced[len(seen) - 1]))
        if x.dim() > 3:  # back to (B, C, *spatial), channels-last memory
            f = unet._to_channels_first_dims(f)
        return (f,)

    for m in model.modules():
        if isinstance(m, QUANT_SITES):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        y = model(_to_port(x, dims), torch.from_numpy(t))
    return y.movedim(1, -1).numpy(), seen


@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_tiny_unet_matches_jax(tiny_case, mode):
    """w8: the outputs. int8: the codes at every quantised site equal JAX's
    up to the first site where one differs, and there only within TIE_BAND
    of a .5 tie (after a flipped code the two forwards part by more than fp32
    rounding, so later sites are not compared); the near-ties are counted.
    The output is held with each quantised site fed JAX's input (the rest of
    the network, GroupNorm, attention, residuals, then runs on the same
    quantised outputs), and without where no code flipped."""
    dims, params, x, t = tiny_case
    want, jseen = _jax_forward(dims, params, x, t, mode)
    got, pseen = _port_forward(dims, params, x, t, mode)
    assert np.abs(want).max() > 0.1 and got.shape == want.shape
    atol = OUT_RTOL * np.abs(want).max()
    if mode != "int8":
        assert not pseen and not jseen
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        return
    assert len(pseen) == len(jseen) > 0
    ties = flips = 0
    for i, (p, j) in enumerate(zip(pseen, jseen)):
        assert p.shape == j.shape
        # JAX's codes of its own activations, by the port's quantize_int8
        # (bit-equal to JAX's: tests/test_torch_quant.py)
        pq, sx = quantize_int8(torch.from_numpy(p))
        jq, _ = quantize_int8(torch.from_numpy(j))
        ratio = np.abs(p / sx.item())
        near = np.abs(ratio - np.floor(ratio) - 0.5) < TIE_BAND
        differ = (pq != jq).numpy()
        assert not (differ & ~near).any(), f"site {i}: a code differs away from a .5 tie"
        ties, flips = ties + int(near.sum()), int(differ.sum())
        if flips:
            break
    print(f"{dims}D int8: {len(pseen)} quantised sites; {ties} activations within {TIE_BAND} "
          f"of a .5 tie up to site {i}, where {flips} codes differ")
    if not flips:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    forced, fseen = _port_forward(dims, params, x, t, mode, forced=jseen)
    assert len(fseen) == len(jseen)
    np.testing.assert_allclose(forced, want, rtol=0, atol=FORCED_RTOL * np.abs(want).max())


def test_tiny_unet_mixed_is_the_unquantised_model(tiny_case):
    dims, params, x, t = tiny_case
    got, seen = _port_forward(dims, params, x, t, "mixed")
    plain, _ = _port_forward(dims, params, x, t, None)
    assert not seen
    np.testing.assert_array_equal(got, plain)


@pytest.fixture(scope="module")
def sweep_case():
    """The (K, B) MSE tables of the tiny UNet's unquantised and int8
    programs on the same 4 images of 8x8 and noise (10-step PLMS, skip 3, 2
    lane groups)."""
    params = seeded_params(junet.make_unet("tiny", 2, 1, 1), 2, 8, seed=3)
    images = np.random.default_rng(5).uniform(size=(4, 8, 8, 1)).astype(np.float32)

    def host_noise(shape, t_starts):
        return np.random.default_rng(6).standard_normal(shape).astype(np.float32)

    out = {}
    for mode in (None, "int8"):
        prog = sweep.ReconProgram(
            sched=schedules.make_schedule(*SCHED_ARGS), model_fn=port_unet(params, 2, mode),
            num_inference_steps=10, inference_skip_factor=3, num_groups=2,
            host_noise_fn=host_noise)
        out[mode] = prog(images)[1].numpy()
    return out


def test_quantised_sweep_tracks_the_unquantised_one(sweep_case):
    """tests/test_quant.py's bounds: the z-scored OOD statistic survives."""
    q, f = sweep_case["int8"].ravel(), sweep_case[None].ravel()
    assert q.shape == (16,) and np.isfinite(q).all()
    rel = np.abs(q - f) / (np.abs(f) + 1e-9)
    assert np.median(rel) < SWEEP_MEDIAN_REL, rel
    corr = np.corrcoef(f, q)[0, 1]
    assert corr > SWEEP_CORR and not math.isnan(corr), corr
