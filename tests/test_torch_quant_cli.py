"""``--quantize`` through the port's entry points, on the CPU.

- ``python -m ddpm_ood_tpu_torch.reconstruct --quantize=int8 --device=cpu``
  writes ``results_val.csv`` in the JAX CLI's layout, with the per-(image,
  start point) scores of JAX's quantised ``ReconProgram`` (the program the
  JAX CLI runs) on the same images (from the port's loader), weights (one
  seeded JAX tree, converted for the port), LPIPS npz, noise (handed to
  both) and lane group: batch 8 in one group, so every UNet call quantises
  a K x B mega-batch of 16 on both sides. The JAX CLI itself would add ~20
  s of orbax import and state set-up to this file's budget;
  tests/test_torch_reconstruct.py holds the two CLIs' CSVs together, and
  only the model differs here. mse and perceptual_difference are held to
  JAX's at RTOL, the fp32 CLI's tolerance.
- What makes that reachable: the input of every QuantConv and QuantDense
  call of JAX's sweep is captured (``jax.debug.callback``, in call order)
  and the port's CLI run checks its own input at the same call against it
  (forward pre-hooks, ``TieRepair``): their per-tensor int8 codes must be
  equal except within TIE_BAND code units of a .5 tie, where the two
  frameworks' fp32 convolutions (oneDNN and XLA, ~1e-6 apart) may round
  either way. At a call where a code flips, the port takes JAX's input in
  place of its own (the rest of its computation is its own), and the flips
  are counted; without this one flipped code moves the rest of the sweep
  by ~1e-3 (tests/test_torch_quant_unet.py). The checked calls must be as
  many as JAX's and of the same shapes: one UNet call a step on the whole
  mega-batch.
- Controls: the port's scores with its quantised sites computed in fp32
  (the scores of JAX's fp32 program, to 1e-5: tests/test_torch_reconstruct.py),
  and with an activation absmax per image or per lane in place of one over
  the mega-batch, each with the same images, noise and checked calls, must
  fail the comparison.
- ``serve`` builds its service, and ``bench_serve`` its program, in every
  mode; ``quality_check --quantize=int8`` scores the extra
  ``<sampler>+int8`` variant under JAX's label; every mode passes the
  scoring CLI's refusals, and ``--quantize`` under a ``WORLD_SIZE=2``
  without torchrun's rendezvous environment raises a named RuntimeError.
  Under torchrun, with each absmax over every rank:
  tests/test_torch_ddp_quant.py, test_torch_sharded_sweep.py and
  test_torch_serve_sharded.py.
- A hot reload under int8: the reloaded service scores exactly what a fresh
  service on the new weights scores, given the same noise: the quantised
  layers hold no stale weight codes.
"""

import argparse
import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddpm_ood_tpu_torch import bench_serve
from ddpm_ood_tpu_torch import quality_check as qc
from ddpm_ood_tpu_torch import reconstruct as cli
from ddpm_ood_tpu_torch import serve
from ddpm_ood_tpu_torch.config import parse_args_serve
from ddpm_ood_tpu_torch.models import unet
from ddpm_ood_tpu_torch.ops.quant import qconv_s8, quant_absmax, quantize_int8
from ddpm_ood_tpu_torch.serve import ScoringService, build_recon_program
from ddpm_ood_tpu_torch.trainers.base import BaseTrainer
from ddpm_ood_tpu_torch.trainers.reconstruct import COLUMNS, refuse_unported_flags
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from ddpm_ood_tpu_torch.data.csv_splits import write_split_csv
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_quant_unet import seeded_params
from test_torch_reconstruct import MODEL, host_noise, write_lpips_npz

CPU = torch.device("cpu")
SIZE = 8
MODES = ("int8", "w8", "mixed")
RTOL = 1e-5  # the CSV's scores against JAX's quantised program
TIE_BAND = 1e-3  # code units either side of a .5 tie (test_torch_quant_unet.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once, and
    torch's OpenMP pool per process oversubscribes the cores ~50-fold slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(seed: int) -> dict:
    model = unet.make_unet("tiny", 2, 1, 1)
    return unet.random_init_(model, torch.Generator().manual_seed(seed)).state_dict()


def _split(root, name: str, n: int, ood: bool, rng) -> str:
    """n 8x8 images: smooth sine fields, or checkerboards (OOD)."""
    d = root / name
    d.mkdir(parents=True)
    yy, xx = np.meshgrid(np.arange(SIZE), np.arange(SIZE), indexing="ij")
    paths = []
    for i in range(n):
        if ood:
            img = ((xx + yy + i) % 2).astype(np.float32)[None]
        else:
            phase = rng.uniform(0, 2 * np.pi)
            img = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) / SIZE + phase)[None]
        paths.append(str(d / f"{name}_{i}.npy"))
        np.save(paths[-1], img.astype(np.float32))
    write_split_csv(paths, str(root / f"{name}.csv"))
    return str(root / f"{name}.csv")


def make_run(root, params, n_val: int = 8):
    """A validation split of `n_val` images of 8x8, a checkpoint of the JAX
    tree `params` and an LPIPS npz; the scoring CLI's argv: batch 8, PLMS
    10/5 (2 start points) in one lane group, --quantize=int8. XLA's s8
    convolution is slow on the CPU (~6 s a batch at 16x16 and 4 start
    points), so the run is small."""
    val = _split(root, "val", n_val, False, np.random.default_rng(0))
    run = root / "output" / MODEL
    run.mkdir(parents=True)
    save_checkpoint(run / "checkpoint.pth", jax_unet_params_to_state_dict(params), epoch=3)
    write_lpips_npz(root / "lpips.npz")
    return ["--device=cpu", f"--output_dir={root / 'output'}", f"--model_name={MODEL}",
            f"--validation_ids={val}", f"--in_ids={val}", f"--out_ids={val}",
            "--run_in=0", "--run_out=0", f"--image_size={SIZE}", "--model_type=tiny",
            "--is_grayscale=1", "--batch_size=8", "--beta_schedule=scaled_linear_beta",
            "--beta_start=0.0015", "--beta_end=0.0195", "--num_inference_steps=10",
            "--inference_skip_factor=5", "--num_workers=2", "--recon_groups=1",
            "--quantize=int8"]


def _jax_program_scores(params, images, npz, sites: list, more=()) -> tuple:
    """(t_starts, mse (K, B), perceptual (K, B)) of JAX's quantised program
    as its CLI builds it, on `images` with the shared noise; the input of
    every QuantConv and QuantDense call appended to `sites` in call order.
    With `more` batches, a tuple of such triples: the same program on
    `images`, then on each of them."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from ddpm_ood_tpu.diffusion.schedules import make_schedule
    from ddpm_ood_tpu.losses.lpips import PerceptualLoss, load_lpips_npz
    from ddpm_ood_tpu.models import unet as junet
    from ddpm_ood_tpu.recon.sweep import ReconProgram

    model = junet.make_unet("tiny", 2, 1, 1, quant="int8")

    def interceptor(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(
                context.module, (junet.QuantConv, junet.QuantDense)):
            jax.debug.callback(lambda a: sites.append(np.array(a)), args[0], ordered=True)
        return next_fun(*args, **kwargs)

    def model_fn(p, x, t):
        with fnn.intercept_methods(interceptor):
            return model.apply({"params": p}, x, t)

    program = ReconProgram(
        sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195),
        model_fn=jax.tree_util.Partial(model_fn, params),
        num_inference_steps=10, inference_skip_factor=5, num_groups=1, host_noise_fn=host_noise,
        perceptual_fn=PerceptualLoss(dimensions=2, lpips_normalize=True,
                                     params=load_lpips_npz(str(npz))),
        latent_sample_shape=(SIZE, SIZE, 1), overlap_host_noise=False)
    out = []
    for batch in (images, *more):
        t, mse, perc = program(jnp.asarray(batch), jax.random.PRNGKey(0))
        out.append((np.asarray(t), np.asarray(mse), np.asarray(perc)))
    return tuple(out) if more else out[0]


class TieRepair:
    """Forward pre-hooks on every quantised site of a port UNet, which hold
    the input of each call against JAX's input at the same call (`want`, in
    call order): the per-tensor int8 codes of the two (each with its own
    scale, by the port's quantize_int8, bit-equal to JAX's) must be equal,
    or (`strict`) differ only within TIE_BAND of a .5 tie. Where a code
    differs the call takes JAX's input. Counts calls, flipped codes and
    repaired calls."""

    def __init__(self, model, want: list, strict: bool = True):
        self.want, self.strict = want, strict
        self.calls = self.flips = self.repaired = 0
        self.handles = [m.register_forward_pre_hook(self) for m in model.modules()
                        if isinstance(m, (unet.QuantConv, unet.QuantDense))]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def __call__(self, module, args):
        x = args[0]
        mine = unet._to_channels_last_dims(x) if x.dim() > 3 else x
        assert self.calls < len(self.want), "more quantised calls than JAX's sweep makes"
        theirs = torch.from_numpy(self.want[self.calls])
        self.calls += 1
        assert mine.shape == theirs.shape, (self.calls, tuple(mine.shape), tuple(theirs.shape))
        pq, sx = quantize_int8(mine)
        differ = pq != quantize_int8(theirs)[0]
        if not differ.any():
            return None
        if self.strict:
            ratio = (mine.float() / sx).abs()
            near = ((ratio - ratio.floor()) - 0.5).abs() < TIE_BAND
            assert not (differ & ~near).any(), f"call {self.calls}: a code differs off a .5 tie"
        self.flips += int(differ.sum())
        self.repaired += 1
        return (unet._to_channels_first_dims(theirs) if x.dim() > 3 else theirs,)


@pytest.fixture(scope="module")
def int8_run(tmp_path_factory):
    from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet

    root = tmp_path_factory.mktemp("quant_cli")
    params = seeded_params(jax_make_unet("tiny", 2, 1, 1), 2, SIZE)
    argv = make_run(root, params)
    counts = (quant_absmax.launches, qconv_s8.launches)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
        args = cli.parse_args(argv)
        recon = cli.Reconstruct(args, CPU)
        recon._program(args.inference_skip_factor).host_noise_fn = host_noise
        batch = next(iter(recon._make_loader(args.validation_ids, None)))
        images = np.moveaxis(batch["image"], 1, -1)
        sites = []
        want = _jax_program_scores(params, images, root / "lpips.npz", sites)
        repair = TieRepair(recon.unet, sites)
        recon.reconstruct(args)
        repair.remove()
    assert (quant_absmax.launches, qconv_s8.launches) == counts  # plain versions on the CPU
    print(f"int8 sweep: {repair.calls} quantised calls, {repair.flips} codes flipped at a .5 "
          f"tie in {repair.repaired} of them")
    return root, argv, recon, ([Path(f).stem for f in batch["filename"]], *want), \
        (batch, sites, repair)


def _read(path) -> list:
    with open(path, newline="") as fh:
        return sorted(csv.DictReader(fh), key=lambda r: (r["filename"], int(r["t"])))


def _matches(got, want) -> bool:
    return got.shape == want.shape and np.allclose(got, want, rtol=RTOL, atol=0)


def test_cli_writes_the_jax_int8_results_csv(int8_run):
    root, _, recon, (filenames, t_starts, _, _), _ = int8_run
    ood = root / "output" / MODEL / "ood"
    assert sorted(p.name for p in ood.glob("results_*.csv")) == ["results_val.csv"]
    assert isinstance(recon.unet.up_blocks[0].resnets[0].conv1.conv, unet.QuantConv)
    rows = _read(ood / "results_val.csv")
    assert list(rows[0]) == ["", *COLUMNS]  # the JAX layout
    assert sorted((r["filename"], int(r["t"])) for r in rows) == sorted(
        (f, int(t)) for f in filenames for t in t_starts)
    assert {r["type"] for r in rows} == {"val"}


def test_quantised_sweep_matches_jax(int8_run):
    """The CSV's per-(lane, image) scores against JAX's quantised program at
    RTOL, every quantised call checked against JAX's (TieRepair)."""
    root, _, _, (filenames, t_starts, mse, perc), (_, sites, repair) = int8_run
    assert repair.calls == len(sites) > 0
    rows = {(r["filename"], int(r["t"])): r
            for r in _read(root / "output" / MODEL / "ood" / "results_val.csv")}
    for col, want in (("mse", mse), ("perceptual_difference", perc)):
        got = np.array([[float(rows[f, int(t)][col]) for f in filenames] for t in t_starts])
        assert want.shape == (2, 8) and np.isfinite(got).all() and (got > 0).all()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=col)


@pytest.fixture(scope="module")
def ragged_run(tmp_path_factory):
    """The int8 CLI on 10 validation images at batch 8: the second batch's 2
    real images are wrap-padded to 8, as the JAX CLI pads a ragged batch,
    so its padded rows enter every activation absmax. JAX's program runs on
    the first batch, then on the padded second one."""
    from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet

    root = tmp_path_factory.mktemp("quant_ragged")
    params = seeded_params(jax_make_unet("tiny", 2, 1, 1), 2, SIZE)
    argv = make_run(root, params, n_val=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
        args = cli.parse_args(argv)
        recon = cli.Reconstruct(args, CPU)
        recon._program(args.inference_skip_factor).host_noise_fn = host_noise
        batches = list(recon._make_loader(args.validation_ids, None))
        assert [len(b["filename"]) for b in batches] == [8, 2]
        images = [np.moveaxis(b["image"], 1, -1) for b in batches]
        padded = np.take(images[1], np.arange(8) % 2, axis=0)
        sites = []
        want = _jax_program_scores(params, images[0], root / "lpips.npz", sites, more=(padded,))
        repair = TieRepair(recon.unet, sites)
        recon.reconstruct(args)
        repair.remove()
    print(f"ragged int8 sweep: {repair.calls} quantised calls, {repair.flips} codes flipped "
          f"at a .5 tie in {repair.repaired} of them")
    return root, [[Path(f).stem for f in b["filename"]] for b in batches], want, sites, repair


def test_ragged_int8_batch_is_wrap_padded_as_jax(ragged_run):
    """The CSV's scores of both batches, the ragged one's 2 real images
    included, against JAX's quantised program on the first batch and on the
    wrap-padded second batch at RTOL, every quantised call of both checked
    against JAX's (TieRepair): a port that quantised the 2 real rows alone
    would take another absmax at every site."""
    root, names, want, sites, repair = ragged_run
    assert repair.calls == len(sites) > 0
    rows = {(r["filename"], int(r["t"])): r
            for r in _read(root / "output" / MODEL / "ood" / "results_val.csv")}
    assert len(rows) == 2 * 10
    for filenames, (t_starts, mse, perc) in zip(names, want):
        b = len(filenames)
        for col, full in (("mse", mse), ("perceptual_difference", perc)):
            got = np.array([[float(rows[f, int(t)][col]) for f in filenames] for t in t_starts])
            assert full.shape == (2, 8) and np.isfinite(got).all() and (got > 0).all()
            np.testing.assert_allclose(got, full[:, :b], rtol=RTOL, atol=0,
                                       err_msg=f"{col}, batch of {b}")


def _per_image(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)


def _per_lane(x: torch.Tensor) -> torch.Tensor:
    """The mega-batch is lane-major: K = 2 lanes of 8 images."""
    lanes = x.float().abs().reshape(2, -1).amax(dim=1)
    return lanes.repeat_interleave(x.shape[0] // 2).reshape((-1,) + (1,) * (x.dim() - 1))


def _fp32_conv(self, x: torch.Tensor) -> torch.Tensor:
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    return conv(x, self.weight, self.bias, self.strides, [lo for lo, _ in self.pads])


@pytest.mark.parametrize("control", ["fp32", "per_image_absmax", "per_lane_absmax"])
def test_the_comparison_rejects_what_is_not_jaxs_int8(int8_run, control, monkeypatch):
    """The port scoring its quantised sites in fp32, or with the activation
    absmax taken per image or per lane of the mega-batch (its calls checked
    and repaired as in the CLI run, without the tie rule), scores outside
    RTOL of JAX's int8 program."""
    _, _, recon, (_, _, mse, perc), (batch, sites, _) = int8_run
    if control == "fp32":
        monkeypatch.setattr(unet.QuantConv, "forward", _fp32_conv)
        monkeypatch.setattr(unet.QuantDense, "forward", torch.nn.Linear.forward)
    else:
        monkeypatch.setattr(unet, "quant_absmax",
                            _per_image if control == "per_image_absmax" else _per_lane)
    repair = TieRepair(recon.unet, sites, strict=False)
    try:
        _, got_mse, got_perc = (np.asarray(a) for a in recon._program(5)(
            np.moveaxis(batch["image"], 1, -1)))
    finally:
        repair.remove()
    assert repair.calls == len(sites)
    assert np.isfinite(got_mse).all() and np.isfinite(got_perc).all()
    assert not _matches(got_mse, mse) and not _matches(got_perc, perc)


@pytest.mark.parametrize("mode", MODES)
def test_every_mode_passes_the_scoring_refusals_in_one_process(mode, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    refuse_unported_flags(cli.parse_args(["--device=cpu", "--model_name=m",
                                          f"--quantize={mode}"]))


def test_quantize_over_more_than_one_process_raises(tmp_path, monkeypatch):
    """--quantize under torchrun takes each absmax over every rank
    (tests/test_torch_ddp_quant.py); a WORLD_SIZE without torchrun's
    rendezvous environment raises a named error before any work."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for key in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2.*rendezvous.*RANK"):
        cli.main(["--device=cpu", f"--output_dir={tmp_path}", "--model_name=m",
                  "--quantize=int8"])


def _sites(model) -> dict:
    return {cls.__name__: sum(isinstance(m, cls) for m in model.modules())
            for cls in (unet.QuantConv, unet.WeightOnlyQuantConv, unet.QuantDense)}


@pytest.mark.parametrize("mode", MODES)
def test_serve_builds_its_service_in_every_mode(int8_run, mode, monkeypatch):
    root, argv = int8_run[:2]
    monkeypatch.setattr(serve, "warmup_program", lambda *a, **k: -1.0)  # no sweep here
    serve_argv = [a for a in argv if a.split("=")[0] in (
        "--device", "--output_dir", "--model_name", "--image_size", "--model_type",
        "--is_grayscale", "--beta_schedule", "--beta_start", "--beta_end",
        "--num_inference_steps", "--inference_skip_factor", "--recon_groups", "--batch_size")]
    service = serve.build_service(parse_args_serve(
        serve_argv + ["--batch_window_ms=0", f"--quantize={mode}"]))
    # the tiny preset: 22 res-block convs, 7 skips, 2 down- and 2 upsamplers;
    # 4 attention blocks of 4 projections
    sites = _sites(service.program.model_fn.__self__.unet)
    assert sites == {"int8": {"QuantConv": 33, "WeightOnlyQuantConv": 0, "QuantDense": 16},
                     "w8": {"QuantConv": 0, "WeightOnlyQuantConv": 33, "QuantDense": 0},
                     "mixed": {"QuantConv": 0, "WeightOnlyQuantConv": 0,
                               "QuantDense": 0}}[mode]


@pytest.mark.parametrize("mode", MODES)
def test_bench_serve_builds_its_program_in_every_mode(mode, monkeypatch):
    """bench_serve up to its server: the quantised model under the service."""
    built = []

    class Built(Exception):
        pass

    def make_server(service, host, port):
        built.append(service)
        raise Built

    monkeypatch.setattr(serve, "make_server", make_server)
    with pytest.raises(Built):
        bench_serve.main(["--quick", "--device=cpu", f"--quantize={mode}"])
    sites = _sites(built[0].program.model_fn)
    assert sites["QuantConv"] == (33 if mode == "int8" else 0)
    assert sites["WeightOnlyQuantConv"] == (33 if mode == "w8" else 0)


def test_quality_check_reports_the_jax_label(tmp_path, capsys):
    save_checkpoint(tmp_path / "given.pth", _seeded(0))
    payload = qc.main(["--device=cpu", "--size=8", "--n_eval=4", "--steps=10", "--skip=5",
                       "--samplers=dpm@10/5", f"--checkpoint={tmp_path / 'given.pth'}",
                       "--quantize=int8", f"--workdir={tmp_path / 'w'}"])
    assert list(payload["per_sampler"]) == ["dpm@10/5", "dpm@10/5+int8"]
    for entry in payload["per_sampler"].values():
        assert 0.0 <= entry["hard"]["auroc"] <= 1.0 and 0.0 <= entry["easy"]["auroc"] <= 1.0
    assert payload["timing"]["dpm@10/5+int8"]["recons"] == payload["timing"]["dpm@10/5"]["recons"]
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert json.loads(printed[-1]) == payload
    for mode in MODES:  # every mode parses, as the JAX script's
        assert qc.parse_args([f"--quantize={mode}"]).quantize == mode


def _service_args(root) -> argparse.Namespace:
    return argparse.Namespace(
        seed=2, output_dir=str(root / "output"), model_name="reload_run", spatial_dimension=2,
        image_size=8, image_roi=None, latent_pad=None, vqvae_checkpoint=None,
        prediction_type="epsilon", model_type="tiny", beta_schedule="scaled_linear_beta",
        beta_start=0.0015, beta_end=0.0195, b_scale=1.0, snr_shift=1, is_grayscale=1,
        use_ema=0, ddpm_checkpoint_epoch=None, num_inference_steps=10, inference_skip_factor=5,
        recon_groups=1, quantize="int8")


def test_int8_hot_reload_scores_the_new_weights(tmp_path):
    args = _service_args(tmp_path)
    run = tmp_path / "output" / "reload_run"
    run.mkdir(parents=True)
    save_checkpoint(run / "checkpoint.pth", _seeded(0))
    trainer = BaseTrainer(args, CPU)
    program = build_recon_program(trainer, args)
    t = np.repeat(np.asarray(program.t_starts, np.int64), 4)
    stats = {"filename": np.array([f"v{i % 4}" for i in range(len(t))], dtype=object),
             "t": t, "mse": 0.1 + 0.01 * (np.arange(len(t)) % 4),
             "perceptual_difference": np.zeros(len(t))}
    svc = ScoringService(program, stats, batch_size=4, model_name="t",
                         reload_fn=lambda: str(trainer.reload_params()))
    imgs = np.random.default_rng(0).uniform(size=(2, 8, 8, 1)).astype("float32")
    before = svc.score(imgs)

    save_checkpoint(run / "checkpoint.pth", _seeded(1))
    svc.reload()
    noise = svc.generator.get_state()
    after = svc.score(imgs)
    assert any(b["per_t"] != a["per_t"] for b, a in zip(before, after))

    fresh = ScoringService(build_recon_program(BaseTrainer(args, CPU), args), stats,
                           batch_size=4, model_name="t")
    fresh.generator.set_state(noise)
    for a, f in zip(after, fresh.score(imgs)):
        assert a["per_t"] == f["per_t"] and a["z_score_mse"] == f["z_score_mse"]
