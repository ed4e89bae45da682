"""A rank of the port's multi-process CPU tests.

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        tests/torch_ddp_worker.py <mode> <in> <out_dir> [<mode> <in> <out_dir> ...]

or each rank started with torchrun's rendezvous environment (RANK,
LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as ``Ranks`` does.

Every rank refuses JAX, its relatives and the JAX package before anything is
imported (``sys.modules[name] = None``), joins the gloo group, runs each
mode and writes what the parent test compares to ``<out_dir>/rank<r>.pt``
(or leaves a CLI's files behind). Modes:

  ddpm_step   three training steps (grad_accum 1 and 2) of the tiny UNet
              under DDP and under FSDP2 on this rank's half of a batch with
              (t, noise) passed in: the first step's all-reduced loss and
              gathered gradients, the parameters after its update, the
              losses of the next two steps.
  vqvae_step  one VQ-VAE G step and one D step under DDP on this rank's half
              of a batch: metrics, gradients, codebook and EMA statistics,
              BatchNorm running statistics.
  trainer     the DDPM trainer's phases (the twin of the JAX package's
              tests/multiprocess_train_worker.py): a frozen-parameter epoch
              and validation with (t, noise) a function of each image, two
              epochs of training, a resume to four, an epoch on a split the
              ranks do not divide.
  fsdp        --fsdp=1 against DDP for one epoch, its sharded state, its
              checkpoint's resume, and one --fsdp=1 VQ-VAE epoch.
  recon       the scoring pipeline with zero noise, then a resume from
              partial CSVs that hold each rank's first batch.
  cli         the port's CLIs one after another, as ``python -m
              ddpm_ood_tpu_torch.<module> <argv>`` runs each: <in> is a JSON
              list of [module, argv] pairs. A lone CLI makes the process
              group itself; a list shares one that the worker makes.
  sharded     sharded calls on this rank's half of 16 images: the PLMS sweep
              of a linear stand-in, ``ReconProgram`` with ``score_elbo``,
              and the int8 tiny UNet's program (each quantised call's absmax
              recorded), then the same with every call held to JAX's input
              (``TieFeed``). The parent writes the int8 weights and JAX's
              inputs to <in>'s ``state`` and ``sites`` paths while the ranks
              run.
  serve       sharded ``ScoringService``s of the tiny UNet: host noise,
              generator noise with and without a warmup, a batch the ranks
              do not divide, int8, and a hot reload; rank 0's responses.
  recon_quant the scoring CLI under ``--quantize=int8`` with generator
              noise (every quantised call's absmax recorded, and its input
              written to ``<in>'s out/inputs<r>.pt``), then a resume from
              partial CSVs that hold different numbers of batches on the
              ranks.
"""

import sys

BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax", "pandas", "sklearn", "matplotlib",
           "tensorboardX", "PIL", "ddpm_ood_tpu")

if __name__ == "__main__":
    for _name in BLOCKED:
        sys.modules[_name] = None

import argparse  # noqa: E402
import copy  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def deterministic_draw(num_train_timesteps: int):
    """(t, noise) as a function of each image's content: the same in any
    process count or batch packing (tests/multiprocess_train_worker.py's
    ``deterministic_simplex_batch``, for the port's ``_draw``)."""
    from ddpm_ood_tpu_torch.train.ddpm import channels_last

    def draw(x0: torch.Tensor):
        sums = x0.reshape(len(x0), -1).double().sum(1).numpy()
        t = (np.abs(sums) * 9973.0).astype(np.int64) % num_train_timesteps
        noise = np.stack([np.random.default_rng(int(ti) + 17).normal(size=tuple(x0.shape[1:]))
                          for ti in t]).astype(np.float32)
        return torch.from_numpy(t), channels_last(torch.from_numpy(noise))

    return draw


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _half(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def _step_model(inp: dict, accum: int, sharded: bool):
    """The tiny UNet from the input's state_dict and its training step, under
    DDP or (``sharded``) under FSDP2 with every parameter that the process
    count divides sharded, as ``--fsdp=1`` wraps it."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.models.unet import make_unet
    from ddpm_ood_tpu_torch.parallel import fsdp
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep

    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(inp["state_dict"], strict=True)
    model = model.to(memory_format=torch.channels_last)
    if sharded:
        replicated = fsdp.apply_fsdp(model, min_size=1)
        wrap = dict(runner=model, sync_grads=lambda: fsdp.sync_replicated_grads(replicated))
    else:
        wrap = dict(runner=pmesh.wrap_ddp(model, torch.device("cpu")))
    return model, DDPMTrainStep(model=model, sched=make_schedule(*inp["sched_args"]),
                                learning_rate=inp["lr"], grad_accum=accum, **wrap)


def mode_ddpm_step(inp: dict, rank: int, world: int) -> dict:
    """Under DDP (keys 1 and 2, the grad_accum) and under FSDP2 (keys
    ("fsdp", 1) and ("fsdp", 2)): the first step's all-reduced loss and
    whole gradients, the parameters after its update, and the all-reduced
    losses of two more steps."""
    from ddpm_ood_tpu_torch.parallel import fsdp
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh

    out = {}
    x0, t, noise = (_half(inp[n], rank, world) for n in ("x0", "t", "noise"))
    for sharded in (False, True):
        for k in (1, 2):
            model, step = _step_model(inp, k, sharded)
            loss = pmesh.all_reduce_mean(step.grads(x0, noise, t))
            grads = {n: fsdp.full_tensor(p.grad).clone() for n, p in model.named_parameters()}
            step.update()
            params = {n: fsdp.full_tensor(p.detach()).clone() for n, p in model.named_parameters()}
            losses = [loss.item()] + [pmesh.all_reduce_mean(step.step(x0, t, noise)).item()
                                      for _ in range(2)]
            out[("fsdp", k) if sharded else k] = {
                "loss": loss.item(), "grads": grads, "backwards": step.backwards,
                "params": params, "losses": losses,
                "sharded": sum(map(fsdp.is_sharded, model.parameters()))}
    return out


def mode_vqvae_step(inp: dict, rank: int, world: int) -> dict:
    from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
    from ddpm_ood_tpu_torch.models.discriminator import PatchDiscriminator
    from ddpm_ood_tpu_torch.models.unet import memory_format
    from ddpm_ood_tpu_torch.models.vqvae import VQVAE
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.train.vqvae import VQVAETrainStep

    model = VQVAE(spatial_dims=2, **inp["config"])
    model.load_state_dict(inp["vq_state"], strict=True)
    disc = PatchDiscriminator(spatial_dims=2, num_layers_d=3, num_channels=8, in_channels=1)
    disc.load_state_dict(inp["disc_state"], strict=True)
    model, disc = (m.to(memory_format=memory_format(2)) for m in (model, disc))
    step = VQVAETrainStep(
        model=model, discriminator=disc, spatial_dims=2, vqvae_lr=inp["lr"],
        perceptual=PerceptualLoss(weights_path=inp["lpips"], spatial_dims=2),
        g_runner=pmesh.wrap_ddp(model, torch.device("cpu")),
        d_runner=pmesh.wrap_ddp(disc, torch.device("cpu")))
    images = _half(inp["images"], rank, world)
    metrics, recon = step.generator_step(images, inp["adv_w"])
    out = {"metrics": {k: pmesh.all_reduce_mean(v).item() for k, v in metrics.items()},
           "g_grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "quantizer": {k: v.clone() for k, v in step.quantizer.state_dict().items()}}
    fake = _half(inp["d_fake"], rank, world)
    d_loss = step.discriminator_step(fake, images, inp["adv_w"])
    out.update(d_loss=pmesh.all_reduce_mean(d_loss).item(),
               d_grads={n: p.grad.clone() for n, p in disc.named_parameters()},
               d_state={k: v.clone() for k, v in disc.state_dict().items()})
    return out


def _trainer(args: dict, **over):
    from ddpm_ood_tpu_torch.trainers import DDPMTrainer

    a = argparse.Namespace(**{**args, **over})
    trainer = DDPMTrainer(a, torch.device("cpu"))
    trainer._draw = deterministic_draw(trainer.sched.num_train_timesteps)
    return trainer, a


def _local_bytes(trainer) -> int:
    from ddpm_ood_tpu_torch.parallel import fsdp

    moments = [v for s in trainer.step.optimizer.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    return fsdp.sharded_bytes_per_device([*trainer.unet.parameters(), *moments])


def mode_trainer(args: dict, rank: int, world: int) -> dict:
    out = {}
    # A: frozen parameters, content-determined (t, noise): the epoch's train
    # loss and the validation loss do not depend on the process count
    t_a, _ = _trainer(args, model_name="mp_parity", learning_rate=1e-30)
    out["parity_loss"] = t_a.train_epoch(0)
    t_a.sample_grid = lambda x0: None  # 1000 sampler forwards, not what is held here
    t_a.val_epoch(0)
    out["parity_val"] = [json.loads(line) for line in
                         (t_a.run_dir / "val" / "scalars.jsonl").read_text().splitlines()
                         ] if rank == 0 else None
    out["partition"] = list(t_a.train_loader.filenames)
    # B: two epochs of real training, rank 0's checkpoint_2
    t_b, a_b = _trainer(args, model_name="mp_resume")
    t_b.train(a_b)
    out["digest_b"] = digest(t_b.unet.state_dict().values())
    # C: a fresh trainer resumes from rank 0's checkpoint and trains to epoch 4
    t_c, a_c = _trainer(args, model_name="mp_resume", n_epochs=4)
    out["resume_start"] = t_c.start_epoch
    t_c.train(a_c)
    out["digest_c"] = digest(t_c.unet.state_dict().values())
    out["global_step"] = t_c.global_step
    # a split that 2 processes do not divide: equal partitions, equal steps
    t_r, _ = _trainer(args, model_name="mp_ragged", training_ids=args["ragged_ids"])
    out["ragged_partition"] = list(t_r.train_loader.filenames)
    out["ragged_loss"] = t_r.train_epoch(0)
    out["ragged_step"] = t_r.global_step
    return out


def mode_fsdp(args: dict, rank: int, world: int) -> dict:
    """--fsdp=1 against DDP for one epoch on the same data, draws and init;
    the sharded state; the resume from the FSDP run's checkpoint; one
    --fsdp=1 VQ-VAE epoch."""
    from ddpm_ood_tpu_torch.parallel import fsdp
    from ddpm_ood_tpu_torch.trainers import VQVAETrainer

    out = {}
    os.environ[fsdp.MIN_SIZE_ENV] = "1"  # the tiny model: shard every parameter that divides
    t_d, _ = _trainer(args, model_name="ddp_ref", n_epochs=1)
    out["ddp_loss"] = t_d.train_epoch(0)
    out["ddp_params"] = {k: v.clone() for k, v in t_d.unet.state_dict().items()}
    t_f, _ = _trainer(args, model_name="fsdp", n_epochs=1, fsdp=1, ema_decay=0.9)
    params = list(t_f.unet.parameters())
    out["fsdp_sharded_params"] = sum(map(fsdp.is_sharded, params))
    out["fsdp_replicated_params"] = len(params) - out["fsdp_sharded_params"]
    out["fsdp_sharded_ema"] = sum(map(fsdp.is_sharded, t_f.step.ema.values()))
    out["fsdp_loss"] = t_f.train_epoch(0)
    states = [v for s in t_f.step.optimizer.state.values() for v in s.values()]
    out["fsdp_sharded_opt"] = sum(map(fsdp.is_sharded, states))
    out["fsdp_local_bytes"] = _local_bytes(t_f)
    out["fsdp_shapes"] = [tuple(p.shape) for p in params]
    out["fsdp_params"] = fsdp.full_state_dict(t_f.unet.state_dict())
    t_f.save_checkpoint("checkpoint_1", 0)
    t_r, _ = _trainer(args, model_name="fsdp", n_epochs=2, fsdp=1, ema_decay=0.9)
    out["fsdp_resume_start"] = t_r.start_epoch
    out["fsdp_resumed_params"] = fsdp.full_state_dict(t_r.unet.state_dict())
    out["fsdp_resumed_ema"] = fsdp.full_state_dict(t_r.step.ema)
    out["fsdp_saved_ema"] = fsdp.full_state_dict(t_f.step.ema)
    out["fsdp_resumed_sharded"] = sum(map(fsdp.is_sharded, t_r.unet.parameters()))

    # --fsdp=1 VQ-VAE: G and D sharded, one G + D epoch, its checkpoint
    vq_args = argparse.Namespace(**args["vqvae"])
    vq = VQVAETrainer(vq_args, torch.device("cpu"))
    out["vq_sharded"] = [sum(map(fsdp.is_sharded, m.parameters()))
                         for m in (vq.model, vq.discriminator)]
    vq.train(vq_args)
    out["vq_loss"] = vq.best_loss
    return out


def mode_recon(args: dict, rank: int, world: int) -> dict:
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.trainers import Reconstruct

    a = argparse.Namespace(**args)

    def zero_noise(recon):
        prog = recon._program(a.inference_skip_factor)
        prog.host_noise_fn = lambda shape, t_starts: np.zeros(shape, np.float32)
        return recon

    recon = zero_noise(Reconstruct(a, torch.device("cpu")))
    recon.reconstruct(a)
    ood = recon.out_dir
    pmesh.coordination_barrier("scored")
    merged = {n: (ood / f"results_{n}.csv").read_text() for n in ("val", "in")}
    shards = {n: (ood / f".results_{n}.shard{rank}.csv").read_text() for n in ("val", "in")}
    pmesh.coordination_barrier("read")
    # an interrupted run: each rank's partial holds its shard's first batch
    k = len(recon._program(a.inference_skip_factor).t_starts)
    for name, text in shards.items():
        lines = text.splitlines()
        head = [",".join(line.split(",")[1:]) for line in lines[:1 + k * a.batch_size]]
        (ood / f".results_{name}.shard{rank}.partial.csv").write_text("\n".join(head) + "\n")
        if rank == 0:
            (ood / f"results_{name}.csv").unlink()
    pmesh.coordination_barrier("partials written")
    resumed = zero_noise(Reconstruct(argparse.Namespace(**{**args, "resume": 1}),
                                     torch.device("cpu")))
    resumed.reconstruct(argparse.Namespace(**{**args, "resume": 1}))
    pmesh.coordination_barrier("resumed")
    return {"merged": merged, "shards": shards, "batches": len(resumed.batch_times),
            "resumed": {n: (ood / f"results_{n}.csv").read_text() for n in ("val", "in")},
            "partials_left": sorted(p.name for p in ood.glob("*.partial.csv"))}


def _fake_model(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """tests/test_sweep_multichip.py's ``fake_model`` (elementwise)."""
    return 0.1 * x + 0.01 * (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))


class QuantCalls:
    """Every int8 product's activation absmax in call order, as (this
    rank's max |x|, the absmax the product received): the model module's
    ``qconv_s8`` and ``qdot_s8`` wrapped. With `inputs`, each call's
    channels-last input too."""

    def __init__(self, inputs: bool = False):
        from ddpm_ood_tpu_torch.models import unet

        self.calls, self.inputs = [], [] if inputs else None
        self._orig = (unet.qconv_s8, unet.qdot_s8)

        def wrap(fn):
            def recorded(x, absmax, *a, **k):
                self.calls.append((float(x.float().abs().amax()), float(absmax)))
                if self.inputs is not None:
                    self.inputs.append(x.numpy().copy())
                return fn(x, absmax, *a, **k)
            return recorded

        unet.qconv_s8, unet.qdot_s8 = map(wrap, self._orig)

    def remove(self) -> None:
        from ddpm_ood_tpu_torch.models import unet

        unet.qconv_s8, unet.qdot_s8 = self._orig


TIE_BAND = 1e-3  # code units either side of a .5 tie (tests/test_torch_quant_cli.py)


class TieFeed:
    """``tests/test_torch_quant_cli.py:TieRepair`` for the ranks of a
    sharded call: forward pre-hooks on every quantised site hold this
    rank's input of each call against `want[i]`, its rows of the
    reference's input of that call, whose whole input had the absmax
    `want_absmax[i]`. The codes (each side under its global scale) must be
    equal except within TIE_BAND of a .5 tie (the others are counted in
    ``off_tie``); where any rank's differ, every rank takes its reference
    rows, so the ranks' absmax stays the reference's."""

    def __init__(self, model, want: list, want_absmax: list):
        from ddpm_ood_tpu_torch.models import unet

        self.want, self.want_absmax = want, want_absmax
        self.calls = self.flips = self.fed = self.off_tie = 0
        self.handles = [m.register_forward_pre_hook(self) for m in model.modules()
                        if isinstance(m, (unet.QuantConv, unet.QuantDense))]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def __call__(self, module, args):
        from ddpm_ood_tpu_torch.models import unet
        from ddpm_ood_tpu_torch.ops import quant
        from ddpm_ood_tpu_torch.parallel import mesh as pmesh

        x = args[0]
        mine = unet._to_channels_last_dims(x) if x.dim() > 3 else x
        i, self.calls = self.calls, self.calls + 1
        theirs = torch.as_tensor(self.want[i])
        assert mine.shape == theirs.shape, (i, tuple(mine.shape), tuple(theirs.shape))
        sx = quant.scale_of(pmesh.all_reduce_max_(mine.float().abs().amax()))
        differ = quant._codes(mine, sx) != quant._codes(
            theirs, quant.scale_of(torch.tensor(self.want_absmax[i])))
        if differ.any():
            ratio = (mine.float() / sx).abs()
            near = ((ratio - ratio.floor()) - 0.5).abs() < TIE_BAND
            self.off_tie += int((differ & ~near).sum())
            self.flips += int(differ.sum())
        if not pmesh.any_process(bool(differ.any()), torch.device("cpu")):
            return None
        self.fed += 1
        return (unet._to_channels_first_dims(theirs) if x.dim() > 3 else theirs,)


def _wait_for_file(path: str):
    """The contents of `path`, which the parent test writes while the ranks
    run."""
    import time

    deadline = time.monotonic() + 600
    while not Path(path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def mode_sharded(inp: dict, rank: int, world: int) -> dict:
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.models.unet import make_unet
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram, plms_sweep

    sched = make_schedule(*inp["sched_args"])
    out = {}
    x0 = torch.from_numpy(inp["x0"])
    noise = torch.from_numpy(inp["noise"])
    rows = slice(rank * len(x0) // world, (rank + 1) * len(x0) // world)
    mine = plms_sweep(sched, _fake_model, pmesh.shard_rows(x0), noise[:, rows],
                      torch.as_tensor(inp["ts"]), torch.as_tensor(inp["t_starts"]), 10)
    out["sweep"] = pmesh.all_gather_rows(mine, dim=1)

    def program(model_fn, host, **kw):
        return ReconProgram(sched=sched, model_fn=model_fn, num_inference_steps=10,
                            inference_skip_factor=4, sharded=True,
                            host_noise_fn=lambda shape, t_starts: host, **kw)

    elbo = program(_fake_model, inp["elbo_noise"], score_elbo=True, num_groups=2)
    out["elbo"] = elbo(pmesh.shard_rows(inp["elbo_x0"]), global_batch=len(inp["elbo_x0"]))

    model = make_unet("tiny", 2, 1, 1, quant="int8")
    model.load_state_dict(_wait_for_file(inp["state"]), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    int8 = program(model, inp["int8_noise"], num_groups=1)
    images = pmesh.shard_rows(inp["int8_x0"])
    calls = QuantCalls()
    try:
        out["int8"] = int8(images, global_batch=len(inp["int8_x0"]))
    finally:
        calls.remove()
    out["int8_absmax"] = calls.calls
    # JAX's input of every quantised call, written by the parent once its
    # JAX run is done; this rank's rows of each
    jax_sites, jax_absmax = _wait_for_file(inp["sites"])
    n = len(inp["int8_x0"])
    mine = [x.reshape((-1, n) + x.shape[1:])[:, rows].reshape((-1,) + x.shape[1:])
            for x in jax_sites]
    feed = TieFeed(model, mine, jax_absmax)
    try:
        out["int8_fed"] = int8(images, global_batch=n)
    finally:
        feed.remove()
    out["int8_feed"] = dict(calls=feed.calls, fed=feed.fed, flips=feed.flips,
                            off_tie=feed.off_tie)
    return out


def serve_program(state: dict, quant=None, host_noise=None, sharded: bool = True):
    """The tiny UNet's fp32 scoring program at tests/test_torch_serve.py's
    grid (PLMS 10/3 in 2 lane groups), from `state`; host noise
    ``host_noise(shape)`` when given, else the service's generator."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.models.unet import make_unet
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram

    model = make_unet("tiny", 2, 1, 1, quant=quant)
    model.load_state_dict(state, strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    return ReconProgram(
        sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195), model_fn=model,
        num_inference_steps=10, inference_skip_factor=3, num_groups=2, sharded=sharded,
        host_noise_fn=None if host_noise is None else (lambda shape, t: host_noise(shape)))


def serve_cases(inp: dict, sharded: bool = True):
    """(name, service, calls) of the sharded-service cases: `calls` a list
    of ("score", images), ("bad", images of another shape), ("reload",
    None) and ("sleep", seconds) that rank 0 makes in order. The same cases
    with ``sharded=False`` are the one-process references. A reload hook
    runs on rank 0 only: the other ranks take rank 0's weights."""
    from types import SimpleNamespace

    from ddpm_ood_tpu_torch import serve
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.serve import ScoringService, warmup_program

    keepalive = serve.KEEPALIVE_SECONDS

    def host_noise(shape):
        return np.random.default_rng(5).standard_normal(shape).astype(np.float32)

    def service(batch, quant=None, host=False, warm=False, reload_to=None, **kw):
        program = serve_program(inp["state"], quant, host_noise if host else None, sharded)
        reload_fn = None
        if reload_to is not None:
            def reload_fn():
                assert pmesh.process_index() == 0, "a follower takes rank 0's weights"
                program.model_fn.load_state_dict(reload_to, strict=True)
                return "reloaded"
        svc = ScoringService(program, inp["stats"], batch_size=batch, model_name="t",
                             reload_fn=reload_fn, image_shape=(16, 16, 1),
                             model=program.model_fn, **kw)
        if warm:
            args = SimpleNamespace(image_size=16, spatial_dimension=2, is_grayscale=1)
            assert warmup_program(program, args, batch) >= 0
        return svc

    images = inp["images"]
    yield "host", service(8, host=True), [("score", images[:5])]
    yield "cold", service(8), [("score", images[:8])]
    yield "warm", service(8, warm=True), [("score", images[:8])]
    # batch 5 over 2 ranks is one of 6: in one process, batch 6; an idle
    # spell of several keepalives first, then a request of 2 channels
    serve.KEEPALIVE_SECONDS = 0.1
    yield "odd", service(5 if sharded else 6, host=True), [
        ("sleep", 0.5), ("bad", np.repeat(images[:3], 2, axis=-1)), ("score", images[:3])]
    serve.KEEPALIVE_SECONDS = keepalive
    yield "int8", service(4, quant="int8", reload_to=inp["state2"]), [
        ("score", images[:4]), ("score", images[:1]), ("reload", None), ("score", images[:4])]


def run_serve_case(svc, calls) -> list:
    """The responses of the "score" calls; a "bad" call's ValueError message."""
    import time

    out = []
    for op, arg in calls:
        if op == "score":
            out.append(svc.score(arg))
        elif op == "bad":
            try:
                svc.score(arg)
            except ValueError as e:
                out.append(str(e))
            else:
                raise AssertionError("a request of another image shape was scored")
        elif op == "reload":
            svc.reload()
        else:
            time.sleep(arg)
    return out


def mode_serve(inp: dict, rank: int, world: int) -> dict:
    """Rank 0 makes each case's calls and stops its service; the other
    ranks follow. Rank 0's responses and every rank's counters, int8
    absmaxes (``QuantCalls``) and weights' digest at the end."""
    out = {}
    for name, svc, calls in serve_cases(inp):
        absmax = QuantCalls()
        try:
            if rank == 0:
                out[name] = run_serve_case(svc, calls)
                svc.stop()
            else:
                svc.follow()
        finally:
            absmax.remove()
        out[f"{name}_stats"] = dict(svc.stats, world=svc.world, absmax=absmax.calls,
                                    weights=digest(svc.model.state_dict().values()))
    return out


def mode_recon_quant(inp: dict, rank: int, world: int) -> dict:
    """The scoring CLI (``reconstruct.main``) under ``--quantize=int8``;
    then partial CSVs holding this rank's first ``held[rank]`` batches, and
    the CLI again with ``--resume=1``."""
    from ddpm_ood_tpu_torch import reconstruct
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh

    calls = QuantCalls(inputs=True)
    try:
        recon = reconstruct.main(inp["argv"])
    finally:
        calls.remove()
    # for the parent's reference, while this rank resumes
    tmp = Path(inp["out"]) / f"inputs{rank}.tmp"
    torch.save(calls.inputs, tmp)
    tmp.rename(tmp.with_suffix(".pt"))
    ood, k, b = recon.out_dir, len(recon._programs[inp["skip"]].t_starts), inp["batch"]
    pmesh.coordination_barrier("scored")
    merged = (ood / "results_val.csv").read_text()
    shard = (ood / f".results_val.shard{rank}.csv").read_text()
    pmesh.coordination_barrier("read")
    lines = shard.splitlines()[:1 + k * b * inp["held"][rank]]
    (ood / f".results_val.shard{rank}.partial.csv").write_text(
        "\n".join(",".join(line.split(",")[1:]) for line in lines) + "\n")
    if rank == 0:
        (ood / "results_val.csv").unlink()
    pmesh.coordination_barrier("partials written")
    resumed = reconstruct.main(inp["argv"] + ["--resume=1"])
    pmesh.coordination_barrier("resumed")
    return {"merged": merged, "shard": shard, "batches": len(recon.batch_times),
            "absmax": calls.calls,
            "resumed_batches": len(resumed.batch_times),
            "resumed": (ood / "results_val.csv").read_text(),
            "partials_left": sorted(p.name for p in ood.glob("*.partial.csv"))}


def main() -> None:
    import runpy

    import torch.distributed as dist

    mode, rest = sys.argv[1], sys.argv[2:]
    if mode == "cli":
        clis = json.loads(Path(rest[0]).read_text())
        if len(clis) > 1:
            # torch names a re-made default group as it named the last one,
            # and its store still holds that group's keys: one group serves
            # every CLI of the list, which then leaves it alone
            dist.init_process_group("gloo")
        for module, argv in clis:  # a lone CLI makes and destroys the group itself
            sys.argv = [f"ddpm_ood_tpu_torch.{module}", *argv]
            runpy.run_module(f"ddpm_ood_tpu_torch.{module}", run_name="__main__")
        if dist.is_initialized():
            dist.destroy_process_group()
        return

    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    fns = {"ddpm_step": mode_ddpm_step, "vqvae_step": mode_vqvae_step,
           "trainer": mode_trainer, "fsdp": mode_fsdp, "recon": mode_recon,
           "sharded": mode_sharded, "serve": mode_serve, "recon_quant": mode_recon_quant}
    for i in range(0, len(sys.argv) - 1, 3):  # one group for every (mode, in, out)
        mode, inp_path, out_dir = sys.argv[1 + i], Path(sys.argv[2 + i]), Path(sys.argv[3 + i])
        inp = (json.loads(inp_path.read_text()) if inp_path.suffix == ".json"
               else torch.load(inp_path, weights_only=False))
        out = fns[mode](copy.deepcopy(inp), rank, world)
        torch.save(out, out_dir / f"rank{rank}.pt")
        dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """`nproc` rank processes of this script, started at once from the repo
    root with one intra-op thread each. With ``torchrun`` they are the
    children of ``python -m torch.distributed.run --standalone`` (the real
    launcher, a free port of its own); else they are started directly with
    the rendezvous environment torchrun would give them (a free port)."""

    def __init__(self, mode: str, *args, nproc: int = 2, env=None, torchrun: bool = False):
        import subprocess

        self.what = f"{mode} in {nproc} ranks"
        script = str(Path(__file__).resolve())
        base = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
        if torchrun:
            cmds = [([sys.executable, "-m", "torch.distributed.run", "--standalone",
                      f"--nproc_per_node={nproc}", script, mode, *map(str, args)], base)]
        else:
            rendezvous = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
                          "WORLD_SIZE": str(nproc)}
            cmds = [([sys.executable, script, mode, *map(str, args)],
                     {**base, **rendezvous, "RANK": str(r), "LOCAL_RANK": str(r)})
                    for r in range(nproc)]
        self.procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True,
                                       start_new_session=True, env=e) for cmd, e in cmds]

    def finish(self, timeout: float = 600) -> str:
        """The output once every process has ended. A failure fails the test
        with the output's end; at the timeout every process (and a
        launcher's children) is killed."""
        import signal
        import subprocess
        import time

        deadline, outs = time.monotonic() + timeout, []
        try:
            for proc in self.procs:
                outs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for proc in self.procs:
                os.killpg(proc.pid, signal.SIGKILL)
            raise AssertionError(f"{self.what} timed out after {timeout} s")
        out = "\n".join(outs)
        if any(proc.returncode != 0 for proc in self.procs):
            codes = [proc.returncode for proc in self.procs]
            raise AssertionError(f"{self.what} exited {codes}:\n{out[-8000:]}")
        return out


def start(mode: str, *args, **kw) -> Ranks:
    """Start the ranks and return at once: the caller computes its reference
    while they run, then calls ``finish``."""
    return Ranks(mode, *args, **kw)


def finish(ranks: Ranks, timeout: float = 600) -> str:
    return ranks.finish(timeout)


def launch(mode: str, *args, timeout: float = 600, **kw) -> str:
    """``start`` and ``finish``: the ranks' output."""
    return finish(start(mode, *args, **kw), timeout)


def results(out_dir: Path, nproc: int = 2) -> list:
    return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(nproc)]


if __name__ == "__main__":
    main()
