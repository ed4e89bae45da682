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
           "trainer": mode_trainer, "fsdp": mode_fsdp, "recon": mode_recon}
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
