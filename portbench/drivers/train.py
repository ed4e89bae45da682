"""Training: ``train/ddpm.py:DDPMTrainStep.step(x0, t, noise)`` in a closed
loop on inputs already on the card.

Set-up builds the UNet (``models/unet.py:make_unet``) with the seeded
weights and one ``DDPMTrainStep`` as the training CLI's trainer builds it
(Adam, bf16 autocast on CUDA), makes a pool of distinct batches (images,
uniform t, Gaussian noise) on the device from the seed, and drives that
same step through its first ``checked_steps`` steps on the pool's first
batches: the warm-up, and what the reference follows. It keeps each
step's loss, each leaf's first gradient (Adam's first moment after one
step over 1 - beta1) and, after the last of them, each leaf's change, on
the host.

The window is whole steps, ended by ``torch.cuda.synchronize()``. With
``--trace`` five more steps run under the profiler. Then the step is
freed and the reference takes the same steps from the same weights.

``traffic["fault"]`` plants a fault for the tests and the readings:
"half_batch" steps on the first half of each batch, "frozen" skips every
update; ``traffic["program"]`` naming one of ``ops.CONTROLS`` puts the
reference in that lower precision in the program's place for the
precision control. ``traffic["compute_dtype"]`` "float32" turns the
step's bf16 autocast off: a witness that the program and the reference
agree at a seed, not a configuration that is timed."""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import flops, seeds
from portbench import trace as tracing
from portbench.reference import diffusion as ref_diffusion
from portbench.reference.ops import CONTROLS, FP32, no_tf32
from portbench.reference.train import train_steps

BETA1 = 0.9
PROFILED_STEPS = 5


def _pool(cfg, tr, seed, dev):
    """[(x0 (B, C, *spatial) channels-last, t (B,), noise)] made on `dev`.
    A batch's rows are in the order of their t, so that its two halves hold
    the t under and over the median: the halves' gradients differ, and a
    step that left half the batch out shows in every leaf (``grad_half``).
    The batch's mean, and so the step, is the same in any order."""
    from ddpm_ood_tpu_torch.train.ddpm import channels_last

    b = int(tr["batch_size"])
    gen = torch.Generator(device=dev).manual_seed(seeds.substream(seed, 20))
    out = []
    for i in range(int(tr["pool"])):
        img = seeds.images((b,) + tuple(cfg["image_shape"]), seeds.substream(seed, 21), i)
        x0 = torch.from_numpy(img).to(dev).movedim(-1, 1)
        t = torch.randint(0, 1000, (b,), generator=gen, device=dev)
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        order = torch.argsort(t, stable=True)
        out.append((channels_last(x0[order]), t[order], channels_last(noise[order])))
    return out


def run(r) -> None:
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        _run(r, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _leaf_norms(tensors) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _run(r, work: Path) -> None:
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep

    cfg, tr, dev, seed = r.config, r.traffic, r.device, r.seed
    cuda = dev.type == "cuda"
    dims = len(cfg["image_shape"]) - 1
    channels = int(cfg["image_shape"][-1])
    b, n_checked, lr = int(tr["batch_size"]), int(tr["checked_steps"]), float(tr["learning_rate"])
    fault, control = tr.get("fault"), tr.get("program")
    p0 = seeds.make_weights(flops.unet_shapes(cfg), "unet", seeds.substream(seed, 10), dev)
    pool = _pool(cfg, tr, seed, dev)
    sc = cfg["schedule"]
    sched = make_schedule(sc["beta_schedule"], int(sc["num_train_timesteps"]),
                          float(sc["beta_start"]), float(sc["beta_end"]), sc["prediction_type"],
                          device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = make_unet(cfg["model_type"], dims, channels, channels)
    model.load_state_dict(p0, strict=True)
    model = model.to(dev, memory_format=memory_format(dims)).train()
    autocast = {"bfloat16": torch.bfloat16, "float32": None}[
        tr.get("compute_dtype", cfg["compute_dtype"])]
    step = DDPMTrainStep(model=model, sched=sched, b_scale=float(cfg["b_scale"]),
                         learning_rate=lr, ema_decay=float(tr["ema_decay"]),
                         autocast_dtype=autocast if cuda else None)
    if fault == "frozen":
        step.update = lambda: None
    run_step = step.step
    if fault == "half_batch":
        def run_step(x0, t, noise):
            return step.step(x0[: b // 2], t[: b // 2], noise[: b // 2])

    # the checked steps, through the window's own call and feed
    losses, first, change = [], None, None
    if control is not None:
        acp = ref_diffusion.alphas_cumprod(ref_diffusion.scaled_linear_betas(
            sc["beta_start"], sc["beta_end"], int(sc["num_train_timesteps"]))).to(dev)
        losses, g, p3, _ = train_steps(p0, cfg["unet"], acp, pool[:n_checked], lr,
                                       CONTROLS[control], chunk=int(tr["reference_chunk"]))
        first = {k: v.cpu() for k, v in g.items()}
        change = {k: (p3[k] - p0[k]).cpu() for k in p0}
    else:
        params = dict(model.named_parameters())
        for i in range(n_checked):
            losses.append(float(run_step(*pool[i])))
            if i == 0:
                first = {k: (step.optimizer.state[p]["exp_avg"] / (1 - BETA1)).cpu()
                         if p in step.optimizer.state else torch.zeros(p.shape)
                         for k, p in params.items()}
        change = {k: (params[k].detach() - p0[k]).cpu() for k in p0}
    p0_cpu = {k: v.cpu() for k, v in p0.items()}
    del p0
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the window
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    r.setup_s = time.perf_counter() - r.t0
    t_start, n, loss = time.perf_counter(), 0, None
    while time.perf_counter() - t_start < r.seconds:
        loss = run_step(*pool[(n_checked + n) % len(pool)])
        n += 1
    if cuda:
        torch.cuda.synchronize(dev)
    r.window = {"seconds": time.perf_counter() - t_start, "steps": n, "items": n * b}
    r.attempted = n
    r.failed = int(loss is not None and not bool(torch.isfinite(loss)))
    if cuda:
        r.peak_window_bytes = torch.cuda.max_memory_allocated(dev)
        r.peak_bytes = max(setup_peak, r.peak_window_bytes)
    r.flops["window"] = flops.unet_train_flops(cfg) * n * b

    if r.trace:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        prof.start()
        for i in range(PROFILED_STEPS):
            run_step(*pool[(n_checked + n + i) % len(pool)])
        if cuda:
            torch.cuda.synchronize(dev)
        r.traced_s = time.perf_counter() - t1
        r.counts["traced_steps"] = PROFILED_STEPS
        prof.stop()
        path = work / "trace.json"
        prof.export_chrome_trace(str(path))
        r.traced = tracing.Trace.load(path)
        path.unlink()
    del step, model, run_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _check(r, p0_cpu, pool[:n_checked], losses, first, change)


def _check(r, p0, batches, losses, first, change) -> None:
    """The checked steps against the reference's. Printed: the largest gap
    of a step's loss (over the reference's); by the worst leaf the gap of
    the first gradient's norm and of the change's norm, each over the larger
    of the reference's norm of that leaf and of the median leaf. Also, by
    the median leaf, the norm of the difference of the first gradient and of
    the change, over the same. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the change. The three worst leaves of each, by gap and by
    difference, go to stderr.

    ``grad_half`` sees every row of the first step: with the reference's
    gradients hA and hB over the batch's two halves (its rows are in the
    order of t; the batch's gradient is the halves' mean), each moved leaf's first-gradient difference e is projected on
    d = hA - hB, 2 <e, d> / <d, d>: 0 for a gradient over the whole batch,
    +1 or -1 for one over a half alone. Printed: the median leaf's
    magnitude."""
    cfg, tr = r.config, r.traffic
    no_tf32()
    sc = cfg["schedule"]
    acp = ref_diffusion.alphas_cumprod(ref_diffusion.scaled_linear_betas(
        sc["beta_start"], sc["beta_end"], int(sc["num_train_timesteps"]))).to(r.device)
    p0 = {k: v.to(r.device) for k, v in p0.items()}
    ref_losses, g, p3, halves = train_steps(p0, cfg["unet"], acp, batches,
                                            float(tr["learning_rate"]), FP32,
                                            chunk=int(tr["reference_chunk"]))
    ref_first = {k: v.cpu() for k, v in g.items()}
    halves = [{k: v.cpu() for k, v in h.items()} for h in halves]
    ref_change = {k: (p3[k] - p0[k]).cpu() for k in p0}
    g_norm, c_norm = _leaf_norms(ref_first), _leaf_norms(ref_change)
    g_med = float(np.median(list(g_norm.values())))
    moved = [k for k in g_norm if g_norm[k] >= 1e-3 * g_med]

    def per_leaf(got, want, norms, keep, diff):
        med = float(np.median([norms[k] for k in keep]))
        num = (_leaf_norms({k: got[k] - want[k] for k in keep}) if diff else
               {k: abs(float(got[k].double().norm()) - norms[k]) for k in keep})
        return {k: num[k] / max(norms[k], med, 1e-30) for k in keep}

    numbers = {"loss": max(abs(a - w) / abs(w) for a, w in zip(losses, ref_losses))}
    for name, got, want, norms, keep in (("grad", first, ref_first, g_norm, list(g_norm)),
                                         ("change", change, ref_change, c_norm, moved)):
        gap = per_leaf(got, want, norms, keep, diff=False)
        diff = per_leaf(got, want, norms, keep, diff=True)
        numbers[name] = max(gap.values())
        numbers[f"{name}_diff"] = float(np.median(list(diff.values())))
        for k in sorted(gap, key=gap.get)[-3:] + sorted(diff, key=diff.get)[-3:]:
            print(f"leaf {name} {k} gap {gap[k]:.3e} difference {diff[k]:.3e} "
                  f"reference norm {norms[k]:.3e}", file=sys.stderr)
    share = {}
    for k in moved:
        d = (halves[0][k] - halves[1][k]).double().flatten()
        e = (first[k] - ref_first[k]).double().flatten()
        share[k] = float(2 * (e @ d) / max(float(d @ d), 1e-300))
    numbers["grad_half"] = float(np.median(np.abs(list(share.values()))))
    r.judge(numbers)
