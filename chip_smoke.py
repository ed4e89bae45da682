#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # from the repo root; needs one CUDA card

Phases, each fatal on failure:
  1. device   -- a CUDA card is required (there is no CPU fallback); prints the
                 torch version and the card's name and power limit.
  2. build    -- compiles ddpm_ood_tpu_torch/csrc/*.cu with nvcc.
  3. kernels  -- every kernel (GroupNorm, flash forward, flash backward dK/dV
                 and dQ) against its plain PyTorch version at the main paths'
                 shapes, with the tolerance stated; each timed with CUDA events
                 beside its plain version, one PyTorch library call computing
                 the same function, and its bound.
  4. forward  -- the full-width small UNet through the kernels on the card
                 against the same weights through the plain versions on the CPU.
  5. step     -- one fp32 training step of the same UNet (loss and every
                 parameter gradient), card against CPU.
  6. main     -- writes a synthetic 32x32 grayscale set and a seeded
                 reference-schema checkpoint.pth, then runs the scoring CLI
                 (ddpm_ood_tpu_torch.reconstruct) in this process: small UNet,
                 100-step PLMS, skip factor 4, batch 32. Checks the result CSVs
                 and that every UNet forward went through both forward kernels.
  7. train    -- runs the training CLI (ddpm_ood_tpu_torch.train_ddpm) in this
                 process on a synthetic 32x32 set: small UNet, batch 128, 2
                 epochs of 4 steps, validation with a 1000-step sample grid.
                 Checks that the loss is finite and falls, the checkpoints'
                 schema, the launch counts of all four kernels, and that the
                 scoring CLI loads the trained checkpoint.pth.

Launch counts are set to 0 just before each of the two CLI runs and read just
after. The line before the last is a JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}. The script imports no JAX.
"""

from __future__ import annotations

import csv
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# max-abs-error tolerances against the plain versions, by dtype. f32: the two
# sum in different orders (groupnorm at 2e-5, attention forward and backward
# at 1e-4 over a 256-long dot and a softmax, tests/test_attention.py). bf16:
# both compute in fp32 from the same bf16 inputs and round once, so they
# differ by at most one bf16 ulp of the output; the inputs keep |y| < 4, where
# that ulp is 2^-6 = 0.0156 < 2e-2. Attention in bf16 also rounds the
# probabilities to bf16 in the plain forward only.
GN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GN_SHAPES = [(1024, 128), (1024, 256), (1024, 384), (256, 128), (256, 256),
             (256, 384), (256, 512), (64, 256), (64, 512)]
# (B*H, N, D): scoring's K*B = 64, training's batch of 128, and a ragged N
ATTN_SHAPES = [(64, 64, 256), (128, 64, 256), (4, 1000, 64)]
ATTN_SUMMARY = (128, 64, 256, torch.bfloat16)  # the training path's shape


CARD = "not read"  # nvidia-smi's name and power limit, set by phase_device


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int = 20, reps: int = 7) -> float:
    """Median milliseconds per call over `reps` runs of `iters` warm calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "ddpm_ood_tpu_torch" / "csrc").is_dir():
        raise PhaseError(f"no ddpm_ood_tpu_torch/csrc beside {Path(__file__).name}: "
                         "run it from the root of a checkout of the repo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise PhaseError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log("card (nvidia-smi name, power.limit):")
    log(CARD)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from ddpm_ood_tpu_torch.ops import _kernels

    secs = _kernels.build(force=True)
    _kernels.library()
    log(f"build: nvcc {secs:.2f} s -> {_kernels.LIB_PATH.relative_to(ROOT)}")
    for line in _kernels.BUILD_LOG.read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


# card peaks for bound_ms (NVIDIA's H100 SXM data sheet, dense): device memory
# 3.35 TB/s; 989 TFLOP/s on bf16 tensor cores, 67 TFLOP/s in fp32
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for the inputs' type, whichever is larger."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _check(name: str, err: float, tol: float, what: str) -> None:
    if not (math.isfinite(err) and err <= tol):
        raise PhaseError(f"{name} disagrees with its plain version at {what}: {err} > {tol}")


def phase_kernels(dev: torch.device) -> dict:
    import torch.nn.functional as F

    from ddpm_ood_tpu_torch.ops.attention import (
        einsum_attention, einsum_logsumexp, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_reference, flash_attention_fwd,
    )
    from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act, groupnorm_act_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in GN_SHAPES:
            x = (torch.rand((64, n, c), generator=gen, device=dev) * 2 - 1).to(dtype)
            gamma = torch.rand((c,), generator=gen, device=dev) + 0.5
            beta = torch.rand((c,), generator=gen, device=dev) - 0.5
            for act in ("none", "silu"):
                got = groupnorm_act(x, gamma, beta, 32, 1e-6, act)
                ref = groupnorm_act_reference(x, gamma, beta, 32, 1e-6, act)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                ms = time_cuda(lambda: groupnorm_act(x, gamma, beta, 32, 1e-6, act))
                plain = time_cuda(lambda: groupnorm_act_reference(x, gamma, beta, 32, 1e-6, act))
                lib = None
                if act == "none":  # F.group_norm on the same memory: a channels_last
                    side = math.isqrt(n)  # (B, C, H, W) view of (B, H*W, C)
                    x4 = x.reshape(64, side, side, c).permute(0, 3, 1, 2)
                    g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
                    lib = time_cuda(lambda: F.group_norm(x4, 32, g_lib, b_lib, 1e-6))
                log(f"groupnorm B=64 N={n} C={c} G=32 {act:4s} {str(dtype)[6:]:8s} "
                    f"max_abs_err={err:.3e} tol={GN_TOL[dtype]:.0e} kernel={ms:.4f} ms "
                    f"plain={plain:.4f} ms library="
                    + (f"{lib:.4f} ms" if lib is not None else "-")
                    + f" {'ok' if err <= GN_TOL[dtype] else 'FAIL'}")
                _check("groupnorm", err, GN_TOL[dtype], f"N={n} C={c} {act} {dtype}")
                worst = max(worst, err)
                if (n, c, act, dtype) == (1024, 384, "none", torch.bfloat16):
                    summary["groupnorm_act"] = {
                        "ms": ms, "plain_ms": plain, "library_ms": lib,
                        **bound(2 * x.numel() * x.element_size() + 2 * c * 4,
                                8 * x.numel(), dtype)}
    summary["groupnorm_act"]["max_abs_err"] = worst

    worst = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dkv": 0.0,
             "flash_attention_bwd_dq": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n, d in ATTN_SHAPES:
            # std 0.5 keeps every gradient under 4, where one bf16 ulp is 2^-6
            q, k, v, do = (0.5 * torch.randn((bh, 1, n, d), generator=gen, device=dev)
                           for _ in range(4))
            q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
            scale = 1.0 / math.sqrt(d)
            elems, s = q.numel(), q.element_size()
            what = f"BH={bh} N={n} D={d} {str(dtype)[6:]}"

            got, lse = flash_attention_fwd(q, k, v, scale)
            ref = einsum_attention(q, k, v, scale)
            ref_lse = einsum_logsumexp(q, k, scale)
            torch.cuda.synchronize()
            err = max((got.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            _check("flash_attention_fwd", err, ATTN_TOL[dtype], what)
            fwd = {"ms": time_cuda(lambda: flash_attention_fwd(q, k, v, scale)),
                   "plain_ms": time_cuda(lambda: einsum_attention(q, k, v, scale)),
                   "library_ms": time_cuda(
                       lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                   **bound(4 * elems * s + bh * n * 4, 4.0 * bh * n * n * d, dtype)}

            # the backward kernels on the forward kernel's own O and lse
            delta = (do.float() * got.float()).sum(-1).reshape(bh, n).contiguous()
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
            rdq, rdk, rdv = flash_attention_bwd_reference(q, k, v, got, lse, do, scale)
            torch.cuda.synchronize()
            e_dkv = max((dk.float() - rdk.float()).abs().max().item(),
                        (dv.float() - rdv.float()).abs().max().item())
            e_dq = (dq.float() - rdq.float()).abs().max().item()
            mag = max(t.float().abs().max().item() for t in (rdq, rdk, rdv))
            _check("flash_attention_bwd_dkv", e_dkv, ATTN_TOL[dtype], what)
            _check("flash_attention_bwd_dq", e_dq, ATTN_TOL[dtype], what)
            if dtype == torch.float32:  # a second, independent yardstick: autograd
                qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
                auto = torch.autograd.grad(einsum_attention(qa, ka, va, scale), (qa, ka, va), do)
                e_auto = max((a - b).abs().max().item() for a, b in zip(auto, (dq, dk, dv)))
                log(f"  {what}: backward kernels vs autograd of the einsum composition "
                    f"max_abs_err={e_auto:.3e} tol={ATTN_TOL[dtype]:.0e}")
                _check("flash attention backward (vs autograd)", e_auto, ATTN_TOL[dtype], what)
            plain_bwd = time_cuda(
                lambda: flash_attention_bwd_reference(q, k, v, got, lse, do, scale))
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            out_lib = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            lib_bwd = time_cuda(lambda: torch.autograd.grad(out_lib, (ql, kl, vl), do,
                                                            retain_graph=True))
            io = 4 * elems * s + 2 * bh * n * 4  # q, k, v, dO read; lse, delta read
            dkv = {"ms": time_cuda(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                   scale)),
                   "plain_ms": plain_bwd, "library_ms": lib_bwd,
                   **bound(io + 2 * elems * s, 8.0 * bh * n * n * d, dtype)}
            dqt = {"ms": time_cuda(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                                  scale)),
                   "plain_ms": plain_bwd, "library_ms": lib_bwd,
                   **bound(io + elems * s, 6.0 * bh * n * n * d, dtype)}
            for name, row, e in (("flash_attention_fwd", fwd, err),
                                 ("flash_attention_bwd_dkv", dkv, e_dkv),
                                 ("flash_attention_bwd_dq", dqt, e_dq)):
                log(f"{name} {what} max_abs_err={e:.3e} tol={ATTN_TOL[dtype]:.0e} "
                    f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
                    f"library={row['library_ms']:.4f} ms bound={row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}) ok")
                worst[name] = max(worst[name], e)
                if (bh, n, d, dtype) == ATTN_SUMMARY:
                    summary[name] = row
            log(f"  max |grad| of the plain version {mag:.3f}")
    for name, e in worst.items():
        summary[name]["max_abs_err"] = e
    return summary


KERNELS = {
    "groupnorm_act": ("ddpm_ood_tpu_torch/csrc/groupnorm.cu", "ddpm_ood_tpu/ops/groupnorm.py:58"),
    "flash_attention_fwd": ("ddpm_ood_tpu_torch/csrc/attention.cu",
                            "ddpm_ood_tpu/ops/attention.py:51"),
    "flash_attention_bwd_dkv": ("ddpm_ood_tpu_torch/csrc/attention_bwd.cu",
                                "ddpm_ood_tpu/ops/attention.py:138"),
    "flash_attention_bwd_dq": ("ddpm_ood_tpu_torch/csrc/attention_bwd.cu",
                               "ddpm_ood_tpu/ops/attention.py:181"),
}
# the main path: small UNet, 32x32x1, 100-step PLMS, skip factor 4, batch 32
MAIN_ARGS = ["--model_type=small", "--image_size=32", "--is_grayscale=1",
             "--num_inference_steps=100", "--inference_skip_factor=4", "--batch_size=32",
             "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195"]
N_IMAGES = 32
GN_PER_FORWARD, ATTN_PER_FORWARD = 27, 4  # small UNet: 11 res blocks x 2 + 4 attn + out
FWD_TOL = 1e-3  # fp32 UNet / sweep, card vs CPU, relative to the output's scale


def seeded_small_unet(seed: int):
    from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_

    return random_init_(make_unet("small", 2, 1, 1), torch.Generator().manual_seed(seed))


def phase_forward(dev: torch.device) -> None:
    """fp32 small UNet and a short sweep: kernels on the card vs plain on the CPU."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram

    cpu = seeded_small_unet(1).to(memory_format=torch.channels_last).eval()
    gpu = seeded_small_unet(1).to(dev, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 1, 32, 32), dtype=np.float32))
    t = torch.tensor([0, 10, 500, 990])
    with torch.no_grad():
        ref = cpu(x.to(memory_format=torch.channels_last), t)
        got = gpu(x.to(dev, memory_format=torch.channels_last), t.to(dev)).cpu()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got16 = gpu(x.to(dev, memory_format=torch.channels_last), t.to(dev)).cpu()
    scale = max(1.0, ref.abs().max().item())
    err = (got - ref).abs().max().item() / scale
    err16 = (got16 - ref).abs().max().item() / scale
    log(f"forward: small UNet fp32 card vs CPU rel_err={err:.3e} tol={FWD_TOL:.0e}; "
        f"bf16 autocast vs CPU fp32 rel_err={err16:.3e} (reported, not held)")
    if not (math.isfinite(err) and err <= FWD_TOL and math.isfinite(err16)):
        raise PhaseError(f"UNet forward on the card disagrees with the CPU: {err}")

    images = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    noise = rng.standard_normal((4, 2, 32, 32, 1)).astype(np.float32)
    mse = {}
    for name, device, model in (("cpu", torch.device("cpu"), cpu), ("cuda", dev, gpu)):
        prog = ReconProgram(
            sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device),
            model_fn=model, device=device, num_inference_steps=10, inference_skip_factor=3,
            num_groups=2, host_noise_fn=lambda shape, ts: noise,
        )
        mse[name] = prog(images)[1].cpu()
    err = ((mse["cuda"] - mse["cpu"]).abs() / mse["cpu"].abs().clamp_min(1e-6)).max().item()
    log(f"sweep: (K, B) = {tuple(mse['cpu'].shape)} MSE table fp32 card vs CPU "
        f"max_rel_err={err:.3e} tol={FWD_TOL:.0e}")
    if not (math.isfinite(err) and err <= FWD_TOL):
        raise PhaseError(f"sweep MSE on the card disagrees with the CPU: {err}")


def _write_split(root: Path, name: str, n: int, ood: bool, rng) -> Path:
    """n 32x32 grayscale .npy images and their single-row split CSV: smooth
    sine fields (in-distribution) or checkerboards (OOD)."""
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    d = root / name
    d.mkdir(parents=True)
    paths = []
    for i in range(n):
        if ood:
            img = ((xx + yy + i) % 2).astype(np.float32)[None]
        else:
            phase = rng.uniform(0, 2 * np.pi)
            img = (0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) / 32 + phase)).astype(np.float32)[None]
        paths.append(str(d / f"{name}_{i}.npy"))
        np.save(paths[-1], img)
    (root / f"{name}.csv").write_text(",".join(paths))
    return root / f"{name}.csv"


def _write_dataset(root: Path) -> dict:
    rng = np.random.default_rng(0)
    return {name: _write_split(root, name, N_IMAGES, ood, rng)
            for name, ood in (("val", False), ("in", False), ("checkerboard_test", True))}


def _check_csv(path: Path, t_starts) -> None:
    if not path.is_file():
        raise PhaseError(f"missing results CSV {path.name}")
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    per_image = {}
    for r in rows:
        mse = float(r["mse"])
        if not math.isfinite(mse):
            raise PhaseError(f"{path.name}: non-finite mse in {r}")
        per_image.setdefault(r["filename"], []).append(int(r["t"]))
    if len(per_image) != N_IMAGES or any(sorted(v) != sorted(t_starts) for v in per_image.values()):
        raise PhaseError(f"{path.name}: expected {N_IMAGES} images x {len(t_starts)} start points, "
                         f"got {len(rows)} rows over {len(per_image)} images")
    log(f"  {path.name}: {len(rows)} rows, {len(t_starts)} per image, all mse finite")


def phase_main(dev: torch.device) -> dict:
    from ddpm_ood_tpu_torch import reconstruct as cli
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        csvs = _write_dataset(root)
        run = root / "output" / "smoke_fashionmnist"
        run.mkdir(parents=True)
        save_checkpoint(run / "checkpoint.pth", seeded_small_unet(0).state_dict())
        argv = [f"--output_dir={root / 'output'}", "--model_name=smoke_fashionmnist",
                f"--validation_ids={csvs['val']}", f"--in_ids={csvs['in']}",
                f"--out_ids={csvs['checkerboard_test']}", "--device=cuda", *MAIN_ARGS]
        log("main: python -m ddpm_ood_tpu_torch.reconstruct " + " ".join(argv))
        reset_launches()
        t0 = time.perf_counter()
        recon = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()

        ts = pndm_timesteps(1000, 100)
        t_starts = pndm_start_points(ts, 4)
        per_batch = sum(len(s) for s, _ in group_t_starts(ts, t_starts, 16))
        expected = per_batch * 3  # val, in, out: one batch of 32 each
        evals = sum(p.model_evals for p in recon._programs.values())
        log(f"main: {evals} UNet forwards (expected {expected}); launches {launches}")
        if evals != expected:
            raise PhaseError(f"sweep made {evals} UNet forwards, expected {expected}")
        if launches["groupnorm_act"] != GN_PER_FORWARD * evals:
            raise PhaseError(f"groupnorm launches {launches['groupnorm_act']} != "
                             f"{GN_PER_FORWARD} x {evals}")
        if launches["flash_attention_fwd"] != ATTN_PER_FORWARD * evals:
            raise PhaseError(f"attention launches {launches['flash_attention_fwd']} != "
                             f"{ATTN_PER_FORWARD} x {evals}")
        if launches["flash_attention_bwd_dkv"] or launches["flash_attention_bwd_dq"]:
            raise PhaseError(f"scoring launched a backward kernel: {launches}")
        for name in ("val", "in", "checkerboard"):
            _check_csv(recon.out_dir / f"results_{name}.csv", t_starts)

    n_all = sum(n for n, _ in recon.batch_times)
    s_all = sum(s for _, s in recon.batch_times)
    n_warm = sum(n for n, _ in recon.batch_times[1:])
    s_warm = sum(s for _, s in recon.batch_times[1:])
    log(f"main: batches (recons, s) = {[(n, round(s, 3)) for n, s in recon.batch_times]}")
    log(f"main: {n_all / s_all:.2f} recons/s over all {len(recon.batch_times)} batches; "
        f"{n_warm / s_warm:.2f} recons/s over batches 2-{len(recon.batch_times)}; "
        f"CLI wall {wall:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches

# the training path: small UNet at full width, 32x32x1, batch 128, 2 epochs
TRAIN_BATCH, TRAIN_STEPS_PER_EPOCH = 128, 4
TRAIN_ARGS = ["--model_type=small", "--image_size=32", "--is_grayscale=1",
              f"--batch_size={TRAIN_BATCH}", "--n_epochs=2", "--eval_freq=2",
              "--checkpoint_every=2", "--learning_rate=2e-4", "--num_workers=4",
              "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195"]
REFERENCE_SCHEMA = {"epoch", "global_step", "model_state_dict", "optimizer_state_dict",
                    "best_loss"}
GRAD_TOL = 1e-3  # fp32 gradients, card vs CPU, relative to each tensor's largest
SHIFT_FREE_GRAD = "to_k.bias"  # held to |g| <= 1e-5 x the largest gradient instead


def _launch_counters():
    from ddpm_ood_tpu_torch.ops.attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    )
    from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act

    return {"groupnorm_act": groupnorm_act, "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq}


def reset_launches() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def phase_train_step(dev: torch.device) -> None:
    """One fp32 training step's loss and gradients: the full-width small UNet
    through the kernels on the card against the plain versions on the CPU."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep

    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.uniform(size=(4, 1, 32, 32)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((4, 1, 32, 32)).astype(np.float32))
    t = torch.tensor([3, 250, 600, 999])
    out = {}
    for device in (torch.device("cpu"), dev):
        model = seeded_small_unet(2).to(device, memory_format=torch.channels_last)
        step = DDPMTrainStep(model=model, sched=make_schedule(
            "scaled_linear_beta", 1000, 0.0015, 0.0195, device=device))
        reset_launches()
        loss = step.grads(x0.to(device), noise.to(device), t.to(device))
        out[device.type] = (loss.item(), {n: None if p.grad is None else p.grad.cpu()
                                          for n, p in model.named_parameters()})
        counts = read_launches()
    want = {"groupnorm_act": GN_PER_FORWARD, "flash_attention_fwd": ATTN_PER_FORWARD,
            "flash_attention_bwd_dkv": ATTN_PER_FORWARD,
            "flash_attention_bwd_dq": ATTN_PER_FORWARD}
    if counts != want:
        raise PhaseError(f"one training step launched {counts}, expected {want}")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    missing = [n for n in g_cpu if g_cpu[n] is None or g_gpu[n] is None]
    if missing:
        raise PhaseError(f"no gradient for {missing}")
    scale = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name, shift_free = 0.0, "", 0.0
    for name, ref in g_cpu.items():
        got = g_gpu[name]
        if name.endswith(SHIFT_FREE_GRAD):
            # softmax ignores a per-query constant, so the key bias's gradient
            # is 0 in exact arithmetic and rounding noise on both devices
            shift_free = max(shift_free, got.abs().max().item(), ref.abs().max().item())
            continue
        if got.abs().max().item() == 0.0:
            raise PhaseError(f"gradient of {name} is all zero on the card")
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    log(f"train step: fp32 card vs CPU loss {l_gpu:.6f} vs {l_cpu:.6f} rel_err={loss_err:.3e}; "
        f"{len(g_cpu)} gradients, worst rel_err={worst:.3e} ({worst_name}) tol={GRAD_TOL:.0e}; "
        f"key-bias gradients (0 in exact arithmetic) at most {shift_free:.3e} against a "
        f"largest gradient of {scale:.3e}; launches {counts}")
    if not (loss_err <= GRAD_TOL and math.isfinite(worst) and worst <= GRAD_TOL
            and shift_free <= 1e-5 * scale):
        raise PhaseError(f"training step on the card disagrees with the CPU: loss {loss_err}, "
                         f"gradient {worst_name} {worst}, key bias {shift_free}")


def _check_checkpoint(path: Path, epoch: int, images: int, steps: int) -> dict:
    if not path.is_file():
        raise PhaseError(f"missing checkpoint {path.name}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if set(payload) != REFERENCE_SCHEMA:
        raise PhaseError(f"{path.name} keys {sorted(payload)} != {sorted(REFERENCE_SCHEMA)}")
    opt_steps = {int(s["step"]) for s in payload["optimizer_state_dict"]["state"].values()}
    if (payload["epoch"], payload["global_step"], opt_steps) != (epoch, images, {steps}):
        raise PhaseError(f"{path.name}: epoch {payload['epoch']}, global_step "
                         f"{payload['global_step']}, Adam steps {opt_steps}; expected "
                         f"{epoch}, {images}, {{{steps}}}")
    log(f"  {path.name}: reference schema, epoch {epoch}, global_step {images}, "
        f"best_loss {payload['best_loss']:.6f}")
    return payload


def phase_train(dev: torch.device) -> dict:
    """The training CLI in this process at full width; then the scoring CLI
    on the checkpoint it wrote."""
    from ddpm_ood_tpu_torch import reconstruct as score_cli
    from ddpm_ood_tpu_torch import train_ddpm

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(1)
        train_csv = _write_split(root, "train", TRAIN_BATCH * TRAIN_STEPS_PER_EPOCH, False, rng)
        val_csv = _write_split(root, "val", TRAIN_BATCH, False, rng)
        out_csv = _write_split(root, "checkerboard_test", 8, True, rng)
        argv = [f"--output_dir={root / 'output'}", "--model_name=smoke_fashionmnist",
                f"--training_ids={train_csv}", f"--validation_ids={val_csv}", "--device=cuda",
                *TRAIN_ARGS]
        log("train: python -m ddpm_ood_tpu_torch.train_ddpm " + " ".join(argv))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_ddpm.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30

        steps = 2 * TRAIN_STEPS_PER_EPOCH
        forwards = trainer.step.forwards + trainer.sample_forwards
        want = {"groupnorm_act": GN_PER_FORWARD * forwards,
                "flash_attention_fwd": ATTN_PER_FORWARD * forwards,
                "flash_attention_bwd_dkv": ATTN_PER_FORWARD * trainer.step.backwards,
                "flash_attention_bwd_dq": ATTN_PER_FORWARD * trainer.step.backwards}
        log(f"train: {trainer.step.backwards} training steps, {trainer.step.forwards} train/eval "
            f"UNet forwards + {trainer.sample_forwards} sampler forwards; launches {launches}")
        if trainer.step.backwards != steps or trainer.sample_forwards != 1000:
            raise PhaseError(f"expected {steps} steps and 1000 sampler forwards")
        if launches != want:
            raise PhaseError(f"launches {launches} != expected {want}")

        losses = [json.loads(line)["value"] for line in
                  (trainer.run_dir / "train" / "scalars.jsonl").read_text().splitlines()]
        first, second = (statistics.mean(losses[i:i + TRAIN_STEPS_PER_EPOCH])
                         for i in (0, TRAIN_STEPS_PER_EPOCH))
        log(f"train: per-step losses {[round(v, 5) for v in losses]}; epoch means "
            f"{first:.5f} -> {second:.5f}")
        if len(losses) != steps or not all(map(math.isfinite, losses)) or not second < first:
            raise PhaseError(f"training loss is not finite and falling: {losses}")
        best = _check_checkpoint(trainer.run_dir / "checkpoint.pth", 2, TRAIN_BATCH * steps,
                                 steps)
        _check_checkpoint(trainer.run_dir / "checkpoint_2.pth", 2, TRAIN_BATCH * steps, steps)
        grid = np.load(trainer.run_dir / "val" / f"samples_{TRAIN_BATCH * steps}.npy")
        num = min(8, TRAIN_BATCH)
        if grid.shape != (num, 32, 32, 1) or not np.isfinite(grid).all():
            raise PhaseError(f"sample grid {grid.shape} is not {num} finite 32x32x1 images")

        (n0, s0), (n1, s1) = trainer.epoch_times
        log(f"train: {n0 / s0:.1f} images/s in epoch 1 (first steps included), "
            f"{n1 / s1:.1f} images/s in epoch 2; CLI wall {wall:.1f} s; peak device memory "
            f"{peak:.2f} GiB; card {CARD}")

        recon = score_cli.main([
            f"--output_dir={root / 'output'}", "--model_name=smoke_fashionmnist",
            f"--validation_ids={val_csv}", f"--in_ids={val_csv}", f"--out_ids={out_csv}",
            "--device=cuda", "--first_n_val=8", "--first_n=8", "--batch_size=8",
            "--num_inference_steps=10", "--inference_skip_factor=5", *MAIN_ARGS[:3],
            *MAIN_ARGS[6:]])
        loaded = recon.unet.state_dict()
        if any(not torch.equal(loaded[k].cpu(), v) for k, v in best["model_state_dict"].items()):
            raise PhaseError("the scoring CLI's weights differ from the trained checkpoint.pth")
        for name in ("val", "in", "checkerboard"):
            path = recon.out_dir / f"results_{name}.csv"
            if not path.is_file():
                raise PhaseError(f"the scoring CLI wrote no {path.name}")
        log("train: the scoring CLI loaded the trained checkpoint.pth and wrote its CSVs")
    return launches


def main() -> int:
    t0 = time.perf_counter()
    try:
        device = phase_device()
        dev = torch.device("cuda", 0)
        phase_build()
        summary = phase_kernels(dev)
        phase_forward(dev)
        phase_train_step(dev)
        score = phase_main(dev)
        train = phase_train(dev)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, (src, tpu) in KERNELS.items():
        by_path = {"score": score.get(name, 0), "train": train[name]}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": tpu,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        **summary[name]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
