#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # from the repo root; needs one CUDA card

Phases, each fatal on failure:
  1. device   -- a CUDA card is required (there is no CPU fallback); prints the
                 torch version and the card's name and power limit.
  2. build    -- compiles ddpm_ood_tpu_torch/csrc/*.cu with nvcc.
  3. kernels  -- every kernel of the scoring path against its plain PyTorch
                 version at the main path's shapes, with the tolerance stated,
                 and both timed with CUDA events.
  4. forward  -- the full-width small UNet through the kernels on the card
                 against the same weights through the plain versions on the CPU.
  5. main     -- writes a synthetic 32x32 grayscale set and a seeded
                 reference-schema checkpoint.pth, then runs the scoring CLI
                 (ddpm_ood_tpu_torch.reconstruct) in this process: small UNet,
                 100-step PLMS, skip factor 4, batch 32. Checks the result CSVs
                 and that every UNet forward went through both kernels.

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. The script imports no JAX.
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
# sum in different orders (groupnorm at 2e-5, attention at 1e-4 over a
# 256-long dot and a softmax). bf16: both compute in fp32 from the same bf16
# inputs and round once, so they differ by at most one bf16 ulp of the output;
# the inputs keep |y| < 4, where that ulp is 2^-6 = 0.0156 < 2e-2. Attention in
# bf16 also rounds the probabilities to bf16 in the plain version only.
GN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GN_SHAPES = [(1024, 128), (1024, 256), (1024, 384), (256, 128), (256, 256),
             (256, 384), (256, 512), (64, 256), (64, 512)]
ATTN_SHAPES = [(64, 64, 256), (4, 1000, 64)]  # (B*H, N, D); the second is ragged


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
    log("card (nvidia-smi name, power.limit):")
    log(smi.stdout.strip().splitlines()[0])
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from ddpm_ood_tpu_torch.ops import _kernels

    secs = _kernels.build(force=True)
    _kernels.library()
    log(f"build: nvcc {secs:.2f} s -> {_kernels.LIB_PATH.relative_to(ROOT)}")
    for line in _kernels.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "bytes stack" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(dev: torch.device) -> dict:
    from ddpm_ood_tpu_torch.ops.attention import (
        einsum_attention, einsum_logsumexp, flash_attention_fwd,
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
                ok = math.isfinite(err) and err <= GN_TOL[dtype]
                ms = time_cuda(lambda: groupnorm_act(x, gamma, beta, 32, 1e-6, act))
                plain = time_cuda(lambda: groupnorm_act_reference(x, gamma, beta, 32, 1e-6, act))
                log(f"groupnorm B=64 N={n} C={c} G=32 {act:4s} {str(dtype)[6:]:8s} "
                    f"max_abs_err={err:.3e} tol={GN_TOL[dtype]:.0e} "
                    f"kernel={ms:.4f} ms plain={plain:.4f} ms {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseError(f"groupnorm disagrees at N={n} C={c} {act} {dtype}: {err}")
                worst = max(worst, err)
                if (n, c, act, dtype) == (1024, 384, "silu", torch.bfloat16):
                    summary["groupnorm_act"] = {"ms": ms, "plain_ms": plain}
    summary["groupnorm_act"]["max_abs_err"] = worst

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n, d in ATTN_SHAPES:
            q, k, v = (torch.randn((bh, 1, n, d), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            scale = 1.0 / math.sqrt(d)
            got, lse = flash_attention_fwd(q, k, v, scale)
            ref = einsum_attention(q, k, v, scale)
            ref_lse = einsum_logsumexp(q, k, scale)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = (math.isfinite(err) and err <= ATTN_TOL[dtype]
                  and math.isfinite(lse_err) and lse_err <= ATTN_TOL[torch.float32])
            ms = time_cuda(lambda: flash_attention_fwd(q, k, v, scale))
            plain = time_cuda(lambda: einsum_attention(q, k, v, scale))
            log(f"attention BH={bh} N={n} D={d} {str(dtype)[6:]:8s} "
                f"max_abs_err={err:.3e} lse_err={lse_err:.3e} tol={ATTN_TOL[dtype]:.0e} "
                f"kernel={ms:.4f} ms plain={plain:.4f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseError(f"attention disagrees at BH={bh} N={n} D={d} {dtype}: "
                                 f"out {err}, lse {lse_err}")
            worst = max(worst, err, lse_err)
            if (bh, n, d, dtype) == (64, 64, 256, torch.bfloat16):
                summary["flash_attention_fwd"] = {"ms": ms, "plain_ms": plain}
    summary["flash_attention_fwd"]["max_abs_err"] = worst
    return summary


KERNELS = {
    "groupnorm_act": ("ddpm_ood_tpu_torch/csrc/groupnorm.cu", "ddpm_ood_tpu/ops/groupnorm.py:58"),
    "flash_attention_fwd": ("ddpm_ood_tpu_torch/csrc/attention.cu",
                            "ddpm_ood_tpu/ops/attention.py:51"),
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


def _write_dataset(root: Path) -> dict:
    """32x32 grayscale .npy images and single-row split CSVs: smooth sine
    fields (val, in) and checkerboards (out)."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    csvs = {}
    for name, ood in (("val", False), ("in", False), ("checkerboard_test", True)):
        d = root / name
        d.mkdir(parents=True)
        paths = []
        for i in range(N_IMAGES):
            if ood:
                img = ((xx + yy + i) % 2).astype(np.float32)[None]
            else:
                phase = rng.uniform(0, 2 * np.pi)
                img = (0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) / 32 + phase)).astype(np.float32)[None]
            paths.append(str(d / f"{name}_{i}.npy"))
            np.save(paths[-1], img)
        csvs[name] = root / f"{name}.csv"
        csvs[name].write_text(",".join(paths))
    return csvs


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
    from ddpm_ood_tpu_torch.ops.attention import flash_attention_fwd
    from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act
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
        groupnorm_act.launches = 0
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        recon = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"groupnorm_act": groupnorm_act.launches,
                    "flash_attention_fwd": flash_attention_fwd.launches}

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


def main() -> int:
    t0 = time.perf_counter()
    try:
        device = phase_device()
        dev = torch.device("cuda", 0)
        phase_build()
        summary = phase_kernels(dev)
        phase_forward(dev)
        launches = phase_main(dev)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name], **summary[name]}
               for name, (src, tpu) in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
