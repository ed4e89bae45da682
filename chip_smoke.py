#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # from the repo root; needs one CUDA card

(``python3 chip_smoke.py --ddp-rank <spec.json>`` is one rank of phase_ddp's
torchrun launches, and ``--quant-run <spec.json>`` phase_quant's
interpreter: neither is a command to run by hand.)

Phases, each fatal on failure:
  1. device   -- a CUDA card is required (there is no CPU fallback); prints the
                 torch version and the card's name and power limit.
  2. build    -- compiles ddpm_ood_tpu_torch/csrc/*.cu with nvcc (one process
                 per source, all at once), prints ptxas' register, spill and
                 shared-memory lines, and fails if a tensor-core kernel spills
                 or if qconv_s8's SASS (cuobjdump) holds no warpgroup MMA.
  3. kernels  -- every kernel (GroupNorm on thread-block clusters, and the
                 large-sample GroupNorm at samples too large for a cluster
                 (GN_LARGE), x off a 16-byte boundary and rows of odd
                 widths (GN_EDGE), its two launches bitwise equal; flash
                 forward, flash backward dK/dV and dQ, bf16 on tensor
                 cores, fp32 on CUDA cores; int8 scoring's absmax,
                 activation codes and s8 x s8 -> s32 convolution, whose
                 absmax, codes, int32 sums and fp32 and bf16 outputs must
                 equal the plain version's exactly at QCONV_SHAPES, beside
                 cuBLAS's torch._int_mm over im2col codes) against its plain PyTorch
                 version at the main paths' shapes and ragged ones, with the
                 tolerance stated; each timed
                 (device time, CUDA events, the host's launch overhead hidden
                 behind a sleep kernel) beside its plain version, one PyTorch
                 library call computing the same function, and its bound.
  4. forward  -- the full-width small UNet through the kernels on the card
                 against the same weights through the plain versions on the CPU.
  5. step     -- one fp32 training step of the same UNet (loss and every
                 parameter gradient), card against CPU.
  6. metrics  -- the scoring metrics tail (recon/sweep.py:metrics_tail: MSE,
                 LPIPS from a seeded npz in the JAX package's key schema, 1 -
                 SSIM, the error-map sums) on one seeded (25, 32, 32, 32, 1)
                 batch of reconstructions, card against CPU (fp32, TF32 off),
                 and its device time per scored batch beside the UNet
                 forwards' (CUDA events).
  7. main     -- writes a synthetic 32x32 grayscale set and a seeded
                 reference-schema checkpoint.pth, then runs the scoring CLI
                 (ddpm_ood_tpu_torch.reconstruct) in this process: small UNet,
                 100-step PLMS, skip factor 4, batch 32, LPIPS from the npz,
                 --score_ssim=1 --save_error_maps=1. Checks the result CSVs
                 (finite, non-zero perceptual_difference and ssim_distance in
                 every row), one error map per image, that LPIPS read the npz,
                 and that every UNet forward went through both forward kernels,
                 every GroupNorm on the cluster kernel and every flash forward
                 on tensor cores (bf16 autocast).
  8. ood      -- ddpm_ood_tpu_torch.ood's run_ood_detection on those CSVs
                 (numpy only) for the plot targets mse, perceptual_difference,
                 mse+perceptual and ssim_distance: AUROC, AUPR, FPR@95 and the
                 DeLong CI, each AUROC finite in [0, 1], ood_scores_*.csv written.
  9. serve    -- the online scoring service on a copy of the main phase's
                 run: an fp32 ScoringService card vs CPU (10-step PLMS,
                 batch 4, noise passed in); python -m ddpm_ood_tpu_torch.serve
                 in a subprocess, SIGTERMed while a POST /score is in flight
                 (200, exit 0); the CLI's service built in this process at
                 full width (batch 32, --flag_fpr=0.05, a bearer token):
                 its first request against the scoring CLI's results_in.csv
                 (per-t mse at rtol 1e-5, z_score_mse within 1e-4 of the
                 offline z), 401 / healthz / statz / metricz / 413, 32
                 concurrent single-image clients through a
                 50 ms BatchingScoringService window (at most 2 sweeps),
                 POST /reload of a new checkpoint.pth (one image, wrap-
                 padded: its score changes, no kernel build, equal to a
                 fresh service given the same
                 noise); launch counts; latencies, flood reqs/s and
                 mean_sweep_seconds printed.
 10. sample   -- plms_denoise, ddim_denoise and dpm_denoise fp32 card vs
                 CPU; the sample CLI at full width on the main checkpoint:
                 dpm@25 (32 samples), then ddpm (8 samples, 1000 forwards);
                 shape, finite, in [0, 1], launch counts, seconds.
 11. samplers -- DDIM, DPM-Solver++ and the carried-history PLMS
                 (plms_ref), and the ELBO score: each sampler's fp32
                 small-UNet ReconProgram on a 10-step grid with the noise
                 passed in, its (K, B) MSE table and (but for plms_ref) its
                 ELBO table, card against CPU; the quality gate's tiny UNet
                 at 16x16 (forward, and one fp32 training step); then the
                 scoring CLI at full width with --sampler=dpm
                 --num_inference_steps=25 --inference_skip_factor=1
                 --score_elbo=1 (finite mse, perceptual_difference and elbo
                 in every row, recons/s and forwards per batch printed), and
                 run_ood_detection for elbo and mse+elbo on its CSVs. Every
                 path launches 27 GroupNorms and 4 flash forwards per UNet
                 forward (in bf16 on the cluster and tensor-core kernels).
 12. simplex  -- simplex noise, --resume, previews and --profile_dir on the
                 scoring path: g++ builds the port's OpenSimplex library
                 (seconds printed); one headline batch's planes, batched and
                 serial, bit-identical; device-mode noise card against CPU
                 (lattice hashes equal, planes within 1e-5); an fp32 small-UNet
                 sweep on one host simplex draw, card against CPU; the scoring
                 CLI at the main path's configuration with exact noise on
                 the val split and device noise on the out split
                 (recons/s beside the main phase's Gaussian run,
                 host seconds making noise and waiting for it, 27 GroupNorm and
                 4 flash launches per forward, previews); a crash after batch
                 1 (DDPM_OOD_TPU_CRASH_AFTER_BATCHES, exit -9) and --resume=1,
                 each in a fresh process, the resumed CSV against an
                 uninterrupted run's, and the resumed run's profiler trace
                 naming the port's GroupNorm and attention kernels.
 13. quant    -- (beside phase 14, in a fresh interpreter started after
                 phase 12) one small-UNet forward of 64 images under
                 --quantize=mixed (no int8 launch), then the scoring CLI on
                 the main phase's 32 validation images at its flags under
                 --quantize=int8 and w8: finite CSVs; scores against the
                 unquantised run's (median relative difference < 0.05,
                 correlation > 0.999); 49 absmax, 49 quantize_codes and 49
                 qconv_s8 launches a forward under int8, none under w8, 27
                 GroupNorm and 4 flash a forward in every mode; recons/s
                 per mode.
 14. ldm pieces -- fp32, TF32 off, card against CPU at full channel widths:
                 the small UNet in 3D on (2, 128, 8, 8, 8) latents; the
                 Decathlon VQ-VAE (four 256-channel levels, 2048 codes of
                 width 128) encoding 32^3 volumes, its quantizer's indices
                 (equal outside near-ties, which are counted) and its
                 decoder; the latent ReconProgram (encode, --latent_pad to
                 4^3, 10-step PLMS with the noise passed in, un-pad, decode,
                 fake-3D LPIPS): its (K, B) MSE and LPIPS tables.
 15. ldm      -- the scoring CLI on a 3D latent diffusion model at the
                 reference's Decathlon geometry (128^3 x 1 volumes, 8^3 x 128
                 latents; seeded VQ-VAE checkpoint.pth with its
                 vqvae_config.json, seeded small 3D UNet), batch 2, LPIPS from
                 the npz, --score_ssim=1 --save_error_maps=1: PLMS 50/2, then
                 --sampler=dpm 25/1. Checks finite non-zero columns, 3D error
                 maps, 27 GroupNorm (cluster) and 4 flash (tensor-core)
                 launches per UNet forward, run_ood_detection on the CSVs;
                 prints latent-recons/s, the device seconds of encode, UNet
                 forwards, decode and metrics tail (CUDA events), and peak
                 device memory.
 15b. brats   -- the scoring CLI at the BraTS ROI geometry (BRATS_ARGS: 176x176x136
                 volumes cropped to 160x160x128, not resized; a VQ-VAE of
                 three 256-channel levels, (20, 20, 16, 128) latents; the
                 small 3D UNet; PLMS 100/16 in 3 lane groups, batch 8). First
                 one UNet forward at the sweep's 24 rows through the kernels
                 against the plain versions on the card (fp32), and the
                 GroupNorm shapes of a bf16 forward, from which the dispatch
                 predicts each forward's launches (2 large-sample, 25
                 cluster); then the CLI on two val batches and one in and
                 one out: finite CSVs, every forward's launches as
                 predicted, val's batch 1 traced (--profile_dir: device busy
                 and idle shares, GroupNorm's and attention's shares of the
                 device time), latent-recons/s of the warm untraced batches,
                 CUDA-event spans of UNet forwards, encode, decode and
                 metrics tail, and peak device memory.
 16. vqvae step, train ldm -- latent-diffusion training: one VQ-VAE +
                 PatchGAN step and one 3D LDM step card against CPU; then
                 train_vqvae and train_ddpm --vqvae_checkpoint at the
                 Decathlon geometry and the scoring CLI on both checkpoints.
 17. train    -- runs the training CLI (ddpm_ood_tpu_torch.train_ddpm) in this
                 process on a synthetic 32x32 set: small UNet, batch 128, 2
                 epochs of 4 steps, validation with a 1000-step sample grid.
                 Checks that the loss is finite and falls, the checkpoints'
                 schema, the launch counts of all four kernels (every
                 GroupNorm on the cluster kernel, every flash forward, dK/dV
                 and dQ on tensor cores), and that the scoring CLI
                 loads the trained checkpoint.pth.
 18. train remat -- one fp32 step with and without remat on the card (equal
                 gradients within 1e-5 of each tensor's largest value, remat's
                 launch counts from the block structure); the training CLI
                 with --simplex_noise=1, without and with --remat=1 (images/s
                 and peak memory side by side, launch counts), the second's
                 --profile_dir trace naming the port's kernels.
 19. pipelines -- the pipeline scripts as users run them, each in a fresh
                 interpreter and all at once: python -m
                 ddpm_ood_tpu_torch.demo (checkpoints, five finite
                 results CSVs, checkerboard AUROC >= 0.9); smoke_3d_ldm at
                 its defaults (PLMS 10/3) and with SAMPLER=dpm STEPS=25
                 SKIP=1 (eleven finite CSVs each, the AUROC table; these
                 two start before phase 15 and run beside phases 15-18); the
                 computer-vision dataset prep of a crafted raw tree (IDX
                 gz, CIFAR tarball, SVHN .mat) with urllib's download
                 refused (split sizes, images bit-equal to the archives).
                 Meanwhile, in this process: the demo's stage argv lists
                 with the launch counts (27 GroupNorm and 4 flash a
                 forward on the cluster and tensor-core kernels, 4 dK/dV
                 and 4 dQ a step), then the library example (a finite
                 AUROC). Then parity_run on the prepped splits with
                 checkpoint_300.pth and the results CSVs in place: stages
                 1-3 skipped, auroc_table.json written. Seconds printed.
 20. ddp      -- beside the pipeline scripts, three launches of python -m
                 torch.distributed.run --standalone, whose ranks run this
                 script with --ddp-rank: 1 rank on NCCL (train_ddpm at the
                 training phase's width, 512 images, batch 128, 2 epochs,
                 then a resume to 3; --fsdp=1; a frozen-parameter epoch;
                 zero-noise scoring of 8 images), 2 ranks on the one card
                 over gloo (DDPM_OOD_TORCH_SHARED_CARD=1: the same training
                 at 64 a rank and its resume, replicas bit-identical; the
                 frozen epoch's loss against 1 rank's; the scoring CLI on
                 64 images, PLMS 100/4, every (image, start point) once in
                 rank 0's merged CSV; zero-noise scores against 1 rank's),
                 and --fsdp=1 at 2 ranks against DDP's first epoch; fp32
                 gradients of DDP and of FSDP2 at 2 ranks against the whole
                 batch's (1e-3 of each tensor's largest); no DDP warning
                 that a gradient's strides differ from its bucket's. Every
                 rank's launch counts (27 GroupNorm and 4 flash a forward, 4
                 dK/dV and 4 dQ a step, on the cluster and tensor-core
                 kernels), FSDP2's bytes a card against bench_fsdp_hbm's
                 arithmetic, images/s and seconds printed.

Launch counts are set to 0 just before each CLI run (scoring, the serve
CLI's service, the sample CLI, the samplers' scoring, the two simplex
scoring runs, each quantised scoring run, the two latent scoring runs, the
training runs, each stage of the demo, each run of each rank of phase_ddp)
and read just after. The
line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. The script imports no JAX.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Tolerances against the plain versions, by dtype. f32, max abs error: the two
# sum in different orders (groupnorm at 2e-5, attention forward and backward
# at 1e-4 over a 256-long dot and a softmax, tests/test_attention.py).
# GroupNorm in bf16, max abs error: both compute in fp32 from the same bf16
# inputs and round once, so they differ by at most one bf16 ulp of the output;
# the inputs keep |y| < 4, where that ulp is 2^-6 = 0.0156 < 2e-2.
# Attention in bf16: its outputs are far below 1 (a typical |dK| is ~0.004 at
# N = 1000), so each output tensor is held on its own, relative to its plain
# version's largest value: max|kernel - plain| / max|plain| <= 1e-2. Both round
# an fp32 result to bf16 once, which differs by at most one ulp, 2^-7 = 7.8e-3
# of the tensor's largest value; the rest is the fp32 difference of the
# tensor-core kernels rounding the forward's unnormalised probabilities and
# the backward's P and dS to bf16 before their products, as FlashAttention-2
# does (the plain forward rounds the normalised probabilities, the plain
# backward nothing): 2^-9 relative per term, averaged out over the keys or
# queries. A dK of 0, or one 2% off, fails. Readings on an NVIDIA H100 80GB
# HBM3 at 700 W over ATTN_SHAPES (PERF.md): O 6.94e-3, dV 6.67e-3, dQ
# 6.06e-3, dK 5.68e-3 at most; on the CPU, tests/test_torch_attention_tc.py
# emulates the kernels' rounding within 4.11e-3 of the fp32 JAX kernels by the
# same measure. The fp32 row logsumexp is held to LSE_TOL, absolute, in both
# dtypes (read at most 1.4e-6).
GN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_TOL = 1e-4
# (N, C) of each sample, batch 64: every one of the 2D small UNet's at 32x32,
# and of the 3D small UNet's on the 8x8x8 latents of the latent diffusion path
# (N = 512, 64, 8), whose deepest level (2x2x2, 8 rows) takes 14 of a
# forward's 27 GroupNorm launches
GN_SHAPES = [(1024, 128), (1024, 256), (1024, 384), (256, 128), (256, 256),
             (256, 384), (256, 512), (64, 256), (64, 512),
             (512, 128), (512, 256), (512, 384), (512, 512), (64, 128), (64, 384),
             (8, 256), (8, 512)]
# (B, N, C) of samples over 8 blocks' shared memory, the large-sample kernel of
# csrc/groupnorm.cu: the 3D small UNet's level-0 GroupNorms over the
# concatenated 384 and 256 channels on 20x20x16 latents (the BraTS ROI over
# 8), at batch 64 and at the sweep's lane groups (3 and 2 lanes of 8
# volumes), then the 2D small UNet's level 0 at 64x64
GN_LARGE = [(64, 6400, 384), (64, 6400, 256), (24, 6400, 384), (24, 6400, 256),
            (16, 6400, 384), (16, 6400, 256), (64, 4096, 256), (64, 4096, 384)]
GN_LARGE_SUMMARY = (64, 6400, 384)
# (name, B, N, C, G, element offset of x, {dtype: the large kernel's load
# bytes, or None for the cluster kernel}) of shapes the cluster kernel
# refuses for another reason, taken by the same kernel on narrower loads: x
# off a 16-byte boundary (2-byte loads in bf16, 4-byte in fp32), an odd C
# (66- and 132-byte rows), 72-byte rows (8-byte loads in bf16; fp32's 144
# bytes are whole vectors, which the cluster kernel takes)
GN_EDGE = [("unaligned", 8, 1024, 128, 32, 1, {"bf16": 2, "fp32": 4}),
           ("odd C", 8, 2000, 33, 3, 0, {"bf16": 2, "fp32": 4}),
           ("72-byte rows", 8, 2000, 36, 4, 0, {"bf16": 8, "fp32": None})]
GN_LDM = (512, 384)  # the summary's latent-diffusion GroupNorm shapes: level 0,
GN_LDM_DEEPEST = (8, 512)  # and the deepest level's concatenated skip
# the spatial shape of N rows, for the library call's (B, C, *spatial) view
GN_SPATIAL = {512: (8, 8, 8), 8: (2, 2, 2), 6400: (20, 20, 16), 2000: (2000,)}
# (B*H, N, D): scoring's K*B = 64, training's batch of 128, and ragged ones: N
# past a 64-key tile at D = 256, two key tiles at a D that pads to 64, three
# at a D that pads to 128, and 16 key tiles at D = 64; then the 3D small
# UNet's deepest level, N = 8 tokens (2x2x2) at D = 256, inside one 16-row,
# 64-key tile: a 17-lane group of batch 32, and of batch 2; and the latent
# diffusion training step's, batch 6
ATTN_SHAPES = [(64, 64, 256), (128, 64, 256), (8, 100, 256), (4, 72, 40), (2, 130, 96),
               (4, 1000, 64), (544, 8, 256), (34, 8, 256), (6, 8, 256)]
ATTN_LDM = (544, 8, 256, torch.bfloat16)  # the summary's latent-diffusion attention shape
ATTN_LDM_TRAIN = (6, 8, 256, torch.bfloat16)  # and the latent-diffusion training step's
# ptxas must show no spill
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel", "flash_bwd_dq_tc_kernel",
              "qconv_s8_kernel", "quant_codes_kernel")
# kernels whose SASS must hold warpgroup MMA (GMMA) instructions
GMMA_KERNELS = ("qconv_s8_kernel",)
ATTN_SUMMARY = (128, 64, 256, torch.bfloat16)  # the training path's shape


CARD = "not read"  # nvidia-smi's name and power limit, set by phase_device


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


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
    function, spills = None, {}
    for line in _kernels.BUILD_LOG.read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
        if m := re.search(r"Function properties for (\S+)", line):
            function = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and function and any(name in function for name in TC_KERNELS):
            spills[function] = int(m.group(1)) + int(m.group(2))
    log(f"build: tensor-core kernels' spill bytes (ptxas) {spills}")
    if not spills or any(spills.values()):
        raise PhaseError(f"tensor-core kernels must compile without spills: {spills}")
    gmma = sass_gmma(_kernels.LIB_PATH, Path(_kernels.find_nvcc()).parent / "cuobjdump")
    log(f"build: warpgroup MMA instructions in the SASS (cuobjdump) {gmma}")
    if sorted(gmma) != sorted(GMMA_KERNELS) or not all(gmma.values()):
        raise PhaseError(f"{', '.join(GMMA_KERNELS)} must run on warpgroup MMA: SASS {gmma}")


def sass_gmma(lib: Path, cuobjdump: Path) -> dict:
    """{kernel of GMMA_KERNELS: its count of GMMA instructions} in the SASS
    of the built library."""
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise PhaseError(f"cuobjdump -sass failed: {out.stderr[-2000:]}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = next((k for k in GMMA_KERNELS if k in m.group(1)), None)
            if name is not None:
                counts.setdefault(name, 0)
        elif name is not None and "GMMA" in line:
            counts[name] += 1
    return counts


def _check(name: str, err: float, tol: float, what: str) -> None:
    if not (math.isfinite(err) and err <= tol):
        raise PhaseError(f"{name} disagrees with its plain version at {what}: {err} > {tol}")


def _attn_errs(got, ref) -> tuple:
    """(max abs error, and the same over the plain version's largest |value|)
    of one attention output tensor against its plain version."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def phase_kernels(dev: torch.device) -> dict:
    import torch.nn.functional as F

    from bench_attention import attention_bounds, bound, time_cuda
    from ddpm_ood_tpu_torch.ops.attention import (
        einsum_attention, einsum_logsumexp, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_reference, flash_attention_fwd,
    )
    from ddpm_ood_tpu_torch.ops.groupnorm import (
        groupnorm_act, groupnorm_act_reference, kernel_for,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    summary, gn_ldm, gn_large, attn_ldm, attn_ldm_train = {}, {}, {}, {}, {}
    worst = {"cluster": 0.0, "large": 0.0}
    cases = ([("", 64, n, c, 32, 0, {"bf16": None, "fp32": None}) for n, c in GN_SHAPES]
             + [("", b, n, c, 32, 0, {"bf16": 16, "fp32": 16}) for b, n, c in GN_LARGE]
             + GN_EDGE)
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, n, c, g, offset, loads in cases:
            spatial = GN_SPATIAL.get(n, (math.isqrt(n),) * 2)
            x = (torch.rand((b * n * c + offset,), generator=gen, device=dev) * 2 - 1).to(dtype)
            x = x[offset:].view(b, n, c)
            gamma = torch.rand((c,), generator=gen, device=dev) + 0.5
            beta = torch.rand((c,), generator=gen, device=dev) - 0.5
            kernel, plan = kernel_for(n, c, g, x.element_size(), x.data_ptr())
            want = loads["bf16" if dtype == torch.bfloat16 else "fp32"]
            if (kernel, plan.vec_bytes if kernel == "large" else None) != (
                    "large" if want else "cluster", want):
                raise PhaseError(f"groupnorm B={b} N={n} C={c} {dtype} {name}: {kernel} kernel "
                                 f"({plan}), expected the "
                                 + (f"large kernel on {want}-byte loads" if want else
                                    "cluster kernel"))
            shown = (f"cluster of {plan[0]}" if kernel == "cluster" else
                     f"large: {plan.tiles} tiles of {plan.rows} rows, "
                     f"{plan.vec_bytes}-byte loads, {'resident' if plan.resident else 'streamed'}")
            for act in ("none", "silu"):
                before = (groupnorm_act.launches, groupnorm_act.cluster_launches,
                          groupnorm_act.large_launches)
                got = groupnorm_act(x, gamma, beta, g, 1e-6, act)
                moved = (groupnorm_act.launches - before[0],
                         groupnorm_act.cluster_launches - before[1],
                         groupnorm_act.large_launches - before[2])
                if moved != (1, int(kernel == "cluster"), int(kernel == "large")):
                    raise PhaseError(f"groupnorm N={n} C={c} {dtype}: launches moved by "
                                     f"{moved} for the {kernel} kernel")
                ref = groupnorm_act_reference(x, gamma, beta, g, 1e-6, act)
                again = groupnorm_act(x, gamma, beta, g, 1e-6, act) if kernel == "large" else got
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise PhaseError(f"groupnorm N={n} C={c} {dtype} {act}: two launches of the "
                                     "large-sample kernel differ")
                err = (got.float() - ref.float()).abs().max().item()
                timed = not name and (kernel == "cluster" or dtype == torch.bfloat16
                                      or (b, n, c) == GN_LARGE_SUMMARY)
                ms = plain = lib = None
                if timed:
                    # the yardsticks of a large sample take milliseconds: fewer runs
                    few = {"iters": 5, "reps": 3} if kernel == "large" else {}
                    ms = time_cuda(lambda: groupnorm_act(x, gamma, beta, g, 1e-6, act))
                    plain = time_cuda(lambda: groupnorm_act_reference(x, gamma, beta, g, 1e-6,
                                                                      act), **few)
                    if act == "none":  # F.group_norm on the same memory: a channels-last
                        nd = len(spatial)  # (B, C, *spatial) view of (B, N, C)
                        xl = x.reshape((b,) + spatial + (c,)).permute(
                            (0, nd + 1) + tuple(range(1, nd + 1)))
                        g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
                        lib = time_cuda(lambda: F.group_norm(xl, g, g_lib, b_lib, 1e-6), **few)
                fmt = lambda v: f"{v:.5f} ms" if v is not None else "-"  # noqa: E731
                log(f"groupnorm B={b} N={n} {spatial} C={c} G={g} {act:4s} {str(dtype)[6:]:8s} "
                    f"{name + ' ' if name else ''}({shown}) "
                    f"max_abs_err={err:.3e} tol={GN_TOL[dtype]:.0e} kernel={fmt(ms)} "
                    f"plain={fmt(plain)} library={fmt(lib)}"
                    + (" bitwise equal over two launches" if kernel == "large" else "")
                    + f" {'ok' if err <= GN_TOL[dtype] else 'FAIL'}")
                _check(f"groupnorm ({kernel})", err, GN_TOL[dtype], f"N={n} C={c} {act} {dtype}")
                worst[kernel] = max(worst[kernel], err)
                if not timed:
                    continue
                row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       **bound(2 * x.numel() * x.element_size() + 2 * c * 4,
                               8 * x.numel(), dtype)}
                if kernel == "large":
                    gn_large[f"{b}x{n}x{c} {str(dtype)[6:]} {act}"] = row
                if act == "none" and dtype == torch.bfloat16:
                    if (n, c) == (1024, 384):
                        summary["groupnorm_act"] = row
                    elif (n, c) == GN_LDM:
                        gn_ldm["ldm"] = {"shape": [64, n, c], **row}
                    elif (n, c) == GN_LDM_DEEPEST:
                        gn_ldm["ldm_deepest"] = {"shape": [64, n, c], **row}
                    elif (b, n, c) == GN_LARGE_SUMMARY:
                        summary["groupnorm_act_large"] = {"shape": [b, n, c], **row}
    summary["groupnorm_act"].update(gn_ldm, max_abs_err=worst["cluster"])
    summary["groupnorm_act_large"].update(by_shape=gn_large, max_abs_err=worst["large"])

    names = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    worst = {name: 0.0 for name in names}  # max abs error, both dtypes
    worst_rel = {name: 0.0 for name in names}  # bf16, relative to the largest |plain|
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n, d in ATTN_SHAPES:
            # std 0.5: every output well under 1 (bf16 is held relative, see ATTN_TOL)
            q, k, v, do = (0.5 * torch.randn((bh, 1, n, d), generator=gen, device=dev)
                           for _ in range(4))
            q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
            scale = 1.0 / math.sqrt(d)
            bounds = attention_bounds(bh, n, d, dtype)
            what = f"BH={bh} N={n} D={d} {str(dtype)[6:]}"

            got, lse = flash_attention_fwd(q, k, v, scale)
            ref = einsum_attention(q, k, v, scale)
            ref_lse = einsum_logsumexp(q, k, scale)
            torch.cuda.synchronize()
            e_lse = (lse - ref_lse).abs().max().item()
            _check("flash_attention_fwd lse", e_lse, LSE_TOL, what)
            # per output tensor: {name: (max abs error, relative to the largest |plain|)}
            errs = {"flash_attention_fwd": {"O": _attn_errs(got, ref)}}
            fwd = {"ms": time_cuda(lambda: flash_attention_fwd(q, k, v, scale)),
                   "plain_ms": time_cuda(lambda: einsum_attention(q, k, v, scale)),
                   "library_ms": time_cuda(
                       lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                   **bounds["flash_attention_fwd"]}

            # the backward kernels on the forward kernel's own O and lse
            delta = (do.float() * got.float()).sum(-1).reshape(bh, n).contiguous()
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
            rdq, rdk, rdv = flash_attention_bwd_reference(q, k, v, got, lse, do, scale)
            torch.cuda.synchronize()
            errs["flash_attention_bwd_dkv"] = {"dK": _attn_errs(dk, rdk),
                                               "dV": _attn_errs(dv, rdv)}
            errs["flash_attention_bwd_dq"] = {"dQ": _attn_errs(dq, rdq)}
            for name, per_tensor in errs.items():
                for tensor, (e_abs, e_rel) in per_tensor.items():
                    _check(f"{name} {tensor}", e_abs if dtype == torch.float32 else e_rel,
                           ATTN_TOL[dtype], what)
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
            dkv = {"ms": time_cuda(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                   scale)),
                   "plain_ms": plain_bwd, "library_ms": lib_bwd,
                   **bounds["flash_attention_bwd_dkv"]}
            dqt = {"ms": time_cuda(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                                  scale)),
                   "plain_ms": plain_bwd, "library_ms": lib_bwd,
                   **bounds["flash_attention_bwd_dq"]}
            for name, row in zip(names, (fwd, dkv, dqt)):
                held = "abs" if dtype == torch.float32 else "rel"
                shown = " ".join(f"{tensor}: abs={a:.3e} rel={r:.3e}"
                                 for tensor, (a, r) in errs[name].items())
                if name == "flash_attention_fwd":
                    shown += f" lse: abs={e_lse:.3e} (tol {LSE_TOL:.0e})"
                log(f"{name} {what} {shown} tol({held})={ATTN_TOL[dtype]:.0e} "
                    f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
                    f"library={row['library_ms']:.4f} ms bound={row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}) ok")
                worst[name] = max(worst[name], *(a for a, _ in errs[name].values()))
                if name == "flash_attention_fwd":
                    worst[name] = max(worst[name], e_lse)
                if dtype == torch.bfloat16:
                    worst_rel[name] = max(worst_rel[name], *(r for _, r in errs[name].values()))
                if (bh, n, d, dtype) == ATTN_SUMMARY:
                    summary[name] = row
                if (bh, n, d, dtype) == ATTN_LDM:
                    attn_ldm[name] = {"shape": [bh, n, d], **row}
                if (bh, n, d, dtype) == ATTN_LDM_TRAIN:
                    attn_ldm_train[name] = {"shape": [bh, n, d], **row}
    for name in names:
        summary[name]["ldm"] = attn_ldm[name]
        summary[name]["ldm_train"] = attn_ldm_train[name]
        summary[name]["max_abs_err"] = worst[name]
        summary[name]["max_rel_err_bf16"] = worst_rel[name]
    summary.update(quant_kernels(dev))
    return summary


# int8 scoring's kernels, (name, x (B, *spatial, Cin), Cout, window, stride,
# padding; window None for qdot): the small UNet's quantised sites at the
# headline's 64 images a UNet call (level 0 and level 1 3x3, the stride-2
# Downsample, an up-path 1x1 skip, the attention projections over 64 x 64
# tokens), level 1 at a lane group's 512 images (bench_quant_micro's shape),
# and the 3D latent path's level 0 (a 17-lane group of batch 2 on 8^3
# latents); then ragged ones: M, N and K off the tiles (Cin stays a multiple
# of 8, as the kernel's 16-byte loads need), and XLA's SAME at stride 2 (pads
# (0, 1)).
QCONV_SHAPES = [("level0 3x3", (64, 32, 32, 128), 128, 3, 1, "SAME"),
                ("level1 3x3", (64, 16, 16, 256), 256, 3, 1, "SAME"),
                ("sweep level1 3x3", (512, 16, 16, 256), 256, 3, 1, "SAME"),
                ("downsample", (64, 32, 32, 128), 128, 3, 2, [(1, 1)] * 2),
                ("skip 1x1", (64, 32, 32, 256), 128, 1, 1, "SAME"),
                ("qdot", (64, 64, 256), 256, None, 1, "SAME"),
                ("ldm level0 3x3x3", (34, 8, 8, 8, 128), 128, 3, 1, "SAME"),
                ("ragged", (3, 7, 9, 24), 36, 3, 1, "SAME"),
                ("same stride 2", (2, 8, 8, 64), 40, 3, 2, "SAME")]
QCONV_SUMMARY, QCONV_LDM = "level0 3x3", "ldm level0 3x3x3"


def _im2col(xq: torch.Tensor, window, strides, pads) -> torch.Tensor:
    """The (M, K) matrix of an implicit-GEMM convolution's activation rows:
    channels-last xq (B, *spatial, C) zero-padded by `pads`, every window tap
    at every output position, K ordered (tap, channel) as the packed weight."""
    import itertools

    spatial = xq.shape[1:-1]
    padded = xq.new_zeros((xq.shape[0],) + tuple(n + lo + hi for n, (lo, hi) in
                                                 zip(spatial, pads)) + (xq.shape[-1],))
    padded[(slice(None),) + tuple(slice(lo, lo + n) for n, (lo, _) in zip(spatial, pads))] = xq
    out = [(n + lo + hi - k) // s + 1 for n, k, s, (lo, hi) in zip(spatial, window, strides, pads)]
    taps = [padded[(slice(None),) + tuple(slice(o, o + s * (m - 1) + 1, s)
                                          for o, s, m in zip(offs, strides, out))]
            for offs in itertools.product(*(range(k) for k in window))]
    return torch.stack(taps, dim=-2).reshape(-1, len(taps) * xq.shape[-1])


def _int_mm_ms(xq, wcodes, window, strides, pads):
    """Device ms of torch._int_mm (cuBLAS s8 x s8 -> s32) on the same M, N, K
    over codes already laid out as im2col (a yardstick the port never
    calls), or None where cuBLAS refuses the shape (M <= 16, K or N off a
    multiple of 8)."""
    from bench_attention import time_cuda

    a = _im2col(xq, window, strides, pads) if window else xq.reshape(-1, xq.shape[-1])
    rows = wcodes.permute((0,) + tuple(range(2, wcodes.dim())) + (1,)).reshape(
        wcodes.shape[0], -1)
    b = rows.t()  # (K, N), column-major
    if a.shape[0] <= 16 or a.shape[1] % 8 or b.shape[1] % 8:
        return None
    try:
        got = torch._int_mm(a, b)
    except RuntimeError as e:  # a cuBLAS refusal of the layout: no yardstick
        log(f"  torch._int_mm refused {tuple(a.shape)} x {tuple(b.shape)}: {e}")
        return None
    if not torch.equal(got, (a.double() @ b.double()).round().int()):
        raise PhaseError(f"torch._int_mm on {tuple(a.shape)} x {tuple(b.shape)}: wrong sums")
    return time_cuda(lambda: torch._int_mm(a, b))


def _qconv_case(dev, gen, name, shape, cout, window, stride, padding, dtype) -> dict:
    """One shape of quant_kernels: the kernels against their plain versions
    (absmax, codes, int32 sums, fp32 and bf16 outputs, all exact); in bf16,
    their times beside the plain version's, cuDNN's bf16 convolution (or
    cuBLAS's bf16 linear for qdot: PyTorch has no s8 convolution), cuBLAS's
    s8 product torch._int_mm over im2col codes, and the bound."""
    import torch.nn.functional as F

    from bench_attention import bound, time_cuda
    from ddpm_ood_tpu_torch.ops.quant import (
        conv_padding, padded_channels, qconv_s8, qconv_s8_reference, qdot_s8,
        qdot_s8_reference, quant_absmax, quant_absmax_reference, quantize_codes,
        quantize_codes_reference, quantize_int8, quantize_weight, s8_conv_sum, s8_dot_sum,
    )

    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    cin, nd = shape[-1], len(shape) - 2
    wshape = (cout, cin) + ((window,) * nd if window else ())
    weight = torch.randn(wshape, generator=gen, device=dev) / math.sqrt(math.prod(wshape[1:]))
    bias = 0.1 * torch.randn((cout,), generator=gen, device=dev)
    w = quantize_weight(weight)
    w_cpu = quantize_weight(weight.cpu())
    what = f"qconv_s8 {name} x={tuple(shape)} Cout={cout} {str(dtype)[6:]}"
    if not (torch.equal(w.codes.cpu(), w_cpu.codes) and torch.equal(w.scale.cpu(), w_cpu.scale)):
        raise PhaseError(f"{what}: weight codes or scales differ, card vs CPU")
    absmax = quant_absmax(x)
    if not torch.equal(absmax, quant_absmax_reference(x)):
        raise PhaseError(f"quant_absmax {what}: {absmax.item()} != "
                         f"{quant_absmax_reference(x).item()}")
    xq, sx = quantize_int8(x)
    xq_cpu, sx_cpu = quantize_int8(x.cpu())
    if not (torch.equal(xq.cpu(), xq_cpu) and torch.equal(sx.cpu(), sx_cpu)):
        raise PhaseError(f"{what}: activation codes or scale differ, card vs CPU")
    codes = quantize_codes(x, absmax)
    torch.cuda.synchronize()
    if not torch.equal(codes, quantize_codes_reference(x, absmax)):
        raise PhaseError(f"quantize_codes {what}: codes differ from the plain version's "
                         f"({(codes != quantize_codes_reference(x, absmax)).sum().item()})")
    if window is None:  # qdot: (B, N, C) tokens
        def run(out_dtype, b=bias):
            return qdot_s8(x, absmax, w, b, out_dtype)

        def plain(out_dtype, b=bias):
            return qdot_s8_reference(x, absmax, w, b, out_dtype)

        ref_sums = s8_dot_sum(xq, w.codes)
        pads, strides = [(0, 0)], (1,)
    else:
        strides = (stride,) * nd
        pads = conv_padding(shape[1:-1], (window,) * nd, strides, padding)

        def run(out_dtype, b=bias):
            return qconv_s8(x, absmax, w, b, strides, pads, out_dtype)

        def plain(out_dtype, b=bias):
            return qconv_s8_reference(x, absmax, w, b, strides, pads, out_dtype)

        ref_sums = s8_conv_sum(xq, w.codes, strides, pads)
    sums = run(torch.int32, None)
    torch.cuda.synchronize()
    if sums.shape != ref_sums.shape or not torch.equal(sums, ref_sums):
        bad = (sums != ref_sums).sum().item() if sums.shape == ref_sums.shape else "shape"
        raise PhaseError(f"{what}: int32 sums differ from the exact plain sums ({bad})")
    for out_dtype in sorted({torch.float32, dtype}, key=str):
        got, ref = run(out_dtype), plain(out_dtype)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            err = (got.float() - ref.float()).abs().max().item()
            raise PhaseError(f"{what}: {out_dtype} output differs from the plain version "
                             f"(max abs {err:.3e}, {(got != ref).sum().item()} elements)")
    m = sums.numel() // cout
    k = cin * (window ** nd if window else 1)
    log(f"{what}: M={m} N={cout} K={k} pads={pads}: absmax, codes (kernel), int32 sums and "
        f"{'fp32' if dtype == torch.float32 else 'fp32 and bf16'} outputs equal the plain "
        "version's exactly")
    if dtype != torch.bfloat16:
        return {}
    ms = time_cuda(lambda: run(dtype))
    plain_ms = time_cuda(lambda: plain(dtype))
    wb, bb = weight.to(dtype), bias.to(dtype)
    if window is None:
        lib = time_cuda(lambda: F.linear(x, wb, bb))
    else:
        conv = {2: F.conv2d, 3: F.conv3d}[nd]
        xc = x.permute((0, nd + 1) + tuple(range(1, nd + 1)))  # channels-last memory
        wc = wb.contiguous(memory_format=(torch.channels_last if nd == 2
                                          else torch.channels_last_3d))
        lo = tuple(p for p, _ in pads)
        lib = (time_cuda(lambda: conv(xc, wc, bb, stride=strides, padding=lo))
               if all(a == b for a, b in pads) else None)
    int_mm = _int_mm_ms(xq, w.codes, (window,) * nd if window else None, strides, pads)
    nbytes = x.numel() * x.element_size() + cout * k + 2 * cout * 4 + m * cout * 2
    row = {"shape": {"x": list(shape), "cout": cout, "window": window, "stride": stride,
                     "M": m, "N": cout, "K": k},
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib, "int_mm_ms": int_mm,
           **bound(nbytes, 2.0 * m * cout * k, torch.int8)}
    c_ms = time_cuda(lambda: quantize_codes(x, absmax))
    c_plain = time_cuda(lambda: quantize_codes_reference(x, absmax))
    pixels = x.numel() // cin
    c_row = {"shape": list(shape), "ms": c_ms, "plain_ms": c_plain, "library_ms": None,
             **bound(x.numel() * x.element_size() + pixels * padded_channels(cin) + 4,
                     x.numel(), torch.float32)}
    a_ms = time_cuda(lambda: quant_absmax(x))
    a_plain = time_cuda(lambda: quant_absmax_reference(x))
    a_lib = time_cuda(lambda: torch.linalg.vector_norm(x, float("inf")))
    a_row = {"shape": list(shape), "ms": a_ms, "plain_ms": a_plain, "library_ms": a_lib,
             **bound(x.numel() * x.element_size() + 4, x.numel(), torch.float32)}
    log(f"  {name} bf16: qconv_s8 {ms:.5f} ms (quantize_codes included), plain {plain_ms:.5f} "
        "ms, library (cuDNN/cuBLAS bf16) " + (f"{lib:.5f} ms" if lib is not None else "-")
        + ", torch._int_mm " + (f"{int_mm:.5f} ms" if int_mm is not None else "-")
        + f", bound {row['bound_ms']:.5f} ms ({row['bound_by']}); quantize_codes {c_ms:.5f} "
        f"ms, plain {c_plain:.5f}, bound {c_row['bound_ms']:.5f} ms; quant_absmax {a_ms:.5f} "
        f"ms, plain {a_plain:.5f}, vector_norm(inf) {a_lib:.5f}, bound {a_row['bound_ms']:.5f} ms")
    return {"qconv_s8": row, "quant_absmax": a_row, "quantize_codes": c_row}


def quant_kernels(dev: torch.device) -> dict:
    """quant_absmax and qconv_s8 at QCONV_SHAPES in fp32 and bf16, then the
    absmax of an all-zero tensor (0, so sx = 1) and a zero input's output
    (the bias, exactly); the bf16 summary rows of phase_kernels's JSON."""
    from ddpm_ood_tpu_torch.ops.quant import (
        qconv_s8, quant_absmax, quantize_codes, quantize_codes_reference, quantize_weight,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, cout, window, stride, padding in QCONV_SHAPES:
            rows[name, dtype] = _qconv_case(dev, gen, name, shape, cout, window, stride,
                                            padding, dtype)
    zeros = torch.zeros((2, 4, 4, 16), device=dev, dtype=torch.bfloat16)
    w = quantize_weight(torch.randn((8, 16, 3, 3), generator=gen, device=dev))
    bias = torch.randn((8,), generator=gen, device=dev)
    absmax = quant_absmax(zeros)
    y = qconv_s8(zeros, absmax, w, bias, (1, 1), [(1, 1)] * 2, torch.float32)
    codes = quantize_codes(zeros, absmax)
    if absmax.item() != 0.0 or not torch.equal(y, bias.expand_as(y)) or codes.any() \
            or not torch.equal(codes, quantize_codes_reference(zeros, absmax)):
        raise PhaseError("quant_absmax / quantize_codes / qconv_s8 on zeros: absmax "
                         f"{absmax.item()}, codes not all 0 or output not the bias")
    # Cin off a multiple of 8, or x off a 16-byte boundary: refused, not launched
    w20 = quantize_weight(torch.randn((8, 20, 3, 3), generator=gen, device=dev))
    x20 = torch.randn((2, 4, 4, 20), generator=gen, device=dev)
    x_off = torch.randn((2 * 4 * 4 * 16 + 1,), generator=gen, device=dev)[1:].view(2, 4, 4, 16)
    before = (qconv_s8.launches, quantize_codes.launches)
    for what, xx, ww in (("Cin 20", x20, w20), ("x off 16 bytes", x_off, w)):
        for call in (lambda: qconv_s8(xx, quant_absmax(xx), ww, None, (1, 1), [(1, 1)] * 2,
                                      torch.float32),
                     lambda: quantize_codes(xx, quant_absmax(xx))):
            try:
                call()
            except ValueError:
                continue
            raise PhaseError(f"qconv_s8 / quantize_codes with {what}: launched where it must "
                             "raise ValueError")
    if (qconv_s8.launches, quantize_codes.launches) != before:
        raise PhaseError("qconv_s8 / quantize_codes: a refused call counted a launch")
    summary = {name: dict(rows[QCONV_SUMMARY, torch.bfloat16][name]) for name in
               ("qconv_s8", "quant_absmax", "quantize_codes")}
    for name in summary:
        summary[name]["ldm"] = rows[QCONV_LDM, torch.bfloat16][name]
        summary[name]["all_shapes_bf16"] = {
            case: rows[case, torch.bfloat16][name] for case, *_ in QCONV_SHAPES
            if rows[case, torch.bfloat16]}
        summary[name]["max_abs_err"] = 0.0  # every comparison above is exact
    return summary


# the main path runs bf16: GroupNorm on the cluster kernel (the large-sample
# kernel where a sample outgrows a cluster), attention on the tensor-core
# kernels
KERNELS = {
    "groupnorm_act": ("ddpm_ood_tpu_torch/csrc/groupnorm_cluster.cu",
                      "ddpm_ood_tpu/ops/groupnorm.py:58"),
    # samples over 8 blocks' shared memory (the 3D latents at 20x20x16)
    "groupnorm_act_large": ("ddpm_ood_tpu_torch/csrc/groupnorm.cu",
                            "ddpm_ood_tpu/ops/groupnorm.py:58"),
    "flash_attention_fwd": ("ddpm_ood_tpu_torch/csrc/attention_fwd_tc.cu",
                            "ddpm_ood_tpu/ops/attention.py:51"),
    "flash_attention_bwd_dkv": ("ddpm_ood_tpu_torch/csrc/attention_bwd_tc.cu",
                                "ddpm_ood_tpu/ops/attention.py:138"),
    "flash_attention_bwd_dq": ("ddpm_ood_tpu_torch/csrc/attention_bwd_dq_tc.cu",
                               "ddpm_ood_tpu/ops/attention.py:181"),
    # int8 scoring's kernels replace no Pallas kernel: XLA's reduction and
    # s8 x s8 -> s32 convolution and dot in the JAX package
    "quant_absmax": ("ddpm_ood_tpu_torch/csrc/quant_absmax.cu",
                     "ddpm_ood_tpu/ops/quant.py:40"),
    "quantize_codes": ("ddpm_ood_tpu_torch/csrc/quant_codes.cu",
                       "ddpm_ood_tpu/ops/quant.py:45"),
    "qconv_s8": ("ddpm_ood_tpu_torch/csrc/qconv_s8.cu", "ddpm_ood_tpu/ops/quant.py:62"),
}
# the main path: small UNet, 32x32x1, 100-step PLMS, skip factor 4, batch 32
MAIN_ARGS = ["--model_type=small", "--image_size=32", "--is_grayscale=1",
             "--num_inference_steps=100", "--inference_skip_factor=4", "--batch_size=32",
             "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195"]
N_IMAGES = 32
GN_PER_FORWARD, ATTN_PER_FORWARD = 27, 4  # small UNet: 11 res blocks x 2 + 4 attn + out
FWD_TOL = 1e-3  # fp32 UNet / sweep, card vs CPU, relative to the output's scale
SMOKE_MODEL = "smoke_fashionmnist"
SCORE_COLUMNS = ("mse", "perceptual_difference", "ssim_distance")
# the metrics tail, fp32 card vs CPU with TF32 off: max abs error over the
# CPU's largest |value|, each of mse, LPIPS, 1 - SSIM and the error-map sums.
# cuDNN and oneDNN sum the AlexNet convolutions in different orders; a few
# 1e-6 is expected (PERF.md has the readings)
METRICS_TOL = 1e-4
OOD_TARGETS = ("mse", "perceptual_difference", "mse+perceptual", "ssim_distance")


def seeded_unet(seed: int, preset: str = "small", remat: bool = False):
    from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_

    return random_init_(make_unet(preset, 2, 1, 1, remat=remat),
                        torch.Generator().manual_seed(seed))


def remat_launches(model) -> tuple:
    """(GroupNorm, flash forward) launches that remat adds to a backward
    pass, from the block structure: each res block's 2 GroupNorms and each
    attention block's GroupNorm and flash forward run again; the output
    head's GroupNorm is outside every block. Checks GN_PER_FORWARD against
    the same count."""
    from ddpm_ood_tpu_torch.models.unet import AttentionBlock, ResnetBlock

    n_res = sum(isinstance(m, ResnetBlock) for m in model.modules())
    n_attn = sum(isinstance(m, AttentionBlock) for m in model.modules())
    if (2 * n_res + n_attn + 1, n_attn) != (GN_PER_FORWARD, ATTN_PER_FORWARD):
        raise PhaseError(f"{n_res} res and {n_attn} attention blocks do not give "
                         f"{GN_PER_FORWARD} GroupNorms and {ATTN_PER_FORWARD} flash a forward")
    return 2 * n_res + n_attn, n_attn


def phase_forward(dev: torch.device) -> None:
    """fp32 small UNet and a short sweep: kernels on the card vs plain on the CPU."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram

    cpu = seeded_unet(1).to(memory_format=torch.channels_last).eval()
    gpu = seeded_unet(1).to(dev, memory_format=torch.channels_last).eval()
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


def _check_csv(path: Path, t_starts, columns=SCORE_COLUMNS, n_images: int = N_IMAGES) -> None:
    """Every image at every start point, and in every row a finite value of
    each of `columns`; those after mse are not all zero."""
    if not path.is_file():
        raise PhaseError(f"missing results CSV {path.name}")
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    per_image = {}
    for r in rows:
        values = [float(r.get(c) or "nan") for c in columns]
        if not all(map(math.isfinite, values)):
            raise PhaseError(f"{path.name}: a score of {columns} is missing or not "
                             f"finite in {r}")
        per_image.setdefault(r["filename"], []).append(int(r["t"]))
    if len(per_image) != n_images or any(sorted(v) != sorted(t_starts) for v in per_image.values()):
        raise PhaseError(f"{path.name}: expected {n_images} images x {len(t_starts)} start points, "
                         f"got {len(rows)} rows over {len(per_image)} images")
    for c in columns[1:]:
        if not any(float(r[c]) for r in rows):
            raise PhaseError(f"{path.name}: {c} is 0 in every row")
    log(f"  {path.name}: {len(rows)} rows, {len(t_starts)} per image, {', '.join(columns)} "
        "finite in every row")


def _write_lpips_npz(path: Path, seed: int = 0) -> Path:
    """LPIPS weights in the key schema of the JAX package's save_lpips_npz
    (HWIO kernels, (C, 1) lin weights, some negative), drawn with numpy from a
    seed: the card runs LPIPS from an npz, as scoring with real weights does."""
    from ddpm_ood_tpu_torch.losses.lpips import ALEX_CHANNELS, ALEX_CONVS

    rng = np.random.default_rng(seed)
    arrays = {}
    for name, cin, cout, k, _, _ in ALEX_CONVS:
        arrays[f"params/net/{name}/kernel"] = (
            rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
        arrays[f"params/net/{name}/bias"] = (0.01 * rng.standard_normal(cout)).astype(np.float32)
    for i, c in enumerate(ALEX_CHANNELS):
        arrays[f"params/lin{i}"] = (rng.standard_normal((c, 1)) / np.sqrt(c)).astype(np.float32)
    np.savez(path, **arrays)
    return path


def _npz_state_dict(npz: Path) -> dict:
    from ddpm_ood_tpu_torch.utils.convert import jax_lpips_params_to_state_dict, load_params_npz

    return jax_lpips_params_to_state_dict(load_params_npz(str(npz)))


def phase_metrics(dev: torch.device, npz: Path) -> dict:
    """The metrics tail, card against CPU on one seeded batch of
    reconstructions; then its device time per scored batch of the main path
    (16 lane groups: the tail runs once per group) beside the UNet forwards'."""
    from collections import Counter

    from bench_attention import time_cuda
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
    from ddpm_ood_tpu_torch.ops.ssim import ssim_distance
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts, metrics_tail

    ts = pndm_timesteps(1000, 100)
    groups = group_t_starts(ts, pndm_start_points(ts, 4), 16)
    k_all = sum(len(st) for _, st in groups)
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(N_IMAGES, 32, 32, 1)).astype(np.float32)
    recon = (images + 0.2 * rng.standard_normal((k_all,) + images.shape)).astype(np.float32)
    names = ("mse", "perceptual_difference", "ssim_distance", "error_maps")
    out, perceptual = {}, {}
    for side, device in (("cpu", torch.device("cpu")), ("card", dev)):
        perceptual[side] = PerceptualLoss(weights_path=str(npz)).to(device).eval()
        with torch.no_grad():
            mse, perc, _, ssim_d, err = metrics_tail(
                torch.from_numpy(images).to(device), torch.from_numpy(recon).to(device), 1.0,
                perceptual[side], score_ssim=True, score_error_maps=True)
        out[side] = dict(zip(names, (t.cpu() for t in (mse, perc, ssim_d, err))))
    errs = {}
    for name in names:
        ref, got = out["cpu"][name], out["card"][name]
        if ref.abs().max().item() == 0.0:
            raise PhaseError(f"metrics: {name} is all zero on the CPU")
        errs[name] = (got - ref).abs().max().item() / ref.abs().max().item()
    log(f"metrics: (K, B) = ({k_all}, {N_IMAGES}) 32x32x1, fp32 card vs CPU, max abs error over "
        f"the CPU's largest |value|: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f"; tol {METRICS_TOL:.0e}")
    bad = {n: e for n, e in errs.items() if not (math.isfinite(e) and e <= METRICS_TOL)}
    if bad:
        raise PhaseError(f"metrics tail on the card disagrees with the CPU: {bad}")

    # device ms per scored batch: the tail once per lane group; the UNet once
    # per step of each group's grid, on k * 32 images under bf16 autocast
    unet = seeded_unet(0).to(dev, memory_format=torch.channels_last).eval()
    img = torch.from_numpy(images).to(dev)
    per_batch = {"metrics_tail": 0.0, "lpips": 0.0, "ssim": 0.0, "unet_forwards": 0.0}
    fn = perceptual["card"]
    with torch.no_grad():
        for k, count in sorted(Counter(len(st) for _, st in groups).items()):
            rec = torch.from_numpy(recon[:k]).to(dev)
            steps = sum(len(tg) for tg, st in groups if len(st) == k)
            x = torch.randn((k * N_IMAGES, 1, 32, 32), device=dev).to(
                memory_format=torch.channels_last)
            t = torch.full((k * N_IMAGES,), 500, device=dev)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                fwd = time_cuda(lambda: unet(x, t), iters=3)
            per_batch["unet_forwards"] += steps * fwd
            per_batch["metrics_tail"] += count * time_cuda(
                lambda: metrics_tail(img, rec, 1.0, fn, score_ssim=True, score_error_maps=True))
            per_batch["lpips"] += count * time_cuda(lambda: fn(img, rec))
            per_batch["ssim"] += count * time_cuda(
                lambda: ssim_distance(img.expand_as(rec).flatten(0, 1), rec.flatten(0, 1)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, st in groups:
            metrics_tail(img, torch.from_numpy(recon[:len(st)]).to(dev), 1.0, fn,
                         score_ssim=True, score_error_maps=True)
        torch.cuda.synchronize()
        per_batch["metrics_tail_wall"] = (time.perf_counter() - t0) * 1e3
    share = per_batch["metrics_tail"] / (per_batch["metrics_tail"] + per_batch["unet_forwards"])
    log(f"metrics: device ms per scored batch (32 images, {k_all} start points, {len(groups)} "
        f"lane groups): metrics tail {per_batch['metrics_tail']:.3f} (LPIPS "
        f"{per_batch['lpips']:.3f}, SSIM {per_batch['ssim']:.3f}) against the UNet forwards' "
        f"{per_batch['unet_forwards']:.2f}, a {100 * share:.2f}% share; the tail's host-clock "
        f"wall {per_batch['metrics_tail_wall']:.2f} ms; card {CARD}")
    summary = {"max_rel_err": errs, "tol": METRICS_TOL, "ms_per_scored_batch": per_batch,
               "card": CARD}
    log(json.dumps({"metrics_tail": summary}))
    return summary


def _rates(batch_times) -> dict:
    """recons/s over all batches, and over batches 2 on (warm)."""
    n_all, s_all = (sum(v) for v in zip(*batch_times))
    warm = batch_times[1:] or batch_times
    n_warm, s_warm = (sum(v) for v in zip(*warm))
    return {"all": n_all / s_all, "warm": n_warm / s_warm}


def phase_main(dev: torch.device, root: Path, npz: Path) -> tuple:
    """The scoring CLI at the main path's configuration, writing its CSVs and
    error maps under `root` (phase_ood reads them); returns its launches and
    recons/s."""
    from ddpm_ood_tpu_torch import reconstruct as cli
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    csvs = _write_dataset(root)
    run = root / "output" / SMOKE_MODEL
    run.mkdir(parents=True)
    save_checkpoint(run / "checkpoint.pth", seeded_unet(0).state_dict())
    argv = [f"--output_dir={root / 'output'}", f"--model_name={SMOKE_MODEL}",
            f"--validation_ids={csvs['val']}", f"--in_ids={csvs['in']}",
            f"--out_ids={csvs['checkerboard_test']}", "--device=cuda", *MAIN_ARGS,
            "--score_ssim=1", "--save_error_maps=1"]
    log(f"main: LPIPS_WEIGHTS_NPZ={os.environ.get('LPIPS_WEIGHTS_NPZ')} "
        "python -m ddpm_ood_tpu_torch.reconstruct " + " ".join(argv))
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
    # LPIPS, SSIM and the error maps launch none of the kernels: the counts
    # stay at 27 and 4 per UNet forward
    if launches["groupnorm_act"] != GN_PER_FORWARD * evals:
        raise PhaseError(f"groupnorm launches {launches['groupnorm_act']} != "
                         f"{GN_PER_FORWARD} x {evals}")
    if launches["groupnorm_act_cluster"] != launches["groupnorm_act"]:
        raise PhaseError(f"scoring ran {launches['groupnorm_act_cluster']} of "
                         f"{launches['groupnorm_act']} GroupNorms on the cluster kernel")
    if launches["flash_attention_fwd"] != ATTN_PER_FORWARD * evals:
        raise PhaseError(f"attention launches {launches['flash_attention_fwd']} != "
                         f"{ATTN_PER_FORWARD} x {evals}")
    if launches["flash_attention_fwd_tc"] != launches["flash_attention_fwd"]:
        raise PhaseError(f"bf16 scoring ran {launches['flash_attention_fwd_tc']} of "
                         f"{launches['flash_attention_fwd']} flash forwards on tensor cores")
    if any(launches[name] for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                                       "flash_attention_bwd_dkv_tc",
                                       "flash_attention_bwd_dq_tc")):
        raise PhaseError(f"scoring launched a backward kernel: {launches}")
    # LPIPS read the npz, not the seeded fallback, and ran on the card
    want = _npz_state_dict(npz)
    got = recon.perceptual.lpips.state_dict()
    if any(got[k].device != dev or not torch.equal(got[k].cpu(), v) for k, v in want.items()):
        raise PhaseError("the scoring CLI's LPIPS weights are not the npz's, or not on the card")
    for name in ("val", "in", "checkerboard"):
        _check_csv(recon.out_dir / f"results_{name}.csv", t_starts)
        maps = sorted((recon.out_dir / "error_maps" / name).glob("*.npy"))
        arrays = [np.load(m) for m in maps]
        if len(maps) != N_IMAGES or any(a.shape != (32, 32, 1) or not np.isfinite(a).all()
                                        for a in arrays):
            raise PhaseError(f"error_maps/{name}: {len(maps)} maps, expected {N_IMAGES} finite "
                             "(32, 32, 1) ones")
        log(f"  error_maps/{name}: {len(maps)} finite (32, 32, 1) maps, mean "
            f"{float(np.mean(arrays)):.4e}")

    rates = _rates(recon.batch_times)
    log(f"main: batches (recons, s) = {[(n, round(s, 3)) for n, s in recon.batch_times]}")
    log(f"main: {rates['all']:.2f} recons/s over all {len(recon.batch_times)} batches; "
        f"{rates['warm']:.2f} recons/s over batches 2-{len(recon.batch_times)}; "
        f"CLI wall {wall:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, rates


# phase_quant: in a fresh interpreter beside phase_ldm_pieces, one forward
# of the small UNet under --quantize=mixed at the headline's 64 images (the
# small preset has no convolution of 512 channels, so it quantises nothing:
# the int8 counters read 0; it also warms the interpreter's cuDNN), then the
# scoring CLI on phase_main's validation batch (32 images, the main path's
# flags) under int8 and w8
QUANT_RUNS = ("int8", "w8")
QUANT_TIMEOUT = 400  # seconds the interpreter may take
QUANT_SITES = 49  # the small UNet's int8 sites: 33 convolutions, 16 projections
# int8 and w8 against the unquantised run's scores on the same images:
# tests/test_quant.py's bounds (median relative difference, correlation)
QUANT_MEDIAN_REL, QUANT_CORR = 0.05, 0.999


def quant_run(spec_path: str) -> int:
    """``python3 chip_smoke.py --quant-run <spec.json>``: phase_quant's
    scoring runs in this process, one after another, each with the launch
    counts set to 0 just before it and read just after; the records go to
    the spec's ``out``."""
    from ddpm_ood_tpu_torch import reconstruct as cli
    from ddpm_ood_tpu_torch.models.unet import QuantConv, QuantDense, WeightOnlyQuantConv

    from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format, random_init_

    spec = json.loads(Path(spec_path).read_text())
    dev = torch.device("cuda", 0)
    model = random_init_(make_unet("small", 2, 1, 1, quant="mixed"),
                         torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=memory_format(2)).eval()
    x = torch.randn((64, 1, 32, 32), device=dev).contiguous(memory_format=memory_format(2))
    reset_launches()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        y = model(x, torch.full((64,), 500, device=dev))
    torch.cuda.synchronize()
    records = {"mixed": {
        "launches": read_launches(), "finite": bool(torch.isfinite(y).all()),
        "sites": {cls.__name__: sum(isinstance(m, cls) for m in model.modules())
                  for cls in (QuantConv, QuantDense, WeightOnlyQuantConv)}}}
    log(f"quant run mixed: one forward of 64 images, launches {records['mixed']['launches']}")
    del model
    for mode, argv in spec["runs"].items():
        reset_launches()
        t0 = time.perf_counter()
        recon = cli.main(argv)
        torch.cuda.synchronize()
        records[mode] = {
            "seconds": time.perf_counter() - t0, "launches": read_launches(),
            "evals": sum(p.model_evals for p in recon._programs.values()),
            "batch_times": recon.batch_times, "csv": str(recon.out_dir / "results_val.csv"),
            "sites": {cls.__name__: sum(isinstance(m, cls) for m in recon.unet.modules())
                      for cls in (QuantConv, QuantDense, WeightOnlyQuantConv)}}
        log(f"quant run {mode}: {records[mode]['seconds']:.1f} s, launches "
            f"{records[mode]['launches']}")
        del recon
    Path(spec["out"]).write_text(json.dumps(records))
    return 0


def start_quant(root: Path) -> tuple:
    """Start phase_quant's interpreter on copies of phase_main's run; returns
    (process, its directory, start time)."""
    out = root / "quant"
    out.mkdir()
    runs = {}
    for mode in QUANT_RUNS:
        runs[mode] = [f"--output_dir={_copy_run(root, f'quant_{mode}')}",
                      f"--model_name={SMOKE_MODEL}", f"--validation_ids={root / 'val.csv'}",
                      f"--in_ids={root / 'in.csv'}", f"--out_ids={root / 'in.csv'}",
                      "--run_in=0", "--run_out=0", "--device=cuda", *MAIN_ARGS,
                      f"--quantize={mode}"]
    spec = out / "spec.json"
    spec.write_text(json.dumps({"out": str(out / "records.json"), "runs": runs}))
    log("quant: python3 chip_smoke.py --quant-run: a --quantize=mixed forward, then python -m "
        "ddpm_ood_tpu_torch.reconstruct " + " ".join(runs["int8"][1:])
        + f" (--quantize={', '.join(QUANT_RUNS)})")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--quant-run",
                             str(spec)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"), start_new_session=True)
    return proc, out, time.perf_counter()


def _tracks(got: dict, want: dict, what: str) -> dict:
    """Median relative difference and correlation of two (filename, t) -> mse
    tables over the same keys, held to QUANT_MEDIAN_REL and QUANT_CORR."""
    if sorted(got) != sorted(want):
        raise PhaseError(f"{what}: the CSV's (image, t) rows are not the unquantised run's")
    a = np.array([got[k] for k in sorted(want)])
    b = np.array([want[k] for k in sorted(want)])
    rel = float(np.median(np.abs(a - b) / np.abs(b)))
    corr = float(np.corrcoef(a, b)[0, 1])
    log(f"  {what} against the unquantised scores: median relative difference {rel:.3e} "
        f"(< {QUANT_MEDIAN_REL}), correlation {corr:.6f} (> {QUANT_CORR}), max relative "
        f"{float(np.max(np.abs(a - b) / np.abs(b))):.3e}")
    if not (rel < QUANT_MEDIAN_REL and corr > QUANT_CORR):
        raise PhaseError(f"{what}: scores do not track the unquantised run's")
    return {"median_rel": rel, "corr": corr}


def phase_quant(started: tuple, none_rows: dict, none_rate: float) -> dict:
    """Wait for start_quant's interpreter and check its runs: finite CSVs;
    int8 and w8 scores against phase_main's unquantised ones on the same
    images; the launch counts (QUANT_SITES absmax, codes and qconv_s8 launches a
    forward under int8, none under w8 and in the mixed forward; 27 GroupNorm
    and 4 flash a forward in every mode); recons/s per mode. Returns the
    int8 run's launch counts."""
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts

    proc, out, t0 = started
    try:
        text, _ = proc.communicate(timeout=QUANT_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        text += f"\nkilled after {QUANT_TIMEOUT} s"
    seconds = time.perf_counter() - t0
    (out / "run.log").write_text(text)
    for line in text.splitlines():
        if line.startswith("quant run"):
            log("  " + line)
    if proc.returncode != 0:
        raise PhaseError(f"quant: the scoring interpreter failed ({proc.returncode}):\n"
                         + text[-3000:])
    records = json.loads((out / "records.json").read_text())
    ts = pndm_timesteps(1000, 100)
    t_starts = pndm_start_points(ts, 4)
    forwards = sum(len(s) for s, _ in group_t_starts(ts, t_starts, 16))  # one batch
    summary = {"card": CARD, "seconds": seconds}
    mixed = records["mixed"]
    want = {"quant_absmax": 0, "quantize_codes": 0, "qconv_s8": 0,
            "groupnorm_act": GN_PER_FORWARD,
            "groupnorm_act_cluster": GN_PER_FORWARD, "flash_attention_fwd": ATTN_PER_FORWARD,
            "flash_attention_fwd_tc": ATTN_PER_FORWARD}
    got = {k: mixed["launches"][k] for k in want}
    log(f"quant mixed: one forward, quantised sites {mixed['sites']}, launches {got}")
    if got != want or any(mixed["sites"].values()) or not mixed["finite"]:
        raise PhaseError(f"quant mixed: sites {mixed['sites']}, launches {got} (want {want}), "
                         f"finite output {mixed['finite']}")
    summary["mixed"] = {"launches": got}
    for mode in QUANT_RUNS:
        rec = records[mode]
        launches, evals = rec["launches"], rec["evals"]
        _check_csv(Path(rec["csv"]), t_starts, columns=("mse", "perceptual_difference"))
        int8 = QUANT_SITES * evals if mode == "int8" else 0
        sites = rec["sites"]
        want_sites = {"QuantConv": 33 if mode == "int8" else 0,
                      "QuantDense": 16 if mode == "int8" else 0,
                      "WeightOnlyQuantConv": 33 if mode == "w8" else 0}
        want = {"quant_absmax": int8, "quantize_codes": int8, "qconv_s8": int8,
                "groupnorm_act": GN_PER_FORWARD * evals,
                "groupnorm_act_cluster": GN_PER_FORWARD * evals,
                "flash_attention_fwd": ATTN_PER_FORWARD * evals,
                "flash_attention_fwd_tc": ATTN_PER_FORWARD * evals}
        got = {k: launches[k] for k in want}
        log(f"quant {mode}: {evals} UNet forwards, quantised sites {sites}, launches {got}")
        if sites != want_sites or got != want or evals != forwards:
            raise PhaseError(f"quant {mode}: sites {sites} (want {want_sites}), {evals} "
                             f"forwards (want {forwards}), launches {got} (want {want})")
        n, secs = (sum(v) for v in zip(*rec["batch_times"]))
        entry = {"recons_per_s": n / secs, "batch_seconds": secs, "launches": got}
        entry.update(_tracks(_rows(Path(rec["csv"])), none_rows, f"quant {mode}"))
        summary[mode] = entry
        log(f"quant {mode}: {n / secs:.2f} recons/s ({n} in {secs:.2f} s, one batch in a "
            f"fresh interpreter beside phase_ldm_pieces, so contended; phase_main's "
            f"unquantised batches, taken alone, read {none_rate:.2f}) on {CARD}")
    log(f"quant: phase took {seconds:.1f} s from its interpreter's start")
    log(json.dumps({"quant": summary}))
    return records["int8"]["launches"]


def phase_ood(root: Path) -> dict:
    """The port's OOD analytics (numpy only) on the main phase's CSVs, for
    each plot target: every AUROC finite in [0, 1], its score table written."""
    from ddpm_ood_tpu_torch.ood import run_ood_detection

    out = {}
    for target in OOD_TARGETS:
        log(f"ood: run_ood_detection({SMOKE_MODEL}, plot_target={target}, "
            "out_datasets=['checkerboard'], report=auroc,aupr,fpr95,auroc_ci)")
        res = run_ood_detection(str(root / "output"), SMOKE_MODEL, plot_target=target,
                                out_datasets=["checkerboard"],
                                report="auroc,aupr,fpr95,auroc_ci")
        auc = res[f"Zscore_{target}"]
        table = root / "output" / SMOKE_MODEL / "ood" / f"ood_scores_{target}.csv"
        if len(auc) != 1 or not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in auc):
            raise PhaseError(f"ood: plot_target={target} gave AUROCs {auc}")
        if not table.is_file():
            raise PhaseError(f"ood: no {table.name}")
        out[target] = {k: v[0] for k, v in res.items() if k != "ood_data"}
    log(json.dumps({"ood": out}))
    return out


# the online scoring service and the sample CLI (phase_serve, phase_sample):
# the serve CLI's flags at the main path's configuration, with a decision
# operating point and a bearer token; 32 concurrent single-image clients
# against a 50 ms batching window
SERVE_TOKEN = "chip-smoke-token"
SERVE_ARGS = [f"--model_name={SMOKE_MODEL}", *MAIN_ARGS, "--flag_fpr=0.05", "--host=127.0.0.1"]
BATCH_WINDOW_MS = 50.0
STATZ_KEYS = {"requests", "images", "sweeps", "device_seconds", "reloads", "mean_sweep_seconds",
              "coalescing_ratio", "mean_served_z_mse", "drift_window", "drift_window_filled",
              "lifetime_mean_z_mse", "flag_fpr", "z_thresholds"}
PROM_NAMES = ("ddpm_ood_requests_total", "ddpm_ood_images_total", "ddpm_ood_sweeps_total",
              "ddpm_ood_reloads_total", "ddpm_ood_device_seconds_total",
              "ddpm_ood_mean_sweep_seconds", "ddpm_ood_coalescing_ratio",
              "ddpm_ood_mean_served_z_mse", "ddpm_ood_drift_window_filled",
              "ddpm_ood_lifetime_mean_z_mse", 'ddpm_ood_z_threshold{target="mse"}')
SERVE_RTOL = 1e-5  # served per-t mse against the scoring CLI's CSV and a fresh service
SERVE_Z_TOL = 1e-4  # served z_score_mse against the offline mean-over-t z


def _http(port: int, path: str, data=None, token=None, headers=None) -> tuple:
    """(status, body bytes) of one request; HTTP errors are returned too."""
    import urllib.error
    import urllib.request

    hdrs = dict(headers or {})
    if token:
        hdrs["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers=hdrs,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npy(arr: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _copy_run(root: Path, name: str) -> Path:
    """A copy of the main phase's run (checkpoint.pth, ood/results_val.csv)
    under root/name/output, which the serve phase may overwrite."""
    import shutil

    src = root / "output" / SMOKE_MODEL
    dst = root / name / "output" / SMOKE_MODEL
    (dst / "ood").mkdir(parents=True)
    shutil.copy2(src / "checkpoint.pth", dst / "checkpoint.pth")
    shutil.copy2(src / "ood" / "results_val.csv", dst / "ood" / "results_val.csv")
    return dst.parent


def _rows(path: Path) -> dict:
    """(filename, t) -> mse of a results CSV."""
    with open(path, newline="") as fh:
        return {(r["filename"], int(r["t"])): float(r["mse"]) for r in csv.DictReader(fh)}


def _serve_parity(dev: torch.device) -> None:
    """fp32 ScoringService on the card against the CPU: the seeded small UNet,
    a 10-step PLMS grid with skip 3, batch 4, the noise passed in, one
    validation table."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram
    from ddpm_ood_tpu_torch.serve import ScoringService

    images = np.random.default_rng(6).uniform(size=(4, 32, 32, 1)).astype(np.float32)

    def host_noise(shape, t_starts):
        return np.random.default_rng(7).standard_normal(shape).astype(np.float32)

    out = {}
    for side, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        model = seeded_unet(0).to(device, memory_format=torch.channels_last).eval()
        prog = ReconProgram(
            sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device),
            model_fn=model, device=device, num_inference_steps=10, inference_skip_factor=3,
            num_groups=2, host_noise_fn=host_noise)
        n = 4 * len(prog.t_starts)
        table = {"filename": np.array([f"v{i % 4}" for i in range(n)], dtype=object),
                 "t": np.repeat(np.asarray(prog.t_starts, np.int64), 4),
                 "mse": 0.1 + 0.01 * (np.arange(n) % 4), "perceptual_difference": np.zeros(n)}
        svc = ScoringService(prog, table, batch_size=4, model_name="parity")
        out[side] = (svc, svc.score(images))
    cpu_svc, cpu = out["cpu"]
    _, card = out["cuda"]
    mse_err = max(abs(c["per_t"][t]["mse"] - r["per_t"][t]["mse"]) / max(r["per_t"][t]["mse"], 1e-6)
                  for c, r in zip(card, cpu) for t in r["per_t"])
    min_sd = min(sd for _, sd in cpu_svc._stats["mse"].values())
    max_mse = max(v["mse"] for r in cpu for v in r["per_t"].values())
    z_tol = FWD_TOL * max_mse / min_sd
    z_err = max(abs(c["z_score_mse"] - r["z_score_mse"]) for c, r in zip(card, cpu))
    log(f"serve: fp32 ScoringService card vs CPU (10-step PLMS, skip 3, batch 4): per-t mse "
        f"max_rel_err={mse_err:.3e} tol={FWD_TOL:.0e}; z_score_mse max_abs_err={z_err:.3e} "
        f"tol={z_tol:.3e} ({FWD_TOL:.0e} x max mse {max_mse:.4f} / min std {min_sd:.4f})")
    if not (math.isfinite(mse_err) and mse_err <= FWD_TOL and math.isfinite(z_err)
            and z_err <= z_tol):
        raise PhaseError(f"the service on the card disagrees with the CPU: {mse_err}, {z_err}")


def _start_serve_cli(root: Path) -> tuple:
    """``python -m ddpm_ood_tpu_torch.serve`` on a copy of the main run, in a
    subprocess; returns (process, port, its output lines so far, the
    perf_counter of its launch)."""
    import threading

    port = _free_port()
    argv = [sys.executable, "-m", "ddpm_ood_tpu_torch.serve",
            f"--output_dir={_copy_run(root, 'serve_cli')}", *SERVE_ARGS, "--device=cuda",
            f"--port={port}"]
    log("serve: " + " ".join(argv[1:]))
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    lines = []
    threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
    return proc, port, lines, time.perf_counter()


def _wait_serve_cli(proc, port: int, lines: list, started: float) -> float:
    """Waits for the CLI's serving line and checks /healthz; returns the
    seconds from launch to the serving line. A failure kills the CLI."""
    try:
        while not any(ln.startswith("serving OOD scores for ") for ln in lines):
            if proc.poll() is not None or time.perf_counter() - started > 300:
                raise PhaseError("serve CLI did not start serving:\n" + "".join(lines[-40:]))
            time.sleep(0.1)
        ready = time.perf_counter() - started
        status, body = _http(port, "/healthz")
        if status != 200 or json.loads(body)["batch_size"] != N_IMAGES:
            raise PhaseError(f"serve CLI /healthz: {status} {body[:200]}")
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return ready


def _sigterm_serve_cli(proc, port: int, lines: list, images: np.ndarray) -> None:
    """SIGTERMs the serving CLI while a POST /score is in flight: the
    response completes with 200 and the process exits 0."""
    import signal
    import threading

    try:
        inflight = {}
        client = threading.Thread(target=lambda: inflight.update(
            result=_http(port, "/score", _npy(images))))
        client.start()
        deadline = time.perf_counter() + 60
        while json.loads(_http(port, "/statz")[1])["requests"] < 1 and client.is_alive():
            if time.perf_counter() > deadline:
                raise PhaseError("serve CLI: the POST /score never arrived")
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        client.join(timeout=300)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    status, body = inflight.get("result", (None, b""))
    scores = json.loads(body).get("scores", []) if status == 200 else []
    log("serve: CLI output: " + " | ".join(ln.strip() for ln in lines
                                            if not ln.startswith(("20", "WARNING"))))
    if status != 200 or len(scores) != len(images) or rc != 0 or \
            not any("shutting down" in ln for ln in lines):
        raise PhaseError(f"serve CLI: SIGTERM during POST /score gave {status} with "
                         f"{len(scores)} scores and exit {rc}:\n" + "".join(lines[-40:]))
    log(f"serve: CLI SIGTERMed during an in-flight POST /score: 200 with {len(scores)} "
        "scores, exit 0")


def phase_serve(dev: torch.device, root: Path) -> dict:
    """The online scoring service on the main phase's run: fp32 card vs CPU;
    the serve CLI's service at full width in this process (first request
    against the scoring CLI's results_in.csv, responses, auth, 413, wrap-pad,
    dynamic batching, hot reload, launch counts, latencies); the real entry
    point in a subprocess, SIGTERMed with a request in flight. Returns the
    in-process launches."""
    import threading

    from ddpm_ood_tpu_torch import serve
    from ddpm_ood_tpu_torch.config import parse_args_serve
    from ddpm_ood_tpu_torch.data.loader import DataLoader
    from ddpm_ood_tpu_torch.data.transforms import TransformChain
    from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
    from ddpm_ood_tpu_torch.ood.score import dedup, read_results_csv, zscore_against_val
    from ddpm_ood_tpu_torch.ops import _kernels
    from ddpm_ood_tpu_torch.trainers.base import BaseTrainer
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    # the in split as the scoring CLI's loader gives it: one batch of 32
    loader = DataLoader(str(root / "in.csv"), N_IMAGES,
                        TransformChain(spatial_dimension=2, is_grayscale=True, image_size=32))
    batch = next(iter(loader))
    images = np.moveaxis(batch["image"], 1, -1)
    stems = [Path(f).stem for f in batch["filename"]]

    # the CLI starts while the parity check and this process's warmup run;
    # it serves before the timed requests, and is SIGTERMed with a request in
    # flight while the fresh service of the reload check scores
    proc, cli_port, cli_lines, cli_started = _start_serve_cli(root)
    try:
        _serve_parity(dev)
        out_dir = _copy_run(root, "serve")
        args = parse_args_serve([f"--output_dir={out_dir}", *SERVE_ARGS, "--device=cuda",
                                 f"--auth_token={SERVE_TOKEN}"])
        reset_launches()
        service = serve.build_service(args)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    cli_ready = _wait_serve_cli(proc, cli_port, cli_lines, cli_started)
    log(f"serve: CLI served after {cli_ready:.1f} s (process start, model, warmup)")
    if not service.warmup_seconds > 0:
        proc.kill()
        raise PhaseError(f"serve: warmup took {service.warmup_seconds} s")
    program = service.program
    per_sweep = sum(len(ts) for ts, _ in program._groups)
    server = serve.make_server(service, "127.0.0.1", 0, auth_token=SERVE_TOKEN)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_port
    batching = serve.BatchingScoringService(service, BATCH_WINDOW_MS)
    flood_server = serve.make_server(batching, "127.0.0.1", 0, auth_token=SERVE_TOKEN)
    threading.Thread(target=flood_server.serve_forever, daemon=True).start()
    try:
        # the first request after warmup: the scoring CLI's first in batch
        t1 = time.perf_counter()
        status, body = _http(port, "/score", _npy(images), SERVE_TOKEN)
        full_latency = time.perf_counter() - t1
        if status != 200:
            raise PhaseError(f"serve: POST /score {status}: {body[:300]}")
        first = json.loads(body)["scores"]
        offline = _rows(root / "output" / SMOKE_MODEL / "ood" / "results_in.csv")
        mse_err = max(abs(rec["per_t"][str(t)]["mse"] - offline[stem, t]) / offline[stem, t]
                      for stem, rec in zip(stems, first) for t in program.t_starts.tolist())
        ood = root / "output" / SMOKE_MODEL / "ood"
        z = zscore_against_val(dedup(read_results_csv(ood / "results_in.csv")),
                               dedup(read_results_csv(ood / "results_val.csv")), ("mse",))
        z_err = max(abs(rec["z_score_mse"] - float(np.mean(z["z_score_mse"][z["filename"] == s])))
                    for s, rec in zip(stems, first))
        log(f"serve: first request ({N_IMAGES} in images) vs the scoring CLI's results_in.csv: "
            f"per-t mse max_rel_err={mse_err:.3e} tol={SERVE_RTOL:.0e}; z_score_mse vs the "
            f"offline mean-over-t z max_abs_err={z_err:.3e} tol={SERVE_Z_TOL:.0e}")
        if not (mse_err <= SERVE_RTOL and z_err <= SERVE_Z_TOL):
            raise PhaseError(f"serve: the first request disagrees with the scoring CLI: "
                             f"{mse_err}, {z_err}")

        # the other responses
        checks = {
            "401 /score without the token": _http(port, "/score", _npy(images[:1]))[0] == 401,
            "401 /statz without the token": _http(port, "/statz")[0] == 401,
            "/healthz open": _http(port, "/healthz")[0] == 200,
        }
        status, body = _http(port, "/statz", token=SERVE_TOKEN)
        checks["/statz keys"] = status == 200 and STATZ_KEYS <= set(json.loads(body))
        status, body = _http(port, "/metricz", token=SERVE_TOKEN)
        samples = {ln.rsplit(" ", 1)[0] for ln in body.decode().splitlines()
                   if not ln.startswith("#")}
        checks["/metricz lines"] = status == 200 and set(PROM_NAMES) <= samples
        status, body = _http(port, "/score", b"x", SERVE_TOKEN,
                             {"Content-Length": str(service.max_body_bytes + 1)})
        checks["413 on an oversized Content-Length"] = status == 413
        log(f"serve: responses {checks}")
        if not all(checks.values()):
            raise PhaseError(f"serve: wrong responses: {checks}")

        # dynamic batching: 32 concurrent single-image clients
        sweeps = service.stats["sweeps"]
        results, sizes = [None] * N_IMAGES, []
        score = service.score
        service.score = lambda imgs: (sizes.append(len(imgs)), score(imgs))[1]

        def one(i):
            results[i] = _http(flood_server.server_port, "/score", _npy(images[i: i + 1]),
                               SERVE_TOKEN)

        clients = [threading.Thread(target=one, args=(i,)) for i in range(N_IMAGES)]
        t1 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        flood_wall = time.perf_counter() - t1
        del service.score
        flood_sweeps = service.stats["sweeps"] - sweeps
        ok = sum(1 for r in results if r is not None and r[0] == 200
                 and len(json.loads(r[1])["scores"]) == 1)
        log(f"serve: {N_IMAGES} concurrent single-image clients, {BATCH_WINDOW_MS:.0f} ms window: "
            f"{ok} x 200 in {flood_sweeps} sweeps of {sizes} images, wall {flood_wall:.3f} s, "
            f"{N_IMAGES / flood_wall:.2f} reqs/s")
        if ok != N_IMAGES or flood_sweeps > 2:
            raise PhaseError(f"serve: flood {ok}/{N_IMAGES} ok in {flood_sweeps} sweeps")

        # hot reload of a new checkpoint.pth: in place, no kernel build
        save_checkpoint(out_dir / SMOKE_MODEL / "checkpoint.pth", seeded_unet(1).state_dict())
        # every launch looks the library up (a cache hit); a build or a
        # load would be a miss
        misses = _kernels.library.cache_info().misses
        lib_mtime = _kernels.LIB_PATH.stat().st_mtime_ns
        model_fn = program.model_fn
        status, body = _http(port, "/reload", b"", SERVE_TOKEN)
        if status != 200:
            raise PhaseError(f"serve: POST /reload {status}: {body[:300]}")
        # one image after the reload: wrap-padded to the batch, and timed
        noise_state = service.generator.get_state()
        t1 = time.perf_counter()
        status, body = _http(port, "/score", _npy(images[:1]), SERVE_TOKEN)
        single_latency = time.perf_counter() - t1
        reloaded = json.loads(body)["scores"] if status == 200 else []
        if len(reloaded) != 1:
            raise PhaseError(f"serve: one image after the reload: {status} {body[:300]}")
        cli_done = {}

        def sigterm_cli():
            try:
                _sigterm_serve_cli(proc, cli_port, cli_lines, images)
            except BaseException as e:  # re-raised after the fresh service's check
                cli_done["error"] = e

        cli_thread = threading.Thread(target=sigterm_cli)
        cli_thread.start()
        fresh_trainer = BaseTrainer(args, dev)
        fresh = serve.ScoringService(
            serve.build_recon_program(fresh_trainer, args, perceptual_fn=PerceptualLoss(
                spatial_dims=2).to(dev).eval()),
            dedup(read_results_csv(out_dir / SMOKE_MODEL / "ood" / "results_val.csv")),
            N_IMAGES)
        fresh.generator.set_state(noise_state)
        want = fresh.score(images[:1])
        cli_thread.join()
        if "error" in cli_done:
            raise cli_done["error"]
        fresh_err = max(abs(a["per_t"][str(t)]["mse"] - b["per_t"][t]["mse"]) / b["per_t"][t]["mse"]
                        for a, b in zip(reloaded, want) for t in b["per_t"])
        changed = sum(a["z_score_mse"] != b["z_score_mse"] for a, b in zip(reloaded, first))
        rebuilt = (_kernels.library.cache_info().misses != misses
                   or _kernels.LIB_PATH.stat().st_mtime_ns != lib_mtime)
        reloads = json.loads(_http(port, "/statz", token=SERVE_TOKEN)[1])["reloads"]
        log(f"serve: POST /reload -> {reloads} "
            f"reload(s); one image, wrap-padded, {single_latency:.2f} s: z_score_mse changed "
            f"{bool(changed)}; vs a fresh service on the new "
            f"checkpoint, same noise: per-t mse max_rel_err={fresh_err:.3e} tol={SERVE_RTOL:.0e}; "
            f"kernel library rebuilt or reloaded: {rebuilt}")
        if status != 200 or not changed or fresh_err > SERVE_RTOL or rebuilt \
                or program.model_fn != model_fn or service.program is not program:
            raise PhaseError(f"serve: reload: {status}, {changed} changed, {fresh_err}, "
                             f"rebuilt {rebuilt}")
        torch.cuda.synchronize()
        launches = read_launches()
        stats = serve.collect_stats(service)
    finally:
        for s in (server, flood_server):
            s.shutdown()
            s.server_close()
        batching.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    sweeps = 1 + int(stats["sweeps"]) + int(fresh.stats["sweeps"])  # warmup, served, fresh
    if program.model_evals != per_sweep * stats["sweeps"]:
        raise PhaseError(f"serve: {program.model_evals} forwards in {stats['sweeps']} sweeps")
    _check_launches(launches, per_sweep * sweeps, "serve", bf16=True)
    log(f"serve: {sweeps} sweeps of {per_sweep} UNet forwards ({GN_PER_FORWARD} GroupNorm on the "
        f"cluster kernel and {ATTN_PER_FORWARD} flash forwards on tensor cores each); "
        f"launches {launches}")
    summary = {"full_batch_latency_s": full_latency, "single_image_latency_s": single_latency,
               "flood_wall_s": flood_wall, "flood_reqs_per_s": N_IMAGES / flood_wall,
               "flood_sweeps": flood_sweeps, "flood_sweep_images": sizes,
               "mean_sweep_seconds": stats["mean_sweep_seconds"],
               "warmup_s": service.warmup_seconds, "cli_ready_s": cli_ready, "card": CARD}
    log(json.dumps({"serve": summary}))
    log(f"serve: phase took {time.perf_counter() - t0:.1f} s")
    return launches


SAMPLE_ARGS = [f"--model_name={SMOKE_MODEL}", "--model_type=small", "--image_size=32",
               "--is_grayscale=1", "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015",
               "--beta_end=0.0195", "--device=cuda"]
# (sampler, steps, samples, UNet forwards) of the sample CLI runs
SAMPLE_RUNS = (("dpm", 25, 32, 25), ("ddpm", 100, 8, 1000))


def phase_sample(dev: torch.device, root: Path) -> dict:
    """The three single-trajectory denoisers fp32 card vs CPU, then the sample
    CLI at full width on the main phase's checkpoint. Returns its launches."""
    from ddpm_ood_tpu_torch import sample as cli
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule

    t0 = time.perf_counter()
    noise = np.random.default_rng(8).standard_normal((4, 32, 32, 1)).astype(np.float32)
    outs = {}
    for side, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        model = seeded_unet(0).to(device, memory_format=torch.channels_last).eval()
        sched = make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device)

        def model_fn(x, t, model=model):
            return model(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)

        with torch.no_grad():
            for name, (make_ts, denoise) in cli.GRID_SAMPLERS.items():
                ts = make_ts(1000, 10)
                outs[side, name] = denoise(sched, model_fn, torch.from_numpy(noise).to(device),
                                           ts, int(ts[0]), 10).cpu()
    errs = {}
    for name in cli.GRID_SAMPLERS:
        ref = outs["cpu", name]
        scale = max(1.0, ref.abs().max().item())
        errs[name] = (outs["cuda", name] - ref).abs().max().item() / scale
    log(f"sample: fp32 denoisers card vs CPU (10-step grids from ts[0], B = 4) rel_err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" tol={FWD_TOL:.0e}")
    if not all(math.isfinite(e) and e <= FWD_TOL for e in errs.values()):
        raise PhaseError(f"a denoiser on the card disagrees with the CPU: {errs}")

    total = {}
    for sampler, steps, n, forwards in SAMPLE_RUNS:
        argv = [f"--output_dir={root / 'output'}", *SAMPLE_ARGS, f"--sampler={sampler}",
                f"--num_inference_steps={steps}", f"--n_samples={n}",
                f"--out={root / 'samples'}"]
        log("sample: python -m ddpm_ood_tpu_torch.sample " + " ".join(argv))
        reset_launches()
        t1 = time.perf_counter()
        path = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches = read_launches()
        _check_launches(launches, forwards, f"sample CLI {sampler}", bf16=True)
        arr = np.load(path)
        if arr.shape != (n, 32, 32, 1) or not np.isfinite(arr).all() or \
                arr.min() < 0.0 or arr.max() > 1.0:
            raise PhaseError(f"sample CLI {sampler}: {arr.shape}, range "
                             f"[{arr.min()}, {arr.max()}]")
        log(f"sample: {sampler}, {n} samples, {forwards} UNet forwards: {secs:.2f} s "
            f"({n / secs:.2f} samples/s) -> {path.name}, mean {float(arr.mean()):.4f}; "
            f"card {CARD}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    log(f"sample: phase took {time.perf_counter() - t0:.1f} s")
    return total


# the samplers' scoring path: DPM-Solver++ on the 25-step grid, every start
# point, with the likelihood column; the rest of MAIN_ARGS as the main path
SAMPLER_ARGS = ["--sampler=dpm", "--num_inference_steps=25", "--inference_skip_factor=1",
                "--score_elbo=1"]
SAMPLER_COLUMNS = ("mse", "perceptual_difference", "elbo")
# (sampler, with the ELBO table) held card against CPU on the fp32 small UNet
SAMPLER_PROGRAMS = (("ddim", True), ("dpm", True), ("plms_ref", False), ("plms", True))


def _check_launches(launches: dict, evals: int, what: str, bf16: bool,
                    large_per_forward: int = 0) -> None:
    """27 GroupNorms and 4 flash forwards per UNet forward and no backward;
    in bf16 `large_per_forward` GroupNorms a forward on the large-sample
    kernel, the others on the cluster kernel, and every flash forward on
    tensor cores."""
    want = {"groupnorm_act": GN_PER_FORWARD * evals,
            "flash_attention_fwd": ATTN_PER_FORWARD * evals}
    if bf16:
        want.update(groupnorm_act_cluster=(GN_PER_FORWARD - large_per_forward) * evals,
                    groupnorm_act_large=large_per_forward * evals,
                    flash_attention_fwd_tc=ATTN_PER_FORWARD * evals)
    got = {k: launches[k] for k in want}
    backward = {k: v for k, v in launches.items() if "bwd" in k and v}
    if got != want or backward:
        raise PhaseError(f"{what}: {evals} UNet forwards launched {launches}, expected {want} "
                         "and no backward kernel")


def phase_samplers(dev: torch.device, root: Path) -> dict:
    """The other samplers and the ELBO score: each sampler's fp32 small-UNet
    program (10-step grid, noise passed in) card against CPU, with the launch
    counts per forward; the quality gate's tiny UNet at 16x16 (forward and an
    fp32 training step); then the scoring CLI with DPM-Solver++ at full width
    and the elbo AUROCs on its CSVs."""
    from ddpm_ood_tpu_torch import reconstruct as cli
    from ddpm_ood_tpu_torch.diffusion.ddim import ddim_timesteps
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.ood import run_ood_detection
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram, group_t_starts
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    models = {"cpu": seeded_unet(1).to(memory_format=torch.channels_last).eval(),
              "cuda": seeded_unet(1).to(dev, memory_format=torch.channels_last).eval()}
    rng = np.random.default_rng(4)
    images = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)

    def host_noise(shape, t_starts):
        return np.random.default_rng(5).standard_normal(shape).astype(np.float32)

    for sampler, elbo in SAMPLER_PROGRAMS:
        tables = {}
        for side, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            prog = ReconProgram(
                sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device),
                model_fn=models[side], device=device, num_inference_steps=10,
                inference_skip_factor=3, num_groups=2, sampler=sampler, score_elbo=elbo,
                host_noise_fn=host_noise)
            reset_launches()
            out = prog(images)
            torch.cuda.synchronize()
            if side == "cuda":
                _check_launches(read_launches(), prog.model_evals, f"{sampler} program",
                                bf16=False)
            tables[side] = {"mse": out[1].cpu(), **({"elbo": out[3].cpu()} if elbo else {})}
        errs = {name: ((tables["cuda"][name] - ref).abs() / ref.abs().clamp_min(1e-6)).max().item()
                for name, ref in tables["cpu"].items()}
        log(f"samplers: {sampler} (K, B) = {tuple(tables['cpu']['mse'].shape)}, "
            f"{prog.model_evals} forwards, fp32 card vs CPU max_rel_err "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" tol={FWD_TOL:.0e}; {GN_PER_FORWARD} GroupNorm and {ATTN_PER_FORWARD} flash "
            "launches per forward")
        if not all(math.isfinite(e) and e <= FWD_TOL for e in errs.values()):
            raise PhaseError(f"{sampler} program on the card disagrees with the CPU: {errs}")

    # the quality gate's model: the tiny preset at 16x16, its GroupNorm shapes
    # (C = 32, 64, 96, 128) and 16-token attention, forward and training step
    tiny = {"cpu": seeded_unet(3, "tiny").to(memory_format=torch.channels_last).eval(),
            "cuda": seeded_unet(3, "tiny").to(dev, memory_format=torch.channels_last).eval()}
    x = torch.from_numpy(rng.standard_normal((8, 1, 16, 16), dtype=np.float32))
    t = torch.tensor([0, 10, 40, 200, 500, 700, 960, 999])
    with torch.no_grad():
        ref = tiny["cpu"](x.to(memory_format=torch.channels_last), t)
        reset_launches()
        got = tiny["cuda"](x.to(dev, memory_format=torch.channels_last), t.to(dev)).cpu()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got16 = tiny["cuda"](x.to(dev, memory_format=torch.channels_last), t.to(dev)).cpu()
        torch.cuda.synchronize()
    _check_launches(read_launches(), 2, "tiny UNet forwards", bf16=False)
    scale = max(1.0, ref.abs().max().item())
    err, err16 = ((g - ref).abs().max().item() / scale for g in (got, got16))
    log(f"samplers: tiny UNet 16x16 forward fp32 card vs CPU rel_err={err:.3e} "
        f"tol={FWD_TOL:.0e}; bf16 autocast vs CPU fp32 rel_err={err16:.3e} (reported)")
    if not (math.isfinite(err) and err <= FWD_TOL and math.isfinite(err16)):
        raise PhaseError(f"tiny UNet forward on the card disagrees with the CPU: {err}")
    phase_train_step(dev, "tiny", 16)

    # the scoring CLI with DPM-Solver++ and the ELBO, at full width
    out_root = root / "output_samplers"
    (out_root / SMOKE_MODEL).mkdir(parents=True)
    save_checkpoint(out_root / SMOKE_MODEL / "checkpoint.pth", seeded_unet(0).state_dict())
    argv = [f"--output_dir={out_root}", f"--model_name={SMOKE_MODEL}",
            f"--validation_ids={root / 'val.csv'}", f"--in_ids={root / 'in.csv'}",
            f"--out_ids={root / 'checkerboard_test.csv'}", "--device=cuda", *MAIN_ARGS,
            *SAMPLER_ARGS]
    log("samplers: python -m ddpm_ood_tpu_torch.reconstruct " + " ".join(argv))
    reset_launches()
    t1 = time.perf_counter()
    recon = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_launches()
    ts = ddim_timesteps(1000, 25)
    t_starts = pndm_start_points(ts, 1)
    groups = group_t_starts(ts, t_starts, 16)
    per_batch = sum(len(s) for s, _ in groups) + len(groups)  # the sweep, then one ELBO call
    evals = sum(p.model_evals for p in recon._programs.values())
    log(f"samplers: {evals} UNet forwards ({per_batch} per batch of {N_IMAGES}: "
        f"{per_batch - len(groups)} sweep + {len(groups)} ELBO, 3 batches); launches {launches}")
    if evals != 3 * per_batch:
        raise PhaseError(f"dpm sweep made {evals} UNet forwards, expected {3 * per_batch}")
    _check_launches(launches, evals, "dpm scoring CLI", bf16=True)
    for name in ("val", "in", "checkerboard"):
        _check_csv(recon.out_dir / f"results_{name}.csv", t_starts, SAMPLER_COLUMNS)
    n_warm = sum(n for n, _ in recon.batch_times[1:])
    s_warm = sum(s for _, s in recon.batch_times[1:])
    n_all = sum(n for n, _ in recon.batch_times)
    s_all = sum(s for _, s in recon.batch_times)
    log(f"samplers: batches (recons, s) = {[(n, round(s, 3)) for n, s in recon.batch_times]}")
    log(f"samplers: dpm@25/1 + elbo {n_all / s_all:.2f} recons/s over all "
        f"{len(recon.batch_times)} batches; {n_warm / s_warm:.2f} over batches 2-"
        f"{len(recon.batch_times)}; {per_batch} model_evals per batch; CLI wall {wall:.1f} s; "
        f"card {CARD}")
    aucs = {}
    for target in ("elbo", "mse+elbo"):
        res = run_ood_detection(str(out_root), SMOKE_MODEL, plot_target=target,
                                out_datasets=["checkerboard"], report="auroc,aupr,fpr95,auroc_ci")
        auc = res[f"Zscore_{target}"]
        if len(auc) != 1 or not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in auc):
            raise PhaseError(f"samplers: plot_target={target} gave AUROCs {auc}")
        aucs[target] = {k: v[0] for k, v in res.items() if k != "ood_data"}
    log(json.dumps({"samplers": {"recons_per_s": n_all / s_all,
                                 "recons_per_s_warm": n_warm / s_warm,
                                 "model_evals_per_batch": per_batch, "ood": aucs,
                                 "card": CARD}}))
    log(f"samplers: phase took {time.perf_counter() - t0:.1f} s")
    return launches


# the latent diffusion path: the reference's Decathlon recipe (docs/RUNBOOK.md,
# 3D LDM): 128^3 x 1 volumes, a VQ-VAE of four 256-channel levels with three
# residual units each and 2048 codes of width 128 (8x8x8 latents), and the
# small UNet in 3D on the latents; weights seeded, scoring batch cut from 32
# to LDM_BATCH
LDM_VQVAE = dict(spatial_dims=3, in_channels=1, out_channels=1, num_res_layers=3,
                 downsample_parameters=[[2, 4, 1, 1]] * 4,
                 upsample_parameters=[[2, 4, 1, 1, 0]] * 4, num_channels=[256] * 4,
                 num_res_channels=[256] * 4, num_embeddings=2048, embedding_dim=128,
                 decay=0.9, commitment_cost=0.25, epsilon=1e-5, dropout=0.0, ddp_sync=True)
LDM_SIZE, LDM_BATCH, LDM_MODEL = 128, 2, "smoke_decathlon"
LDM_ARGS = ["--spatial_dimension=3", "--model_type=small", "--image_roi=[160,160,128]",
            f"--image_size={LDM_SIZE}", "--is_grayscale=1", "--prediction_type=epsilon",
            "--beta_schedule=scaled_linear_beta",
            "--beta_start=0.0015", "--beta_end=0.0195", "--b_scale=1.0"]
# (PLMS on the reference recipe's skip factor over a grid of 50, not 100,
# steps: half the forwards; the BraTS-ROI phase runs the 100-step grid)
LDM_GRIDS = (("plms", ["--num_inference_steps=50", "--inference_skip_factor=2"]),
             ("dpm", ["--sampler=dpm", "--num_inference_steps=25",
                      "--inference_skip_factor=1"]))
# the fp32 card-vs-CPU checks run the VQ-VAE on 32^3 volumes (2^3 latents,
# padded to 4^3), which keeps the CPU's side to about a minute
LDM_CHECK_SIZE, LDM_CHECK_PAD = 32, (1, 1, 1, 1, 1, 1)
# quantizer indices, card vs CPU: equal wherever the CPU's float64 runner-up
# distance exceeds the best by more than this share of the largest distance
# (fp32 distances of ~1e2 round differently on the two by ~1e-5)
TIE_MARGIN = 1e-5


def _ldm_vqvae(seed: int = 0, config: dict = LDM_VQVAE):
    """The seeded Decathlon VQ-VAE (or one of `config`), on the CPU, in eval
    mode."""
    from ddpm_ood_tpu_torch.models.vqvae import VQVAE

    torch.manual_seed(seed)
    vq = VQVAE(**config).eval()
    # the default init decodes to values about 0.1 wide just below 0, which
    # the clip to [0, 1] before the metrics flattens to 0: spread them 8x and
    # centre them inside (0, 1), so the scores depend on what was decoded
    with torch.no_grad():
        last = vq.decoder.blocks[-1].conv
        last.weight.mul_(8.0)
        last.bias.fill_(0.37)
    return vq


def _ldm_models(seed: int = 0):
    """The seeded Decathlon VQ-VAE and 3D small UNet, on the CPU."""
    from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_

    vq = _ldm_vqvae(seed)
    unet = random_init_(make_unet("small", 3, 128, 128), torch.Generator().manual_seed(seed))
    return vq, unet.eval()


def _volumes(n: int, size, ood: bool, rng) -> np.ndarray:
    """(n, 1, size, size, size) volumes, or (n, 1, *size) for a tuple:
    smooth 3D sine fields, or 3D checkerboards of 4-voxel cells."""
    shape = (size,) * 3 if isinstance(size, int) else tuple(size)
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    out = []
    for i in range(n):
        if ood:
            v = (((xx // 4) + (yy // 4) + (zz // 4) + i) % 2).astype(np.float32)
        else:
            phase = rng.uniform(0, 2 * np.pi)
            v = 0.5 + 0.5 * np.sin(2 * np.pi * (zz / shape[0] + yy / shape[1] + xx / shape[2])
                                   + phase)
        out.append(v.astype(np.float32)[None])
    return np.stack(out)


def _near_ties(z: np.ndarray, codebook: np.ndarray, margin: float) -> np.ndarray:
    """(positions,) mask of latent vectors whose two nearest codes lie within
    `margin` of the largest distance of each other, in float64."""
    flat = z.reshape(-1, z.shape[-1]).astype(np.float64)
    e = codebook.astype(np.float64)
    d = (flat ** 2).sum(1)[:, None] - 2 * flat @ e.T + (e ** 2).sum(1)[None]
    part = np.partition(d, 1, axis=1)
    return (part[:, 1] - part[:, 0]) <= margin * np.abs(d).max()


class _DeviceTimer:
    """Device seconds of wrapped calls, from CUDA events recorded around each
    (no synchronisation until ``seconds``)."""

    def __init__(self):
        self.events = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def seconds(self) -> dict:
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in ev) / 1e3
                for name, ev in self.events.items()}


def phase_ldm_pieces(dev: torch.device, npz: Path) -> None:
    """fp32, TF32 off, card against CPU at full channel widths: the 3D small
    UNet on 8^3 x 128 latents, the Decathlon VQ-VAE's encode, quantizer and
    decode on 32^3 volumes, and the latent ReconProgram on a 10-step grid
    with the noise passed in (MSE and LPIPS tables)."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
    from ddpm_ood_tpu_torch.models.unet import memory_format
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram

    t0 = time.perf_counter()
    vq, unet = _ldm_models()
    fmt = memory_format(3)
    models = {"cpu": (vq.to(memory_format=fmt), unet.to(memory_format=fmt))}
    vq_card, unet_card = _ldm_models()
    models["cuda"] = (vq_card.to(dev, memory_format=fmt), unet_card.to(dev, memory_format=fmt))
    rng = np.random.default_rng(6)

    x = torch.from_numpy(rng.standard_normal((2, 128, 8, 8, 8), dtype=np.float32))
    t = torch.tensor([20, 900])
    with torch.no_grad():
        ref = models["cpu"][1](x.to(memory_format=fmt), t)
        reset_launches()
        got = models["cuda"][1](x.to(dev, memory_format=fmt), t.to(dev)).cpu()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got16 = models["cuda"][1](x.to(dev, memory_format=fmt), t.to(dev)).cpu()
        torch.cuda.synchronize()
    _check_launches(read_launches(), 2, "3D small UNet forwards", bf16=False)
    scale = max(1.0, ref.abs().max().item())
    err, err16 = ((g - ref).abs().max().item() / scale for g in (got, got16))
    log(f"ldm: 3D small UNet (2, 128, 8, 8, 8) forward fp32 card vs CPU rel_err={err:.3e} "
        f"tol={FWD_TOL:.0e}; bf16 autocast vs CPU fp32 rel_err={err16:.3e} (reported); "
        f"{GN_PER_FORWARD} GroupNorm and {ATTN_PER_FORWARD} flash launches per forward")
    if not (math.isfinite(err) and err <= FWD_TOL and math.isfinite(err16)):
        raise PhaseError(f"3D UNet forward on the card disagrees with the CPU: {err}")

    size = LDM_CHECK_SIZE
    vols = torch.from_numpy(_volumes(2, size, False, rng))
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    with torch.no_grad():
        z = {side: models[side][0].encode(vols.to(d, memory_format=fmt)).cpu()
             for side, d in devices.items()}
        # the quantizer and the decoder both take the CPU's latents
        q = {side: models[side][0].quantizer(z["cpu"].to(d, memory_format=fmt))
             for side, d in devices.items()}
        codes = {side: v[2].cpu().reshape(-1) for side, v in q.items()}
        dec = {side: models[side][0].decode(q["cpu"][0].to(d, memory_format=fmt)).cpu()
               for side, d in devices.items()}
    err_z = (z["cuda"] - z["cpu"]).abs().max().item() / z["cpu"].abs().max().item()
    err_dec = (dec["cuda"] - dec["cpu"]).abs().max().item() / dec["cpu"].abs().max().item()
    codebook = vq.quantizer.quantizer.embedding.weight.detach().numpy()
    ties = _near_ties(z["cpu"].movedim(1, -1).numpy(), codebook, TIE_MARGIN)
    clear = torch.from_numpy(~ties)
    same = (codes["cuda"] == codes["cpu"])
    log(f"ldm: Decathlon VQ-VAE on (2, 1, {size}, {size}, {size}) fp32 card vs CPU: encoder "
        f"rel_err={err_z:.3e}, decoder (on the CPU's quantized latents) rel_err={err_dec:.3e}, "
        f"tol={FWD_TOL:.0e}; quantizer indices equal at {int(same.sum())} of {same.numel()} "
        f"positions, {int(ties.sum())} within {TIE_MARGIN:.0e} of a tie (held equal outside)")
    if not (err_z <= FWD_TOL and err_dec <= FWD_TOL and bool(same[clear].all())):
        raise PhaseError(f"VQ-VAE on the card disagrees with the CPU: encoder {err_z}, decoder "
                         f"{err_dec}, {int((~same[clear]).sum())} indices differ outside ties")

    def host_noise(shape, t_starts):
        return np.random.default_rng(7).standard_normal(shape).astype(np.float32)

    # each side's sweep latents (un-padded) and decoded volumes (before / b_scale
    # and the clip to [0, 1], which saturates the seeded decoder's outputs and
    # would hide a wrong decode from the MSE table), one lane per decode call
    tables, latents, decoded = {}, {}, {}
    for side, device in devices.items():
        v, u = models[side]

        def decode(zz, v=v, side=side):
            latents.setdefault(side, []).append(zz.cpu())
            out = v.decode_stage_2_outputs(zz.movedim(-1, 1)).movedim(1, -1)
            decoded.setdefault(side, []).append(out.cpu())
            return out

        prog = ReconProgram(
            sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device),
            model_fn=u, device=device, num_inference_steps=10, inference_skip_factor=3,
            num_groups=2, host_noise_fn=host_noise,
            encode_fn=lambda xx, v=v: v.encode_stage_2_inputs(xx.movedim(-1, 1)).movedim(1, -1),
            decode_fn=decode, latent_pad=LDM_CHECK_PAD,
            perceptual_fn=PerceptualLoss(weights_path=str(npz), spatial_dims=3).to(device))
        out = prog(vols.movedim(1, -1).numpy())
        tables[side] = {"mse": out[1].cpu(), "perceptual_difference": out[2].cpu()}
    k = len(prog.t_starts)
    lat = {side: torch.stack(v) for side, v in latents.items()}  # (K, B, *latent, E)
    dec = {side: torch.stack(v) for side, v in decoded.items()}  # (K, B, *spatial, 1)
    if lat["cpu"].shape[:2] != (k, 2) or dec["cpu"].shape != (k, 2) + (size,) * 3 + (1,):
        raise PhaseError(f"latent ReconProgram decoded {tuple(lat['cpu'].shape)} latents into "
                         f"{tuple(dec['cpu'].shape)} volumes, not {k} lanes of 2")
    # an image whose encoding holds a tie may take another code on each side,
    # and then a lane's sweep starts elsewhere; a lane whose swept latents hold
    # one may decode another code
    image_ties = torch.from_numpy(ties.reshape(2, -1).any(-1))
    entry_ties = torch.from_numpy(
        _near_ties(lat["cpu"].numpy(), codebook, TIE_MARGIN).reshape(k, 2, -1).any(-1))
    keep = ~(entry_ties | image_ties[None])
    if not keep.any():
        raise PhaseError(f"latent ReconProgram: every (lane, image) entry holds a near-tie "
                         f"({int(entry_ties.sum())} of the sweep, {int(image_ties.sum())} "
                         "images of the encoding)")
    lat_keep = ~image_ties[None].expand(k, 2)
    errs = {  # the volumes relative to their largest |value|, the tables entry by entry
        "latents": ((lat["cuda"] - lat["cpu"])[lat_keep].abs().max()
                    / lat["cpu"][lat_keep].abs().max()).item(),
        "decoded (before the clip)": ((dec["cuda"] - dec["cpu"])[keep].abs().max()
                                      / dec["cpu"][keep].abs().max()).item(),
        **{n: ((tables["cuda"][n] - want).abs() / want.abs().clamp_min(1e-6))[keep].max().item()
           for n, want in tables["cpu"].items()}}
    inside = ((dec["cpu"] > 0) & (dec["cpu"] < 1)).float().mean().item()
    finite = all(bool(torch.isfinite(t).all()) for tab in tables.values() for t in tab.values())
    log(f"ldm: latent ReconProgram (plms 10/3, latent_pad {LDM_CHECK_PAD}, (K, B) = ({k}, 2)) "
        f"fp32 card vs CPU max_rel_err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" tol={FWD_TOL:.0e} over {int(keep.sum())} of {keep.numel()} (lane, image) entries "
        f"(the latents over all lanes of {int((~image_ties).sum())} of 2 images); "
        f"{int(entry_ties.sum())} hold a near-tie of the re-quantization, "
        f"{int(image_ties.sum())} images one of the encoding (held finite only); "
        f"{inside:.1%} of the decoded voxels lie inside (0, 1)")
    if not (finite and all(math.isfinite(e) and e <= FWD_TOL for e in errs.values())):
        raise PhaseError(f"latent ReconProgram on the card disagrees with the CPU: {errs}")
    if inside < 0.5:
        raise PhaseError(f"only {inside:.1%} of the decoded voxels lie inside (0, 1): the clip "
                         "flattens the rest, and the MSE and LPIPS tables hold little")
    log(f"ldm: card-vs-CPU checks took {time.perf_counter() - t0:.1f} s")


def _write_volumes(root: Path, name: str, n: int, ood: bool, rng, size=LDM_SIZE) -> Path:
    """n LDM_SIZE^3 volumes (or of `size`, ``_volumes``) as .npy and their
    single-row split CSV."""
    (root / name).mkdir(parents=True)
    paths = []
    for i, v in enumerate(_volumes(n, size, ood, rng)):
        paths.append(str(root / name / f"{name}_{i}.npy"))
        np.save(paths[-1], v)
    (root / f"{name}.csv").write_text(",".join(paths))
    return root / f"{name}.csv"


def _scalars(path: Path) -> dict:
    """{tag: [values in step order]} of a Logger's scalars.jsonl."""
    out = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], []).append(rec["value"])
    return out


def _ldm_cli(argv: list):
    """One latent scoring CLI run in this process with its program's encode,
    UNet, decode and metrics tail timed between CUDA events (a span holds
    the device's idle time between its events too); returns (Reconstruct,
    launches, event seconds by part, wall seconds, peak GiB)."""
    from ddpm_ood_tpu_torch import reconstruct as cli
    from ddpm_ood_tpu_torch.recon import sweep as sweep_mod

    args = cli.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    recon = cli.Reconstruct(args, cli.resolve_device(args.device))
    prog = recon._program(args.inference_skip_factor)
    timer = _DeviceTimer()
    prog.encode_fn = timer.wrap("encode", prog.encode_fn)
    prog.decode_fn = timer.wrap("decode", prog.decode_fn)
    prog.model_fn = timer.wrap("unet", prog.model_fn)
    tail = sweep_mod.metrics_tail
    sweep_mod.metrics_tail = timer.wrap("metrics_tail", tail)
    try:
        recon.reconstruct(args)
    finally:
        sweep_mod.metrics_tail = tail
    parts = timer.seconds()
    wall = time.perf_counter() - t0
    return recon, read_launches(), parts, wall, torch.cuda.max_memory_allocated() / 2**30


def phase_ldm(dev: torch.device, root: Path, batch: int = LDM_BATCH) -> dict:
    """The scoring CLI on a 3D latent diffusion model at the Decathlon
    geometry: PLMS 50/2 and DPM-Solver++ 25/1, LPIPS from the npz, SSIM and
    error maps, on `batch` volumes in each of the val, in and out sets (one
    batch each); then run_ood_detection on the CSVs."""
    from ddpm_ood_tpu_torch.diffusion.ddim import ddim_timesteps
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.ood import run_ood_detection
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts
    from ddpm_ood_tpu_torch.serve import resolve_recon_groups
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    ldm = root / "ldm"
    rng = np.random.default_rng(8)
    csvs = {name: _write_volumes(ldm, name, batch, ood, rng)
            for name, ood in (("val", False), ("in", False), ("Task02_Heart_test", True))}
    vq, unet = _ldm_models()
    (ldm / "vqvae").mkdir()
    save_checkpoint(ldm / "vqvae" / "checkpoint.pth", vq.state_dict())
    (ldm / "vqvae" / "vqvae_config.json").write_text(json.dumps(LDM_VQVAE))
    launches = {}
    for sampler, grid in LDM_GRIDS:
        out = ldm / f"output_{sampler}"
        (out / LDM_MODEL).mkdir(parents=True)
        save_checkpoint(out / LDM_MODEL / "checkpoint.pth", unet.state_dict())
        argv = [f"--output_dir={out}", f"--model_name={LDM_MODEL}",
                f"--vqvae_checkpoint={ldm / 'vqvae' / 'checkpoint.pth'}",
                f"--validation_ids={csvs['val']}", f"--in_ids={csvs['in']}",
                f"--out_ids={csvs['Task02_Heart_test']}", "--device=cuda", *LDM_ARGS,
                f"--batch_size={batch}", *grid, "--score_ssim=1", "--save_error_maps=1"]
        log("ldm: python -m ddpm_ood_tpu_torch.reconstruct " + " ".join(argv))
        recon, counts, parts, wall, peak = _ldm_cli(argv)
        for name, value in counts.items():
            launches[name] = launches.get(name, 0) + value
        steps = int(grid[-2].split("=")[1])
        ts = (pndm_timesteps if sampler == "plms" else ddim_timesteps)(1000, steps)
        t_starts = pndm_start_points(ts, int(grid[-1].split("=")[1]))
        groups = group_t_starts(ts, t_starts, resolve_recon_groups("auto", 3))
        evals = sum(p.model_evals for p in recon._programs.values())
        want = 3 * sum(len(s) for s, _ in groups)  # val, in, out: one batch each
        log(f"ldm: {sampler} {evals} UNet forwards (expected {want}, {len(groups)} lane "
            f"groups); launches {counts}")
        if evals != want:
            raise PhaseError(f"ldm {sampler}: {evals} UNet forwards, expected {want}")
        _check_launches(counts, evals, f"ldm {sampler} scoring CLI", bf16=True)
        for name in ("val", "in", "Task02"):
            _check_csv(recon.out_dir / f"results_{name}.csv", t_starts, n_images=batch)
            maps = sorted((recon.out_dir / "error_maps" / name).glob("*.npy"))
            arrays = [np.load(m) for m in maps]
            if len(maps) != batch or any(a.shape != (LDM_SIZE,) * 3 + (1,)
                                         or not np.isfinite(a).all() for a in arrays):
                raise PhaseError(f"ldm error_maps/{name}: {len(maps)} maps, expected "
                                 f"{batch} finite {(LDM_SIZE,) * 3 + (1,)} ones")
        n_all = sum(n for n, _ in recon.batch_times)
        s_all = sum(s for _, s in recon.batch_times)
        n_warm = sum(n for n, _ in recon.batch_times[1:])
        s_warm = sum(s for _, s in recon.batch_times[1:])
        split = {k: round(v, 3) for k, v in parts.items()}
        log(f"ldm: {sampler} batches (latent recons, s) = "
            f"{[(n, round(s, 3)) for n, s in recon.batch_times]}")
        log(f"ldm: {sampler} {n_all / s_all:.3f} latent-recons/s over all "
            f"{len(recon.batch_times)} batches, {n_warm / s_warm:.3f} over batches 2-"
            f"{len(recon.batch_times)}; device seconds by part {split} of "
            f"{s_all:.2f} s scoring ({wall:.1f} s CLI wall with set-up); peak device "
            f"memory {peak:.2f} GiB; card {CARD}")
        aucs = {}
        for target in ("mse", "perceptual_difference", "ssim_distance"):
            res = run_ood_detection(str(out), LDM_MODEL, plot_target=target,
                                    out_datasets=["Task02"])
            auc = res[f"Zscore_{target}"]
            if len(auc) != 1 or not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in auc):
                raise PhaseError(f"ldm {sampler}: plot_target={target} gave AUROCs {auc}")
            aucs[target] = auc[0]
        log(json.dumps({"ldm": {"sampler": sampler, "batch": batch,
                                "latent_recons_per_s": n_all / s_all,
                                "latent_recons_per_s_warm": n_warm / s_warm,
                                "device_s": parts, "scoring_s": s_all, "wall_s": wall,
                                "peak_gib": peak, "auroc": aucs, "card": CARD}}))
    log(f"ldm: phase took {time.perf_counter() - t0:.1f} s")
    return launches


# the 3D latent diffusion path at the BraTS ROI (BASELINE.md's 3D LDM sweep,
# docs/RUNBOOK.md): volumes cropped to --image_roi 160x160x128 and not
# resized (written at 176x176x136, a margin on every axis for the crop); a
# VQ-VAE of three 256-channel levels with three residual units each and 2048
# codes of width 128, so (20, 20, 16, 128) latents; the small UNet in 3D;
# PLMS 100/16 (7 start points) in 3 lane groups at batch 8. Weights seeded.
# Level 0 of the UNet's up path normalises 384 and 256 channels over 6400
# rows, samples over 8 blocks' shared memory in bf16.
BRATS_VQVAE = dict(LDM_VQVAE, downsample_parameters=[[2, 4, 1, 1]] * 3,
                   upsample_parameters=[[2, 4, 1, 1, 0]] * 3, num_channels=[256] * 3,
                   num_res_channels=[256] * 3)
BRATS_RAW, BRATS_LATENT = (176, 176, 136), (20, 20, 16)
BRATS_BATCH, BRATS_MODEL = 8, "smoke_brats"
BRATS_ARGS = ["--spatial_dimension=3", "--model_type=small", "--image_roi=[160,160,128]",
              "--is_grayscale=1", "--prediction_type=epsilon",
              "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015",
              "--beta_end=0.0195", "--b_scale=1.0", "--num_inference_steps=100",
              "--inference_skip_factor=16", "--recon_groups=3", f"--batch_size={BRATS_BATCH}",
              "--score_ssim=1"]


def _unet_gn_forward(unet, x, t, plain: bool = False):
    """One UNet forward on the card: (output, the (N, C, G, itemsize, address)
    of each GroupNorm it ran, launch counts). `plain`: GroupNorm and
    attention through their plain versions instead of the kernels."""
    from ddpm_ood_tpu_torch.models import unet as unet_mod
    from ddpm_ood_tpu_torch.ops.attention import einsum_attention
    from ddpm_ood_tpu_torch.ops.groupnorm import groupnorm_act_reference

    real = (unet_mod.groupnorm_act, unet_mod.attention)
    norm = groupnorm_act_reference if plain else real[0]
    seen = []

    def recorded(x, gamma, beta, num_groups, eps=1e-6, act="none"):
        seen.append((math.prod(x.shape[1:-1]), x.shape[-1], num_groups, x.element_size(),
                     x.data_ptr()))
        return norm(x, gamma, beta, num_groups, eps, act)

    unet_mod.groupnorm_act = recorded
    if plain:
        unet_mod.attention = einsum_attention
    reset_launches()
    try:
        with torch.no_grad():
            out = unet(x, t)
        torch.cuda.synchronize()
    finally:
        unet_mod.groupnorm_act, unet_mod.attention = real
    return out, seen, read_launches()


def _large_per_forward(seen) -> int:
    """GroupNorms of one forward that the dispatch gives the large-sample kernel."""
    from ddpm_ood_tpu_torch.ops.groupnorm import kernel_for

    return sum(kernel_for(*shape)[0] == "large" for shape in seen)


def phase_ldm_brats(dev: torch.device, root: Path) -> dict:
    """The scoring CLI on a 3D latent diffusion model at the BraTS ROI
    geometry (BRATS_ARGS): one UNet forward at the sweep's largest batch
    through the kernels against the plain versions on the card (fp32), the
    forward, then the CLI on two batches of the val set and one of each of
    the in and out sets: finite CSVs, every UNet forward's launches as
    predicted, val's batch 1 traced by the CLI's --profile_dir (the device's
    busy and idle shares, each kernel's share of the device time:
    ``profile_scoring.trace_split``), latent-recons/s of the warm, untraced
    in and out batches, and CUDA-event spans by part (UNet forwards; encode;
    decode; metrics tail)."""
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format, random_init_
    from ddpm_ood_tpu_torch.profile_scoring import trace_split
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    brats = root / "brats"
    rng = np.random.default_rng(9)
    csvs = {name: _write_volumes(brats, name, n * BRATS_BATCH, ood, rng, BRATS_RAW)
            for name, n, ood in (("val", 2, False), ("in", 1, False),
                                 ("Task01_BrainTumour_ood", 1, True))}
    vq = _ldm_vqvae(0, BRATS_VQVAE)
    unet = random_init_(make_unet("small", 3, 128, 128), torch.Generator().manual_seed(0)).eval()
    (brats / "vqvae").mkdir()
    save_checkpoint(brats / "vqvae" / "checkpoint.pth", vq.state_dict())
    (brats / "vqvae" / "vqvae_config.json").write_text(json.dumps(BRATS_VQVAE))
    out = brats / "output"
    (out / BRATS_MODEL).mkdir(parents=True)
    save_checkpoint(out / BRATS_MODEL / "checkpoint.pth", unet.state_dict())
    t_data = time.perf_counter() - t0

    ts = pndm_timesteps(1000, 100)
    t_starts = pndm_start_points(ts, 16)
    groups = group_t_starts(ts, t_starts, 3)
    rows = BRATS_BATCH * max(len(starts) for _, starts in groups)
    card_unet = unet.to(dev, memory_format=memory_format(3))
    x = torch.from_numpy(rng.standard_normal((rows, 128) + BRATS_LATENT, dtype=np.float32))
    x = x.to(dev, memory_format=memory_format(3))
    t = torch.from_numpy(rng.integers(0, 1000, rows)).to(dev)
    got, seen32, counts32 = _unet_gn_forward(card_unet, x, t)
    ref, _, _ = _unet_gn_forward(card_unet, x, t, plain=True)
    err = ((got - ref).abs().max() / max(1.0, ref.abs().max().item())).item()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got16, seen16, counts16 = _unet_gn_forward(card_unet, x, t)
    large = {"fp32": _large_per_forward(seen32), "bf16": _large_per_forward(seen16)}
    shapes16 = sorted({(n, c) for n, c, *_ in seen16 if n == math.prod(BRATS_LATENT)})
    log(f"brats: 3D small UNet ({rows}, 128, {BRATS_LATENT}) forward through the kernels vs the "
        f"plain versions on the card, fp32 (TF32 off): rel_err={err:.3e} tol={FWD_TOL:.0e}; "
        f"bf16 autocast forward finite={bool(torch.isfinite(got16).all())}; GroupNorms a forward "
        f"on the large-sample kernel (dispatch): fp32 {large['fp32']}, bf16 {large['bf16']} of "
        f"{len(seen16)}; level-0 (N, C) {shapes16}")
    if not (math.isfinite(err) and err <= FWD_TOL and bool(torch.isfinite(got16).all())):
        raise PhaseError(f"brats: UNet forward through the kernels is {err} off the plain "
                         "versions")
    _check_launches(counts32, 1, "brats fp32 forward", bf16=False)
    for what, counts, n_large, bf16 in (("fp32", counts32, large["fp32"], False),
                                        ("bf16", counts16, large["bf16"], True)):
        if counts["groupnorm_act_large"] != n_large:
            raise PhaseError(f"brats {what} forward: {counts['groupnorm_act_large']} large-sample "
                             f"GroupNorm launches, the dispatch gives {n_large}")
    _check_launches(counts16, 1, "brats bf16 forward", bf16=True, large_per_forward=large["bf16"])
    if large["bf16"] < 1:
        raise PhaseError("brats: no GroupNorm of the forward takes the large-sample kernel")
    del card_unet, x, got, ref, got16
    torch.cuda.empty_cache()

    argv = [f"--output_dir={out}", f"--model_name={BRATS_MODEL}",
            f"--vqvae_checkpoint={brats / 'vqvae' / 'checkpoint.pth'}",
            f"--validation_ids={csvs['val']}", f"--in_ids={csvs['in']}",
            f"--out_ids={csvs['Task01_BrainTumour_ood']}", "--device=cuda", *BRATS_ARGS,
            f"--profile_dir={brats / 'trace'}"]
    log("brats: python -m ddpm_ood_tpu_torch.reconstruct " + " ".join(argv))
    recon, counts, parts, wall, peak = _ldm_cli(argv)
    evals = sum(p.model_evals for p in recon._programs.values())
    per_batch = sum(len(s) for s, _ in groups)
    want = 4 * per_batch  # val's two batches, in's and out's one
    log(f"brats: {evals} UNet forwards (expected {want}, {len(groups)} lane groups); "
        f"launches {counts}")
    if evals != want:
        raise PhaseError(f"brats: {evals} UNet forwards, expected {want}")
    _check_launches(counts, evals, "brats scoring CLI", bf16=True, large_per_forward=large["bf16"])
    for name, n in (("val", 2 * BRATS_BATCH), ("in", BRATS_BATCH), ("Task01", BRATS_BATCH)):
        _check_csv(recon.out_dir / f"results_{name}.csv", t_starts, n_images=n)
    # val's batch 1 is traced (the CLI's --profile_dir); in and out run warm
    # and untraced
    if recon.profile_path is None or len(recon.batch_times) != 4:
        raise PhaseError(f"brats: no trace of val's batch 1, or {len(recon.batch_times)} "
                         "batches, not 4")
    trace = trace_split(Path(recon.profile_path))
    if trace["forwards"] != per_batch:
        raise PhaseError(f"brats: the trace holds {trace['forwards']} forwards' GroupNorms, "
                         f"expected {per_batch}")
    n_warm = sum(n for n, _ in recon.batch_times[2:])
    s_warm = sum(s for _, s in recon.batch_times[2:])
    split = {k: round(v, 3) for k, v in parts.items()}
    shares = {k: round(v, 4) for k, v in trace["share_of_device_time"].items() if v}
    log(f"brats: batches (latent recons, s) = {[(n, round(s, 3)) for n, s in recon.batch_times]}")
    log(f"brats: {n_warm / s_warm:.3f} latent-recons/s (in and out, warm, untraced); traced "
        f"val batch 1: {trace['device_ms_per_forward']:.3f} device ms a forward of "
        f"{trace['traced_wall_ms_per_forward']:.3f} wall ms, idle {trace['idle_share']:.3f}, "
        f"shares of device time {shares}; CUDA-event spans by part, all four batches {split} "
        f"({wall:.1f} s CLI wall with set-up, {t_data:.1f} s writing volumes and checkpoints); "
        f"peak device memory {peak:.2f} GiB; card {CARD}")
    log(json.dumps({"brats": {"batch": BRATS_BATCH, "latent_recons_per_s": n_warm / s_warm,
                              "trace": trace, "event_spans_s": parts,
                              "batch_times": recon.batch_times, "wall_s": wall,
                              "peak_gib": peak, "forward_rel_err": err,
                              "large_per_forward": large, "forwards": evals, "card": CARD}}))
    log(f"brats: phase took {time.perf_counter() - t0:.1f} s")
    return counts


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
    from ddpm_ood_tpu_torch.ops.quant import qconv_s8, quant_absmax, quantize_codes

    return {"groupnorm_act": groupnorm_act, "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "quant_absmax": quant_absmax, "quantize_codes": quantize_codes,
            "qconv_s8": qconv_s8}


# wrappers that also count their bf16 tensor-core launches, read as "<name>_tc"
TC_COUNTED = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def reset_launches() -> None:
    for name, fn in _launch_counters().items():
        fn.launches = 0
        if name in TC_COUNTED:
            fn.tc_launches = 0
    _launch_counters()["groupnorm_act"].cluster_launches = 0
    _launch_counters()["groupnorm_act"].large_launches = 0


def read_launches() -> dict:
    """Every launch count; "<name>_tc" the tensor-core launches, and
    "groupnorm_act_cluster" and "groupnorm_act_large" GroupNorm's launches of
    the cluster and the large-sample kernel."""
    fns = _launch_counters()
    return {**{name: fn.launches for name, fn in fns.items()},
            **{f"{name}_tc": fns[name].tc_launches for name in TC_COUNTED},
            "groupnorm_act_cluster": fns["groupnorm_act"].cluster_launches,
            "groupnorm_act_large": fns["groupnorm_act"].large_launches}


def _step_launches(forwards: int, backwards: int, bf16: bool, remat: tuple = (0, 0)) -> dict:
    """The launch counts of UNet training: GroupNorm on the cluster kernel;
    attention on tensor cores in bf16, on the CUDA-core kernels in fp32.
    `remat` is ``remat_launches``'s (GroupNorm, flash forward) recomputed per
    backward."""
    gn = GN_PER_FORWARD * forwards + remat[0] * backwards
    want = {"groupnorm_act": gn, "groupnorm_act_cluster": gn, "groupnorm_act_large": 0,
            "flash_attention_fwd": ATTN_PER_FORWARD * forwards + remat[1] * backwards,
            "flash_attention_bwd_dkv": ATTN_PER_FORWARD * backwards,
            "flash_attention_bwd_dq": ATTN_PER_FORWARD * backwards,
            "quant_absmax": 0, "quantize_codes": 0, "qconv_s8": 0}  # never quantised
    want.update({f"{name}_tc": want[name] if bf16 else 0 for name in TC_COUNTED})
    return want


def _grad_errs(g_cpu: dict, g_gpu: dict) -> tuple:
    """(worst relative error, its name, the largest key-bias gradient, the
    largest gradient) of the card's gradients against the CPU's, each
    relative to the CPU tensor's largest |value|. A missing or all-zero card
    gradient raises. The attention key biases are returned apart: softmax
    ignores a per-query constant, so their gradient is 0 in exact arithmetic
    and rounding noise on both devices."""
    missing = [n for n in g_cpu if g_cpu[n] is None or g_gpu[n] is None]
    if missing:
        raise PhaseError(f"no gradient for {missing}")
    scale = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name, shift_free = 0.0, "", 0.0
    for name, ref in g_cpu.items():
        got = g_gpu[name]
        if name.endswith(SHIFT_FREE_GRAD):
            shift_free = max(shift_free, got.abs().max().item(), ref.abs().max().item())
            continue
        if got.abs().max().item() == 0.0:
            raise PhaseError(f"gradient of {name} is all zero on the card")
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    return worst, worst_name, shift_free, scale


def phase_train_step(dev: torch.device, preset: str = "small", size: int = 32) -> None:
    """One fp32 training step's loss and gradients: the UNet (the full-width
    small one unless `preset` says otherwise) through the kernels on the
    card against the plain versions on the CPU."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep

    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.uniform(size=(4, 1, size, size)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((4, 1, size, size)).astype(np.float32))
    t = torch.tensor([3, 250, 600, 999])
    out = {}
    for device in (torch.device("cpu"), dev):
        model = seeded_unet(2, preset).to(device, memory_format=torch.channels_last)
        step = DDPMTrainStep(model=model, sched=make_schedule(
            "scaled_linear_beta", 1000, 0.0015, 0.0195, device=device))
        reset_launches()
        loss = step.grads(x0.to(device), noise.to(device), t.to(device))
        out[device.type] = (loss.item(), {n: None if p.grad is None else p.grad.cpu()
                                          for n, p in model.named_parameters()})
        counts = read_launches()
    want = _step_launches(1, 1, bf16=False)
    if counts != want:
        raise PhaseError(f"one training step launched {counts}, expected {want}")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst, worst_name, shift_free, scale = _grad_errs(g_cpu, g_gpu)
    log(f"train step ({preset} UNet, {size}x{size}): fp32 card vs CPU loss {l_gpu:.6f} vs "
        f"{l_cpu:.6f} rel_err={loss_err:.3e}; "
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
        # bf16 autocast: every flash kernel on tensor cores, every GroupNorm
        # on the cluster kernel
        want = _step_launches(forwards, trainer.step.backwards, bf16=True)
        log(f"train: {trainer.step.backwards} training steps, {trainer.step.forwards} train/eval "
            f"UNet forwards + {trainer.sample_forwards} sampler forwards; launches {launches}")
        if trainer.step.backwards != steps or trainer.sample_forwards != 1000:
            raise PhaseError(f"expected {steps} steps and 1000 sampler forwards")
        if launches != want:
            raise PhaseError(f"launches {launches} != expected {want}")

        losses = _scalars(trainer.run_dir / "train" / "scalars.jsonl")["loss"]
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


# the fp32 card-vs-CPU checks of latent-diffusion training: the Decathlon
# VQ-VAE and a PatchGAN discriminator (Flax's init) on 2 volumes of 32^3;
# the LDM step pads their 2^3 latents to the 8^3 of the real path
VQ_STEP_BATCH, VQ_STEP_ADV = 2, 0.1
# The VQ-VAE's encoder gradients are sums that cancel, and two fp32
# implementations both miss their fp64 values: on an H100 host, cuDNN's fp32
# by up to 1.0e-2 of a tensor's largest value and the CPU's channels-last
# fp32 by up to 2.0e-2, where the card's decoder gradients stay within 4e-6
# (PERF.md). So each G gradient of the card is held against an fp64
# CPU reference, to GRAD_TOL or GRAD_CONDITION times the CPU fp32's own
# error on that tensor, whichever is larger, and never beyond GRAD_CAP.
GRAD_CONDITION, GRAD_CAP = 10.0, 5e-2
LDM_STEP_PAD = (3, 3, 3, 3, 3, 3)
# latent-diffusion training at the Decathlon geometry (docs/RUNBOOK.md's 3D
# recipe: VQ-VAE batch 8 as --grad_accum_steps=4 --remat=1 on one card, LDM
# batch 6), cut to 2 epochs of 24 synthetic volumes each
TRAIN_LDM_VOLUMES, TRAIN_LDM_VAL, TRAIN_LDM_MODEL = 24, 8, "smoke_train_decathlon"
VQ_TRAIN_ARGS = ["--spatial_dimension=3", "--image_roi=[160,160,128]", f"--image_size={LDM_SIZE}",
                 "--is_grayscale=1",
                 "--vqvae_downsample_parameters=[[2,4,1,1],[2,4,1,1],[2,4,1,1],[2,4,1,1]]",
                 "--vqvae_upsample_parameters=[[2,4,1,1,0],[2,4,1,1,0],[2,4,1,1,0],[2,4,1,1,0]]",
                 "--vqvae_num_channels=[256,256,256,256]",
                 "--vqvae_num_res_channels=[256,256,256,256]", "--vqvae_embedding_dim=128",
                 "--vqvae_num_embeddings=2048", "--vqvae_decay=0.9", "--vqvae_learning_rate=3e-5",
                 "--batch_size=8", "--grad_accum_steps=4", "--remat=1", "--n_epochs=2",
                 "--eval_freq=2", "--checkpoint_every=2", "--num_workers=4"]
LDM_TRAIN_ARGS = ["--batch_size=6", "--n_epochs=2", "--eval_freq=2", "--checkpoint_every=2",
                  "--num_workers=4"]


def _rel_errs(cpu: dict, card: dict) -> dict:
    """{name: max|card - cpu| / max|cpu|} over tensors of the same names."""
    return {n: ((card[n].float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            for n, ref in cpu.items()}


def phase_vqvae_step(dev: torch.device, npz: Path) -> None:
    """fp32, TF32 off, card against CPU from the same weights: one VQ-VAE +
    PatchGAN G step and one D step (on the CPU's reconstruction) at full
    channel widths on 32^3 volumes, then one 3D LDM training step."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.losses.lpips import PerceptualLoss
    from ddpm_ood_tpu_torch.models.discriminator import PatchDiscriminator, init_like_flax_
    from ddpm_ood_tpu_torch.models.unet import make_unet, memory_format, random_init_
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep
    from ddpm_ood_tpu_torch.train.vqvae import VQVAETrainStep

    t0 = time.perf_counter()
    fmt = memory_format(3)
    base = _ldm_vqvae()  # eval mode; each side trains a copy
    rng = np.random.default_rng(9)
    vols = torch.from_numpy(_volumes(VQ_STEP_BATCH, LDM_CHECK_SIZE, False, rng))
    d_init = init_like_flax_(PatchDiscriminator(spatial_dims=3),
                             torch.Generator().manual_seed(0)).state_dict()
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    # the fp32 CPU, the fp32 card, and an fp64 CPU reference for the G gradients
    sides = {"cpu": (devices["cpu"], torch.float32), "cuda": (dev, torch.float32),
             "cpu64": (devices["cpu"], torch.float64)}
    out = {}
    for side, (device, dtype) in sides.items():
        vq = copy.deepcopy(base).to(device, dtype, memory_format=fmt)
        disc = PatchDiscriminator(spatial_dims=3)
        disc.load_state_dict(d_init)
        disc = disc.to(device, dtype, memory_format=fmt)
        step = VQVAETrainStep(model=vq, discriminator=disc, spatial_dims=3,
                              perceptual=PerceptualLoss(weights_path=str(npz),
                                                        spatial_dims=3).to(device, dtype),
                              vqvae_lr=3e-5)
        x = vols.to(device, dtype).contiguous(memory_format=fmt)
        with torch.no_grad():  # the codes the G step's quantizer will pick
            codes = vq.quantizer(vq.encode(x))[2].cpu().reshape(-1)
        metrics, recon = step.generator_step(x, VQ_STEP_ADV)
        res = {"codes": codes, "losses": {k: v.cpu() for k, v in metrics.items()},
               "g_grads": {n: p.grad.cpu().double() for n, p in vq.named_parameters()},
               "ema": {k: v.cpu() for k, v in step.quantizer.state_dict().items()},
               "recon": recon.cpu()}
        fake = (out["cpu"]["recon"].to(device) if side == "cuda" else recon).contiguous(
            memory_format=fmt)
        res["losses"]["discriminator_loss"] = step.discriminator_step(fake, x, VQ_STEP_ADV).cpu()
        res["d_grads"] = {n: p.grad.cpu() for n, p in disc.named_parameters()}
        res["bn"] = {k: v.cpu() for k, v in disc.state_dict().items() if "running" in k}
        out[side] = res
    torch.cuda.synchronize()
    codebook = base.quantizer.quantizer.embedding.weight.numpy()
    with torch.no_grad():
        z = base.encode(vols.to(memory_format=fmt))
    ties = _near_ties(z.movedim(1, -1).numpy(), codebook, TIE_MARGIN)
    same = out["cuda"]["codes"] == out["cpu"]["codes"]
    if not bool(same[torch.from_numpy(~ties)].all()):
        raise PhaseError(f"VQ-VAE step: {int((~same).sum())} quantizer indices differ, "
                         f"{int(ties.sum())} positions near a tie")
    c, g = out["cpu"], out["cuda"]
    errs = _rel_errs(c["losses"], g["losses"])
    state = {**_rel_errs(c["ema"], g["ema"]), **_rel_errs(c["bn"], g["bn"])}
    worst_d, name_d, _, _ = _grad_errs(c["d_grads"], g["d_grads"])
    for name, grad in g["g_grads"].items():
        if grad.abs().max().item() == 0.0:
            raise PhaseError(f"VQ-VAE gradient of {name} is all zero on the card")
    e_cpu = _rel_errs(out["cpu64"]["g_grads"], c["g_grads"])
    e_card = _rel_errs(out["cpu64"]["g_grads"], g["g_grads"])
    tols = {n: min(GRAD_CAP, max(GRAD_TOL, GRAD_CONDITION * e)) for n, e in e_cpu.items()}
    name_g = max(e_card, key=lambda n: e_card[n] / tols[n])
    worst_g = e_card[name_g] / tols[name_g]  # <= 1 passes
    name_cpu = max(e_cpu, key=e_cpu.get)
    held = bool(same.all())  # a near-tie that fell apart changes a code: values held finite
    log(f"vqvae step: Decathlon VQ-VAE + PatchGAN on ({VQ_STEP_BATCH}, 1, {LDM_CHECK_SIZE}^3), "
        f"adv_weight {VQ_STEP_ADV}, fp32 card vs CPU: quantizer indices equal at "
        f"{int(same.sum())} of {same.numel()}, {int(ties.sum())} within {TIE_MARGIN:.0e} of a "
        f"tie; losses " + ", ".join(f"{n} {c['losses'][n].item():.6f} rel_err={e:.3e}"
                                    for n, e in errs.items())
        + f"; G gradients ({len(e_card)}) against fp64: card fp32 worst "
        f"{max(e_card.values()):.3e}, CPU fp32 worst {e_cpu[name_cpu]:.3e} ({name_cpu}); "
        f"{sum(t > GRAD_TOL for t in tols.values())} tensors held above {GRAD_TOL:.0e} by "
        f"the CPU's own error; tightest {name_g} card {e_card[name_g]:.3e} of "
        f"{tols[name_g]:.3e}; decoder worst card "
        f"{max(e for n, e in e_card.items() if n.startswith('decoder')):.3e}; D "
        f"gradients ({len(c['d_grads'])}) worst {worst_d:.3e} ({name_d}); EMA and BatchNorm "
        "statistics " + ", ".join(f"{n} {e:.3e}" for n, e in state.items())
        + f"; tol {FWD_TOL:.0e} (losses, statistics), {GRAD_TOL:.0e} (D gradients)"
        + ("" if held else "; a code differs at a near-tie: values held finite only"))
    values = list(errs.values()) + list(state.values()) + [worst_g, worst_d]
    if not all(math.isfinite(v) for v in values):
        raise PhaseError(f"VQ-VAE step: a value is not finite: {errs} {state} {worst_g} {worst_d}")
    if held and not (all(e <= FWD_TOL for e in list(errs.values()) + list(state.values()))
                     and worst_g <= 1.0 and worst_d <= GRAD_TOL):
        raise PhaseError(f"VQ-VAE step on the card disagrees with the CPU: {errs} {state} "
                         f"G {name_g} {e_card[name_g]} > {tols[name_g]}, D {name_d} {worst_d}")

    # one 3D LDM training step: encode, pad to 8^3, loss, every UNet gradient
    unet_init = random_init_(make_unet("small", 3, 128, 128),
                             torch.Generator().manual_seed(2)).state_dict()
    noise = torch.from_numpy(rng.standard_normal((VQ_STEP_BATCH, 128, 8, 8, 8),
                                                 dtype=np.float32))
    t = torch.tensor([20, 900])
    ldm, x0_cpu = {}, None
    for side, device in devices.items():
        unet = make_unet("small", 3, 128, 128)
        unet.load_state_dict(unet_init)
        vq = copy.deepcopy(base).to(device, memory_format=fmt)
        step = DDPMTrainStep(model=unet.to(device, memory_format=fmt),
                             sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195,
                                                 device=device),
                             encode_fn=vq.encode_stage_2_inputs, latent_pad=LDM_STEP_PAD)
        x0 = step.prepare(vols.to(device, memory_format=fmt))
        x0_cpu = x0.cpu() if x0_cpu is None else x0_cpu
        reset_launches()  # the gradients of both sides are taken on the CPU's latents
        loss = step.grads(x0_cpu.to(device, memory_format=fmt), noise.to(device), t.to(device))
        ldm[side] = (x0.cpu(), loss.item(),
                     {n: None if p.grad is None else p.grad.cpu()
                      for n, p in unet.named_parameters()}, read_launches())
    want = _step_launches(1, 1, bf16=False)
    if ldm["cuda"][3] != want:
        raise PhaseError(f"one 3D LDM training step launched {ldm['cuda'][3]}, expected {want}")
    image_ties = torch.from_numpy(ties.reshape(VQ_STEP_BATCH, -1).any(-1))
    keep = ~image_ties
    err_x0 = ((ldm["cuda"][0] - ldm["cpu"][0])[keep].abs().max()
              / ldm["cpu"][0][keep].abs().max()).item() if keep.any() else float("nan")
    loss_err = abs(ldm["cuda"][1] - ldm["cpu"][1]) / abs(ldm["cpu"][1])
    worst, worst_name, shift_free, scale = _grad_errs(ldm["cpu"][2], ldm["cuda"][2])
    log(f"vqvae step: 3D LDM training step (encode, latent_pad {LDM_STEP_PAD} to 8^3, small "
        f"UNet) fp32 card vs CPU: latents rel_err={err_x0:.3e} over {int(keep.sum())} of "
        f"{VQ_STEP_BATCH} images without a near-tie; loss {ldm['cuda'][1]:.6f} vs "
        f"{ldm['cpu'][1]:.6f} rel_err={loss_err:.3e}; {len(ldm['cpu'][2])} gradients, worst "
        f"rel_err={worst:.3e} ({worst_name}) tol={GRAD_TOL:.0e}; key-bias gradients at most "
        f"{shift_free:.3e} against {scale:.3e}; launches {ldm['cuda'][3]}")
    if not ((not keep.any() or err_x0 <= FWD_TOL) and loss_err <= GRAD_TOL
            and math.isfinite(worst) and worst <= GRAD_TOL and shift_free <= 1e-5 * scale):
        raise PhaseError(f"3D LDM training step on the card disagrees with the CPU: latents "
                         f"{err_x0}, loss {loss_err}, gradient {worst_name} {worst}, key bias "
                         f"{shift_free}")
    log(f"vqvae step: phase took {time.perf_counter() - t0:.1f} s")


def phase_train_ldm(dev: torch.device, root: Path) -> dict:
    """The 3D latent-diffusion training recipe at the Decathlon geometry:
    train_vqvae, train_ddpm on its checkpoint, then the scoring CLI on both
    trained checkpoints; returns the LDM training CLI's launch counts."""
    from ddpm_ood_tpu_torch import reconstruct as score_cli
    from ddpm_ood_tpu_torch import train_ddpm, train_vqvae
    from ddpm_ood_tpu_torch.diffusion.ddim import ddim_timesteps
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points
    from ddpm_ood_tpu_torch.models.vqvae import VQVAE
    from ddpm_ood_tpu_torch.ood import run_ood_detection
    from ddpm_ood_tpu_torch.trainers.base import resolve_device
    from ddpm_ood_tpu_torch.trainers.vqvae_trainer import VQVAETrainer
    from ddpm_ood_tpu_torch.utils.checkpoint import load_vqvae_checkpoint

    t0 = time.perf_counter()
    data = root / "train_ldm"
    rng = np.random.default_rng(10)
    train_csv = _write_volumes(data, "train", TRAIN_LDM_VOLUMES, False, rng)
    val_csv = _write_volumes(data, "val", TRAIN_LDM_VAL, False, rng)
    ood_csv = _write_volumes(data, "Task02_Heart_test", 2, True, rng)
    out = data / "output"
    common = [f"--output_dir={out}", f"--training_ids={train_csv}",
              f"--validation_ids={val_csv}", "--device=cuda"]

    # stage 1: the VQ-VAE and its discriminator
    argv = [*common, "--model_name=vqvae_decathlon", *VQ_TRAIN_ARGS]
    log("train_ldm: python -m ddpm_ood_tpu_torch.train_vqvae " + " ".join(argv))
    args = train_vqvae.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    vq = VQVAETrainer(args, resolve_device(args.device))  # what train_vqvae.main runs
    codebook = vq.model.quantizer.quantizer.embedding.weight.clone()
    vq.train(args)
    torch.cuda.synchronize()
    vq_wall = time.perf_counter() - t1
    vq_peak = torch.cuda.max_memory_allocated() / 2**30
    if any(read_launches().values()):
        raise PhaseError(f"VQ-VAE training launched the UNet's kernels: {read_launches()}")
    steps = 2 * math.ceil(TRAIN_LDM_VOLUMES / 8)
    losses = _scalars(vq.run_dir / "train" / "scalars.jsonl")
    if (sorted(losses) != sorted(("l1_loss", "quantization_loss", "perceptual_loss",
                                  "jukebox_loss", "adversarial_loss", "generator_loss",
                                  "discriminator_loss"))
            or any(len(v) != steps or not all(map(math.isfinite, v)) for v in losses.values())):
        raise PhaseError(f"VQ-VAE training losses are not {steps} finite values a tag: {losses}")
    moved = (vq.model.quantizer.quantizer.embedding.weight - codebook).abs().max().item()
    ckpt = vq.run_dir / "checkpoint.pth"
    config, state = load_vqvae_checkpoint(ckpt)
    VQVAE(**config).load_state_dict(state, strict=True)
    grid = np.load(vq.run_dir / "val" / f"RECONSTRUCTIONS_{2 * TRAIN_LDM_VOLUMES}.npy")
    if not (moved > 0 and (vq.run_dir / "checkpoint_2.pth").is_file()
            and grid.shape == (4, 2, LDM_SIZE, LDM_SIZE, 1) and np.isfinite(grid).all()):
        raise PhaseError(f"VQ-VAE training: codebook moved by {moved}, reconstruction grid "
                         f"{grid.shape}, files {sorted(p.name for p in vq.run_dir.iterdir())}")
    vq_rates = [n / s for n, s in vq.epoch_times]
    log(f"train_ldm: VQ-VAE {vq.step.g_backwards} G microbatch backwards in {steps} G+D steps; "
        f"losses per step {({k: [round(x, 5) for x in v] for k, v in losses.items()})}; "
        f"codebook moved by up to {moved:.3e}; {ckpt.name} and vqvae_config.json load")
    log(f"train_ldm: VQ-VAE {vq_rates[0]:.3f} volumes/s in epoch 1 (first steps included), "
        f"{vq_rates[1]:.3f} volumes/s in epoch 2 ({8 / vq_rates[1]:.3f} s a G+D step of 8); CLI "
        f"wall {vq_wall:.1f} s; peak device memory {vq_peak:.2f} GiB; card {CARD}")

    # stage 2: the small 3D UNet on the frozen VQ-VAE's latents
    argv = [*common, f"--model_name={TRAIN_LDM_MODEL}", f"--vqvae_checkpoint={ckpt}",
            *LDM_ARGS, *LDM_TRAIN_ARGS]
    log("train_ldm: python -m ddpm_ood_tpu_torch.train_ddpm " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    ldm = train_ddpm.main(argv)
    torch.cuda.synchronize()
    ldm_wall = time.perf_counter() - t1
    launches = read_launches()
    ldm_peak = torch.cuda.max_memory_allocated() / 2**30
    ldm_steps = 2 * math.ceil(TRAIN_LDM_VOLUMES / 6)
    forwards = ldm.step.forwards + ldm.sample_forwards
    want = _step_launches(forwards, ldm.step.backwards, bf16=True)
    log(f"train_ldm: {ldm.step.backwards} LDM training steps, {ldm.step.forwards} train/eval "
        f"UNet forwards + {ldm.sample_forwards} sampler forwards; launches {launches}")
    if ldm.step.backwards != ldm_steps or ldm.sample_forwards != 1000 or launches != want:
        raise PhaseError(f"LDM training: {ldm.step.backwards} steps (expected {ldm_steps}), "
                         f"{ldm.sample_forwards} sampler forwards; launches {launches} != {want}")
    ldm_losses = _scalars(ldm.run_dir / "train" / "scalars.jsonl")["loss"]
    if len(ldm_losses) != ldm_steps or not all(map(math.isfinite, ldm_losses)):
        raise PhaseError(f"LDM training losses are not {ldm_steps} finite values: {ldm_losses}")
    images = TRAIN_LDM_VOLUMES * 2
    _check_checkpoint(ldm.run_dir / "checkpoint_2.pth", 2, images, ldm_steps)
    # the rolling best on train loss: epoch 1 or 2, as the losses fell
    best_epoch = int(torch.load(ldm.run_dir / "checkpoint.pth", map_location="cpu",
                                weights_only=True)["epoch"])
    best = _check_checkpoint(ldm.run_dir / "checkpoint.pth", best_epoch,
                             images * best_epoch // 2, ldm_steps * best_epoch // 2)
    samples = np.load(ldm.run_dir / "val" / f"samples_{images}.npy")
    if samples.shape != (2, LDM_SIZE, LDM_SIZE, LDM_SIZE, 1) or not np.isfinite(samples).all():
        raise PhaseError(f"LDM sample grid {samples.shape} is not 2 finite decoded volumes")
    ldm_rates = [n / s for n, s in ldm.epoch_times]
    log(f"train_ldm: LDM losses {[round(v, 5) for v in ldm_losses]}; {ldm_rates[0]:.2f} latents/s "
        f"in epoch 1 (first steps included), {ldm_rates[1]:.2f} latents/s in epoch 2 "
        f"({6e3 / ldm_rates[1]:.1f} ms a step of 6, the encode included); CLI wall "
        f"{ldm_wall:.1f} s with the 1000-step validation sample; peak device memory "
        f"{ldm_peak:.2f} GiB; card {CARD}")

    # the scoring CLI on both trained checkpoints: dpm 25/1, one batch a set
    argv = [f"--output_dir={out}", f"--model_name={TRAIN_LDM_MODEL}",
            f"--vqvae_checkpoint={ckpt}", f"--validation_ids={val_csv}",
            f"--in_ids={val_csv}", f"--out_ids={ood_csv}", "--device=cuda", *LDM_ARGS,
            "--batch_size=2", "--first_n_val=2", "--first_n=2", *LDM_GRIDS[1][1]]
    log("train_ldm: python -m ddpm_ood_tpu_torch.reconstruct " + " ".join(argv))
    reset_launches()
    recon = score_cli.main(argv)
    torch.cuda.synchronize()
    counts = read_launches()
    evals = sum(p.model_evals for p in recon._programs.values())
    _check_launches(counts, evals, "scoring the trained latent diffusion model", bf16=True)
    loaded = recon.unet.state_dict()
    vq_loaded = recon.vqvae.state_dict()
    if (any(not torch.equal(loaded[k].cpu(), v) for k, v in best["model_state_dict"].items())
            or any(not torch.equal(vq_loaded[k].cpu(), v) for k, v in state.items())):
        raise PhaseError("the scoring CLI's weights differ from the trained checkpoints")
    t_starts = pndm_start_points(ddim_timesteps(1000, 25), 1)
    for name in ("val", "in", "Task02"):
        _check_csv(recon.out_dir / f"results_{name}.csv", t_starts,
                   ("mse", "perceptual_difference"), n_images=2)
    res = run_ood_detection(str(out), TRAIN_LDM_MODEL, plot_target="mse",
                            out_datasets=["Task02"])
    auc = res["Zscore_mse"]
    if len(auc) != 1 or not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in auc):
        raise PhaseError(f"train_ldm: AUROC {auc}")
    log(json.dumps({"train_ldm": {
        "vqvae_volumes_per_s": vq_rates[1], "vqvae_volumes_per_s_epoch1": vq_rates[0],
        "vqvae_peak_gib": vq_peak, "ldm_latents_per_s": ldm_rates[1],
        "ldm_latents_per_s_epoch1": ldm_rates[0], "ldm_peak_gib": ldm_peak,
        "auroc_mse": auc[0], "card": CARD}}))
    log(f"train_ldm: phase took {time.perf_counter() - t0:.1f} s")
    return launches


# simplex noise on the scoring path: the headline configuration (MAIN_ARGS
# with --score_ssim=1 --save_error_maps=1, phase_main's data and weights)
# with exact host noise and with on-device noise; phase_main's run is the
# Gaussian one
# (mode, flags, {split it scores: its preview}): exact noise scores the val
# split, device noise the out split (an out preview is named by its pass of
# the run, here the first), one batch each to keep the script's time
SIMPLEX_MODES = (("exact", ["--simplex_noise=1", "--run_in=0", "--run_out=0"],
                  {"val": "preview_val.npy"}),
                 ("device", ["--simplex_noise=1", "--simplex_noise_mode=device", "--run_val=0",
                             "--run_in=0"], {"checkerboard": "preview_out_1.npy"}))
DEVICE_NOISE_TOL = 1e-5  # simplex_noise_device planes of ~1, fp32 card vs CPU
# crash and resume: the headline model on a shorter grid (PLMS 20/2), 2
# batches of 32; the resumed CSV against an uninterrupted run's, each column
# to RESUME_TOL of its largest value (bf16 autocast in both; 0 when the two
# processes compute alike)
RESUME_ARGS = [a for a in MAIN_ARGS if not a.startswith(("--num_inference_steps",
                                                         "--inference_skip_factor"))] + [
    "--num_inference_steps=20", "--inference_skip_factor=2"]
RESUME_TOL = 1e-3
# a --profile_dir trace must name these port kernels
TRACE_KERNELS = ("groupnorm_act_cluster_kernel", "flash_fwd_tc_kernel")


def _trace_kernels(path: Path, names) -> dict:
    """{name: events whose name contains it} in a Chrome trace; fails on a
    missing or empty trace, or a kernel it does not name."""
    if not path.is_file() or path.stat().st_size == 0:
        raise PhaseError(f"no profiler trace at {path}")
    events = json.loads(path.read_text())["traceEvents"]
    found = {n: sum(n in e.get("name", "") for e in events) for n in names}
    if not all(found.values()):
        raise PhaseError(f"{path.name} names no {[n for n, c in found.items() if not c]}")
    return found


def _read_rows(path: Path) -> dict:
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    keyed = {(r["filename"], int(r["t"])): r for r in rows}
    if len(keyed) != len(rows):
        raise PhaseError(f"{path.name}: duplicate (filename, t) rows")
    return keyed


def phase_simplex_resume(dev: torch.device, root: Path, gaussian: dict) -> dict:
    """Simplex noise, --resume, previews and --profile_dir on the scoring
    path: the OpenSimplex build and its batched planes against the serial
    loop; device-mode noise card against CPU; an fp32 sweep on one host
    simplex draw card against CPU; the scoring CLI at the headline with
    exact and device noise beside phase_main's Gaussian run (`gaussian`,
    its recons/s); a crash after batch 1 and a resume in fresh processes,
    the second traced. Returns the two simplex runs' launch counts."""
    from bench_attention import time_cuda
    from ddpm_ood_tpu_torch import reconstruct as cli
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.noise import _native
    from ddpm_ood_tpu_torch.noise.simplex import (Simplex, _hash3, generate_simplex_noise,
                                                  simplex_noise_device)
    from ddpm_ood_tpu_torch.recon.sweep import ReconProgram, group_t_starts
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    _native.LIB_PATH.unlink(missing_ok=True)
    _native.library.cache_clear()
    t1 = time.perf_counter()
    _native.library()
    log(f"simplex: g++ -O3 -fopenmp built {_native.LIB_PATH.relative_to(ROOT)} from "
        f"{_native.SRC.relative_to(ROOT)} in {time.perf_counter() - t1:.2f} s")

    # one headline batch's draw: 25 start points x 32 images, batched and serial
    ts = pndm_timesteps(1000, 100)
    t_starts = pndm_start_points(ts, 4)
    k = len(t_starts)
    shape = (N_IMAGES, 32, 32, 1)
    np.random.seed(0)
    simplex = Simplex()
    t1 = time.perf_counter()
    batched = np.stack([generate_simplex_noise(simplex, shape, np.full(N_IMAGES, t))
                        for t in t_starts])
    host_s = time.perf_counter() - t1
    np.random.seed(0)
    simplex = Simplex()
    serial = np.empty_like(batched)
    t1 = time.perf_counter()
    for i, t in enumerate(t_starts):
        for j in range(N_IMAGES):  # one channel: (channel, item) order is item order
            simplex.newSeed()
            serial[i, j, ..., 0] = simplex.rand_3d_fixed_T_octaves((32, 32), t, 6, 0.8, 64)[0]
    serial_s = time.perf_counter() - t1
    if batched.tobytes() != serial.tobytes():
        raise PhaseError("batched OpenSimplex planes differ from the serial loop's")
    log(f"simplex: one headline batch's host draw {batched.shape} ({k * N_IMAGES} planes of "
        f"32x32, 6 octaves): batched {host_s * 1e3:.1f} ms, serial loop {serial_s * 1e3:.1f} ms, "
        f"bit-identical; {os.cpu_count()} host CPUs")

    # device mode, card against CPU: the lattice hashes equal, the planes close
    grid = torch.stack(torch.meshgrid(*(torch.arange(-20, 20),) * 3, indexing="ij")).reshape(3, -1)
    seed = torch.tensor(3_000_000_000)
    hashes = [_hash3(*(g.to(d) for g in grid), seed.to(d)).cpu()
              for d in (torch.device("cpu"), dev)]
    if not torch.equal(*hashes):
        raise PhaseError("simplex_noise_device's lattice hash differs on the card")
    seeds = torch.from_numpy(np.random.default_rng(1).integers(0, 2**31 - 1, k))
    lanes_t = torch.as_tensor(t_starts)[:, None].expand(k, N_IMAGES)
    planes = {side: simplex_noise_device(seeds.to(d), shape, lanes_t.to(d)).cpu()
              for side, d in (("cpu", torch.device("cpu")), ("card", dev))}
    err = (planes["card"] - planes["cpu"]).abs().max().item()
    ms = time_cuda(lambda: simplex_noise_device(seeds.to(dev), shape, lanes_t.to(dev)), iters=5)
    log(f"simplex: device-mode noise {tuple(planes['cpu'].shape)} card vs CPU: {grid.shape[1]} "
        f"lattice hashes equal, planes max_abs_err={err:.3e} tol={DEVICE_NOISE_TOL:.0e}; "
        f"{ms:.3f} ms of device time a headline batch")
    if not (math.isfinite(err) and err <= DEVICE_NOISE_TOL):
        raise PhaseError(f"simplex_noise_device on the card disagrees with the CPU: {err}")

    # an fp32 sweep on one host simplex draw, card against CPU
    models = {"cpu": seeded_unet(1).to(memory_format=torch.channels_last).eval(),
              "card": seeded_unet(1).to(dev, memory_format=torch.channels_last).eval()}
    images = np.random.default_rng(2).uniform(size=(2, 32, 32, 1)).astype(np.float32)
    mse = {}
    for side, device in (("cpu", torch.device("cpu")), ("card", dev)):
        prog = ReconProgram(sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195,
                                                device=device),
                            model_fn=models[side], device=device, num_inference_steps=10,
                            inference_skip_factor=3, num_groups=2)
        if side == "cpu":
            np.random.seed(5)
            noise = np.stack([generate_simplex_noise(Simplex(), images.shape, np.full(2, t))
                              for t in prog.t_starts])
        prog.host_noise_fn = lambda shape, ts: noise
        mse[side] = prog(images)[1].cpu()
        prog.close()
    err = ((mse["card"] - mse["cpu"]).abs() / mse["cpu"].abs().clamp_min(1e-6)).max().item()
    log(f"simplex: fp32 sweep on one host simplex draw {noise.shape}, MSE table card vs CPU "
        f"max_rel_err={err:.3e} tol={FWD_TOL:.0e}")
    if not (math.isfinite(err) and err <= FWD_TOL):
        raise PhaseError(f"simplex sweep MSE on the card disagrees with the CPU: {err}")

    # the scoring CLI at the headline: exact and device noise
    per_batch = sum(len(st) for st, _ in group_t_starts(ts, t_starts, 16))
    launches, summary = {}, {"gaussian": gaussian}
    for mode, flags, splits in SIMPLEX_MODES:
        out = root / f"output_simplex_{mode}"
        (out / SMOKE_MODEL).mkdir(parents=True)
        save_checkpoint(out / SMOKE_MODEL / "checkpoint.pth", seeded_unet(0).state_dict())
        argv = [f"--output_dir={out}", f"--model_name={SMOKE_MODEL}",
                f"--validation_ids={root / 'val.csv'}", f"--in_ids={root / 'in.csv'}",
                f"--out_ids={root / 'checkerboard_test.csv'}", "--device=cuda", *MAIN_ARGS,
                "--score_ssim=1", "--save_error_maps=1", *flags]
        log(f"simplex: python -m ddpm_ood_tpu_torch.reconstruct " + " ".join(argv))
        args = cli.parse_args(argv)
        np.random.seed(0)
        reset_launches()
        t1 = time.perf_counter()
        recon = cli.Reconstruct(args, cli.resolve_device(args.device))
        prog = recon._program(args.inference_skip_factor)
        timer = _DeviceTimer()
        if prog.simplex_noise_fn is not None:
            prog.simplex_noise_fn = timer.wrap("noise", prog.simplex_noise_fn)
        recon.reconstruct(args)
        device_noise_s = timer.seconds().get("noise", 0.0)
        wall = time.perf_counter() - t1
        counts = read_launches()
        for name, value in counts.items():
            launches[name] = launches.get(name, 0) + value
        evals = prog.model_evals
        if evals != len(splits) * per_batch:
            raise PhaseError(f"simplex {mode}: {evals} UNet forwards, expected "
                             f"{len(splits) * per_batch}")
        _check_launches(counts, evals, f"simplex {mode} scoring CLI", bf16=True)
        for name in splits:
            _check_csv(recon.out_dir / f"results_{name}.csv", t_starts)
        previews = sorted(p.name for p in recon.out_dir.glob("preview_*.npy"))
        grid_shape = np.load(recon.out_dir / next(iter(splits.values()))).shape
        if previews != sorted(splits.values()) or \
                grid_shape != (2, 8, 32, 32, 1):
            raise PhaseError(f"simplex {mode}: previews {previews} {grid_shape}")
        rates = _rates(recon.batch_times)
        summary[mode] = {**rates, "host_noise_s": prog.host_noise_seconds,
                         "host_noise_wait_s": prog.host_noise_wait_seconds,
                         "device_noise_s": device_noise_s, "batches": len(recon.batch_times)}
        log(f"simplex: {mode} batches (recons, s) = "
            f"{[(n, round(s, 3)) for n, s in recon.batch_times]}; {GN_PER_FORWARD} GroupNorm "
            f"and {ATTN_PER_FORWARD} flash launches per forward; previews {previews}")
        log(f"simplex: {mode} {rates['all']:.2f} recons/s over all batches, {rates['warm']:.2f} "
            f"over batches 2 on (Gaussian, phase main: {gaussian['all']:.2f}, "
            f"{gaussian['warm']:.2f}); host seconds making noise {prog.host_noise_seconds:.3f}, "
            f"waited on it {prog.host_noise_wait_seconds:.3f}; device noise seconds "
            f"{device_noise_s:.3f}; CLI wall {wall:.1f} s; card {CARD}")

    # crash after batch 1, then --resume=1, each in a fresh process
    rng = np.random.default_rng(6)
    val = _write_split(root, "resume_val", 2 * N_IMAGES, False, rng)
    common = [f"--model_name={SMOKE_MODEL}", f"--validation_ids={val}", f"--in_ids={val}",
              f"--out_ids={val}", "--run_in=0", "--run_out=0", "--device=cuda", *RESUME_ARGS]
    for name in ("output_uninterrupted", "output_resumed"):
        (root / name / SMOKE_MODEL).mkdir(parents=True)
        save_checkpoint(root / name / SMOKE_MODEL / "checkpoint.pth", seeded_unet(0).state_dict())
    cmd = [sys.executable, "-m", "ddpm_ood_tpu_torch.reconstruct",
           f"--output_dir={root / 'output_resumed'}", *common, "--resume=1"]
    ood = root / "output_resumed" / SMOKE_MODEL / "ood"
    # the crashing process starts while the uninterrupted run scores here
    crash_log = root / "crash_run.log"
    with open(crash_log, "w") as sink:
        crashing = subprocess.Popen(cmd, cwd=ROOT, stdout=sink, stderr=subprocess.STDOUT,
                                    env={**os.environ, "DDPM_OOD_TPU_CRASH_AFTER_BATCHES": "1"})
    try:
        want = cli.main([f"--output_dir={root / 'output_uninterrupted'}", *common])
        k_resume = len(next(iter(want._programs.values())).t_starts)
        crashing.wait(timeout=600)
    finally:
        if crashing.poll() is None:
            crashing.kill()
            crashing.wait()
    crash = subprocess.CompletedProcess(cmd, crashing.returncode, "", crash_log.read_text())
    partial = ood / ".results_val.partial.csv"
    rows = len(_read_rows(partial)) if partial.is_file() else 0
    log(f"simplex: the crashing run exited {crash.returncode} with {rows} rows in {partial.name}")
    if crash.returncode != -9 or rows != N_IMAGES * k_resume:
        raise PhaseError(f"crash run: exit {crash.returncode}, {rows} rows persisted (expected -9, "
                         f"{N_IMAGES * k_resume}): {crash.stderr[-2000:]}")
    prof = root / "prof_scoring"
    resumed = subprocess.run(cmd + [f"--profile_dir={prof}"], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
    said = f"resume: skipped {N_IMAGES} already-scored images for 'val'"
    if resumed.returncode != 0 or said not in resumed.stdout + resumed.stderr:
        raise PhaseError(f"resumed run: exit {resumed.returncode}: {resumed.stderr[-3000:]}")
    got = _read_rows(ood / "results_val.csv")
    ref = _read_rows(want.out_dir / "results_val.csv")
    if sorted(got) != sorted(ref) or len(got) != 2 * N_IMAGES * k_resume or partial.exists():
        raise PhaseError(f"resumed CSV: {len(got)} rows, keys equal {sorted(got) == sorted(ref)}")
    errs = {}
    for col in ("mse", "perceptual_difference"):
        diff = max(abs(float(got[key][col]) - float(r[col])) for key, r in ref.items())
        errs[col] = diff / max(abs(float(r[col])) for r in ref.values())
    log(f"simplex: resumed CSV {len(got)} rows, the uninterrupted run's (filename, t) keys, no "
        f"duplicates; max difference over each column's largest value {errs} "
        f"(tol {RESUME_TOL:.0e}; {'exactly equal' if not any(errs.values()) else 'not equal'})")
    if not all(math.isfinite(e) and e <= RESUME_TOL for e in errs.values()):
        raise PhaseError(f"the resumed CSV differs from the uninterrupted run's: {errs}")
    found = _trace_kernels(prof / "scoring_val_batch1.pt.trace.json", TRACE_KERNELS)
    log(f"simplex: the resumed run's --profile_dir trace of batch 1 names {found}")
    summary["resume"] = {"rows": len(got), "max_rel_diff": errs, "trace_kernel_events": found}
    summary["card"] = CARD
    log(json.dumps({"simplex": summary}))
    log(f"simplex: phase took {time.perf_counter() - t0:.1f} s")
    return launches


REMAT_GRAD_TOL = 1e-5  # fp32 gradients with and without remat, of each tensor's largest


def phase_train_remat(dev: torch.device) -> dict:
    """The training path's remat and simplex leg: one fp32 step with and
    without remat on the card (the same gradients, remat's launch counts);
    then the training CLI with --simplex_noise=1, without and with
    --remat=1 (the second with --profile_dir), images/s and peak memory side
    by side, launch counts from the block structure. Returns each run's
    launch counts by path."""
    from ddpm_ood_tpu_torch import train_ddpm
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.uniform(size=(4, 1, 32, 32)).astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.standard_normal((4, 1, 32, 32)).astype(np.float32)).to(dev)
    t = torch.tensor([3, 250, 600, 999], device=dev)
    grads = {}
    for remat in (False, True):
        model = seeded_unet(2, remat=remat).to(dev, memory_format=torch.channels_last)
        step = DDPMTrainStep(model=model, sched=make_schedule("scaled_linear_beta", 1000, 0.0015,
                                                              0.0195, device=dev))
        reset_launches()
        step.grads(x0, noise, t)
        torch.cuda.synchronize()
        counts = read_launches()
        want = _step_launches(1, 1, bf16=False, remat=remat_launches(model) if remat else (0, 0))
        if counts != want:
            raise PhaseError(f"fp32 step (remat={remat}) launched {counts}, expected {want}")
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    # the key biases' gradients are 0 in exact arithmetic (_grad_errs): held
    # to REMAT_GRAD_TOL of the largest gradient instead
    worst, worst_name, shift_free, scale = _grad_errs(
        {n: g.cpu() for n, g in grads[False].items()}, {n: g.cpu() for n, g in grads[True].items()})
    log(f"train_remat: fp32 step on the card, {len(grads[False])} gradients with remat against "
        f"without: worst {worst:.3e} ({worst_name}) of the tensor's largest, tol "
        f"{REMAT_GRAD_TOL:.0e}; key-bias gradients at most {shift_free:.3e} against a largest "
        f"gradient of {scale:.3e}; launches {counts}")
    if not (math.isfinite(worst) and worst <= REMAT_GRAD_TOL
            and shift_free <= REMAT_GRAD_TOL * scale):
        raise PhaseError(f"remat changes the gradients on the card: {worst_name} {worst}, key "
                         f"bias {shift_free}")

    paths, rates = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(1)
        train_csv = _write_split(root, "train", TRAIN_BATCH * TRAIN_STEPS_PER_EPOCH, False, rng)
        val_csv = _write_split(root, "val", TRAIN_BATCH, False, rng)
        for remat in (0, 1):
            path = "train_remat" if remat else "train_simplex"
            argv = [f"--output_dir={root / path}", "--model_name=smoke_fashionmnist",
                    f"--training_ids={train_csv}", f"--validation_ids={val_csv}",
                    "--device=cuda", *TRAIN_ARGS, "--eval_freq=100", "--simplex_noise=1",
                    f"--remat={remat}"] + ([f"--profile_dir={root / 'prof'}"] if remat else [])
            log("train_remat: python -m ddpm_ood_tpu_torch.train_ddpm " + " ".join(argv))
            np.random.seed(0)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # by earlier phases' live objects
            reset_launches()
            trainer = train_ddpm.main(argv)
            torch.cuda.synchronize()
            paths[path] = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            own = peak - held / 2**30
            want = _step_launches(trainer.step.forwards, trainer.step.backwards, bf16=True,
                                  remat=remat_launches(trainer.unet) if remat else (0, 0))
            losses = _scalars(trainer.run_dir / "train" / "scalars.jsonl")["loss"]
            log(f"train_remat: {path}: {trainer.step.backwards} steps, {trainer.step.forwards} "
                f"forwards; launches {paths[path]}; losses {[round(v, 5) for v in losses]}")
            if paths[path] != want:
                raise PhaseError(f"{path}: launches {paths[path]} != expected {want}")
            if len(losses) != 2 * TRAIN_STEPS_PER_EPOCH or not all(map(math.isfinite, losses)):
                raise PhaseError(f"{path}: losses {losses}")
            (n0, s0), (n1, s1) = trainer.epoch_times
            rates[path] = {"images_per_s": n1 / s1, "images_per_s_epoch1": n0 / s0,
                           "peak_gib": peak, "peak_above_start_gib": own}
        found = _trace_kernels(trainer.profile_path, TRACE_KERNELS + ("flash_bwd_dkv_tc_kernel",
                                                                    "flash_bwd_dq_tc_kernel"))
        log(f"train_remat: --profile_dir trace of steps 2-4 {trainer.profile_path.name} "
            f"names {found}")
    a, b = rates["train_simplex"], rates["train_remat"]
    log(f"train_remat: simplex noise, batch {TRAIN_BATCH}: without remat {a['images_per_s']:.1f} "
        f"images/s in epoch 2 ({a['images_per_s_epoch1']:.1f} in epoch 1), peak device memory "
        f"{a['peak_gib']:.2f} GiB ({a['peak_above_start_gib']:.2f} above what was allocated at "
        f"its start); with remat {b['images_per_s']:.1f} ({b['images_per_s_epoch1']:.1f}), peak "
        f"{b['peak_gib']:.2f} GiB ({b['peak_above_start_gib']:.2f}); card {CARD}")
    log(json.dumps({"train_remat": {**rates, "remat_grad_max_rel_err": worst, "card": CARD}}))
    log(f"train_remat: phase took {time.perf_counter() - t0:.1f} s")
    return paths



# the pipeline scripts (python -m ddpm_ood_tpu_torch.<script>)
PIPELINE_TIMEOUT = 900  # seconds a script may take, as a whole
DEMO_OUT = ("MNIST", "FashionMNIST_vflip", "FashionMNIST_hflip")
LDM3D_RUNS = (("plms", {}), ("dpm", {"SAMPLER": "dpm", "STEPS": "25", "SKIP": "1"}))
PIPELINE_COLUMNS = ("mse", "perceptual_difference")
LDM3D_SETS = 2 + 9  # val, in and the nine held-out Decathlon tasks, 4 volumes each
PREP_COUNTS = {"FashionMNIST": (40, 8), "MNIST": (20, 8), "CIFAR10": (10, 4), "SVHN": (6, 4)}
# the dataset prep as ``python -m``, with urllib's download refused: every raw
# file is in place, so it must not be asked for
OFFLINE_PREP = ("import runpy, sys, urllib.request\n"
                "def refuse(url, dest):\n"
                "    raise OSError(f'no download in chip_smoke.py (asked for {url})')\n"
                "urllib.request.urlretrieve = refuse\n"
                "sys.argv = ['get_computer_vision_datasets', '--data_root', sys.argv[1]]\n"
                "runpy.run_module('ddpm_ood_tpu_torch.data.get_computer_vision_datasets', "
                "run_name='__main__')\n")


def _python(args: list, what: str, env: dict = None) -> tuple:
    """``python <args>`` from the repo root in a fresh interpreter; (seconds,
    stdout). A non-zero exit fails the phase with the output's end."""
    log(f"{what}: python " + " ".join(args if args[0] != "-c" else ["-c", "...", *args[2:]]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=PIPELINE_TIMEOUT, env={**os.environ, **(env or {})})
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise PhaseError(f"{what} exited {proc.returncode} after {seconds:.1f} s:\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return seconds, proc.stdout


def _aurocs(path: Path) -> dict:
    with open(path, newline="") as fh:
        return {r["ood_data"]: float(r["Zscore_mse"]) for r in csv.DictReader(fh)}


def _write_raw_archives(raw: Path) -> dict:
    """MNIST and FashionMNIST as gzipped IDX, CIFAR-10 as its python tarball,
    SVHN as its .mat files: the raw tree the dataset prep reads offline.
    Returns one known image per dataset, {dataset: (split, index, array)}."""
    import gzip
    import io
    import pickle
    import struct
    import tarfile

    from scipy.io import savemat

    rng = np.random.default_rng(0)
    known = {}
    for name, (n_train, n_test) in PREP_COUNTS.items():
        d = raw / name / "raw"
        d.mkdir(parents=True)
        if name in ("FashionMNIST", "MNIST"):
            for stem, n in (("train-images-idx3-ubyte", n_train), ("t10k-images-idx3-ubyte",
                                                                   n_test)):
                imgs = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
                with gzip.open(d / f"{stem}.gz", "wb") as f:
                    f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
                known.setdefault(name, ("train", 3, imgs[3]))
        elif name == "CIFAR10":
            batches = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
            with tarfile.open(d / "cifar-10-python.tar.gz", "w:gz") as tf:
                for b in batches:
                    n = n_test if b == "test_batch" else n_train // 5
                    data = rng.integers(0, 256, size=(n, 3072), dtype=np.uint8)
                    blob = pickle.dumps({b"data": data, b"labels": [0] * n})
                    info = tarfile.TarInfo(f"cifar-10-batches-py/{b}")
                    info.size = len(blob)
                    tf.addfile(info, io.BytesIO(blob))
                    if b == "test_batch":
                        known[name] = ("test", 1, data[1].reshape(3, 32, 32))
        else:
            for fname, n in (("train_32x32.mat", n_train), ("test_32x32.mat", n_test)):
                x = rng.integers(0, 256, size=(32, 32, 3, n), dtype=np.uint8)
                savemat(d / fname, {"X": x, "y": np.ones((n, 1))})
                known.setdefault(name, ("train", 2, np.transpose(x[..., 2], (2, 0, 1))))
    return known


def _demo_counted(root: Path) -> dict:
    """The demo's stage argv lists run in this process, the launch counts set
    to 0 before each stage and read after it; returns their sums."""
    import contextlib
    import io

    from ddpm_ood_tpu_torch import demo, ood_detection, reconstruct, train_ddpm

    ws = root / "demo_counted"
    demo.make_dataset(ws)
    launches = {}
    for module, argv in demo.stages(ws, 2, "cuda"):
        reset_launches()
        if module == "train_ddpm":
            trainer = train_ddpm.main(argv)
            torch.cuda.synchronize()
            got = read_launches()
            want = _step_launches(trainer.step.forwards + trainer.sample_forwards,
                                  trainer.step.backwards, bf16=True)
            if got != want:
                raise PhaseError(f"pipelines demo train_ddpm: launches {got} != {want}")
        elif module == "reconstruct":
            recon = reconstruct.main(argv)
            torch.cuda.synchronize()
            got = read_launches()
            _check_launches(got, sum(p.model_evals for p in recon._programs.values()),
                            "pipelines demo reconstruct", bf16=True)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                auc = ood_detection.main(argv)[demo.MODEL]["Zscore_mse"][0]
            got = read_launches()
            if any(got.values()):
                raise PhaseError(f"ood_detection launched kernels: {got}")
        log(f"pipelines: demo {module} in this process, launches {got}")
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    log(f"pipelines: the demo's stages in this process: MNIST AUROC {auc:.4f}")
    return launches


def _library_example() -> float:
    import contextlib
    import io

    from ddpm_ood_tpu_torch import minimal_library_usage

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        auc = minimal_library_usage.main(["--device=cuda"])
    lines = printed.getvalue().splitlines()
    log("pipelines: library example: " + " | ".join(lines))
    if not (math.isfinite(auc) and lines[-1] == f"AUROC: {auc:.3f}"):
        raise PhaseError(f"the library example printed no finite AUROC: {lines}")
    return auc


def _timed(fn, *args) -> tuple:
    t0 = time.perf_counter()
    out = fn(*args)
    return time.perf_counter() - t0, out


def start_ldm3d_smokes(pool, root: Path) -> dict:
    """The 3D LDM smoke with PLMS and with DPM-Solver++, each in a fresh
    interpreter on `pool`: {name: future of (seconds, output)}, which
    phase_pipelines checks. They start before the latent-diffusion phases,
    beside which they run."""
    return {f"ldm3d_{sampler}": pool.submit(
        _python, ["-m", "ddpm_ood_tpu_torch.smoke_3d_ldm", str(root / f"ldm3d_{sampler}"),
                  "--device=cuda"], f"pipelines ldm3d_{sampler}", env)
        for sampler, env in LDM3D_RUNS}


def phase_pipelines(dev: torch.device, root: Path, ldm3d: dict) -> dict:
    """The pipeline scripts on the card, each in a fresh interpreter and all
    at once: the demo and the dataset prep of a crafted raw tree with no
    download, beside the 3D LDM smokes that ``start_ldm3d_smokes`` started
    (`ldm3d`, their futures); meanwhile, in this process, the demo's stages
    with the launch counts and the library example. Then the parity run on
    the prepped splits with its training and scoring outputs in place. The
    seconds of the stages overlap. Returns the launch counts of the demo's
    stages."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from ddpm_ood_tpu_torch import demo
    from ddpm_ood_tpu_torch.diffusion.ddim import ddim_timesteps
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps

    t_phase = time.perf_counter()
    raw = root / "raw"
    known = _write_raw_archives(raw)
    scripts = {"demo": (["-m", "ddpm_ood_tpu_torch.demo", "--device=cuda",
                         f"--workdir={root / 'demo'}"], None),
               "dataset_prep": (["-c", OFFLINE_PREP, str(raw)], None)}
    with ThreadPoolExecutor(max_workers=len(scripts)) as pool:
        running = {name: pool.submit(_python, args, f"pipelines {name}", env)
                   for name, (args, env) in scripts.items()}
        # one after the other: the launch counts are the process's
        counted_s, launches = _timed(_demo_counted, root)
        example_s, example_auc = _timed(_library_example)
        secs = {name: f.result()[0] for name, f in {**running, **ldm3d}.items()}
    secs.update(demo_counted=counted_s, library_example=example_s)

    run = root / "demo" / "output" / demo.MODEL
    if not (run / "checkpoint.pth").is_file() or not (run / "checkpoint_2.pth").is_file():
        raise PhaseError(f"the demo wrote no checkpoint.pth / checkpoint_2.pth under {run}")
    demo_starts = pndm_start_points(pndm_timesteps(1000, 10), 3)  # the demo's PLMS 10/3
    for name in ("val", "in", *DEMO_OUT):
        _check_csv(run / "ood" / f"results_{name}.csv", demo_starts, PIPELINE_COLUMNS, 8)
    demo_auc = _aurocs(run / "ood" / "ood_scores_mse.csv")
    log(f"pipelines: demo AUROCs {demo_auc}; card {CARD}")
    if list(demo_auc) != list(DEMO_OUT) or not demo_auc["MNIST"] >= 0.9:
        raise PhaseError(f"the demo's checkerboard AUROC is not >= 0.9: {demo_auc}")

    ldm_auc = {}
    for sampler, env in LDM3D_RUNS:
        steps, skip = int(env.get("STEPS", 10)), int(env.get("SKIP", 3))  # the smoke's defaults
        ood = root / f"ldm3d_{sampler}" / "output" / "ldm_decathlon" / "ood"
        csvs = sorted(ood.glob("results_*.csv"))
        if len(csvs) != LDM3D_SETS:
            raise PhaseError(f"smoke_3d_ldm {sampler}: {len(csvs)} results CSVs, "
                             f"expected {LDM3D_SETS}")
        grid = (pndm_timesteps if sampler == "plms" else ddim_timesteps)(1000, steps)
        for path in csvs:
            _check_csv(path, pndm_start_points(grid, skip), PIPELINE_COLUMNS, 4)
        ldm_auc[sampler] = _aurocs(ood / "ood_scores_mse.csv")
        log(f"pipelines: smoke_3d_ldm {sampler}: AUROCs {ldm_auc[sampler]}")

    splits = raw / "data_splits"
    for name, (n_train, n_test) in PREP_COUNTS.items():
        parts = {s: (splits / f"{name}_{s}.csv").read_text().split(",")
                 for s in ("train", "val", "test")}
        n_val = math.ceil(0.05 * n_train)
        if [len(parts[s]) for s in ("train", "val", "test")] != [n_train - n_val, n_val, n_test]:
            raise PhaseError(f"{name} split sizes {[len(v) for v in parts.values()]}")
        if not all(Path(p).is_file() for v in parts.values() for p in v):
            raise PhaseError(f"{name}: a split names a missing file")
        split, i, img = known[name]
        got = np.load(raw / name / "numpy" / split / f"{name}_{i}.npy")
        if got.dtype != np.uint8 or not np.array_equal(got, img):
            raise PhaseError(f"{name}: {split} image {i} is not the raw archive's")
    if list(splits.glob("CelebA_*")):
        raise PhaseError("dataset prep wrote CelebA splits with no CelebA raw files")
    log(f"pipelines: dataset prep wrote {len(list(splits.glob('*.csv')))} split CSVs, images "
        "bit-equal to the archives")

    # the demo's CSVs in place of the parity run's scoring (MNIST's stand in
    # for SVHN and CIFAR10), and a checkpoint_300.pth in place of training
    out_root = root / "parity_out"
    ood = out_root / "fashionmnist" / "ood"
    ood.mkdir(parents=True)
    (out_root / "fashionmnist" / "checkpoint_300.pth").write_bytes(b"")
    for name in ("val", "in", *DEMO_OUT):
        shutil.copy(run / "ood" / f"results_{name}.csv", ood / f"results_{name}.csv")
    for name in ("SVHN", "CIFAR10"):
        shutil.copy(run / "ood" / "results_MNIST.csv", ood / f"results_{name}.csv")
    secs["parity_run"], out = _python(["-m", "ddpm_ood_tpu_torch.parity_run", str(raw),
                                       str(out_root), "--device=cuda"], "pipelines parity_run")
    if not all(f"[parity] stage {i}" in out for i in (1, 2, 3)) or \
            not (ood / "auroc_table.json").is_file():
        raise PhaseError(f"parity_run did not skip stages 1-3 and write auroc_table.json:\n{out}")
    table = json.loads((ood / "auroc_table.json").read_text())["comparison"]
    log("pipelines: parity_run skipped stages 1-3, auroc_table.json "
        f"{ {k: v['measured_auroc'] for k, v in table.items()} }")

    secs["phase"] = time.perf_counter() - t_phase
    log(json.dumps({"pipelines": {"seconds": secs, "demo_auroc": demo_auc, "ldm3d_auroc": ldm_auc,
                                  "library_example_auroc": example_auc, "card": CARD}}))
    log(f"pipelines: phase took {secs['phase']:.1f} s")
    return launches


# Multi-process training and scoring, under python -m
# torch.distributed.run: the training phase's width (small UNet, 32x32x1),
# 512 images, at 1 rank on NCCL and at 2 ranks sharing the one card over gloo
# (DDPM_OOD_TORCH_SHARED_CARD=1, chosen here, never as a fallback: NCCL
# refuses two ranks on one device), each rank batch 64 for the frozen
# parity epoch so both runs compute every image in a batch of one shape.
DDP_IMAGES, DDP_SCORE_IMAGES, DDP_ZERO_IMAGES = 512, 64, 8
DDP_RANK_BATCH = 64
DDP_TRAIN_ARGS = ["--model_type=small", "--image_size=32", "--is_grayscale=1", "--n_epochs=2",
                  "--eval_freq=10", "--checkpoint_every=2", "--learning_rate=2e-4",
                  "--num_workers=4", "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015",
                  "--beta_end=0.0195", "--device=cuda"]
# the frozen epoch's mean loss, 2 ranks against 1: the same images in batches
# of one shape, summed in another order
DDP_LOSS_RTOL = 1e-4
# zero-noise scores (PLMS 10/3), 2 ranks against 1, batches of 4 on both: per
# image the same kernels on the same inputs; mse and LPIPS, relative
DDP_SCORE_RTOL = 1e-3
# --fsdp=1 at 2 ranks against DDP's first epoch, per step: the same
# parameters, data and noise, the gradients averaged by a reduce-scatter
# instead of an all-reduce (a sum of two and a halving, exact either way)
DDP_FSDP_RTOL = 1e-4
DDP_TIMEOUT = 600  # seconds a launch may take
DDP_STRIDE_WARNING = "Grad strides do not match bucket view strides"
# --quantize=int8 scoring at 2 ranks: 12 images at batch 2, PLMS 10/3, each
# rank's own noise; then a resume from partials holding 2 batches on rank 0
# and 1 on rank 1. Rank 0's one-process program on the global batches (each
# rank's i-th batch, rank order, their noise joined) is the reference. Every
# int8 product runs on qconv_s8, per image, under the global absmax, so the
# int8 scores at 2 ranks are held to the one-process ones at SHARD_INT8_REL
# (read: exact served, within 1.1e-7 in the CSV; a rank's own absmax moves a
# sweep by ~1e-3), and the scale itself exactly (each call's absmax the
# larger of the two ranks' own max |x|). Unquantised, cuDNN's bf16
# convolutions of 16 against 32 images sum in another order (read: median
# 2e-4, max 1.5e-3): those are held to the median relative difference and
# the correlation
DDP_QUANT_IMAGES, DDP_QUANT_BATCH, DDP_QUANT_HELD = 12, 2, (2, 1)
SHARD_INT8_REL = 1e-6
SHARD_MEDIAN_REL, SHARD_CORR = 1e-2, 0.999
# the service sharded over 2 ranks on the card (gloo) against 1 rank on NCCL:
# the small UNet at 32x32x1, batch 32, on PLMS 10/3 (4 start points, 26
# forwards a sweep; the main grid's 944 would take 46,256 gloo reductions of
# ~1 ms a sweep under int8, and PLMS 20/4's 50 put the phase past the
# pipeline scripts beside it), on a copy of the main run with a validation
# table at that grid
SHARD_SERVE_STEPS, SHARD_SERVE_SKIP = 10, 3
SHARD_SERVE_GRID = [f"--num_inference_steps={SHARD_SERVE_STEPS}",
                    f"--inference_skip_factor={SHARD_SERVE_SKIP}"]
SHARD_SERVE_ARGS = [f"--model_name={SMOKE_MODEL}", "--host=127.0.0.1", "--device=cuda",
                    *[a for a in MAIN_ARGS if not a.startswith(("--num_inference_steps",
                                                                "--inference_skip_factor"))],
                    *SHARD_SERVE_GRID]
SHARD_SERVE_SWEEPS = 4  # the warmup, a full batch, one image, a full batch after /reload


def _content_draw(num_train_timesteps: int):
    """(t, noise) as a function of each image's content, the same in any
    process count or batch packing: the frozen parity epoch's draws."""
    from ddpm_ood_tpu_torch.train.ddpm import channels_last

    def draw(x0: torch.Tensor):
        host = x0.float().cpu().numpy().reshape(len(x0), -1).astype(np.float64)
        t = (np.abs(host.sum(1)) * 9973.0).astype(np.int64) % num_train_timesteps
        noise = np.stack([np.random.default_rng(int(ti) + 17).normal(size=tuple(x0.shape[1:]))
                          for ti in t]).astype(np.float32)
        return (torch.from_numpy(t).to(x0.device),
                channels_last(torch.from_numpy(noise).to(x0.device)))

    return draw


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _ddp_train_record(trainer) -> dict:
    from ddpm_ood_tpu_torch.parallel import fsdp

    moments = [v for s in trainer.step.optimizer.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    params = list(trainer.unet.parameters())
    rec = {"forwards": trainer.step.forwards + trainer.sample_forwards,
           "backwards": trainer.step.backwards, "epoch_times": trainer.epoch_times,
           "start_epoch": trainer.start_epoch, "global_step": trainer.global_step,
           "best_loss": trainer.best_loss,
           "local_bytes": fsdp.sharded_bytes_per_device(params + moments),
           "shapes": [list(p.shape) for p in params],
           "sharded": sum(map(fsdp.is_sharded, params))}
    if not trainer.fsdp:
        rec["digest"] = _digest(params)
    return rec


def _wrapped_grads(device: torch.device, wrap: str) -> dict:
    """fp32 (TF32 off): the small UNet's gradients on this rank's half of a
    seeded batch of 8 under DDP (``wrap_ddp``) or ``--fsdp=1``'s FSDP2 wrap
    (gathered), and the same model's whole-batch gradients in this process
    without a wrap: the worst error relative to each tensor's largest value
    (``_grad_errs``), and the loss both ways."""
    from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
    from ddpm_ood_tpu_torch.parallel import fsdp
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.uniform(size=(8, 1, 32, 32)).astype(np.float32)).to(device)
    noise = torch.from_numpy(rng.standard_normal((8, 1, 32, 32)).astype(np.float32)).to(device)
    t = torch.from_numpy(rng.integers(0, 1000, 8)).to(device)
    rank, world = pmesh.process_index(), pmesh.process_count()
    part = slice(rank * 8 // world, (rank + 1) * 8 // world)
    sched = make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device)
    grads, losses = {}, {}
    for how in ("whole", wrap):
        model = seeded_unet(2).to(device, memory_format=torch.channels_last)
        if how == "ddp":
            kw = {"runner": pmesh.wrap_ddp(model, device)}
        elif how == "fsdp":
            replicated = fsdp.apply_fsdp(model, fsdp.min_size_from_env())
            kw = {"sync_grads": lambda: fsdp.sync_replicated_grads(replicated)}
        else:
            kw = {}
        step = DDPMTrainStep(model=model, sched=sched, **kw)
        batch = (x0, noise, t) if how == "whole" else (x0[part], noise[part], t[part])
        loss = step.grads(*batch)
        losses[how] = (loss if how == "whole" else pmesh.all_reduce_mean(loss)).item()
        grads[how] = {n: fsdp.full_tensor(p.grad).cpu() for n, p in model.named_parameters()}
    worst, name, shift_free, scale = _grad_errs(grads["whole"], grads[wrap])
    return {"grad_worst": worst, "grad_worst_name": name, "key_bias_grad": shift_free,
            "grad_scale": scale, "loss_whole": losses["whole"], "loss_wrapped": losses[wrap]}


class _AbsmaxCalls(list):
    """Every int8 product's (this rank's max |x|, the absmax it received),
    the model module's ``qconv_s8`` and ``qdot_s8`` wrapped while the
    ``with`` lasts. The pairs stay on the card until its end, so recording
    adds no host sync to the run it watches."""

    def __enter__(self):
        from ddpm_ood_tpu_torch.models import unet

        self._pairs, self._orig = [], (unet.qconv_s8, unet.qdot_s8)

        def recorded(fn):
            def call(x, absmax, *a, **k):
                self._pairs.append(torch.stack([x.detach().abs().amax().float(),
                                                absmax.detach().float().reshape(())]))
                return fn(x, absmax, *a, **k)
            return call

        unet.qconv_s8, unet.qdot_s8 = map(recorded, self._orig)
        return self

    def __exit__(self, *exc):
        from ddpm_ood_tpu_torch.models import unet

        unet.qconv_s8, unet.qdot_s8 = self._orig
        if self._pairs:
            self.extend(map(tuple, torch.stack(self._pairs).cpu().tolist()))
        return False


def _check_absmax_spans(ranks: list, calls: int, what: str) -> None:
    """Each rank made `calls` int8 products, and every one took the max over
    the ranks of their own max |x| (for one rank, its own)."""
    if not all(len(r) == calls > 0 for r in ranks):
        raise PhaseError(f"{what}: {[len(r) for r in ranks]} int8 calls, expected {calls}")
    spans = [len({got for _, got in pairs}) == 1 and pairs[0][1] == max(loc for loc, _ in pairs)
             for pairs in zip(*ranks)]
    log(f"{what}: {sum(spans)} of {len(spans)} int8 calls took the max over the "
        f"{len(ranks)} rank(s)' own max |x| on every rank")
    if not all(spans):
        raise PhaseError(f"{what}: an int8 call's absmax is not the max over the ranks")


def _held_close(a: list, b: list, rel: float, what: str) -> float:
    """The largest relative difference of two paired score lists, held to
    `rel`."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise PhaseError(f"{what}: scores {a.shape} against {b.shape}, or not finite")
    worst = float((np.abs(a - b) / np.abs(b)).max())
    log(f"ddp: {what}: largest relative difference {worst:.3e} (tolerance {rel:.0e})")
    if not worst <= rel:
        raise PhaseError(f"{what}: the scores differ by {worst:.3e} relative")
    return worst


def _ddp_quant_run(run: dict, device: torch.device, out: Path) -> dict:
    """``reconstruct.main`` under --quantize=int8 on this rank, every int8
    product's (this rank's max |x|, the absmax it received) recorded; its
    launch counts; partials of ``run["held"][rank]`` batches and the CLI
    again with --resume=1; on rank 0, the one-process program on the global
    batches (rank 0's reference)."""
    import dataclasses

    from ddpm_ood_tpu_torch import reconstruct
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.serve import NOISE_SEED
    from ddpm_ood_tpu_torch.trainers.reconstruct import _stem

    rank, world = pmesh.process_index(), pmesh.process_count()
    with _AbsmaxCalls() as calls:
        recon = reconstruct.main(run["argv"])
    torch.cuda.synchronize()
    program = next(iter(recon._programs.values()))
    rec = {"launches": read_launches(), "evals": program.model_evals, "absmax": calls,
           "batches": len(recon.batch_times), "batch_times": recon.batch_times}
    ood, k = recon.out_dir, len(program.t_starts)
    batches = [(list(b["filename"]), np.moveaxis(b["image"], 1, -1)) for b in recon.val_loader]
    torch.save(batches, out / f"quant_batches{rank}.pt")
    pmesh.coordination_barrier("quant scored")
    rec["merged"] = (ood / "results_val.csv").read_text()
    lines = (ood / f".results_val.shard{rank}.csv").read_text().splitlines()
    lines = lines[:1 + k * DDP_QUANT_BATCH * run["held"][rank]]
    (ood / f".results_val.shard{rank}.partial.csv").write_text(
        "\n".join(",".join(line.split(",")[1:]) for line in lines) + "\n")
    pmesh.coordination_barrier("quant read")
    if rank == 0:
        (ood / "results_val.csv").unlink()
    pmesh.coordination_barrier("quant partials written")
    resumed = reconstruct.main(run["argv"] + ["--resume=1"])
    rec.update(resumed=(ood / "results_val.csv").read_text(),
               resumed_batches=len(resumed.batch_times))
    # what an int8 call's all-reduce of its absmax costs: a 0-dim tensor on
    # the card, MAX over the ranks (through the host under gloo)
    scalar = torch.ones((), device=device)
    for n in (20, 500):  # a warm-up, then the timed run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            pmesh.all_reduce_max_(scalar)
        torch.cuda.synchronize()
    rec["absmax_reduce_us"] = (time.perf_counter() - t0) / 500 * 1e6
    if rank == 0:  # the one-process program on the global batches, noise joined
        per_rank = [torch.load(out / f"quant_batches{r}.pt", weights_only=False)
                    for r in range(world)]
        gens = [torch.Generator(device=device).manual_seed(NOISE_SEED + r) for r in range(world)]
        noise = iter([torch.cat([torch.randn((k,) + x.shape, generator=g, device=device)
                                 for g, (_, x) in zip(gens, group)], dim=1).cpu().numpy()
                      for group in zip(*per_rank)])
        one = dataclasses.replace(program, sharded=False, host_noise_fn=(
            lambda shape, t_starts: next(noise, np.zeros(shape, np.float32))))
        reference = {}
        for group in zip(*per_rank):
            t_starts, mse, _ = one(np.concatenate([x for _, x in group]))
            mse = mse.cpu().numpy()
            names = [f for names, _ in group for f in names]
            for j, f in enumerate(names):
                for i, t in enumerate(t_starts):
                    reference[f"{_stem(f)},{int(t)}"] = float(mse[i, j])
        one.close()
        rec["reference"] = reference
    pmesh.coordination_barrier("quant done")
    return rec


def serve_rank(spec_path: str) -> int:
    """One rank of a phase_ddp serve launch: ``serve.main`` (the CLI's entry
    point) with the spec's flags, the launch counts set to 0 before it and
    read once SIGTERM has ended it, with every int8 product's absmax
    (``_AbsmaxCalls``), to ``<out>/rank<r>.json``."""
    from ddpm_ood_tpu_torch import serve

    spec = json.loads(Path(spec_path).read_text())
    reset_launches()
    with _AbsmaxCalls() as calls:
        serve.main(spec["argv"])
    rank = int(os.environ.get("RANK", "0"))
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(
        {"launches": read_launches(), "absmax": calls}))
    return 0


def ddp_rank(spec_path: str) -> int:
    """One rank of a phase_ddp launch: every run of the spec in this process
    (one process group for all: torch names a re-made default group as the
    last, and the rendezvous store still holds that group's keys), each
    run's launch counts set to 0 before it and read after it; the records
    go to ``<out>/rank<r>.json``."""
    import torch.distributed as dist

    from ddpm_ood_tpu_torch import reconstruct, train_ddpm
    from ddpm_ood_tpu_torch.parallel import mesh as pmesh
    from ddpm_ood_tpu_torch.trainers import DDPMTrainer, Reconstruct
    from ddpm_ood_tpu_torch.trainers.base import resolve_device

    spec = json.loads(Path(spec_path).read_text())
    device = resolve_device("cuda")
    pmesh.initialize_distributed(device, need_group=True)
    rank, world = pmesh.process_index(), pmesh.process_count()
    records = []
    for run in spec["runs"]:
        reset_launches()
        t0 = time.perf_counter()
        rec = {"name": run["name"], "kind": run["kind"]}
        if run["kind"] == "train":
            rec.update(_ddp_train_record(train_ddpm.main(run["argv"])))
        elif run["kind"] == "parity":
            args = train_ddpm.parse_args(run["argv"])
            args.learning_rate = 1e-30
            trainer = DDPMTrainer(args, device)
            trainer._draw = _content_draw(trainer.sched.num_train_timesteps)
            rec["loss"] = trainer.train_epoch(0)
            rec.update(forwards=trainer.step.forwards, backwards=trainer.step.backwards)
        elif run["kind"] == "grads":
            rec.update(_wrapped_grads(device, run["wrap"]))
        elif run["kind"] == "score":
            recon = reconstruct.main(run["argv"])
            rec["evals"] = sum(p.model_evals for p in recon._programs.values())
            rec["batch_times"] = recon.batch_times
        elif run["kind"] == "quant":
            rec.update(_ddp_quant_run(run, device, Path(spec["out"])))
        else:  # zero-noise scoring
            args = reconstruct.parse_args(run["argv"])
            recon = Reconstruct(args, device)
            program = recon._program(args.inference_skip_factor)
            program.host_noise_fn = lambda shape, t_starts: np.zeros(shape, np.float32)
            recon.reconstruct(args)
            rec["evals"] = program.model_evals
            rec["csv"] = (recon.out_dir / "results_val.csv").read_text()
        torch.cuda.synchronize()
        rec.setdefault("launches", read_launches())
        rec["seconds"] = time.perf_counter() - t0
        log(f"ddp rank {rank}/{world} {run['name']}: {rec['seconds']:.1f} s, launches "
            f"{rec['launches']}")
        records.append(rec)
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(records))
    pmesh.coordination_barrier("records written")
    dist.destroy_process_group()
    return 0


def _ddp_launch(root: Path, name: str, nproc: int, runs: list, shared: bool) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc_per_node=<nproc>
    chip_smoke.py --ddp-rank <spec>``: (seconds, output, per-rank records);
    a failed launch returns its output and no records."""
    out = root / name
    out.mkdir()
    spec = out / "spec.json"
    spec.write_text(json.dumps({"out": str(out), "runs": runs}))
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("DDPM_OOD_TORCH_SHARED_CARD", None)
    if shared:
        env["DDPM_OOD_TORCH_SHARED_CARD"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(ROOT / "chip_smoke.py"), "--ddp-rank", str(spec)]
    log(f"ddp: {name}: python -m torch.distributed.run --standalone --nproc_per_node={nproc} "
        f"chip_smoke.py --ddp-rank ({', '.join(r['name'] for r in runs)})"
        + (" with DDPM_OOD_TORCH_SHARED_CARD=1 (gloo)" if shared else " (NCCL)"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=DDP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
        text, _ = proc.communicate()
        text += f"\nkilled after {DDP_TIMEOUT} s"
    seconds = time.perf_counter() - t0
    (out / "launch.log").write_text(text)
    for line in text.splitlines():
        if line.startswith("ddp rank"):
            log("  " + line)
    if proc.returncode != 0:
        return seconds, text, None
    records = [json.loads((out / f"rank{r}.json").read_text()) for r in range(nproc)]
    return seconds, text, [{rec["name"]: rec for rec in recs} for recs in records]


def _children(pid: int) -> list:
    """The processes whose parent is `pid` (from /proc)."""
    kids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(d.name))
    return kids


def _serve_launch(top: Path, name: str, nproc: int, quantize: str, images: np.ndarray) -> dict:
    """``python -m torch.distributed.run --nproc_per_node=<nproc> chip_smoke.py
    --serve-rank``: ``serve.main`` on a copy of the main run (2 ranks on the
    card over gloo, 1 on NCCL); POST /score a full batch and one image, a
    new checkpoint, POST /reload, a full batch again, /statz; then SIGTERM to
    every rank, as torchrun forwards it. Returns the responses, /statz, the
    ranks' launch counts and the launcher's exit code."""
    import threading

    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    out = top / "ddp" / name
    out.mkdir()
    run = _copy_run(top, f"ddp_{name}") / SMOKE_MODEL
    t_starts = pndm_start_points(pndm_timesteps(1000, SHARD_SERVE_STEPS), SHARD_SERVE_SKIP)
    table = [",filename,type,t,perceptual_difference,mse"]
    for t in t_starts:  # 4 validation rows a start point of the served grid
        for i in range(4):
            table.append(f"{len(table) - 1},v{i},val,{int(t)},{0.02 + 0.01 * i},{0.01 + 0.002 * i}")
    (run / "ood" / "results_val.csv").write_text("\n".join(table) + "\n")
    port = _free_port()
    argv = [f"--output_dir={run.parent}", *SHARD_SERVE_ARGS, f"--port={port}",
            f"--quantize={quantize}"]
    spec = out / "spec.json"
    spec.write_text(json.dumps({"out": str(out), "argv": argv}))
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONUNBUFFERED": "1"}
    env.pop("DDPM_OOD_TORCH_SHARED_CARD", None)
    if nproc > 1:
        env["DDPM_OOD_TORCH_SHARED_CARD"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(ROOT / "chip_smoke.py"), "--serve-rank", str(spec)]
    log(f"ddp: {name}: python -m torch.distributed.run --standalone --nproc_per_node={nproc} "
        f"chip_smoke.py --serve-rank: ddpm_ood_tpu_torch.serve.main({' '.join(argv)})"
        + (" with DDPM_OOD_TORCH_SHARED_CARD=1 (gloo)" if nproc > 1 else " (NCCL)"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, start_new_session=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    rec = {"name": name, "nproc": nproc, "quantize": quantize}
    try:
        while not any("serving OOD scores for " in ln for ln in lines):
            if proc.poll() is not None or time.perf_counter() - t0 > DDP_TIMEOUT:
                raise PhaseError(f"ddp {name}: the service did not start:\n"
                                 + "".join(lines[-60:]))
            time.sleep(0.2)
        rec["ready_seconds"] = time.perf_counter() - t0
        health = json.loads(_http(port, "/healthz")[1])
        # a request of 3 channels: rank 0 refuses it before the other ranks
        status, body = _http(port, "/score", _npy(np.repeat(images[:1], 3, axis=-1)))
        if status != 400:
            raise PhaseError(f"ddp {name}: a 3-channel /score got {status}: {body[:300]}")
        responses = []
        for request in (images, images[:1]):
            status, body = _http(port, "/score", _npy(request))
            if status != 200:
                raise PhaseError(f"ddp {name}: /score {status}: {body[:300]}")
            responses.append(json.loads(body)["scores"])
        save_checkpoint(run / "checkpoint.pth", seeded_unet(9).state_dict(), epoch=9)
        status, body = _http(port, "/reload", b"")
        if status != 200:
            raise PhaseError(f"ddp {name}: /reload {status}: {body[:300]}")
        status, body = _http(port, "/score", _npy(images))
        if status != 200:
            raise PhaseError(f"ddp {name}: /score after /reload {status}: {body[:300]}")
        responses.append(json.loads(body)["scores"])
        rec.update(health=health, responses=responses,
                   statz=json.loads(_http(port, "/statz")[1]))
        ranks = _children(proc.pid)
        rec["ranks_signalled"] = len(ranks)
        for pid in ranks:  # as torchrun forwards SIGTERM: every rank
            os.kill(pid, signal.SIGTERM)
        rec["returncode"] = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:  # torchrun starts each rank in a session of its own
            for pid in _children(proc.pid):
                os.kill(pid, signal.SIGKILL)
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        reader.join(timeout=10)
        (out / "launch.log").write_text("".join(lines))
    rec["seconds"] = time.perf_counter() - t0
    rec["log"] = "".join(lines)
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             if (out / f"rank{r}.json").is_file() else None for r in range(nproc)]
    rec["launches"] = [r and r["launches"] for r in ranks]
    rec["absmax"] = [r and r["absmax"] for r in ranks]
    return rec


def _served_mse(responses: list) -> list:
    """The per-(request, image, t) mse of a launch's responses, in order."""
    return [v["mse"] for scores in responses for r in scores for _, v in sorted(
        r["per_t"].items(), key=lambda kv: int(kv[0]))]


def _paired(a: list, b: list, what: str) -> dict:
    """Median relative difference and correlation of two paired score
    lists, held to SHARD_MEDIAN_REL and SHARD_CORR."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise PhaseError(f"{what}: scores {a.shape} against {b.shape}, or not finite")
    rel = np.abs(a - b) / np.abs(b)
    out = {"median_rel": float(np.median(rel)), "max_rel": float(rel.max()),
           "corr": float(np.corrcoef(a, b)[0, 1])}
    log(f"ddp: {what}: median relative difference {out['median_rel']:.3e} (< "
        f"{SHARD_MEDIAN_REL:.0e}), max {out['max_rel']:.3e}, correlation {out['corr']:.6f} "
        f"(> {SHARD_CORR})")
    if not (out["median_rel"] < SHARD_MEDIAN_REL and out["corr"] > SHARD_CORR):
        raise PhaseError(f"{what}: the scores do not agree: {out}")
    return out


def _check_ddp_quant(a: dict, b: dict) -> dict:
    """--quantize=int8 scoring at 2 ranks: 27 + 4 + 49 + 49 launches a
    forward on each rank; every int8 product's absmax the larger of the two
    ranks' own max |x|; the merged CSV against rank 0's one-process program
    on the global batches; the resume from unequal partials."""
    for rank, rec in enumerate((a, b)):
        what = f"ddp quant, rank {rank}"
        _check_launches(rec["launches"], rec["evals"], what, bf16=True)
        int8 = QUANT_SITES * rec["evals"]
        if (rec["launches"]["quant_absmax"], rec["launches"]["quantize_codes"],
                rec["launches"]["qconv_s8"]) != (int8, int8, int8):
            raise PhaseError(f"{what}: launches {rec['launches']}, expected {int8} int8 each")
    _check_absmax_spans([a["absmax"], b["absmax"]], QUANT_SITES * a["evals"], "ddp quant")
    merged = {k: float(r["mse"]) for k, r in _csv_rows(a["merged"]).items()}
    reference = {tuple(k.split(",")[:1]) + (int(k.split(",")[1]),): v
                 for k, v in a["reference"].items()}
    if sorted(merged) != sorted(reference) or a["merged"] != b["merged"]:
        raise PhaseError("ddp quant: the merged CSV's rows are not the global batches'")
    keys = sorted(reference)
    csv_worst = _held_close([merged[k] for k in keys], [reference[k] for k in keys],
                            SHARD_INT8_REL, "int8 merged CSV mse at 2 ranks against the "
                            "one-process program on the global batches")
    held = DDP_QUANT_IMAGES // (2 * DDP_QUANT_BATCH)
    resumed = {k: float(r["mse"]) for k, r in _csv_rows(a["resumed"]).items()}
    worst = max(abs(resumed[k] - merged[k]) / abs(merged[k]) for k in merged)
    log(f"ddp quant: resume from partials of {list(DDP_QUANT_HELD)} batches: "
        f"{a['resumed_batches']} and {b['resumed_batches']} of {held} batches rescored; the "
        f"merged CSV reproduced to {worst:.2e} relative (tolerance {RESUME_TOL:.0e})")
    if (sorted(resumed) != sorted(merged) or not worst <= RESUME_TOL
            or [a["resumed_batches"], b["resumed_batches"]] != [held - min(DDP_QUANT_HELD)] * 2):
        raise PhaseError("ddp quant: the resume did not reproduce the merged CSV")
    per_forward = [QUANT_SITES * rec["absmax_reduce_us"] / 1e3 for rec in (a, b)]
    log(f"ddp quant: one absmax all-reduce at 2 ranks on the card over gloo: "
        f"{a['absmax_reduce_us']:.1f} / {b['absmax_reduce_us']:.1f} us (rank 0 / 1, 500 in a "
        f"row), {per_forward[0]:.2f} / {per_forward[1]:.2f} ms a forward of {QUANT_SITES} int8 "
        f"calls, on {CARD}")
    return {"csv_worst_rel": csv_worst, "resume_worst_rel": worst,
            "int8_calls": len(a["absmax"]),
            "absmax_reduce_us": [a["absmax_reduce_us"], b["absmax_reduce_us"]],
            "seconds": [a["seconds"], b["seconds"]]}


def _check_serve_sharded(recs: dict) -> dict:
    """The serve launches: every rank exited 0 on SIGTERM and counted 27
    GroupNorm and 4 flash launches (and 49 + 49 int8 under int8) a forward
    of its SHARD_SERVE_SWEEPS sweeps, every int8 absmax the max over the
    ranks; 2 ranks' responses against 1 rank's, before and after /reload
    (int8 at SHARD_INT8_REL); the seconds of a served sweep."""
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts

    ts = pndm_timesteps(1000, SHARD_SERVE_STEPS)
    forwards = sum(len(a) for a, _ in group_t_starts(ts, pndm_start_points(ts, SHARD_SERVE_SKIP),
                                                       16))
    evals = SHARD_SERVE_SWEEPS * forwards
    summary = {}
    for quantize in ("none", "int8"):
        one, two = recs[(1, quantize)], recs[(2, quantize)]
        for rec in (one, two):
            what = f"ddp serve, {rec['nproc']} rank(s), --quantize={quantize}"
            statz = rec["statz"]
            if (rec["returncode"] != 0 or rec["ranks_signalled"] != rec["nproc"]
                    or rec["health"]["world_size"] != rec["nproc"]
                    or (statz["world_size"], statz["sweeps"], statz["reloads"])
                    != (rec["nproc"], 3, 1)
                    or "draining in-flight requests and shutting down" not in rec["log"]):
                raise PhaseError(f"{what}: exit {rec['returncode']}, {rec['ranks_signalled']} "
                                 f"ranks signalled, /statz {statz}:\n{rec['log'][-3000:]}")
            if rec["nproc"] > 1 and "waiting for rank 0 to stop" not in rec["log"]:
                raise PhaseError(f"{what}: rank 1 did not wait for rank 0's stop")
            for rank, launches in enumerate(rec["launches"]):
                if launches is None:
                    raise PhaseError(f"{what}: rank {rank} wrote no launch counts")
                _check_launches(launches, evals, f"{what}, rank {rank}", bf16=True)
                int8 = QUANT_SITES * evals if quantize == "int8" else 0
                if (launches["quant_absmax"], launches["quantize_codes"],
                        launches["qconv_s8"]) != (int8, int8, int8):
                    raise PhaseError(f"{what}, rank {rank}: {launches}, expected {int8} "
                                     "quant_absmax, quantize_codes and qconv_s8 launches")
            if quantize == "int8":
                _check_absmax_spans(rec["absmax"], QUANT_SITES * evals, what)
        for i, what in enumerate(("a full batch", "one image (wrap-padded)",
                                  "a full batch after /reload")):
            got, want = _served_mse([two["responses"][i]]), _served_mse([one["responses"][i]])
            what = f"served per-t mse, --quantize={quantize}, {what}, 2 ranks against 1"
            if quantize == "int8":
                _held_close(got, want, SHARD_INT8_REL, what)
            else:
                _paired(got, want, what)
        if _served_mse(two["responses"][:1]) == _served_mse(two["responses"][2:]):
            raise PhaseError(f"ddp serve --quantize={quantize}: /reload changed no score")
        summary[quantize] = {
            f"{rec['nproc']} rank(s)": {
                "mean_sweep_seconds": rec["statz"]["mean_sweep_seconds"],
                "ready_seconds": rec["ready_seconds"], "seconds": rec["seconds"]}
            for rec in (one, two)}
        log(f"ddp: served sweep ({forwards} forwards, batch {N_IMAGES}, --quantize={quantize}) "
            f"on {CARD}: 1 rank (NCCL) {one['statz']['mean_sweep_seconds']:.3f} s, 2 ranks on "
            f"the card (gloo) {two['statz']['mean_sweep_seconds']:.3f} s (/statz, the 3 "
            "requests' mean, contended by the phase's other launches)")
    return summary


def _csv_rows(text: str) -> dict:
    """{(filename, t): row} of a results CSV's text, the first of each."""
    rows = {}
    for r in csv.DictReader(text.splitlines()):
        rows.setdefault((r["filename"], int(r["t"])), r)
    return rows


def _ddp_check_train(rec: dict, what: str, steps: int, images: int, start: int) -> None:
    """A train run of one rank: its backwards, start epoch and image count,
    and 27 GroupNorm and 4 flash launches a forward, 4 dK/dV and 4 dQ a
    step, all on the cluster and tensor-core kernels."""
    want = _step_launches(rec["forwards"], rec["backwards"], bf16=True)
    if rec["launches"] != want:
        raise PhaseError(f"ddp {what}: launches {rec['launches']} != expected {want}")
    got = (rec["backwards"], rec["start_epoch"], rec["global_step"])
    if got != (steps, start, images):
        raise PhaseError(f"ddp {what}: (steps, start epoch, global_step) {got}, expected "
                         f"{(steps, start, images)}")
    if not math.isfinite(rec["best_loss"]):
        raise PhaseError(f"ddp {what}: loss {rec['best_loss']}")


def _ddp_fsdp_bytes(rec: dict, world: int, what: str) -> dict:
    """Parameters and Adam's moments on the card against the policy's
    arithmetic (``bench_fsdp_hbm``'s)."""
    from ddpm_ood_tpu_torch.parallel import fsdp

    planned = 3 * fsdp.planned_bytes_per_device(rec["shapes"], world)
    full = 3 * fsdp.planned_bytes_per_device(rec["shapes"], 1)
    if rec["local_bytes"] != planned or not rec["sharded"]:
        raise PhaseError(f"ddp {what}: {rec['local_bytes']} bytes of parameters and moments on "
                         f"the card, {rec['sharded']} sharded; the policy gives {planned}")
    log(f"ddp: {what}: {rec['sharded']} of {len(rec['shapes'])} parameters sharded, "
        f"{rec['local_bytes'] / 2**20:.2f} MiB of parameters and Adam moments a card "
        f"(bench_fsdp_hbm's arithmetic {planned / 2**20:.2f}; replicated {full / 2**20:.2f})")
    return {"MiB": rec["local_bytes"] / 2**20, "planned_MiB": planned / 2**20,
            "replicated_MiB": full / 2**20}


def phase_ddp(dev: torch.device, root: Path) -> dict:
    """The multi-process path: train_ddpm under torchrun at 1 rank (NCCL)
    and 2 ranks on the one card (gloo), a resume of each, --fsdp=1 at 1 and
    at 2 ranks, a frozen-parameter epoch at both, the scoring CLI at 2 ranks
    on 64 images (PLMS 100/4), zero-noise scoring (PLMS 10/3) at 1 and 2
    ranks, fp32 DDP and FSDP2 gradients at 2 ranks against the whole
    batch's, --quantize=int8 scoring at 2 ranks with a resume from unequal
    partials (``_ddp_quant_run``), and the serve CLI under torchrun at 1
    rank (NCCL) and 2 ranks on the card, unquantised and int8
    (``_serve_launch``). The seven launches run at once. Returns the launch
    counts of every rank's runs, summed, by path: "ddp", "ddp_quant" and
    "serve_sharded"."""
    from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
    from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    top, root = root, root / "ddp"
    root.mkdir()
    rng = np.random.default_rng(5)
    train_csv = _write_split(root, "train", DDP_IMAGES, False, rng)
    score_csv = _write_split(root, "score", DDP_SCORE_IMAGES, False, rng)
    serve_images = rng.uniform(size=(N_IMAGES, 32, 32, 1)).astype(np.float32)
    for name in ("score_cli", "score_zero1", "score_zero2", "score_quant"):
        (root / "output" / name).mkdir(parents=True)
        save_checkpoint(root / "output" / name / "checkpoint.pth", seeded_unet(3).state_dict())
    out = f"--output_dir={root / 'output'}"

    def train(name, model, batch, *extra):
        return {"name": name, "kind": "train", "argv": [
            out, f"--model_name={model}", f"--training_ids={train_csv}",
            f"--validation_ids={score_csv}", f"--batch_size={batch}", *DDP_TRAIN_ARGS, *extra]}

    def parity(model):
        return {"name": "parity", "kind": "parity", "argv": [
            out, f"--model_name={model}", f"--training_ids={train_csv}",
            f"--validation_ids={score_csv}", f"--batch_size={DDP_RANK_BATCH}", *DDP_TRAIN_ARGS]}

    scoring = [out, f"--validation_ids={score_csv}", f"--in_ids={score_csv}", "--run_in=0",
               "--run_out=0", "--device=cuda", *MAIN_ARGS[:3], *MAIN_ARGS[6:]]
    score = {"name": "score", "kind": "score", "argv": [
        *scoring, "--model_name=score_cli", "--batch_size=32", "--num_inference_steps=100",
        "--inference_skip_factor=4"]}

    def zero(model):
        return {"name": "zero", "kind": "zero", "argv": [
            *scoring, f"--model_name={model}", f"--first_n_val={DDP_ZERO_IMAGES}",
            "--batch_size=4", "--num_inference_steps=10", "--inference_skip_factor=3"]}

    quant = {"name": "quant", "kind": "quant", "held": DDP_QUANT_HELD, "argv": [
        *scoring, "--model_name=score_quant", f"--first_n_val={DDP_QUANT_IMAGES}",
        f"--batch_size={DDP_QUANT_BATCH}", "--num_inference_steps=10",
        "--inference_skip_factor=3", "--quantize=int8"]}

    launches_spec = [
        (root, "rank1", 1, [train("train", "ddp1", TRAIN_BATCH),
                            train("resume", "ddp1", TRAIN_BATCH, "--n_epochs=3"),
                            train("fsdp", "fsdp1", TRAIN_BATCH, "--n_epochs=1", "--fsdp=1"),
                            parity("parity1"), zero("score_zero1")], False),
        (root, "rank2", 2, [train("train", "ddp2", DDP_RANK_BATCH),
                            train("resume", "ddp2", DDP_RANK_BATCH, "--n_epochs=3"),
                            parity("parity2"), score, zero("score_zero2"),
                            {"name": "grads", "kind": "grads", "wrap": "ddp"}], True),
        # the quantised scoring run in the shorter of the two gloo launches
        (root, "fsdp2", 2, [train("fsdp", "fsdp2", DDP_RANK_BATCH, "--n_epochs=1",
                                  "--fsdp=1"),
                            {"name": "grads", "kind": "grads", "wrap": "fsdp"}, quant], True)]
    from concurrent.futures import ThreadPoolExecutor

    serve_spec = [(nproc, quantize) for quantize in ("none", "int8") for nproc in (1, 2)]
    with ThreadPoolExecutor(len(launches_spec) + len(serve_spec)) as pool:
        served = {key: pool.submit(_serve_launch, top, f"serve{key[0]}_{key[1]}", *key,
                                   serve_images) for key in serve_spec}
        one, two, fsdp2 = pool.map(lambda spec: _ddp_launch(*spec), launches_spec)
        served = {key: future.result() for key, future in served.items()}
    secs = {"rank1": one[0], "rank2": two[0], "fsdp2": fsdp2[0],
            **{f"serve{n}_{q}": rec["seconds"] for (n, q), rec in served.items()}}
    # DDP's reducer warns once when a gradient's strides differ from its
    # bucket view's (a copy of that gradient every step)
    stride_warned = {name: DDP_STRIDE_WARNING in text
                     for name, (_, text, _) in (("rank1", one), ("rank2", two), ("fsdp2", fsdp2))}
    log(f"ddp: DDP's bucket-view stride warning in the launches' output: {stride_warned}")
    if any(stride_warned.values()):
        raise PhaseError("ddp: DDP copied a gradient whose strides differ from its bucket "
                         f"view's: {stride_warned}")
    failed = [f"ddp {name} launch failed after {s:.1f} s:\n{text[-4000:]}"
              for name, (s, text, recs) in (("rank1", one), ("rank2", two), ("fsdp2", fsdp2))
              if recs is None]
    if failed:
        raise PhaseError("\n".join(failed))
    (r1,), (a, b) = one[2], two[2]

    # training: 2 epochs of 4 steps (1 rank: 128 a step; 2 ranks: 64 a rank),
    # then 1 more from the checkpoint of epoch 2; global_step is this
    # process's images; the 2 replicas are bit-identical
    _ddp_check_train(r1["train"], "1 rank train", 8, 8 * TRAIN_BATCH, 0)
    _ddp_check_train(r1["resume"], "1 rank resume", 4, 12 * TRAIN_BATCH, 2)
    for rank, rec in enumerate((a, b)):
        _ddp_check_train(rec["train"], f"2 ranks train, rank {rank}", 8, 8 * DDP_RANK_BATCH, 0)
        _ddp_check_train(rec["resume"], f"2 ranks resume, rank {rank}", 4, 12 * DDP_RANK_BATCH,
                         2)
    for run in ("train", "resume"):
        if a[run]["digest"] != b[run]["digest"]:
            raise PhaseError(f"ddp 2 ranks {run}: the replicas differ "
                             f"({a[run]['digest']} != {b[run]['digest']})")
    _check_checkpoint(root / "output" / "ddp1" / "checkpoint_2.pth", 2, 8 * TRAIN_BATCH, 8)
    _check_checkpoint(root / "output" / "ddp2" / "checkpoint_2.pth", 2, 8 * DDP_RANK_BATCH, 8)
    rate = {"1 rank": r1["train"]["epoch_times"][1][0] / r1["train"]["epoch_times"][1][1],
            "2 ranks": sum(r["train"]["epoch_times"][1][0] / r["train"]["epoch_times"][1][1]
                           for r in (a, b))}
    log(f"ddp: training images/s in epoch 2: {rate}; replicas identical after training and "
        f"resume ({a['resume']['digest']}); card {CARD}")

    # the frozen epoch: 2 ranks' mean loss against 1 rank's
    losses = [r1["parity"]["loss"], a["parity"]["loss"], b["parity"]["loss"]]
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    log(f"ddp: frozen-parameter epoch loss 1 rank {losses[0]:.8f}, 2 ranks {losses[1]:.8f} "
        f"(relative {rel:.2e}, tolerance {DDP_LOSS_RTOL:.0e})")
    if losses[1] != losses[2] or not rel <= DDP_LOSS_RTOL:
        raise PhaseError(f"ddp frozen epoch losses {losses} disagree")
    for rec, what in ((r1["parity"], "1 rank parity"), (a["parity"], "2 ranks parity"),
                      (b["parity"], "2 ranks parity")):
        want = _step_launches(rec["forwards"], rec["backwards"], bf16=True)
        if rec["launches"] != want:
            raise PhaseError(f"ddp {what}: launches {rec['launches']} != expected {want}")

    # --fsdp=1: 1 rank on NCCL, 2 on the card over gloo; the 2-rank epoch
    # against the DDP run's first epoch (same init, data and noise)
    f1, (fa, fb) = r1["fsdp"], fsdp2[2]
    _ddp_check_train(f1, "1 rank fsdp", 4, 4 * TRAIN_BATCH, 0)
    fsdp_bytes = {"1 rank": _ddp_fsdp_bytes(f1, 1, "fsdp at 1 rank")}
    for rank, rec in enumerate((fa["fsdp"], fb["fsdp"])):
        _ddp_check_train(rec, f"2 ranks fsdp, rank {rank}", 4, 4 * DDP_RANK_BATCH, 0)
        fsdp_bytes[f"2 ranks, rank {rank}"] = _ddp_fsdp_bytes(rec, 2,
                                                              f"fsdp at 2 ranks, rank {rank}")
    ddp_steps = _scalars(root / "output" / "ddp2" / "train" / "scalars.jsonl")["loss"][:4]
    fsdp_steps = _scalars(root / "output" / "fsdp2" / "train" / "scalars.jsonl")["loss"]
    rel_fsdp = max(abs(f - d) / abs(d) for f, d in zip(fsdp_steps, ddp_steps))
    log(f"ddp: --fsdp=1 at 2 ranks, step losses {fsdp_steps} against DDP's {ddp_steps} "
        f"(worst relative {rel_fsdp:.2e}, tolerance {DDP_FSDP_RTOL:.0e})")
    if len(fsdp_steps) != 4 or not rel_fsdp <= DDP_FSDP_RTOL:
        raise PhaseError("ddp: --fsdp=1 at 2 ranks does not follow DDP's first epoch")

    # the gradients themselves (Adam's updates do not see their scale): fp32,
    # 2 ranks' DDP and FSDP2 gradients against the whole batch's in-process
    grad_errs = {}
    for wrap, recs in (("ddp", (a, b)), ("fsdp", (fa, fb))):
        for rank, rec in enumerate(recs):
            g = rec["grads"]
            loss_err = abs(g["loss_wrapped"] - g["loss_whole"]) / abs(g["loss_whole"])
            grad_errs[f"{wrap} rank {rank}"] = g["grad_worst"]
            log(f"ddp: fp32 {wrap} gradients at 2 ranks against the whole batch's, rank {rank}: "
                f"worst rel_err={g['grad_worst']:.3e} ({g['grad_worst_name']}) "
                f"tol={GRAD_TOL:.0e}; loss rel_err={loss_err:.3e}; key-bias gradients at most "
                f"{g['key_bias_grad']:.3e} of a largest {g['grad_scale']:.3e}")
            if not (g["grad_worst"] <= GRAD_TOL and loss_err <= GRAD_TOL
                    and g["key_bias_grad"] <= 1e-5 * g["grad_scale"]):
                raise PhaseError(f"ddp: {wrap} gradients at 2 ranks, rank {rank}, differ from "
                                 f"the whole batch's: {g}")

    # scoring at 2 ranks: each rank a shard, rank 0 the merged CSV with
    # every (image, start point) once
    starts = pndm_start_points(pndm_timesteps(1000, 100), 4)
    ood = root / "output" / "score_cli" / "ood"
    _check_csv(ood / "results_val.csv", starts, PIPELINE_COLUMNS, DDP_SCORE_IMAGES)
    for r in range(2):
        if not (ood / f".results_val.shard{r}.csv").is_file():
            raise PhaseError(f"ddp score: no shard of rank {r}")
    for rank, rec in enumerate((a, b)):
        _check_launches(rec["score"]["launches"], rec["score"]["evals"],
                        f"ddp score, rank {rank}", bf16=True)
    recons = sum(n for rec in (a, b) for n, _ in rec["score"]["batch_times"])
    log(f"ddp: scoring CLI at 2 ranks on {DDP_SCORE_IMAGES} images: {recons} recons in "
        f"{max(rec['score']['seconds'] for rec in (a, b)):.1f} s")

    # zero noise: 2 ranks' merged scores against 1 rank's
    want, got = _csv_rows(r1["zero"]["csv"]), _csv_rows(a["zero"]["csv"])
    zero_starts = pndm_start_points(pndm_timesteps(1000, 10), 3)
    if sorted(want) != sorted(got) or len(want) != DDP_ZERO_IMAGES * len(zero_starts):
        raise PhaseError(f"ddp zero-noise: 2 ranks scored {sorted(got)[:4]}..., 1 rank "
                         f"{sorted(want)[:4]}...")
    worst = max(abs(float(got[k][c]) - float(want[k][c])) / max(abs(float(want[k][c])), 1e-12)
                for k in want for c in PIPELINE_COLUMNS)
    log(f"ddp: zero-noise scores, 2 ranks against 1: worst relative difference {worst:.2e} "
        f"(tolerance {DDP_SCORE_RTOL:.0e})")
    if not worst <= DDP_SCORE_RTOL:
        raise PhaseError(f"ddp zero-noise scores differ by {worst:.2e} relative")
    for rec, what in ((r1["zero"], "1 rank"), (a["zero"], "2 ranks"), (b["zero"], "2 ranks")):
        _check_launches(rec["launches"], rec["evals"], f"ddp zero-noise, {what}", bf16=True)

    quant_summary = _check_ddp_quant(fa["quant"], fb["quant"])
    serve_summary = _check_serve_sharded(served)

    def summed(records) -> dict:
        out = {}
        for rec in records:
            for k, v in rec.items():
                out[k] = out.get(k, 0) + v
        return out

    paths = {
        "ddp": summed(rec["launches"] for recs in (one[2], two[2], fsdp2[2])
                      for rank_recs in recs for name, rec in rank_recs.items()
                      if name != "quant"),
        "ddp_quant": summed(rec["quant"]["launches"] for rec in (fa, fb)),
        "serve_sharded": summed(launches for rec in served.values()
                                for launches in rec["launches"]),
    }
    log(f"ddp: launches a rank, ddp_quant: {[rec['quant']['launches'] for rec in (fa, fb)]}; "
        f"serve_sharded: { {rec['name']: rec['launches'] for rec in served.values()} }")
    secs["phase"] = time.perf_counter() - t_phase
    log(json.dumps({"ddp": {"seconds": secs, "train_images_per_s": rate,
                            "frozen_epoch_loss": losses[:2], "fsdp_bytes": fsdp_bytes,
                            "zero_noise_worst_rel": worst, "grad_worst_rel": grad_errs,
                            "stride_warning": stride_warned, "quant": quant_summary,
                            "serve_sharded": serve_summary, "card": CARD}}))
    log(f"ddp: phase took {secs['phase']:.1f} s")
    return paths


def main() -> int:
    t0 = time.perf_counter()
    try:
        device = phase_device()
        dev = torch.device("cuda", 0)
        phase_build()
        summary = phase_kernels(dev)
        phase_forward(dev)
        phase_train_step(dev)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            npz = _write_lpips_npz(root / "lpips.npz")
            os.environ["LPIPS_WEIGHTS_NPZ"] = str(npz)  # both scoring CLI runs read it
            phase_metrics(dev, npz)
            score, gaussian = phase_main(dev, root, npz)
            none_rows = _rows(root / "output" / SMOKE_MODEL / "ood" / "results_val.csv")
            phase_ood(root)
            served = phase_serve(dev, root)
            sampled = phase_sample(dev, root)
            samplers = phase_samplers(dev, root)
            simplex = phase_simplex_resume(dev, root, gaussian)
            quant_started = start_quant(root)
            phase_ldm_pieces(dev, npz)
            quant = phase_quant(quant_started, none_rows, gaussian["all"])
            # the 3D LDM smoke scripts beside the latent-diffusion and
            # training phases, and the torchrun launches beside the other
            # pipeline scripts: fresh interpreters, mostly starting up and
            # host-bound
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(len(LDM3D_RUNS)) as early:
                ldm3d = start_ldm3d_smokes(early, root)
                ldm = phase_ldm(dev, root)
                ldm_brats = phase_ldm_brats(dev, root)
                phase_vqvae_step(dev, npz)
                train_ldm = phase_train_ldm(dev, root)
                train = phase_train(dev)
                remat = phase_train_remat(dev)
                with ThreadPoolExecutor(1) as pool:
                    ddp_future = pool.submit(phase_ddp, dev, root)
                    pipelines = phase_pipelines(dev, root, ldm3d)
                    ddp = ddp_future.result()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    paths = {"score": score, "serve": served, "sample": sampled, "samplers": samplers,
             "simplex": simplex, "quant": quant, "ldm": ldm, "ldm_brats": ldm_brats,
             "train": train,
             "train_ldm": train_ldm, **remat, "pipelines": pipelines, **ddp}
    kernels = []
    for name, (src, tpu) in KERNELS.items():
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        row = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
               "launches": sum(by_path.values()), "launches_by_path": by_path}
        if name in TC_COUNTED:
            row["tensor_core_launches"] = sum(p.get(f"{name}_tc", 0) for p in paths.values())
        if name == "groupnorm_act":
            row["cluster_launches"] = sum(p.get("groupnorm_act_cluster", 0)
                                          for p in paths.values())
        kernels.append({**row, **summary[name]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:  # a rank of phase_ddp's torchrun launches
        sys.exit(ddp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-rank"]:  # a rank of phase_ddp's serve launches
        sys.exit(serve_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--quant-run"]:  # phase_quant's scoring interpreter
        sys.exit(quant_run(sys.argv[2]))
    sys.exit(main())
