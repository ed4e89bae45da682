#!/usr/bin/env python3
"""Time the port's GroupNorm forward kernels at large samples and the cluster kernel's edge.

    python3 bench_groupnorm.py [--earlier=DIR] [--json=PATH]

At each (B, N, C) of ``SHAPES`` (G = 32, seeded inputs in [-1, 1)), in bf16
and fp32, it holds every kernel's output against the plain version
(``chip_smoke.GN_TOL``), then times (device time, ``time_cuda``):
- the large-sample kernel (csrc/groupnorm.cu) at ``large_plan``'s plan
  (one block to an SM, tiles in shared memory where they fit), at a plan of
  smaller tiles that fit two blocks to an SM ("large_2", where the sample
  has at most MAX_TILES of them), and with its tiles streamed from device
  memory twice ("streamed", the layout of a two-pass design);
- the cluster kernel (csrc/groupnorm_cluster.cu) where its plan takes the
  shape;
- ``F.group_norm`` on a channels-last view of the same memory, the plain
  version, and the bound (one read of x, one write, ``bench_attention.bound``);
- with ``--earlier=<root of an older checkout>``, that checkout's own
  ``ddpm_groupnorm_act`` (the one-block-per-group kernel the large-sample
  kernel replaced), built from its sources by its own ``ops/_kernels.py`` and
  called through its C signature, in the same process.
It prints the card's name and power limit, one JSON object per shape and
dtype, and writes the list to ``--json``. SiLU is timed at the first shape.
One CUDA card is required.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
from pathlib import Path

import torch

from bench_attention import bound, time_cuda
from chip_smoke import GN_TOL

# the 3D small UNet's level 0 on 20x20x16 latents (384, 256 and 128
# channels) at batch 64 and at the sweep's lane groups of 3 and 2 lanes x 8,
# the 2D small UNet's level 0 at 64x64 and at 32x32
SHAPES = [(64, 6400, 384), (64, 6400, 256), (24, 6400, 384), (24, 6400, 256), (16, 6400, 384),
          (16, 6400, 256), (64, 4096, 256), (64, 4096, 384), (64, 6400, 128), (24, 6400, 128),
          (64, 4096, 128), (64, 1024, 384), (64, 1024, 256), (64, 1024, 128)]
GROUPS = 32


def earlier_library(root: Path):
    """The ctypes library of the checkout at `root`, built by its own
    ``ops/_kernels.py`` (into its own ``_build``), with that file's
    ``SIGNATURES`` bound."""
    spec = importlib.util.spec_from_file_location(
        "earlier_kernels", root / "ddpm_ood_tpu_torch" / "ops" / "_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.library()


def two_per_sm_plan(n: int, c: int, itemsize: int):
    """The fewest resident tiles whose blocks fit two to an SM, or None; the
    launcher then puts two on an SM, as its occupancy query allows."""
    from ddpm_ood_tpu_torch.ops import groupnorm as gn

    budget = gn.SM_SHARED_BYTES // 2 - gn.BLOCK_RESERVED_BYTES
    for tiles in range(max(1, -(-n * c * itemsize // budget)), min(n, gn.MAX_TILES) + 1):
        rows = -(-n // tiles)
        threads, real, smem = gn.large_layout(n, c, GROUPS, itemsize, 16, rows, True)
        if smem <= budget:
            return gn.LargePlan(16, rows, real, 1, threads, smem)
    return None


def launch(kernel, plan, x, gamma, beta, act):
    """One launch of the GroupNorm `kernel` ("cluster" or "large") with the
    given plan, whichever kernel ``kernel_for`` would pick for x."""
    from ddpm_ood_tpu_torch.ops import _kernels

    b, n, c = x.shape
    out = torch.empty_like(x)
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr())
    shape = (b, n, c, GROUPS, 1e-6, int(act == "silu"), _kernels.DTYPE_CODES[x.dtype])
    target = _kernels.cuda_target(x, "bench_groupnorm")
    if kernel == "cluster":
        _kernels.call("ddpm_groupnorm_act_cluster", *args, *shape, *plan, *target)
    else:
        work = torch.empty(b + b * plan.tiles * 2 * GROUPS, dtype=torch.int32, device=x.device)
        _kernels.call("ddpm_groupnorm_act", *args, work.data_ptr(), *shape, plan.vec_bytes,
                      plan.rows, plan.resident, plan.smem, *target)
    return out


def main(argv=None) -> list:
    import torch.nn.functional as F

    from ddpm_ood_tpu_torch.ops import _kernels
    from ddpm_ood_tpu_torch.ops import groupnorm as gn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path, default=None)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_groupnorm: no CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    _kernels.library()
    earlier = earlier_library(args.earlier) if args.earlier else None
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for i, (b, n, c) in enumerate(SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.rand((b, n, c), generator=gen, device=dev) * 2 - 1).to(dtype)
            gamma = torch.rand((c,), generator=gen, device=dev) + 0.5
            beta = torch.rand((c,), generator=gen, device=dev) - 0.5
            itemsize = x.element_size()
            plans = {"large": ("large", gn.large_plan(n, c, GROUPS, itemsize))}
            two = two_per_sm_plan(n, c, itemsize)
            if two is not None:
                plans["large_2"] = ("large", two)
            streamed = -(-n // min(n, gn.MAX_TILES))
            threads, tiles, smem = gn.large_layout(n, c, GROUPS, itemsize, 16, streamed, False)
            plans["large_streamed"] = ("large", gn.LargePlan(16, streamed, tiles, 0, threads,
                                                             smem))
            cplan = gn.cluster_plan(n, c, GROUPS, itemsize)
            if cplan is not None:
                plans["cluster"] = ("cluster", cplan)
            calls = {name: (lambda kernel=kernel, plan=plan, act="none": launch(
                kernel, plan, x, gamma, beta, act)) for name, (kernel, plan) in plans.items()}
            if earlier is not None:
                mod, lib = earlier

                def old(act="none"):
                    out = torch.empty_like(x)
                    mod.check_rc(lib, lib.ddpm_groupnorm_act(
                        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), b, n, c,
                        GROUPS, 1e-6, int(act == "silu"), _kernels.DTYPE_CODES[dtype], 0,
                        torch.cuda.current_stream(dev).cuda_stream), "earlier groupnorm")
                    return out
                calls["earlier"] = old
            acts = ("none", "silu") if i == 0 else ("none",)
            row = {"shape": [b, n, c], "dtype": str(dtype)[6:], "card": card,
                   **bound(2 * x.numel() * itemsize + 2 * c * 4, 8 * x.numel(), dtype),
                   "plans": {name: list(p) for name, (_, p) in plans.items()}}
            for act in acts:
                ref = gn.groupnorm_act_reference(x, gamma, beta, GROUPS, 1e-6, act)
                for name, fn in calls.items():
                    got = fn(act=act)
                    torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs().max().item()
                    if not (math.isfinite(err) and err <= GN_TOL[dtype]):
                        raise SystemExit(f"bench_groupnorm: {name} at {(b, n, c)} {dtype} {act} "
                                         f"is {err} off the plain version (tol {GN_TOL[dtype]})")
                    if name.startswith("large") and not torch.equal(got, fn(act=act)):
                        raise SystemExit(f"bench_groupnorm: {name} at {(b, n, c)} {dtype} {act}:"
                                         " two launches differ")
                    row[f"{name}_ms" + ("_silu" if act == "silu" else "")] = time_cuda(
                        lambda fn=fn, act=act: fn(act=act))
                    row.setdefault("max_abs_err", {})[f"{name} {act}"] = err
            nd = 3 if n == 6400 else 2
            spatial = (20, 20, 16) if n == 6400 else (math.isqrt(n),) * 2
            xl = x.reshape((b,) + spatial + (c,)).permute((0, nd + 1) + tuple(range(1, nd + 1)))
            g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
            row["library_ms"] = time_cuda(lambda: F.group_norm(xl, GROUPS, g_lib, b_lib, 1e-6),
                                          iters=5, reps=3)
            row["plain_ms"] = time_cuda(
                lambda: gn.groupnorm_act_reference(x, gamma, beta, GROUPS, 1e-6), iters=5, reps=3)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del x, ref
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
