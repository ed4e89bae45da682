#!/usr/bin/env python3
"""Time the port's flash-attention kernels in bf16 beside SDPA and their bounds, on one CUDA card.

    python3 bench_attention.py [--label=NAME]    # from the root of a checkout

At each (B*H, N, D) of ``SHAPES`` it times ``flash_attention_fwd``,
``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq`` on seeded inputs of
std 0.5 (device time, ``time_cuda``), one PyTorch call for the same work
(``scaled_dot_product_attention`` forward, and its backward for the two
backward kernels together), and each kernel's bound (``attention_bounds``). It
prints the card's name and power limit, one JSON object per shape, and the
kernels' launch counts.

It also holds the yardstick that ``chip_smoke.py`` times every kernel with:
``time_cuda``, ``bound`` and the card's peak rates. It imports the port from
the directory it is run in and uses only what every version of the port since
the backward kernels has, so a copy of this file at the root of an older
checkout times that checkout's kernels: put two checkouts in one call to
compare them on one card. The card is required.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import torch

MEM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
SLEEP_CLOCK_HZ = 2.0e9  # at or above the H100's SM clock, so a sleep lasts at least as asked
# dense tensor cores (bf16; int8 in ops a second) / CUDA cores (fp32)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12, torch.float32: 67e12}
# (B*H, N, D): training (batch 128), scoring (64 images), and two ragged ones
SHAPES = [(128, 64, 256), (64, 64, 256), (8, 100, 256), (4, 1000, 64)]


def time_cuda(fn, iters: int = 20, reps: int = 7) -> float:
    """Median device milliseconds per call over `reps` runs of `iters` warm
    calls, CUDA events. A sleep kernel ahead of the start event outlasts the
    host's enqueueing of the `iters` calls, so the events time the device's
    work back to back and not the host's launch overhead (~40 us a call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    cycles = int(min(2 * enqueue_s, 0.05) * SLEEP_CLOCK_HZ)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for the inputs' type, whichever is larger."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_bounds(bh: int, n: int, d: int, dtype: torch.dtype) -> dict:
    """Bounds of the three kernels: each input read once, each output written
    once (lse and delta are fp32 rows); 2 flops per multiply-add."""
    elems, s = bh * n * d, torch.finfo(dtype).bits // 8
    io_bwd = 4 * elems * s + 2 * bh * n * 4  # q, k, v, dO, lse, delta
    return {"flash_attention_fwd": bound(4 * elems * s + bh * n * 4, 4.0 * bh * n * n * d, dtype),
            "flash_attention_bwd_dkv": bound(io_bwd + 2 * elems * s, 8.0 * bh * n * n * d, dtype),
            "flash_attention_bwd_dq": bound(io_bwd + elems * s, 6.0 * bh * n * n * d, dtype)}


def bench_shape(bh: int, n: int, d: int, dtype=torch.bfloat16, seed: int = 0) -> dict:
    import torch.nn.functional as F

    from ddpm_ood_tpu_torch.ops.attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (0.5 * torch.randn((bh, 1, n, d), generator=gen, device=dev)
                   for _ in range(4))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash_attention_fwd(q, k, v, scale)
    delta = (do.float() * out.float()).sum(-1).reshape(bh, n).contiguous()
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out_lib = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    ms = {
        "flash_attention_fwd": time_cuda(lambda: flash_attention_fwd(q, k, v, scale)),
        "flash_attention_bwd_dkv": time_cuda(
            lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)),
        "flash_attention_bwd_dq": time_cuda(
            lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)),
    }
    sdpa_fwd = time_cuda(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    sdpa_bwd = time_cuda(lambda: torch.autograd.grad(out_lib, (ql, kl, vl), do, retain_graph=True))
    bounds = attention_bounds(bh, n, d, dtype)
    return {"shape": [bh, n, d], "dtype": str(dtype).removeprefix("torch."),
            "kernels": {name: {"ms": t, **bounds[name],
                               "library_ms": sdpa_fwd if name.endswith("fwd") else sdpa_bwd}
                        for name, t in ms.items()}}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name printed with every result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention needs a CUDA card")
    from ddpm_ood_tpu_torch.ops import _kernels
    from ddpm_ood_tpu_torch.ops.attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    )

    _kernels.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}", flush=True)
    results = []
    for bh, n, d in SHAPES:
        row = {"label": args.label, "card": smi, **bench_shape(bh, n, d)}
        print(json.dumps(row), flush=True)
        results.append(row)
    # the tensor-core counters exist only where the bf16 kernels run on tensor cores
    print(json.dumps({"label": args.label, "launches": {
        fn.__name__: {"all": fn.launches, "tensor_core": getattr(fn, "tc_launches", None)}
        for fn in (flash_attention_fwd, flash_attention_bwd_dkv, flash_attention_bwd_dq)}}),
        flush=True)
    return results


if __name__ == "__main__":
    main()
