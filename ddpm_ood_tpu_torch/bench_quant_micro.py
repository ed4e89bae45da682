"""Microbenchmark of one channels-last 3x3 convolution in bf16 and in int8.

Port of the JAX package's ``scripts/bench_quant_micro.py``:

    python -m ddpm_ood_tpu_torch.bench_quant_micro [--batch 512] [--hw 16] \\
        [--cin 256] [--cout 256] [--iters 20] [--repeats 5] [--device=cuda|cpu]

It times three variants of the same convolution (SAME padding, stride 1,
x (batch, hw, hw, cin) bf16 from a seeded normal draw, weights of std 0.05):

  bf16     -- ``F.conv2d`` in bf16 on the channels-last tensor: cuDNN on the
              card, the yardstick (the port never calls it on the int8 path);
  int8dyn  -- what ``--quantize=int8`` runs at each convolution: one
              ``quant_absmax`` (the dynamic activation scale) and one
              ``qconv_s8`` (the activation's codes made once by
              ``quantize_codes``, then s8 x s8 -> s32 on warpgroup MMA,
              dequantised to bf16), with the weight quantised once outside
              the loop, as the model caches it and as XLA hoists it out of
              JAX's scan;
  int8pre  -- ``qconv_s8`` alone, the activation's absmax computed outside
              the loop (the upper bound of a static calibrated scale; the
              codes are still made each call, where JAX's int8pre feeds
              codes made outside the loop).

Each variant runs `iters` calls back to back, timed with CUDA events on the
card (the host's clock on the CPU), best of `repeats`. It prints one JSON
line per variant: JAX's keys (``backend`` is the torch device type,
``tflops`` the dense operations a second, 2 per multiply-add, also for
int8) plus ``device``, the card's name and power limit. The card is the
default; ``--device=cpu`` runs the plain PyTorch versions (a check that the
script runs, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch
import torch.nn.functional as F


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--hw", type=int, default=16)
    p.add_argument("--cin", type=int, default=256)
    p.add_argument("--cout", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    return p.parse_args(argv)


def best_seconds(fn, iters: int, repeats: int, device: torch.device) -> float:
    """The best of `repeats` runs of `iters` calls, seconds for the run."""
    fn()  # warm: the kernel library's load, cuDNN's choice
    best = math.inf
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> list:
    from .ops.quant import qconv_s8, quant_absmax, quantize_weight
    from .quality_check import card_name_and_power
    from .trainers.base import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((args.batch, args.hw, args.hw, args.cin), generator=gen)
    x = x.to(device=device, dtype=torch.bfloat16)
    w = (0.05 * torch.randn((args.cout, args.cin, 3, 3), generator=gen)).to(device)
    wq = quantize_weight(w)
    wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    xc = x.permute(0, 3, 1, 2)  # (B, C, H, W) over channels-last memory
    absmax = quant_absmax(x)
    pads = [(1, 1), (1, 1)]

    cases = [
        ("bf16", lambda: F.conv2d(xc, wb, padding=1)),
        ("int8dyn", lambda: qconv_s8(x, quant_absmax(x), wq, None, (1, 1), pads,
                                     torch.bfloat16)),
        ("int8pre", lambda: qconv_s8(x, absmax, wq, None, (1, 1), pads, torch.bfloat16)),
    ]
    flops = 2 * args.batch * args.hw * args.hw * 9 * args.cin * args.cout
    card = card_name_and_power() if device.type == "cuda" else "cpu"
    results, rows = {}, []
    for name, fn in cases:
        best = best_seconds(fn, args.iters, args.repeats, device)
        results[name] = best
        row = {"bench": "quant_micro", "variant": name, "backend": device.type, "device": card,
               "shape": [args.batch, args.hw, args.hw, args.cin, args.cout],
               "iters": args.iters, "best_s": best, "tflops": flops * args.iters / best / 1e12,
               "vs_bf16": results["bf16"] / best}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
