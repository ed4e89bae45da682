"""Where a training step's time goes, on one CUDA card.

    python -m ddpm_ood_tpu_torch.profile_train [--json=output/profile_train.json]

Builds the small UNet at full width with the JAX package's initialisation
and a ``DDPMTrainStep`` (bf16 autocast, Adam), then on a synthetic batch of
128 32x32x1 images already on the card (no loader):
  1. times 20 warm steps with the host clock, synchronising at the
     end: ms per step, images/s, and the host's enqueue time per step;
  2. runs 5 steps under ``torch.profiler``: the device's busy share (kernel
     time over wall time) and kernel time per step by layer, attributed
     through the autograd tree: GroupNorm forward kernel, GroupNorm backward
     (the plain VJP), attention forward / backward (the flash kernels and
     delta), convolutions, linears, Adam, and the rest.
It prints one JSON object as its last line and writes it to ``--json``.
The card is required: there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from .diffusion.schedules import make_schedule
from .models.unet import jax_like_init_, make_unet
from .ops import _kernels
from .train.ddpm import DDPMTrainStep

# (layer, substring of a profiler event name); the first match of an event or
# of its nearest matching ancestor takes the kernels it launched
LAYERS = [
    ("groupnorm_bwd (plain VJP)", "_GroupNormActBackward"),
    ("attention_bwd (2 kernels + delta)", "_FlashAttentionBackward"),
    ("adam", "Optimizer.step"),
    ("conv_bwd", "convolution_backward"),
    ("linear_bwd", "AddmmBackward"),
    ("linear_bwd", "MmBackward"),
    ("groupnorm_fwd (kernel)", "groupnorm_act_cluster_kernel"),
    ("groupnorm_fwd (kernel)", "groupnorm_act_kernel"),
    ("attention_fwd (kernel)", "flash_fwd_tc_kernel"),
    ("conv_fwd", "aten::convolution"),
    ("linear_fwd", "aten::addmm"),
    ("linear_fwd", "aten::linear"),
]


MODEL_TYPE, BATCH, IMAGE_SIZE, STEPS = "small", 128, 32, 20  # the training path's cell
# bf16 autocast: GroupNorm runs on its cluster kernel, the flash kernels on
# tensor cores; the others are listed so that a launch of them shows
OUR_KERNELS = ("groupnorm_act_cluster_kernel", "groupnorm_act_kernel", "flash_fwd_tc_kernel",
               "flash_bwd_dkv_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dq_kernel")


def _layer(name: str):
    for layer, key in LAYERS:
        if key in name:
            return layer
    return None


def _kernel_us(evt) -> float:
    return sum(k.duration for k in getattr(evt, "kernels", []))


def attribute(events) -> dict:
    """Kernel microseconds by layer: each CPU event's own kernels go to the
    layer of its nearest ancestor (itself included) that names one."""
    by_layer = defaultdict(float)
    for evt in events:
        us = _kernel_us(evt)
        if not us:
            continue
        layer, node = None, evt
        while node is not None and layer is None:
            layer = _layer(node.name)
            node = node.cpu_parent
        if layer is None:
            layer = _layer(" ".join(k.name for k in evt.kernels)) or "other"
        by_layer[layer] += us
    return by_layer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="output/profile_train.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.library()

    model = jax_like_init_(make_unet(MODEL_TYPE, 2, 1, 1), torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last).train()
    step = DDPMTrainStep(model=model, sched=make_schedule("scaled_linear_beta", 1000, 0.0015,
                                                          0.0195, device=dev),
                         learning_rate=1e-4, autocast_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (BATCH, 1, IMAGE_SIZE, IMAGE_SIZE)
    x0 = torch.rand(shape, generator=gen, device=dev).contiguous(memory_format=torch.channels_last)

    def one():
        t, noise = step.draw(x0, gen)
        return step.step(x0, t, noise)

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loss = one()
    t_host = time.perf_counter()
    loss.item()
    ms_step = (time.perf_counter() - t0) / STEPS * 1e3
    host_ms = (t_host - t0) / STEPS * 1e3  # enqueue only, unless the device pushes back

    n_prof = 5
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            loss = one()
        loss.item()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.time_range.elapsed_us() for e in device)
    by_layer = attribute(events)
    # device work the profiler did not link to a CPU event (e.g. a launch it
    # could not correlate)
    by_layer["unlinked"] = max(0.0, kernel_us - sum(by_layer.values()))
    ours = defaultdict(float)
    for e in device:
        for name in OUR_KERNELS:
            if name in e.name:
                ours[name] += e.time_range.elapsed_us()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {
        "card": smi, "model_type": MODEL_TYPE, "batch_size": BATCH,
        "image_size": IMAGE_SIZE, "steps_timed": STEPS,
        "ms_per_step": ms_step, "host_enqueue_ms_per_step": host_ms,
        "images_per_s": BATCH / ms_step * 1e3,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_steps": n_prof,
        "profiled_ms_per_step": wall_us / n_prof / 1e3,
        "kernel_ms_per_step": kernel_us / n_prof / 1e3,
        "device_busy_share": kernel_us / wall_us,
        "device_events_per_step": len(device) / n_prof,
        "port_kernels_ms_per_step": {k: v / n_prof / 1e3 for k, v in ours.items()},
        "kernel_ms_per_step_by_layer": {k: v / n_prof / 1e3 for k, v in
                                        sorted(by_layer.items(), key=lambda kv: -kv[1])},
    }
    out = Path(args.json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
