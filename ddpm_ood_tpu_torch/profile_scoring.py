"""Where a scoring batch's time goes, on one CUDA card, by quantisation mode.

    python -m ddpm_ood_tpu_torch.profile_scoring [--quantize=none,int8,int8,none] \
        [--json=out.json]

Writes 96 synthetic 32x32x1 images (sine fields) and a seeded small-UNet
``checkpoint.pth`` under a temporary directory, then for each mode runs the
scoring CLI in this process (``reconstruct.main``): small UNet, batch 32,
PLMS 20/1 (20 start points in 16 lane groups of one or two lanes, so UNet
calls of 32 and 64 images as on the headline's PLMS 100/4 grid; 211
forwards a batch), ``--profile_dir``. Batch 0 pays the set-up, batch 1 is
traced (the CLI traces its second batch), batch 2 runs warm and untraced.

From the trace (``trace_split``): the UNet forwards (27 GroupNorms each),
the wall and the device's busy time (the union of its kernels' spans) a
forward, the idle share, and the int8 kernels' (and GroupNorm's and
attention's) shares of the busy time. From batch 2: recons/s and wall ms a
forward without the profiler. The host's speed drifts within a call, so a
comparison names each mode more than once, in turns (the default runs
none, int8, int8, none). It prints one JSON object a run, then one with all
of them last, and writes that to ``--json``. The card is required: there is
no CPU path.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

N_IMAGES, SIZE, BATCH = 96, 32, 32
GN_PER_FORWARD = 27  # GroupNorm launches a small-UNet forward, 2D or 3D
MODEL = "profile_fashionmnist"
ARGS = ["--model_type=small", f"--image_size={SIZE}", "--is_grayscale=1",
        "--num_inference_steps=20", "--inference_skip_factor=1", f"--batch_size={BATCH}",
        "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195",
        "--run_in=0", "--run_out=0", "--device=cuda"]
# device-time shares reported, by a substring of the kernel's name
KERNELS = ("qconv_s8_kernel", "quant_codes_kernel", "quant_absmax_kernel",
           "groupnorm_act_cluster_kernel", "groupnorm_act_large_kernel", "flash_fwd_tc_kernel")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--quantize", default="none,int8,int8,none",
                   help="comma-separated --quantize modes, profiled in this order")
    p.add_argument("--json", default=None, help="also write the last JSON line here")
    return p.parse_args(argv)


def trace_split(path: Path) -> dict:
    """Where a traced batch's time went, from its Chrome trace (torch.profiler
    with CPU and CUDA activities)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                     for e in spans if e.get("cat") == "kernel")
    if not kernels:
        raise RuntimeError(f"{path.name}: the trace holds no kernel on the device")
    busy, end = 0.0, -math.inf
    for a, b, _ in kernels:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    wall = (max(float(e["ts"]) + float(e["dur"]) for e in spans)
            - min(float(e["ts"]) for e in spans))
    forwards = sum("groupnorm_act_" in n for *_, n in kernels) / GN_PER_FORWARD
    shares = {k: sum(b - a for a, b, n in kernels if k in n) / busy for k in KERNELS}
    return {"forwards": forwards, "traced_wall_ms_per_forward": wall / 1e3 / forwards,
            "device_ms_per_forward": busy / 1e3 / forwards, "idle_share": 1.0 - busy / wall,
            "share_of_device_time": shares, "kernels": len(kernels)}


def write_run(root: Path) -> Path:
    """The images, their split CSV and the checkpoint; returns the CSV."""
    from .models.unet import make_unet, random_init_
    from .utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(SIZE), np.arange(SIZE), indexing="ij")
    (root / "images").mkdir(parents=True)
    paths = []
    for i in range(N_IMAGES):
        phase = rng.uniform(0, 2 * np.pi)
        img = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) / SIZE + phase)
        paths.append(str(root / "images" / f"img_{i}.npy"))
        np.save(paths[-1], img.astype(np.float32)[None])
    (root / "images.csv").write_text(",".join(paths))
    model = random_init_(make_unet("small", 2, 1, 1), torch.Generator().manual_seed(0))
    (root / "output" / MODEL).mkdir(parents=True)
    save_checkpoint(root / "output" / MODEL / "checkpoint.pth", model.state_dict())
    return root / "images.csv"


def profile(out: Path, images: Path, mode: str, base: Path) -> dict:
    """One scoring CLI run of `mode` under `out`, on `base`'s checkpoint."""
    import shutil

    from . import reconstruct as cli

    (out / "output" / MODEL).mkdir(parents=True)
    shutil.copy2(base / "output" / MODEL / "checkpoint.pth", out / "output" / MODEL)
    recon = cli.main([f"--output_dir={out / 'output'}", f"--model_name={MODEL}",
                      f"--validation_ids={images}", f"--in_ids={images}",
                      f"--out_ids={images}", *ARGS, f"--quantize={mode}",
                      f"--profile_dir={out / 'trace'}"])
    if recon.profile_path is None or len(recon.batch_times) != N_IMAGES // BATCH:
        raise RuntimeError(f"--quantize={mode}: no trace of batch 1, or not "
                           f"{N_IMAGES // BATCH} batches")
    out = {"quantize": mode, **trace_split(Path(recon.profile_path))}
    n, secs = recon.batch_times[2]  # warm and untraced
    out.update(recons_per_s=n / secs,
               wall_ms_per_forward=secs * 1e3 / out["forwards"])
    return out


def main(argv=None) -> dict:
    from .quality_check import card_name_and_power

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_scoring needs a CUDA card")
    result = {"device": card_name_and_power(), "grid": "PLMS 20/1, batch 32, small UNet",
              "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        images = write_run(root)
        for i, mode in enumerate(args.quantize.split(",")):
            result["runs"].append(profile(root / f"run{i}", images, mode, root))
            print(json.dumps(result["runs"][-1]), flush=True)
    print(json.dumps(result), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
