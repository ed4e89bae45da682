"""Online OOD scoring service benchmark at the headline configuration.

Port of the JAX package's ``scripts/bench_serve.py``:

    python -m ddpm_ood_tpu_torch.bench_serve [--batch 32] [--batch_window_ms 50] \\
        [--sampler plms|ddim|dpm --steps N --skip K] [--quick] [--device=cuda|cpu]

It builds the scoring program (small UNet from a seeded random init,
32x32 grayscale, 100-step PLMS, skip 4, batch 32, 16 lane groups; bf16
autocast on the card, fp32 on the CPU), wraps it in ``ScoringService`` and
the HTTP front end on 127.0.0.1, and measures request latency end to end
(client -> HTTP -> sweep -> z-scores -> JSON) for full and single-image
batches: the best of three after one warm request. With
``--batch_window_ms`` it also floods a ``BatchingScoringService`` with
`batch` concurrent single-image clients. ``--quick`` is a tiny 16x16 setup
(tiny UNet, 10-step grid, skip 3, batch 4, 2 lane groups) that runs on the
CPU in seconds. It prints one JSON line with the JAX script's keys
(``backend`` is the torch device type) plus ``device`` (the card's name and
power limit from nvidia-smi, or "cpu") and ``mean_sweep_seconds``.
``--quantize=int8|w8|mixed`` benchmarks the quantised UNet.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Benchmark the online OOD scoring service.")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--sampler", default="plms", choices=("plms", "ddim", "dpm"),
                   help="sweep sampler behind the service")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--skip", type=int, default=4)
    p.add_argument("--quantize", default="none", choices=("none", "int8", "w8", "mixed"),
                   help="post-training quantization of the UNet under the service "
                   "(reconstruct --quantize; ops/quant.py)")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="also measure dynamic batching: `batch` concurrent single-image "
                   "clients against a BatchingScoringService with this window")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from .diffusion.schedules import make_schedule
    from .models.unet import make_unet, memory_format, random_init_
    from .quality_check import card_name_and_power
    from .recon.sweep import ReconProgram
    from .serve import BatchingScoringService, ScoringService, collect_stats, make_server
    from .trainers.base import refuse_multi_process, resolve_device

    args = parse_args(argv)
    refuse_multi_process("the serving benchmark")
    device = resolve_device(args.device)
    batch = 4 if args.quick else args.batch
    steps = 10 if args.quick else args.steps
    skip = 3 if args.quick else args.skip
    model = "tiny" if args.quick else "small"
    size = 16 if args.quick else 32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    unet = random_init_(make_unet(model, 2, 1, 1, quant=args.quantize),
                        torch.Generator().manual_seed(0))
    unet = unet.to(device, memory_format=memory_format(2)).eval()
    prog = ReconProgram(
        sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195, device=device),
        model_fn=unet, device=device, num_inference_steps=steps, inference_skip_factor=skip,
        sampler=args.sampler, num_groups=2 if args.quick else 16,
        autocast_dtype=torch.bfloat16 if device.type == "cuda" else None,
    )
    n_t = len(prog.t_starts)
    stats = {
        "filename": np.array([f"v{i}" for _ in range(n_t) for i in range(4)], dtype=object),
        "type": np.array(["val"] * (4 * n_t), dtype=object),
        "t": np.repeat(np.asarray(prog.t_starts, np.int64), 4),
        "mse": np.tile(0.1 + 0.01 * np.arange(4), n_t),
        "perceptual_difference": np.tile(0.02 + 0.01 * np.arange(4), n_t),
    }
    service = ScoringService(prog, stats, batch_size=batch, model_name="bench")
    if args.batch_window_ms > 0:
        service = BatchingScoringService(service, args.batch_window_ms)

    server = make_server(service, "127.0.0.1", 0)
    port = server.server_port
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def post(n_imgs: int) -> float:
        buf = io.BytesIO()
        np.save(buf, np.random.default_rng(n_imgs).uniform(
            size=(n_imgs, size, size, 1)).astype("float32"))
        req = urllib.request.Request(f"http://127.0.0.1:{port}/score", data=buf.getvalue())
        t0 = time.perf_counter()
        with urllib.request.urlopen(req) as r:
            payload = json.loads(r.read())
        dt = time.perf_counter() - t0
        assert len(payload["scores"]) == n_imgs
        assert all(np.isfinite(s["z_score_mse"]) for s in payload["scores"])
        return dt

    try:
        post(batch)  # the first sweep pays the kernel library's load and cuDNN's choices
        full = min(post(batch) for _ in range(3))
        single = min(post(1) for _ in range(3))  # wrap-padded to the service batch
        out = {
            "bench": "serve_http",
            "backend": device.type,
            "device": card_name_and_power() if device.type == "cuda" else "cpu",
            "model": model,
            "sampler": args.sampler,
            "steps": steps,
            "skip": skip,
            "quantize": args.quantize,
            "batch": batch,
            "batch_window_ms": args.batch_window_ms,
            "full_batch_latency_s": full,
            "single_image_latency_s": single,
            "sustained_imgs_per_s": batch / full,
        }
        if args.batch_window_ms > 0:
            def flood() -> float:
                """`batch` concurrent single-image clients; every one must
                complete, or a dropped request would make the wall fast."""
                lat = [None] * batch

                def one(i):
                    lat[i] = post(1)

                threads = [threading.Thread(target=one, args=(i,)) for i in range(batch)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
                failed = sum(1 for v in lat if v is None)
                if failed:
                    raise RuntimeError(f"flood: {failed}/{batch} requests failed")
                return wall

            flood()  # warm the batched path
            wall = min(flood() for _ in range(3))
            out["concurrent_single_image_clients"] = batch
            out["flood_wall_s"] = wall
            out["flood_reqs_per_s"] = batch / wall
        out["mean_sweep_seconds"] = collect_stats(service)["mean_sweep_seconds"]
    finally:
        server.shutdown()
        server.server_close()
        if isinstance(service, BatchingScoringService):
            service.close()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
