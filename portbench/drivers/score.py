"""Offline scoring: closed-loop batches through the scoring CLI's program.

Set-up writes seeded checkpoints (the UNet, and in latent diffusion the
VQ-VAE with its config) and LPIPS weights under a temporary directory,
builds ``trainers/reconstruct.py:Reconstruct`` from the CLI's own parser
and ``serve.build_recon_program`` over it, with the host noise of
``seeds.HostNoise``, and wraps the program's UNet, encode and decode calls
in ``record_function`` spans. It warms the shapes of the cell: one UNet
forward at each row count the lane groups use, the encode, one decode and
the metrics tail at each lane count.

The window is whole batches, each started while ``--seconds`` has not
passed and ended when its scores are on the host; the images are host
arrays of a seeded pool. With ``--trace`` one more batch runs with the
profiler on from the first UNet call of lane group ``trace_from_group``.
Then the program is freed and the reference scores a seeded sample of the
window's (batch, image) pairs at every start point, with the same weights,
images and noise, and runs the UNet forward on the rows kept of a few UNet
calls of the window's first batch (seeded calls and rows), with the
inputs those calls were given.
"""

from __future__ import annotations

import contextlib
import gc
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import flops, seeds
from portbench import trace as tracing
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import metrics as ref_metrics
from portbench.reference import vqvae as ref_vqvae
from portbench.reference.ops import CONTROLS, FP32, no_tf32
from portbench.reference.unet import unet_forward

COLUMNS = ("mse", "perceptual_difference")
SHORT = {"mse": "mse", "perceptual_difference": "lpips", "ssim_distance": "ssim"}


class _Spans:
    """A program hook wrapped in a named ``record_function`` span; counts
    calls and leading rows, and calls ``before(call)`` first. Of each call
    numbered in ``keep_calls`` it keeps ``keep_rows`` consecutive rows (all
    it has, if fewer), from a start drawn by ``rng``, of the inputs and the
    output, copied on the device."""

    def __init__(self, name, fn, before=None):
        self.name, self.fn, self.before = name, fn, before
        self.calls = self.rows = 0
        self.keep_calls, self.keep_rows, self.rng, self.kept = (), 0, None, []

    def __call__(self, x, *rest):
        if self.before is not None:
            self.before(self.calls)
        call = self.calls
        self.calls += 1
        self.rows += int(x.shape[0])
        with torch.profiler.record_function(self.name):
            out = self.fn(x, *rest)
        if call in self.keep_calls:
            k = min(self.keep_rows, int(x.shape[0]))
            at = int(self.rng.integers(int(x.shape[0]) - k + 1))
            self.kept.append([v.detach()[at:at + k].clone() for v in (x, *rest, out)])
        return out


def _argv(cfg: dict, tr: dict, work: Path, vq_ckpt) -> list:
    spatial = cfg["image_shape"][:-1]
    argv = [f"--output_dir={work / 'output'}", "--model_name=bench",
            f"--validation_ids={work / 'none.csv'}", f"--in_ids={work / 'none.csv'}",
            f"--out_ids={work / 'none.csv'}",
            f"--spatial_dimension={len(spatial)}", f"--model_type={cfg['model_type']}",
            f"--is_grayscale={int(cfg['image_shape'][-1] == 1)}",
            f"--prediction_type={cfg['schedule']['prediction_type']}",
            f"--beta_schedule={cfg['schedule']['beta_schedule']}",
            f"--beta_start={cfg['schedule']['beta_start']}",
            f"--beta_end={cfg['schedule']['beta_end']}", f"--b_scale={cfg['b_scale']}",
            f"--batch_size={tr['batch_size']}", f"--sampler={tr['sampler']}",
            f"--num_inference_steps={tr['num_inference_steps']}",
            f"--inference_skip_factor={tr['inference_skip_factor']}",
            f"--recon_groups={tr['recon_groups']}", f"--score_ssim={int(tr['score_ssim'])}",
            f"--quantize={tr.get('quantize', 'none')}"]
    if len(set(spatial)) == 1 and not cfg.get("vqvae"):
        argv.append(f"--image_size={spatial[0]}")
    else:
        argv.append(f"--image_roi={list(spatial)}")
    if vq_ckpt is not None:
        argv.append(f"--vqvae_checkpoint={vq_ckpt}")
    return argv


def _write(cfg: dict, seed: int, work: Path, device):
    """The seeded weights as checkpoints and LPIPS npz; returns (UNet and
    VQ-VAE state dicts on the CPU, the VQ-VAE checkpoint path or None)."""
    run_dir = work / "output" / "bench"
    run_dir.mkdir(parents=True)
    (work / "none.csv").write_text("\n")
    sd = seeds.make_weights(flops.unet_shapes(cfg), "unet", seeds.substream(seed, 10), device)
    unet = {k: v.cpu() for k, v in sd.items()}
    torch.save({"epoch": 0, "global_step": 0, "model_state_dict": unet,
                "optimizer_state_dict": {}, "best_loss": 1000.0}, run_dir / "checkpoint.pth")
    vq, vq_ckpt = None, None
    if cfg.get("vqvae"):
        from portbench.reference.vqvae import vqvae_param_shapes
        sd = seeds.make_weights(vqvae_param_shapes(cfg["vqvae"]), "vqvae",
                                seeds.substream(seed, 11), device)
        vq = {k: v.cpu() for k, v in sd.items()}
        (work / "vqvae").mkdir()
        vq_ckpt = work / "vqvae" / "checkpoint.pth"
        torch.save({"model_state_dict": vq}, vq_ckpt)
        (work / "vqvae" / "vqvae_config.json").write_text(json.dumps(cfg["vqvae"]))
    del sd
    return unet, vq, vq_ckpt, seeds.lpips_npz(work / "lpips.npz", seed)


def _lanes_to_model(x: torch.Tensor) -> torch.Tensor:
    """(K, B, *spatial, C) -> (K*B, C, *spatial), the view the sweep hands
    the UNet."""
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    nd = flat.dim()
    return flat.permute((0, nd - 1) + tuple(range(1, nd - 1)))


def _warm(program, images: np.ndarray, lane_counts, score_ssim: bool) -> None:
    """One UNet forward at each lane count's rows, the encode, one decode,
    and the metrics tail at each lane count."""
    from ddpm_ood_tpu_torch.recon.sweep import metrics_tail

    dev = program.device
    autocast = (torch.autocast(dev.type, dtype=program.autocast_dtype)
                if program.autocast_dtype is not None else contextlib.nullcontext())
    img = torch.as_tensor(images).to(dev)
    with torch.no_grad(), autocast:
        x = program.encode_fn(img) if program.encode_fn is not None else img
        for k in lane_counts:
            xk = x[None].expand((k,) + tuple(x.shape)).contiguous()
            program.model_fn(_lanes_to_model(xk), torch.full((xk.shape[0] * xk.shape[1],), 500,
                                                             device=dev))
        if program.decode_fn is not None:
            metrics_tail(img, program.decode_fn(x)[None], program.b_scale, program.perceptual_fn,
                         score_ssim)
        else:
            for k in lane_counts:
                metrics_tail(img, x[None].expand((k,) + tuple(x.shape)), program.b_scale,
                             program.perceptual_fn, score_ssim)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(r) -> None:
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        _run(r, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(r, work: Path) -> None:
    import os

    from ddpm_ood_tpu_torch.config import parse_args_reconstruct
    from ddpm_ood_tpu_torch.recon.sweep import group_t_starts
    from ddpm_ood_tpu_torch.serve import build_recon_program
    from ddpm_ood_tpu_torch.trainers.reconstruct import Reconstruct

    cfg, tr, dev, seed = r.config, r.traffic, r.device, r.seed
    cuda = dev.type == "cuda"
    unet_sd, vq_sd, vq_ckpt, npz = _write(cfg, seed, work, dev)
    os.environ["LPIPS_WEIGHTS_NPZ"] = npz
    args = parse_args_reconstruct(_argv(cfg, tr, work, vq_ckpt))
    trainer = Reconstruct(args, dev)
    noise = seeds.HostNoise(seeds.substream(seed, 12))
    program = build_recon_program(trainer, args, perceptual_fn=trainer.perceptual,
                                  host_noise_fn=noise)
    if program.latent_pad:
        raise NotImplementedError("a latent pad is not part of any cell")
    groups = group_t_starts(program.timesteps_desc, program.t_starts, program.num_groups)
    gi = int(tr["trace_from_group"]) % len(groups)
    trace_call = sum(len(ts) for ts, _ in groups[:gi])  # UNet calls before that group
    tracer = {"first": None, "prof": None}

    def start_trace():
        if cuda:
            torch.cuda.synchronize(dev)
        tracer["t"] = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        tracer["prof"] = torch.profiler.profile(activities=acts)
        tracer["prof"].start()
        tracer["rows0"] = unet.rows

    def before_unet(call):
        if tracer["prof"] is None and tracer["first"] is not None \
                and call - tracer["first"] == trace_call:
            start_trace()

    unet = program.model_fn = _Spans("portbench.unet", program.model_fn, before_unet)
    if program.encode_fn is not None:
        program.encode_fn = _Spans("portbench.encode", program.encode_fn)
        program.decode_fn = _Spans("portbench.decode", program.decode_fn)

    b = int(tr["batch_size"])
    shape = (b,) + tuple(cfg["image_shape"])
    pool = [seeds.images(shape, seeds.substream(seed, 13), i) for i in range(int(tr["image_pool"]))]
    k_all = len(program.t_starts)
    _warm(program, pool[0], sorted({len(st) for _, st in groups}), bool(tr["score_ssim"]))
    names = list(COLUMNS) + (["ssim_distance"] if tr["score_ssim"] else [])
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # the window's first batch gives rows of a few UNet calls to the check
    keep_rng = np.random.default_rng([int(seed), 5])
    per_batch = sum(len(ts) for ts, _ in groups)
    picks = keep_rng.choice(per_batch, min(int(tr["check_calls"]), per_batch), replace=False)
    unet.keep_calls = {unet.calls + int(c) for c in picks}
    unet.keep_rows, unet.rng = int(tr["check_rows"]), keep_rng

    # the window
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    evals0, outs = program.model_evals, []
    r.setup_s = time.perf_counter() - r.t0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < r.seconds:
        _, *scores = program(pool[len(outs) % len(pool)], None, noise_batch=b)
        host = [s.cpu().numpy() for s in scores]  # (mse, perceptual[, ssim]): no ELBO here
        outs.append(dict(zip(["mse", "perceptual_difference"], host[:2])))
        if tr["score_ssim"]:
            outs[-1]["ssim_distance"] = host[-1]
    window_s = time.perf_counter() - t_start
    r.window = {"seconds": window_s, "batches": len(outs), "items": len(outs) * k_all * b}
    r.counts["unet_calls"] = program.model_evals - evals0
    r.attempted = len(outs) * k_all * b
    r.failed = int(sum((~np.isfinite(o[c])).sum() for o in outs for c in names))
    if cuda:
        r.peak_window_bytes = torch.cuda.max_memory_allocated(dev)
        r.peak_bytes = max(setup_peak, r.peak_window_bytes)

    # useful work a batch: each start point's own steps, the encode, one
    # decode and the LPIPS of each reconstruction, and the images' LPIPS
    steps = sum(ref_diffusion.lane_steps(tr["sampler"], 1000, int(tr["num_inference_steps"]),
                                         int(tr["inference_skip_factor"])))
    per_image = steps * flops.unet_forward_flops(cfg) + (k_all + 1) * flops.lpips_flops(cfg)
    if cfg.get("vqvae"):
        vq = flops.vqvae_flops(cfg)
        per_image += vq["encode"] + k_all * vq["decode"]
    r.flops["window"] = per_image * b * len(outs)
    r.flops["gn_bytes_per_row"] = flops.groupnorm_bytes(cfg)

    if r.trace:
        tracer["first"] = unet.calls
        if gi == 0:  # from the encode on
            start_trace()
        _, *scores = program(pool[len(outs) % len(pool)], None, noise_batch=b)
        for s in scores:
            s.cpu()
        if cuda:
            torch.cuda.synchronize(dev)
        r.traced_s = time.perf_counter() - tracer["t"]
        tracer["prof"].stop()
        r.counts["traced_rows"] = unet.rows - tracer["rows0"]
        path = work / "trace.json"
        tracer["prof"].export_chrome_trace(str(path))
        r.traced = tracing.Trace.load(path)
        path.unlink()
    kept = [[v.cpu() for v in call] for call in unet.kept]
    program.close()
    del program, trainer, unet
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _check(r, outs, pool, noise, unet_sd, vq_sd, npz, names, kept)


def reference_scores(cfg: dict, tr: dict, w: dict, images: np.ndarray, noise: np.ndarray,
                     device, ops=FP32, metric_fault=None) -> dict:
    """{column: (K, n)} of the reference on images (n, *spatial, C) with
    noise (K, n, *latent, E), weights `w` {"unet", "vqvae", "lpips"} on
    `device`; `metric_fault` (one of ``ref_metrics.FAULTS``) plants a
    fault in the scores."""
    no_tf32()
    p, vq, lp = w["unet"], w["vqvae"], w["lpips"]
    acp = ref_diffusion.alphas_cumprod(ref_diffusion.scaled_linear_betas(
        cfg["schedule"]["beta_start"], cfg["schedule"]["beta_end"])).to(device)
    x0 = torch.from_numpy(images).to(device).movedim(-1, 1)
    eps = torch.from_numpy(noise).to(device).movedim(-1, 2)
    out = {}
    with torch.no_grad():
        x = ref_vqvae.encode(vq, cfg["vqvae"], x0, ops) if vq is not None else x0
        recon = ref_diffusion.sweep(lambda z, t: unet_forward(p, cfg["unet"], z, t, ops), acp, x,
                                    eps, tr["sampler"], int(tr["num_inference_steps"]),
                                    int(tr["inference_skip_factor"]), float(cfg["b_scale"]))
        for lane in recon:
            y = ref_vqvae.decode(vq, cfg["vqvae"], lane, ops) if vq is not None else lane
            s = ref_metrics.scores(lp, x0, y, float(cfg["b_scale"]), bool(tr["score_ssim"]), ops,
                                   fault=metric_fault)
            for c, v in s.items():
                out.setdefault(c, []).append(v.cpu().numpy())
    return {c: np.stack(v) for c, v in out.items()}


def _check(r, outs, pool, noise, unet_sd, vq_sd, npz, names, kept) -> None:
    """The program's scores of a seeded sample of the window's (batch,
    image) pairs against the reference's: for each column the largest and
    the median gap, over the median of the reference's values. And the
    rows kept of a few UNet calls of the window against the reference's
    forward on the same inputs: of each call the median element gap over
    the median magnitude; printed, their median over the calls
    (``unet_med``). With ``traffic["program"]`` naming one of
    ``ops.CONTROLS`` (the precision control) the reference in that lower
    precision stands in the program's place; with ``traffic["fault"]``
    naming one of ``ref_metrics.FAULTS``, the reference with that fault in
    its scores does."""
    cfg, tr = r.config, r.traffic
    b = int(tr["batch_size"])
    control, fault = tr.get("program"), tr.get("fault")
    rng = np.random.default_rng([int(r.seed), 4])
    n = min(int(tr["check_images"]), len(outs) * b)
    picks = sorted(rng.choice(len(outs) * b, n, replace=False).tolist())
    w = {"unet": {k: v.to(r.device) for k, v in unet_sd.items()},
         "vqvae": {k: v.to(r.device) for k, v in vq_sd.items()} if vq_sd is not None else None,
         "lpips": ref_metrics.lpips_weights(npz, r.device)}
    got = {c: [] for c in names}
    ref = {c: [] for c in names}
    for batch in sorted({p // b for p in picks}):
        idx = [p % b for p in picks if p // b == batch]
        k = outs[batch]["mse"].shape[0]
        spatial, emb = flops.unet_input(cfg)
        full = noise.draw(batch, (k, b) + spatial + (emb,))
        args = (cfg, tr, w, pool[batch % len(pool)][idx], np.ascontiguousarray(full[:, idx]),
                r.device)
        want = reference_scores(*args)
        if control is not None:
            instead = reference_scores(*args, ops=CONTROLS[control])
        elif fault is not None:
            instead = reference_scores(*args, metric_fault=fault)
        for c in names:
            got[c].append(instead[c] if control or fault else outs[batch][c][:, idx])
            ref[c].append(want[c])
    numbers = {}
    for c in names:
        g, w_ = np.concatenate(got[c], 1), np.concatenate(ref[c], 1)
        gap = np.abs(g.astype(np.float64) - w_) / max(float(np.median(np.abs(w_))), 1e-12)
        numbers[f"{SHORT[c]}_max"] = float(np.max(gap))
        numbers[f"{SHORT[c]}_med"] = float(np.median(gap))
    med = []
    for x, t, out in ([v.to(r.device) for v in call] for call in kept):
        with torch.no_grad():
            want = unet_forward(w["unet"], cfg["unet"], x.float(), t).double()
            if control is not None:
                out = unet_forward(w["unet"], cfg["unet"], x.float(), t, CONTROLS[control])
        gap = (out.double() - want).abs()
        med.append(float(gap.median() / want.abs().median().clamp_min(1e-30)))
    numbers["unet_med"] = float(np.median(med))
    r.judge(numbers)
