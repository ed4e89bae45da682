"""Quality gate of the PyTorch port: train -> reconstruct -> OOD AUROC on
synthetic data, printed as one JSON line.

    python -m ddpm_ood_tpu_torch.quality_check [--pinned] [--samplers ...]
        [--compare_to QUALITY_r05.json] [--out FILE] [--device=cuda|cpu]

The twin of the JAX package's ``scripts/quality_check.py``, with the same
flags, ``--pinned`` settings, data and JSON schema. It draws the same images
(``make_dataset``, numpy's ``default_rng(0)``), trains the port's
``DDPMTrainer`` (tiny preset, seed 2, batch 8), scores the checkpoint with
the port's ``Reconstruct`` once per sampler, and computes the AUROCs with the
port's numpy ``ood/score.py``. Two OOD sets: "easy" checkerboards, and
"hard" sinusoids just outside the training spectrum. The port draws its own
noise, so its AUROCs are held to ``compare_quality``'s band against an
earlier result, not to equal numbers.

Initial weights: ``--pinned`` starts training from the JAX package's own
init of the tiny UNet, ``make_ddpm_state(make_unet("tiny", 2, 1, 1),
PRNGKey(2), (16, 16, 1))``, kept as ``assets/quality_init_tiny_seed2.npz``
(written by ``python tests/test_torch_quality_init.py``, which also holds it
equal to a fresh JAX draw), so the gate compares training from one init in
both packages. Other runs draw ``jax_like_init_`` from torch seed 2. The
JSON's ``config.init`` names which.

Differences from the JAX script:
- ``--device`` (default cuda, which raises without a card);
- ``--recon_groups`` passes through to ``Reconstruct`` and is written into
  ``config``;
- ``--samplers`` given with ``--pinned`` picks a subset of the pinned
  samplers, so the pinned run can be split across processes; the entries of
  the parts merge into one ``per_sampler``;
- ``backend`` is the torch device type, ``device`` the card's name and power
  limit as ``nvidia-smi`` reports them, and ``timing`` the seconds of
  training and of each sampler's scoring and its recons/s; with
  ``--compare_to`` the JSON also holds ``compare_quality``'s lines;
- ``--quantize=<mode>`` also scores the first sampler with that mode,
  reported as ``<sampler>+<mode>`` as the JAX script does; ``--simplex``
  trains and scores with exact simplex noise, as the JAX script does;
- ``--checkpoint`` scores a given reference-schema ``.pth`` (for example a
  model the JAX package trained, converted) instead of training one, which
  tells a fault of training from one of scoring.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PINNED_SAMPLERS = "plms,dpm@25/1,ddim@25/1"
# the JAX package's PRNGKey(2) init of the tiny UNet, the --pinned gate's start
QUALITY_INIT = Path(__file__).resolve().parent / "assets" / "quality_init_tiny_seed2.npz"


def make_dataset(root: Path, name: str, n: int, size: int, rng, kind: str = "in",
                 near_freq: float = 4.0):
    """kind: 'in' smooth sinusoids | 'ood' checkerboards | 'near' perturbed
    sinusoids (the training spectrum is freq {1, 2}; `near_freq` sets how
    near the hard set sits). Writes .npy images and their split CSV."""
    from .data.csv_splits import write_split_csv

    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    paths = []
    for i in range(n):
        if kind == "ood":
            img = ((xx + yy + i) % 2).astype(np.float32)[None]
        else:
            phase = rng.uniform(0, 2 * np.pi)
            freq = near_freq if kind == "near" else rng.choice([1.0, 2.0])
            img = (
                0.5 + 0.5 * np.sin(2 * np.pi * freq * (xx + yy) / size + phase)
            ).astype(np.float32)[None]
        p = d / f"{name}_{i}.npy"
        np.save(p, img)
        paths.append(str(p))
    csv = root / f"{name}.csv"
    write_split_csv(paths, str(csv))
    return str(csv)


def score_run(out_dir: Path, out_name: str, target: str = "mse"):
    """AUROC with its DeLong 95% CI and the mean z-scores of the in and out
    sets, for one OOD set and plot target."""
    from .ood import auroc_delong_ci, compute_ood_scores, read_results_csv

    scored = compute_ood_scores(
        read_results_csv(out_dir / "results_val.csv"),
        read_results_csv(out_dir / "results_in.csv"),
        read_results_csv(out_dir / f"results_{out_name}.csv"),
        plot_target=target,
    )
    per_image = scored["per_image"]
    z = per_image[f"z_score_{target}"]

    def mean_z(kind):
        vals = z[per_image["type"] == kind]
        vals = vals[~np.isnan(vals)]
        return float(vals.mean()) if len(vals) else float("nan")

    _, ci_lo, ci_hi = auroc_delong_ci(scored["labels"], scored["scores"])
    return {
        "auroc": round(scored["auroc"], 4),
        "auroc_ci": [round(ci_lo, 4), round(ci_hi, 4)],
        "mean_z_in": round(mean_z("in"), 4),
        "mean_z_out": round(mean_z("out"), 4),
    }


def compare_quality(prev: dict, per_sampler: dict):
    """A drop is flagged when it exceeds the combined standard uncertainty of
    the two estimates, hypot(cur_half_width, old_half_width) of their DeLong
    CIs (the JAX script's rule, unchanged). Returns (printable lines,
    regression lines)."""
    lines, regressions = [], []
    for label, entry in per_sampler.items():
        prev_entry = prev.get("per_sampler", {}).get(label)
        if prev_entry is None:
            continue
        for task in ("easy", "hard"):
            cur, old = entry[task], prev_entry[task]
            cur_half = (cur["auroc_ci"][1] - cur["auroc_ci"][0]) / 2
            old_ci = old.get("auroc_ci")
            old_half = (old_ci[1] - old_ci[0]) / 2 if old_ci else cur_half
            threshold = max(1e-4, math.hypot(cur_half, old_half))
            drop = old["auroc"] - cur["auroc"]
            line = (
                f"{label}/{task}: {old['auroc']:.4f} -> {cur['auroc']:.4f} "
                f"(drop {drop:+.4f}, threshold {threshold:.4f})"
            )
            if drop > threshold:
                regressions.append(line)
                lines.append(f"REGRESSION {line}")
            else:
                lines.append(f"ok         {line}")
    return lines, regressions


def card_name_and_power() -> str:
    """nvidia-smi's "name, power.limit" of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--size", type=int, default=16)
    parser.add_argument("--n_train", type=int, default=32)
    parser.add_argument("--steps", type=int, default=10,
                        help="num_inference_steps (headline config: 100)")
    parser.add_argument("--skip", type=int, default=2,
                        help="inference_skip_factor (headline config: 4)")
    parser.add_argument("--samplers", default=None,
                        help="comma list of plms|plms_ref|ddim|dpm to compare (default "
                        f"plms; with --pinned {PINNED_SAMPLERS}, of which a subset may be "
                        "named); a token may carry its own grid as name@steps/skip")
    parser.add_argument("--simplex", action="store_true",
                        help="train + reconstruct with simplex noise")
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help="train with a weight EMA at this decay and ALSO score with "
                        "--use_ema (reported as '<sampler>+ema')")
    parser.add_argument("--quantize", default="none", choices=("none", "int8", "w8", "mixed"),
                        help="ALSO score the first sampler with this PTQ mode "
                        "(reconstruct --quantize=<mode>), reported as '<sampler>+<mode>': "
                        "side-by-side quality check of the quantized scoring path")
    parser.add_argument("--elbo", action="store_true",
                        help="reconstruct with --score_elbo and additionally report the "
                        "likelihood-target (elbo / mse+elbo) AUROCs")
    parser.add_argument("--ssim", action="store_true",
                        help="reconstruct with --score_ssim and additionally report the "
                        "ssim_distance / mse+ssim AUROCs")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--near_freq", type=float, default=4.0,
                        help="frequency of the 'hard' near-OOD sinusoids (training spectrum "
                        "is {1,2}; 3.0 is nearer/harder than the default 4.0)")
    parser.add_argument("--n_eval", type=int, default=16,
                        help="images per val/in/out evaluation set")
    parser.add_argument("--pinned", action="store_true",
                        help="run the fixed regression config (epochs=80, size=16, n_train=32, "
                        "headline 100/4 grid, samplers plms,dpm@25/1,ddim@25/1, near_freq=3, "
                        "n_eval=1024, scoring batch 32, fixed seeds)")
    parser.add_argument("--out", default=None, help="also write the result JSON to this path")
    parser.add_argument("--compare_to", default=None,
                        help="an earlier result JSON: flag any per-task AUROC drop larger "
                        "than the combined DeLong half-widths as REGRESSION")
    parser.add_argument("--recon_groups", default="auto",
                        help="lane groups of the scoring sweep (Reconstruct --recon_groups)")
    parser.add_argument("--checkpoint", default=None,
                        help="score this reference-schema .pth instead of training a model")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    if args.pinned:
        args.samplers = args.samplers or PINNED_SAMPLERS
        unknown = set(args.samplers.split(",")) - set(PINNED_SAMPLERS.split(","))
        if unknown:
            parser.error(f"--pinned scores {PINNED_SAMPLERS}; --samplers named {sorted(unknown)}")
        args.epochs, args.size, args.n_train = 80, 16, 32
        args.steps, args.skip = 100, 4
        args.simplex = False
        args.ema_decay = 0.0
        args.quantize = "none"
        args.elbo = args.ssim = False
        args.near_freq, args.n_eval = 3.0, 1024
    args.samplers = args.samplers or "plms"
    return args


def parse_token(token: str, steps: int, skip: int):
    """'name' or 'name@steps/skip' -> (name, steps, skip, label)."""
    if "@" in token:
        name, grid = token.split("@", 1)
        steps_s, skip_s = grid.split("/", 1)
        return name, int(steps_s), int(skip_s), token
    return token, steps, skip, token


def main(argv=None) -> dict:
    import logging

    from .config import parse_args_reconstruct, parse_args_train_ddpm
    from .trainers.base import refuse_multi_process, resolve_device
    from .trainers.ddpm_trainer import DDPMTrainer
    from .trainers.reconstruct import Reconstruct, refuse_unported_flags

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    refuse_unported_flags(args)  # the scoring CLI's
    refuse_multi_process("the quality gate")
    device = resolve_device(args.device)

    root = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    train_csv = make_dataset(root, "train", args.n_train, args.size, rng)
    val_csv = make_dataset(root, "val", args.n_eval, args.size, rng)
    in_csv = make_dataset(root, "inset", args.n_eval, args.size, rng)
    out_csv = make_dataset(root, "outset", args.n_eval, args.size, rng, kind="ood")
    near_csv = make_dataset(root, "nearset", args.n_eval, args.size, rng,
                            kind="near", near_freq=args.near_freq)

    common = dict(
        seed=2, output_dir=str(root / "output"), model_name="quality_fashionmnist",
        validation_ids=val_csv, spatial_dimension=2, image_size=args.size, image_roi=None,
        latent_pad=None, vqvae_checkpoint=None, prediction_type="epsilon", model_type="tiny",
        beta_schedule="scaled_linear_beta", beta_start=0.0015, beta_end=0.0195, b_scale=1.0,
        snr_shift=1, simplex_noise=int(args.simplex), batch_size=8, augmentation=0,
        num_workers=2, cache_data=1, ddpm_checkpoint_epoch=None, is_grayscale=1,
        quick_test=0, profile_dir=None,
    )
    ns = parse_args_train_ddpm([])
    vars(ns).update(common, training_ids=train_csv, n_epochs=args.epochs, eval_freq=10**9,
                    checkpoint_every=10**9, ema_decay=args.ema_decay)
    init = QUALITY_INIT if args.pinned else None
    if args.checkpoint:
        init = None
        run_dir = Path(ns.output_dir) / ns.model_name
        run_dir.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(args.checkpoint, run_dir / "checkpoint.pth")
        timing = {"train_s": None}
    else:
        t0 = time.perf_counter()
        trainer = DDPMTrainer(ns, device, init_weights=init)
        trainer.train(ns)
        timing = {"train_s": round(time.perf_counter() - t0, 3)}
        del trainer

    out_dir = Path(ns.output_dir) / ns.model_name / "ood"
    tokens = args.samplers.split(",")
    variants = [parse_token(t, args.steps, args.skip) + (0, "none") for t in tokens]
    if args.ema_decay > 0:
        variants.append(parse_token(tokens[0], args.steps, args.skip) + (1, "none"))
    if args.quantize != "none":
        variants.append(parse_token(tokens[0], args.steps, args.skip) + (0, args.quantize))
    per_sampler = {}
    for sampler, steps, skip, label, use_ema, quantize in variants:
        rargs = parse_args_reconstruct([])
        vars(rargs).update(
            common, in_ids=in_csv, out_ids=f"{out_csv},{near_csv}", first_n=None,
            first_n_val=None, run_val=1, run_in=1, run_out=1, num_inference_steps=steps,
            inference_skip_factor=skip, drop_last=False, eval_checkpoint=None,
            sampler=sampler, use_ema=use_ema, quantize=quantize, score_elbo=int(args.elbo),
            score_ssim=int(args.ssim), recon_groups=args.recon_groups)
        if args.pinned:
            rargs.batch_size = 32  # scoring only; training stays at batch 8
        t1 = time.perf_counter()
        recon = Reconstruct(rargs, device)
        recon.reconstruct(rargs)
        entry = {
            "easy": score_run(out_dir, "outset"),
            "hard": score_run(out_dir, "nearset"),
        }
        for target in ((("elbo", "mse+elbo") if args.elbo else ())
                       + (("ssim_distance", "mse+ssim") if args.ssim else ())):
            entry[f"easy_{target}"] = score_run(out_dir, "outset", target)
            entry[f"hard_{target}"] = score_run(out_dir, "nearset", target)
        key = label + ("+ema" if use_ema else "") + (f"+{quantize}" if quantize != "none" else "")
        per_sampler[key] = entry
        n = sum(r for r, _ in recon.batch_times)
        secs = sum(s for _, s in recon.batch_times)
        evals = sum(p.model_evals for p in recon._programs.values())
        timing[key] = {"wall_s": round(time.perf_counter() - t1, 3), "recons": n,
                       "recons_per_s": round(n / secs, 2) if secs else None,
                       "batches": len(recon.batch_times),
                       "model_evals_per_batch": evals / max(len(recon.batch_times), 1)}
        del recon

    first = tokens[0]
    payload = {
        "metric": "synthetic_ood_auroc_hard",
        "value": per_sampler[first]["hard"]["auroc"],
        "unit": (
            f"AUROC (freq-1/2 sinusoids vs freq-{args.near_freq:g} sinusoids,"
            " tiny 2D DDPM)"
        ),
        "vs_baseline": per_sampler[first]["hard"]["auroc"],
        "easy_auroc": per_sampler[first]["easy"]["auroc"],
        "simplex": bool(args.simplex),
        "per_sampler": per_sampler,
        "pinned": bool(args.pinned),
        "config": {
            "epochs": args.epochs, "size": args.size, "n_train": args.n_train,
            "steps": args.steps, "skip": args.skip, "samplers": args.samplers,
            "near_freq": args.near_freq, "n_eval": args.n_eval,
            "data_seed": 0, "train_seed": 2, "recon_groups": args.recon_groups,
            "checkpoint": args.checkpoint,
            "init": (None if args.checkpoint else
                     f"ddpm_ood_tpu_torch/assets/{QUALITY_INIT.name} (the JAX package's "
                     "make_ddpm_state, PRNGKey(2))" if init else
                     "jax_like_init_ (torch.Generator seed 2)"),
        },
        "backend": device.type,
        "device": card_name_and_power() if device.type == "cuda" else "cpu",
        "timing": timing,
    }
    lines, regressions = [], []
    if args.compare_to:
        prev = json.loads(Path(args.compare_to).read_text())
        lines, regressions = compare_quality(prev, per_sampler)
        payload["compare"] = {"to": args.compare_to, "lines": lines}
    print(json.dumps(payload), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(payload, indent=2) + "\n")
        print(f"wrote {args.out}")
    for line in lines:
        print(line)
    if regressions:
        sys.exit(1)
    return payload


if __name__ == "__main__":
    main()
