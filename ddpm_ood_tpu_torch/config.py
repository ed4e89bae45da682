"""Argparse surfaces of the port's CLIs: the same flags and defaults as the
JAX package's ``train_ddpm.py``, ``train_vqvae.py``, ``reconstruct.py`` and
``ood_detection.py``, so launch scripts work unchanged. A copy of
``ddpm_ood_tpu/config.py``'s ``parse_args_train_ddpm``,
``parse_args_train_vqvae``, ``parse_args_reconstruct`` and
``parse_args_ood_detection``: the port imports nothing of the JAX package.
Tuple-ish flags are parsed with ast.literal_eval like the reference.
``parse_args_serve`` and ``parse_args_sample`` copy the parsers of the JAX
package's ``scripts/serve.py`` and ``scripts/sample.py``, which keep
``--image_roi`` and ``--latent_pad`` as raw strings: here they are parsed
with ast.literal_eval too, and ``--device`` is added.

Flags the port does not serve (``--aot_cache``, and ``--quantize`` other than
none under more than one process) are still parsed here; the CLI that reads
them raises NotImplementedError naming the flag. ``--fsdp=1`` shards with FSDP2 (``parallel/fsdp.py``).
``--profile_dir`` writes a ``torch.profiler`` trace where the JAX CLIs write
a ``jax.profiler`` one.
"""

from __future__ import annotations

import argparse
import ast


def _common_train_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--seed", type=int, default=2, help="Random seed to use.")
    parser.add_argument("--output_dir", help="Location for models.")
    parser.add_argument("--model_name", help="Name of model.")
    parser.add_argument("--training_ids", help="Location of file with training ids.")
    parser.add_argument("--validation_ids", help="Location of file with validation ids.")
    parser.add_argument("--image_size", default=None, help="Resize images.")
    parser.add_argument(
        "--image_roi", default=None, type=ast.literal_eval,
        help="Central ROI crop of inputs as a tuple; -1 leaves a dim uncropped.",
    )


def _ddpm_model_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--latent_pad", default=None, type=ast.literal_eval,
        help="Padding applied to the latent so the UNet's downsamples divide evenly.",
    )
    parser.add_argument(
        "--vqvae_checkpoint", default=None,
        help="Path to a VQ-VAE checkpoint to train/evaluate an LDM.",
    )
    parser.add_argument(
        "--prediction_type", default="epsilon",
        help="epsilon, sample, or v_prediction.",
    )
    parser.add_argument("--model_type", default="small", help="Small or big model.")
    parser.add_argument(
        "--beta_schedule", default="linear_beta",
        help="linear_beta or scaled_linear_beta (reference choices), or "
        "cosine_beta (framework extension: Improved-DDPM cosine schedule, "
        "arXiv:2102.09672; beta_start/beta_end ignored).",
    )
    parser.add_argument("--beta_start", type=float, default=1e-4, help="Beta start.")
    parser.add_argument("--beta_end", type=float, default=2e-2, help="Beta end.")
    parser.add_argument(
        "--b_scale", type=float, default=1,
        help="Scale the data by a factor b before noising.",
    )
    parser.add_argument(
        "--snr_shift", type=float, default=1,
        help="Shift the schedule SNR by a factor (for higher resolutions).",
    )
    parser.add_argument(
        "--simplex_noise", type=int, default=0,
        help="Use simplex instead of Gaussian noise.",
    )
    parser.add_argument(
        "--remat", type=int, default=0,
        help="Rematerialize UNet res/attention blocks in the backward pass "
        "(framework extension): trades ~30%% extra FLOPs for a large activation-"
        "memory cut, for big 3D configs whose activations exceed HBM.",
    )


def parse_args_train_ddpm(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a DDPM (or latent DDPM).")
    _common_train_flags(parser)
    parser.add_argument(
        "--spatial_dimension", default=2, type=int, help="Dimension of images: 2d or 3d."
    )
    _ddpm_model_flags(parser)
    parser.add_argument("--batch_size", type=int, default=512, help="Training batch size.")
    parser.add_argument(
        "--ema_decay", type=float, default=0.0,
        help="Keep an exponential moving average of UNet weights with this "
        "decay (framework extension; 0 disables, matching the reference, which "
        "has no weight EMA). The EMA is updated inside the jitted step and "
        "checkpointed as ema_model_state_dict; score with it via "
        "reconstruct.py --use_ema 1.",
    )
    parser.add_argument(
        "--grad_accum_steps", type=int, default=1,
        help="Accumulate gradients over this many equal microbatches inside "
        "the jitted train step (framework extension; lax.scan, one microbatch's "
        "activations live at a time). Numerics match the full batch; batch_size "
        "must be divisible by it. Lets one chip run the reference's global "
        "batch when activations exceed HBM (composable with --remat).",
    )
    parser.add_argument(
        "--fsdp", type=int, default=0,
        help="Shard the UNet's parameters, Adam state and weight EMA over the "
        "processes with FSDP2 (ddpm_ood_tpu_torch/parallel/fsdp.py): the "
        "ZeRO-3/FSDP pattern, all-gathers before use and reduce-scatters "
        "after the backward. Numerics match DDP (tests/test_torch_fsdp.py); "
        "reclaims per-card memory under torchrun with more than one process.",
    )
    parser.add_argument(
        "--learning_rate", type=float, default=2.5e-5,
        help="Adam learning rate (the reference hardcodes 2.5e-5, "
        "base.py:156 — that stays the default).",
    )
    parser.add_argument(
        "--lr_warmup_steps", type=int, default=0,
        help="Linearly ramp the learning rate from 0 over this many optimizer "
        "steps, then hold (framework extension; 0 = constant lr like the "
        "reference; off keeps the reference-era optimizer checkpoint schema).",
    )
    parser.add_argument("--n_epochs", type=int, default=300, help="Number of epochs to train.")
    parser.add_argument(
        "--eval_freq", type=int, default=10, help="Epochs between evaluations."
    )
    parser.add_argument(
        "--augmentation", type=int, default=1, help="Use of augmentation, 1 or 0."
    )
    parser.add_argument("--num_workers", type=int, default=8, help="Number of loader workers")
    parser.add_argument(
        "--cache_data", type=int, default=1, help="Cache data in the loader."
    )
    parser.add_argument(
        "--checkpoint_every", type=int, default=100,
        help="Save a checkpoint every checkpoint_every epochs.",
    )
    parser.add_argument(
        "--ddpm_checkpoint_epoch", default=None,
        help="Epoch number of a specific checkpoint to resume from (default: best).",
    )
    parser.add_argument("--is_grayscale", type=int, default=0, help="Is data grayscale.")
    parser.add_argument(
        "--quick_test", type=int, default=0,
        help="Run a single batch of the train and eval loops.",
    )
    parser.add_argument(
        "--profile_dir", default=None,
        help="Write a torch.profiler trace of warm train steps 2-4 into this "
        "directory (Chrome JSON).",
    )
    return parser.parse_args(argv)


def parse_args_train_vqvae(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a VQ-VAE (stage 1 of an LDM).")
    _common_train_flags(parser)
    parser.add_argument(
        "--spatial_dimension", default=3, type=int, help="Dimension of images: 2d or 3d."
    )
    parser.add_argument("--vqvae_in_channels", default=1, type=int)
    parser.add_argument("--vqvae_out_channels", default=1, type=int)
    parser.add_argument("--vqvae_num_res_layers", default=3, type=int)
    parser.add_argument(
        "--vqvae_downsample_parameters",
        default=((2, 4, 1, 1), (2, 4, 1, 1), (2, 4, 1, 1), (2, 4, 1, 1)),
        type=ast.literal_eval,
        help="Per-level (stride, kernel, dilation, padding).",
    )
    parser.add_argument(
        "--vqvae_upsample_parameters",
        default=((2, 4, 1, 1, 0), (2, 4, 1, 1, 0), (2, 4, 1, 1, 0), (2, 4, 1, 1, 0)),
        type=ast.literal_eval,
        help="Per-level (stride, kernel, dilation, padding, output_padding).",
    )
    parser.add_argument(
        "--vqvae_num_channels", default=[128, 128, 128, 256], type=ast.literal_eval
    )
    parser.add_argument(
        "--vqvae_num_res_channels", default=[128, 128, 128, 256], type=ast.literal_eval
    )
    parser.add_argument("--vqvae_num_embeddings", default=256, type=int)
    parser.add_argument("--vqvae_embedding_dim", default=256, type=int)
    parser.add_argument("--vqvae_decay", default=0.99, type=float)
    parser.add_argument("--vqvae_commitment_cost", default=0.25, type=float)
    parser.add_argument("--vqvae_epsilon", default=1e-5, type=float)
    parser.add_argument("--vqvae_dropout", default=0.0, type=float)
    parser.add_argument("--vqvae_ddp_sync", default=True, type=bool)
    parser.add_argument("--vqvae_learning_rate", default=3e-4, type=float)
    parser.add_argument(
        "--remat", type=int, default=0,
        help="Rematerialize VQ-VAE residual units in the backward pass "
        "(framework extension): cuts activation memory for the production 3D "
        "pixel-space config (image_roi [160,160,128]); numerics unchanged.",
    )
    parser.add_argument(
        "--grad_accum_steps", type=int, default=1,
        help="Accumulate GENERATOR gradients over this many equal microbatches "
        "inside the jitted G step (framework extension; lax.scan). Gradients, "
        "metrics, and the EMA codebook update are exact vs the full batch; the "
        "activation-light D step keeps the full batch. batch_size must be "
        "divisible by it. Composable with --remat for the production 3D "
        "pixel-space config.",
    )
    parser.add_argument(
        "--fsdp", type=int, default=0,
        help="Shard G's and D's parameters and Adam state over the processes "
        "with FSDP2 (ddpm_ood_tpu_torch/parallel/fsdp.py). Numerics match "
        "DDP; reclaims per-card memory, which matters most for the 3D "
        "pixel-space G step.",
    )
    parser.add_argument("--batch_size", type=int, default=4, help="Training batch size.")
    parser.add_argument("--n_epochs", type=int, default=300, help="Number of epochs to train.")
    parser.add_argument(
        "--eval_freq", type=int, default=10, help="Epochs between evaluations."
    )
    parser.add_argument(
        "--augmentation", type=int, default=1, help="Use of augmentation, 1 or 0."
    )
    parser.add_argument(
        "--adversarial_weight", type=float, default=0.01,
        help="Weight of the adversarial loss term.",
    )
    parser.add_argument(
        "--adversarial_warmup", type=int, default=0,
        help="Linearly warm the adversarial weight over the first 50 epochs.",
    )
    parser.add_argument("--num_workers", type=int, default=8, help="Number of loader workers")
    parser.add_argument(
        "--cache_data", type=int, default=1, help="Cache data in the loader."
    )
    parser.add_argument(
        "--checkpoint_every", type=int, default=100,
        help="Save a checkpoint every checkpoint_every epochs.",
    )
    parser.add_argument("--is_grayscale", type=int, default=0, help="Is data grayscale.")
    parser.add_argument(
        "--quick_test", type=int, default=0,
        help="Run a single batch of the train and eval loops.",
    )
    return parser.parse_args(argv)


def parse_args_reconstruct(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Reconstruct val/in/out datasets from many start timesteps."
    )
    parser.add_argument("--seed", type=int, default=2, help="Random seed to use.")
    parser.add_argument("--output_dir", help="Location for models.")
    parser.add_argument("--model_name", help="Name of model.")
    parser.add_argument("--validation_ids", help="Location of file with validation ids.")
    parser.add_argument("--in_ids", help="Location of file with in-distribution ids.")
    parser.add_argument(
        "--out_ids",
        help="List of the OOD split CSVs, comma separated; `_vflip`/`_hflip` "
        "suffixes score flipped versions of a split.",
    )
    parser.add_argument(
        "--spatial_dimension", default=2, type=int, help="Dimension of images: 2d or 3d."
    )
    parser.add_argument("--image_size", default=None, help="Resize images.")
    parser.add_argument(
        "--image_roi", default=None, type=ast.literal_eval,
        help="Central ROI crop of inputs as a tuple.",
    )
    _ddpm_model_flags(parser)
    parser.add_argument("--batch_size", type=int, default=512, help="Batch size.")
    parser.add_argument(
        "--augmentation", type=int, default=1, help="Use of augmentation, 1 or 0."
    )
    parser.add_argument("--num_workers", type=int, default=8, help="Number of loader workers")
    parser.add_argument(
        "--cache_data", type=int, default=1, help="Cache data in the loader."
    )
    parser.add_argument(
        "--first_n_val", default=None,
        help="Only run reconstructions on the first n val samples.",
    )
    parser.add_argument(
        "--first_n", default=None,
        help="Only run reconstructions on the first n in/out samples.",
    )
    parser.add_argument(
        "--ddpm_checkpoint_epoch", default=None,
        help="Epoch of a specific checkpoint to reconstruct with (default: best).",
    )
    parser.add_argument(
        "--eval_checkpoint", default=None,
        help="Alias of --ddpm_checkpoint_epoch (reference reconstruct.py:115-121).",
    )
    parser.add_argument("--drop_last", default=False, help="Drop last incomplete batch.")
    parser.add_argument("--is_grayscale", type=int, default=0, help="Is data grayscale.")
    parser.add_argument("--run_val", type=int, default=1, help="Run reconstructions on val set.")
    parser.add_argument("--run_in", type=int, default=1, help="Run reconstructions on in set.")
    parser.add_argument("--run_out", type=int, default=1, help="Run reconstructions on out set.")
    parser.add_argument(
        "--num_inference_steps", type=int, default=100,
        help="Number of PLMS sampler steps.",
    )
    parser.add_argument(
        "--inference_skip_factor", type=int, default=1,
        help="Only reconstruct from every n-th start timestep.",
    )
    parser.add_argument(
        "--sampler", default="plms", choices=("plms", "plms_ref", "ddim", "dpm"),
        help="Reconstruction sampler (framework extension; the reference is "
        "PLMS-only). 'plms' = batched sweep with a fresh epsilon history per "
        "start point; 'plms_ref' = the reference's exact carried-history "
        "semantics (sequential, for parity quantification); 'ddim' is "
        "deterministic and cheaper per step; 'dpm' = DPM-Solver++(2M), "
        "comparable quality at ~4x fewer --num_inference_steps.",
    )
    parser.add_argument(
        "--score_elbo", type=int, default=0,
        help="Framework extension: also emit the per-(image, t) variational-"
        "bound KL term (bits/dim, diffusion/elbo.py) as an 'elbo' column in "
        "the results CSVs — likelihood-based OOD scoring beside the "
        "reconstruction metrics, at ~2%% extra sweep cost. Score with "
        "ood_detection.py --plot_target=elbo (or mse+elbo).",
    )
    parser.add_argument(
        "--score_ssim", type=int, default=0,
        help="Framework extension: also emit per-(image, t) 1-SSIM "
        "(Gaussian-window structural dissimilarity, ops/ssim.py) as an "
        "'ssim_distance' column in the results CSVs — a third similarity "
        "family beside mse/LPIPS, metrics-tail only (no extra UNet evals). "
        "Score with ood_detection.py --plot_target=ssim_distance (or "
        "mse+ssim).",
    )
    parser.add_argument(
        "--save_error_maps", type=int, default=0,
        help="Framework extension: save per-image anomaly-LOCALIZATION "
        "heatmaps — the per-pixel squared reconstruction error, mean over "
        "every start point — to ood/error_maps/<dataset>/<stem>.{npy,png} "
        "(middle-slice PNG for 3D). The reference emits per-image scalars "
        "only; this shows WHERE the input deviates. Metrics-tail only, no "
        "extra UNet evals. Not available with --sampler=plms_ref.",
    )
    parser.add_argument(
        "--simplex_noise_mode", default="exact", choices=("exact", "device"),
        help="With --simplex_noise: 'exact' draws bit-faithful OpenSimplex "
        "planes with the native C++ kernel on the host (the reference's "
        "scoring-time noise, reconstruct.py:130-142); 'device' uses the "
        "on-device statistical stand-in (faster, not bit-identical).",
    )
    parser.add_argument(
        "--profile_dir", default=None,
        help="Write a torch.profiler trace of one warm sweep batch (batch 1 of "
        "the first dataset pass) into this directory (Chrome JSON).",
    )
    parser.add_argument(
        "--use_ema", type=int, default=0,
        help="Reconstruct with the checkpoint's EMA weights "
        "(ema_model_state_dict, written by train_ddpm.py --ema_decay > 0) "
        "instead of the raw training weights. Framework extension.",
    )
    parser.add_argument(
        "--quantize", default="none", choices=("none", "int8", "w8", "mixed"),
        help="Framework extension: post-training quantization of the UNet "
        "block convolutions for the scoring sweep (ops/quant.py). int8: "
        "s8 x s8 -> s32 on the card's int8 tensor cores (csrc/qconv_s8.cu); "
        "w8: weight-only int8, dequantized in the compute dtype; mixed: "
        "s8 x s8 only at >=512-wide convs (models/unet.py:MIXED_QUANT_MIN_CH), "
        "unquantized elsewhere. Same checkpoint, no calibration; one process "
        "only; validate quality via python -m ddpm_ood_tpu_torch.quality_check "
        "--quantize <mode>.",
    )
    parser.add_argument(
        "--recon_groups", default="auto",
        help="Lane groups in the batched sweep (framework extension): more "
        "groups = less masked-lane waste but one compile per group. 'auto' "
        "(default) picks the v5e-autotuned optimum per dimensionality — 16 "
        "for 2D, 3 for 3D (scripts/autotune_sweep.py grids, DESIGN.md) — or "
        "pass an integer.",
    )
    parser.add_argument(
        "--aot_cache", default=None,
        help="Framework extension: path PREFIX for AOT sweep artifacts "
        "(recon/aot.py). Per (sampler, steps, skip factor, batch) geometry, "
        "the compiled lane-group executables are saved to "
        "<prefix>.<sampler><steps>.skip<K>.b<B>.aot (recon/aot.py:"
        "artifact_path) on the first run and LOADED (zero tracing, zero XLA "
        "compiles) on "
        "restarts. Pinned to jax version + backend + geometry; weights stay "
        "call-time inputs. Single-process only (the multi-process path owns "
        "its compile-then-barrier choreography).",
    )
    parser.add_argument(
        "--resume", type=int, default=0,
        help="Framework extension: crash-safe dataset passes. Scored rows "
        "are always flushed to a per-host partial CSV after every batch "
        "(trainers/reconstruct.py:_CsvSink); with --resume=1 a restart "
        "reloads that partial, skips images whose full t_start grid is "
        "already persisted, and completes the pass without rescoring them. "
        "The reference buffers the whole pass in memory and writes once at "
        "the end (src/trainers/reconstruct.py:252-330), so a mid-run failure "
        "there loses the entire pass.",
    )
    args = parser.parse_args(argv)
    if args.eval_checkpoint and not args.ddpm_checkpoint_epoch:
        args.ddpm_checkpoint_epoch = args.eval_checkpoint
    return args


def parse_args_ood_detection(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Compute Z-score AUROCs from reconstruction result CSVs."
    )
    parser.add_argument("--seed", type=int, default=2, help="Random seed to use.")
    parser.add_argument("--output_dir", help="Location of model outputs.")
    parser.add_argument(
        "--model_name", help="Name of model (or comma-separated list of models)."
    )
    parser.add_argument(
        "--max_t", type=int, default=1000,
        help="Only use reconstructions starting from t < max_t.",
    )
    parser.add_argument(
        "--min_t", type=int, default=0,
        help="Only use reconstructions starting from t > min_t.",
    )
    parser.add_argument(
        "--t_skip", type=int, default=1,
        help="Only use every n reconstructions (accepted for parity; the reference "
        "also never applies it, ood_detection.py:34,58).",
    )
    parser.add_argument(
        "--plot_target", default="mse",
        choices=("mse", "perceptual_difference", "mse+perceptual", "elbo",
                 "mse+elbo", "ssim_distance", "mse+ssim"),
        help="Z-score target for the AUROC (framework extension; the reference "
        "hardcodes 'mse', ood_detection.py:73). 'elbo' targets require result "
        "CSVs produced with reconstruct.py --score_elbo=1; 'ssim' targets "
        "require --score_ssim=1.",
    )
    parser.add_argument(
        "--report", default="auroc",
        help="Comma-separated metrics to report per OOD dataset (framework "
        "extension; the reference prints AUROC only): auroc, aupr (average "
        "precision, OOD positive), fpr95 (FPR at 95%% TPR), auroc_ci "
        "(DeLong 95%% confidence interval on the AUROC).",
    )
    return parser.parse_args(argv)


def _run_model_flags(parser: argparse.ArgumentParser) -> None:
    """The model, geometry, schedule and checkpoint flags that the JAX
    package's ``scripts/serve.py`` and ``scripts/sample.py`` share, plus
    ``--device``."""
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--model_type", default="small")
    parser.add_argument("--spatial_dimension", type=int, default=2)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--image_roi", default=None, type=ast.literal_eval)
    parser.add_argument("--is_grayscale", type=int, default=0)
    parser.add_argument("--prediction_type", default="epsilon")
    parser.add_argument("--beta_schedule", default="linear_beta")
    parser.add_argument("--beta_start", type=float, default=1e-4)
    parser.add_argument("--beta_end", type=float, default=2e-2)
    parser.add_argument("--b_scale", type=float, default=1.0)
    parser.add_argument("--snr_shift", type=float, default=1)
    parser.add_argument("--vqvae_checkpoint", default=None)
    parser.add_argument("--latent_pad", default=None, type=ast.literal_eval)
    parser.add_argument("--eval_checkpoint", default=None)
    parser.add_argument("--ddpm_checkpoint_epoch", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the hand-written kernels) or cpu (the plain PyTorch path)")


def parse_args_serve(argv=None) -> argparse.Namespace:
    """``python -m ddpm_ood_tpu_torch.serve``: the flags and defaults of the
    JAX package's ``scripts/serve.py``, with ``--image_roi`` and
    ``--latent_pad`` parsed by ast.literal_eval, plus ``--device``."""
    import os

    p = argparse.ArgumentParser(description="Serve OOD scores for a trained run over HTTP.")
    _run_model_flags(p)
    p.add_argument("--num_inference_steps", type=int, default=100)
    p.add_argument("--inference_skip_factor", type=int, default=1)
    p.add_argument("--sampler", default="plms")
    p.add_argument("--use_ema", type=int, default=0,
                   help="serve with the checkpoint's EMA weights (ema_model_state_dict)")
    p.add_argument("--score_elbo", type=int, default=0,
                   help="also return z_score_elbo per image (needs a results_val.csv "
                   "produced with --score_elbo=1)")
    p.add_argument("--score_ssim", type=int, default=0,
                   help="also return z_score_ssim per image (needs a results_val.csv "
                   "produced with --score_ssim=1)")
    p.add_argument("--quantize", default="none", choices=("none", "int8", "w8", "mixed"),
                   help="post-training quantization of the served UNet "
                   "(reconstruct --quantize; ops/quant.py)")
    p.add_argument("--recon_groups", default="auto",
                   help="lane groups in the sweep; 'auto' = 16 for 2D, 3 for 3D, or an integer")
    p.add_argument("--batch_size", type=int, default=8,
                   help="the sweep's batch; every request up to this size is wrap-padded to it")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="dynamic request batching: coalesce concurrent requests arriving "
                   "within this window into ONE sweep (up to batch_size images). 0 disables")
    p.add_argument("--results_val", default=None,
                   help="validation stats CSV (default <run>/ood/results_val.csv)")
    p.add_argument("--flag_fpr", type=float, default=0.0,
                   help="serve is_ood / ood_flags decisions thresholded at the (1 - flag_fpr) "
                   "quantile of the validation images' per-image mean-z distribution "
                   "(0.05 targets a 5%% false-positive rate on in-distribution traffic). "
                   "0 disables (z-scores only)")
    p.add_argument("--drift_window", type=int, default=256,
                   help="the /statz mean_served_z_mse drift indicator is a windowed mean "
                   "over the last N served images (a lifetime mean is also reported)")
    p.add_argument("--auth_token", default=os.environ.get("DDPM_OOD_TPU_AUTH_TOKEN") or None,
                   help="require 'Authorization: Bearer <token>' on every endpoint except "
                   "GET /healthz (default from $DDPM_OOD_TPU_AUTH_TOKEN). The service binds "
                   "0.0.0.0: set this anywhere the network is not already trusted")
    p.add_argument("--aot_cache", default=None,
                   help="an ahead-of-time compiled sweep artifact of the JAX package: "
                   "TPU-only, refused by the port")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    if args.eval_checkpoint and not args.ddpm_checkpoint_epoch:
        args.ddpm_checkpoint_epoch = args.eval_checkpoint
    return args


def parse_args_sample(argv=None) -> argparse.Namespace:
    """``python -m ddpm_ood_tpu_torch.sample``: the flags and defaults of the
    JAX package's ``scripts/sample.py``, with ``--image_roi`` and
    ``--latent_pad`` parsed by ast.literal_eval, plus ``--device``."""
    p = argparse.ArgumentParser(description="Generate samples from a trained checkpoint.")
    _run_model_flags(p)
    p.add_argument("--use_ema", type=int, default=0)
    p.add_argument("--sampler", default="ddpm", choices=("ddpm", "plms", "ddim", "dpm"))
    p.add_argument("--num_inference_steps", type=int, default=100)
    p.add_argument("--n_samples", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="output directory (default <run_dir>/samples)")
    args = p.parse_args(argv)
    if args.eval_checkpoint and not args.ddpm_checkpoint_epoch:
        args.ddpm_checkpoint_epoch = args.eval_checkpoint
    return args
