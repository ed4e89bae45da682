"""Reconstruction pipeline: the OOD scoring workload on one device.

Port of ``ddpm_ood_tpu/trainers/reconstruct.py`` for the slice the port
serves: 2D pixel-space models, the batched PLMS sweep, MSE scoring. It needs
a checkpoint (found before the model is built), sweeps every start timestep
of every image, and writes per-(image, t_start) rows
{filename, type, t, perceptual_difference, mse} to
``ood/results_{val,in,<name>[_vflip|_hflip]}.csv`` in the JAX package's
format (a leading index column), which ``ood_detection.py`` reads unchanged.
LPIPS is not ported: ``perceptual_difference`` is 0.0, the JAX program's
own convention when it has no perceptual function.

``resolve_recon_groups`` stands in for the JAX package's
``serve.py`` helper of the same name.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
from ddpm_ood_tpu.data.transforms import TransformChain

from ..data.loader import EvalLoader
from ..recon.sweep import ReconProgram
from ..utils.checkpoint import find_checkpoint, missing_checkpoint_error
from .base import BaseTrainer

log = logging.getLogger(__name__)

COLUMNS = ("filename", "type", "t", "perceptual_difference", "mse")
NOISE_SEED = 777  # the JAX pipeline's PRNGKey(777 + process_index), one process


def refuse_unported_flags(args) -> None:
    """Raise NotImplementedError naming the first flag this slice does not serve."""
    def flag(name, default=None):
        return getattr(args, name, default)

    refused = [
        ("--sampler", flag("sampler", "plms") != "plms", "only plms is ported"),
        ("--score_elbo", bool(flag("score_elbo", 0)), ""),
        ("--score_ssim", bool(flag("score_ssim", 0)), ""),
        ("--save_error_maps", bool(flag("save_error_maps", 0)), ""),
        ("--simplex_noise", bool(flag("simplex_noise", 0)), "Gaussian noise only"),
        ("--quantize", flag("quantize", "none") not in (None, "none"), ""),
        ("--aot_cache", bool(flag("aot_cache")), "a TPU-only feature"),
        ("--profile_dir", bool(flag("profile_dir")), ""),
        ("--resume", bool(flag("resume", 0)), ""),
        ("--spatial_dimension", int(flag("spatial_dimension", 2)) != 2, "2D only"),
        ("--vqvae_checkpoint", bool(flag("vqvae_checkpoint")), "latent diffusion"),
        ("--latent_pad", bool(flag("latent_pad")), "latent diffusion"),
        ("--remat", bool(flag("remat", 0)), ""),
    ]
    for name, on, why in refused:
        if on:
            value = flag(name[2:])
            raise NotImplementedError(
                f"{name}={value} is not ported to ddpm_ood_tpu_torch"
                + (f" ({why})" if why else ""))
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise NotImplementedError(
            f"more than one process (WORLD_SIZE={world}) is not ported: run one process")


def resolve_recon_groups(value) -> int:
    """'auto' -> 16 lane groups (2D): the JAX package's choice, tuned on a
    TPU and not yet re-measured on a GPU. Integers pass through."""
    s = str("auto" if value is None else value).strip().lower()
    return 16 if s == "auto" else int(s)


def _stem(filename: str) -> str:
    return Path(filename).stem.replace(".nii", "").replace(".gz", "")


class _CsvSink:
    """Rows of one dataset pass: every batch is appended (flushed and
    fsynced) to a partial CSV as soon as it is scored; ``finalize()`` writes
    ``results_{name}.csv`` in the JAX package's format and removes the
    partial."""

    def __init__(self, out_dir: Path, name: str):
        self.out_dir, self.name = Path(out_dir), name
        self.partial = self.out_dir / f".results_{name}.partial.csv"
        self.rows: List[dict] = []
        self.partial.unlink(missing_ok=True)  # stale, from an interrupted run
        self._fh = None

    def append(self, rows: List[dict]) -> None:
        if not rows:
            return
        self.rows.extend(rows)
        if self._fh is None:
            self._fh = open(self.partial, "w", newline="")
            self._writer = csv.writer(self._fh, lineterminator="\n")
            self._writer.writerow(COLUMNS)
        self._writer.writerows([r[c] for c in COLUMNS] for r in rows)
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def finalize(self) -> Path:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        final = self.out_dir / f"results_{self.name}.csv"
        tmp = final.with_name(f".{final.name}.tmp")
        with open(tmp, "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow(("",) + COLUMNS)  # pandas' unnamed index column
            w.writerows((i,) + tuple(r[c] for c in COLUMNS) for i, r in enumerate(self.rows))
        os.replace(tmp, final)
        self.partial.unlink(missing_ok=True)
        return final


class Reconstruct(BaseTrainer):
    def __init__(self, args, device: torch.device):
        refuse_unported_flags(args)
        # fail fast, before the model is built: scoring needs a trained checkpoint
        run_dir = Path(args.output_dir) / args.model_name
        epoch = getattr(args, "ddpm_checkpoint_epoch", None)
        if find_checkpoint(run_dir, int(epoch) if epoch else None) is None:
            raise missing_checkpoint_error(run_dir)
        super().__init__(args, device)
        self.out_dir = self.run_dir / "ood"
        self.out_dir.mkdir(exist_ok=True)
        self.args = args
        self.val_loader = self._make_loader(args.validation_ids, args.first_n_val)
        self.in_loader = self._make_loader(args.in_ids, args.first_n)
        self._programs = {}
        # (recons, seconds) per scored batch, every get_scores call
        self.batch_times: List[tuple] = []
        log.info("LPIPS is not ported: perceptual_difference is written as 0.0; "
                 "score with ood_detection.py's default --plot_target=mse")

    def _make_loader(self, ids, first_n, add_vflip=False, add_hflip=False) -> EvalLoader:
        a = self.args
        transform = TransformChain(
            spatial_dimension=self.spatial_dimension, is_grayscale=self.is_grayscale,
            image_size=self.image_size, image_roi=self.image_roi,
            add_vflip=add_vflip, add_hflip=add_hflip,
        )
        return EvalLoader(ids, a.batch_size, transform, first_n=int(first_n) if first_n else None,
                          drop_last=bool(getattr(a, "drop_last", 0)),
                          num_workers=int(getattr(a, "num_workers", 1) or 1))

    def _program(self, skip_factor: int) -> ReconProgram:
        if skip_factor not in self._programs:
            a = self.args
            self._programs[skip_factor] = ReconProgram(
                sched=self.sched, model_fn=self.model_fn, device=self.device,
                num_inference_steps=int(a.num_inference_steps),
                inference_skip_factor=int(skip_factor), b_scale=self.b_scale,
                num_groups=resolve_recon_groups(getattr(a, "recon_groups", "auto")),
                autocast_dtype=self.autocast_dtype,
            )
        return self._programs[skip_factor]

    def get_scores(self, loader, dataset_name: str, inference_skip_factor: int,
                   sink: Optional[_CsvSink] = None) -> List[dict]:
        log.info(dataset_name)
        program = self._program(inference_skip_factor)
        generator = torch.Generator(device=self.device).manual_seed(NOISE_SEED)
        results: List[dict] = []
        for batch in loader:
            t1 = time.perf_counter()
            images = np.moveaxis(batch["image"], 1, -1)  # (B, *spatial, C)
            t_starts, mse, perc = program(images, generator)
            mse, perc = mse.cpu().numpy(), perc.cpu().numpy()  # waits for the device
            rows = [
                {"filename": _stem(f), "type": dataset_name, "t": int(t),
                 "perceptual_difference": float(perc[k, b]), "mse": float(mse[k, b])}
                for k, t in enumerate(t_starts) for b, f in enumerate(batch["filename"])
            ]
            results.extend(rows)
            if sink is not None:
                sink.append(rows)
            secs = time.perf_counter() - t1
            n = len(t_starts) * images.shape[0]
            self.batch_times.append((n, secs))
            log.info(f"Took {secs:.2f}s for a batch size of {images.shape[0]} "
                     f"({n / secs:.1f} recons/s)")
        return results

    def _run_scored(self, loader, dataset_name: str, csv_name: str) -> None:
        sink = _CsvSink(self.out_dir, csv_name)
        self.get_scores(loader, dataset_name, self.args.inference_skip_factor, sink=sink)
        sink.finalize()

    def reconstruct(self, args) -> None:
        if bool(args.run_val):
            self._run_scored(self.val_loader, "val", "val")
        if bool(args.run_in):
            self._run_scored(self.in_loader, "in", "in")
        if bool(args.run_out):
            for out in args.out_ids.split(","):
                log.info(out)
                flip_kw = {}
                if "vflip" in out:
                    out = out.replace("_vflip", "")
                    flip_kw["add_vflip"] = True
                    dataset_name = Path(out).stem.split("_")[0] + "_vflip"
                elif "hflip" in out:
                    out = out.replace("_hflip", "")
                    flip_kw["add_hflip"] = True
                    dataset_name = Path(out).stem.split("_")[0] + "_hflip"
                else:
                    dataset_name = Path(out).stem.split("_")[0]
                self._run_scored(self._make_loader(out, args.first_n, **flip_kw),
                                 "out", dataset_name)
