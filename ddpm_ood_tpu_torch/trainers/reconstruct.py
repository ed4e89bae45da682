"""Reconstruction pipeline: the OOD scoring workload on one device.

Port of ``ddpm_ood_tpu/trainers/reconstruct.py`` for the slice the port
serves: 2D and 3D models in pixel space or in the latent space of a frozen
VQ-VAE (``--vqvae_checkpoint``, ``--latent_pad``), with Gaussian noise, and
every sampler of the JAX CLI (``--sampler`` plms, plms_ref, ddim or dpm). It needs a checkpoint
(found before the model is built), sweeps every start timestep of every
image, and writes per-(image, t_start) rows
{filename, type, t, perceptual_difference, mse[, elbo][, ssim_distance]} to
``ood/results_{val,in,<name>[_vflip|_hflip]}.csv`` in the JAX package's
format (a leading index column), which both packages' ``ood_detection`` read.
``perceptual_difference`` is LPIPS (``losses/lpips.py``, weights from
``LPIPS_WEIGHTS_NPZ``; fake 3D on volumes); ``--score_elbo`` adds ``elbo`` (the variational
bound's term at each start point, bits/dim), ``--score_ssim`` adds
``ssim_distance`` and
``--save_error_maps`` writes ``ood/error_maps/<dataset>/<stem>.npy``. The
JAX package also renders each map to a ``.png`` with matplotlib, which the
port does not use, so it writes the ``.npy`` files only.

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

from ..data.loader import DataLoader
from ..data.transforms import TransformChain
from ..losses.lpips import PerceptualLoss
from ..recon.sweep import ReconProgram
from ..utils.checkpoint import find_checkpoint, missing_checkpoint_error
from .base import BaseTrainer, refuse_flags

log = logging.getLogger(__name__)

COLUMNS = ("filename", "type", "t", "perceptual_difference", "mse")
ELBO_COLUMN = "elbo"  # after COLUMNS, with --score_elbo
SSIM_COLUMN = "ssim_distance"  # after COLUMNS and elbo, with --score_ssim
NOISE_SEED = 777  # the JAX pipeline's PRNGKey(777 + process_index), one process


def refuse_unported_flags(args) -> None:
    """Raise NotImplementedError naming the first flag this slice does not serve."""
    def flag(name, default=None):
        return getattr(args, name, default)

    refuse_flags(args, [
        ("--simplex_noise", bool(flag("simplex_noise", 0)), "Gaussian noise only"),
        ("--quantize", flag("quantize", "none") not in (None, "none"), ""),
        ("--aot_cache", bool(flag("aot_cache")), "a TPU-only feature"),
        ("--profile_dir", bool(flag("profile_dir")), ""),
        ("--resume", bool(flag("resume", 0)), ""),
        ("--remat", bool(flag("remat", 0)), ""),
    ])


def resolve_recon_groups(value, spatial_dimension: int = 2) -> int:
    """'auto' -> 16 lane groups in 2D, 3 in 3D: the JAX package's choice,
    tuned on a TPU and not measured on a GPU. Integers pass through."""
    s = str("auto" if value is None else value).strip().lower()
    if s != "auto":
        return int(s)
    return 3 if int(spatial_dimension) == 3 else 16


def _stem(filename: str) -> str:
    return Path(filename).stem.replace(".nii", "").replace(".gz", "")


class _CsvSink:
    """Rows of one dataset pass: every batch is appended (flushed and
    fsynced) to a partial CSV as soon as it is scored; ``finalize()`` writes
    ``results_{name}.csv`` in the JAX package's format and removes the
    partial."""

    def __init__(self, out_dir: Path, name: str, columns=COLUMNS):
        self.out_dir, self.name, self.columns = Path(out_dir), name, tuple(columns)
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
            self._writer.writerow(self.columns)
        self._writer.writerows([r[c] for c in self.columns] for r in rows)
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
            w.writerow(("",) + self.columns)  # pandas' unnamed index column
            w.writerows((i,) + tuple(r[c] for c in self.columns)
                        for i, r in enumerate(self.rows))
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
        self.score_elbo = bool(getattr(args, "score_elbo", 0))
        self.score_ssim = bool(getattr(args, "score_ssim", 0))
        self.save_error_maps = bool(getattr(args, "save_error_maps", 0))
        self.columns = (COLUMNS + ((ELBO_COLUMN,) if self.score_elbo else ())
                        + ((SSIM_COLUMN,) if self.score_ssim else ()))
        # LPIPS in fp32 on the scoring device (fake 3D on volumes), shared by
        # every program
        self.perceptual = PerceptualLoss(spatial_dims=self.spatial_dimension).to(device).eval()
        if self.save_error_maps:
            log.info("--save_error_maps: writing each map as .npy; the port draws no .png "
                     "(matplotlib is not a dependency of the port)")

    def _make_loader(self, ids, first_n, add_vflip=False, add_hflip=False) -> DataLoader:
        a = self.args
        transform = TransformChain(
            spatial_dimension=self.spatial_dimension, is_grayscale=self.is_grayscale,
            image_size=self.image_size, image_roi=self.image_roi,
            add_vflip=add_vflip, add_hflip=add_hflip,
        )
        return DataLoader(ids, a.batch_size, transform, first_n=int(first_n) if first_n else None,
                          drop_last=bool(getattr(a, "drop_last", 0)),
                          num_workers=int(getattr(a, "num_workers", 1) or 1))

    def _program(self, skip_factor: int) -> ReconProgram:
        if skip_factor not in self._programs:
            a = self.args
            self._programs[skip_factor] = ReconProgram(
                sched=self.sched, model_fn=self.model_fn, device=self.device,
                num_inference_steps=int(a.num_inference_steps),
                inference_skip_factor=int(skip_factor), b_scale=self.b_scale,
                num_groups=resolve_recon_groups(getattr(a, "recon_groups", "auto"),
                                                self.spatial_dimension),
                sampler=getattr(a, "sampler", "plms"), autocast_dtype=self.autocast_dtype,
                perceptual_fn=self.perceptual, score_elbo=self.score_elbo,
                score_ssim=self.score_ssim, score_error_maps=self.save_error_maps,
                encode_fn=self.encode_fn, decode_fn=self.decode_fn, latent_pad=self.latent_pad,
                # the loader resizes to image_size, so the latent shape is known
                latent_sample_shape=self._latent_sample_shape() if self.image_size else None,
            )
        return self._programs[skip_factor]

    def get_scores(self, loader, dataset_name: str, inference_skip_factor: int,
                   save_name: Optional[str] = None,
                   sink: Optional[_CsvSink] = None) -> List[dict]:
        """`save_name` names the error-map directory (several datasets share
        dataset_name "out"); defaults to dataset_name."""
        log.info(dataset_name)
        program = self._program(inference_skip_factor)
        generator = torch.Generator(device=self.device).manual_seed(NOISE_SEED)
        results: List[dict] = []
        for batch in loader:
            t1 = time.perf_counter()
            images = np.moveaxis(batch["image"], 1, -1)  # (B, *spatial, C)
            t_starts, *scores = program(images, generator)
            # mse, perceptual_difference, then the optional columns in order
            names = ("mse", "perceptual_difference") + self.columns[len(COLUMNS):]
            by_name = {c: v.cpu().numpy() for c, v in zip(names, scores)}  # waits for the device
            rows = []
            for k, t in enumerate(t_starts):
                for b, f in enumerate(batch["filename"]):
                    row = {"filename": _stem(f), "type": dataset_name, "t": int(t)}
                    row.update((c, float(by_name[c][k, b])) for c in self.columns[3:])
                    rows.append(row)
            if self.save_error_maps:
                self._save_error_maps(program.last_error_maps.cpu().numpy(), batch["filename"],
                                      save_name or dataset_name)
            results.extend(rows)
            if sink is not None:
                sink.append(rows)
            secs = time.perf_counter() - t1
            n = len(t_starts) * images.shape[0]
            self.batch_times.append((n, secs))
            log.info(f"Took {secs:.2f}s for a batch size of {images.shape[0]} "
                     f"({n / secs:.1f} recons/s)")
        return results

    def _save_error_maps(self, maps: np.ndarray, filenames, name: str) -> None:
        """One ``<stem>.npy`` per image under ood/error_maps/<name>/: the
        per-pixel squared reconstruction error, mean over every start point,
        channels last."""
        out = self.out_dir / "error_maps" / name
        out.mkdir(parents=True, exist_ok=True)
        for m, filename in zip(maps, filenames):
            np.save(out / f"{_stem(filename)}.npy", m)

    def _run_scored(self, loader, dataset_name: str, csv_name: str, **kw) -> None:
        sink = _CsvSink(self.out_dir, csv_name, self.columns)
        self.get_scores(loader, dataset_name, self.args.inference_skip_factor, sink=sink, **kw)
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
                                 "out", dataset_name, save_name=dataset_name)
