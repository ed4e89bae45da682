"""Reconstruction pipeline: the OOD scoring workload, on one device or one
process per device under torchrun.

Port of ``ddpm_ood_tpu/trainers/reconstruct.py``: 2D and 3D models in pixel
space or in the latent space of a frozen VQ-VAE (``--vqvae_checkpoint``,
``--latent_pad``), every sampler of the JAX CLI (``--sampler`` plms,
plms_ref, ddim or dpm), Gaussian or simplex noise. It needs a checkpoint
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
port does not use, so it writes the ``.npy`` files only; the first batch of
each dataset pass likewise goes to ``ood/preview_<tag>.npy`` (inputs and
reconstructions stacked) where the JAX CLI draws a figure.

``--simplex_noise=1`` draws simplex noise: ``--simplex_noise_mode=exact``
(the default) the reference's OpenSimplex planes on the host, seeded from
numpy's global RNG in the JAX CLI's order (a ragged last batch draws at the
first batch's size, as the JAX CLI's wrap-pad does), which a missing g++
makes an error; ``device`` the on-device gradient noise, seeded from the
scoring generator. Every scored batch is appended to a partial CSV at once;
``--resume=1`` reloads it after a crash, skips the batches it holds whole
(advancing the generator past their draws) and rescores the rest.
``--profile_dir`` traces batch 1 of the first dataset pass with
``torch.profiler``. ``--remat`` is accepted and changes nothing: scoring
takes no gradient. ``DDPM_OOD_TPU_CRASH_AFTER_BATCHES=N`` SIGKILLs the
process after N batches are persisted, to test the resume.
``--quantize=int8|w8|mixed`` scores with the quantised UNet
(``models/unet.py``, ``ops/quant.py``); each activation scale is taken over
a whole UNet call (every lane and image of a group), as in JAX, and under
torchrun over every rank's images of that call (the program is
``sharded``: JAX's global batch is the processes' batches joined).

Under torchrun (``parallel/mesh.py``) each process scores its partition of
every dataset (``partition_for_process``: equal partitions, wrap-padded) with
its own noise stream (``NOISE_SEED + rank``), appends to its own partial CSV
``.results_<name>.shard<rank>.partial.csv`` (which ``--resume=1`` reloads),
finishes it as ``.results_<name>.shard<rank>.csv``, and after a barrier rank 0
merges the shards, in rank order, into ``results_<name>.csv``, as the JAX
package's ``_CsvSink.finalize`` does. Previews and the profiler trace are
rank 0's; the latent path runs on each process unchanged. The ranks' quantised
calls meet in lockstep: equal partitions give every rank the same batches,
and ``--resume=1`` skips a batch only where every rank's partial holds it
whole (a rank that rescores a batch it held keeps one row of each).

The scoring program is assembled by ``serve.build_recon_program``, the
one place the online service assembles its own, so that offline scoring and
serving cannot diverge; ``resolve_recon_groups`` and the generator's
``NOISE_SEED`` live there too.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import signal
import time
from collections import Counter
from pathlib import Path
from typing import List, Optional, Set

import numpy as np
import torch

from ..data.loader import DataLoader
from ..data.transforms import TransformChain
from ..losses.lpips import PerceptualLoss
from ..noise import _native
from ..noise.simplex import Simplex, generate_simplex_noise, simplex_noise_device
from ..parallel import mesh as pmesh
from ..recon.sweep import ReconProgram
from ..serve import NOISE_SEED, build_recon_program
from ..serve import resolve_recon_groups  # noqa: F401 (its callers import it from here)
from ..utils.checkpoint import find_checkpoint, missing_checkpoint_error
from ..utils.profiling import start_trace, stop_trace
from .base import BaseTrainer, refuse_flags

log = logging.getLogger(__name__)

COLUMNS = ("filename", "type", "t", "perceptual_difference", "mse")
ELBO_COLUMN = "elbo"  # after COLUMNS, with --score_elbo
SSIM_COLUMN = "ssim_distance"  # after COLUMNS and elbo, with --score_ssim
CRASH_ENV = "DDPM_OOD_TPU_CRASH_AFTER_BATCHES"  # fault injection for the resume


def refuse_unported_flags(args) -> None:
    """Raise NotImplementedError naming ``--aot_cache`` (TPU-only) when it
    is set."""
    refuse_flags(args, [
        ("--aot_cache", bool(getattr(args, "aot_cache", None)), "a TPU-only feature"),
    ])


def _stem(filename: str) -> str:
    return Path(filename).stem.replace(".nii", "").replace(".gz", "")


class _CsvSink:
    """Rows of one dataset pass: every batch is appended (flushed and
    fsynced) to a partial CSV as soon as it is scored; ``finalize()`` writes
    ``results_{name}.csv`` in the JAX package's format and removes the
    partial.

    With ``resume=True`` a partial left by an interrupted run is reloaded:
    its rows are kept, ``done()`` names the images it holds at every start
    point, a torn or non-finite row is dropped so that its image is rescored,
    ``finalize()`` keeps the last row of each (filename, type, t), and a
    partial that cannot be read (or holds other columns) is removed and the
    pass starts afresh. Without ``resume`` a stale partial is removed.

    Under torchrun every process keeps its own partial (``.shard<rank>``
    before ``.partial.csv``); ``finalize()``, which every process calls,
    writes its shard, rank 0 merges them, and every process returns once
    the merged file is there."""

    def __init__(self, out_dir: Path, name: str, columns=COLUMNS, resume: bool = False):
        self.out_dir, self.name, self.columns = Path(out_dir), name, tuple(columns)
        self.rank, self.world = pmesh.process_index(), pmesh.process_count()
        self.suffix = f".shard{self.rank}" if self.world > 1 else ""
        self.partial = self.out_dir / f".results_{name}{self.suffix}.partial.csv"
        self.rows: List[dict] = []
        self._fh = None
        self._counts: Counter = Counter()  # stem -> rows persisted
        if resume and self.partial.exists():
            self.rows = self._read_partial()
            self._counts = Counter(r["filename"] for r in self.rows)
            if self.rows:  # the partial now holds exactly the kept rows, then grows
                tmp = self.partial.with_name(f"{self.partial.name}.tmp")
                with open(tmp, "w", newline="") as fh:
                    w = csv.writer(fh, lineterminator="\n")
                    w.writerow(self.columns)
                    w.writerows([r[c] for c in self.columns] for r in self.rows)
                os.replace(tmp, self.partial)
                self._open("a")
        if not self.rows:
            self.partial.unlink(missing_ok=True)
        self.resumed_rows = len(self.rows)

    def _read_partial(self) -> List[dict]:
        try:
            with open(self.partial, newline="") as fh:
                records = list(csv.reader(fh))
        except (OSError, UnicodeDecodeError, csv.Error):
            return []
        if not records or tuple(records[0]) != self.columns:
            return []
        rows = []
        for rec in records[1:]:
            if len(rec) != len(self.columns) or not all(rec):
                continue  # torn by the crash
            row = dict(zip(self.columns, rec))
            try:
                row["t"] = int(row["t"])
                for c in self.columns[3:]:
                    row[c] = float(row[c])
            except ValueError:
                continue
            if all(math.isfinite(row[c]) for c in self.columns[3:]):
                rows.append(row)
        return rows

    def done(self, filenames, k: int) -> Set[str]:
        """The `filenames` whose `k` start points are all persisted already."""
        return {f for f in filenames if self._counts.get(_stem(f), 0) >= int(k)}

    def _open(self, mode: str) -> None:
        self._fh = open(self.partial, mode, newline="")
        self._writer = csv.writer(self._fh, lineterminator="\n")
        if mode == "w":
            self._writer.writerow(self.columns)

    def _write(self, rows: List[dict]) -> None:
        self._writer.writerows([r[c] for c in self.columns] for r in rows)
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def append(self, rows: List[dict]) -> None:
        if not rows:
            return
        self.rows.extend(rows)
        if self._fh is None:
            self._open("w")
        self._write(rows)

    def finalize(self) -> Path:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        last = {(r["filename"], r["type"], r["t"]): i for i, r in enumerate(self.rows)}
        rows = [r for i, r in enumerate(self.rows) if last[(r["filename"], r["type"], r["t"])] == i]
        final = self.out_dir / f"results_{self.name}.csv"
        if self.world == 1:
            self._write_csv(final, [[r[c] for c in self.columns] for r in rows])
            self.partial.unlink(missing_ok=True)
            return final
        self._write_csv(self.out_dir / f".results_{self.name}{self.suffix}.csv",
                        [[r[c] for c in self.columns] for r in rows])
        pmesh.coordination_barrier(f"recon_write_{self.name}")
        if self.rank == 0:
            merged = []
            for r in range(self.world):
                with open(self.out_dir / f".results_{self.name}.shard{r}.csv", newline="") as fh:
                    merged.extend(rec[1:] for rec in list(csv.reader(fh))[1:])
            self._write_csv(final, merged)
        self.partial.unlink(missing_ok=True)
        pmesh.coordination_barrier(f"recon_merged_{self.name}")  # every rank sees it
        return final

    def _write_csv(self, path: Path, records) -> None:
        """`records` (lists in column order) as a CSV in the JAX package's
        format, written to a temporary name and renamed."""
        tmp = path.with_name(f".{path.name}.tmp")
        with open(tmp, "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow(("",) + self.columns)  # pandas' unnamed index column
            w.writerows([i, *rec] for i, rec in enumerate(records))
        os.replace(tmp, path)


class Reconstruct(BaseTrainer):
    def __init__(self, args, device: torch.device):
        refuse_unported_flags(args)
        # fail fast, before the model is built: scoring needs a trained checkpoint
        run_dir = Path(args.output_dir) / args.model_name
        epoch = getattr(args, "ddpm_checkpoint_epoch", None)
        if find_checkpoint(run_dir, int(epoch) if epoch else None) is None:
            raise missing_checkpoint_error(run_dir)
        self.simplex_noise = bool(getattr(args, "simplex_noise", 0))
        self.simplex_mode = getattr(args, "simplex_noise_mode", "exact")
        if self.simplex_noise and self.simplex_mode == "exact":
            _native.library()  # no g++: an error that names --simplex_noise_mode=device
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
        self.profile_dir = getattr(args, "profile_dir", None)
        self.profile_path: Optional[Path] = None  # the trace, once written
        self._previews = 0  # get_scores calls that saved a preview
        # LPIPS in fp32 on the scoring device (fake 3D on volumes), shared by
        # every program
        self.perceptual = PerceptualLoss(spatial_dims=self.spatial_dimension).to(device).eval()
        if self.simplex_noise:
            # the JAX CLI draws this seed here too, which fixes the order of
            # every later draw from numpy's global RNG
            self.simplex = Simplex()
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
                          num_workers=int(getattr(a, "num_workers", 1) or 1),
                          num_processes=pmesh.process_count(),
                          process_index=pmesh.process_index())

    def _program(self, skip_factor: int) -> ReconProgram:
        if skip_factor not in self._programs:
            exact = self.simplex_noise and self.simplex_mode == "exact"
            device_noise = self.simplex_noise and not exact
            self._programs[skip_factor] = build_recon_program(
                self, self.args, perceptual_fn=self.perceptual, skip_factor=skip_factor,
                host_noise_fn=self._host_simplex_noise if exact else None,
                simplex_noise_fn=self._device_simplex_noise if device_noise else None,
            )
        return self._programs[skip_factor]

    def _host_simplex_noise(self, shape, t_starts) -> np.ndarray:
        """(K, B, *latent) OpenSimplex planes, one freshly seeded plane per
        (lane, channel, item) in that order: the reference's draw order."""
        b = int(shape[1])
        out = np.empty(shape, dtype=np.float32)
        for k, t in enumerate(np.asarray(t_starts)):
            out[k] = generate_simplex_noise(self.simplex, shape[1:],
                                            np.full((b,), int(t), dtype=np.int64))
        return out

    @staticmethod
    def _device_simplex_noise(generator, shape, t_starts) -> torch.Tensor:
        """(K, B, *latent) on-device simplex-family noise, each lane's seed
        drawn from `generator`."""
        k, b = int(shape[0]), int(shape[1])
        seeds = torch.randint(0, 2**31 - 1, (k,), generator=generator,
                              device=generator.device if generator is not None else None)
        return simplex_noise_device(seeds, shape[1:], t_starts[:, None].expand(k, b))

    def get_scores(self, loader, dataset_name: str, inference_skip_factor: int,
                   save_name: Optional[str] = None,
                   sink: Optional[_CsvSink] = None) -> List[dict]:
        """`save_name` names the error-map directory (several datasets share
        dataset_name "out"); defaults to dataset_name. `sink` receives each
        batch's rows as soon as they are scored; when it holds rows of an
        interrupted run, the batches they cover whole are skipped."""
        log.info(dataset_name)
        program = self._program(inference_skip_factor)
        rank = pmesh.process_index()
        generator = torch.Generator(device=self.device).manual_seed(NOISE_SEED + rank)
        crash_after = int(os.environ.get(CRASH_ENV) or 0)
        names = ("mse", "perceptual_difference") + self.columns[len(COLUMNS):]
        results: List[dict] = []
        n_skipped, first_b, preview_saved = 0, None, False
        # under torchrun a rank skips with the others or not at all: a
        # quantised forward all-reduces its scales, so the ranks' calls pair up
        # batch by batch
        resuming = bool(getattr(self.args, "resume", 0)) and sink is not None
        for batch_idx, batch in enumerate(loader):
            real = np.moveaxis(batch["image"], 1, -1)  # (B, *spatial, C)
            n_real = len(real)
            # a ragged last batch is wrap-padded to the first batch's size and
            # only its real rows are read back, as in the JAX CLI: the padded
            # rows enter every int8 activation absmax, and the noise draw
            first_b = first_b or n_real
            images = (np.take(real, np.arange(first_b) % n_real, axis=0) if n_real < first_b
                      else real)
            held = bool(sink is not None and sink.resumed_rows and len(
                sink.done(batch["filename"], len(program.t_starts))) == n_real)
            if resuming and pmesh.process_count() > 1:
                held = pmesh.all_processes(held, self.device)
            if held:
                program.skip(images, generator)  # the noise it would have drawn
                n_skipped += n_real
                continue
            profiler = None
            if self.profile_dir and batch_idx == 1 and self.profile_path is None and rank == 0:
                profiler = start_trace(self.device)  # a warm batch: batch 0 pays the set-up
            t1 = time.perf_counter()
            t_starts, *scores = program(images, generator, noise_batch=first_b)
            by_name = {c: v[:, :n_real].cpu().numpy()  # waits for the device
                       for c, v in zip(names, scores)}
            if profiler is not None:
                self.profile_path = stop_trace(profiler, self.device, self.profile_dir,
                                               f"scoring_{dataset_name}_batch1")
            rows = []
            for k, t in enumerate(t_starts):
                for b, f in enumerate(batch["filename"]):
                    row = {"filename": _stem(f), "type": dataset_name, "t": int(t)}
                    row.update((c, float(by_name[c][k, b])) for c in self.columns[3:])
                    rows.append(row)
            if self.save_error_maps:
                self._save_error_maps(program.last_error_maps[:n_real].cpu().numpy(),
                                      batch["filename"], save_name or dataset_name)
            results.extend(rows)
            if sink is not None:
                sink.append(rows)
                if crash_after and batch_idx + 1 >= crash_after:
                    log.info(f"fault injection: SIGKILL after batch {batch_idx}")
                    os.kill(os.getpid(), signal.SIGKILL)
            secs = time.perf_counter() - t1
            n = len(t_starts) * n_real  # the real rows' recons
            self.batch_times.append((n, secs))
            log.info(f"Took {secs:.2f}s for a batch size of {n_real} "
                     f"({n / secs:.1f} recons/s)")
            if not preview_saved and rank == 0:
                # one name per get_scores call: every out dataset is "out"
                self._previews += 1
                tag = (dataset_name if dataset_name in ("val", "in")
                       else f"{dataset_name}_{self._previews}")
                self._save_preview(images, program.last_preview.cpu().numpy(), tag)
                preview_saved = True
        if n_skipped:
            log.info(f"resume: skipped {n_skipped} already-scored images for '{dataset_name}' "
                     "(rows persisted by the interrupted run)")
        return results

    def _save_preview(self, images: np.ndarray, recon: np.ndarray, tag: str) -> Path:
        """``ood/preview_<tag>.npy``: (2, n, *spatial, C), the first n <= 8
        images and their reconstructions from the highest start point."""
        n = min(len(recon), len(images), 8)
        path = self.out_dir / f"preview_{tag}.npy"
        np.save(path, np.stack([np.asarray(images[:n], np.float32),
                                np.asarray(recon[:n], np.float32)]))
        return path

    def _save_error_maps(self, maps: np.ndarray, filenames, name: str) -> None:
        """One ``<stem>.npy`` per image under ood/error_maps/<name>/: the
        per-pixel squared reconstruction error, mean over every start point,
        channels last."""
        out = self.out_dir / "error_maps" / name
        out.mkdir(parents=True, exist_ok=True)
        for m, filename in zip(maps, filenames):
            np.save(out / f"{_stem(filename)}.npy", m)

    def _run_scored(self, loader, dataset_name: str, csv_name: str, **kw) -> None:
        sink = _CsvSink(self.out_dir, csv_name, self.columns,
                        resume=bool(getattr(self.args, "resume", 0)))
        if sink.resumed_rows:
            log.info(f"resume: reloaded {sink.resumed_rows} rows for '{csv_name}' from "
                     f"{sink.partial.name}")
        self.get_scores(loader, dataset_name, self.args.inference_skip_factor, sink=sink, **kw)
        sink.finalize()

    def reconstruct(self, args) -> None:
        try:
            self._reconstruct(args)
        finally:
            for program in self._programs.values():
                program.close()

    def _reconstruct(self, args) -> None:
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
