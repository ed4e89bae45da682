"""Long-lived OOD scoring service over a trained run, and its CLI.

Port of ``ddpm_ood_tpu/serve.py`` and ``scripts/serve.py``: load a trained
(possibly latent) DDPM once, keep the reconstruction-sweep program resident
on the card, and score POSTed images against the validation per-t
statistics: the z-score math of ``ood_detection`` (reference
ood_detection.py:150-174), per request instead of per CSV.

Pieces:
  - ``build_recon_program(trainer, args, ...)``: the one place where the
    port assembles a ``ReconProgram`` from a trainer's model, VQ-VAE and
    schedule (the scoring CLI's ``Reconstruct`` goes through it too, so
    serving and offline scoring cannot diverge), and ``NOISE_SEED``, the seed
    of both scoring generators;
  - ``ScoringService``: wrap-pads each request up to the service batch,
    runs one sweep, z-scores against ``results_val.csv``'s statistics (the
    port's numpy ``Table``, no pandas), returns per-image scores; optional
    decisions at a validation-calibrated false-positive rate, ops counters
    and a drift ring;
  - ``BatchingScoringService``: coalesces concurrent requests into one sweep;
  - a dependency-free stdlib HTTP front end: POST /score with an .npy body
    -> JSON, POST /reload, GET /healthz, /statz and /metricz (Prometheus
    text), optional bearer-token auth; SIGTERM drains in-flight requests.

The JSON payloads and the Prometheus names are the JAX package's. There is
no compile cache to warm on the card: ``warmup_program`` runs one sweep on
a zero batch with a throwaway generator, which pays the kernel library's
build or load, the CUDA context and cuDNN's algorithm choice before the
first request. Noise comes from the service's own generator, seeded like
the scoring CLI's, so a fresh service's first sweep draws what the CLI's
first batch of a dataset pass draws.

    python -m ddpm_ood_tpu_torch.serve --output_dir=... --model_name=fashionmnist \\
        --model_type=small --is_grayscale=1 --beta_schedule=scaled_linear_beta \\
        --beta_start=0.0015 --beta_end=0.0195 --image_size=32 \\
        --num_inference_steps=100 --inference_skip_factor=4 --batch_size=32 \\
        --port=8700 [--device=cuda|cpu]

It takes the flags of the JAX package's ``scripts/serve.py`` plus
``--device`` (default cuda, which raises without a card). ``--quantize``
serves the quantised UNet (int8, w8 or mixed; a request batched with others
is quantised with them, as in JAX); ``--aot_cache`` (TPU-only) raises
NotImplementedError naming the flag. A hot reload re-reads the weights in
place, and the quantised layers re-quantise them at their next call.

Under torchrun the service is sharded, the twin of the JAX service's
``shard_fn`` over a data mesh (``scripts/serve.py``): each request batch is
split over the ranks, one card a rank (NCCL) or every rank on one card
(``DDPM_OOD_TORCH_SHARED_CARD=1``, gloo; ``--device=cpu``: gloo)::

    python -m torch.distributed.run --standalone --nproc_per_node=2 \\
        -m ddpm_ood_tpu_torch.serve <the flags above>

Rank 0 serves HTTP; the others follow it (``ScoringService.follow``).
``--quantize=int8`` takes each activation scale over the whole batch, every
rank's rows, as JAX's sharded program does.
"""

from __future__ import annotations

import collections
import dataclasses
import hmac
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .ood.score import Table, dedup, read_results_csv
from .parallel import mesh as pmesh
from .recon.sweep import ReconProgram

log = logging.getLogger(__name__)

NOISE_SEED = 777  # the JAX pipeline's PRNGKey(777 + process_index), plus the rank


def resolve_recon_groups(value, spatial_dimension: int = 2) -> int:
    """'auto' -> 16 lane groups in 2D, 3 in 3D: the JAX package's choice,
    tuned on a TPU and not measured on a GPU. Integers pass through; the
    sweep clamps to the start-point count."""
    s = str("auto" if value is None else value).strip().lower()
    if s != "auto":
        return int(s)
    return 3 if int(spatial_dimension) == 3 else 16


def build_recon_program(trainer, args, perceptual_fn=None, simplex_noise_fn=None,
                        host_noise_fn=None, skip_factor: Optional[int] = None) -> ReconProgram:
    """The scoring program of a BaseTrainer-derived object (which owns the
    model, the VQ-VAE hooks, the schedule, b_scale and the latent pad)."""
    return ReconProgram(
        sched=trainer.sched, model_fn=trainer.model_fn, device=trainer.device,
        num_inference_steps=int(getattr(args, "num_inference_steps", 100)),
        inference_skip_factor=int(skip_factor if skip_factor is not None
                                  else getattr(args, "inference_skip_factor", 1)),
        b_scale=trainer.b_scale, sampler=getattr(args, "sampler", "plms"),
        num_groups=resolve_recon_groups(getattr(args, "recon_groups", "auto"),
                                        trainer.spatial_dimension),
        autocast_dtype=trainer.autocast_dtype, perceptual_fn=perceptual_fn,
        score_elbo=bool(getattr(args, "score_elbo", 0)),
        score_ssim=bool(getattr(args, "score_ssim", 0)),
        score_error_maps=bool(getattr(args, "save_error_maps", 0)),
        encode_fn=trainer.encode_fn, decode_fn=trainer.decode_fn, latent_pad=trainer.latent_pad,
        # the loader resizes to image_size, so the latent shape is known
        latent_sample_shape=trainer._latent_sample_shape() if trainer.image_size else None,
        host_noise_fn=host_noise_fn, simplex_noise_fn=simplex_noise_fn,
        sharded=pmesh.process_count() > 1,
    )


def serving_example(args, batch_size: int) -> Optional[np.ndarray]:
    """(batch, *spatial, C) float32 zeros in the serving geometry, or None
    when args give neither image_size nor image_roi."""
    spatial = None
    if getattr(args, "image_size", None):
        spatial = (int(args.image_size),) * int(getattr(args, "spatial_dimension", 2))
    elif getattr(args, "image_roi", None):
        spatial = tuple(int(s) for s in args.image_roi)  # parsed by ast.literal_eval
    if spatial is None:
        return None
    channels = 1 if getattr(args, "is_grayscale", 0) else 3
    return np.zeros((int(batch_size),) + spatial + (channels,), np.float32)


def warmup_program(program: ReconProgram, args, batch_size: int) -> float:
    """One sweep on the zero example before the first request: the kernel
    library's build or load, the CUDA context and cuDNN's heuristics. It runs
    on a copy of the program with Gaussian noise from a throwaway generator,
    so neither the service's generator nor a host noise function moves, and
    the program's own counters stay those of served sweeps. A sharded
    program's sweep runs on every rank at once, each on its rows of the
    service's global batch, as a request's does. Returns the seconds it
    took, or -1.0 when the geometry cannot be derived from args."""
    world = pmesh.process_count() if program.sharded else 1
    example = serving_example(args, -(-int(batch_size) // world) * world)
    if example is None:
        return -1.0
    warm = dataclasses.replace(program, host_noise_fn=None, simplex_noise_fn=None)
    kw = {"global_batch": len(example)} if world > 1 else {}
    t0 = time.perf_counter()
    _, *scores = warm(pmesh.shard_rows(example, world),
                      torch.Generator(device=program.device).manual_seed(0), **kw)
    for s in scores:
        s.cpu()  # waits for the device
    return time.perf_counter() - t0


def _per_t_mean_std(table: Table, target: str) -> Dict[int, Tuple[float, float]]:
    """pandas' ``groupby("t")[target].agg(["mean", "std"])``: NaN values
    skipped, the std with ddof 1 (NaN below two values)."""
    out = {}
    for t in np.unique(table["t"]):
        v = table[target][table["t"] == t].astype(np.float64)
        v = v[~np.isnan(v)]
        mean = float(v.mean()) if len(v) else float("nan")
        std = float(v.std(ddof=1)) if len(v) > 1 else float("nan")
        out[int(t)] = (mean, std)
    return out


def _mean_by(keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """pandas' ``values.groupby(keys).mean()``: NaN skipped, NaN for a group
    without a value, groups in sorted key order."""
    groups, inv = np.unique(keys, return_inverse=True)
    ok = ~np.isnan(values)
    sums = np.bincount(inv, weights=np.where(ok, values, 0.0), minlength=len(groups))
    counts = np.bincount(inv, weights=ok, minlength=len(groups))
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)


# a sharded service's rank 0 broadcasts a header of HEADER_LEN int64s, (op,
# ndim, *shape), before each collective step of the other ranks
OP_STOP, OP_SCORE, OP_RELOAD, OP_KEEPALIVE = range(4)
HEADER_LEN = 8
# an idle sharded service's rank 0 broadcasts OP_KEEPALIVE about this often:
# a rank waiting in a collective longer than the group's timeout
# (parallel/mesh.py, 10 minutes) would fail
KEEPALIVE_SECONDS = 60.0


class ScoringService:
    """Score images against a trained run's validation statistics.

    program: a ReconProgram; batch_size: the sweep's batch (requests are
    wrap-padded up to it); val_stats: the port's table of a deduplicated
    ``results_val.csv`` (``ood.score.read_results_csv``), whose per-t mean
    and std of mse and perceptual_difference (and of elbo / ssim_distance
    when both the program and the table have them) normalise the scores;
    image_shape: the (*spatial, C) of one image the service scores (a
    request of another shape raises ValueError, the HTTP layer's 400);
    model: the module whose weights a sharded service's reload sends from
    rank 0 to the other ranks.

    A ``sharded`` program in a group of W processes (torchrun) makes the
    JAX service's ``shard_fn``: every rank builds this service; rank 0
    scores, wrap-padding each request to the batch and then up to a multiple
    of W (JAX's ``shard_batch``), broadcasts a header and the padded batch,
    sweeps its own rows and takes the gathered scores; the other ranks run
    ``follow()``. Every rank's generator is seeded alike and the sweep draws
    the global batch's noise, so the scores are those of one process. Rank 0
    refuses a request whose image shape is not ``image_shape`` before the
    other ranks see it, and a reload copies the weights rank 0 read into
    every rank's `model`, so the ranks never serve two checkpoints."""

    def __init__(self, program: ReconProgram, val_stats: Table, batch_size: int,
                 model_name: str = "model", reload_fn=None, flag_fpr: float = 0.0,
                 drift_window: int = 256, image_shape: Optional[Tuple[int, ...]] = None,
                 model: Optional[torch.nn.Module] = None):
        self.program = program
        self.image_shape = None if image_shape is None else tuple(int(d) for d in image_shape)
        self.model = model
        # POST /reload: a callable that copies freshly read weights into the
        # program's model in place and returns a description; the program,
        # its model_fn and the kernel library stay as they are
        self.reload_fn = reload_fn
        self.batch_size = int(batch_size)
        self.model_name = model_name
        self._lock = threading.Lock()  # one sweep in flight on the device
        # the scoring CLI's seed: a fresh service's first sweep draws the
        # noise of the CLI's first batch of a dataset pass
        self.generator = torch.Generator(device=program.device).manual_seed(NOISE_SEED)
        self.warmup_seconds = -1.0  # set by build_service
        t_col = np.asarray(val_stats["t"]).astype(np.int64)
        mse_col = np.asarray(val_stats["mse"], np.float64)
        # pandas' groupby("t")["mse"].count(): the non-NaN rows of every t
        thin = [int(t) for t in np.unique(t_col)
                if np.count_nonzero(~np.isnan(mse_col[t_col == t])) < 2]
        if thin:
            # a single validation row makes the sample std (ddof=1) NaN, which
            # would turn EVERY response into NaN z-scores with HTTP 200
            raise ValueError(
                f"results_val.csv has fewer than 2 rows for t_start(s) {thin} "
                "— per-t z-score std is undefined; reconstruct a larger validation set")
        # the likelihood and SSIM columns are served when BOTH the program
        # emits them and the validation table carries them
        self.serve_elbo = bool(getattr(program, "score_elbo", False)) and "elbo" in val_stats
        self.serve_ssim = bool(getattr(program, "score_ssim", False)) and \
            "ssim_distance" in val_stats
        targets = (("mse", "perceptual_difference") + (("elbo",) if self.serve_elbo else ())
                   + (("ssim_distance",) if self.serve_ssim else ()))
        table = {"t": t_col, **{c: np.asarray(val_stats[c], np.float64) for c in targets}}
        self._stats: Dict[str, Dict[int, tuple]] = {
            target: {t: (mu, sd + 1e-12) for t, (mu, sd) in _per_t_mean_std(table, target).items()}
            for target in targets
        }
        missing = [int(t) for t in program.t_starts if int(t) not in self._stats["mse"]]
        if missing:
            raise ValueError(
                f"results_val.csv lacks stats for start points {missing} — the service must "
                "use the same num_inference_steps / inference_skip_factor as the validation "
                "reconstruction run")
        # optional decision operating point: with flag_fpr in (0, 1) each
        # response carries is_ood / ood_flags, thresholded at the
        # (1 - flag_fpr) quantile of the validation images' own per-image
        # mean-z distribution, over the program's start points only
        self.flag_fpr = float(flag_fpr)
        self.z_thresholds: Dict[str, float] = {}
        if self.flag_fpr != 0.0:
            if not 0.0 < self.flag_fpr < 1.0:
                raise ValueError(f"flag_fpr must be in (0, 1), got {flag_fpr}")
            rows = np.isin(t_col, [int(t) for t in program.t_starts])
            names = np.asarray(val_stats["filename"])[rows]
            for target in targets:
                stats = self._stats[target]
                mu = np.array([stats[int(t)][0] for t in t_col[rows]])
                sd = np.array([stats[int(t)][1] for t in t_col[rows]])
                z = (table[target][rows] - mu) / sd
                self.z_thresholds[target] = float(
                    np.quantile(_mean_by(names, z), 1.0 - self.flag_fpr))
        # request-size ceiling: the service batch of f64 images at a generous
        # 64 MiB/image, plus npy header slack
        self.max_body_bytes = self.batch_size * 64 * 1024 * 1024 + 1024 * 1024
        # ops counters, served at GET /statz (requests are tallied by the
        # HTTP layer, so batched coalescing is visible)
        self.stats: Dict[str, float] = {
            "requests": 0, "images": 0, "sweeps": 0, "device_seconds": 0.0,
            "reloads": 0, "z_mse_sum": 0.0,
        }
        # drift indicator: the last `drift_window` served images' z_score_mse
        if drift_window < 1:
            raise ValueError(f"drift_window must be >= 1, got {drift_window}")
        self.drift_window = int(drift_window)
        self._drift_ring: "collections.deque[float]" = collections.deque(
            maxlen=self.drift_window)
        self.world = pmesh.process_count() if program.sharded else 1
        self.rank = pmesh.process_index()
        if self.world > 1 and self.image_shape is None:
            raise ValueError("a sharded service needs image_shape, to refuse a request of "
                             "another shape before the other ranks sweep it")
        if self.world > 1 and reload_fn is not None and model is None:
            raise ValueError("a sharded service with a reload hook needs the model whose "
                             "weights rank 0 sends the other ranks")
        self._stopped = threading.Event()
        self._keepalive = None
        self._last_lead = time.monotonic()
        if self.world > 1 and self.rank == 0:
            if self.batch_size % self.world:
                print(f"serve: batch_size {self.batch_size} not divisible by {self.world} "
                      "processes — batches wrap-pad up to the next multiple (one-time; scores "
                      "are unaffected)", flush=True)
            self._keepalive = threading.Thread(target=self._keep_alive,
                                               args=(KEEPALIVE_SECONDS,), daemon=True)
            self._keepalive.start()

    def reload(self) -> str:
        """Swap in freshly read checkpoint weights under the sweep lock, so no
        sweep sees half of them; a sharded service's other ranks then take
        rank 0's weights (a checkpoint written meanwhile reaches no rank)."""
        if self.reload_fn is None:
            raise RuntimeError("service was started without a reload hook")
        with self._lock:
            desc = self.reload_fn()
            if self.world > 1:
                self._lead(OP_RELOAD)
                self._share_weights()
            self.stats["reloads"] += 1
        return str(desc)

    def _checked(self, images) -> np.ndarray:
        """The request as float32, its size and image shape checked."""
        images = np.asarray(images, np.float32)
        if images.shape[0] > self.batch_size:
            raise ValueError(f"batch {images.shape[0]} > service batch_size {self.batch_size}")
        if self.image_shape is not None and images.shape[1:] != self.image_shape:
            raise ValueError(f"images of shape {images.shape[1:]}: the service scores "
                             f"{self.image_shape}")
        return images

    # ------------------------------------------ sharded over processes --
    def _lead(self, op: int, batch: Optional[np.ndarray] = None) -> None:
        """Rank 0, under the sweep lock: the header of `op` (and `batch`)
        to every rank."""
        header = torch.zeros(HEADER_LEN, dtype=torch.int64)
        header[0] = op
        if batch is not None:
            header[1] = batch.ndim
            header[2:2 + batch.ndim] = torch.tensor(batch.shape)
        pmesh.broadcast_(header.to(self.program.device))
        if batch is not None:
            pmesh.broadcast_(torch.from_numpy(np.ascontiguousarray(batch)).to(self.program.device))
        self._last_lead = time.monotonic()

    def _share_weights(self) -> None:
        """Every rank, at a reload: rank 0's parameters and buffers copied
        into this rank's model (in place, so quantised layers re-quantise)."""
        with torch.no_grad():
            for t in self.model.state_dict().values():
                t.copy_(pmesh.broadcast_(t.clone(memory_format=torch.contiguous_format)))

    def _keep_alive(self, every: float) -> None:
        while not self._stopped.wait(every):
            with self._lock:
                if not self._stopped.is_set() and time.monotonic() - self._last_lead >= every:
                    self._lead(OP_KEEPALIVE)

    def _sweep(self, pad: np.ndarray) -> tuple:
        """The program on the padded request, under the sweep lock: on one
        process directly; sharded, this rank's rows of the batch wrap-padded
        to a multiple of the ranks, the gathered scores back."""
        if self.world == 1:
            return self.program(pad, self.generator)
        pad = pmesh.wrap_pad(pad, self.world)
        self._lead(OP_SCORE, pad)
        return self.program(pmesh.shard_rows(pad, self.world), self.generator,
                            global_batch=len(pad))

    def follow(self) -> None:
        """A sharded service's rank other than 0: sweep its rows of each
        batch rank 0 broadcasts, reload when rank 0 reloads, and return at
        rank 0's stop (``stop()``)."""
        while True:
            header = pmesh.broadcast_(torch.zeros(HEADER_LEN, dtype=torch.int64,
                                                  device=self.program.device)).cpu()
            op = int(header[0])
            if op == OP_STOP:
                return
            if op == OP_RELOAD:
                self._share_weights()
                self.stats["reloads"] += 1
            elif op == OP_SCORE:
                shape = tuple(header[2:2 + int(header[1])].tolist())
                pad = pmesh.broadcast_(torch.empty(shape, dtype=torch.float32,
                                                   device=self.program.device))
                t0 = time.perf_counter()
                _, *scores = self.program(pmesh.shard_rows(pad, self.world), self.generator,
                                          global_batch=shape[0])
                scores[0].cpu()  # waits for the device
                self.stats["sweeps"] += 1
                self.stats["device_seconds"] += time.perf_counter() - t0

    def stop(self) -> None:
        """Rank 0 of a sharded service, once its last request is answered:
        every other rank leaves ``follow()``. Idempotent; a no-op elsewhere."""
        self._stopped.set()
        if self._keepalive is not None:
            self._keepalive.join()
        with self._lock:
            if self.world > 1 and self.rank == 0 and self._keepalive is not None:
                self._lead(OP_STOP)
                self._keepalive = None

    @classmethod
    def from_val_csv(cls, program, val_csv: str | Path, batch_size: int,
                     model_name: str = "model") -> "ScoringService":
        return cls(program, dedup(read_results_csv(val_csv)), batch_size, model_name)

    def score(self, images: np.ndarray) -> list:
        """images: (B, *spatial, C) floats in [0, 1], B <= batch_size.
        Returns one dict per image: z_score_mse / z_score_perceptual (mean
        over start points, the reference's per-image aggregation), the
        optional z_score_elbo / z_score_ssim and decisions, and the raw per-t
        values."""
        images = self._checked(images)
        b = images.shape[0]
        if b == 0:
            return []
        pad = np.take(images, np.arange(self.batch_size) % b, axis=0)
        with self._lock:
            t0 = time.perf_counter()
            t_starts, *scores = self._sweep(pad)
            # on the host inside the lock: the clock then covers the sweep,
            # not only its enqueue
            scores = [s.cpu().numpy()[:, :b] for s in scores]
            self.stats["sweeps"] += 1
            self.stats["images"] += b
            self.stats["device_seconds"] += time.perf_counter() - t0
        mse, perc = scores[:2]
        # extras ride after (mse, perc) in program-flag order: elbo, then
        # ssim; index by what the PROGRAM emits, serve what the table normalises
        idx = 2
        elbo = ssim = None
        if getattr(self.program, "score_elbo", False):
            if self.serve_elbo:
                elbo = scores[idx]
            idx += 1
        if getattr(self.program, "score_ssim", False) and self.serve_ssim:
            ssim = scores[idx]
        out = []
        for i in range(b):
            rec: Dict[str, object] = {"per_t": {}}
            zs = {"mse": [], "perceptual_difference": [], "elbo": [], "ssim_distance": []}
            for k, t in enumerate(int(t) for t in t_starts):
                m_mu, m_sd = self._stats["mse"][t]
                p_mu, p_sd = self._stats["perceptual_difference"][t]
                zs["mse"].append((float(mse[k, i]) - m_mu) / m_sd)
                zs["perceptual_difference"].append((float(perc[k, i]) - p_mu) / p_sd)
                rec["per_t"][t] = {"mse": float(mse[k, i]),
                                   "perceptual_difference": float(perc[k, i])}
                if elbo is not None:
                    e_mu, e_sd = self._stats["elbo"][t]
                    zs["elbo"].append((float(elbo[k, i]) - e_mu) / e_sd)
                    rec["per_t"][t]["elbo"] = float(elbo[k, i])
                if ssim is not None:
                    s_mu, s_sd = self._stats["ssim_distance"][t]
                    zs["ssim_distance"].append((float(ssim[k, i]) - s_mu) / s_sd)
                    rec["per_t"][t]["ssim_distance"] = float(ssim[k, i])
            rec["z_score_mse"] = float(np.mean(zs["mse"]))
            rec["z_score_perceptual"] = float(np.mean(zs["perceptual_difference"]))
            if elbo is not None:
                rec["z_score_elbo"] = float(np.mean(zs["elbo"]))
            if ssim is not None:
                rec["z_score_ssim"] = float(np.mean(zs["ssim_distance"]))
            if self.z_thresholds:
                # is_ood follows the reference's headline statistic (mse,
                # ood_detection.py:73); ood_flags carries every served target
                flags = {
                    "mse": rec["z_score_mse"] > self.z_thresholds["mse"],
                    "perceptual_difference": rec["z_score_perceptual"]
                    > self.z_thresholds["perceptual_difference"],
                }
                if elbo is not None and "elbo" in self.z_thresholds:
                    flags["elbo"] = rec["z_score_elbo"] > self.z_thresholds["elbo"]
                if ssim is not None and "ssim_distance" in self.z_thresholds:
                    flags["ssim_distance"] = (
                        rec["z_score_ssim"] > self.z_thresholds["ssim_distance"])
                rec["ood_flags"] = {k: bool(v) for k, v in flags.items()}
                rec["is_ood"] = bool(flags["mse"])
            out.append(rec)
        with self._lock:
            self.stats["z_mse_sum"] += float(sum(r["z_score_mse"] for r in out))
            self._drift_ring.extend(float(r["z_score_mse"]) for r in out)
        return out


class BatchingScoringService:
    """Dynamic request batching over a ScoringService.

    Concurrent ``score()`` calls are coalesced into ONE sweep: the first
    arrival opens a window of `batch_window_ms`, and every request queued by
    its close (up to the service batch) rides the same sweep. The sweep costs
    the same for any request size up to the batch (the tail is wrap-padded),
    so under single-image load this multiplies throughput by up to
    `batch_size`, at the price of at most one window of added latency.
    Per-image scores equal unbatched scoring given the same noise: the
    sweep's metrics are independent per image.

    Delegates everything else (stats, caps, metadata) to the wrapped service.
    """

    def __init__(self, service: ScoringService, batch_window_ms: float = 5.0):
        self.inner = service
        self.batch_window_ms = float(batch_window_ms)
        self._queue = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def __getattr__(self, name):  # model_name, batch_size, program, caps, stop, ...
        return getattr(self.inner, name)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=10)

    def score(self, images: np.ndarray) -> list:
        images = self.inner._checked(images)  # a refused request joins no sweep
        if images.shape[0] == 0:
            return []
        req = {"images": images, "event": threading.Event(), "result": None, "error": None}
        with self._cv:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.append(req)
            self._cv.notify()
        req["event"].wait()
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                batch = [self._queue.popleft()]
                total = batch[0]["images"].shape[0]
                # the window opens at the FIRST dequeued request
                deadline = time.monotonic() + self.batch_window_ms / 1e3
                while total < self.inner.batch_size:
                    if not self._queue:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                        continue  # re-check queue and deadline after any wake
                    n = self._queue[0]["images"].shape[0]
                    if total + n > self.inner.batch_size:
                        break  # left for the next sweep
                    batch.append(self._queue.popleft())
                    total += n
            try:
                results = self.inner.score(np.concatenate([r["images"] for r in batch], axis=0))
                off = 0
                for r in batch:
                    n = r["images"].shape[0]
                    r["result"] = results[off: off + n]
                    off += n
            except Exception as e:  # propagate to every waiting caller
                for r in batch:
                    r["error"] = e
            finally:
                for r in batch:
                    r["event"].set()


def collect_stats(service: ScoringService) -> Dict[str, object]:
    """The /statz payload: ops counters, derived rates and drift indicators."""
    s = dict(service.stats)
    s["world_size"] = service.world
    sweeps = max(int(s["sweeps"]), 1)
    s["mean_sweep_seconds"] = s["device_seconds"] / sweeps
    s["coalescing_ratio"] = s["requests"] / sweeps if s["requests"] else 0.0
    # drift: windowed mean z over the LAST drift_window served images; the
    # lifetime mean is kept for continuity but goes inert at high volume
    ring = list(service._drift_ring)
    s["mean_served_z_mse"] = sum(ring) / len(ring) if ring else 0.0
    s["drift_window"] = service.drift_window
    s["drift_window_filled"] = len(ring)
    s["lifetime_mean_z_mse"] = s.pop("z_mse_sum") / s["images"] if s["images"] else 0.0
    thr = getattr(service, "z_thresholds", None)
    if thr:
        s["flag_fpr"] = service.flag_fpr
        s["z_thresholds"] = thr
    return s


# (metric name, /statz key, prometheus type) for the scrape endpoint
_PROM_METRICS = (
    ("ddpm_ood_requests_total", "requests", "counter"),
    ("ddpm_ood_images_total", "images", "counter"),
    ("ddpm_ood_sweeps_total", "sweeps", "counter"),
    ("ddpm_ood_reloads_total", "reloads", "counter"),
    ("ddpm_ood_device_seconds_total", "device_seconds", "counter"),
    ("ddpm_ood_mean_sweep_seconds", "mean_sweep_seconds", "gauge"),
    ("ddpm_ood_coalescing_ratio", "coalescing_ratio", "gauge"),
    ("ddpm_ood_mean_served_z_mse", "mean_served_z_mse", "gauge"),
    ("ddpm_ood_drift_window_filled", "drift_window_filled", "gauge"),
    ("ddpm_ood_lifetime_mean_z_mse", "lifetime_mean_z_mse", "gauge"),
)


def prometheus_text(service: ScoringService) -> str:
    """GET /metricz: the /statz numbers in Prometheus exposition format
    (text/plain 0.0.4)."""
    s = collect_stats(service)
    lines = []
    for name, key, kind in _PROM_METRICS:
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {float(s[key]):g}")
    for target, value in (s.get("z_thresholds") or {}).items():
        name = "ddpm_ood_z_threshold"
        if not any(line.startswith(f"# TYPE {name} ") for line in lines):
            lines.append(f"# TYPE {name} gauge")
        lines.append(f'{name}{{target="{target}"}} {float(value):g}')
    return "\n".join(lines) + "\n"


def make_handler(service: ScoringService, auth_token: Optional[str] = None):
    """auth_token: when set, every endpoint except GET /healthz (left open
    for load-balancer probes) requires `Authorization: Bearer <token>`,
    compared in constant time. The CLI listens on 0.0.0.0 by default: set a
    token anywhere the network is not already trusted."""

    class OODRequestHandler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            if auth_token is None or self.path == "/healthz":
                return True
            header = self.headers.get("Authorization", "")
            supplied = header[len("Bearer "):] if header.startswith("Bearer ") else ""
            if hmac.compare_digest(supplied, auth_token):
                return True
            self._json(401, {"error": "missing or invalid bearer token"})
            return False

        def do_GET(self):
            if not self._authorized():
                return
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": service.model_name,
                    "batch_size": service.batch_size,
                    "t_starts": [int(t) for t in service.program.t_starts],
                    "world_size": service.world,
                })
            elif self.path == "/statz":
                self._json(200, collect_stats(service))
            elif self.path == "/metricz":
                body = prometheus_text(service).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if not self._authorized():
                return
            if self.path == "/reload":
                try:
                    self._json(200, {"reloaded_from": service.reload()})
                except RuntimeError as e:
                    self._json(409, {"error": str(e)})
                except FileNotFoundError as e:
                    self._json(404, {"error": str(e)})
                except Exception as e:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != "/score":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            service.stats["requests"] += 1
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > service.max_body_bytes:
                    self._json(413, {
                        "error": f"request body {n} bytes exceeds cap "
                        f"{service.max_body_bytes} (batch_size {service.batch_size})"
                    })
                    return
                arr = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                self._json(200, {"scores": service.score(arr)})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # malformed body etc.
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return OODRequestHandler


class _OODHTTPServer(ThreadingHTTPServer):
    # the socketserver default accept backlog is 5: a burst of concurrent
    # single-image clients (the dynamic-batching pattern) overflows it and
    # the overflowed clients see ConnectionResetError instead of queueing.
    # A deep backlog costs nothing; the sweep lock is the real throttle.
    request_queue_size = 128
    # ThreadingHTTPServer's handler threads are daemons, which server_close
    # does not join: the process would exit under an in-flight sweep and cut
    # its response. Non-daemon handlers are joined, so SIGTERM drains them.
    daemon_threads = False


def make_server(service: ScoringService, host: str = "0.0.0.0", port: int = 8700,
                auth_token: Optional[str] = None) -> ThreadingHTTPServer:
    """The serving HTTP server (burst-safe accept backlog), not yet running."""
    return _OODHTTPServer((host, port), make_handler(service, auth_token))


def serve_forever(service: ScoringService, host: str = "0.0.0.0", port: int = 8700,
                  auth_token: Optional[str] = None):
    """Run the HTTP server until SIGTERM/SIGINT; in-flight sweeps finish.

    SIGTERM stops the listener, ``server_close`` joins the handler threads
    (each completes its current request), and the process exits 0, so a
    rolling restart never cuts a response mid-body."""
    import signal

    server = make_server(service, host, port, auth_token)
    print(f"serving OOD scores for {service.model_name} on {host}:{server.server_port}",
          flush=True)

    def _graceful(signum, frame):
        print(f"signal {signum}: draining in-flight requests and shutting down", flush=True)
        # shutdown() must not be called from the serve_forever thread itself
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    except ValueError:
        pass  # not the main thread (tests drive the server directly)
    server.serve_forever()
    server.server_close()


def build_service(args, device: Optional[torch.device] = None):
    """The CLI's service, before it listens: the trainer's model from the
    run's checkpoint, LPIPS, the program, the validation table, the reload
    hook and a warmup sweep; a BatchingScoringService with
    ``--batch_window_ms``. Under torchrun the process joins the group (if it
    has not) and the service is sharded over its ranks; every rank builds
    it. Raises FileNotFoundError without a checkpoint."""
    from .losses.lpips import PerceptualLoss
    from .trainers.base import BaseTrainer, resolve_device
    from .trainers.reconstruct import refuse_unported_flags  # the scoring CLI's refusals
    from .utils.checkpoint import find_checkpoint, missing_checkpoint_error

    refuse_unported_flags(args)
    device = resolve_device(args.device) if device is None else device
    pmesh.initialize_distributed(device)
    run_dir = Path(args.output_dir) / args.model_name
    epoch = int(args.ddpm_checkpoint_epoch) if args.ddpm_checkpoint_epoch else None
    if find_checkpoint(run_dir, epoch) is None:  # before the model is built
        raise missing_checkpoint_error(run_dir)
    trainer = BaseTrainer(args, device)
    # LPIPS in fp32 on the scoring device (fake 3D on volumes), weights from
    # LPIPS_WEIGHTS_NPZ as in the scoring CLI
    perceptual = PerceptualLoss(spatial_dims=trainer.spatial_dimension).to(device).eval()
    program = build_recon_program(trainer, args, perceptual_fn=perceptual)
    val_csv = args.results_val or run_dir / "ood" / "results_val.csv"

    def reload_fn():
        # the newest/best (or the pinned epoch's) weights, copied in place
        # into the model the program calls
        return str(trainer.reload_params(epoch))

    example = serving_example(args, 1)
    service = ScoringService(
        program, dedup(read_results_csv(val_csv)), args.batch_size, model_name=args.model_name,
        reload_fn=reload_fn, flag_fpr=args.flag_fpr, drift_window=args.drift_window,
        image_shape=None if example is None else example.shape[1:], model=trainer.unet)
    if service.z_thresholds:
        print(f"decision thresholds (flag_fpr={args.flag_fpr}): {service.z_thresholds}",
              flush=True)
    service.warmup_seconds = warmup_program(program, args, args.batch_size)
    if service.warmup_seconds >= 0:
        print(f"warm: ran {len(program._groups)} lane groups in "
              f"{service.warmup_seconds:.1f} s"
              + (f" (rank {service.rank} of {service.world})" if service.world > 1 else ""),
              flush=True)
    if args.batch_window_ms > 0:
        return BatchingScoringService(service, args.batch_window_ms)
    return service


def main(argv=None) -> None:
    """One process, or every rank of a torchrun launch: rank 0 binds the
    HTTP server and, once SIGTERM has drained it, stops the other ranks,
    which follow it until then (the SIGTERM torchrun forwards to them is
    ignored: a rank must not leave a collective halfway)."""
    import signal

    from .config import parse_args_serve
    from .trainers.base import resolve_device

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args_serve(argv)
    device = resolve_device(args.device)
    with pmesh.distributed(device):
        service = build_service(args, device)
        if service.rank != 0:
            def _wait_for_rank0(signum, frame):
                print(f"rank {service.rank}: signal {signum}: waiting for rank 0 to stop",
                      flush=True)

            signal.signal(signal.SIGTERM, _wait_for_rank0)
            signal.signal(signal.SIGINT, _wait_for_rank0)
            service.follow()
            return
        if args.auth_token:
            print("bearer-token auth enabled (all endpoints except GET /healthz)", flush=True)
        try:
            serve_forever(service, args.host, args.port, auth_token=args.auth_token)
        finally:
            if isinstance(service, BatchingScoringService):
                service.close()
            service.stop()


if __name__ == "__main__":
    main()
