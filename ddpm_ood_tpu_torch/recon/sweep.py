"""Batched multi-start-point reconstruction sweep: the scoring hot path.

Port of ``ddpm_ood_tpu/recon/sweep.py`` (``plms_sweep``, ``ddim_sweep``,
``dpm_sweep``, ``group_t_starts`` and ``ReconProgram``). All K start points
("lanes") of a lane group move down one descending grid together; a lane
joins once the grid reaches its start timestep (``t <= t_start``). Every
grid step calls the UNet once on the flattened (K*B) batch. The JAX package
compiles each group into one ``lax.scan``; here each group is a Python loop
of eager launches whose per-step state stays on the device, so no step
waits for the host. The sampler's step math runs in fp32 on the UNet's fp32
output, also inside the bf16 autocast region.

``sampler="plms_ref"`` is the reference's carried-history PLMS
(``diffusion/plms.py:plms_reference_exact_sweep``): sequential, one UNet
call of batch B per step, for parity with the paper's code, not for speed.

Public edges keep the JAX layout, images and noise as (B, *spatial, C) and
(K, B, *spatial, C); the UNet itself takes (N, C, *spatial) in channels_last,
which is a free permute of the same memory.

``metrics_tail`` is the port of the JAX program's ``_score_body``:
per-(lane, image) MSE, LPIPS, optionally 1 - SSIM and the lane-sum of
squared residuals (the error maps), all in fp32, in 2D and 3D.

Latent diffusion: with ``encode_fn`` / ``decode_fn`` (the trainer's frozen
VQ-VAE) and ``latent_pad``, a batch runs encode -> pad -> sweep -> un-pad
-> decode -> / b_scale -> clip -> metrics, the JAX program's order. The JAX
package decodes a lane group's K*B latents inside one compiled program;
eager decoding of K*B volumes at once would hold them all, so the port
decodes one lane (B samples) at a time and scores it as it comes, against
LPIPS taps of the images computed once. The ELBO terms stay in latent space.
``score_elbo`` adds one UNet call per lane group at each lane's own start
point and noise, and the variational-bound term (``diffusion/elbo.py``).

Noise: Gaussian from the caller's ``torch.Generator`` by default;
``host_noise_fn`` (exact simplex noise, or a test's fixed draw) makes it on
the host, and ``simplex_noise_fn`` on the device from the generator. Host
noise is double-buffered as in the JAX program: after each batch's draw one
worker thread starts the next batch's at the same shape, and a batch whose
shape differs consumes and discards that draw before making its own, so
the draws reach a global RNG in the order of a run without prefetch.

Several processes (torchrun, ``parallel/mesh.py``): a ``sharded`` program's
calls are made on every rank together, each on its part of the batch, and
each quantised call takes its activation absmax over the process group, as
JAX's program over a sharded batch does. A call with ``global_batch`` (the
sharded service) is JAX's ``out_mesh`` call: each rank holds its rows of one
global batch, draws the noise of the whole batch and keeps its rows, and
gets every rank's scores back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..diffusion.ddim import ddim_step, ddim_timesteps
from ..diffusion.dpm_solver import dpm_init_state, dpm_step
from ..diffusion.elbo import elbo_terms_from_model
from ..diffusion.plms import (plms_init_state, plms_reference_exact_sweep, plms_step,
                              pndm_start_points, pndm_timesteps)
from ..diffusion.schedules import NoiseSchedule, add_noise, lanes
from ..losses.lpips import PerceptualLoss
from ..ops.quant import absmax_over_processes
from ..ops.ssim import ssim_distance
from ..parallel import mesh as pmesh
from ..utils.padding import pad_torch_style, unpad_torch_style

# model_fn(x (N, C, *spatial), t (N,) int) -> fp32 (N, C, *spatial)
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# perceptual_fn(images (B, *spatial, C), recon (K, B, *spatial, C)) -> (K, B),
# each lane scored against the images (losses.lpips.PerceptualLoss)
PerceptualFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _lane_major_to_model(x: torch.Tensor) -> torch.Tensor:
    """(K, B, *spatial, C) -> (K*B, C, *spatial), a view."""
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    nd = flat.dim()
    return flat.permute((0, nd - 1) + tuple(range(1, nd - 1)))


def _model_to_lane_major(y: torch.Tensor, k: int) -> torch.Tensor:
    """(K*B, C, *spatial) -> (K, B, *spatial, C); contiguous input for
    channels_last model outputs, so a view."""
    nd = y.dim()
    y = y.permute((0,) + tuple(range(2, nd)) + (1,))
    return y.reshape((k, -1) + tuple(y.shape[1:]))


def plms_sweep(
    sched: NoiseSchedule,
    model_fn: ModelFn,
    x0: torch.Tensor,
    noise: torch.Tensor,
    timesteps_desc: torch.Tensor,
    t_starts: torch.Tensor,
    num_inference_steps: int,
    b_scale: float = 1.0,
) -> torch.Tensor:
    """Denoise `x0` (B, *spatial, C) from K start points in one loop.

    noise: (K, B, *spatial, C) fresh noise per lane; timesteps_desc and
    t_starts (K,) ascending are int tensors on x0's device. Returns the
    (K, B, *spatial, C) reconstructions (still b_scaled)."""
    k = t_starts.shape[0]
    step_ratio = sched.num_train_timesteps // num_inference_steps
    x_start = add_noise(sched, (x0 * b_scale)[None], noise, t_starts)  # (K, B, ...)
    state = plms_init_state(x_start)
    n_imgs = k * x0.shape[0]
    for t in timesteps_desc:
        out = model_fn(_lane_major_to_model(state.x), t.expand(n_imgs))
        state = plms_step(sched, state, _model_to_lane_major(out, k), t, step_ratio,
                          active=t <= t_starts)
    return state.x


def ddim_sweep(
    sched: NoiseSchedule,
    model_fn: ModelFn,
    x0: torch.Tensor,
    noise: torch.Tensor,
    timesteps_desc: torch.Tensor,
    t_starts: torch.Tensor,
    num_inference_steps: int,
    b_scale: float = 1.0,
) -> torch.Tensor:
    """DDIM (eta = 0) form of ``plms_sweep``: the lane state is x alone."""
    k = t_starts.shape[0]
    step_ratio = sched.num_train_timesteps // num_inference_steps
    x = add_noise(sched, (x0 * b_scale)[None], noise, t_starts)
    n_imgs = k * x0.shape[0]
    for t in timesteps_desc:
        out = model_fn(_lane_major_to_model(x), t.expand(n_imgs))
        new_x = ddim_step(sched, _model_to_lane_major(out, k), t, t - step_ratio, x)
        x = torch.where(lanes(t <= t_starts, x.dim()), new_x, x)
    return x


def dpm_sweep(
    sched: NoiseSchedule,
    model_fn: ModelFn,
    x0: torch.Tensor,
    noise: torch.Tensor,
    timesteps_desc: torch.Tensor,
    t_starts: torch.Tensor,
    num_inference_steps: int,
    b_scale: float = 1.0,
) -> torch.Tensor:
    """DPM-Solver++(2M) form of ``plms_sweep``: the lane state is (x,
    prev_x0, has_prev), and each lane's first step is first order."""
    k = t_starts.shape[0]
    step_ratio = sched.num_train_timesteps // num_inference_steps
    state = dpm_init_state(add_noise(sched, (x0 * b_scale)[None], noise, t_starts))
    n_imgs = k * x0.shape[0]
    for t in timesteps_desc:
        out = model_fn(_lane_major_to_model(state.x), t.expand(n_imgs))
        state = dpm_step(sched, state, _model_to_lane_major(out, k), t, t - step_ratio,
                         t + step_ratio, active=t <= t_starts)
    return state.x


SWEEPS = {"plms": plms_sweep, "ddim": ddim_sweep, "dpm": dpm_sweep}


def group_t_starts(timesteps_desc: np.ndarray, t_starts: np.ndarray,
                   num_groups: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split ascending t_starts into contiguous groups, each with the
    descending timestep suffix it needs."""
    num_groups = max(1, min(num_groups, len(t_starts)))
    out = []
    for chunk in np.array_split(np.asarray(t_starts), num_groups):
        if len(chunk) == 0:
            continue
        suffix = timesteps_desc[timesteps_desc <= int(chunk.max())]
        out.append((suffix.astype(np.int32), chunk.astype(np.int32)))
    return out


def metrics_tail(images: torch.Tensor, recon: torch.Tensor, b_scale: float = 1.0,
                 perceptual_fn: Optional[PerceptualFn] = None, score_ssim: bool = False,
                 score_error_maps: bool = False):
    """Scores of one lane group's reconstructions, in fp32 with autocast off
    (the JAX package computes them in fp32): /b_scale and clamp to [0, 1],
    then per-(lane, image) MSE, LPIPS (``losses.lpips.PerceptualLoss``, which
    pads inputs under 32x32; zeros without a perceptual function, the JAX
    program's own convention), 1 - SSIM when `score_ssim`, and the lane-sum
    of squared residuals (B, *spatial, C) when `score_error_maps`.

    images (B, *spatial, C) and recon (K, B, *spatial, C) -> (mse (K, B),
    perc (K, B), preview, ssim (K, B) or None, error sum or None); the
    preview is the highest-start lane's reconstructions of up to 8 images."""
    with torch.autocast(images.device.type, enabled=False):
        images = images.float()
        recon = torch.clamp(recon.float() / b_scale, 0.0, 1.0)
        diff = torch.square(images[None] - recon)
        mse = diff.mean(dim=tuple(range(2, diff.dim())))  # (K, B)
        if perceptual_fn is not None:
            perc = perceptual_fn(images, recon)
            if perc.shape != mse.shape:
                raise ValueError(f"perceptual_fn must return per-image scores per lane "
                                 f"{tuple(mse.shape)}; got {tuple(perc.shape)}")
        else:
            perc = torch.zeros_like(mse)
        ssim_d = None
        if score_ssim:
            ssim_d = ssim_distance(images.expand_as(recon).flatten(0, 1),
                                   recon.flatten(0, 1)).view(mse.shape)
        err_sum = diff.sum(dim=0) if score_error_maps else None
        preview = recon[-1, : min(8, recon.shape[1])]
    return mse, perc, preview, ssim_d, err_sum


@dataclasses.dataclass
class ReconProgram:
    """Scoring program: noise -> the sampler's sweep per lane group -> metrics.

    ``__call__(images, generator)`` maps one batch (B, *spatial, C) in [0, 1]
    to (t_starts (K,), mse (K, B), perceptual (K, B)), then elbo (K, B) in
    bits/dim when ``score_elbo`` is set, then ssim_distance (K, B) when
    ``score_ssim`` is set: the JAX program's order. The highest-start lane's
    reconstructions of up to 8 images are kept on ``last_preview``, and with
    ``score_error_maps`` the per-pixel squared error averaged over all K
    start points, (B, *spatial, C), on ``last_error_maps``. ``model_evals``
    counts the UNet calls made (of K*B images in a lane group's sweep and
    its ELBO call, of B images under ``plms_ref``)."""

    sched: NoiseSchedule
    model_fn: ModelFn
    device: torch.device = torch.device("cpu")
    num_inference_steps: int = 100
    inference_skip_factor: int = 1
    b_scale: float = 1.0
    num_groups: int = 8
    # "plms" (fresh history per start point), "plms_ref" (the reference's
    # carried history, sequential), "ddim" (eta = 0) or "dpm" (DPM-Solver++(2M))
    sampler: str = "plms"
    # the trainer passes bf16 on CUDA (fp32 params, bf16 compute); the whole
    # call runs under one autocast region, so each weight is cast once per
    # call rather than once per UNet forward. None computes in fp32.
    autocast_dtype: Optional[torch.dtype] = None
    # host_noise_fn((K, B, *latent), t_starts) -> np.ndarray replaces the
    # generator's Gaussian draw (exact simplex noise; tests feed both
    # packages one draw through it); the next batch's draw is made ahead on
    # one worker thread
    host_noise_fn: Optional[Callable] = None
    # simplex_noise_fn(generator, (K, B, *latent), t_starts (K,)) -> noise
    # on the device (--simplex_noise_mode=device)
    simplex_noise_fn: Optional[Callable] = None
    perceptual_fn: Optional[PerceptualFn] = None
    score_elbo: bool = False
    score_ssim: bool = False
    score_error_maps: bool = False
    # latent diffusion: encode_fn(images (B, *spatial, C)) -> (B, *latent, E)
    # and decode_fn(latents (N, *latent, E)) -> (N, *spatial, C), the frozen
    # VQ-VAE's stage-2 hooks (None in pixel space); latent_pad a torch-style
    # pad tuple; latent_sample_shape the (*latent, E) the UNet is built for,
    # checked against each encoded batch
    encode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    decode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    latent_pad: Optional[Tuple[int, ...]] = None
    latent_sample_shape: Optional[Tuple[int, ...]] = None
    # every rank of the process group makes each call together, on its own
    # part of the batch (the scoring CLI's partitions, a sharded service's
    # rows): each quantised call's activation absmax is then the max over
    # the group (ops.quant.absmax_over_processes), JAX's out_mesh program
    sharded: bool = False

    def __post_init__(self):
        if self.sampler in ("ddim", "dpm"):
            self.timesteps_desc = ddim_timesteps(self.sched.num_train_timesteps,
                                                 self.num_inference_steps)
        elif self.sampler in ("plms", "plms_ref"):
            self.timesteps_desc = pndm_timesteps(self.sched.num_train_timesteps,
                                                 self.num_inference_steps)
        else:
            raise ValueError(f"Unknown sampler {self.sampler!r} (plms, plms_ref, ddim or dpm)")
        if self.sampler == "plms_ref":
            for flag in ("score_elbo", "score_ssim", "score_error_maps"):
                if getattr(self, flag):
                    raise ValueError(f"{flag} is not supported with sampler='plms_ref' (the "
                                     "parity path emits exactly the reference's outputs)")
        self.t_starts = pndm_start_points(self.timesteps_desc, self.inference_skip_factor)
        self._groups = [
            (torch.as_tensor(ts, device=self.device), torch.as_tensor(st, device=self.device))
            for ts, st in group_t_starts(self.timesteps_desc, self.t_starts, self.num_groups)
        ]
        self.model_evals = 0
        self.last_preview = None
        self.last_error_maps = None
        # host noise: seconds spent drawing the draws consumed so far, and
        # seconds the caller's thread waited for them
        self.host_noise_seconds = 0.0
        self.host_noise_wait_seconds = 0.0
        self._noise_executor: Optional[ThreadPoolExecutor] = None
        self._pending_noise: Optional[Tuple[tuple, Future]] = None  # the next batch's draw

    def _model(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        self.model_evals += 1
        return self.model_fn(x, t)

    def _sample_model(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The UNet on B samples in the (B, *spatial, C) layout."""
        return _model_to_lane_major(self._model(_lane_major_to_model(x[None]), t), 1)[0]

    def _draw_host(self, shape: tuple) -> tuple:
        """(host_noise_fn's float32 draw of `shape`, the seconds it took)."""
        t0 = time.perf_counter()
        arr = np.asarray(self.host_noise_fn(shape, self.t_starts), dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"host noise shape {arr.shape} != expected {shape}")
        return arr, time.perf_counter() - t0

    def _host_noise_for(self, shape: tuple) -> np.ndarray:
        """This batch's host draw: the prefetched one when its shape matches,
        else (after consuming a mismatched prefetch) a draw made now; then the
        next batch's draw starts on the worker thread."""
        t0 = time.perf_counter()
        arr = None
        if self._pending_noise is not None:
            pending_shape, future = self._pending_noise
            self._pending_noise = None
            drawn, secs = future.result()
            self.host_noise_seconds += secs
            if pending_shape == shape:
                arr = drawn
        if arr is None:
            arr, secs = self._draw_host(shape)
            self.host_noise_seconds += secs
        self.host_noise_wait_seconds += time.perf_counter() - t0
        if self._noise_executor is None:
            self._noise_executor = ThreadPoolExecutor(max_workers=1,
                                                      thread_name_prefix="host-noise")
        self._pending_noise = (shape, self._noise_executor.submit(self._draw_host, shape))
        return arr

    def close(self) -> None:
        """Wait for a pending host draw and stop the worker thread."""
        if self._pending_noise is not None:
            self._pending_noise[1].result()
            self._pending_noise = None
        if self._noise_executor is not None:
            self._noise_executor.shutdown()
            self._noise_executor = None

    def _noise(self, shape: tuple, generator: Optional[torch.Generator],
               noise_batch: Optional[int], prefetch: bool = True) -> torch.Tensor:
        """(K, B, *latent) noise. Host noise is drawn at `noise_batch` items
        (the run's first batch size, which a ragged last batch keeps) and
        sliced to B."""
        if self.host_noise_fn is not None:
            b = shape[1]
            full = (shape[0], max(b, int(noise_batch or b))) + shape[2:]
            arr = self._host_noise_for(full) if prefetch else self._draw_host(full)[0]
            return torch.from_numpy(arr[:, :b]).to(self.device)
        if self.simplex_noise_fn is not None:
            t_starts = torch.as_tensor(self.t_starts, device=self.device)
            return self.simplex_noise_fn(generator, shape, t_starts).to(self.device)
        return torch.randn(shape, generator=generator, device=self.device)

    def skip(self, images, generator: Optional[torch.Generator] = None) -> None:
        """Advance `generator` past the draw a batch of `images` would make,
        without scoring it (a resumed run's already-scored batch), so the
        batches after it get the noise of a run without the skip. Host noise
        is not drawn for a skipped batch, as in the JAX program."""
        if self.host_noise_fn is not None:
            return
        if self.latent_sample_shape is not None:
            sample = tuple(self.latent_sample_shape)
        else:
            with torch.no_grad():
                sample = tuple(self._encode(torch.as_tensor(images, dtype=torch.float32)
                                            .to(self.device)).shape[1:])
        self._noise((len(self.t_starts), len(images)) + sample, generator, None)

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        """The UNet's input space: the images, encoded and padded."""
        x = images if self.encode_fn is None else self.encode_fn(images)
        if self.latent_pad:
            x = pad_torch_style(x, self.latent_pad)
        if self.latent_sample_shape is not None and \
                tuple(x.shape[1:]) != tuple(self.latent_sample_shape):
            raise ValueError(f"encoded batch {tuple(x.shape)} does not match the latent sample "
                             f"shape {tuple(self.latent_sample_shape)}")
        return x

    def _score(self, images: torch.Tensor, recon: torch.Tensor):
        """``metrics_tail``'s outputs for the sweep's (K, B, *latent, E)
        output: un-padded, then decoded and scored a lane at a time in latent
        diffusion, else scored at once."""
        if self.latent_pad:
            recon = unpad_torch_style(recon, self.latent_pad, images.dim() - 2)
        if self.decode_fn is None:
            return metrics_tail(images, recon, self.b_scale, self.perceptual_fn,
                                self.score_ssim, self.score_error_maps)
        perceptual_fn = self.perceptual_fn
        if isinstance(perceptual_fn, PerceptualLoss):  # the images' taps once for every lane
            with torch.autocast(images.device.type, enabled=False):
                perceptual_fn = functools.partial(
                    perceptual_fn, y_features=perceptual_fn.image_features(images))
        parts = []
        for lane in recon:
            decoded = self.decode_fn(lane)
            parts.append(metrics_tail(
                images, decoded[None], self.b_scale, perceptual_fn, self.score_ssim,
                self.score_error_maps))
        mse, perc, _, ssim_d, err = zip(*parts)
        return (torch.cat(mse), torch.cat(perc), parts[-1][2],
                torch.cat(ssim_d) if self.score_ssim else None,
                sum(err) if self.score_error_maps else None)

    def _elbo(self, x: torch.Tensor, noise: torch.Tensor,
              t_starts: torch.Tensor) -> torch.Tensor:
        """(K, B) bits/dim: one UNet call on every lane's own x_t, the sample
        its trajectory starts from (in latent space for latent diffusion);
        the terms in fp32 with autocast off."""
        k, b = noise.shape[:2]
        x_t = add_noise(self.sched, (x * self.b_scale)[None], noise, t_starts)
        t_flat = t_starts.repeat_interleave(b)
        out = _model_to_lane_major(self._model(_lane_major_to_model(x_t), t_flat), k)
        with torch.autocast(x.device.type, enabled=False):
            return elbo_terms_from_model(self.sched, out.flatten(0, 1).float(),
                                         x_t.flatten(0, 1), noise.flatten(0, 1),
                                         t_flat).view(k, b)

    def __call__(self, images, generator: Optional[torch.Generator] = None,
                 noise_batch: Optional[int] = None, global_batch: Optional[int] = None):
        """`noise_batch`: the batch size host noise is drawn at (the JAX CLI
        wrap-pads a ragged last batch to its first batch's size before the
        draw); None draws at this batch's size.

        `global_batch` (a sharded service's call, made on every rank): the
        images are this rank's rows [r*b, (r+1)*b) of a batch of that many
        spread over the process group. The noise is one draw at the global
        batch, of which this rank takes its rows (so every rank's generator
        must be seeded alike), and the scores come back gathered, (K,
        global_batch) on every rank. The preview and the error maps stay
        this rank's."""
        scope = absmax_over_processes() if self.sharded else contextlib.nullcontext()
        with scope:
            out = self._call(images, generator, noise_batch, global_batch)
        if global_batch is None:
            return out
        return out[:1] + tuple(pmesh.all_gather_rows(o, dim=1) for o in out[1:])

    def _call(self, images, generator, noise_batch, global_batch):
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        autocast = (torch.autocast(self.device.type, dtype=self.autocast_dtype)
                    if self.autocast_dtype is not None else contextlib.nullcontext())
        with torch.no_grad(), autocast:
            x = self._encode(images)
        shape, rows = (len(self.t_starts),) + tuple(x.shape), slice(None)
        if global_batch is not None:
            b, world = x.shape[0], pmesh.process_count()
            if b * world != int(global_batch):
                raise ValueError(f"{b} rows a rank over {world} processes is not a global batch "
                                 f"of {global_batch}")
            shape = shape[:1] + (int(global_batch),) + shape[2:]
            rows = slice(pmesh.process_index() * b, (pmesh.process_index() + 1) * b)
        # plms_ref draws its host noise at once, as the JAX program does
        noise_full = self._noise(shape, generator, noise_batch,
                                 prefetch=self.sampler != "plms_ref")[:, rows].contiguous()
        if self.sampler == "plms_ref":
            with torch.no_grad(), autocast:
                recon = plms_reference_exact_sweep(
                    self.sched, self._sample_model, x, noise_full, self.timesteps_desc,
                    self.t_starts, self.num_inference_steps, self.b_scale)
                mse, perc, self.last_preview, _, _ = self._score(images, recon)
            return self.t_starts, mse, perc
        sweep = SWEEPS[self.sampler]
        mses, percs, elbos, ssims, err_sum, offset = [], [], [], [], None, 0
        with torch.no_grad(), autocast:
            for ts_desc, t_starts in self._groups:
                k = t_starts.shape[0]
                noise = noise_full[offset: offset + k]
                recon = sweep(self.sched, self._model, x, noise, ts_desc, t_starts,
                              self.num_inference_steps, self.b_scale)
                offset += k
                mse, perc, preview, ssim_d, err = self._score(images, recon)
                mses.append(mse)
                percs.append(perc)
                ssims.append(ssim_d)
                if self.score_elbo:
                    elbos.append(self._elbo(x, noise, t_starts))
                if err is not None:  # lane sums, so the mean over groups is exact
                    err_sum = err if err_sum is None else err_sum + err
        self.last_preview = preview  # from the highest-start group
        if err_sum is not None:
            self.last_error_maps = err_sum / float(len(self.t_starts))
        out = (self.t_starts, torch.cat(mses), torch.cat(percs))
        if self.score_elbo:
            out += (torch.cat(elbos),)
        if self.score_ssim:
            out += (torch.cat(ssims),)
        return out
