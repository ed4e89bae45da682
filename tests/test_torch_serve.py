"""The port's online scoring service (ddpm_ood_tpu_torch/serve.py) on the CPU.

Parity with the JAX package's service: one tiny UNet at 16x16 (seeded JAX
params carried into the port by ``utils/convert.py``), a 10-step PLMS grid
with skip 3 in 2 lane groups, fp32, and one noise draw from a numpy seed
handed to both programs through ``host_noise_fn``. Both services read one
validation CSV written to tmp_path in the scoring CLI's format, with a
duplicate (filename, t) row and NaN cells: JAX through pandas and its
``dedup``, the port through ``ood.score.read_results_csv`` and its
``dedup``. Tolerances:
- per-t mse: rtol 1e-5 (the sweep's, tests/test_torch_plms_sweep.py);
- z-scores: 1e-5 x max mse / the smallest per-t std (an mse error of rtol
  1e-5 moves z by at most that much; the number is printed, ~3e-4 here);
- the per-t (mean, std + 1e-12) tables and the flag_fpr thresholds: rtol
  1e-12 (float64 on both sides; pandas sums with Kahan and Welford, numpy
  pairwise);
- is_ood / ood_flags: equal, except where a z lies within the z tolerance
  of its threshold; those are counted and must be at most one.

Then the single-device cases of the JAX package's tests/test_serve.py, with
the same assertions: served elbo and ssim, the oversize and mismatch
refusals, 413, concurrency, the HTTP round trip, the batching service's
coalescing, spill and error propagation, warmup (on the card it runs one
sweep instead of compiling: a warmed and an unwarmed service give equal
first-request scores), SIGTERM in a subprocess, flag_fpr, the drift
window, bearer auth, /metricz and a connection burst. The cases that only
exercise the HTTP layer and the batching run a program whose model is a
linear stand-in, so that each of their sweeps takes milliseconds. The two
shard cases of the JAX file (test_sharded_service_matches_unsharded and
test_warmup_with_shard_fn_precompiles_sharded_key) have their twins in
tests/test_torch_serve_sharded.py: the port's service sharded over the
ranks of a torchrun launch.
"""

import argparse
import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from ddpm_ood_tpu import serve as jserve
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.ood.score import dedup as jax_dedup
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch.diffusion import schedules
from ddpm_ood_tpu_torch.models.unet import make_unet
from ddpm_ood_tpu_torch.ood.score import dedup, read_results_csv
from ddpm_ood_tpu_torch.recon.sweep import ReconProgram
from ddpm_ood_tpu_torch.serve import (BatchingScoringService, ScoringService, make_handler,
                                      make_server, warmup_program)
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_unet import seeded_jax_params
from torch_recon_parity import SCHED_ARGS, linear_model_torch

SIZE = 16
MSE_RTOL = 1e-5
GRID = dict(num_inference_steps=10, inference_skip_factor=3, num_groups=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host_noise(shape, t_starts):
    return np.random.default_rng(5).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=3)
    model = make_unet("tiny", 2, 1, 1)
    model.load_state_dict(jax_unet_params_to_state_dict(params), strict=True)
    return unet, params, model.to(memory_format=torch.channels_last).eval()


def port_program(model_fn, **kw) -> ReconProgram:
    return ReconProgram(sched=schedules.make_schedule(*SCHED_ARGS), model_fn=model_fn,
                        **{**GRID, **kw})


@pytest.fixture(scope="module")
def program(weights):
    """The tiny UNet's program, Gaussian noise from the service's generator."""
    return port_program(weights[2])


@pytest.fixture(scope="module")
def fast_program():
    """The same grid over a linear stand-in for the UNet."""
    return port_program(linear_model_torch)


def _images(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(n, SIZE, SIZE, 1)).astype("float32")


def _val_stats(program):
    """4 validation rows per start point (the JAX test's table), as the
    port's table."""
    t = np.repeat(np.asarray(program.t_starts, np.int64), 4)
    return {"filename": np.array([f"v{i % 4}" for i in range(len(t))], dtype=object),
            "type": np.array(["val"] * len(t), dtype=object), "t": t,
            "mse": 0.1 + 0.01 * (np.arange(len(t)) % 4),
            "perceptual_difference": np.zeros(len(t))}


def _with(stats, **cols):
    return {**stats, **{k: v(np.arange(len(stats["t"]))) for k, v in cols.items()}}


@pytest.fixture(scope="module")
def service(program):
    return ScoringService(program, _val_stats(program), batch_size=4, model_name="tiny_test")


@pytest.fixture(scope="module")
def fast_service(fast_program):
    return ScoringService(fast_program, _val_stats(fast_program), batch_size=4,
                          model_name="tiny_test")


@contextlib.contextmanager
def running(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield server.server_port
    finally:
        server.shutdown()
        server.server_close()


def _plain_server(service, auth_token=None):
    """The plain stdlib server around the handler, as the JAX tests build it."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service, auth_token))


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


# ------------------------------------------------------------ JAX parity --
def _sine(n: int, rng) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(SIZE), np.arange(SIZE), indexing="ij")
    return np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (xx + yy) / SIZE + rng.uniform(0, 6.3))
                     for _ in range(n)])[..., None].astype(np.float32)


@pytest.fixture(scope="module")
def parity(weights, tmp_path_factory):
    """Both services on one validation CSV (scored by the port's program,
    then given a duplicate row and NaN cells) and one request: 2 smooth
    images and 2 checkerboards."""
    unet, params, model = weights
    rng = np.random.default_rng(0)
    prog = port_program(model, host_noise_fn=host_noise)
    rows = []
    for batch in range(2):
        t_starts, mse, perc = prog(_sine(4, rng))
        for k, t in enumerate(t_starts):
            for i in range(4):
                rows.append((f"val_{4 * batch + i}", "val", int(t), 0.02 + 0.01 * float(mse[k, i]),
                             float(mse[k, i])))
    rows[1] = rows[1][:4] + (float("nan"),)  # an empty mse cell
    rows[9] = rows[9][:3] + (float("nan"),) + rows[9][4:]  # an empty perceptual cell
    rows.append(rows[0][:4] + (rows[0][4] + 1.0,))  # a duplicate (filename, t): dropped
    csv = tmp_path_factory.mktemp("serve_parity") / "results_val.csv"
    pd.DataFrame(rows, columns=["filename", "type", "t", "perceptual_difference", "mse"]
                 ).to_csv(csv)

    yy, xx = np.meshgrid(np.arange(SIZE), np.arange(SIZE), indexing="ij")
    checker = np.stack([(xx + yy + i) % 2 for i in range(2)])[..., None].astype(np.float32)
    request = np.concatenate([_sine(2, rng), checker])

    jprog = jsweep.ReconProgram(
        sched=jsched.make_schedule(*SCHED_ARGS),
        model_fn=jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t), params),
        host_noise_fn=host_noise, latent_sample_shape=(SIZE, SIZE, 1),
        overlap_host_noise=False, **GRID)
    jsvc = jserve.ScoringService(jprog, jax_dedup(pd.read_csv(csv)), batch_size=4,
                                 model_name="t", flag_fpr=0.25)
    svc = ScoringService(port_program(model, host_noise_fn=host_noise),
                         dedup(read_results_csv(csv)), batch_size=4, model_name="t",
                         flag_fpr=0.25)
    return jsvc, jsvc.score(request), svc, svc.score(request)


def test_stats_tables_and_thresholds_match_jax(parity):
    jsvc, _, svc, _ = parity
    assert svc._stats.keys() == jsvc._stats.keys() == {"mse", "perceptual_difference"}
    for target, table in jsvc._stats.items():
        assert svc._stats[target].keys() == table.keys()
        for t, (mu, sd) in table.items():
            np.testing.assert_allclose(svc._stats[target][t], (mu, sd), rtol=1e-12, atol=0)
    assert svc.z_thresholds.keys() == jsvc.z_thresholds.keys()
    for target, thr in jsvc.z_thresholds.items():
        assert np.isfinite(thr)
        np.testing.assert_allclose(svc.z_thresholds[target], thr, rtol=1e-12, atol=0)


def test_scores_and_flags_match_jax(parity):
    jsvc, want, svc, got = parity
    assert len(got) == len(want) == 4
    max_mse = max(v["mse"] for r in want for v in r["per_t"].values())
    min_sd = min(sd for _, sd in jsvc._stats["mse"].values())
    z_tol = MSE_RTOL * max_mse / min_sd
    print(f"z tolerance {z_tol:.3e} = {MSE_RTOL} x max mse {max_mse:.4f} / min std {min_sd:.4e}")
    near = 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["per_t"].keys() == w["per_t"].keys()
        for t, vals in w["per_t"].items():
            np.testing.assert_allclose(g["per_t"][t]["mse"], vals["mse"], rtol=MSE_RTOL, atol=0)
            assert g["per_t"][t]["perceptual_difference"] == 0.0 == vals["perceptual_difference"]
        np.testing.assert_allclose(g["z_score_mse"], w["z_score_mse"], rtol=0, atol=z_tol)
        np.testing.assert_allclose(g["z_score_perceptual"], w["z_score_perceptual"], rtol=1e-9)
        for target, key in (("mse", "z_score_mse"), ("perceptual_difference",
                                                      "z_score_perceptual")):
            if abs(w[key] - jsvc.z_thresholds[target]) <= z_tol:
                near += 1
            else:
                assert g["ood_flags"][target] == w["ood_flags"][target]
        if abs(w["z_score_mse"] - jsvc.z_thresholds["mse"]) > z_tol:
            assert g["is_ood"] == w["is_ood"]
    assert near <= 1
    # the checkerboards score far above the smooth images, on both sides
    assert min(r["z_score_mse"] for r in got[2:]) > max(r["z_score_mse"] for r in got[:2])


# ------------------------------------------- the JAX package's service cases --
def test_score_shapes_and_fields(service, program):
    out = service.score(_images(0, 3))
    assert len(out) == 3
    for rec in out:
        assert np.isfinite(rec["z_score_mse"])
        assert np.isfinite(rec["z_score_perceptual"])
        assert set(rec["per_t"]) == {int(t) for t in program.t_starts}


def test_elbo_served_when_program_and_stats_have_it(program):
    """A score_elbo program + an elbo column in the val stats -> z_score_elbo
    per image; either one missing -> the field is absent (no crash)."""
    elbo_prog = port_program(program.model_fn, score_elbo=True)
    stats = _with(_val_stats(program), elbo=lambda i: 0.05 + 0.001 * (i % 4))
    svc = ScoringService(elbo_prog, stats, batch_size=4, model_name="t")
    imgs = _images(1, 2)
    out = svc.score(imgs)
    assert all(np.isfinite(r["z_score_elbo"]) for r in out)
    assert all("elbo" in v for r in out for v in r["per_t"].values())

    # program emits elbo but the val CSV predates the column: served without it
    out = ScoringService(elbo_prog, _val_stats(program), batch_size=4, model_name="t").score(imgs)
    assert all("z_score_elbo" not in r for r in out)
    assert np.isfinite(out[0]["z_score_mse"])


def test_ssim_served_beside_elbo(program):
    """score_ssim rides after elbo in the program outputs; the service serves
    z_score_ssim when the val stats carry ssim_distance, and indexes the
    extras correctly whether or not elbo is also enabled."""
    both_prog = port_program(program.model_fn, score_elbo=True, score_ssim=True)
    stats = _with(_val_stats(program), elbo=lambda i: 0.05 + 0.001 * (i % 4),
                  ssim_distance=lambda i: 0.2 + 0.01 * (i % 4))
    imgs = _images(2, 2)
    out = ScoringService(both_prog, stats, batch_size=4, model_name="t").score(imgs)
    assert all(np.isfinite(r["z_score_ssim"]) for r in out)
    assert all(np.isfinite(r["z_score_elbo"]) for r in out)
    assert all("ssim_distance" in v for r in out for v in r["per_t"].values())

    # ssim only (no elbo): the ssim array sits right after perceptual
    ssim_prog = port_program(program.model_fn, score_ssim=True)
    stats2 = _with(_val_stats(program), ssim_distance=lambda i: 0.2 + 0.01 * (i % 4))
    out2 = ScoringService(ssim_prog, stats2, batch_size=4, model_name="t").score(imgs)
    assert all(np.isfinite(r["z_score_ssim"]) for r in out2)
    assert all("z_score_elbo" not in r for r in out2)
    # same ssim values through both programs (each service's generator starts
    # at the same seed)
    np.testing.assert_allclose([r["z_score_ssim"] for r in out2],
                               [r["z_score_ssim"] for r in out], rtol=1e-5)

    # program emits ssim but the val CSV lacks the column: served without it
    out3 = ScoringService(ssim_prog, _val_stats(program), batch_size=4,
                          model_name="t").score(imgs)
    assert all("z_score_ssim" not in r for r in out3)


def test_oversize_batch_rejected(fast_service):
    with pytest.raises(ValueError, match="batch"):
        fast_service.score(np.zeros((5, SIZE, SIZE, 1), "float32"))


def test_stats_mismatch_rejected(fast_program):
    stats = _val_stats(fast_program)
    bad = {k: v[stats["t"] != int(fast_program.t_starts[0])] for k, v in stats.items()}
    with pytest.raises(ValueError, match="start points"):
        ScoringService(fast_program, bad, batch_size=2)


def test_single_row_val_stats_rejected(fast_program):
    """One validation row for a t_start makes the sample std (ddof=1) NaN:
    the service refuses at construction instead of serving NaN z-scores."""
    stats = _val_stats(fast_program)
    t0 = int(fast_program.t_starts[0])
    keep = (stats["t"] != t0) | (np.arange(len(stats["t"])) == int(np.argmax(stats["t"] == t0)))
    thin = {k: v[keep] for k, v in stats.items()}
    with pytest.raises(ValueError, match="fewer than 2 rows"):
        ScoringService(fast_program, thin, batch_size=2)


def test_oversized_content_length_rejected_413(fast_service):
    """A Content-Length above the service cap is refused BEFORE the body is
    buffered into host memory."""
    with running(make_server(fast_service, "127.0.0.1", 0)) as port:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/score", data=b"x")
        req.add_unredirected_header("Content-Length", str(fast_service.max_body_bytes + 1))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 413
        assert "exceeds cap" in json.loads(e.value.read())["error"]


def test_concurrent_requests_serialize_safely(fast_service):
    """Parallel callers share one program behind the service lock; both
    complete with valid, independent results."""
    imgs = _images(2, 2)
    results = [None, None]

    def worker(i):
        results[i] = fast_service.score(imgs)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for r in results:
        assert r is not None and len(r) == 2
        assert all(np.isfinite(rec["z_score_mse"]) for rec in r)


def test_http_round_trip(fast_service):
    with running(make_server(fast_service, "127.0.0.1", 0)) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["model"] == "tiny_test"
        assert health["batch_size"] == 4
        assert health["t_starts"] == [int(t) for t in fast_service.program.t_starts]

        req = urllib.request.Request(f"http://127.0.0.1:{port}/score", data=_npy(_images(1, 2)))
        with urllib.request.urlopen(req) as r:
            payload = json.loads(r.read())
        assert len(payload["scores"]) == 2
        assert all(np.isfinite(s["z_score_mse"]) for s in payload["scores"])

        # malformed body -> 400, named error
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/score", data=b"junk")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400

        # unknown path -> 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
        assert e.value.code == 404

        # /reload without a hook -> 409 (the fixture service has none)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/reload", data=b"", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 409

        # ops counters: the one successful POST above scored 2 images in 1 sweep
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statz") as r:
            stats = json.loads(r.read())
        assert stats["sweeps"] >= 1 and stats["images"] >= 2
        assert stats["requests"] >= 1
        assert stats["device_seconds"] > 0
        assert stats["mean_sweep_seconds"] > 0


# ---------------------------------------------------------- dynamic batching --
def _deterministic_program(program):
    """The same program with zero host noise: per-image scores become a pure
    function of the image, independent of batching and wrap-padding."""
    return port_program(program.model_fn,
                        host_noise_fn=lambda shape, t_starts: np.zeros(shape, np.float32),
                        latent_sample_shape=(SIZE, SIZE, 1))


def _counted(inner):
    calls = []
    orig = inner.score
    inner.score = lambda imgs: (calls.append(imgs.shape[0]), orig(imgs))[1]
    return calls, orig


def test_batching_coalesces_concurrent_requests(fast_program):
    inner = ScoringService(_deterministic_program(fast_program), _val_stats(fast_program),
                           batch_size=4, model_name="t")
    calls, orig = _counted(inner)
    svc = BatchingScoringService(inner, batch_window_ms=500.0)
    try:
        imgs = _images(2, 4)
        results = [None] * 4
        errors = []

        def submit(i):
            try:
                results[i] = svc.score(imgs[i: i + 1])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        assert all(r is not None and len(r) == 1 for r in results)
        # 4 one-image requests inside a 500 ms window: coalesced, not 4 sweeps
        assert len(calls) <= 2, calls
        assert sum(calls) == 4

        # scores identical to solo scoring (deterministic zero noise)
        solo = orig(imgs[:1])
        assert results[0][0]["z_score_mse"] == pytest.approx(solo[0]["z_score_mse"], rel=1e-6)
    finally:
        svc.close()


def test_batching_rejects_oversize_and_propagates_errors(fast_program):
    inner = ScoringService(_deterministic_program(fast_program), _val_stats(fast_program),
                           batch_size=4, model_name="t")
    svc = BatchingScoringService(inner, batch_window_ms=10.0)
    try:
        with pytest.raises(ValueError, match="batch"):
            svc.score(np.zeros((5, SIZE, SIZE, 1), "float32"))
        assert svc.score(np.zeros((0, SIZE, SIZE, 1), "float32")) == []

        # an inner failure reaches every waiting caller instead of hanging them
        def boom(imgs):
            raise RuntimeError("device fell over")

        inner.score = boom
        with pytest.raises(RuntimeError, match="device fell over"):
            svc.score(np.zeros((1, SIZE, SIZE, 1), "float32"))
    finally:
        svc.close()


def test_batching_spills_requests_beyond_capacity(fast_program):
    """5 x 1-image requests at batch_size 4: the 5th rides a SECOND sweep and
    still completes."""
    inner = ScoringService(_deterministic_program(fast_program), _val_stats(fast_program),
                           batch_size=4, model_name="t")
    calls, _ = _counted(inner)
    svc = BatchingScoringService(inner, batch_window_ms=300.0)
    try:
        imgs = _images(3, 5)
        results = [None] * 5
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, svc.score(imgs[i: i + 1])))
            for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None and len(r) == 1 for r in results)
        assert sum(calls) == 5
    finally:
        svc.close()


def test_warmup_program_runs_the_service_geometry(program):
    """Warmup runs one sweep on the serving geometry without touching the
    service's noise: a warmed service's first scores equal an unwarmed
    one's. An roi-shaped geometry warms too; an underivable one returns -1."""
    args = argparse.Namespace(image_size=SIZE, spatial_dimension=2, is_grayscale=1)
    imgs = _images(4, 3)
    cold = ScoringService(program, _val_stats(program), batch_size=4).score(imgs)
    warmed = ScoringService(program, _val_stats(program), batch_size=4)
    evals = program.model_evals
    assert warmup_program(program, args, batch_size=4) >= 0
    assert program.model_evals == evals  # served sweeps only on the program's counter
    for a, b in zip(cold, warmed.score(imgs)):
        assert a["z_score_mse"] == b["z_score_mse"]
        assert a["per_t"] == b["per_t"]
    fast = port_program(linear_model_torch)
    args_roi = argparse.Namespace(image_size=None, image_roi=(8, 8), is_grayscale=1)
    assert warmup_program(fast, args_roi, 2) >= 0
    args_none = argparse.Namespace(image_size=None, image_roi=None)
    assert warmup_program(fast, args_none, 2) == -1.0


def test_sigterm_graceful_shutdown():
    """serve_forever exits cleanly on SIGTERM (the rolling-restart contract)."""
    import os
    import signal
    import subprocess
    import sys
    import time

    code = ("from ddpm_ood_tpu_torch.serve import serve_forever\n"
            "class S: model_name = 'sigterm_test'\n"
            "serve_forever(S(), host='127.0.0.1', port=0)\n"
            "print('CLEAN-EXIT')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    try:
        line = proc.stdout.readline()  # only then is the handler registered
        assert "serving OOD scores" in line, line
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "CLEAN-EXIT" in out and "shutting down" in out


def test_flag_fpr_decisions_and_drift_stat(fast_program):
    """--flag_fpr: thresholds are the (1-fpr) quantile of the validation
    per-image mean-z distribution; responses carry is_ood/ood_flags; /statz
    reports the drift mean and the threshold table."""
    stats = _val_stats(fast_program)
    svc = ScoringService(_deterministic_program(fast_program), stats, batch_size=4,
                         model_name="t", flag_fpr=0.25)
    # the validation mean-z distribution by hand, with pandas
    df = pd.DataFrame(stats)
    mu = df.groupby("t")["mse"].mean()
    sd = df.groupby("t")["mse"].std() + 1e-12
    z = (df["mse"] - df["t"].map(mu)) / df["t"].map(sd)
    expect = float(np.quantile(z.groupby(df["filename"]).mean().to_numpy(), 0.75))
    assert svc.z_thresholds["mse"] == pytest.approx(expect)

    out = svc.score(_images(5, 3))
    for rec in out:
        assert rec["is_ood"] == (rec["z_score_mse"] > svc.z_thresholds["mse"])
        assert set(rec["ood_flags"]) == {"mse", "perceptual_difference"}
        assert isinstance(rec["is_ood"], bool)

    with running(make_server(svc, "127.0.0.1", 0)) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statz") as resp:
            s = json.loads(resp.read())
    want = float(np.mean([r["z_score_mse"] for r in out]))
    assert s["mean_served_z_mse"] == pytest.approx(want, rel=1e-6)
    assert s["flag_fpr"] == pytest.approx(0.25)
    assert s["z_thresholds"]["mse"] == pytest.approx(expect)
    assert "z_mse_sum" not in s


def test_flag_fpr_out_of_range_rejected(fast_program):
    with pytest.raises(ValueError, match="flag_fpr"):
        ScoringService(fast_program, _val_stats(fast_program), batch_size=4, model_name="t",
                       flag_fpr=1.5)


def test_drift_window_forgets_old_traffic(fast_program):
    """/statz mean_served_z_mse is a WINDOWED mean: once the ring (drift_window
    images) turns over, earlier traffic no longer counts; the lifetime mean,
    also reported, still does."""
    svc = ScoringService(_deterministic_program(fast_program), _val_stats(fast_program),
                         batch_size=4, model_name="t", drift_window=4)
    rng = np.random.default_rng(7)
    old = svc.score(rng.uniform(size=(4, SIZE, SIZE, 1)).astype("float32"))
    new = svc.score(rng.uniform(size=(4, SIZE, SIZE, 1)).astype("float32"))
    old_z = [r["z_score_mse"] for r in old]
    new_z = [r["z_score_mse"] for r in new]
    assert np.mean(old_z) != pytest.approx(np.mean(new_z))  # task sanity

    with running(make_server(svc, "127.0.0.1", 0)) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statz") as resp:
            s = json.loads(resp.read())
    # window = 4: only the NEW batch remains
    assert s["mean_served_z_mse"] == pytest.approx(np.mean(new_z), rel=1e-6)
    assert s["drift_window"] == 4 and s["drift_window_filled"] == 4
    assert s["lifetime_mean_z_mse"] == pytest.approx(np.mean(old_z + new_z), rel=1e-6)


def test_drift_window_must_be_positive(fast_program):
    with pytest.raises(ValueError, match="drift_window"):
        ScoringService(fast_program, _val_stats(fast_program), batch_size=4, model_name="t",
                       drift_window=0)


def test_bearer_token_auth(fast_service):
    """With auth_token set: /healthz stays open (load-balancer probes); every
    other endpoint requires `Authorization: Bearer <token>` and 401s otherwise."""
    server = make_server(fast_service, "127.0.0.1", 0, auth_token="sekrit")
    with running(server) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert json.loads(r.read())["status"] == "ok"

        for path, data in (("/statz", None), ("/score", b"x"), ("/reload", b"")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data))
            assert e.value.code == 401, path
            assert "bearer" in e.value.read().decode().lower()

        wrong = urllib.request.Request(f"http://127.0.0.1:{port}/statz",
                                       headers={"Authorization": "Bearer nope"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(wrong)
        assert e.value.code == 401

        ok = urllib.request.Request(f"http://127.0.0.1:{port}/statz",
                                    headers={"Authorization": "Bearer sekrit"})
        with urllib.request.urlopen(ok) as r:
            assert "mean_served_z_mse" in json.loads(r.read())

        scored = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                        data=_npy(_images(3, 2)),
                                        headers={"Authorization": "Bearer sekrit"})
        with urllib.request.urlopen(scored) as r:
            assert len(json.loads(r.read())["scores"]) == 2


def test_metricz_prometheus_exposition(fast_program):
    """GET /metricz serves the ops stats in Prometheus text format (0.0.4):
    TYPE lines, counter/gauge values, and labeled z-threshold gauges."""
    svc = ScoringService(_deterministic_program(fast_program), _val_stats(fast_program),
                         batch_size=4, model_name="t", flag_fpr=0.25)
    svc.score(_images(9, 2))
    with running(_plain_server(svc)) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metricz") as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
    lines = text.strip().splitlines()
    metrics = {}
    for ln in lines:
        if ln.startswith("#"):
            continue
        name, value = ln.rsplit(" ", 1)
        metrics[name] = float(value)
    assert metrics["ddpm_ood_images_total"] == 2.0
    assert metrics["ddpm_ood_sweeps_total"] == 1.0
    assert metrics["ddpm_ood_device_seconds_total"] > 0
    assert "ddpm_ood_mean_served_z_mse" in metrics
    # labeled threshold gauges (flag_fpr set on this service)
    assert any(k.startswith('ddpm_ood_z_threshold{target="mse"}') for k in metrics)
    # every sample has a TYPE declaration, and the names are the JAX package's
    for ln in lines:
        if ln.startswith("#"):
            assert ln.startswith("# TYPE ddpm_ood_")
    assert [ln for ln in lines if ln.startswith("#")] == [
        ln for ln in jserve.prometheus_text(svc).strip().splitlines() if ln.startswith("#")]


def test_metricz_requires_auth_when_token_set(fast_service):
    with running(_plain_server(fast_service, auth_token="sekrit")) as port:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/metricz")
        assert e.value.code == 401
        ok = urllib.request.Request(f"http://127.0.0.1:{port}/metricz",
                                    headers={"Authorization": "Bearer sekrit"})
        with urllib.request.urlopen(ok) as r:
            assert b"ddpm_ood_requests_total" in r.read()


def test_connection_burst_all_succeed(fast_service):
    """A burst of concurrent single-image clients must ALL be served: the
    stdlib default accept backlog of 5 resets overflowed connections, and
    make_server deepens it."""
    server = make_server(fast_service, "127.0.0.1", 0)
    assert type(server).request_queue_size >= 64
    n = 24
    results = [None] * n

    with running(server) as port:
        def one(i):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                         data=_npy(_images(i, 1)))
            with urllib.request.urlopen(req) as r:
                results[i] = json.loads(r.read())

        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert all(r is not None and len(r["scores"]) == 1 for r in results), \
        f"{sum(r is None for r in results)}/{n} requests dropped"
