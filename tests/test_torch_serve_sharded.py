"""The port's scoring service sharded over 2 gloo processes on the CPU: the
twins of tests/test_serve.py::test_sharded_service_matches_unsharded and
::test_warmup_with_shard_fn_precompiles_sharded_key, and the serve CLI
under ``python -m torch.distributed.run --nproc_per_node=2``.

The library service runs in 2 ranks of ``tests/torch_ddp_worker.py``
(``serve`` mode): rank 0 scores, the other rank follows it. The tiny UNet
(seeded JAX params carried across by the converter) at 16x16, PLMS 10/3 in
2 lane groups, fp32. Tolerances:
- against JAX's unsharded service on the same request (5 images, batch 8)
  and noise (one host draw at the batch, handed to both packages): per-t
  mse at rtol 1e-4 / atol 1e-6 and z_score_mse at rtol 1e-4 / atol 1e-5,
  JAX's own test's;
- against the port's one-process service with the same seed or host draw:
  per-t mse at rtol 1e-5 (each rank sweeps its rows of the batch with its
  rows of one global draw; the CPU's fp32 matmul of the time embedding
  depends on the row count in the last bit), z-scores at rtol 1e-5 / atol
  1e-4; under int8 the median relative difference of the per-t mse below
  1e-2, since a last-bit difference can flip a code at a .5 tie (~1e-3 on a
  sweep, compounding; tests/test_torch_sharded_sweep.py holds the int8
  sweep to JAX's at 1e-5 with the ties fed). The int8 scale itself is held
  exactly: every quantised call on both ranks took the larger of the two
  ranks' own max |x|.

Cases: host noise; the service's generator with and without a warmup
sweep (a warmed and an unwarmed service give equal first-request scores);
a batch of 5 over 2 ranks (wrap-padded to 6, with JAX's one-time note,
scored as one process's batch of 6, between requests an idle spell that
the keepalive covers, then a request of 2 channels that rank 0 refuses
before the other rank sees it, then a good one that both ranks sweep);
``--quantize=int8`` (every activation absmax over both ranks) at batch 4
over a full batch, one image, a hot reload that reaches both ranks (the
reload hook runs on rank 0 only; rank 1 takes its weights), and a full
batch again.

The CLI under torchrun (gloo, ``--device=cpu``): POST /score equals the
library's one-process service built here from the same flags (rtol 1e-5:
the processes' thread counts), a request of 3 channels gets 400 and the
service goes on, POST /reload reaches both ranks (the next scores equal
the one-process service's after its own reload), /healthz and /statz
report world_size 2, and SIGTERM to both ranks (as torchrun forwards it)
exits 0 on both: torchrun itself exits 0.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from ddpm_ood_tpu import serve as jserve
from ddpm_ood_tpu.diffusion import schedules as jsched
from ddpm_ood_tpu.models.unet import make_unet as jax_make_unet
from ddpm_ood_tpu.recon import sweep as jsweep
from ddpm_ood_tpu_torch import serve
from ddpm_ood_tpu_torch.config import parse_args_serve
from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from ddpm_ood_tpu_torch.utils.convert import jax_unet_params_to_state_dict
from test_torch_unet import seeded_jax_params
from torch_ddp_worker import REPO, finish, results, run_serve_case, serve_cases, start

SIZE = 16
T_STARTS = pndm_start_points(pndm_timesteps(1000, 10), 3)
CASES = ("host", "cold", "warm", "odd", "int8")
# the port's 2 ranks against its one process: the CPU's fp32 matmul (the
# time embedding) depends on the row count in the last bit
RTOL = 1e-5
# under int8 a last-bit difference can flip a code at a .5 tie, which moves
# a sweep by ~1e-3 (tests/test_torch_quant_cli.py), and the flips compound
# over the sweep: the median relative difference of the per-t mse is held;
# the scale itself is held exactly by test_int8_absmax_spans_both_ranks
INT8_MEDIAN_REL = 1e-2


def _val_stats() -> dict:
    """tests/test_torch_serve.py's table: 4 validation rows a start point."""
    t = np.repeat(np.asarray(T_STARTS, np.int64), 4)
    return {"filename": np.array([f"v{i % 4}" for i in range(len(t))], dtype=object),
            "type": np.array(["val"] * len(t), dtype=object), "t": t,
            "mse": 0.1 + 0.01 * (np.arange(len(t)) % 4),
            "perceptual_difference": np.zeros(len(t))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _http(port, path, data=None) -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _children(pid: int) -> list:
    """The processes whose parent is `pid` (from /proc)."""
    kids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(d.name))
    return kids


def _cli_run(root: Path) -> list:
    """A seeded tiny checkpoint and a results_val.csv at the grid; the
    serve CLI's flags (batch 4: 2 rows a rank)."""
    run_dir = root / "output" / "sharded_cli"
    (run_dir / "ood").mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(run_dir / "checkpoint.pth", model.state_dict())
    lines = [",filename,type,t,perceptual_difference,mse"]
    for t in T_STARTS:
        for i in range(4):
            lines.append(f"{len(lines) - 1},v{i},val,{int(t)},{0.02 + 0.01 * i},{0.1 + 0.01 * i}")
    (run_dir / "ood" / "results_val.csv").write_text("\n".join(lines) + "\n")
    return ["--device=cpu", f"--output_dir={root / 'output'}", "--model_name=sharded_cli",
            "--model_type=tiny", "--is_grayscale=1", f"--image_size={SIZE}",
            "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195",
            "--num_inference_steps=10", "--inference_skip_factor=3", "--batch_size=4",
            "--recon_groups=2", "--host=127.0.0.1"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The 2-rank library services and the 2-rank CLI, started at once;
    the references computed here while they run."""
    root = tmp_path_factory.mktemp("serve_sharded")
    unet = jax_make_unet("tiny", 2, 1, 1)
    params = seeded_jax_params(unet, seed=3)
    images = np.random.default_rng(7).uniform(size=(8, SIZE, SIZE, 1)).astype(np.float32)
    inp = dict(state=jax_unet_params_to_state_dict(params), stats=_val_stats(), images=images,
               state2=random_init_(make_unet("tiny", 2, 1, 1),
                                   torch.Generator().manual_seed(1)).state_dict())
    torch.save(inp, root / "in.pt")
    ranks = start("serve", root / "in.pt", root)
    argv = _cli_run(root)
    port = _free_port()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "ddpm_ood_tpu_torch.serve", *argv, f"--port={port}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1"),
        start_new_session=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(cli.stdout), daemon=True).start()
    try:  # the CLI is killed however the set-up or the tests end
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            # JAX's unsharded service on the host case's request and draw
            jprog = jsweep.ReconProgram(
                sched=jsched.make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195),
                model_fn=jax.tree_util.Partial(lambda p, x, t: unet.apply({"params": p}, x, t),
                                               params),
                num_inference_steps=10, inference_skip_factor=3, num_groups=2,
                host_noise_fn=lambda shape, t: np.random.default_rng(5).standard_normal(
                    shape).astype(np.float32),
                latent_sample_shape=(SIZE, SIZE, 1), overlap_host_noise=False)
            jsvc = jserve.ScoringService(jprog, pd.DataFrame(_val_stats()), batch_size=8,
                                         model_name="t")
            with ThreadPoolExecutor(1) as pool:  # XLA compiles beside the port's sweeps
                jax_host = pool.submit(jsvc.score, images[:5])
                one = {name: run_serve_case(svc, calls)
                       for name, svc, calls in serve_cases(inp, sharded=False)}
                jax_host = jax_host.result()
        finally:
            torch.set_num_threads(n)
        out = finish(ranks)
        yield dict(ranks=results(root), jax_host=jax_host, one=one, out=out, cli=cli,
                   cli_lines=lines, cli_argv=argv, port=port, root=root)
    finally:
        if cli.poll() is None:  # torchrun starts each rank in a session of its own
            for pid in _children(cli.pid):
                os.kill(pid, signal.SIGKILL)
            os.killpg(cli.pid, signal.SIGKILL)


def test_sharded_service_matches_unsharded(launched):
    """JAX's plain service against the port's 2-rank service, same draw."""
    got, want = launched["ranks"][0]["host"][0], launched["jax_host"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["z_score_mse"], w["z_score_mse"], rtol=1e-4, atol=1e-5)
        assert g["per_t"].keys() == {int(t) for t in w["per_t"]}
        for t in w["per_t"]:
            np.testing.assert_allclose(g["per_t"][int(t)]["mse"], w["per_t"][t]["mse"],
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_sharded_service_matches_one_process(launched, case):
    # the responses, without a refused request's message
    got, want = ([r for r in reqs if not isinstance(r, str)]
                 for reqs in (launched["ranks"][0][case], launched["one"][case]))
    assert len(got) == len(want) > 0
    rel = []
    for g_req, w_req in zip(got, want):
        assert len(g_req) == len(w_req)
        for g, w in zip(g_req, w_req):
            assert g["per_t"].keys() == w["per_t"].keys()
            rel += [abs(g["per_t"][t]["mse"] - v["mse"]) / v["mse"] for t, v in w["per_t"].items()]
            if case != "int8":
                np.testing.assert_allclose(g["z_score_mse"], w["z_score_mse"], rtol=RTOL,
                                           atol=10 * RTOL)
    if case == "int8":
        print(f"int8 per-t mse, 2 ranks against 1: median relative difference "
              f"{np.median(rel):.2e}, max {max(rel):.2e}")
        assert np.median(rel) < INT8_MEDIAN_REL
    else:
        assert max(rel) <= RTOL
    for r, rank in enumerate(launched["ranks"]):
        assert rank[f"{case}_stats"]["world"] == 2
        assert rank[f"{case}_stats"]["sweeps"] == len(want), r


def test_int8_absmax_spans_both_ranks(launched):
    """Every quantised call of the served int8 sweeps (the warmup's
    included) took the larger of the two ranks' own max |x|."""
    a, b = (r["int8_stats"]["absmax"] for r in launched["ranks"])
    assert len(a) == len(b) > 0
    for (local_a, got_a), (local_b, got_b) in zip(a, b):
        assert got_a == got_b == max(local_a, local_b)


def test_warmup_with_sharded_program_gives_the_first_request_scores(launched):
    """The twin of test_warmup_with_shard_fn_precompiles_sharded_key: a
    warmed sharded service (one sweep on every rank at the shard geometry,
    a throwaway generator) scores its first request as an unwarmed one."""
    assert launched["ranks"][0]["warm"] == launched["ranks"][0]["cold"]


def test_batch_the_ranks_do_not_divide_is_wrap_padded(launched):
    assert len(launched["ranks"][0]["odd"][1]) == 3
    assert launched["out"].count("serve: batch_size 5 not divisible by 2 processes") == 1


def test_request_of_another_shape_is_refused_before_the_other_ranks(launched):
    """Rank 0 refuses a 2-channel request (ValueError, the CLI's 400) as the
    one-process service does; the other rank never sweeps it, and the next
    request is scored on both ranks."""
    refused, one_refused = launched["ranks"][0]["odd"][0], launched["one"]["odd"][0]
    assert refused == one_refused == "images of shape (16, 16, 2): the service scores (16, 16, 1)"
    for rank in launched["ranks"]:
        assert rank["odd_stats"]["sweeps"] == 1


def test_int8_reload_reaches_every_rank(launched):
    first, one_image, reloaded = launched["ranks"][0]["int8"]
    assert (len(first), len(one_image), len(reloaded)) == (4, 1, 4)
    assert all(np.isfinite(r["z_score_mse"]) for r in first + one_image + reloaded)
    assert first != reloaded
    for rank in launched["ranks"]:
        assert rank["int8_stats"]["reloads"] == 1
    # rank 1 serves the weights rank 0 read, not its initial ones
    after = {rank["int8_stats"]["weights"] for rank in launched["ranks"]}
    assert len(after) == 1 and after != {launched["ranks"][1]["cold_stats"]["weights"]}


def test_serve_cli_under_torchrun(launched):
    cli, lines, port = launched["cli"], launched["cli_lines"], launched["port"]
    t0 = time.time()
    while not any("serving OOD scores for sharded_cli on 127.0.0.1:" in ln for ln in lines):
        assert cli.poll() is None, "".join(lines)
        assert time.time() - t0 < 300, "".join(lines)
        time.sleep(0.1)
    images = np.random.default_rng(3).uniform(size=(3, SIZE, SIZE, 1)).astype("float32")
    assert _http(port, "/healthz")[1]["world_size"] == 2
    with pytest.raises(urllib.error.HTTPError) as bad:  # 3 channels, rank 0 only
        _http(port, "/score", _npy(np.repeat(images, 3, axis=-1)))
    assert bad.value.code == 400
    status, served = _http(port, "/score", _npy(images))
    assert status == 200 and len(served["scores"]) == 3

    ckpt = Path(launched["cli_argv"][1].split("=", 1)[1]) / "sharded_cli" / "checkpoint.pth"
    library = serve.build_service(parse_args_serve(launched["cli_argv"]))
    want = library.score(images)
    save_checkpoint(ckpt, random_init_(make_unet("tiny", 2, 1, 1),
                                       torch.Generator().manual_seed(1)).state_dict())
    status, body = _http(port, "/reload", b"")
    assert status == 200 and body["reloaded_from"] == str(ckpt)
    _, reloaded = _http(port, "/score", _npy(images))
    library.reload()
    want_reloaded = library.score(images)
    for got, ref in zip(served["scores"] + reloaded["scores"], want + want_reloaded):
        for t, vals in ref["per_t"].items():
            np.testing.assert_allclose(got["per_t"][str(t)]["mse"], vals["mse"], rtol=1e-5)
        np.testing.assert_allclose(got["z_score_mse"], ref["z_score_mse"], rtol=1e-5)
    assert served["scores"][0]["z_score_mse"] != reloaded["scores"][0]["z_score_mse"]
    stats = _http(port, "/statz")[1]
    assert (stats["world_size"], stats["sweeps"], stats["reloads"]) == (2, 2, 1)

    ranks = _children(cli.pid)
    assert len(ranks) == 2, ranks
    for pid in ranks:  # as torchrun forwards SIGTERM: every rank at once
        os.kill(pid, signal.SIGTERM)
    assert cli.wait(timeout=120) == 0, "".join(lines)
    text = "".join(lines)
    assert "draining in-flight requests and shutting down" in text
    assert "waiting for rank 0 to stop" in text
