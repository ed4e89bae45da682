"""The port's serve and sample parsers, and ``python -m ddpm_ood_tpu_torch.serve``
end to end on the CPU.

Parser parity: ``config.parse_args_serve`` and ``parse_args_sample`` hold
every flag of the JAX package's ``scripts/serve.py`` and
``scripts/sample.py`` (both import no JAX at module level) with the same
option strings, defaults, choices and requiredness. The only differences:
``--device`` (default cuda) besides, and ``--image_roi`` / ``--latent_pad``
parsed by ast.literal_eval where the scripts keep raw strings.

The CLI in a subprocess (``--device=cpu``) on a seeded tiny checkpoint and
a hand-built results_val.csv at the serving grid: it warms up and serves;
POST /score equals the library service built in this process from the same
flags (both first sweeps draw from a fresh generator; rtol 1e-5 for the
two processes' CPU thread counts); POST /reload picks up a newer
checkpoint and the scores change; SIGTERM while a POST /score is in flight
completes that response with 200 and exits 0. --aot_cache raises
NotImplementedError naming the flag, a missing checkpoint
FileNotFoundError, --device=cuda without a card RuntimeError, and a
WORLD_SIZE above 1 without torchrun's rendezvous environment RuntimeError
(the service under torchrun: tests/test_torch_serve_sharded.py).
"""

import argparse
import ast
import importlib.util
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch import serve
from ddpm_ood_tpu_torch.config import parse_args_sample, parse_args_serve
from ddpm_ood_tpu_torch.diffusion.plms import pndm_start_points, pndm_timesteps
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
SIZE, STEPS, SKIP = 16, 10, 3
REQUIRED = ["--output_dir=o", "--model_name=m"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _actions(parse_args, argv) -> dict:
    """dest -> argparse action of the parser `parse_args` builds."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen["parser"] = self
        return orig(self, args, namespace)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", spy):
        parse_args(argv)
    return {a.dest: a for a in seen["parser"]._actions if a.dest != "help"}


@pytest.mark.parametrize("script,port_parser", [("serve", parse_args_serve),
                                                ("sample", parse_args_sample)])
def test_parser_matches_the_jax_script(script, port_parser):
    want = _actions(_script(script).parse_args, REQUIRED)
    got = _actions(port_parser, REQUIRED)
    assert set(got) == set(want) | {"device"}
    assert got["device"].default == "cuda"
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.choices, b.required, b.nargs) == \
            (a.option_strings, a.default, a.choices, a.required, a.nargs), dest
        if dest in ("image_roi", "latent_pad"):
            assert a.type is None and b.type is ast.literal_eval
        else:
            assert b.type is a.type, dest
    args = port_parser(REQUIRED + ["--image_roi=[8,8]", "--latent_pad=(1,1,2,2)",
                                   "--eval_checkpoint=3"])
    assert args.image_roi == [8, 8] and args.latent_pad == (1, 1, 2, 2)
    assert args.ddpm_checkpoint_epoch == "3"  # the alias, as in the scripts


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory) -> list:
    """A seeded tiny checkpoint.pth and a results_val.csv at the serving
    grid; returns the serve CLI's flags."""
    root = tmp_path_factory.mktemp("serve_cli")
    run_dir = root / "output" / "serve_cli_run"
    (run_dir / "ood").mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(run_dir / "checkpoint.pth", model.state_dict())
    lines = [",filename,type,t,perceptual_difference,mse"]
    for t in pndm_start_points(pndm_timesteps(1000, STEPS), SKIP):
        for i in range(4):
            lines.append(f"{len(lines) - 1},v{i},val,{int(t)},{0.02 + 0.01 * i},{0.1 + 0.01 * i}")
    (run_dir / "ood" / "results_val.csv").write_text("\n".join(lines) + "\n")
    return ["--device=cpu", f"--output_dir={root / 'output'}", "--model_name=serve_cli_run",
            "--model_type=tiny", "--is_grayscale=1", f"--image_size={SIZE}",
            "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015", "--beta_end=0.0195",
            f"--num_inference_steps={STEPS}", f"--inference_skip_factor={SKIP}",
            "--batch_size=2", "--recon_groups=2", "--host=127.0.0.1"]


def _wait_for(lines, proc, needle, timeout=240):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if any(needle in ln for ln in lines):
            return
        if proc.poll() is not None:
            raise AssertionError(f"serve exited rc={proc.returncode} before {needle!r}:\n"
                                 + "".join(lines))
        time.sleep(0.1)
    raise AssertionError(f"timeout waiting for {needle!r}:\n" + "".join(lines))


def _post(port, path, data) -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_serve_cli_end_to_end(run):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddpm_ood_tpu_torch.serve", *run, f"--port={port}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1"))
    lines = []
    threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True).start()
    images = np.random.default_rng(3).uniform(size=(2, SIZE, SIZE, 1)).astype("float32")
    try:
        _wait_for(lines, proc, "serving OOD scores for serve_cli_run on 127.0.0.1:")
        assert any(ln.startswith("warm: ran 2 lane groups in ") for ln in lines), lines
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert json.loads(r.read())["batch_size"] == 2
        status, served = _post(port, "/score", _npy(images))
        assert status == 200

        library = serve.build_service(parse_args_serve(run))
        want = library.score(images)
        for got, ref in zip(served["scores"], want):
            assert got["per_t"].keys() == {str(t) for t in ref["per_t"]}  # JSON keys
            for t, vals in ref["per_t"].items():
                np.testing.assert_allclose(got["per_t"][str(t)]["mse"], vals["mse"], rtol=1e-5)
            np.testing.assert_allclose(got["z_score_mse"], ref["z_score_mse"], rtol=1e-4)

        ckpt = Path(run[1].split("=", 1)[1]) / "serve_cli_run" / "checkpoint.pth"
        model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(1))
        save_checkpoint(ckpt, model.state_dict())
        status, body = _post(port, "/reload", b"")
        assert status == 200 and body["reloaded_from"] == str(ckpt)
        _, reloaded = _post(port, "/score", _npy(images))
        assert reloaded["scores"][0]["z_score_mse"] != served["scores"][0]["z_score_mse"]

        # SIGTERM while a POST /score is in flight: it completes, the process exits 0
        inflight = {}

        def score():
            inflight["result"] = _post(port, "/score", _npy(images))

        client = threading.Thread(target=score)
        client.start()
        t0 = time.time()
        while time.time() - t0 < 60:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/statz") as r:
                if json.loads(r.read())["requests"] >= 3:
                    break
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        client.join(timeout=300)
        assert proc.wait(timeout=120) == 0, "".join(lines)
        status, body = inflight["result"]
        assert status == 200 and len(body["scores"]) == 2
        assert any("shutting down" in ln for ln in lines)
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("flag,name", [("--aot_cache=sweep.aot", "--aot_cache")])
def test_unported_flags_raise(run, flag, name):
    """--aot_cache (TPU-only). --quantize is served in one process
    (tests/test_torch_quant_cli.py) and in several
    (tests/test_torch_serve_sharded.py)."""
    with pytest.raises(NotImplementedError, match=name):
        serve.main(run + [flag])


def test_more_than_one_process_raises(run, monkeypatch):
    """More than one process is served under torchrun
    (tests/test_torch_serve_sharded.py); a WORLD_SIZE without torchrun's
    rendezvous environment raises a named error before any work."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for key in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2.*rendezvous.*RANK"):
        serve.main(run)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        serve.main(["--device=cpu", f"--output_dir={tmp_path}", "--model_name=nope"])


def test_cuda_without_a_card_raises(run):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main([a for a in run if a != "--device=cpu"])  # --device defaults to cuda
