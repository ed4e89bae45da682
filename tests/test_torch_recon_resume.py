"""The port's crash-safe scoring passes and ``--resume``, on the CPU.

The cases of ``tests/test_recon_resume.py`` against the port's ``_CsvSink``
and ``Reconstruct.get_scores``: every scored batch reaches the partial CSV
before the next one starts; a resumed pass skips the batches the partial
holds whole, without scoring them, and its CSV equals an uninterrupted
pass's exactly (the scoring generator is advanced past a skipped batch's
draw); an image persisted at fewer than every start point is rescored with
no duplicate rows; an unreadable partial, or one whose last line was torn,
is dropped (whole, or that row) and the pass completes; a run without
``--resume`` removes a stale partial. Then the CLI itself: ``python -m
ddpm_ood_tpu_torch.reconstruct`` with ``DDPM_OOD_TPU_CRASH_AFTER_BATCHES=1``
is SIGKILLed after batch 1 with that batch's rows on disk, and the rerun
with ``--resume=1`` writes the CSV an uninterrupted run writes, byte for
byte (fp32 on the CPU, one thread).
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch import reconstruct as cli
from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.recon.sweep import ReconProgram
from ddpm_ood_tpu_torch.trainers.reconstruct import _CsvSink
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_reconstruct import _split, write_lpips_npz

REPO = Path(__file__).resolve().parents[1]
MODEL = "resume_fashionmnist"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_model_fn(x, t):
    return 0.1 * x + 0.01 * (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))


class _Counting:
    """A program proxy that counts scored batches."""

    def __init__(self, prog):
        self.__dict__.update(_p=prog, calls=0)

    def __call__(self, *a, **k):
        self.calls += 1
        return self._p(*a, **k)

    def __getattr__(self, name):
        return getattr(self._p, name)


def _program() -> _Counting:
    return _Counting(ReconProgram(sched=make_schedule("scaled_linear_beta", 1000, 0.0015, 0.0195),
                                  model_fn=_toy_model_fn, num_inference_steps=10,
                                  inference_skip_factor=3, num_groups=2))


@pytest.fixture(scope="module")
def run_root(tmp_path_factory):
    """A tiny checkpoint, 12 validation images and an LPIPS npz."""
    root = tmp_path_factory.mktemp("resume")
    val = _split(root, "val", 12, False, np.random.default_rng(0))
    (root / "output" / MODEL).mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(root / "output" / MODEL / "checkpoint.pth", model.state_dict(), epoch=1)
    write_lpips_npz(root / "lpips.npz")
    return root, val


def _argv(root: Path, val: str, out: str = "output", *extra) -> list:
    return ["--device=cpu", f"--output_dir={root / out}", f"--model_name={MODEL}",
            f"--validation_ids={val}", f"--in_ids={val}", f"--out_ids={val}", "--run_in=0",
            "--run_out=0", "--image_size=16", "--model_type=tiny", "--is_grayscale=1",
            "--batch_size=4", "--num_inference_steps=10", "--inference_skip_factor=3",
            "--num_workers=1", "--recon_groups=2", *extra]


@pytest.fixture
def recon(run_root, monkeypatch):
    """A Reconstruct whose skip-3 program is the toy one, counted."""
    root, val = run_root
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
    r = cli.Reconstruct(cli.parse_args(_argv(root, val)), torch.device("cpu"))
    r._programs[3] = _program()
    return r


def _batch(n, tag):
    return {"image": np.random.default_rng(sum(map(ord, tag))).uniform(
                size=(n, 1, 8, 8)).astype(np.float32),
            "filename": [f"{tag}_{i}.npy" for i in range(n)]}


class _CrashingLoader:
    """Yields the first `n_ok` batches, then fails as a crash would."""

    def __init__(self, batches, n_ok):
        self.batches, self.n_ok = batches, n_ok

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i >= self.n_ok:
                raise RuntimeError("simulated mid-run failure")
            yield b


def _read(path: Path) -> list:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _keys(rows) -> list:
    return [(r["filename"], r["type"], r["t"]) for r in rows]


def test_sink_flushes_per_batch_and_resume_skips(recon, tmp_path):
    batches = [_batch(4, "a"), _batch(4, "b"), _batch(4, "c")]
    k = len(recon._programs[3].t_starts)

    sink1 = _CsvSink(tmp_path, "val", recon.columns)
    with pytest.raises(RuntimeError, match="simulated"):
        recon.get_scores(_CrashingLoader(batches, 2), "val", 3, sink=sink1)
    assert recon._programs[3].calls == 2
    partial = tmp_path / ".results_val.partial.csv"
    assert len(_read(partial)) == 2 * 4 * k  # both scored batches are on disk
    assert not (tmp_path / "results_val.csv").exists()

    recon._programs[3] = _program()
    sink2 = _CsvSink(tmp_path, "val", recon.columns, resume=True)
    assert sink2.resumed_rows == 2 * 4 * k
    recon.get_scores(batches, "val", 3, sink=sink2)
    assert recon._programs[3].calls == 1  # batches 1-2 were not rescored
    sink2.finalize()
    assert not partial.exists()
    final = _read(tmp_path / "results_val.csv")
    assert len(final) == 3 * 4 * k and len(set(_keys(final))) == len(final)

    recon._programs[3] = _program()
    sink3 = _CsvSink(tmp_path, "ref", recon.columns)
    recon.get_scores(batches, "val", 3, sink=sink3)
    sink3.finalize()
    ref = _read(tmp_path / "results_ref.csv")
    by_key = {key: r for key, r in zip(_keys(ref), ref)}
    for key, row in zip(_keys(final), final):
        assert row["mse"] == by_key[key]["mse"]  # the same noise as without the crash


def test_sink_partial_image_is_rescored(recon, tmp_path):
    batches = [_batch(4, "a")]
    k = len(recon._programs[3].t_starts)
    sink1 = _CsvSink(tmp_path, "val", recon.columns)
    recon.get_scores(batches, "val", 3, sink=sink1)
    partial = tmp_path / ".results_val.partial.csv"
    lines = partial.read_text().splitlines()
    partial.write_text("\n".join(lines[:-1]) + "\n")  # one image now has k - 1 rows

    recon._programs[3] = _program()
    sink2 = _CsvSink(tmp_path, "val", recon.columns, resume=True)
    assert sink2.resumed_rows == 4 * k - 1
    recon.get_scores(batches, "val", 3, sink=sink2)
    assert recon._programs[3].calls == 1  # the torn batch was rescored
    sink2.finalize()
    final = _read(tmp_path / "results_val.csv")
    assert len(final) == 4 * k and len(set(_keys(final))) == len(final)
    assert [r[""] for r in final] == [str(i) for i in range(4 * k)]


def test_sink_resume_from_corrupt_partial_starts_fresh(recon, tmp_path):
    batches = [_batch(4, "a")]
    k = len(recon._programs[3].t_starts)
    partial = tmp_path / ".results_val.partial.csv"
    partial.write_bytes(b"\x00\xffnot,a\ncsv\x00" * 3)
    sink = _CsvSink(tmp_path, "val", recon.columns, resume=True)
    assert sink.resumed_rows == 0 and not partial.exists()
    recon.get_scores(batches, "val", 3, sink=sink)
    sink.finalize()
    final = _read(tmp_path / "results_val.csv")
    assert len(final) == 4 * k and all(all(v != "" for v in r.values()) for r in final)

    # a torn last line that still splits into fields: that row goes, and its
    # image is rescored
    (tmp_path / "t2").mkdir()
    recon._programs[3] = _program()
    recon.get_scores(batches, "val", 3, sink=_CsvSink(tmp_path / "t2", "val", recon.columns))
    p2 = tmp_path / "t2" / ".results_val.partial.csv"
    lines = p2.read_text().splitlines()
    p2.write_text("\n".join(lines[:-1] + [lines[-1].rsplit(",", 2)[0]]) + "\n")
    sink2 = _CsvSink(tmp_path / "t2", "val", recon.columns, resume=True)
    assert sink2.resumed_rows == 4 * k - 1
    recon._programs[3] = _program()
    recon.get_scores(batches, "val", 3, sink=sink2)
    assert recon._programs[3].calls == 1
    sink2.finalize()
    final2 = _read(tmp_path / "t2" / "results_val.csv")
    assert len(final2) == 4 * k and len(set(_keys(final2))) == len(final2)
    assert all(all(v != "" for v in r.values()) for r in final2)


def test_non_resume_run_discards_stale_partial(recon, tmp_path):
    stale = tmp_path / ".results_val.partial.csv"
    stale.write_text(",".join(recon.columns) + "\nghost,val,1,0.0,0.0\n")
    sink = _CsvSink(tmp_path, "val", recon.columns)
    assert sink.resumed_rows == 0 and not stale.exists()
    recon.get_scores([_batch(4, "a")], "val", 3, sink=sink)
    sink.finalize()
    assert "ghost" not in {r["filename"] for r in _read(tmp_path / "results_val.csv")}


def test_cli_sigkill_then_resume_equals_an_uninterrupted_run(run_root, monkeypatch):
    root, val = run_root
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
    cli.main(_argv(root, val, "output"))  # uninterrupted, into output/
    want = (root / "output" / MODEL / "ood" / "results_val.csv").read_text()

    crashed = root / "crashed"
    (crashed / MODEL).mkdir(parents=True)
    (crashed / MODEL / "checkpoint.pth").write_bytes(
        (root / "output" / MODEL / "checkpoint.pth").read_bytes())
    cmd = [sys.executable, "-m", "ddpm_ood_tpu_torch.reconstruct",
           *_argv(root, val, "crashed", "--resume=1")]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "DDPM_OOD_TPU_CRASH_AFTER_BATCHES": "1"}
    p1 = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p1.returncode == -9, (p1.returncode, p1.stderr[-3000:])
    ood = crashed / MODEL / "ood"
    partial = ood / ".results_val.partial.csv"
    assert len(_read(partial)) == 4 * 4  # batch 1: 4 images x 4 start points
    assert not (ood / "results_val.csv").exists()

    env.pop("DDPM_OOD_TPU_CRASH_AFTER_BATCHES")
    p2 = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p2.returncode == 0, p2.stderr[-3000:]
    assert "resume: skipped 4 already-scored images for 'val'" in p2.stdout + p2.stderr
    assert not partial.exists()
    got = (ood / "results_val.csv").read_text()
    assert len(_read(ood / "results_val.csv")) == 12 * 4
    assert got == want
