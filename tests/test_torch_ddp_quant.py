"""``python -m ddpm_ood_tpu_torch.reconstruct --quantize=int8`` under
``python -m torch.distributed.run --nproc_per_node=2`` (gloo, the CPU).

12 validation images of 8x8 over 2 ranks at batch 2: 3 batches a rank,
PLMS 10/5 (2 start points) in one lane group, each rank's own noise
(``NOISE_SEED + rank``). Every quantised call takes its activation absmax
over both ranks' images of that call, as JAX's program over the processes'
joined batch does. Held:

- every quantised call's absmax is the larger of the two ranks' own max
  |x| of that call, the same on both ranks;
- the merged ``results_val.csv`` against the port's one-process int8
  program run on the global batches (rank 0's i-th batch, then rank 1's)
  with the ranks' noise joined the same way, at RTOL 1e-5 (the quantised
  CLI's tolerance), every (image, start point), mse and
  perceptual_difference. The CPU's fp32 kernels depend on the batch size
  in the last bit (the time embedding's matmul), and a code at a .5 tie
  then flips, which moves a sweep by ~1e-3: so each quantised call of the
  one process is held to the ranks' joined input of that call and takes it
  where a code flips (``tests/test_torch_quant_cli.py:TieRepair``, strict:
  codes differ only within TIE_BAND of a tie);
- a control: rank 0's batches scored alone (its own absmax), held the
  same way, miss the merged CSV at RTOL;
- a resume from per-rank partial CSVs that hold 2 batches on rank 0 and 1
  on rank 1: the ranks skip only the batch both hold, so their quantised
  calls still pair up (2 batches rescored on each), and the merged CSV is
  reproduced exactly with no partial left.
"""

import csv
import io
import json
import time

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch import reconstruct as cli
from ddpm_ood_tpu_torch.parallel import mesh as pmesh
from ddpm_ood_tpu_torch.serve import NOISE_SEED
from ddpm_ood_tpu_torch.trainers.reconstruct import _stem
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_quant_cli import RTOL, SIZE, TieRepair, _seeded, _split
from test_torch_reconstruct import MODEL, write_lpips_npz
from torch_ddp_worker import finish, results, start

BATCH, BATCHES, SKIP, HELD = 2, 3, 5, (2, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(text: str) -> dict:
    return {(r["filename"], int(r["t"])): r for r in csv.DictReader(io.StringIO(text))}


@pytest.fixture(scope="module")
def quant_ddp(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_quant")
    val = _split(root, "val", 2 * BATCH * BATCHES, False, np.random.default_rng(0))
    write_lpips_npz(root / "lpips.npz")
    argv = [f"--validation_ids={val}", f"--in_ids={val}", "--run_in=0", "--run_out=0",
            f"--image_size={SIZE}", "--model_type=tiny", "--is_grayscale=1",
            f"--batch_size={BATCH}", "--beta_schedule=scaled_linear_beta", "--beta_start=0.0015",
            "--beta_end=0.0195", "--num_inference_steps=10", f"--inference_skip_factor={SKIP}",
            "--num_workers=1", "--recon_groups=1", "--quantize=int8", f"--model_name={MODEL}"]
    for name in ("one", "ranks"):
        (root / name / MODEL).mkdir(parents=True)
        save_checkpoint(root / name / MODEL / "checkpoint.pth", _seeded(2), epoch=3)
    (root / "in.json").write_text(json.dumps({
        "argv": ["--device=cpu", f"--output_dir={root / 'ranks'}", *argv], "skip": SKIP,
        "batch": BATCH, "held": HELD, "out": str(root)}))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
        ranks = start("recon_quant", root / "in.json", root, torchrun=True)
        try:
            args = cli.parse_args(["--device=cpu", f"--output_dir={root / 'one'}", *argv])
            recon = cli.Reconstruct(args, torch.device("cpu"))
            program = recon._program(SKIP)
            k = len(program.t_starts)
            batches = []
            for r in range(2):  # each rank's partition, as the ranks' loaders make it
                with pytest.MonkeyPatch.context() as rank_mp:
                    rank_mp.setattr(pmesh, "process_count", lambda: 2)
                    rank_mp.setattr(pmesh, "process_index", lambda r=r: r)
                    loader = recon._make_loader(args.validation_ids, None)
                gen = torch.Generator().manual_seed(NOISE_SEED + r)
                batches.append([(b["filename"], np.moveaxis(b["image"], 1, -1),
                                 torch.randn((k, BATCH, SIZE, SIZE, 1), generator=gen).numpy())
                                for b in loader])
            # the ranks' input of every quantised call of their first run
            # (written while they resume), each call's rows joined in rank
            # order, lane by lane: the global batch's
            inputs = [_wait_for(root / f"inputs{r}.pt", ranks) for r in range(2)]
            joined = [np.concatenate([a.reshape((k, BATCH) + a.shape[1:]),
                                      b.reshape((k, BATCH) + b.shape[1:])], axis=1
                                     ).reshape((-1,) + a.shape[1:])
                      for a, b in zip(*inputs)]
            want, repair = _scores(program, [
                (list(f0) + list(f1), np.concatenate([x0, x1]), np.concatenate([n0, n1], axis=1))
                for (f0, x0, n0), (f1, x1, n1) in zip(*batches)], recon.unet, joined, True)
            # the control: rank 0's batches alone, each absmax its own
            alone, _ = _scores(program, batches[0], recon.unet, inputs[0], False)
        finally:
            torch.set_num_threads(n)
        finish(ranks)
    print(f"int8 one process: {repair.calls} quantised calls, {repair.flips} codes flipped at a "
          f".5 tie in {repair.repaired} of them")
    return dict(ranks=results(root), want=want, alone=alone, k=k, repair=repair)


def _wait_for(path, ranks) -> list:
    """`path`'s contents once a rank has written it."""
    deadline = time.monotonic() + 600
    while not path.exists():
        if any(p.poll() is not None for p in ranks.procs) or time.monotonic() > deadline:
            finish(ranks)  # raises with the ranks' output
            raise AssertionError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _scores(program, batches, model, sites: list, strict: bool) -> tuple:
    """{(filename, t): (mse, perceptual)} of the one-process program on
    (filenames, images, noise) batches, each quantised call held to
    `sites` (TieRepair), and the repair."""
    draws = iter([noise for _, _, noise in batches])
    # the draw prefetched after the last batch is never used
    program.host_noise_fn = lambda shape, t_starts: next(draws, np.zeros(shape, np.float32))
    repair = TieRepair(model, sites, strict=strict)
    out = {}
    try:
        for names, images, _ in batches:
            t_starts, mse, perc = (np.asarray(a) for a in program(images))
            for j, f in enumerate(names):
                for i, t in enumerate(t_starts):
                    out[(_stem(f), int(t))] = (float(mse[i, j]), float(perc[i, j]))
    finally:
        repair.remove()
        program.host_noise_fn = None
        program.close()
    assert repair.calls == len(sites)
    return out, repair


def test_merged_csv_equals_the_one_process_program_on_the_global_batches(quant_ddp):
    rows = _rows(quant_ddp["ranks"][0]["merged"])
    assert sorted(rows) == sorted(quant_ddp["want"])
    assert len(rows) == 2 * BATCH * BATCHES * quant_ddp["k"]
    got = np.array([[float(rows[key][c]) for c in ("mse", "perceptual_difference")]
                    for key in quant_ddp["want"]])
    want = np.array(list(quant_ddp["want"].values()))
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    for r in quant_ddp["ranks"]:
        assert r["batches"] == BATCHES


def test_every_absmax_spans_both_ranks(quant_ddp):
    a, b = (r["absmax"] for r in quant_ddp["ranks"])
    assert len(a) == len(b) == quant_ddp["repair"].calls > 0
    for (local_a, got_a), (local_b, got_b) in zip(a, b):
        assert got_a == got_b == max(local_a, local_b)


def test_a_rank_alone_scores_otherwise(quant_ddp):
    rows = _rows(quant_ddp["ranks"][0]["merged"])
    keys = sorted(quant_ddp["alone"])
    got = np.array([float(rows[key]["mse"]) for key in keys])
    alone = np.array([quant_ddp["alone"][key][0] for key in keys])
    assert not np.allclose(got, alone, rtol=RTOL, atol=0)


def test_resume_from_unequal_partials_reproduces_the_merged_csv(quant_ddp):
    for r in quant_ddp["ranks"]:
        assert r["resumed_batches"] == BATCHES - min(HELD)
        assert r["partials_left"] == []
        assert r["resumed"] == r["merged"]
    assert quant_ddp["ranks"][0]["merged"] == quant_ddp["ranks"][1]["merged"]
