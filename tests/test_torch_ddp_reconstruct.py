"""The scoring pipeline in 2 gloo processes on the CPU against one process
(the twin of the JAX package's
tests/test_multiprocess.py::test_two_process_reconstruct_and_checkpoint).

With the noise forced to zeros (``host_noise_fn``) a score is a function of
(image, start point) alone, so the merged ``results_{val,in}.csv`` of 2
processes, deduplicated by (filename, t), equals one process's CSV at rtol
1e-4, atol 1e-6 (mse and perceptual_difference). Each rank wrote its shard
``.results_<name>.shard<rank>.csv`` and rank 0 merged them in rank order.
Splits of 6 and 5 images at batch 2: the 5 are wrap-padded to 3 a process.
A resume from per-rank partial CSVs that hold each rank's first batch
rescores one batch a pass and reproduces the merged CSVs exactly.
"""

import argparse
import csv
import io
import json
import shutil

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch.config import parse_args_reconstruct
from ddpm_ood_tpu_torch.models.unet import make_unet, random_init_
from ddpm_ood_tpu_torch.trainers import Reconstruct
from ddpm_ood_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_reconstruct import _split, write_lpips_npz
from torch_ddp_worker import finish, results, start

MODEL = "mp_fashionmnist"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(text: str) -> list:
    return list(csv.DictReader(io.StringIO(text)))


def dedup_sorted(text: str) -> list:
    seen = {}
    for r in rows(text):
        seen.setdefault((r["filename"], int(r["t"])), r)
    return [seen[k] for k in sorted(seen)]


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_recon")
    rng = np.random.default_rng(0)
    val = _split(root, "val", 6, False, rng)
    ins = _split(root, "FashionMNIST_test", 5, False, rng)
    run = root / "output" / MODEL
    run.mkdir(parents=True)
    model = random_init_(make_unet("tiny", 2, 1, 1), torch.Generator().manual_seed(0))
    save_checkpoint(run / "checkpoint.pth", model.state_dict(), epoch=3)
    args = vars(parse_args_reconstruct([
        f"--output_dir={root / 'output'}", f"--model_name={MODEL}", f"--validation_ids={val}",
        f"--in_ids={ins}", "--run_out=0", "--image_size=16", "--model_type=tiny",
        "--is_grayscale=1", "--batch_size=2", "--beta_schedule=scaled_linear_beta",
        "--beta_start=0.0015", "--beta_end=0.0195", "--num_inference_steps=10",
        "--inference_skip_factor=3", "--num_workers=2", "--recon_groups=2"]))
    (root / "args.json").write_text(json.dumps(args))
    (root / "ranks.json").write_text(json.dumps({**args, "output_dir": str(root / "ranks")}))
    npz = str(write_lpips_npz(root / "lpips.npz"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPIPS_WEIGHTS_NPZ", npz)
        # the ranks score their own copy of the run while this process scores
        shutil.copytree(run, root / "ranks" / MODEL)
        ranks = start("recon", root / "ranks.json", root)
        try:
            a = argparse.Namespace(**args)
            single = Reconstruct(a, torch.device("cpu"))
            single._program(a.inference_skip_factor).host_noise_fn = (
                lambda shape, t_starts: np.zeros(shape, np.float32))
            single.reconstruct(a)
        finally:
            torch.set_num_threads(n)
        one = {name: (run / "ood" / f"results_{name}.csv").read_text() for name in ("val", "in")}
        finish(ranks)
    return dict(one=one, ranks=results(root), k=len(single._program(3).t_starts))


@pytest.mark.parametrize("name", ["val", "in"])
def test_merged_csv_equals_one_process(scored, name):
    merged = dedup_sorted(scored["ranks"][0]["merged"][name])
    single = dedup_sorted(scored["one"][name])
    assert [(r["filename"], r["t"]) for r in merged] == [(r["filename"], r["t"]) for r in single]
    for col in ("mse", "perceptual_difference"):
        np.testing.assert_allclose([float(r[col]) for r in merged],
                                   [float(r[col]) for r in single], rtol=1e-4, atol=1e-6,
                                   err_msg=col)


@pytest.mark.parametrize("name,per_rank", [("val", 3), ("in", 3)])
def test_each_rank_wrote_a_shard_and_rank0_merged_them(scored, name, per_rank):
    r0, r1 = scored["ranks"]
    assert r0["merged"][name] == r1["merged"][name]
    shards = [rows(r["shards"][name]) for r in scored["ranks"]]
    assert [len(s) for s in shards] == [per_rank * scored["k"]] * 2
    merged = rows(r0["merged"][name])
    assert [int(r[""]) for r in merged] == list(range(len(merged)))
    strip = [{k: v for k, v in r.items() if k} for r in merged]
    assert strip == [{k: v for k, v in r.items() if k} for s in shards for r in s]


def test_resume_from_per_rank_partials(scored):
    for r in scored["ranks"]:
        assert r["resumed"] == r["merged"]
        assert r["batches"] == 2  # one rescored batch of each pass
        assert r["partials_left"] == []
