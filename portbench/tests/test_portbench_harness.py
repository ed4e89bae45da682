"""The harness on the CPU: cells, configurations and metrics found by name
as new files, the operation and byte counts against hand arithmetic, the
union-of-spans arithmetic, the import guard, and the command's refusal to
run without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import flops, harness, spec
from portbench.trace import Trace, covered, union

CHECKOUT = Path(__file__).resolve().parents[2]
SMALL = {"num_channels": [128, 256, 256], "attention_levels": [False, False, True],
         "num_res_blocks": 1, "num_head_channels": 256, "norm_num_groups": 32}
BRATS_VQ = {"downsample_parameters": [[2, 4, 1, 1]] * 3, "embedding_dim": 128,
            "upsample_parameters": [[2, 4, 1, 1, 0]] * 3, "num_channels": [256] * 3,
            "num_res_channels": [256] * 3, "num_res_layers": 3, "num_embeddings": 2048,
            "spatial_dims": 3, "in_channels": 1, "out_channels": 1}


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(spec.PKG, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "unet2d-small-32.json").read_text())
    cfg["image_shape"] = [64, 64, 1]
    (root / "configs" / "unet2d-small-64.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "score2d-plms100x4-b512.json").read_text())
    cell["config"] = "unet2d-small-64"
    (root / "workloads" / "score2d-64-b128.json").write_text(json.dumps(cell))
    (root / "metrics" / "images_seen.score.py").write_text(
        "def read(run):\n    return run.window.get('batches')\n")
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        if m["name"] == "recons_per_s":
            m["workloads"].append("score2d-64-b128")
    bench["per_layer"].append({"name": "images_seen.score", "unit": "batches",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "recons_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = spec.cell("score2d-64-b128", root=root)
    assert found["config_spec"]["image_shape"] == [64, 64, 1]
    assert found["traffic"]["batch_size"] == 512
    names = [m["name"] for m in spec.metrics_for("score2d-64-b128", True,
                                                  tmp_path / "BENCHMARK.json")]
    assert names == ["images_seen.score"]  # the others list their cells
    assert "recons_per_s" in [m["name"] for m in spec.metrics_for(
        "score2d-64-b128", False, tmp_path / "BENCHMARK.json")]
    run = harness.Run(cell=found, seed=1, seconds=1, trace=True, device=None, t0=0.0)
    run.window["batches"] = 3
    assert spec.reader("images_seen.score", root=root).read(run) == 3


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.metrics_for(w["name"], True), w["name"]
        assert spec.cell(w["name"])["config"] == w["config"]
        for m in spec.metrics_for(w["name"], False) + spec.metrics_for(w["name"], True):
            assert callable(spec.reader(m["name"]).read)


def test_config_files_name_the_keys_benchmark_json_reduces():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((CHECKOUT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]), c["name"]
        assert set(cfg["reduced"]) <= set(cfg["assumed"]), c["name"]


def test_flops_match_hand_counts():
    c2 = {"image_shape": [32, 32, 1], "unet": SMALL, "compute_dtype": "bfloat16"}
    c3 = {"image_shape": [160, 160, 128, 1], "unet": SMALL, "compute_dtype": "bfloat16",
          "vqvae": BRATS_VQ}
    assert round(flops.unet_forward_flops(c2) / 1e9, 3) == 7.893
    assert round(flops.unet_forward_flops(c3) / 1e9, 1) == 114.7
    # the training step: the forward, and a backward of about twice it (the
    # first convolution's input takes no gradient)
    ratio = flops.unet_train_flops(c2) / flops.unet_forward_flops(c2)
    assert 2.99 < ratio < 3.0


def test_groupnorm_bytes_match_hand_count():
    # channels normalised at each level of the small UNet's forward (27
    # GroupNorms): 32x32: down 128+128, up 384+128, 256+128, out 128;
    # 16x16: down 128+256, up 512+256, 384+256; 8x8: down 256+256 and the
    # attention's 256, the middle 4x256 and its attention's 256, up
    # (512+256+256) twice
    elements = 1280 * 1024 + 1792 * 256 + 4096 * 64
    c2 = {"image_shape": [32, 32, 1], "unet": SMALL, "compute_dtype": "bfloat16"}
    assert flops.groupnorm_bytes(c2) == 2 * elements * 2


def _trace():
    ev = []

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    x("user_annotation", "portbench.unet", 0, 50)
    x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1)
    x("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=2)
    x("cpu_op", "aten::copy_", 60, 30)
    x("cuda_runtime", "cudaLaunchKernel", 70, 2, corr=3)
    x("kernel", "groupnorm_act_cluster_kernel", 15, 10, tid=7, corr=1)
    x("kernel", "conv", 20, 15, tid=7, corr=2)  # overlaps the first
    x("kernel", "elementwise", 80, 5, tid=7, corr=3)
    return Trace(ev)


def test_union_of_spans():
    assert union([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert covered([(0, 10), (5, 12), (20, 25)]) == 17
    t = _trace()
    assert t.busy_us() == 20 + 5  # (15, 35) and (80, 85)
    assert t.kernel_us("groupnorm_act") == 10
    assert t.under(lambda n: n == "portbench.unet") == 25
    assert t.idle_gaps() == [["portbench.unet", 45e-6]]  # the host span at the gap's start
    assert t.top_kernels(1) == [["conv", 15e-6]]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ddpm_ood_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ddpm_ood_tpu.fake", sys)
    assert harness.forbidden_modules() == ["ddpm_ood_tpu.fake"]


def test_reference_loads_nothing_of_the_port():
    code = ("import sys, portbench.reference.unet, portbench.reference.vqvae, "
            "portbench.reference.diffusion, portbench.reference.metrics, "
            "portbench.reference.train, portbench.flops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ddpm_ood_tpu_torch', 'ddpm_ood_tpu', 'jax', 'jaxlib', 'flax')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, check=True, timeout=120)


def test_the_command_refuses_to_run_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "score2d-plms100x4-b512", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
