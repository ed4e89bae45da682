"""``--remat`` and ``--profile_dir`` on the CPU.

- ``make_unet(..., remat=True)``: the tiny UNet in 2D and 3D gives the same
  loss and the same gradient of every parameter as without remat (fp32 on
  the CPU, one thread: the recomputed forward runs the same operations, so
  the values are equal, held at atol 0), while each res and attention block
  runs its forward twice a step (once more in the backward pass) and once
  under no_grad. The model JAX's ``nn.remat`` wraps is the same set of
  blocks: 11 res and 4 attention blocks in the tiny and small presets.
- The training CLI with ``--remat=1`` writes the per-step losses of a run
  without it, exactly.
- ``--profile_dir``: the training CLI traces warm steps 2-4 of its first
  epoch and the scoring CLI batch 1 of its first dataset pass, each as a
  non-empty Chrome trace naming the UNet's operations.
"""

import json

import numpy as np
import pytest
import torch

from ddpm_ood_tpu_torch import reconstruct as score_cli
from ddpm_ood_tpu_torch import train_ddpm as train_cli
from ddpm_ood_tpu_torch.diffusion.schedules import make_schedule
from ddpm_ood_tpu_torch.models.unet import AttentionBlock, ResnetBlock, make_unet, random_init_
from ddpm_ood_tpu_torch.train.ddpm import DDPMTrainStep
from test_torch_reconstruct import make_synthetic_run
from test_torch_train_cli import MODEL, train_argv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count_block_forwards(model) -> dict:
    counts = {"res": 0, "attn": 0}

    def hook(kind):
        def fn(module, inputs):
            counts[kind] += 1
        return fn

    for m in model.modules():
        if isinstance(m, ResnetBlock):
            m.register_forward_pre_hook(hook("res"))
        elif isinstance(m, AttentionBlock):
            m.register_forward_pre_hook(hook("attn"))
    return counts


@pytest.mark.parametrize("dims", [2, 3])
def test_remat_gives_the_same_gradients(dims):
    shape = (2, 3) + (8,) * dims
    rng = np.random.default_rng(dims)
    x0 = torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = torch.tensor([40, 870])
    out = {}
    for remat in (False, True):
        model = random_init_(make_unet("tiny", dims, 3, 3, remat=remat),
                             torch.Generator().manual_seed(0))
        counts = _count_block_forwards(model)
        step = DDPMTrainStep(model=model, sched=make_schedule("scaled_linear_beta", 1000,
                                                              0.0015, 0.0195))
        loss = step.grads(x0, noise, t)
        out[remat] = (loss, {n: p.grad.clone() for n, p in model.named_parameters()},
                      dict(counts))
        with torch.no_grad():
            model(x0, t)
        out[remat] += ({k: v - out[remat][2][k] for k, v in counts.items()},)
    (l0, g0, c0, n0), (l1, g1, c1, n1) = out[False], out[True]
    assert l1.item() == l0.item()
    assert sorted(g1) == sorted(g0) and len(g0) > 100
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, atol=0, rtol=0, msg=name)
    assert c0 == n0 == n1 == {"res": 11, "attn": 4}  # one forward of each block
    assert c1 == {"res": 22, "attn": 8}  # and one more in the backward pass


def test_training_cli_with_remat_writes_the_same_losses(tmp_path):
    runs = {}
    for flag in ("--remat=0", "--remat=1"):
        root = tmp_path / flag[2:].replace("=", "")
        trainer = train_cli.main(train_argv(root, "--n_epochs=1", "--eval_freq=100", flag))
        lines = (root / "output" / MODEL / "train" / "scalars.jsonl").read_text().splitlines()
        runs[flag] = [(r["tag"], r["step"], r["value"]) for r in map(json.loads, lines)]
        assert all(b.remat == (flag == "--remat=1") for b in trainer.unet.modules()
                   if isinstance(b, (ResnetBlock, AttentionBlock)))
    assert runs["--remat=1"] == runs["--remat=0"] and len(runs["--remat=0"]) == 3


def _trace_names(path) -> set:
    trace = json.loads(path.read_text())
    return {e.get("name", "") for e in trace["traceEvents"]}


def test_profile_dir_writes_traces(tmp_path, monkeypatch):
    trainer = train_cli.main(train_argv(tmp_path / "train", "--n_epochs=1", "--eval_freq=100",
                                        f"--profile_dir={tmp_path / 'prof_train'}"))
    assert trainer.profile_path == tmp_path / "prof_train" / "train_steps_2_4.pt.trace.json"
    names = _trace_names(trainer.profile_path)
    assert trainer.profile_path.stat().st_size > 0
    assert any("conv" in n for n in names) and any("Optimizer.step" in n for n in names)

    root = tmp_path / "score"
    argv = make_synthetic_run(root) + ["--batch_size=2", f"--profile_dir={tmp_path / 'prof'}"]
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(root / "lpips.npz"))
    recon = score_cli.main(argv)
    assert recon.profile_path == tmp_path / "prof" / "scoring_val_batch1.pt.trace.json"
    names = _trace_names(recon.profile_path)
    assert any("conv" in n for n in names) and "aten::einsum" in names  # plain attention
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == [recon.profile_path.name]
