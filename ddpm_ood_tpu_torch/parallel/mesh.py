"""Process group and batch helpers: the port's twin of ``ddpm_ood_tpu/parallel/mesh.py``.

The JAX package runs one GSPMD program over a device mesh, with the batch
sharded along its ``data`` axis and the gradient all-reduce compiled into the
step. The port runs as the reference program did: one process per card under
torchrun, the UNet wrapped in ``DistributedDataParallel`` (or sharded by FSDP2,
``parallel/fsdp.py``), NCCL between cards and gloo on the CPU::

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m ddpm_ood_tpu_torch.train_ddpm <flags>             # NCCL, one card a rank
    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m ddpm_ood_tpu_torch.train_ddpm <flags> --device=cpu  # gloo

Each process loads its own partition of the data (``data/csv_splits.py:
partition_for_process``), so a process holds one device's share of the batch
and ``shard_batch``'s local multiple is 1; its wrap-pad arithmetic is kept in
``local_multiple`` and ``wrap_pad``. ``make_mesh``, ``batch_sharding``,
``replicate`` and ``NamedSharding`` have no counterpart: DDP replicates the
parameters by broadcasting rank 0's when it wraps the model, and a rank's
tensors live on its one device.

``SHARED_CARD_ENV=1``, set by the launcher and never as a reaction to an
error, puts every rank of the host on ``cuda:0`` over gloo: NCCL refuses two
ranks on one device, and a host with one card can still hold a 2-rank run.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

SHARED_CARD_ENV = "DDPM_OOD_TORCH_SHARED_CARD"
RENDEZVOUS_KEYS = ("RANK", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(minutes=10)


def _launched_world() -> int:
    """The WORLD_SIZE torchrun gave this process, or 0 without one."""
    return int(os.environ.get("WORLD_SIZE", "0") or 0)


def shared_card() -> bool:
    return os.environ.get(SHARED_CARD_ENV, "0") not in ("", "0")


def local_device_index() -> int:
    """The card of this process: ``LOCAL_RANK`` under torchrun (0 for every
    rank with ``SHARED_CARD_ENV``), else the current device. A rank whose
    card is not there raises."""
    if _launched_world() == 0 or "LOCAL_RANK" not in os.environ:
        return torch.cuda.current_device()
    if shared_card():
        return 0
    index, count = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(f"LOCAL_RANK={index} finds no card: {count} visible. NCCL takes one "
                           f"card a rank; two ranks on one card need {SHARED_CARD_ENV}=1 (gloo)")
    return index


def backend_for(device: torch.device) -> str:
    if device.type == "cuda" and not shared_card():
        return "nccl"
    return "gloo"


def initialize_distributed(device: torch.device, need_group: bool = False) -> bool:
    """Join torchrun's process group (``initialize_multihost``'s twin): NCCL
    on CUDA, gloo on the CPU. A no-op without torchrun's environment, as the
    JAX one is without a coordinator, unless ``need_group`` (FSDP2 needs a
    group even for one process): then a group of one process is made.
    Returns True when this call made the group, so its caller destroys it.
    A failed ``init_process_group`` raises; nothing falls back."""
    if dist.is_initialized():
        return False
    world = _launched_world()
    missing = [k for k in RENDEZVOUS_KEYS if k not in os.environ]
    if world > 1 and missing:
        raise RuntimeError(
            f"more than one process (WORLD_SIZE={world}) needs torchrun's rendezvous "
            f"environment; {', '.join(missing)} unset: launch with python -m "
            "torch.distributed.run --nproc_per_node=N -m ddpm_ood_tpu_torch.<cli>")
    backend = backend_for(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world >= 1 and not missing:
        dist.init_process_group(backend, init_method="env://", world_size=world,
                                rank=int(os.environ["RANK"]), timeout=TIMEOUT, **kw)
    elif need_group:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=TIMEOUT, **kw)
    else:
        return False
    return True


@contextlib.contextmanager
def distributed(device: torch.device, need_group: bool = False) -> Iterator[None]:
    """``initialize_distributed`` for a CLI's lifetime, the one place that
    joins and leaves the group: the group it made is destroyed on the way
    out, and one that was there before is left alone. (Under torchrun a
    process can make its group only once, so a program that runs several
    CLIs in one process joins first.)"""
    made = initialize_distributed(device, need_group)
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def check_joined() -> None:
    """Raise when this process is one of several that torchrun launched but
    has joined no group: it would train or score alone, on all the data."""
    world = _launched_world()
    if world > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"this process is one of WORLD_SIZE={world} but has joined no process group: run "
            "the CLI, or call ddpm_ood_tpu_torch.parallel.mesh.initialize_distributed(device) "
            "first")


def wrap_ddp(module: torch.nn.Module, device: torch.device):
    """``DistributedDataParallel`` around `module`, its gradients all-reduced
    over the group. DDP lays each gradient bucket's view out with its
    parameter's strides, and warns and copies element by element when a
    gradient comes with others. The channels-last weight of a convolution
    over one input channel has the memory order of the standard layout but
    other strides, and cuDNN gives its gradient the standard ones (an input
    of one channel suggests no channels-last layout): such a weight is given
    the standard strides first, one copy of it here. Every other weight's
    gradient comes as its parameter is laid out, a transposed convolution's
    to one output channel too."""
    from torch import nn
    from torch.nn.parallel import DistributedDataParallel

    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)) and m.in_channels == 1:
            m.weight.data = m.weight.data.clone(memory_format=torch.contiguous_format)
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def coordination_barrier(name: str) -> None:
    """Every process meets here before any goes on; a no-op for one process.
    `name` is for the reader and the log: torch's barrier is not named."""
    del name
    if process_count() > 1:
        dist.barrier()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In place, the sum over processes (gloo has no average); a no-op for one."""
    if process_count() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over processes of a tensor every process holds at one shape."""
    if process_count() == 1:
        return t
    return all_reduce_sum_(t.clone()) / process_count()


def any_process(flag: bool, device: torch.device) -> bool:
    """True when `flag` is true on any process (`device`: this process's)."""
    if process_count() == 1:
        return bool(flag)
    return bool(all_reduce_max_(torch.tensor([1.0 if flag else 0.0], device=device)).item())


def all_processes(flag: bool, device: torch.device) -> bool:
    """True when `flag` is true on every process."""
    return not any_process(not flag, device)


def _backend_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` as the group's backend takes it: a CUDA tensor under gloo as a
    host copy (which waits for the card), else `t` itself (NCCL works on
    the card's stream, with no host sync)."""
    if t.device.type == "cuda" and dist.get_backend() != "nccl":
        return t.cpu()
    return t


def _through_host(t: torch.Tensor, op) -> torch.Tensor:
    """``op(tensor)`` on `t`, in place, through ``_backend_copy``."""
    x = _backend_copy(t)
    op(x)
    return t if x is t else t.copy_(x)


def all_reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """In place, the elementwise max over processes; a no-op for one."""
    if process_count() > 1:
        _through_host(t, lambda x: dist.all_reduce(x, op=dist.ReduceOp.MAX))
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In place, rank `src`'s `t` on every process; a no-op for one."""
    if process_count() > 1:
        _through_host(t, lambda x: dist.broadcast(x, src))
    return t


def shard_rows(batch, world: Optional[int] = None):
    """This rank's rows of a global batch (a numpy array, or a tensor that
    `world` divides): ``shard_batch``'s wrap-pad up to a multiple of the
    `world` processes (default: the group's), then rank r's contiguous rows
    [r*b, (r+1)*b); the whole batch for one process."""
    world = process_count() if world is None else int(world)
    if len(batch) % world:
        batch = wrap_pad(batch, world)
    b = len(batch) // world
    return batch[process_index() * b:(process_index() + 1) * b]


def all_gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global tensor on every process: each process's `t` (all of one
    shape) joined along `dim` in rank order; `t` itself for one."""
    world = process_count()
    if world == 1:
        return t
    x = _backend_copy(t.contiguous())
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim).to(t.device)


def local_multiple(data_size: int, procs: int) -> int:
    """``shard_batch``'s local multiple: the data-axis devices each process
    holds, which its local batch must tile evenly (1 under DDP)."""
    return max(1, data_size // procs)


def wrap_pad(batch: np.ndarray, multiple: int) -> np.ndarray:
    """``shard_batch``'s wrap-pad: a leading dim that `multiple` does not
    divide is padded up to one it does by repeating leading samples."""
    batch = np.asarray(batch)
    if batch.shape[0] % multiple == 0:
        return batch
    target = -(-batch.shape[0] // multiple) * multiple
    return batch[np.arange(target) % batch.shape[0]]


def pad_batch_to(batch: np.ndarray, multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the leading dim up to a multiple with zeros; (padded, valid_mask)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    mask = np.ones((n + rem,), dtype=bool)
    if rem:
        batch = np.pad(batch, [(0, rem)] + [(0, 0)] * (batch.ndim - 1))
        mask[n:] = False
    return batch, mask
