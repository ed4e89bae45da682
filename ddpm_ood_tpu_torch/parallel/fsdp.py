"""FSDP2 parameter and optimizer sharding: the port's twin of ``ddpm_ood_tpu/parallel/fsdp.py``.

``--fsdp=1`` shards each large parameter over the process group with
``torch.distributed.fsdp.fully_shard``; Adam's moments and the weight EMA are
made from the sharded parameters after the wrap, so they shard with them. The
JAX package's policy is kept: a parameter of fewer than ``min_size`` elements
(``DEFAULT_MIN_SIZE``, or ``DDPM_OOD_TPU_FSDP_MIN_SIZE``) stays replicated,
and a larger one is sharded along its largest axis that the process count
divides (one with no such axis stays replicated too). FSDP2 gathers the
sharded parameters before the forward and reduce-scatters their gradients
after the backward; the replicated ones are left out of FSDP2
(``ignored_params``) and their gradients are averaged by ``sync_replicated_grads``.

The model is wrapped as one FSDP2 unit at its root: parameters, gradients,
Adam's moments and the EMA are sharded at rest, and the whole model is
gathered for the step, as GSPMD may do with the JAX package's shardings.
FSDP2 refuses a parameter that is not contiguous, so a sharded parameter
leaves the channels-last layout the port gives convolution weights (one copy
of each, when the model is wrapped; the convolution then reads the weight in
the standard layout).

Checkpoints stay full state dicts in the reference schema: ``full_tensor``
gathers each sharded tensor on every process, and ``load_full_`` copies a full
tensor into its shard, so a checkpoint of an FSDP run loads into a plain run
and the other way round.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
from torch import nn

from . import mesh as pmesh

# tensors smaller than this stay replicated (sharding tiny arrays costs more
# in collective latency than it saves in memory)
DEFAULT_MIN_SIZE = 2**16
MIN_SIZE_ENV = "DDPM_OOD_TPU_FSDP_MIN_SIZE"


def min_size_from_env() -> int:
    return int(os.environ.get(MIN_SIZE_ENV, DEFAULT_MIN_SIZE))


def shard_axis(shape: Sequence[int], world: int, min_size: int = DEFAULT_MIN_SIZE
               ) -> Optional[int]:
    """The axis a tensor of `shape` is sharded along over `world` processes,
    or None when it stays replicated: ``_leaf_sharding``'s policy."""
    size = math.prod(shape) if len(shape) else 0
    if size >= min_size:
        for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
            if shape[ax] % world == 0:
                return ax
    return None


def apply_fsdp(module: nn.Module, min_size: int = DEFAULT_MIN_SIZE) -> List[nn.Parameter]:
    """Shard `module`'s large parameters over the process group in place;
    returns the parameters that stay replicated (``sync_replicated_grads``
    averages their gradients). Build the optimizer and the EMA afterwards."""
    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    if not dist.is_initialized():
        raise RuntimeError("--fsdp=1 shards over a process group and none is joined: run the "
                           "CLI (it makes a group of one without torchrun), or call "
                           "ddpm_ood_tpu_torch.parallel.mesh.initialize_distributed(device, "
                           "need_group=True) first")
    world = pmesh.process_count()
    axes: Dict[nn.Parameter, int] = {}
    replicated = []
    for p in module.parameters():
        ax = shard_axis(tuple(p.shape), world, min_size)
        if ax is None:
            replicated.append(p)
        else:
            axes[p] = ax
            p.data = p.data.contiguous()
    if axes:
        fully_shard(module, shard_placement_fn=lambda p: Shard(axes[p]),
                    ignored_params=set(replicated) or None)
    return replicated


def sync_replicated_grads(params: Iterable[nn.Parameter]) -> None:
    """Average the gradients of parameters that FSDP2 leaves out over the
    process group, in one all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or pmesh.process_count() == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    pmesh.all_reduce_sum_(flat).div_(pmesh.process_count())
    for g, chunk in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(chunk.view_as(g))


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full_tensor(t):
    """The whole tensor of a shard (a collective: every process calls it),
    else `t` itself. The shards are gathered with ``all_gather``, through
    host memory under gloo, which gathers host tensors (two ranks sharing a
    card run over gloo)."""
    if not is_sharded(t):
        return t
    import torch.distributed as dist

    local = t.to_local().contiguous()
    via_host = dist.get_backend() == "gloo" and local.device.type != "cpu"
    part = local.cpu() if via_host else local
    parts = [torch.empty_like(part) for _ in range(pmesh.process_count())]
    dist.all_gather(parts, part)
    return torch.cat(parts, dim=t.placements[0].dim).to(local.device)


def _local_shard(full: torch.Tensor, like) -> torch.Tensor:
    """This process's shard of `full`, cut as `like` (a sharded tensor) is:
    no collective, since every process holds `full`."""
    dim = like.placements[0].dim
    return full.to(like.device, like.dtype).chunk(pmesh.process_count(), dim)[
        pmesh.process_index()]


def full_state_dict(state: Mapping) -> dict:
    """A module state_dict with every shard gathered: the reference schema."""
    return {k: full_tensor(v) for k, v in state.items()}


def full_optimizer_state(state: Mapping) -> dict:
    """An optimizer state_dict with every shard of its state gathered."""
    return {"state": {i: {k: full_tensor(v) for k, v in s.items()}
                      for i, s in state["state"].items()},
            "param_groups": state["param_groups"]}


def load_full_(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a full tensor into `dst`, or into this process's shard of it."""
    if is_sharded(dst):
        full, dst = _local_shard(full, dst), dst.to_local()
    dst.copy_(full)


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Mapping) -> None:
    """A full optimizer state_dict into an optimizer over sharded parameters:
    each tensor of a parameter's shape is cut to that parameter's shard."""
    from torch.distributed.tensor import DTensor

    params = [p for g in optimizer.param_groups for p in g["params"]]
    converted = {}
    for i, s in state["state"].items():
        p = params[int(i)]
        converted[i] = {
            k: (DTensor.from_local(_local_shard(v, p), p.device_mesh, p.placements,
                                   run_check=False)
                if is_sharded(p) and torch.is_tensor(v) and v.shape == p.shape else v)
            for k, v in s.items()}
    optimizer.load_state_dict({"state": converted, "param_groups": state["param_groups"]})


def adam(params: Iterable[nn.Parameter], lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults over `params`. Torch's multi-tensor Adam
    (its default on CUDA) refuses a list that mixes shards and whole
    tensors, as ``apply_fsdp`` leaves them: then each parameter is updated
    on its own, to the same values."""
    params = list(params)
    mixed = len({is_sharded(p) for p in params}) > 1
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            foreach=False if mixed else None)


def sharded_bytes_per_device(tensors: Iterable[torch.Tensor]) -> int:
    """The bytes the tensors occupy on this process's device: a shard's
    local part, or the whole of a replicated tensor."""
    total = 0
    for t in tensors:
        local = t.to_local() if is_sharded(t) else t
        total += local.numel() * local.element_size()
    return total


def planned_bytes_per_device(shapes: Iterable[Sequence[int]], world: int,
                             min_size: int = DEFAULT_MIN_SIZE, itemsize: int = 4) -> int:
    """The bytes ``apply_fsdp``'s policy leaves on one of `world` devices for
    tensors of these shapes: the arithmetic ``bench_fsdp_hbm`` reports."""
    total = 0
    for shape in shapes:
        n = math.prod(shape) if len(shape) else 1
        total += (n // world if shard_axis(tuple(shape), world, min_size) is not None
                  else n) * itemsize
    return total
