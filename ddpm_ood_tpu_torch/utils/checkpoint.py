"""Write, find and load reference-schema ``.pth`` checkpoints.

The reference (and the port's trainer) saves ``checkpoint.pth`` (the
rolling best) and periodic ``checkpoint_{N}.pth`` files, each a dict {epoch
(the next epoch to run), global_step (images seen), model_state_dict,
optimizer_state_dict (torch Adam's own ``state_dict()``), best_loss} plus
``ema_model_state_dict`` when the run keeps a weight EMA. Discovery follows the JAX package's
``utils/checkpoint.py:find_checkpoint``: an explicit epoch, else the rolling
file, else the newest periodic one.

A latent diffusion model's frozen VQ-VAE (``--vqvae_checkpoint``) is a
``.pth`` whose ``model_state_dict`` holds monai-generative ``VQVAE`` keys,
with the run's ``vqvae_config.json`` (the model's constructor arguments)
beside it: ``load_vqvae_checkpoint`` reads both and
``save_vqvae_checkpoint`` writes both. The VQ-VAE trainer's files hold
{epoch, global_step, best_loss, model_state_dict, discriminator_state_dict,
optimizer_g_state_dict, optimizer_d_state_dict}.

The JAX package's own checkpoints are Orbax directories. Reading them needs
orbax, which the port does not use; convert them on a host with JAX
(``utils.convert.jax_unet_params_to_state_dict``) and save a ``.pth``.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional, Tuple

import torch

_PERIODIC_RE = re.compile(r"^checkpoint_(\d+)\.pth$")
_ORBAX_RE = re.compile(r"^checkpoint(_\d+)?$")


def find_checkpoint(run_dir: str | Path, epoch: Optional[int] = None) -> Optional[Path]:
    run_dir = Path(run_dir)
    if epoch is not None:
        p = run_dir / f"checkpoint_{int(epoch)}.pth"
        return p if p.is_file() else None
    rolling = run_dir / "checkpoint.pth"
    if rolling.is_file():
        return rolling
    periodic = []
    if run_dir.is_dir():
        for child in run_dir.iterdir():
            m = _PERIODIC_RE.match(child.name)
            if m and child.is_file():
                periodic.append((int(m.group(1)), child))
    return max(periodic)[1] if periodic else None


def missing_checkpoint_error(run_dir: str | Path) -> FileNotFoundError:
    """The error for a run without a .pth checkpoint; it names Orbax
    directories it found, which the port cannot read."""
    run_dir = Path(run_dir)
    orbax = sorted(c.name for c in run_dir.iterdir()
                   if c.is_dir() and _ORBAX_RE.match(c.name)) if run_dir.is_dir() else []
    msg = f"Failed to find a saved model checkpoint (.pth) under {run_dir}."
    if orbax:
        msg += (f" Found Orbax checkpoint director{'ies' if len(orbax) > 1 else 'y'} "
                f"{orbax}: the PyTorch port cannot read Orbax. On a host with JAX, "
                "restore its model_state_dict, convert it with "
                "ddpm_ood_tpu_torch.utils.convert.jax_unet_params_to_state_dict and "
                "save it with torch.save as checkpoint.pth in the reference schema.")
    return FileNotFoundError(msg)


def write_checkpoint(path: str | Path, payload: dict) -> Path:
    """torch.save to a temporary name, then an atomic rename: a reader (or a
    resume after a crash) never sees a torn file."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str | Path) -> dict:
    """The payload on the CPU; tensors only, no pickled code."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(path: str | Path, model_state_dict: dict, epoch: int = 0,
                    ema_model_state_dict: Optional[dict] = None) -> None:
    """Write a reference-schema checkpoint of weights only (scoring needs no
    optimizer state: that slot is empty, the step count and loss are 0 and
    the reference's initial best loss)."""
    payload = {
        "epoch": int(epoch),
        "global_step": 0,
        "model_state_dict": model_state_dict,
        "optimizer_state_dict": {},
        "best_loss": 1000.0,
    }
    if ema_model_state_dict is not None:
        payload["ema_model_state_dict"] = ema_model_state_dict
    write_checkpoint(path, payload)


VQVAE_CONFIG = "vqvae_config.json"


def write_vqvae_config(run_dir: str | Path, config: dict) -> Path:
    """``<run_dir>/vqvae_config.json`` as the JAX package writes it (indent
    2, tuples as lists), replaced atomically."""
    path = Path(run_dir) / VQVAE_CONFIG
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(config, indent=2, default=str))
    os.replace(tmp, path)
    return path


def save_vqvae_checkpoint(path: str | Path, config: dict, payload: dict) -> Path:
    """Write a VQ-VAE checkpoint that ``load_vqvae_checkpoint`` reads: the
    ``.pth`` `payload` (its ``model_state_dict`` in monai-generative keys)
    and `config` as ``vqvae_config.json`` beside it."""
    if "model_state_dict" not in payload:
        raise ValueError("a VQ-VAE checkpoint payload needs its model_state_dict")
    write_vqvae_config(Path(path).parent, config)
    return write_checkpoint(path, payload)


def load_vqvae_checkpoint(path: str | Path) -> Tuple[dict, dict]:
    """(config, state_dict) of a VQ-VAE checkpoint: the ``vqvae_config.json``
    beside `path` (list-valued entries as tuples) and the ``.pth``'s
    ``model_state_dict`` (or the whole file, for a bare state_dict)."""
    path = Path(path)
    cfg_path = path.parent / VQVAE_CONFIG
    if not path.is_file():
        raise FileNotFoundError(
            f"Cannot find VQ-VAE checkpoint {path} (the port reads a .pth; convert an Orbax "
            "directory with ddpm_ood_tpu_torch.utils.convert.jax_vqvae_params_to_state_dict)")
    if not cfg_path.is_file():
        raise FileNotFoundError(f"Cannot find VQ-VAE config {cfg_path}")
    config = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
              if isinstance(v, list) else v
              for k, v in json.loads(cfg_path.read_text()).items()}
    payload = load_checkpoint(path)
    return config, payload.get("model_state_dict", payload)
