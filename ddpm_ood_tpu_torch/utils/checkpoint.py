"""Find and load reference-schema ``.pth`` checkpoints.

The reference (and the port) saves ``checkpoint.pth`` (the rolling best)
and periodic ``checkpoint_{N}.pth`` files, each a dict {epoch,
global_step, model_state_dict, optimizer_state_dict, best_loss} plus an
optional ``ema_model_state_dict``. Discovery follows the JAX package's
``utils/checkpoint.py:find_checkpoint``: an explicit epoch, else the rolling
file, else the newest periodic one.

The JAX package's own checkpoints are Orbax directories. Reading them needs
orbax, which the port does not use; convert them on a host with JAX
(``utils.convert.jax_unet_params_to_state_dict``) and save a ``.pth``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

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
    torch.save(payload, path)
