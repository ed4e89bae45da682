"""``--profile_dir``: a ``torch.profiler`` trace of a short window of work.

``start_trace`` records host events, and on a CUDA device also the card's
kernels (the port's ctypes-launched kernels among them); ``stop_trace``
waits for the device, stops, and writes the trace as Chrome JSON
(``<profile_dir>/<name>.pt.trace.json``, readable by Perfetto or
chrome://tracing).
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

log = logging.getLogger(__name__)


def start_trace(device: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, device: torch.device, profile_dir,
               name: str) -> Path:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path = Path(profile_dir) / f"{name}.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    log.info(f"Wrote the profiler trace {path}")
    return path
