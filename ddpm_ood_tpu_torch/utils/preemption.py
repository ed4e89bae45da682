"""Preemption-graceful training.

Port of ``ddpm_ood_tpu/utils/preemption.py`` (stdlib only). A SIGTERM
finishes the current epoch, writes the periodic checkpoint
``checkpoint_{epoch+1}`` and ends training normally, so the process exits 0.
Rerunning the same command resumes: discovery takes the rolling best
``checkpoint`` first, as the reference does; resume at the preemption point
with ``--ddpm_checkpoint_epoch=<epoch+1>`` (the number is in the log line).
Under torchrun a stop asked of any process stops them all after the same
epoch, since the checkpoint is written by all of them together.
"""

from __future__ import annotations

import logging
import signal

log = logging.getLogger(__name__)


class PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._prev = {}

    def install(self, signals=(signal.SIGTERM,)) -> "PreemptionGuard":
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread (tests drive trainers directly)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()

    def _handler(self, signum, frame):
        log.info(f"signal {signum}: finishing the current epoch, then checkpointing and "
                 "exiting cleanly (preemption-graceful stop)")
        self.requested = True


def checkpoint_if_preempted(guard: PreemptionGuard, trainer, epoch: int, args) -> bool:
    """On a requested stop, write the periodic checkpoint (unless this epoch's
    periodic save just wrote it) and return True so the epoch loop breaks."""
    from ..parallel.mesh import any_process

    if not any_process(guard.requested, trainer.device):
        return False
    if (epoch + 1) % args.checkpoint_every != 0:
        trainer.save_checkpoint(f"checkpoint_{epoch + 1}", epoch,
                                f"Preempted: checkpointed epoch {epoch + 1}, exiting")
    return True
