"""Graceful preemption for the long-running drivers (the port's copy of
lightningdot_tpu/utils/preemption.py:23-112, for one process).

A preemptible host gets SIGTERM with a short grace window.
:class:`PreemptionGuard` turns the signal into a flag that the training
loop checks at update boundaries: the loop checkpoints once more and exits
cleanly, and auto-resume continues from that step on the next start.

The JAX guard OR-reduces the flag across hosts, so that every host leaves
at the same boundary. That reduce comes with multi-GPU training (ROADMAP
A11): where ``torch.distributed`` runs more than one process, the guard
raises instead of acting for one host alone.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional

import torch

from lightningdot_tpu_torch.utils.logging import LOGGER


def _single_process() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "PreemptionGuard across processes needs the multi-host "
            "OR-reduce of the flag, which comes with multi-GPU training "
            "(ROADMAP A11)")


class PreemptionGuard:
    """Context manager: latch SIGTERM-style signals into a flag.

    Signal handlers install only from the main thread; elsewhere (a driver
    called from a worker thread in tests) the guard is a flag that
    ``sim_after_step`` trips. One process acts on every check; the JAX
    guard's multi-host cadence (``check_every``) comes with its reduce
    (ROADMAP A11).
    """

    def __init__(self, signals=(signal.SIGTERM,),
                 sim_after_step: Optional[int] = None):
        self.signals = signals
        self.requested = False
        # fault injection: trip the guard once global_step reaches this
        # value, as if signalled
        self.sim_after_step = sim_after_step
        self._old = {}
        self._depth = 0

    def _handler(self, signum, frame):
        LOGGER.warning("signal %d: finishing the current update, "
                       "checkpointing, and exiting", signum)
        self.requested = True

    def check(self, global_step: int) -> bool:
        """True once preemption was requested (or simulated); on one
        process the flag acts at once."""
        if (self.sim_after_step is not None
                and global_step >= self.sim_after_step):
            self.requested = True
        _single_process()
        return self.requested

    def sync(self) -> bool:
        """The flag at a boundary that every process reaches together (the
        JAX guard forces its OR-reduce here)."""
        _single_process()
        return self.requested

    def __enter__(self) -> "PreemptionGuard":
        """Re-entrant: a driver installs ONE guard at the top of main() (so
        a signal during set-up is latched, not fatal) and re-enters the
        same object around the hot loop."""
        self._depth += 1
        if (self._depth == 1
                and threading.current_thread() is threading.main_thread()):
            for sig in self.signals:
                self._old[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        self._depth -= 1
        if self._depth > 0:
            return
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old.clear()
