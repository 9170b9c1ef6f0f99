"""Graceful preemption for the long-running drivers (the port's copy of
lightningdot_tpu/utils/preemption.py:23-112).

A preemptible host gets SIGTERM with a short grace window.
:class:`PreemptionGuard` turns the signal into a flag that the training
loop checks at update boundaries: the loop checkpoints once more and exits
cleanly, and auto-resume continues from that step on the next start.

Across processes the flag is OR-reduced (:func:`~lightningdot_tpu_torch.
utils.misc.host_all_gather`), so that every rank leaves at the same
boundary; saving stays rank 0's (its weights are every rank's).
"""
from __future__ import annotations

import signal
import threading
from typing import Optional

from lightningdot_tpu_torch.parallel.mesh import process_count
from lightningdot_tpu_torch.utils.logging import LOGGER
from lightningdot_tpu_torch.utils.misc import host_all_gather


class PreemptionGuard:
    """Context manager: latch SIGTERM-style signals into a flag.

    Signal handlers install only from the main thread; elsewhere (a driver
    called from a worker thread in tests) the guard is a flag that
    ``sim_after_step`` trips.
    """

    def __init__(self, signals=(signal.SIGTERM,),
                 sim_after_step: Optional[int] = None,
                 check_every: int = 1):
        self.signals = signals
        self.requested = False
        # fault injection: trip the guard once global_step reaches this
        # value, as if signalled
        self.sim_after_step = sim_after_step
        # the cadence of the OR-reduce across processes: once every
        # ``check_every`` steps, so that the hot loop pays no collective
        # per step (the reference gathers once per accumulation window,
        # pretrain.py:392)
        self.check_every = max(int(check_every), 1)
        self._old = {}
        self._depth = 0

    def _handler(self, signum, frame):
        LOGGER.warning("signal %d: finishing the current update, "
                       "checkpointing, and exiting", signum)
        self.requested = True

    def check(self, global_step: int) -> bool:
        """True once preemption was requested (or simulated) on ANY
        process. Signals land on the ranks tens of ms apart, and a rank
        that left alone would leave the others waiting in the next step's
        collectives: across processes the flag is OR-reduced every
        ``check_every`` steps, and between those boundaries a local latch
        is not acted on. One process acts at once."""
        if (self.sim_after_step is not None
                and global_step >= self.sim_after_step):
            self.requested = True
        if process_count() > 1:
            if global_step % self.check_every:
                return False   # act only at the shared boundaries
            self.requested = any(host_all_gather(self.requested))
        return self.requested

    def sync(self) -> bool:
        """The OR-reduce now, whatever the cadence: for epoch and run
        boundaries that every process reaches together (a latch after the
        last boundary would otherwise split the ranks). One collective per
        call: keep it out of per-step loops."""
        if process_count() > 1:
            self.requested = any(host_all_gather(self.requested))
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
