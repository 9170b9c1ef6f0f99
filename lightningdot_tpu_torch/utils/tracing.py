"""Spans and counters inside the port, on the device trace's clock (nearest
counterpart: lightningdot_tpu/utils/profiling.py, which wraps a region in a
JAX profiler trace).

``span(name, id=None)`` times a region of the program; ``count(name, n)``
adds to a counter of the innermost open span on the calling thread, so that
counts are taken at the same boundary as the time. Each record holds the
span's name, its index, the index of its parent (the span open around it on
the same thread, or None), the thread, an identifier shared by the spans of
one batch or call (given, else the parent's, else the span's own index),
its start and end in ``time.perf_counter_ns`` and its counters.

Spans record only while ``torch.profiler`` is recording (one read of
``torch.autograd.profiler._is_profiler_enabled``) or inside
:func:`recording`; otherwise a span is a shared do-nothing context. So the
spans exist exactly where a device trace does. ``wall_offset_ns()`` moves a
record onto the clock of the profiler's device events (``time.time_ns``).
Records are kept in memory, at most ``CAPACITY``; once full, the oldest
are dropped and counted (:func:`dropped`).

The kernel wrappers of ``ops/`` count their launches here
(:func:`launched`): a total per kernel, which ``ops.launch_counts`` reads,
and ``launches`` on the spans open meanwhile. A span's ``launches`` are
those made while it was open, from any thread, and are kept on the spans
of threads that launch kernels themselves: a backward on the card
launches from autograd's device thread while its caller waits inside a
span, and a loader thread's span holds none of the launching thread's.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 65536


class Record(NamedTuple):
    name: str
    index: int
    parent: Optional[int]
    thread: int
    id: int
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []       # this thread's open spans, innermost last
        self.launcher = False       # this thread has launched a kernel


class _State:
    def __init__(self, capacity: int = CAPACITY):
        self.lock = threading.Lock()
        self.records: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.indices = itertools.count()
        self.forced = 0
        self.launches: Dict[str, int] = {}
        self.launch_total = 0       # never reset: spans take differences
        self.local = _Local()


_STATE = _State()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "id", "index", "parent", "counts", "start",
                 "launch0")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        stack = _STATE.local.stack
        outer = stack[-1] if stack else None
        self.index = next(_STATE.indices)
        self.parent = outer.index if outer is not None else None
        if self.id is None:
            self.id = outer.id if outer is not None else self.index
        self.counts: Dict[str, int] = {}
        self.launch0 = _STATE.launch_total
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _STATE.local.stack.pop()
        launches = _STATE.launch_total - self.launch0
        if launches and _STATE.local.launcher:
            self.counts["launches"] = launches
        record = Record(self.name, self.index, self.parent,
                        threading.get_ident(), self.id, self.start, end,
                        self.counts)
        with _STATE.lock:
            if len(_STATE.records) == _STATE.records.maxlen:
                _STATE.dropped += 1
            _STATE.records.append(record)
        return False


def span(name: str, id: Optional[int] = None):
    """A context that records ``name`` while recording is on (see the
    module's docstring); ``id`` ties the spans of one batch or call."""
    if _profiler._is_profiler_enabled or _STATE.forced:
        return _Span(name, id)
    return _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span on this
    thread; nothing if none is open. ``n`` may be a count the device holds
    (a tensor): it is added on the device, and read as an int only by
    :func:`records`, so that counting waits for nothing."""
    stack = _STATE.local.stack
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def launched(kernel: str) -> None:
    """One launch of ``kernel`` by its wrapper in ``ops/``."""
    state = _STATE
    state.launches[kernel] = state.launches.get(kernel, 0) + 1
    state.launch_total += 1
    state.local.launcher = True


def launch_counts() -> Dict[str, int]:
    """{kernel: launches since the last reset}, the kernels launched."""
    return dict(_STATE.launches)


def reset_launch_counts() -> None:
    _STATE.launches.clear()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this context whether or not a profiler runs."""
    with _STATE.lock:
        _STATE.forced += 1
    try:
        yield
    finally:
        with _STATE.lock:
            _STATE.forced -= 1


def records() -> List[Record]:
    """The finished spans kept, in the order they began."""
    with _STATE.lock:
        out = list(_STATE.records)
    out = [r if all(isinstance(v, int) for v in r.counts.values()) else
           r._replace(counts={k: int(v) for k, v in r.counts.items()})
           for r in out]
    return sorted(out, key=lambda r: r.index)


def dropped() -> int:
    """Records dropped since the last :func:`clear` because the buffer was
    full."""
    return _STATE.dropped


def clear() -> None:
    """Forget the records kept and the count of those dropped."""
    with _STATE.lock:
        _STATE.records.clear()
        _STATE.dropped = 0


def wall_offset_ns() -> int:
    """Add to a record's ``start_ns`` or ``end_ns`` to put it on the clock
    of torch.profiler's device events (``time.time_ns``)."""
    return time.time_ns() - time.perf_counter_ns()
