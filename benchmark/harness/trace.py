"""Host spans and the device trace of a traced window.

The benchmark records its own spans around the calls it makes into the
program (``Spans``). A traced run records the device's activity with
torch.profiler, whose timestamps are on the wall clock; the spans are put
on that clock, so that the device's idle gaps can be labelled by the span
the host was in.
:func:`union_seconds` is a frozen copy of the interval union of
``chip_smoke.py::_device_stats``: the device is busy while any kernel, copy
or memset runs.
"""
from __future__ import annotations

import re
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

TOP = 10            # entries of each breakdown list
NAME_CHARS = 120    # a device operation's name is cut to this


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    busy_ns, reach = 0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy_ns += end - max(start, reach)
            reach = end
    return busy_ns / 1e9


class Spans:
    """The benchmark's host spans: (name, start, end) in nanoseconds of
    ``time.perf_counter_ns``. :meth:`on_wall_clock` gives them on the
    clock of the profiler's device events (``time.time_ns``)."""

    def __init__(self):
        self.records: List[Tuple[str, int, int]] = []
        self._offset = time.time_ns() - time.perf_counter_ns()

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter_ns()))

    def on_wall_clock(self) -> List[Tuple[str, int, int]]:
        return [(n, t0 + self._offset, t1 + self._offset)
                for n, t0, t1 in self.records]


class TraceData:
    """What a traced window left: device events and the benchmark's spans,
    (name, start_ns, end_ns) on the profiler's clock, and the window."""

    def __init__(self, device, spans):
        self.spans = spans
        windows = [(s, e) for n, s, e in spans if n == "window"]
        if not windows:
            raise RuntimeError("the trace holds no window span")
        self.window = windows[0]
        w0, w1 = self.window
        # clipped to the window: work queued before it or after it is not
        # the window's
        self.device = [(n, max(s, w0), min(e, w1)) for n, s, e in device
                       if e > w0 and s < w1]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return union_seconds((s, e) for _, s, e in self.device)

    def seconds_matching(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose names match
        the regular expression."""
        rx = re.compile(pattern)
        hits = [(e - s) for n, s, e in self.device if rx.search(n)]
        return sum(hits) / 1e9, len(hits)

    def device_ops(self) -> List[list]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The longest gaps in which nothing ran on the device, each named
        by the innermost span open on the host when it began."""
        w0, w1 = self.window
        gaps, reach = [], w0
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > reach:
                gaps.append((s - reach, reach))
            reach = max(reach, e)
        if w1 > reach:
            gaps.append((w1 - reach, reach))
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:TOP]:
            open_ = [(s, n) for n, s, e in self.spans
                     if n != "window" and s <= at < e]
            out.append([max(open_)[1] if open_ else "window", length / 1e9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


class DeviceTrace:
    """torch.profiler over a window, device activity only: the host's
    operators are not recorded, so that tracing does not slow the host
    that paces what the device is given."""

    def __init__(self, on_card: bool = True):
        from torch.profiler import ProfilerActivity, profile
        # without a card there is no device activity to record (CPU tests)
        self._prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                         else ProfilerActivity.CPU])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def data(self, spans: Spans) -> TraceData:
        """The device's kernels, copies and memsets, with ``spans``."""
        device = [(ev.name(), ev.start_ns(), ev.end_ns())
                  for ev in self._prof.profiler.kineto_results.events()
                  if str(ev.device_type()) == "DeviceType.CUDA"]
        return TraceData(device, spans.on_wall_clock())
