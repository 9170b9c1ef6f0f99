"""feed_idle.train: the share of the traced window in which nothing ran on
the card while the launching thread (the thread of the program's ``step``
spans) was, innermost, in the program's ``loader.wait`` or ``stage`` span:
waiting on the loader's queue, or pinning and copying the next batch; in
percent, weighted by time. Device idle time is the window less the union of
its kernels, copies and memsets, as ``device_idle.train`` takes it.

The program's spans and counters are those of
``lightningdot_tpu_torch/utils/tracing.py``, recorded while the traced
window's profiler runs; this file also holds what the other readers of
them share. Each returns None where the program recorded nothing (a
program without that module records nothing).
"""
from collections import Counter, namedtuple

Span = namedtuple("Span", "name thread start end counts")


def program_spans(run):
    """The program's spans that overlap the traced window, on the
    profiler's clock, or None."""
    if run.trace is None:
        return None
    try:
        from lightningdot_tpu_torch.utils import tracing
    except ImportError:
        return None
    off = tracing.wall_offset_ns()
    w0, w1 = run.trace.window
    spans = [Span(r.name, r.thread, r.start_ns + off, r.end_ns + off,
                  r.counts) for r in tracing.records()]
    return [s for s in spans if s.end > w0 and s.start < w1] or None


def ending_in_window(run, name):
    """The spans ``name`` that end inside the traced window, or None."""
    spans = program_spans(run)
    if spans is None:
        return None
    w0, w1 = run.trace.window
    return [s for s in spans if s.name == name and w0 < s.end <= w1] or None


def mean_ms(run, name):
    """The mean duration of the spans ``name`` ending in the window."""
    spans = ending_in_window(run, name)
    if spans is None:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) / 1e6


def pad_share(run, name):
    """100 (1 - real positions / positions) over the spans ``name`` ending
    in the window."""
    spans = ending_in_window(run, name)
    total = sum(s.counts.get("positions", 0) for s in spans or ())
    if not total:
        return None
    real = sum(s.counts.get("real_positions", 0) for s in spans)
    return 100.0 * (1.0 - real / total)


def launching_thread(spans, root):
    """The thread of most of the spans ``root``, or None."""
    threads = Counter(s.thread for s in spans if s.name == root)
    return threads.most_common(1)[0][0] if threads else None


def innermost(spans):
    """(start, end, name) pieces of time, each with the innermost of the
    nested ``spans`` (one thread's) open over it."""
    out, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1][0] <= s.start:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack:
            out.append((t, s.start, stack[-1][1]))
        stack.append((s.end, s.name))
        t = s.start
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [p for p in out if p[1] > p[0]]


def idle_gaps(run):
    """(start, end) of each stretch of the window with nothing on the
    card."""
    w0, w1 = run.trace.window
    gaps, reach = [], w0
    for s, e in sorted((s, e) for _, s, e in run.trace.device):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if w1 > reach:
        gaps.append((reach, w1))
    return gaps


def idle_share(run, root, names):
    """The share of the window, in percent, in which the card idled while
    the innermost program span of ``root``'s thread was one of ``names``."""
    spans = program_spans(run)
    if spans is None:
        return None
    thread = launching_thread(spans, root)
    if thread is None:
        return None
    pieces = [(a, b) for a, b, n in innermost(
        [s for s in spans if s.thread == thread]) if n in names]
    gaps, overlap, i = idle_gaps(run), 0, 0
    for a, b in pieces:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            overlap += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    w0, w1 = run.trace.window
    return 100.0 * overlap / (w1 - w0)


def read(run):
    return idle_share(run, "step", {"loader.wait", "stage"})
