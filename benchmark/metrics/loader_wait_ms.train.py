"""loader_wait_ms.train: the time the launching thread (the thread of the
program's ``step`` spans) spent in the program's ``loader.wait`` spans,
blocked on the loader's queue, inside the traced window, over the steps
of the window: ms a step waited for its batch."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def read(run):
    spans = feed.program_spans(run)
    steps = run.work.get("steps")
    if spans is None or not steps:
        return None
    thread = feed.launching_thread(spans, "step")
    if thread is None:
        return None
    w0, w1 = run.trace.window
    waited = sum(min(s.end, w1) - max(s.start, w0) for s in spans
                 if s.name == "loader.wait" and s.thread == thread)
    return waited / 1e6 / steps
