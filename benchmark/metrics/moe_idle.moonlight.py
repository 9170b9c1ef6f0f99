"""moe_idle.moonlight: the share of the traced window in which nothing ran
on the card while a thread that launches the text tower's work (the step's,
or autograd's in the backward) was, innermost, in one of the program's
``moe.*`` spans (routing, experts, shared experts, combining); in percent,
the pieces of all such threads joined before they meet the idle gaps."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def read(run):
    spans = feed.program_spans(run)
    if spans is None or not any(s.name.startswith("moe.") for s in spans):
        return None
    pieces = []
    for thread in {s.thread for s in spans if s.name.startswith("moe.")}:
        pieces += [(a, b) for a, b, n in feed.innermost(
            [s for s in spans if s.thread == thread]) if n.startswith("moe.")]
    merged = []
    for a, b in sorted(pieces):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    overlap = 0
    for ga, gb in feed.idle_gaps(run):
        for a, b in merged:
            if a < gb and b > ga:
                overlap += min(b, gb) - max(a, ga)
    w0, w1 = run.trace.window
    return 100.0 * overlap / (w1 - w0)
