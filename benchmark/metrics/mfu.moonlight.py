"""mfu.moonlight: the model FLOPs of the Moonlight cell's training steps in
the traced window over the window's length, as a share of one H100's bf16
peak (989 TFLOP/s), in percent. FLOPs count real tokens only
(``harness/counts_moe.py``: the text tower's projections, its causal
attention pairs, its dense layer, shared experts and router, the routed
experts' work by the ``routed_rows`` the program's ``moe.route`` spans
count; the image tower and both score matrices as ``mfu.train`` counts
them), the backward at twice the forward; padding and the routed experts'
recomputation are not counted."""
from pathlib import Path

from harness import counts, counts_moe
from harness.core import load_module
from harness.roofline import PEAK_OPS

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def routed_rows(run):
    """The routed rows the window's forward ``moe.route`` spans counted,
    or None where the program counted none."""
    spans = feed.ending_in_window(run, "moe.route")
    rows = [s.counts["routed_rows"] for s in spans or ()
            if "routed_rows" in s.counts]
    return sum(rows) if rows else None


def read(run):
    if not run.calls or not run.window_s:
        return None
    routed = routed_rows(run)
    if routed is None:
        return None
    cfg = run.config
    pd = cfg["project_dim"]
    flops = 0.0
    for call in run.calls:
        n = len(call["txt_lens"])
        flops += (counts_moe.text_forward_flops(call["txt_lens"], cfg, 0.0,
                                                pd)
                  + counts.tower_flops(call["img_lens"], cfg["image"], pd,
                                       regions=True)
                  + 2 * 2.0 * n * n * pd)
    flops += counts_moe.swiglu_flops(routed, cfg["hidden_size"],
                                     cfg["moe_intermediate_size"])
    return 100.0 * 3.0 * flops / run.window_s / PEAK_OPS["bf16"]
