"""expert_imbalance.moonlight: how unevenly the router loads the card's
held experts: the mean over the traced window's forward ``moe.route``
spans (each MoE layer of each step) of max_expert_rows / (routed_rows /
held experts), from the counters the program puts on the span; 1 is an
even load."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def read(run):
    spans = feed.ending_in_window(run, "moe.route")
    held = run.config["n_routed_experts"]
    ratios = [s.counts["max_expert_rows"] * held / s.counts["routed_rows"]
              for s in spans or ()
              if s.counts.get("routed_rows")]
    return sum(ratios) / len(ratios) if ratios else None
