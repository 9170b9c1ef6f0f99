"""step_idle.train: the share of the traced window in which nothing ran on
the card while the launching thread was, innermost, in the program's
``step`` span or one of its phases; in percent, weighted by time, as
``feed_idle.train`` takes it."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")
STEP = {"step", "step.to_device", "step.forward", "step.kd", "step.backward",
        "step.optimizer"}


def read(run):
    return feed.idle_share(run, "step", STEP)
