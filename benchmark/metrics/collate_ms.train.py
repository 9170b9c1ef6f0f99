"""collate_ms.train: the mean duration of the program's ``loader.collate``
spans that end in the traced window: a loader thread fetching a batch's
items and collating them (``data/itm.py::itm_fast_collate``), in ms."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def read(run):
    return feed.mean_ms(run, "loader.collate")
