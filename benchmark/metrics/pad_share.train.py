"""pad_share.train: the share of the text and image positions that the
collate padded, over the program's ``loader.collate`` spans that end in the
traced window: 100 (1 - real_positions / positions), from the counters
``data/itm.py::itm_fast_collate`` puts on the span, in percent."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def read(run):
    return feed.pad_share(run, "loader.collate")
