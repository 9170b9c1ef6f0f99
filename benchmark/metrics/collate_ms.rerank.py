"""collate_ms.rerank: the mean duration of the program's ``score.collate``
spans that end in the traced window: ``CrossScorer.block`` padding one
block of pairs on the host, in ms."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def read(run):
    return feed.mean_ms(run, "score.collate")
