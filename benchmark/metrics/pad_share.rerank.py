"""pad_share.rerank: the share of the joint positions that
``CrossScorer.block`` padded, over the program's ``score.collate`` spans
that end in the traced window: 100 (1 - real_positions / positions), in
percent; the copies that fill a short block count as padding."""
from pathlib import Path

from harness.core import load_module

feed = load_module(Path(__file__).with_name("feed_idle.train.py"),
                   "bench_metric_feed_idle.train")


def read(run):
    return feed.pad_share(run, "score.collate")
