"""The readers of the program's own spans and counters
(``lightningdot_tpu_torch/utils/tracing.py``) on the CPU: a tiny traced
run of each cell reports them; a program that records nothing, or has no
such module, leaves them out; the idle split weighs idle time by the span
the launching thread was in."""
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import tiny
from harness import core
from harness.trace import TraceData
from lightningdot_tpu_torch.utils import tracing

SEED = 2 ** 31 + 4093
ROOT = Path(__file__).resolve().parents[2]
NEW = {"tiny.train": ["loader_wait_ms.train", "collate_ms.train",
                      "feed_idle.train", "step_idle.train",
                      "pad_share.train"],
       "tiny.rerank": ["collate_ms.rerank", "pad_share.rerank"]}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny benchmark with the seven readers, each on its tiny cell."""
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = []
    for m in doc["per_layer"]:
        for cell, names in NEW.items():
            if m["name"] in names:
                metrics.append(dict(m, workloads=[cell]))
    assert len(metrics) == 7
    return tiny.make(tmp_path_factory.mktemp("spans"), {}, metrics)


def _traced(bench, name):
    cell = core.Cell(name, bench_dir=bench)
    result, _, run = core.run_cell(cell, SEED, 0.5, True, "cpu")
    assert result["correct"], result["check"]
    return result, run


@pytest.mark.parametrize("name", list(NEW))
def test_traced_run_reports_the_program_span_metrics(bench, name):
    result, run = _traced(bench, name)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert sorted(got) == sorted(NEW[name])
    assert all(math.isfinite(v) and v >= 0 for v in got.values())
    if name == "tiny.train":
        idle = 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
        assert got["feed_idle.train"] + got["step_idle.train"] <= idle + 1e-9
        assert 0 < got["pad_share.train"] < 100
        assert got["collate_ms.train"] > 0
    else:
        assert 0 < got["pad_share.rerank"] < 100


@pytest.mark.parametrize("name", list(NEW))
@pytest.mark.parametrize("how", ["records_nothing", "no_module"])
def test_readers_return_none_without_program_records(bench, monkeypatch,
                                                     name, how):
    if how == "records_nothing":
        monkeypatch.setattr(tracing, "span", lambda *a, **k: tracing._OFF)
    else:                       # as the parent commit, which lacks it
        import lightningdot_tpu_torch.utils as utils
        monkeypatch.delattr(utils, "tracing")
        monkeypatch.setitem(sys.modules, "lightningdot_tpu_torch.utils."
                            "tracing", None)
    tracing.clear()
    result, _ = _traced(bench, name)
    assert not set(result["metrics"]) & set(NEW[name])


def _rec(index, name, start, end, parent=None, thread=1, counts=None):
    return tracing.Record(name, index, parent, thread, index, start, end,
                          counts or {})


def test_idle_split_weighs_idle_time_by_the_innermost_span(bench,
                                                           monkeypatch):
    """Window 0-1000 ns; the card runs 100-300 and 600-900, so it idles
    0-100, 300-600 and 900-1000. The launching thread waits on the loader
    (50-150), stages (150-200), then steps 200-700 (its forward 250-550);
    another thread's collate (0-1000) does not count."""
    recs = [_rec(0, "loader.wait", 50, 150), _rec(1, "stage", 150, 200),
            _rec(2, "step", 200, 700), _rec(3, "step.forward", 250, 550, 2),
            _rec(4, "loader.collate", 0, 1000, thread=2,
                 counts={"positions": 40, "real_positions": 30})]
    monkeypatch.setattr(tracing, "records", lambda: recs)
    monkeypatch.setattr(tracing, "wall_offset_ns", lambda: 0)
    run = SimpleNamespace(
        trace=TraceData([("k", 100, 300), ("k", 600, 900)],
                        [("window", 0, 1000)]),
        work={"steps": 2})
    cell = core.Cell("tiny.train", bench_dir=bench)
    read = {m: cell.reader(m).read(run) for m in NEW["tiny.train"]}
    # idle 50-100 in loader.wait; 300-550 in step.forward, 550-600 in step
    assert read["feed_idle.train"] == pytest.approx(5.0)
    assert read["step_idle.train"] == pytest.approx(30.0)
    assert read["loader_wait_ms.train"] == pytest.approx(100 / 1e6 / 2)
    assert read["collate_ms.train"] == pytest.approx(1000 / 1e6)
    assert read["pad_share.train"] == pytest.approx(25.0)
