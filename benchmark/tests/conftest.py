"""The benchmark's CPU tests: the harness, the readers and the references
at small sizes, without a card, nvcc or triton."""
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

NEW_METRIC = '''"""calls_counted: a reader added as a file of its own."""


def read(run):
    return float(len(run.calls)) if run.calls else None
'''


@pytest.fixture(scope="session")
def bench(tmp_path_factory):
    """The benchmark with the small configurations, mixes, cells and one
    more metric added as new files only (``tiny.py``)."""
    import tiny
    extra = {"metrics/calls_counted.py": NEW_METRIC}
    metric = {"name": "calls_counted", "unit": "calls", "better": "higher",
              "source": "host_clock", "layer": "harness",
              "moves": "setup_s", "workloads": list(tiny.CELLS)}
    probe = {"name": "host_enqueue_ms.train", "unit": "ms",
             "better": "lower", "source": "host_clock",
             "layer": "training step on the host", "moves": "setup_s",
             "workloads": ["tiny.train"]}
    return tiny.make(tmp_path_factory.mktemp("b"), extra, [metric, probe])
