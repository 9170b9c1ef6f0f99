"""Small stand-ins for the readers' tests."""
from types import SimpleNamespace

from harness.trace import TraceData


def run_stub(config, device, calls, window_ns=None):
    """A run whose traced window holds ``device`` events."""
    end = window_ns or max(e for _, _, e in device) + 1
    return SimpleNamespace(config=config, calls=calls,
                           trace=TraceData(device, [("window", 0, end)]),
                           settings={"compute_dtype": "f32"},
                           window_s=end / 1e9)
