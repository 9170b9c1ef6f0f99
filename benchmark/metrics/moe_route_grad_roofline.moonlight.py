"""moe_route_grad_roofline.moonlight: ``csrc/moe_gemm.cu``'s routing-weight
gradient kernel (backward) in the traced window: the least time their bytes
need on one H100 at 3.35 TB/s (``harness/counts_moe.py::route_grad_bytes``;
the routed rows from the program's ``moe.route`` counters) over their device
time, in percent."""
from pathlib import Path

from harness import counts_moe
from harness.core import load_module
from harness.roofline import HBM_BYTES_PER_S

mfu = load_module(Path(__file__).with_name("mfu.moonlight.py"),
                  "bench_metric_mfu.moonlight")
PATTERN = r"route_grad_kernel\("


def read(run):
    if run.trace is None or not run.calls:
        return None
    seconds, launches = run.trace.seconds_matching(PATTERN)
    if not launches:
        return None
    routed = mfu.routed_rows(run)
    if routed is None:
        return None
    calls = len(run.calls) * counts_moe.n_moe(run.config)
    rows = routed / calls
    nbytes = sum(counts_moe.n_moe(run.config) * counts_moe.route_grad_bytes(
        c["txt_shape"][0] * c["txt_shape"][1], rows, run.config)
        for c in run.calls)
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
