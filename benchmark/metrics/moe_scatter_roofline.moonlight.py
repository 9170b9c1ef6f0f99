"""moe_scatter_roofline.moonlight: ``csrc/moe_gemm.cu``'s kernel that copies
each row's cotangent (backward: the routed rows, and the real rows of the
shared experts and the dense layer) in the traced window: the least time
their bytes need on one H100 at 3.35 TB/s
(``harness/counts_moe.py::step_scatter_bytes``; the routed rows from the
program's ``moe.route`` counters) over their device time, in percent."""
from pathlib import Path

from harness import counts_moe
from harness.core import load_module
from harness.roofline import HBM_BYTES_PER_S

mfu = load_module(Path(__file__).with_name("mfu.moonlight.py"),
                  "bench_metric_mfu.moonlight")
PATTERN = r"scatter_rows_kernel\("


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
    nbytes = sum(counts_moe.step_scatter_bytes(int(sum(c["txt_lens"])),
                                               rows, run.config)
                 for c in run.calls)
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
