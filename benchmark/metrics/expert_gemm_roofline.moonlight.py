"""expert_gemm_roofline.moonlight: the grouped SwiGLU GEMMs of
``csrc/moe_gemm.cu`` (the dense layer, the shared experts and the held
routed experts, forward, recomputation and backward) in the traced window:
the least time their work needs on one H100 (``harness/roofline.py``; each
GEMM bound by its bytes at 3.35 TB/s or its operations at the bf16 peak,
989 TFLOP/s; ``harness/counts_moe.py::step_gemms``, the routed rows from
the program's ``moe.route`` counters, spread evenly over the steps; the
dense layer's and the shared experts' rows are the real tokens) over their
device time, in percent."""
from pathlib import Path

from harness import counts_moe
from harness.core import load_module
from harness.roofline import PEAK_OPS, bound_s

mfu = load_module(Path(__file__).with_name("mfu.moonlight.py"),
                  "bench_metric_mfu.moonlight")
PATTERN = r"grouped_kernel<"


def read(run):
    if run.trace is None or not run.calls:
        return None
    seconds, launches = run.trace.seconds_matching(PATTERN)
    routed = mfu.routed_rows(run)
    if not launches or routed is None:
        return None
    per_step = routed / len(run.calls)
    least = 0.0
    for call in run.calls:
        # the dense layer and the shared experts take the real tokens' rows
        tokens = int(sum(call["txt_lens"]))
        least += sum(bound_s(b, ops, PEAK_OPS["bf16"]) for b, ops in
                     counts_moe.step_gemms(tokens, per_step, 1, run.config))
    return 100.0 * least / seconds
