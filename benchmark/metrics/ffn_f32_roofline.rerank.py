"""ffn_f32_roofline.rerank: the float32 FFN kernels of ``csrc/ffn.cu``
(fc1 with its bias-GELU epilogue, fc2) in the traced window: the least time
their launched shapes need on one H100 (each GEMM bound by its bytes at
3.35 TB/s or its operations at 67 TFLOP/s) over their device time, in
percent. Each block of pairs runs them in each of the 12 layers at its
padded joint rows."""
from harness import counts
from harness.roofline import PEAK_OPS, bound_s

PATTERN = (r"\(anonymous namespace\)::(gemm_kernel<\d+>\(|narrow_kernel<"
           r"|transpose_b_kernel)")
ELEM = 4


def read(run):
    if run.trace is None or not run.calls:
        return None
    seconds, launches = run.trace.seconds_matching(PATTERN)
    if not launches:
        return None
    c = run.config["model"]
    h, i = c["hidden_size"], c["intermediate_size"]
    least = 0.0
    for call in run.calls:
        for b, s in call["blocks"]:
            least += c["num_hidden_layers"] * sum(
                bound_s(nb, ops, PEAK_OPS["f32"]) for nb, ops in
                counts.ffn_forward(b * s, h, i, ELEM, with_h1=False))
    return 100.0 * least / seconds
