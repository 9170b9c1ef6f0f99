"""ffn_f32_roofline.train: the float32 FFN kernels of ``csrc/ffn.cu`` (fc1
with h1 and gelu(h1) for the backward, fc2, and the backward's dh1 with
its transpose of W2) in the traced window: the least time their launched
shapes need on one H100 (``harness/roofline.py``; each GEMM bound by its
bytes at 3.35 TB/s or its operations at 67 TFLOP/s) over their device
time, in percent. Every step runs them in each of the 12 layers of both
towers, at the batch's padded rows."""
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
    peak = PEAK_OPS["f32"]
    least = 0.0
    for call in run.calls:
        for shape, cfg in ((call["txt_shape"], run.config["text"]),
                           (call["img_shape"], run.config["image"])):
            rows, h, i = (shape[0] * shape[1], cfg["hidden_size"],
                          cfg["intermediate_size"])
            work = (counts.ffn_forward(rows, h, i, ELEM, with_h1=True)
                    + [counts.ffn_dh1(rows, h, i, ELEM)])
            least += cfg["num_hidden_layers"] * sum(
                bound_s(b, ops, peak) for b, ops in work)
    return 100.0 * least / seconds
