"""attention_f32_roofline.rerank: the float32 attention kernel of
``csrc/attention.cu`` (B2) in the traced window: the least time its
launched shapes need on one H100 (4 b s^2 h operations at 67 TFLOP/s, or
its bytes at 3.35 TB/s) over its device time, in percent. Each block of
pairs runs it in each of the 12 layers at its padded joint length."""
from harness import counts
from harness.roofline import PEAK_OPS, bound_s

PATTERN = r"\(anonymous namespace\)::attention_kernel<"
ELEM = 4


def read(run):
    if run.trace is None or not run.calls:
        return None
    seconds, launches = run.trace.seconds_matching(PATTERN)
    if not launches:
        return None
    c = run.config["model"]
    least = sum(c["num_hidden_layers"] * bound_s(
        *counts.attention_forward(b, s, c["hidden_size"], ELEM),
        PEAK_OPS["f32"]) for call in run.calls for b, s in call["blocks"])
    return 100.0 * least / seconds
