"""rope_roofline.moonlight: ``csrc/rope.cu``'s kernel (RoPE of the text tower's
query and key heads, forward and inverse) in the traced window: the least
time their bytes need on one H100 at 3.35 TB/s
(``harness/counts_moe.py::rope_bytes``) over their device time, in percent."""
from harness import counts_moe
from harness.roofline import HBM_BYTES_PER_S

PATTERN = r"rope_kernel<"


def read(run):
    if run.trace is None or not run.calls:
        return None
    seconds, launches = run.trace.seconds_matching(PATTERN)
    if not launches:
        return None
    nbytes = sum(counts_moe.rope_bytes(c["txt_shape"][0] * c["txt_shape"][1],
                                 run.config) for c in run.calls)
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
