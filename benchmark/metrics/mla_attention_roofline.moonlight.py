"""mla_attention_roofline.moonlight: the MLA attention kernels of
``csrc/mla_attention.cu`` (forward and backward, every launch in the traced
window: each text layer of each step, at the batch's padded length) over
their device time: the least time on one H100 (``harness/roofline.py``:
bytes of q, k, v, o (and dO, dq, dk, dv) at 3.35 TB/s or the real causal
pairs' operations at the bf16 peak; ``harness/counts_moe.py::
attention_work``), in percent. The image tower does not launch them."""
from harness import counts_moe
from harness.roofline import PEAK_OPS, bound_s

PATTERN = r"mla_(fwd|bwd)_kernel<"


def read(run):
    if run.trace is None or not run.calls:
        return None
    seconds, launches = run.trace.seconds_matching(PATTERN)
    if not launches:
        return None
    cfg = run.config
    least = 0.0
    for call in run.calls:
        b, s = call["txt_shape"]
        for backward in (False, True):
            nbytes, ops = counts_moe.attention_work(b, s, call["txt_lens"],
                                                    cfg, backward)
            least += cfg["num_hidden_layers"] * bound_s(nbytes, ops,
                                                        PEAK_OPS["bf16"])
    return 100.0 * least / seconds
