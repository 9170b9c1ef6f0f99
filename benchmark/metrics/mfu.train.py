"""mfu.train: the model FLOPs of the training steps in the window over the
window's length, as a share of one H100's peak in the cell's precision
(float32: 67 TFLOP/s on the FMA units), in percent. FLOPs count real tokens
only (``harness/counts.py``): each tower forward, both directions' score
matrices, and the backward at twice the forward; padding and recomputation
are not counted."""
from harness import counts
from harness.roofline import PEAK_OPS


def read(run):
    if not run.calls or not run.window_s:
        return None
    cfg = run.config
    pd = cfg["project_dim"]
    flops = 0.0
    for call in run.calls:
        n = len(call["txt_lens"])
        forward = (counts.tower_flops(call["txt_lens"], cfg["text"], pd,
                                      regions=False)
                   + counts.tower_flops(call["img_lens"], cfg["image"], pd,
                                        regions=True)
                   + 2 * 2.0 * n * n * pd)
        flops += 3.0 * forward
    peak = PEAK_OPS[run.settings["compute_dtype"]]
    return 100.0 * flops / run.window_s / peak
