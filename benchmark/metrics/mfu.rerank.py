"""mfu.rerank: the model FLOPs of the pairs scored in the window over the
window's length, as a share of one H100's peak in the cell's precision
(float32: 67 TFLOP/s), in percent. A pair's FLOPs count its real tokens
only: the joint sequence of its caption and regions through the layers,
the region embedding, the pooler and the rank head."""
from harness import counts
from harness.roofline import PEAK_OPS


def read(run):
    if not run.calls or not run.window_s:
        return None
    c = run.config["model"]
    h = c["hidden_size"]
    flops = 0.0
    for call in run.calls:
        for length, regions in call["pairs"]:
            s = int(length) + int(regions)
            flops += (c["num_hidden_layers"]
                      * counts.layer_flops(s, h, c["intermediate_size"])
                      + counts.region_embedding_flops(
                          int(regions), h, c["img_dim"], c["pos_dim"])
                      + 2.0 * h * h + 2.0 * h)
    peak = PEAK_OPS[run.settings["compute_dtype"]]
    return 100.0 * flops / run.window_s / peak
