"""host_enqueue_ms.train: the mean host time of a ``step(...)`` call issued
onto a drained device queue, over the steps a traced run times after its
window (the benchmark's ``step_drained`` spans): what the host spends
enqueueing a step. Inside the window a call can wait on the device (for
room in CUDA's launch queue), so a span there reads no less than the
device's pace, whatever the host's own cost."""


def read(run):
    spans = [(t1 - t0) / 1e6 for name, t0, t1 in run.spans.records
             if name == "step_drained"]
    if not spans:
        return None
    return sum(spans) / len(spans)
