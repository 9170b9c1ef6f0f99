"""Published peaks of one NVIDIA H100 SXM and the least time work can take
on it.

A frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``PEAK_OPS`` and
``bound``: the benchmark keeps its own yardstick, which later changes to the
program do not move. The rates are NVIDIA's data sheet (dense, no
sparsity) at the full 700 W power limit; a share of them is stated with the
card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float, peak: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``nbytes`` (each input read once, each output written
    once) and do ``ops`` operations at ``peak`` per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """:func:`bound` in seconds."""
    return bound(nbytes, ops, peak)[0] / 1e3
