"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference computes from the same inputs."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import numpy as np


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want|."""
    return abs(got - want) / max(abs(want), 1e-30)


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               names: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap between two norms, |got - want|, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger (some gradients are all but zero)."""
    names = list(want if names is None else names)
    med = statistics.median(want[k] for k in names)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in names)


def moved_leaves(grad_norms: Dict[str, float],
                 share: float = 1e-3) -> list:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others (a key's bias under softmax) move under Adam
    by round-off alone."""
    med = statistics.median(grad_norms.values())
    return [k for k, g in grad_norms.items() if g >= share * med]


def peak_gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| against the reference's largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def centered_rows(got: np.ndarray, want: np.ndarray) -> float:
    """The widest row gap ||got - want|| of the rows less their mean over
    the sample, against the reference's rms centered norm: the part of each
    answer that depends on its input."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    dg = got - got.mean(axis=0)
    dw = want - want.mean(axis=0)
    scale = np.sqrt(np.mean(np.sum(dw * dw, axis=-1)))
    return float(np.max(np.linalg.norm(dg - dw, axis=-1)) / max(scale,
                                                                 1e-30))
