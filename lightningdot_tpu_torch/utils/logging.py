"""The drivers' logging and metrics plumbing (the port's copy of
lightningdot_tpu/utils/logging.py; reference uniter_model/utils/logger.py
and misc.py): the global ``LOGGER`` with an optional per-run file handler,
``RunningMeter`` (EMA-smoothed losses with a NaN guard), ``MetricsLogger``
/ ``TB_LOGGER`` (a TensorboardLogger-style scalar registry backed by a
JSONL file, no external service), and ``NoOp`` for non-main ranks.
"""
from __future__ import annotations

import json
import logging
import math
import time
from typing import Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("__main__")


def add_log_to_file(log_path: str) -> None:
    """logger.py:17-22."""
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)


class RunningMeter:
    """EMA-smoothed scalar with NaN guard (logger.py:69-91)."""

    def __init__(self, name: str, val: Optional[float] = None,
                 smooth: float = 0.99):
        self._name = name
        self._sm = smooth
        self._val = val

    def __call__(self, value: float) -> None:
        val = (value if self._val is None
               else value * (1 - self._sm) + self._val * self._sm)
        if math.isnan(val):
            return
        self._val = val

    def __str__(self) -> str:
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self) -> float:
        return self._val if self._val is not None else 0.0

    @property
    def name(self) -> str:
        return self._name


class MetricsLogger:
    """Scalar metrics sink -> JSONL file (replaces TensorboardLogger /
    Comet hooks, logger.py:25-66; metric call sites e.g.
    train_itm.py:275-340)."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._step = 0
        self._fh = open(path, "a") if path else None

    def create(self, path: str) -> None:
        self._path = path
        self._fh = open(path, "a")

    def set_step(self, step: int) -> None:
        self._step = step

    def log_metric(self, name: str, value, step: Optional[int] = None) -> None:
        if self._fh is None:
            return
        rec = {"t": time.time(), "step": step if step is not None else
               self._step, name: float(value)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_scalar_dict(self, d: dict, prefix: str = "") -> None:
        for k, v in d.items():
            name = f"{prefix}_{k}" if prefix else k
            self.log_metric(name, v)


TB_LOGGER = MetricsLogger()


class NoOp:
    """Absorb-everything stub for non-main ranks (misc.py:14-19)."""

    def __getattr__(self, name):
        return self.noop

    def noop(self, *args, **kwargs):
        return
