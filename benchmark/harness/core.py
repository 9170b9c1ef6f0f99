"""The harness: it finds a cell's files by the names in ``BENCHMARK.json``,
runs the cell's runner once and reads its metrics.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes, its source and cuts;
* ``traffic/<traffic>.json``: the runner that serves the mix
  (``runners/<runner>.py``) and the mix's parameters, which the one
  generator (``harness/traffic.py``) reads;
* ``workloads/<cell>.json``: what the cell fixes beyond its configuration
  and mix (the compute precision, the job's settings) and the limits of
  the numbers that decide ``correct``;
* ``metrics/<metric>.py``: a reader, ``read(run) -> value or None``; a
  reader that finds nothing to read returns None and the metric is left
  out of the line.

A runner's ``run(run)`` sets up, calls :meth:`Run.setup_done`, measures
inside :meth:`Run.window`, then frees the program's state and checks what
the timed path produced against the plain reference; it returns
``{"attempted", "failed", "check": {name: (value, limit)}}``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from harness.trace import DeviceTrace, Spans, TraceData

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "lightningdot_tpu")


def forbidden_modules(names) -> List[str]:
    """The top-level names among ``names`` (module names, compared whole up
    to the first dot) that a run may not load: JAX and the JAX package."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by path: a name may hold
    dots (``metrics/mfu.train.py``)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with the files it names."""

    def __init__(self, name: str, bench_dir: Path = BENCH_DIR,
                 manifest: Optional[Path] = None):
        self.bench_dir = Path(bench_dir)
        doc = load_json(manifest or self.bench_dir.parent / "BENCHMARK.json")
        entries = {w["name"]: w for w in doc["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entries[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(self.bench_dir / "configs"
                                / f"{self.entry['config']}.json")
        self.traffic = load_json(self.bench_dir / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.settings = load_json(self.bench_dir / "workloads"
                                  / f"{name}.json")
        self.end_to_end = [m for m in doc["end_to_end"]
                           if name in m.get("workloads", [name])]
        mine = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in doc["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in mine)]

    def runner(self):
        name = self.traffic["runner"]
        return load_module(self.bench_dir / "runners" / f"{name}.py",
                           f"bench_runner_{name}")

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric}")


class Run:
    """One run of a cell: what the runner measured, for the readers.

    ``work``: counts over the window ({"pairs": n, ...}); ``calls``: one
    record per call into the program in the window (its shapes); ``spans``:
    the benchmark's host spans; ``trace``: the traced window's
    :class:`~harness.trace.TraceData` (``--trace 1`` only)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: Optional[float] = None):
        import torch
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.traced = bool(trace)
        self.device = torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spans = Spans()
        self.work: Dict[str, float] = {}
        self.calls: List[dict] = []
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.trace: Optional[TraceData] = None
        self.memory_peak_bytes = 0
        self._t0: Optional[float] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def settings(self) -> dict:
        return self.cell.settings

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """Set-up ends here: everything is loaded, built and warm."""
        if self.setup_s is None:
            self.sync()
            self.setup_s = time.perf_counter() - self.t_start

    @contextmanager
    def window(self):
        """The measured window: from a synchronized device to the
        completion of all the work queued in it."""
        self.setup_done()
        tracer = DeviceTrace(self.on_card) if self.traced else None
        if tracer is not None:
            tracer.__enter__()
        try:
            with self.spans("window"):
                self._t0 = time.perf_counter()
                yield self
                self.sync()
            self.window_s = time.perf_counter() - self._t0
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)
        if tracer is not None:
            self.trace = tracer.data(self.spans)
        if self.on_card:
            import torch
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))

    def running(self) -> bool:
        return time.perf_counter() - self._t0 < self.seconds

    def count(self, **work: float) -> None:
        for k, v in work.items():
            self.work[k] = self.work.get(k, 0) + v

    def window_durations(self, name: str) -> List[float]:
        """Seconds of each host span ``name`` inside the window."""
        windows = [(t0, t1) for n, t0, t1 in self.spans.records
                   if n == "window"]
        if not windows:
            return []
        w0, w1 = windows[-1]
        return [(t1 - t0) / 1e9 for n, t0, t1 in self.spans.records
                if n == name and t0 >= w0 and t1 <= w1]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None) -> Tuple[dict, List[str], Run]:
    """Run ``cell`` once -> (the result line's object, the compared
    numbers as lines, the run)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, seconds, trace, device, t_start)
    out = cell.runner().run(run)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    check = {k: (float(v), float(lim)) for k, (v, lim) in out["check"].items()}
    correct = (bool(check) and out["failed"] == 0
               and all(math.isfinite(v) and v <= lim
                       for v, lim in check.values()))
    dev = {"platform": "gpu" if run.on_card else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.on_card
                    else run.device.type),
           "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in check.items()}
    lines = [f"check {k} {v!r} limit {lim!r}" for k, (v, lim) in
             check.items()]
    return result, lines, run


def loaded_forbidden() -> List[str]:
    return forbidden_modules(list(sys.modules))
