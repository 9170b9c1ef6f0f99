"""Run one cell of the benchmark of ``lightningdot_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It sets up the cell (weights and inputs from
the seed, the kernels built, every shape warm), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints as its last line one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), ``breakdown`` (``--trace 1``) and ``check``, the numbers
compared with their limits, which are also the last lines of standard
error. The line before it gives the card, its power limit, the seconds
the kernels' build took and the mean of each host span in the window. It
needs as many CUDA devices as the cell asks for and exits with 2 without
them; it exits with 3, printing no result, if JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _power_limit():
    """(name, power.limit) of each card as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(BENCH_DIR)]
    from harness import core

    cell = core.Cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result, lines, run = core.run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T_START)
    bad = core.loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    from lightningdot_tpu_torch.ops import _build
    print(json.dumps({"bench_device": {
        "cards": _power_limit(), "device_count": found,
        "nvcc_build_s": _build.build_seconds, "setup_s": run.setup_s,
        "window_s": run.window_s, "work": run.work,
        "window_span_ms": {
            name: 1e3 * sum(d) / len(d) for name in sorted(
                {n for n, _, _ in run.spans.records} - {"window"})
            if (d := run.window_durations(name))}}}))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
