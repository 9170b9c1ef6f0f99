"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 1] [--out file.json]

For each of ``--seeds`` it runs the cell once in this process with a short
window (``--seconds``; a training cell's readings need none) and keeps
the numbers compared and the end-to-end metrics: the program's readings,
which set a limit's lower end. For each of ``--control-seeds`` it runs the
runner's ``control``: the plain reference in the program's place in the
precision below the cell's (TF32 for float32), and for training the fault
that leaves out half of each batch, each read against the float32
reference: the upper end. The benchmark's own runs never run this. It
prints one JSON object, and writes it to ``--out`` too.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(BENCH_DIR)]
    from harness import core

    cell = core.Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = {"workload": cell.name,
           "card": torch.cuda.get_device_name(0), "program": [],
           "control": []}
    for seed in seeds:
        t = time.perf_counter()
        result, _, run = core.run_cell(cell, seed, args.seconds, False,
                                       "cuda")
        out["program"].append({
            "seed": seed, "check": result["check"],
            "correct": result["correct"], "metrics": result["metrics"],
            "seconds": time.perf_counter() - t})
        print(json.dumps(out["program"][-1]), file=sys.stderr, flush=True)
    for seed in controls:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        run = core.Run(cell, seed, 0.0, False, "cuda")
        t = time.perf_counter()
        out["control"].append({"seed": seed,
                               "readings": cell.runner().control(run),
                               "seconds": time.perf_counter() - t})
        print(json.dumps(out["control"][-1]), file=sys.stderr, flush=True)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
