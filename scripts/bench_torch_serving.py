#!/usr/bin/env python3
"""H100 serving bench of the PyTorch port (the port's counterpart of
``bench.py`` and ``scripts/perf_serving_native.py``, which drive the JAX
package).

Run from the root of the repository on a machine with a CUDA card:

    python3 scripts/bench_torch_serving.py [--seed 0] [--configs bf16,int8]

Both serving configurations of ``lightningdot_tpu_torch.serving.Retriever``
over ``bench.py:108-113``'s tower (BERT-base cased, ``project_dim`` 0,
random weights from ``--seed``) and a full-COCO corpus of 123,287 x 768
seeded vectors, top 100:

- ``bf16``: bfloat16 tower and corpus, exact top-k;
- ``int8``: int8 tower, int8 corpus, approximate top-100 at recall 0.95.

For each it measures the p50 of ``retrieve_batch_arrays`` at batch 1, 8 and
64 on 32-token queries (host clock around calls that end in
``torch.cuda.synchronize()``), the device-busy time per call beside each
(torch.profiler device intervals, as chip_smoke.py's ``profile`` rows), and
then, under load, ``serving_native.serve_retriever`` (``max_batch`` 64)
driven by ``run_loadgen`` over ``--conns`` connections at offered rates that
are the ``--shares`` of the rate the batch-64 p50 implies, ``--duration``
seconds each: achieved QPS, p50/p99 latency, loadgen and server errors,
and the mean batch the server dispatched. The load generator's queries
are 9-10 tokens (``native/ldloadgen.cc``).

Prints one JSON line per configuration with the card's name and power
limit (``nvidia-smi``). Exits non-zero when there is no card; it never runs
on the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CORPUS_SIZE = 123_287
TOP = 100
QUERY_WORDS = 30          # + [CLS] and [SEP]: 32 tokens, as bench.py
BATCHES = (1, 8, 64)
REPS = 30
WORDS = ("a man riding horse on the beach two dogs playing in snow next to "
         "fence red double decker bus driving down city street cat "
         "sleeping laptop keyboard people flying kites green park sunny "
         "day plate of pizza and glass beer wooden table young girl "
         "holding an umbrella rain airplane taking off from runway at "
         "sunset photo dog near fountain").split()


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_tokenizer(workdir: Path):
    """A cased WordPiece vocabulary with BERT-base cased's special ids and
    the words and numbers of the queries (the load generator's included)."""
    from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer

    words = sorted(set(WORDS) | {str(i) for i in range(64)})
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
    path = workdir / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return WordPieceTokenizer(str(path), do_lower_case=False)


def build(config: str, tok, seed: int):
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models import BiEncoder, init_tower_
    from lightningdot_tpu_torch.serving import Retriever

    cfg = EncoderConfig(vocab_size=28996, project_dim=0)
    model = BiEncoder(cfg, compute_dtype=torch.bfloat16)
    init_tower_(model.txt_model, torch.Generator().manual_seed(seed))
    kw = (dict(quantization="int8", weight_quantization="int8",
               topk="approx", topk_recall=0.95) if config == "int8" else {})
    r = Retriever(model, tok, **kw)
    rng = np.random.default_rng(seed)
    r.set_corpus([f"coco_{i:06d}" for i in range(CORPUS_SIZE)],
                 rng.standard_normal((CORPUS_SIZE, cfg.hidden_size),
                                     dtype=np.float32))
    return r


def latency_rows(r, rng):
    from chip_smoke import device_profile

    r.warmup(tops=(TOP,), batches=BATCHES)
    rows = []
    for batch in BATCHES:
        queries = [" ".join(rng.choice(WORDS, QUERY_WORDS))
                   for _ in range(batch)]

        def call():
            out = r.retrieve_batch_arrays(queries, top=TOP)
            torch.cuda.synchronize()
            return out

        idx, scores = call()
        if idx.shape != (batch, TOP) or not np.isfinite(scores).all():
            raise RuntimeError(f"batch {batch}: malformed output")
        lat = []
        for _ in range(REPS):
            t = time.perf_counter()
            call()
            lat.append((time.perf_counter() - t) * 1e3)
        prof = device_profile(call, 10)
        p50 = statistics.median(lat)
        rows.append(dict(batch=batch, p50_ms=p50,
                         p90_ms=float(np.percentile(lat, 90)), reps=REPS,
                         device_busy_ms=prof["busy_ms"],
                         idle_share=1.0 - prof["busy_ms"] / p50,
                         launches_per_call=sum(
                             prof["launches_per_call"].values())))
    return rows


def load_rows(r, p50_64_ms, shares, duration, conns):
    from lightningdot_tpu_torch.serving_native import (run_loadgen,
                                                       serve_retriever)

    saturation = 64 / (p50_64_ms / 1e3)
    srv = serve_retriever(r, max_batch=64, max_top=TOP)
    rows = []
    try:
        run_loadgen(srv.port, rate=200, duration_s=1.0, conns=conns,
                    top=TOP)                      # warm the socket path
        for share in shares:
            before = srv.stats()
            stats = run_loadgen(srv.port, rate=share * saturation,
                                duration_s=duration, conns=conns, top=TOP)
            after = srv.stats()
            batches = after["batches"] - before["batches"]
            rows.append(dict(
                share=share, offered_per_s=stats["offered_per_s"],
                achieved_per_s=stats["achieved_per_s"],
                completed=stats["completed"], p50_ms=stats["p50_ms"],
                p90_ms=stats["p90_ms"], p99_ms=stats["p99_ms"],
                max_ms=stats["max_ms"], loadgen_errors=stats["errors"],
                server_errors=after["errors"] - before["errors"],
                mean_batch=(after["batched_requests"]
                            - before["batched_requests"]) / max(batches, 1)))
    finally:
        srv.stop()
    return saturation, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--configs", default="bf16,int8")
    ap.add_argument("--shares", default="0.25,0.5,0.9,1.2,1.6",
                    help="offered rates as shares of 64 / p50(batch 64)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--conns", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_serving: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    smi = smi_line()
    shares = [float(s) for s in args.shares.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        tok = make_tokenizer(Path(tmp))
        for config in args.configs.split(","):
            t0 = time.perf_counter()
            r = build(config, tok, args.seed)
            setup_s = time.perf_counter() - t0
            lat = latency_rows(r, np.random.default_rng(args.seed))
            saturation, load = load_rows(r, lat[-1]["p50_ms"], shares,
                                         args.duration, args.conns)
            if any(row["server_errors"] or row["loadgen_errors"]
                   for row in load):
                print(json.dumps({"config": config, "load": load}))
                raise RuntimeError(f"{config}: errors under load")
            print(json.dumps(dict(
                bench="bench_torch_serving", config=config,
                device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                torch=torch.__version__, corpus=CORPUS_SIZE, top=TOP,
                query_tokens=QUERY_WORDS + 2, setup_s=setup_s,
                latency=lat, saturation_per_s=saturation,
                conns=args.conns, duration_s=args.duration, load=load)),
                flush=True)
            del r
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
