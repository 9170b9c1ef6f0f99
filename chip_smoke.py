#!/usr/bin/env python3
"""Drive the PyTorch port (lightningdot_tpu_torch) on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure (no result is printed):

1. set-up: torch version, the card's name and power limit, TF32 off, the
   CUDA kernels built from ``lightningdot_tpu_torch/csrc`` (build time);
2. kernels: each hand-written kernel against its plain PyTorch twin on the
   card, at the shapes of the query path, float32 and bfloat16, with its
   median time beside the twin's (CUDA events);
3. main path at BERT-base cased width (12 layers, hidden 768, 12 heads,
   intermediate 3072, vocab 28,996; random weights from ``--seed``) against
   a full-COCO corpus of 123,287 x 768 bfloat16 vectors, through
   ``Retriever.retrieve_batch_arrays``:
   - float32: rankings ``ranking_equivalent`` to the port's plain path on
     the CPU (same weights, same corpus);
   - bfloat16 (the serving configuration): each query's planted embedding
     ranks first; cosine to the float32 embeddings above a bound;
   - p50 latency at batch 1, 8 and 64, top 100;
   - every kernel's launch counter rose on this path;
4. serve: ``serving_native.serve_retriever`` over the bfloat16 Retriever
   answers concurrent /search requests, each ``ranking_equivalent`` to a
   direct ``retrieve_batch``.

Then one JSON line listing the kernels, and as the last line
``{"ok": true, "device": {...}}``. The script imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from urllib.parse import quote

import numpy as np
import torch

CORPUS_SIZE = 123_287          # COCO images (train + restval + val + test)
TOP = 100
# kernel vs twin: float32 within 1e-5 and bfloat16 within one bf16 ulp
# (2**-7), relative to max(1, the twin's largest magnitude); only the
# summation order differs
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# float32 tower on the card vs on the CPU: the query vector may differ by
# float32 summation order (1e-3 absolute on unit-scale LayerNorm outputs
# after 12 layers), and then rounds to bfloat16 for the corpus product, where
# a few of its 768 elements can land one bf16 ulp apart: rankings are held
# at 5e-4 of the peak score
F32_VEC_ATOL = 1e-3
F32_RANK_RTOL = 5e-4
# bfloat16 vs float32 tower, cosine of the query embeddings
BF16_COSINE_MIN = 0.99
# served (coalesced batch) vs direct single-query bfloat16 rankings: another
# batch size sums in another order (cuBLAS picks other kernels, the FFN
# kernel other splits), which moves bf16 roundings inside the tower and
# compounds over 12 layers; the first run on an H100 measured score deltas
# up to 9.4e-4 of the peak score, so rankings are held at 2e-3 of it (the
# serve phase also prints the embedding jitter itself)
SERVE_RANK_RTOL = 2e-3

CAPTIONS = [
    "A man riding a horse on the beach .",
    "Two dogs playing in the snow next to a fence .",
    "A red double decker bus driving down a city street .",
    "A cat sleeping on a laptop keyboard .",
    "People flying kites in a green park on a sunny day .",
    "A plate of pizza and a glass of beer on a wooden table .",
    "A young girl holding an umbrella in the rain .",
    "An airplane taking off from a runway at sunset .",
]


class Failure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, groups: int = 7, per_group: int = 10) -> float:
    """Device time of one call: ``per_group`` calls captured in a CUDA
    graph (so the host's launch cost is out of the measurement), replayed
    ``groups`` times between CUDA events; the median over groups of the
    mean per call. Inputs stay in the 50 MB L2 between calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_group):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return statistics.median(times)


def compare(name, shape, dtype, kernel, twin, device_name):
    got, want = kernel(), twin()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} {shape}: kernel gave {got.dtype}{tuple(got.shape)}, twin "
          f"{want.dtype}{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite")
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype] * max(1.0, want.float().abs().max().item())
    row = dict(phase="kernel", kernel=name, shape=list(shape),
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
               tol=tol, ms=time_ms(kernel), plain_ms=time_ms(twin),
               device=device_name)
    emit(**row)
    check(err <= tol, f"{name} {shape} {dtype}: error {err} > {tol}")
    return row


def kernel_phase(device_name):
    from lightningdot_tpu_torch.ops import attention, ffn, layernorm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n in (32, 2048, 16384):
            x = randn(n, 768, scale=3.0, dtype=dtype) + 1
            scale = torch.rand(768, device=dev, generator=g) + 0.5
            bias = randn(768)
            rows.append(compare(
                "layernorm", (n, 768), dtype,
                lambda: layernorm.layer_norm_cuda(x, scale, bias, 1e-12),
                lambda: layernorm._ln_math(x.float(), scale, bias,
                                           1e-12).to(dtype), device_name))
        for b in (1, 8, 64, 256):
            for s in (16, 32, 64):
                q, k, v = (randn(b, s, 12, 64, dtype=dtype)
                           for _ in range(3))
                lens = torch.randint(1, s + 1, (b,), device=dev, generator=g)
                mask = torch.arange(s, device=dev)[None, :] < lens[:, None]
                bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
                rows.append(compare(
                    "attention", (b, s, 12, 64), dtype,
                    lambda: attention.multi_head_attention(q, k, v, bias),
                    lambda: attention._attention_math(q, k, v, bias, 0.125),
                    device_name))
        for n in (16, 32, 256, 2048):
            x = randn(n, 768, dtype=dtype)
            w1 = randn(768, 3072, scale=0.02, dtype=dtype)
            b1 = randn(3072, scale=0.02)
            w2 = randn(3072, 768, scale=0.02, dtype=dtype)
            b2 = randn(768, scale=0.02)
            rows.append(compare(
                "ffn", (n, 768, 3072), dtype,
                lambda: ffn.ffn_gelu(x, w1, b1, w2, b2),
                lambda: ffn._ffn_math(x, w1, b1, w2, b2)[0], device_name))
    return rows


def make_tokenizer(workdir: Path, words):
    """A cased WordPiece vocabulary with BERT-base cased's special ids
    ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103) and the words
    of the queries."""
    from lightningdot_tpu.data.tokenizer import WordPieceTokenizer

    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(words)))
    path = workdir / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return WordPieceTokenizer(str(path), do_lower_case=False)


def rankings(retriever, queries):
    return retriever.retrieve_batch(queries, top=TOP)


def max_rank_delta(got, want):
    return max(abs(g[1] - w[1]) for gl, wl in zip(got, want)
               for g, w in zip(gl, wl))


def hold_rankings(got, want, rtol, what):
    from lightningdot_tpu_torch.serving import ranking_equivalent

    peak = max(abs(s) for lst in got + want for _, s in lst)
    atol = rtol * max(1.0, peak)
    for i, (g, w) in enumerate(zip(got, want)):
        ok, why = ranking_equivalent(g, w, atol=atol)
        check(ok, f"{what}: query {i}: {why}")
    return atol


def main_path(args, tok, device_name):
    from lightningdot_tpu.config import EncoderConfig
    from lightningdot_tpu_torch.models import BiEncoder, init_text_encoder_
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.serving import Retriever

    cfg = EncoderConfig(vocab_size=28996, project_dim=0)   # BERT-base cased
    t0 = time.perf_counter()
    master = BiEncoder(cfg)
    init_text_encoder_(master.txt_model,
                       torch.Generator().manual_seed(args.seed))
    state = master.state_dict()

    def model(dtype):
        m = BiEncoder(cfg, compute_dtype=dtype)
        m.load_state_dict(state)
        return m

    rng = np.random.default_rng(args.seed)
    corpus = rng.standard_normal((CORPUS_SIZE, cfg.hidden_size),
                                 dtype=np.float32)
    ids = [f"coco_{i:06d}" for i in range(CORPUS_SIZE)]
    emit(phase="setup_main", seconds=time.perf_counter() - t0,
         layers=cfg.num_hidden_layers, hidden=cfg.hidden_size,
         corpus=list(corpus.shape))

    reset_launch_counts()
    # float32 on the card against the plain path on the CPU
    r32 = Retriever(model(torch.float32), tok, device="cuda")
    r32.set_corpus(ids, corpus)
    ref = Retriever(model(torch.float32), tok, device="cpu")
    ref.set_corpus(ids, corpus)
    vec32 = r32.encode_queries(CAPTIONS)
    vec_ref = ref.encode_queries(CAPTIONS)
    check(vec32.shape == (len(CAPTIONS), cfg.hidden_size)
          and np.isfinite(vec32).all(), "float32 query vectors malformed")
    vec_err = float(np.abs(vec32 - vec_ref).max())
    got, want = rankings(r32, CAPTIONS), rankings(ref, CAPTIONS)
    check(all(len(x) == TOP for x in got), "float32: short result lists")
    atol = hold_rankings(got, want, F32_RANK_RTOL, "float32 card vs cpu")
    emit(phase="f32_check", max_vec_err=vec_err, vec_atol=F32_VEC_ATOL,
         max_rank_score_delta=max_rank_delta(got, want), rank_atol=atol,
         queries=len(CAPTIONS))
    check(vec_err <= F32_VEC_ATOL, f"float32 vectors differ by {vec_err}")
    del r32, ref

    # bfloat16, the serving configuration: plant each query's embedding
    r16 = Retriever(model(torch.bfloat16), tok, device="cuda")
    r16.set_corpus(ids, corpus)
    vec16 = r16.encode_queries(CAPTIONS)
    check(np.isfinite(vec16).all(), "bfloat16 query vectors not finite")
    cos = (vec16 * vec32).sum(1) / (np.linalg.norm(vec16, axis=1)
                                    * np.linalg.norm(vec32, axis=1))
    spots = rng.choice(CORPUS_SIZE, len(CAPTIONS), replace=False)
    planted = corpus.copy()
    planted[spots] = vec16
    r16.set_corpus(ids, planted)
    res = rankings(r16, CAPTIONS)
    firsts = [r[0][0] for r in res]
    margins = [r[0][1] - r[1][1] for r in res]
    emit(phase="bf16_check", min_cosine_to_f32=float(cos.min()),
         cosine_min=BF16_COSINE_MIN, planted_first=sum(
             f == ids[s] for f, s in zip(firsts, spots)),
         queries=len(CAPTIONS), min_top1_margin=min(margins))
    check(float(cos.min()) >= BF16_COSINE_MIN,
          f"bfloat16 vs float32 cosine {cos.min()}")
    check(all(f == ids[s] for f, s in zip(firsts, spots)),
          f"planted embeddings not first: {firsts} vs "
          f"{[ids[s] for s in spots]}")

    # latency of the serving entry point, 32-token queries as bench.py
    words = sorted({w for c in CAPTIONS for w in c.split()})
    r16.warmup(tops=(TOP,), batches=(1, 8, 64))
    for batch in (1, 8, 64):
        queries = [" ".join(rng.choice(words, 30)) for _ in range(batch)]
        idx, scores = r16.retrieve_batch_arrays(queries, top=TOP)
        check(idx.shape == (batch, TOP) and np.isfinite(scores).all(),
              "retrieve_batch_arrays output malformed")
        lat = []
        for _ in range(30):
            t = time.perf_counter()
            r16.retrieve_batch_arrays(queries, top=TOP)
            lat.append((time.perf_counter() - t) * 1e3)
        emit(phase="latency", batch=batch, top=TOP, query_tokens=32,
             p50_ms=statistics.median(lat),
             p90_ms=float(np.percentile(lat, 90)), reps=len(lat),
             device=device_name)
    counts = launch_counts()
    emit(phase="main_path_launches", **counts)
    check(all(n > 0 for n in counts.values()),
          f"a kernel was not launched on the main path: {counts}")
    return r16, counts


def serve_phase(r16):
    from lightningdot_tpu.serving_native import serve_retriever

    t0 = time.perf_counter()
    srv = serve_retriever(r16, max_batch=64, max_top=TOP)
    warm_s = time.perf_counter() - t0
    queries = CAPTIONS + [c.replace(" .", " at night .") for c in CAPTIONS]
    out = [None] * len(queries)
    errors = []

    def call(i):
        url = f"{srv.address}/search?q={quote(queries[i])}&top=10"
        try:
            with urllib.request.urlopen(url, timeout=120) as r:
                out[i] = [tuple(x) for x in json.loads(r.read())["results"]]
        except Exception as e:  # reported below, fails the phase
            errors.append(f"{queries[i]!r}: {e!r}")

    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "a request hung")
        check(not errors, f"requests failed: {errors}")
        stats = srv.stats()
    finally:
        srv.stop()
    want = [r16.retrieve_batch([q], top=10)[0] for q in queries]
    atol = hold_rankings(out, want, SERVE_RANK_RTOL, "served vs direct")
    # the batch-composition jitter of the bf16 tower, measured directly
    solo = np.concatenate([r16.encode_queries([q]) for q in queries])
    together = r16.encode_queries(queries)
    cos = (solo * together).sum(1) / (np.linalg.norm(solo, axis=1)
                                      * np.linalg.norm(together, axis=1))
    emit(phase="serve", server="serving_native", requests=len(queries),
         batches=stats["batches"], errors=stats["errors"],
         warmup_s=warm_s, max_rank_score_delta=max_rank_delta(out, want),
         rank_atol=atol, embedding_jitter_max_abs=float(
             np.abs(solo - together).max()),
         embedding_jitter_min_cosine=float(cos.min()))
    check(stats["errors"] == 0, f"server errors: {stats}")


REPLACES = {
    "layernorm": ("lightningdot_tpu_torch/csrc/layernorm.cu",
                  "lightningdot_tpu/ops/layernorm.py:30"),
    "attention": ("lightningdot_tpu_torch/csrc/attention.cu",
                  "lightningdot_tpu/ops/attention.py:87"),
    "ffn": ("lightningdot_tpu_torch/csrc/ffn.cu",
            "lightningdot_tpu/ops/ffn.py:77"),
}
# the serving shape reported in the kernels line: batch 64, 32 tokens, bf16
REPORT_SHAPE = {"layernorm": [2048, 768], "attention": [64, 32, 12, 64],
                "ffn": [2048, 768, 3072]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from lightningdot_tpu_torch.ops import _build

    device_name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    emit(phase="setup", torch=torch.__version__, cuda=torch.version.cuda,
         device=device_name, nvidia_smi=smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds)

    rows = kernel_phase(device_name)
    with tempfile.TemporaryDirectory() as tmp:
        words = [w for c in CAPTIONS for w in c.split()] + ["at", "night"]
        t0 = time.perf_counter()
        tok = make_tokenizer(Path(tmp), words)
        emit(phase="tokenizer", native=tok.native,
             seconds=time.perf_counter() - t0)
        r16, counts = main_path(args, tok, device_name)
        serve_phase(r16)

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        rep = [r for r in rows if r["kernel"] == name
               and r["shape"] == REPORT_SHAPE[name]
               and r["dtype"] == "bfloat16"][0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=rep["max_abs_err"],
            ms=rep["ms"], plain_ms=rep["plain_ms"], shape=rep["shape"],
            dtype="bfloat16", passed=True))
    check("jax" not in sys.modules, "jax was imported")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
