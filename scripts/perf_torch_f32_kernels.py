#!/usr/bin/env python3
"""Time the port's float32 FMA kernels (the FFN, B3; the attention, B2) on
one CUDA card.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 scripts/perf_torch_f32_kernels.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``lightningdot_tpu_torch`` is timed
(default: this one), so that two commits can be compared in one call:
unpack the other into a directory that .gitignore lists and run parent,
change, change, parent.

1. The float32 FFN (768 -> 3,072 -> 768) through ``ops.ffn.ffn_gelu`` and
   its twin (the cuBLAS float32 pair, TF32 off) at rows 16-256 (query
   encoding), 512-4,096, a re-ranking block's 12,288 and 21,504 and the
   KD teacher's 106,880. Where the checkout picks float32 GEMM tiles
   (``ops.gemm.f32_gemm_tile``), also each forced (fc1 tile, fc2 tile) at
   rows up to 4,096, whose outputs must equal the default's bit for bit,
   and the first 16 rows of every call must equal a 16-row call's.
2. The float32 attention at the KD teacher's [640, 167] and a re-ranking
   block's [128, 168] (12 heads of 64) against SDPA in float32, read
   ``--rounds`` times alternately, with the spread of kernel / SDPA.

Times are chip_smoke.py's ``time_ms`` (calls in a CUDA graph, the median
of replays, inputs L2-warm), one JSON line per row, with the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

FFN_ROWS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 12288, 21504,
            106880)
FORCED_MAX_ROWS = 4096
ATTN_SHAPES = ((640, 167), (128, 168))


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def ffn_phase(label, ffn, gemm, _build, time_ms, gen):
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    w1, b1 = randn(768, 3072, scale=0.02), randn(3072, scale=0.02)
    w2, b2 = randn(3072, 768, scale=0.02), randn(768, scale=0.02)
    x_all = randn(max(FFN_ROWS), 768)
    first16 = ffn.ffn_gelu(x_all[:16], w1, b1, w2, b2)
    tiles = getattr(gemm, "f32_gemm_tile", None)
    for rows in FFN_ROWS:
        x = x_all[:rows]
        out = ffn.ffn_gelu(x, w1, b1, w2, b2)
        want = ffn._ffn_math(x, w1, b1, w2, b2)[0]
        row = dict(label=label, kernel="ffn", rows=rows,
                   max_abs_err=float((out - want).abs().max()),
                   rows16_equal=bool(torch.equal(out[:16], first16)),
                   ms=time_ms(lambda: ffn.ffn_gelu(x, w1, b1, w2, b2), 5, 5),
                   plain_ms=time_ms(lambda: ffn._ffn_math(x, w1, b1, w2,
                                                          b2), 5, 5))
        if tiles is not None:
            sms = _build.num_sms(dev)
            row["tiles"] = [tiles(rows, n, sms) for n in (3072, 768)]
        emit(**row)
        if tiles is None or rows > FORCED_MAX_ROWS:
            continue
        for t1, t2 in itertools.product((gemm.F32_WIDE, *gemm.F32_NARROW),
                                        repeat=2):
            got = torch.empty_like(x)
            inter = x.new_empty((rows, 3072))

            def call():
                _build.check(_build.lib().ldot_ffn(
                    x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), got.data_ptr(), None,
                    inter.data_ptr(), rows, 768, 3072, *t1, *t2,
                    _build.stream_ptr(x)), "ffn kernel")

            call()
            emit(label=label, kernel="ffn_forced", rows=rows,
                 tiles=[t1, t2], equal_to_default=bool(torch.equal(got, out)),
                 ms=time_ms(call, 5, 5))


def attention_phase(label, attention, time_ms, gen, rounds):
    dev = torch.device("cuda")
    for b, s in ATTN_SHAPES:
        q, k, v = (torch.randn(b, s, 12, 64, device=dev, generator=gen)
                   for _ in range(3))
        lens = torch.randint(1, s + 1, (b,), device=dev, generator=gen)
        mask = torch.arange(s, device=dev)[None, :] < lens[:, None]
        bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        mine = lambda: attention.multi_head_attention(q, k, v, bias)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=bias)
        reads = []
        for _ in range(rounds):
            reads.append((time_ms(mine, 3, 5), time_ms(sdpa, 3, 5)))
        ratios = [m / y for m, y in reads]
        emit(label=label, kernel="attention", shape=[b, s, 12, 64],
             ms=[m for m, _ in reads], library_ms=[y for _, y in reads],
             ratio_min=min(ratios), ratio_max=max(ratios))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("perf_torch_f32_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from lightningdot_tpu_torch.ops import _build, attention, ffn, gemm

    torch.backends.cuda.matmul.allow_tf32 = False
    emit(smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), label=args.label, root=args.root,
        package=str(Path(ffn.__file__).resolve()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    ffn_phase(args.label, ffn, gemm, _build, chip_smoke.time_ms, gen)
    attention_phase(args.label, attention, chip_smoke.time_ms, gen,
                    args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
