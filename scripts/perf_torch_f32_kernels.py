#!/usr/bin/env python3
"""Time the port's float32 FMA kernels (the FFN, B3; the attention, B2;
the training attention, B5; dh1, B6) and the float32 training step on one
CUDA card.

Run from the root of the repository, on a machine with the card and nvcc:

    python3 scripts/perf_torch_f32_kernels.py [--root DIR] [--label NAME]
        [--phases ffn,attention,train_attention,dh1,step]

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
3. ``train_attention``: the training attention's float32 forward and
   backward (``ops.attention_fused``, rate 0.1) at the fine-tuning shapes
   (batch 64 at text S 32, image S 64 and 104; 128 rows at S 104) against
   SDPA in float32 at rate 0 (the forward; the forward and backward
   through autograd), read ``--rounds`` times alternately; each kernel's
   output must equal its twin's bit for bit.
4. ``dh1``: the FFN backward's dh1 in float32 (``ops.ffn_dh1.ffn_dh1``:
   g [rows, 768], h1 [rows, 3,072], w2 [3,072, 768]) at rows 16-256
   (narrow tiles), the dist ranks' 1,024, the float32 step's 2,048 and
   4,096 and 13,312, against its twin (cuBLAS's float32 g w2^T, then
   gelu' in eager ops) and ``torch.mm(g, w2.t())`` alone, read
   ``--rounds`` times in turn; each kernel output within 1e-5 x max(1,
   peak) of the twin, the same bits on a second launch, its first 16
   rows equal to a 16-row call's.
5. ``step``: the ITM step at configs/coco_ft.json's full width in float32
   (TF32 off, dropout 0.1, batch 64) through ``make_itm_train_step``: the
   p50 of 20 steps after 3 warm-up steps, and a profile of 3 steps (device
   busy, the shares of it that the training attention's float32 kernels
   and dh1's take).

Times are chip_smoke.py's ``time_ms`` (calls in a CUDA graph, the median
of replays, inputs L2-warm), one JSON line per row, with the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

FFN_ROWS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 12288, 21504,
            106880)
FORCED_MAX_ROWS = 4096
ATTN_SHAPES = ((640, 167), (128, 168))
TRAIN_ATTN_SHAPES = ((64, 32), (64, 64), (64, 104), (128, 104))
DH1_ROWS = (16, 32, 130, 256, 1024, 2048, 4096, 13312)
PHASES = ("ffn", "attention", "train_attention", "dh1", "step")
STEPS, WARM_UP = 20, 3
# the training attention's float32 kernels by device name, in this tree
# (the forward is attention.cu's kernel with its dropout pass) and in the
# first port (fwd_kernel<float>, bwd_q_kernel<float>, bwd_kv_kernel<float>)
B5_F32_KERNELS = (r"::(attention_kernel<true>|fwd_kernel<float>|"
                  r"bwd_q_kernel|bwd_kv_kernel)")
# dh1's float32 kernels: ffn.cu's transpose of W2 and its GEMM with the
# dh1 epilogue (2), in this tree; the first port's dh1_kernel
# (csrc/ffn_dh1.cu) in checkouts that have it (--root)
DH1_F32_KERNELS = (r"::(transpose_b_kernel|(gemm|narrow)_kernel<2[,>]|"
                   r"dh1_kernel)")


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


def train_attention_phase(label, af, time_ms, gen, rounds):
    dev = torch.device("cuda")
    f = torch.nn.functional
    seed = torch.tensor([0x5EED_0000_1234], device=dev)
    for b, s in TRAIN_ATTN_SHAPES:
        d = 64
        q, k, v, g = (torch.randn(b, s, 12 * d, device=dev, generator=gen)
                      for _ in range(4))
        lens = torch.randint(1, s + 1, (b,), device=dev, generator=gen)
        bias = ((torch.arange(s, device=dev)[None, :] >= lens[:, None])
                .float() * -10000.0)
        kw = dict(nh=12, rate=0.1, scale=d ** -0.5)
        heads = [t.view(b, s, 12, d).transpose(1, 2) for t in (q, k, v)]
        leaves = [t.detach().clone().requires_grad_() for t in heads]
        g4 = g.view(b, s, 12, d).transpose(1, 2)
        mask4 = bias[:, None, None, :]
        fwd = lambda: af.attention_train_fwd(q, k, v, bias, seed, **kw)
        bwd = lambda: af.attention_train_bwd(q, k, v, bias, seed, g, **kw)
        equal = (torch.equal(fwd(), af._fused_attn_fwd_math(
            q, k, v, bias, seed, 12, 0.1, d ** -0.5)) and all(
                torch.equal(x, y) for x, y in zip(
                    bwd(), af._fused_attn_bwd_math(q, k, v, bias, seed, g,
                                                   12, 0.1, d ** -0.5))))

        def sdpa_fwd_bwd():
            out = f.scaled_dot_product_attention(*leaves, attn_mask=mask4)
            return torch.autograd.grad(out, leaves, g4)

        for name, mine, sdpa in (
                ("attention_train_fwd", fwd,
                 lambda: f.scaled_dot_product_attention(*heads,
                                                        attn_mask=mask4)),
                ("attention_train_bwd", bwd, sdpa_fwd_bwd)):
            reads = [(time_ms(mine, 3, 5), time_ms(sdpa, 3, 5))
                     for _ in range(rounds)]
            ratios = [m / y for m, y in reads]
            emit(label=label, kernel=name, shape=[b, s, 12, d], rate=0.1,
                 bit_equal_to_twin=bool(equal),
                 ms=[m for m, _ in reads], library_ms=[y for _, y in reads],
                 ratio_min=min(ratios), ratio_max=max(ratios))


def dh1_phase(label, ffn_dh1, time_ms, gen, rounds):
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    w2 = randn(3072, 768, scale=0.02)
    g_all, h1_all = randn(max(DH1_ROWS), 768), randn(max(DH1_ROWS), 3072)
    first16 = ffn_dh1.ffn_dh1(g_all[:16], h1_all[:16], w2)
    for rows in DH1_ROWS:
        g, h1 = g_all[:rows], h1_all[:rows]
        mine = lambda: ffn_dh1.ffn_dh1(g, h1, w2)
        twin = lambda: ffn_dh1._dh1_math(g, h1, w2)
        got, again, want = mine(), mine(), twin()
        peak = float(want.abs().max())
        reads = [(time_ms(mine, 3, 5), time_ms(twin, 3, 5),
                  time_ms(lambda: torch.mm(g, w2.t()), 3, 5))
                 for _ in range(rounds)]
        emit(label=label, kernel="ffn_dh1", rows=rows,
             max_abs_err=float((got - want).abs().max()),
             tol=1e-5 * max(1.0, peak),
             repeat_equal=bool(torch.equal(got, again)),
             rows16_equal=bool(torch.equal(got[:16], first16)),
             ms=[r[0] for r in reads], plain_ms=[r[1] for r in reads],
             product_ms=[r[2] for r in reads],
             bound_ms=2 * rows * 768 * 3072 / 67e12 * 1e3,
             device_kernels_ms=device_kernels(mine))


def device_kernels(fn, calls=5):
    """{device kernel: ms per call} of ``fn`` (torch.profiler, after a
    warm-up call): the share of each of a wrapper's kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if str(e.device_type) == "DeviceType.CUDA":
            m = re.search(r"\w+_kernel(<[^>]*>)?", e.name)
            name = m.group(0) if m else e.name[:60]
            out[name] = (out.get(name, 0.0)
                         + (e.time_range.end - e.time_range.start) / 1e3
                         / calls)
    return out


def step_phase(label, chip_smoke, time_profile):
    from dataclasses import replace

    from lightningdot_tpu_torch.models import BiEncoder, init_tower_
    from lightningdot_tpu_torch.training.itm_step import make_itm_train_step
    from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                       schedule_linear)

    txt_cfg, img_cfg = chip_smoke.train_configs(0.1)
    master = BiEncoder(txt_cfg, img_cfg)
    gen = torch.Generator().manual_seed(3)
    init_tower_(master.txt_model, gen)
    init_tower_(master.img_model, gen)
    model = BiEncoder(*(replace(c, hidden_dropout_prob=0.1,
                                attention_probs_dropout_prob=0.1)
                        for c in (txt_cfg, img_cfg)),
                      compute_dtype=torch.float32)
    model.load_state_dict(master.state_dict())
    del master
    model.train()
    step = make_itm_train_step(model, make_optimizer(
        model, schedule_linear(2e-5, 0, 1000), max_grad_norm=2.0),
        device="cuda")
    data = chip_smoke.SynthImages(4 * 64, chip_smoke.NUM_BB, 3, "train")
    batches = list(chip_smoke.image_loader(data, 64))
    dropout_gen = torch.Generator().manual_seed(0)
    for i in range(WARM_UP):
        step(batches[i % 4], dropout_gen)
    torch.cuda.synchronize()
    lat = []
    for i in range(STEPS):
        t = time.perf_counter()
        step(batches[i % 4], dropout_gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    busy, (b5, dh1), dh1_launches = time_profile(
        lambda: step(batches[0], dropout_gen), 3,
        (B5_F32_KERNELS, DH1_F32_KERNELS))
    p50 = statistics.median(lat)
    emit(label=label, kernel="itm_train_f32_full", batch=64,
         ms_per_step_p50=p50, ms_per_step=lat, busy_ms=busy,
         idle_share=1.0 - busy / p50, b5_f32_ms=b5, b5_share=b5 / busy,
         dh1_f32_ms=dh1, dh1_share=dh1 / busy,
         dh1_launches_per_step=dh1_launches)


def profile_shares(fn, calls, patterns):
    """(device busy ms, [ms of the kernels whose names match each of
    ``patterns``], launches of the last pattern's kernels) per call, from
    torch.profiler's device events over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans, mine, last = [], [0.0] * len(patterns), 0
    for e in prof.events():
        if str(e.device_type) != "DeviceType.CUDA":
            continue
        spans.append((e.time_range.start, e.time_range.end))
        for i, pattern in enumerate(patterns):
            if re.search(pattern, e.name):
                mine[i] += e.time_range.end - e.time_range.start
                last += i == len(patterns) - 1
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return (busy / 1e3 / calls, [m / 1e3 / calls for m in mine],
            last / calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("perf_torch_f32_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from lightningdot_tpu_torch.ops import (_build, attention,
                                            attention_fused, ffn, ffn_dh1,
                                            gemm)

    emit(smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), label=args.label, root=args.root,
        package=str(Path(ffn.__file__).resolve()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "ffn" in phases:
        ffn_phase(args.label, ffn, gemm, _build, chip_smoke.time_ms, gen)
    if "attention" in phases:
        attention_phase(args.label, attention, chip_smoke.time_ms, gen,
                        args.rounds)
    if "train_attention" in phases:
        train_attention_phase(args.label, attention_fused,
                              chip_smoke.time_ms, gen, args.rounds)
    if "dh1" in phases:
        dh1_phase(args.label, ffn_dh1, chip_smoke.time_ms, gen, args.rounds)
    if "step" in phases:
        step_phase(args.label, chip_smoke, profile_shares)
    return 0


if __name__ == "__main__":
    sys.exit(main())
