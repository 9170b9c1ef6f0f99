#!/usr/bin/env python3
"""Drive the PyTorch port (lightningdot_tpu_torch) on one CUDA card.

Run from the root of the repository:

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure (no result is printed):

1. set-up: torch version, the card's name and power limit, TF32 off, the
   CUDA kernels built from ``lightningdot_tpu_torch/csrc`` (build time);
2. kernels: each hand-written kernel against its plain PyTorch twin on the
   card, at the shapes of the paths below (the encode and training batches
   included: the LayerNorm forward at 32-16,384 rows and at the VQA head's
   widths, 3,072 and 6,144, forward and backward, with its
   mask-and-add prologue at 32-4,096 rows bit-equal to the kernel on the
   twin's u, its backward at 130-4,096 rows;
   attention at [128, 32|64|104], the bf16 FFN at 16-13,312 rows; the
   int8 FFN at 16-4,096 rows and a ragged 37, bit-equal to its twin and
   to itself on a second launch) and at S 37, 65, 105 and 128 and head
   dim 32 for the ragged paths, with its median time beside the twin's
   (CUDA graph, CUDA events); the approximate top-k beside torch.topk over
   the corpus;
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
   - a torch.profiler pass at batch 1 and 64: device busy time per call,
     idle share against the p50, the costliest device kernels;
4. serve: ``serving_native.serve_retriever`` over the bfloat16 Retriever
   answers concurrent /search requests, each ``ranking_equivalent`` to a
   direct ``retrieve_batch``; then the port's HTTP front end
   (``serving_http.RetrievalServer`` over ``serving_frontend.
   BatchingFrontend``, ``max_batch`` 64) answers a burst that coalesces
   into fewer device calls than requests, held the same way
   (``serve_http``); then ``serving_native.run_loadgen`` drives
   ``serve_retriever`` at two offered rates, 2 s each: achieved QPS,
   p50/p99 latency, no errors (``loadgen``);
5. image: corpus encoding with both towers in bfloat16 through
   ``get_model_encoded_vecs`` over 4,224 synthetic images (num_bb 36 and
   100), images/s; float32 on the card against the CPU plain path, bfloat16
   against float32; a profiler pass over one batch;
6. int8 serving: ``Retriever(quantization="int8", weight_quantization=
   "int8", topk="approx")`` against a 123,287-vector int8 corpus that begins
   with the image vectors: cosine to the bfloat16 tower, planted queries
   first, p50 at batch 1, 8 and 64, a profiler pass, approximate
   recall@100 against exact top-k, rankings on the card against the CPU
   plain path, and a control (see ``int8_phase``);
7. ITM fine-tuning at configs/coco_ft.json's configuration (both towers
   with project_dim 768, bf16 over float32 masters, dropout 0.1, batch 64,
   clip 2.0, AdamW, linear schedule) through ``make_itm_train_step``:
   ms/step, pairs/s, peak memory, launches per step, a profiler pass
   (launch counts of copies and elementwise work), eval after the steps
   against a fresh model, the loss falling on a fixed batch, float32 card
   vs CPU (at dropout 0, and at attention dropout 0.1 with one step seed on
   both devices) and bfloat16 vs float32, each bound beside a control (see
   ``train_phase``); and the same step at full width in float32 (TF32 off,
   dropout 0.1: training with ``--compute_dtype f32``): ms/step, a profiler
   pass with the shares of the device time that the training attention's
   float32 kernels and B6's float32 dh1 take (``itm_train_f32_full``);
8. eval: ``cli/eval_itm.main`` of the port on the card at
   configs/coco_eval.json's model (BERT-base cased + UNITER-base,
   ``project_dim`` 768, bf16, batch 80) over synthetic DBs written by the
   port's writers (500 images x 5 captions, 10-100 regions of 2,048
   features, captions of up to 60 tokens): recall@{1,5,10} both ways,
   loss, correct ratio, pairs/s and distinct images/s, the batches' shapes
   (each held by the kernel rows); each index's rankings against NumPy's
   exact top-k of the same vectors, recall recomputed on the host, the
   native HNSW index's recall equal to the flat index's, a profiler pass
   over one batch, and float32 on the card against the CPU on 32 images x
   2 captions (recall equal, vectors within ``F32_VEC_ATOL``);
9. the drivers: ``cli/train_itm`` (``train_itm_cli_phase``) and
   ``cli/pretrain`` (``pretrain_phase``);
10. the cross-encoder (ROADMAP A9), each at UNITER-base width
   (configs/img_base.json) with random weights from ``--seed`` plus
   ``TEACHER_NOISE``: ``rerank`` (``cli/rerank.main`` over synthetic DBs
   with a teacher directory the port saved, stage 2 on the fly in float32
   as JAX's teacher scores;
   pairs/s; a profile of one 128-pair ``CrossScorer`` block; f32 card vs
   CPU scores at 2 layers beside TF32; bf16 vs f32 at 12 layers;
   ``cli/inf_itm``'s results.bin through ``--score_file`` equal to the
   on-the-fly recall in f32), ``train_teacher`` (``cli/train_teacher.main``
   in its joint, self-mining and fast variants; learning on a fixed batch;
   f32 card vs CPU at 2 layers and bf16 vs f32 at 12, each beside a
   control), ``kd`` (``cli/train_itm.main --teacher_checkpoint`` beside the
   same driver without KD; the teacher's forward over a step's 640-pair
   grid) and ``pretrain_kd`` (``cli/pretrain.main`` with a one-tower
   teacher at ``PRE_KD_LAYERS`` layers, then one update per non-itm task).
   The driver phases hold a kernel row at every bf16 shape they recorded
   that no earlier path held, and the float32 teachers' attention (B2) and
   FFN (B3) at every float32 shape, the FFN against the twin's cuBLAS
   float32 pair; at the KD teacher's largest shapes each must be no slower
   than its yardstick (the cuBLAS pair, SDPA in float32);
11. ``vqa`` (ROADMAP A10): ``cli/train_vqa.main`` at configs/coco_ft.json's
   model with 3,129 answers and ``--vqa_lr_mul`` 10 over synthetic DBs of
   the port's ``synth.py``, one epoch with the plain head (its LayerNorm
   3,072 wide) and one with ``--vqa_intersection`` (6,144): ms/step,
   questions/s, a profile; f32 card vs CPU at 2 layers, bf16 vs f32 at 12,
   learning on a fixed batch, ``evaluate_vqa`` card vs CPU;
12. ``prepro`` (A12): ``cli/prepro.py``'s ``img`` and ``txt`` tasks over 500
   region files and 2,500 COCO-style captions (images/s, captions/s, every
   record read back), then ``cli/eval_itm`` on the card over the result;
13. ``dist`` (A11): two ranks on the one card over gloo (processes of this
   script, ``--dist_worker``) at coco_ft.json's width, 32 rows each of a
   global batch of 64, 2 ITM steps in float32 (TF32 off), float32 with a
   hard negative and bf16, held against one process on the global batch
   (float32 also against one process's update, where a planted fault must
   fail), the ranks' weights bit-equal, bf16 at every step within the
   bf16-vs-f32 bound beside a control that must fail, a kernel row at
   every bf16 shape the ranks ran; the step time of two ranks against one
   process and the collectives' times; the same ranks' KD steps (A13:
   a UNITER-base teacher in float32) and VQA steps (A14: 3,129 answers,
   both head forms), in float32 and bf16, held the same way, each beside
   a planted fault that must fail (``_hold_dist_kd_vqa``);
   ``cli/train_itm``, ``cli/train_itm --teacher_checkpoint`` and
   ``cli/train_vqa`` under ``torch.distributed.run`` (one writer, one
   result each); NCCL at world 1 bit-equal to no group (two NCCL ranks
   where there are two cards); the bf16 and int8 Retriever and
   ``DenseShardedIndex`` over ``DeviceMesh([cuda:0, cuda:0])`` against
   the unsharded ones (``dist_phase``);
14. ``examples`` (A15): ``examples/demo_retrieval_torch.py``'s ``main()``
   on the card, its answers equal to ``Retriever.retrieve_query``, and one
   ``/search`` through ``examples/serve_http_torch.py``'s server, equal to
   a direct ``retrieve_query``;
15. ``moonlight``: the Moonlight-16B-A3B tower's kernels against their
   twins at its fine-tuning step's shapes (batch 512, captions padded to
   32): B1's RMS mode (``rmsnorm``, ``rmsnorm_bwd``; library
   ``F.rms_norm``), RoPE, MLA's attention (q/k 192, v 128, causal with pad
   keys masked; ``mla_attention``, ``mla_attention_bwd``; library SDPA),
   the grouped SwiGLU GEMMs in every form (``moe_gemm``: the routed
   experts, 8 of 64 held, the shared experts and the dense layer) and the
   routing's gathers (``moe_combine``, ``moe_scatter_rows``,
   ``moe_route_grad``); then one training step of a 3-layer cut beside
   the image tower under ``torch.cuda.set_sync_debug_mode("error")``, its
   spans and MoE counters recorded and its launches held
   (``moonlight_phase``).

The kernel rows also hold the training kernels at the step's shapes: the
FFN forward writing h1 and gelu(h1) and dh1 at 2,048 and 4,096 rows (in
bfloat16 on the tensor cores, ``ffn_dh1_mma``, also at 256 rows, a split
plan, and 130, a ragged one; in float32 on FMA units, ``ffn_dh1``, the
float32 GEMM of ``ffn.cu`` with its dh1 epilogue, also at 16, 130 and
1,024 rows, the same bits again on a second launch, its first 16 rows
bit-equal to a 16-row call, and ``dh1_f32_yardstick`` rows: at 2,048 and
4,096 rows against its twin and ``torch.mm(g, w2.t())`` alone, which fail
if it is slower than its twin), ``adamw`` over every parameter of both
towers
with a float32 and a bfloat16 first moment, bit for bit, and the fused
training attention (``attention_train_fwd``/``_bwd``) at rate 0.1 at
[64, 32|37|64|104], [8, 256] and head dim 32 (float32 also at [128, 104],
and ``train_attn_f32_yardstick`` rows: at [64, 104] and [128, 104] each
float32 kernel against SDPA in float32, which fail above
``TRAIN_ATTN_F32_RATIO_MAX``), after ``mask`` rows that read
the kernels' Philox keep masks against ``philox_keep`` bit for bit: the
forward's (q = k = 0, v = I), the dk/dv kernel's (g = I) and the dq
kernel's (k = I, g v^T = 1). The float32 kernels of the attention and the
training attention are held bit for bit; the bfloat16 tensor-core kernels
(the attention forwards, the training attention's backward, the FFN and
dh1) within a bf16 ulp of their twins, no less accurate than the twins
against the float32 computation, and the same bits on a second launch; the
``resources`` rows print their registers and spills. Each row carries its
bound (bytes or operations at the card's published rates) and, where one
PyTorch call computes the same function, that call's time.

Each path's kernel launch counters are reset just before it and read just
after it: the bf16 query, encode and training paths must go through the
tensor-core FFN (``ffn_mma``), dh1 (``ffn_dh1_mma``) and backward
(``attention_train_bwd_mma``) and through no FMA form; the float32 checks
of the query tower and of a training step against the CPU (``text_f32``,
``itm_train_f32``) and the float32 step at full width
(``itm_train_f32_full``) through the FMA forms; the training paths through
the LayerNorm backward kernel (``layernorm_bwd``); the bf16 evaluation
(``eval``) through the tensor-core FFN and no FMA form; the Moonlight step
(``moonlight``) through every kernel of its tower. Then one JSON line listing the
kernels, and as the last line ``{"ok": true, "device": {...}}``. The script
imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import re
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


def _load_file(*parts):
    """This checkout's file at ``parts`` as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent.joinpath(*parts)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CORPUS_SIZE = 123_287          # COCO images (train + restval + val + test)
MODEL = dict(vocab_size=28996, project_dim=0)   # BERT-base cased
IMG_DIM = 2048                 # Faster R-CNN region features
IMG_LABEL_DIM = 1601           # detection classes of the MRC soft labels
DEVICE = "cuda"
TOP = 100
# kernel vs twin: float32 within 1e-5 and bfloat16 within one bf16 ulp
# (2**-7), relative to max(1, the twin's largest magnitude); only the
# summation order differs
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# a bfloat16 attention forward on the tensor cores keeps its twin's rounding
# points and sums in another order: its relative L2 error against the
# float32 computation (the twin on the float32 upcast of the same inputs)
# may be at most this times the twin's own: as accurate as the spec, with
# room for the summation order
ACCURACY_RATIO = 1.1
# the card's published rates, the least time work can take on it and the
# device's busy time, as the benchmark states them (benchmark/harness/)
_ROOFLINE = _load_file("benchmark", "harness", "roofline.py")
_TRACE = _load_file("benchmark", "harness", "trace.py")
PEAK_OPS, bound = _ROOFLINE.PEAK_OPS, _ROOFLINE.bound
# the int8 FFN kernel is held to its twin bit for bit: both compute the
# same roundings in the same order, and the int32 sums are exact
# int8 vs bfloat16 tower, cosine of the query embeddings: int8 weights and
# activations keep about two decimal digits per value; H100 runs read
# 0.99960 at seed 0, so the bound leaves 2.5 times that gap
INT8_BF16_COSINE_MIN = 0.999
# int8 tower on the card vs on the CPU: the bf16 roundings inside the tower
# differ by summation order (LayerNorm and attention sums), and every dense
# layer requantizes its input per row, where the int8 step (max|x| / 127,
# ~0.03 on LayerNorm outputs) is only twice the bf16 ulp at 2-4: a one-ulp
# difference often moves an element one int8 level, a fresh quantization
# error that the next layers carry on. H100 runs read embedding cosines of
# 0.99973 and score deltas of 1.7e-3 of the peak score (1.33 of 768; an
# earlier twin whose deferred softmax summed in another order read 2.1e-3);
# with GELU's 2**-0.5 rounded to bf16 as JAX rounds it, which moves other
# elements onto int8 boundaries, 0.99971 and 3.0e-3 (2.32 of 770): held at
# cosine 0.9995 and 5e-3 of the peak score
INT8_CARD_COSINE_MIN = 0.9995
INT8_RANK_RTOL = 5e-3
# corpus encoding: images per run and per batch; the regions per image
# (configs/coco_eval.json:11)
IMAGES = 4096
IMG_BATCH = 128
NUM_BB = 36
# the kernels each path must launch: the bf16 paths the tensor-core FFN,
# dh1 and attention backward, the float32 checks (the query tower against
# the CPU, the training step at attention dropout 0.1 against the CPU) their
# FMA forms
PATH_KERNELS = {"text_f32": ("layernorm", "attention", "ffn"),
                "text_bf16": ("layernorm", "attention", "ffn_mma"),
                "image_bf16": ("layernorm", "attention", "ffn_mma"),
                "int8_serving": ("layernorm", "attention", "ffn_int8"),
                "itm_train": ("layernorm", "layernorm_bwd", "ffn_mma",
                              "ffn_dh1_mma", "adamw", "attention_train_fwd",
                              "attention_train_bwd_mma"),
                "itm_train_f32": ("layernorm", "layernorm_bwd", "ffn",
                                  "ffn_dh1", "adamw", "attention_train_fwd",
                                  "attention_train_bwd"),
                "eval": ("layernorm", "attention", "ffn_mma")}
# the float32 step at full width (configs/coco_ft.json, dropout 0.1): the
# FMA forms, as the float32 check at batch 8
PATH_KERNELS["itm_train_f32_full"] = PATH_KERNELS["itm_train_f32"]
# the training drivers (cli/train_itm.py, cli/pretrain.py): every bf16
# training kernel, and the attention forward of their evaluations
PATH_KERNELS.update({
    path: PATH_KERNELS["itm_train"] + ("attention",)
    for path in ("train_itm_cli", "pretrain")})
# the cross-encoder paths (ROADMAP A9): re-ranking scores through the
# inference kernels; teacher training, KD fine-tuning and pre-training KD
# train through every bf16 training kernel, and their teachers' (and the
# self-mining scoring pass's) forwards through the attention forward
PATH_KERNELS["rerank"] = ("layernorm", "attention", "ffn_mma")
PATH_KERNELS.update({
    path: PATH_KERNELS["itm_train"] + ("attention",)
    for path in ("train_teacher", "kd", "pretrain_kd")})
# VQA fine-tuning (ROADMAP A10): every bf16 training kernel (the head's
# LayerNorm at 3,072 and 6,144 through B1's forward and backward), and the
# attention forward of its validation
PATH_KERNELS["vqa"] = PATH_KERNELS["itm_train"] + ("attention",)
# the dist phase (ROADMAP A11): every rank's bf16 steps (coco_ft.json's
# dropout 0.1) every bf16 training kernel; its float32 steps (dropout 0)
# the FMA forms and the attention forward; the sharded Retriever the
# query paths' kernels (bf16; the int8 tower's B4)
PATH_KERNELS["dist"] = PATH_KERNELS["itm_train"]
PATH_KERNELS["dist_f32"] = ("layernorm", "layernorm_bwd", "attention",
                            "ffn", "ffn_dh1", "adamw")
PATH_KERNELS["dist_sharded_bf16"] = PATH_KERNELS["text_bf16"]
PATH_KERNELS["dist_sharded_int8"] = PATH_KERNELS["int8_serving"]
# re-ranking and KD: the cross-encoder teacher scores in float32, as
# JAX's does, through the float32 FFN (an FMA form), beside the bf16
# bi-encoder's kernels
PATH_KERNELS["rerank"] = ("layernorm", "attention", "ffn_mma", "ffn")
PATH_KERNELS["kd"] = PATH_KERNELS["kd"] + ("ffn",)
# KD and VQA across the dist ranks (ROADMAP A13, A14) at dropout 0: the
# bf16 steps through the tensor-core FFN and dh1, the attention forward
# (its backward recomputes) and the LayerNorm backward; KD's float32
# teacher through the float32 FFN too; their float32 steps through the
# FMA forms. The examples: the query and encode paths' kernels
PATH_KERNELS["dist_kd"] = ("layernorm", "layernorm_bwd", "attention",
                           "ffn_mma", "ffn_dh1_mma", "adamw", "ffn")
PATH_KERNELS["dist_vqa"] = PATH_KERNELS["dist_kd"][:-1]
PATH_KERNELS["dist_kd_f32"] = PATH_KERNELS["dist_f32"]
PATH_KERNELS["dist_vqa_f32"] = PATH_KERNELS["dist_f32"]
PATH_KERNELS["examples"] = PATH_KERNELS["text_bf16"]
# the Moonlight step (eval mode, as dist_vqa's steps at dropout 0): the
# image tower's bf16 kernels and every kernel of the text tower
PATH_KERNELS["moonlight"] = PATH_KERNELS["dist_vqa"] + (
    "rmsnorm", "rmsnorm_bwd", "mla_attention", "mla_attention_bwd", "rope",
    "moe_gemm", "moe_combine", "moe_scatter_rows", "moe_route_grad")
# the device kernels of B5's float32 forms (the forward is attention.cu's
# kernel with its dropout pass), whose share of the float32 step the
# profile row reads
B5_F32_KERNELS = r"attention_kernel<true>|bwd_q_kernel|bwd_kv_kernel"
# and B6's float32 form: ffn.cu's transpose of W2, then its GEMM with the
# dh1 epilogue (2), in the wide or the narrow tile (no tensor-core GEMM
# runs in the float32 step): two device kernels a launch
DH1_F32_KERNELS = r"::(transpose_b_kernel|(gemm|narrow)_kernel<2[,>])"
DH1_F32_DEVICE_KERNELS = 2
# the FMA forms that a bf16 path must not launch, and those that a path's
# float32 part (the teachers) does launch
FMA_KERNELS = ("ffn", "ffn_dh1", "attention_train_bwd")
FMA_ALLOWED = {"rerank": ("ffn",), "kd": ("ffn",), "dist_kd": ("ffn",)}


def hold_path(path, counts):
    """Emit a path's launch counts; fail if a kernel it must launch did not
    run, or (bf16 paths) an FMA form did, other than its float32 part's."""
    emit(phase="main_path_launches", path=path, **counts)
    check(all(counts[k] > 0 for k in PATH_KERNELS[path]),
          f"{path}: a kernel of the path was not launched: {counts}")
    check("f32" in path.split("_") or all(
        counts[k] == 0 for k in FMA_KERNELS
        if k not in FMA_ALLOWED.get(path, ())),
        f"{path}: the bf16 path went through an FMA kernel: {counts}")
# the Philox keep masks: at rate 0.1 the kept fraction of the >= 1e6 draws
# read from the kernels must be 0.9 within this
KEEP_FRACTION_TOL = 0.005
# ITM fine-tuning (configs/coco_ft.json): batch, timed steps after 3
# warm-up steps, and the fixed-batch learning check: LEARN_STEPS steps at a
# constant LEARN_LR must bring the mean of the last five losses under
# LEARN_LOSS_FRAC of the first. The first is not ln 64 = 4.16: the random
# projection heads give 768-d vectors of norm ~20 whose scores spread by
# ~10, so it starts near 24 (a probe on an H100 read 24.5, then 11.5 after
# 12 steps at this lr)
TRAIN_BATCH = 64
TRAIN_STEPS = 20
LEARN_LR = 1e-4
LEARN_STEPS = 30
LEARN_LOSS_FRAC = 0.5
# float32 training, card vs the CPU plain path at batch 8: the loss before
# and after two steps, and every gradient leaf (relative L2), where only
# summation orders differ. An H100 run read 4.4e-6 and 5.4e-6 for the
# losses (scores of ~10-20 through 24 layers) and 1.7e-5 for the worst
# leaf; the control, TF32 products, read 8.4e-4 and 5.5e-3: the bounds sit
# 5-6 times above the readings and 28-55 times below the control
TRAIN_F32_LOSS_RTOL = 3e-5
TRAIN_F32_GRAD_RTOL = 1e-4
# bfloat16 vs float32 training on the card: the loss and the cosine of the
# whole gradient (an H100 run read 1.5e-3 and 0.9938; the control, the
# float32 gradient of another batch, read a cosine of -0.002). The loss of
# a batch of 8 moves with every bf16 rounding inside the towers: the
# embeddings (norm ~20) move by ~1 % (cosine 0.9999), each score of ~10-20
# by ~0.2, the loss by a few percent, and a change of summation order alone
# redraws it. ``bf16_loss_controls`` reads the spread beside the check, over
# four batches and three valid bf16 attentions; an H100 run read 2.5e-3 to
# 4.5e-2 through the tensor-core kernel (3.4e-2 on the checked batch), 1.8e-3
# to 1.2e-2 through its twin on the card (the FMA kernel's bits) and 9.8e-3
# to 3.2e-2 through the plain path on the CPU, which an earlier bound of
# 2e-2 would have refused. A fault in a kernel moves the loss by tens of
# percent
TRAIN_BF16_LOSS_RTOL = 6e-2
TRAIN_BF16_COSINE_MIN = 0.98
# float32 tower on the card vs on the CPU: the query vector may differ by
# float32 summation order (1e-3 absolute on unit-scale LayerNorm outputs
# after 12 layers), and then rounds to bfloat16 for the corpus product, where
# a few of its 768 elements can land one bf16 ulp apart: rankings are held
# at 5e-4 of the peak score
F32_VEC_ATOL = 1e-3
F32_RANK_RTOL = 5e-4
# bfloat16 vs float32 tower, cosine of the query and image embeddings (the
# text tower read 0.99993 on an H100)
BF16_COSINE_MIN = 0.999
# served (coalesced batch) vs direct single-query bfloat16 rankings: another
# batch size sums in another order (cuBLAS picks other kernels, the FFN
# kernel other splits), which moves bf16 roundings inside the tower and
# compounds over 12 layers; the first run on an H100 measured score deltas
# up to 9.4e-4 of the peak score, so rankings are held at 2e-3 of it (the
# serve phase also prints the embedding jitter itself)
SERVE_RANK_RTOL = 2e-3
# the loadgen phase: two offered rates, as shares of the rate that the
# bf16 batch-64 p50 implies (64 / p50), 2 s each over 8 connections; the
# full sweep is scripts/bench_torch_serving.py's
LOADGEN_SHARES = (0.3, 0.8)
LOADGEN_SECONDS = 2.0
# evaluation (cli/eval_itm.py at configs/coco_eval.json's model and data
# settings): synthetic DBs of EVAL_IMAGES images with EVAL_CAPTIONS
# captions each (the COCO test split has 5,000 x 5, cut for the run's
# time; widths are not cut), 10-100 regions an image (conf_th 0.2,
# min_bb 10, max_bb 100), captions of 4-58 ids (max_txt_len 60); and the
# float32 card-vs-CPU check on EVAL_F32_IMAGES x EVAL_F32_CAPTIONS
EVAL_IMAGES = 500
EVAL_CAPTIONS = 5
# its encode shapes (valid_batch_size, sequence): captions at S 64 (up to
# 60 tokens) and images at 1 + 103 (100 regions); the kernel rows hold
# attention, LayerNorm and the bf16 FFN at these shapes, and the eval
# phase checks that its batches ran at no other
EVAL_BATCH = 80
EVAL_SEQS = (64, 104)
EVAL_ROWS = tuple(EVAL_BATCH * s for s in EVAL_SEQS)
EVAL_F32_IMAGES = 32
EVAL_F32_CAPTIONS = 2
# the flat index against NumPy's exact top-k of the same vectors: ids may
# differ only among scores tied within this share of the peak score
# (float32 on both sides, only the summation order differs)
EVAL_TIE_RTOL = 1e-5
# the training drivers' phases: synthetic images x 5 captions (COCO's
# train split has 113,287 images, its test split 5,000; cut for the run's
# time, widths not cut), 2 epochs of cli/train_itm.py; for cli/pretrain.py
# images with soft labels, PRE_UPDATES updates of 6 micro-batches
FT_CONFIG = "configs/coco_ft.json"
EVAL_CONFIG = "configs/coco_eval.json"
PRE_CONFIG = "configs/pretrain_alldata_base.json"
FT_TRAIN_IMAGES = 200
FT_VAL_IMAGES = 100
PRE_TRAIN_IMAGES = 240
PRE_VAL_IMAGES = 48
PRE_UPDATES = 2
# pre-training, bfloat16 vs float32 at full depth per task: |loss delta| /
# loss and the cosine of the whole gradient. An H100 run read 1.5e-2 /
# 0.9930 (itm), 1.3e-5 / 0.99988 (mlm), 2.3e-6 / 0.99997 (mrfr) and 1.9e-4
# / 0.99996 (mrckl); each bound sits 4-9 times above its reading. The
# control, which every bound must refuse, is the float32 reference with its
# weights and layer outputs rounded to PRE_CONTROL_MANTISSA_BITS mantissa
# bits (bf16 keeps 7); it read 0.25 / 0.738, 1.5e-4 / 0.9925, 1.5e-3 /
# 0.9928 and 4.4e-3 / 0.9928. mlm's loss has no reading at the control: on
# an H100 the same control read 1.5e-4 and, once the float32 FFN summed in
# another order (the same function within 1e-5), 8.2e-7, under bf16's own
# reading, while its cosine read 0.9926 both times. Rounding to nearest
# leaves a random-init mlm loss almost where it was, so mlm is held to its
# control by its cosine alone (PRE_CONTROL_COSINE_ONLY)
PRE_BF16_BOUNDS = {"itm": (6e-2, 0.98), "mlm": (5e-5, 0.999),
                   "mrfr": (2e-5, 0.9997), "mrckl": (1e-3, 0.9997)}
PRE_CONTROL_MANTISSA_BITS = 3
PRE_CONTROL_COSINE_ONLY = {"mlm"}
# the VQA head's LayerNorm rows (batch, width): 4 x 768 = 3,072 wide, 8 x
# 768 = 6,144 with --vqa_intersection; the training batch (64), the
# validation batch (coco_ft.json's valid_batch_size, 256) and a ragged 37
VQA_LN_ROWS = ((64, 3072), (64, 6144), (256, 3072), (256, 6144), (37, 6144))
# the answer vocabulary (VQA v2; the JAX driver's --num_answers default)
VQA_ANSWERS = 3129
# (groups, calls per group) of the kernel rows held at the shapes the
# drivers' phases recorded: fewer than the other rows' (7, 10), for the
# number of shapes
RECORDED_TIMING = (3, 5)
# reads of a float32 FMA kernel and its yardstick, taken in turn, whose
# medians kd_phase compares at the KD teacher's largest shapes
KD_YARDSTICK_ROUNDS = 7
# B5's float32 kernels at the image tower's training shapes (batch 64, and
# 128 rows with a mined negative; S 104 at max_bb 100) against SDPA in
# float32, read KD_YARDSTICK_ROUNDS times in turn: the median of kernel /
# SDPA may be at most this. The first port (one thread an output element
# from shared memory) read about 3.0; the redesign's goal is 1.0
TRAIN_ATTN_YARDSTICK_SHAPES = ((64, 104), (128, 104))
TRAIN_ATTN_F32_RATIO_MAX = 1.5
# B6's float32 kernel at the float32 step's rows (text 64 x 32, image 64
# x 64) against its twin, read KD_YARDSTICK_ROUNDS times in turn: the
# median of kernel / twin may be at most 1
DH1_YARDSTICK_ROWS = (2048, 4096)

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


_T0 = time.perf_counter()


def emit(**fields) -> None:
    """One JSON row, stamped with the seconds since the script started
    (``elapsed_s``: where the run's time goes, phase by phase)."""
    fields.setdefault("elapsed_s", round(time.perf_counter() - _T0, 1))
    print(json.dumps(fields), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _warm_up_stream() -> torch.cuda.Stream:
    """One side stream for every warm-up: cuBLAS keeps a workspace (32 MiB
    on Hopper) for each stream it has run on, so a new stream per call
    would leave ~1 GiB allocated under the later phases' memory readings."""
    return torch.cuda.Stream()


def time_ms(fn, groups: int = 7, per_group: int = 10) -> float:
    """Device time of one call: ``per_group`` calls captured in a CUDA
    graph (so the host's launch cost is out of the measurement), replayed
    ``groups`` times between CUDA events; the median over groups of the
    mean per call. Inputs stay in the 50 MB L2 between calls. The warm-up
    call runs on a side stream, as capturing a call that runs autograd
    wants."""
    side = _warm_up_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
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


def time_eager_ms(fn, calls: int = 10, groups: int = 5) -> float:
    """Device time of one call launched eagerly (for a wrapper that copies a
    host table to the card on every call, which a CUDA graph must not
    capture): ``calls`` back-to-back calls between CUDA events, the median
    over ``groups`` of the mean per call. The host enqueues faster than
    such a kernel runs, so the events time the device."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _flat(out):
    if isinstance(out, tuple):
        return torch.cat([t.float().reshape(-1) for t in out])
    return out


def compare(name, shape, dtype, kernel, twin, device_name, work,
            library=None, exact=False, reference=None, repeat=False,
            timing=(7, 10), plain_eager=False, **extra):
    """Hold a kernel against its twin on the same inputs and time both (and
    ``library``, one PyTorch call computing the same function, where there
    is one); ``work`` = (bytes, operations, peak rate) for the bound;
    ``exact``: bit for bit; ``reference``: the float32 computation of the
    same inputs, against which the kernel's relative L2 error may be at most
    ``ACCURACY_RATIO`` times the twin's; ``repeat``: a second launch must
    give the same bits; ``timing`` = (groups, calls per group) of
    :func:`time_ms`; ``plain_eager``: the twin waits for the host, so it
    is timed by :func:`time_eager_ms`."""
    got, want = kernel(), twin()
    again = kernel() if repeat else None
    torch.cuda.synchronize()
    got, want = _flat(got), _flat(want)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} {shape}: kernel gave {got.dtype}{tuple(got.shape)}, twin "
          f"{want.dtype}{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {shape}: non-finite")
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    differ = (got != want).float().mean().item()
    tol = 0.0 if exact else TOL[dtype] * max(1.0, peak)
    held = {}
    if reference is not None:
        ref = _flat(reference()).float()
        held.update({f"rel_l2_{who}": ((x.float() - ref).norm() / ref.norm())
                     .item() for who, x in (("kernel", got), ("twin", want))},
                    rel_l2_ratio_max=ACCURACY_RATIO)
    if repeat:
        held["deterministic"] = bool(torch.equal(_flat(again), got))
    bound_ms, bound_by = bound(*work)
    row = dict(phase="kernel", kernel=name, shape=list(shape),
               dtype=str(dtype).replace("torch.", ""), **extra,
               max_abs_err=err, tol=tol, differ_frac=differ, **held,
               ms=time_ms(kernel, *timing),
               plain_ms=(time_eager_ms(twin) if plain_eager
                         else time_ms(twin, *timing)),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None if library is None else time_ms(library,
                                                               *timing),
               device=device_name)
    emit(**row)
    check(err <= tol, f"{name} {shape} {dtype}: error {err} > {tol}")
    check(not exact or differ == 0.0,
          f"{name} {shape}: {differ:.3%} of elements differ")
    check(reference is None or held["rel_l2_kernel"]
          <= ACCURACY_RATIO * held["rel_l2_twin"],
          f"{name} {shape}: less accurate than its twin against float32: "
          f"{held}")
    check(not repeat or held["deterministic"],
          f"{name} {shape}: a second launch gave other bits")
    return row


def _peak(dtype):
    return PEAK_OPS["bf16" if dtype == torch.bfloat16 else "f32"]


def make_randn(seed):
    """(randn, generator): normal tensors on the card from one seeded
    generator, in a given dtype and scale."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)

    return randn, g


def _attention_inputs(b, s, d, dtype, randn, g):
    """q, k, v [b, s, 12, d] and the additive key bias of ragged masks."""
    dev = torch.device("cuda")
    q, k, v = (randn(b, s, 12, d, dtype=dtype) for _ in range(3))
    lens = torch.randint(1, s + 1, (b,), device=dev, generator=g)
    mask = torch.arange(s, device=dev)[None, :] < lens[:, None]
    return q, k, v, ((1.0 - mask.float()) * -10000.0)[:, None, None, :]


def _ffn_inputs(n, dtype, randn):
    """x [n, 768], w1, b1, w2, b2 of a 768 -> 3,072 -> 768 FFN."""
    return (randn(n, 768, dtype=dtype),
            randn(768, 3072, scale=0.02, dtype=dtype),
            randn(3072, scale=0.02),
            randn(3072, 768, scale=0.02, dtype=dtype),
            randn(768, scale=0.02))


def attention_row(b, s, d, dtype, device_name, randn, g, **kw):
    """B2 at [b, s, 12 heads, d] with ragged key masks: float32 bit for bit
    (every row sums in the twin's order); bfloat16 within the tolerance,
    as accurate as the twin, deterministic. Library: SDPA."""
    from lightningdot_tpu_torch.ops import attention

    isz = torch.finfo(dtype).bits // 8
    q, k, v, bias = _attention_inputs(b, s, d, dtype, randn, g)
    half = dtype == torch.bfloat16
    return compare(
        "attention", (b, s, 12, d), dtype,
        lambda: attention.multi_head_attention(q, k, v, bias),
        lambda: attention._attention_math(q, k, v, bias, d ** -0.5),
        device_name,
        (4 * b * s * 12 * d * isz + b * s * 4, 4 * b * 12 * s * s * d,
         _peak(dtype)),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=bias.to(dtype)), exact=not half,
        reference=(lambda: attention._attention_math(
            q.float(), k.float(), v.float(), bias, d ** -0.5))
        if half else None, repeat=True, **kw)


def ffn_rows(n, dtype, device_name, randn, train, **kw):
    """B3 over n rows (768 -> 3072 -> 768): the forward, and where
    ``train`` the training forward that also writes h1 and gelu(h1).
    bfloat16 on the tensor cores within a bf16 ulp, as accurate as the twin
    against the float32 computation of the same inputs; float32 on FMA
    units within 1e-5, its first 16 rows alone (the narrow tile) giving
    the same bits. Both the same bits again on a second launch."""
    from lightningdot_tpu_torch.ops import ffn

    isz = torch.finfo(dtype).bits // 8
    half = dtype == torch.bfloat16
    name = "ffn_mma" if half else "ffn"
    x, w1, b1, w2, b2 = _ffn_inputs(n, dtype, randn)
    io = (2 * n * 768 + 2 * 768 * 3072) * isz + (768 + 3072) * 4
    held = dict(
        reference=lambda: ffn._ffn_math(x.float(), w1.float(), b1,
                                        w2.float(), b2)[0],
        repeat=True) if half else dict(repeat=True)
    if not half and n > 16:
        # the first 16 rows alone take the narrow tile: the same bits
        held["rows16_bits_equal"] = bool(torch.equal(
            ffn.ffn_gelu(x[:16], w1, b1, w2, b2),
            ffn.ffn_gelu(x, w1, b1, w2, b2)[:16]))
    rows = [compare(
        name, (n, 768, 3072), dtype,
        lambda: ffn.ffn_gelu(x, w1, b1, w2, b2),
        lambda: ffn._ffn_math(x, w1, b1, w2, b2)[0], device_name,
        (io, 4 * n * 768 * 3072, _peak(dtype)), mode="forward", **held,
        **kw)]
    check(rows[0].get("rows16_bits_equal", True),
          f"ffn {n} rows float32: the first 16 rows alone gave other bits")
    if train:
        def twin_h1(x=x, w1=w1, w2=w2):
            out, h1 = ffn._ffn_math(x, w1, b1, w2, b2)
            return out, h1, ffn.gelu(h1)

        held = dict(reference=lambda: twin_h1(
            x.float(), w1.float(), w2.float()), repeat=True) if half else \
            dict(repeat=True)
        rows.append(compare(
            name, (n, 768, 3072), dtype,
            lambda: ffn.ffn_cuda(x, w1, b1, w2, b2, with_h1=True),
            twin_h1, device_name,
            (io + 2 * n * 3072 * isz, 4 * n * 768 * 3072, _peak(dtype)),
            mode="train", **held, **kw))
    return rows


def _dh1_inputs(n, dtype, randn):
    """g [n, 768], h1 [n, 3,072] and w2 [3,072, 768] of B6."""
    return (randn(n, 768, dtype=dtype), randn(n, 3072, dtype=dtype),
            randn(3072, 768, scale=0.02, dtype=dtype))


def _dh1_work(n, dtype):
    """B6's (bytes, operations, peak) over n rows: g, h1 and w2 read once,
    dh1 written once; 2 n H I flops."""
    isz = torch.finfo(dtype).bits // 8
    return ((n * 768 + 2 * n * 3072 + 3072 * 768) * isz,
            2 * n * 768 * 3072, _peak(dtype))


def dh1_row(n, dtype, device_name, randn, **kw):
    """B6, dh1 over n rows: bf16 on the tensor cores (``ffn_dh1_mma``),
    held as the bf16 FFN rows; float32 on FMA units (``ffn_dh1``, the
    float32 GEMM of ``ffn.cu`` with its dh1 epilogue) within 1e-5, its
    first 16 rows alone (the narrow tile) giving the same bits. Both the
    same bits again on a second launch."""
    from lightningdot_tpu_torch.ops import ffn_dh1

    half = dtype == torch.bfloat16
    gr, h1, w2 = _dh1_inputs(n, dtype, randn)
    held = dict(reference=lambda: ffn_dh1._dh1_math(
        gr.float(), h1.float(), w2.float()), repeat=True) if half else \
        dict(repeat=True)
    if not half and n > 16:
        # the first 16 rows alone take the narrow tile: the same bits
        held["rows16_bits_equal"] = bool(torch.equal(
            ffn_dh1.ffn_dh1(gr[:16], h1[:16], w2),
            ffn_dh1.ffn_dh1(gr, h1, w2)[:16]))
    row = compare(
        "ffn_dh1_mma" if half else "ffn_dh1", (n, 768, 3072), dtype,
        lambda: ffn_dh1.ffn_dh1_cuda(gr, h1, w2),
        lambda: ffn_dh1._dh1_math(gr, h1, w2), device_name,
        _dh1_work(n, dtype), **held, **kw)
    check(row.get("rows16_bits_equal", True),
          f"ffn_dh1 {n} rows float32: the first 16 rows alone gave other "
          f"bits")
    return row


def dh1_f32_yardstick(device_name):
    """B6's float32 kernel at the float32 step's rows (text 2,048, image
    4,096) against its twin (cuBLAS's float32 g W2^T, then gelu' in eager
    ops) and against ``torch.mm(g, w2.t())`` alone (TF32 off), read
    ``KD_YARDSTICK_ROUNDS`` times in turn: the medians of kernel / twin,
    kernel / product and kernel / bound. Fails if the kernel is slower
    than its twin."""
    from lightningdot_tpu_torch.ops import ffn_dh1

    randn, _ = make_randn(19)
    for n in DH1_YARDSTICK_ROWS:
        gr, h1, w2 = _dh1_inputs(n, torch.float32, randn)
        bound_ms = bound(*_dh1_work(n, torch.float32))[0]
        reads = [(time_ms(lambda: ffn_dh1.ffn_dh1_cuda(gr, h1, w2),
                          *RECORDED_TIMING),
                  time_ms(lambda: ffn_dh1._dh1_math(gr, h1, w2),
                          *RECORDED_TIMING),
                  time_ms(lambda: torch.mm(gr, w2.t()), *RECORDED_TIMING))
                 for _ in range(KD_YARDSTICK_ROUNDS)]
        twin = [k / t for k, t, _ in reads]
        row = dict(phase="dh1_f32_yardstick", kernel="ffn_dh1",
                   shape=[n, 768, 3072],
                   ms=statistics.median(r[0] for r in reads),
                   plain_ms=statistics.median(r[1] for r in reads),
                   product_ms=statistics.median(r[2] for r in reads),
                   bound_ms=bound_ms, ratio_to_twin=statistics.median(twin),
                   ratio_to_twin_min=min(twin), ratio_to_twin_max=max(twin),
                   ratio_to_product=statistics.median(
                       k / m for k, _, m in reads),
                   ratio_to_bound=statistics.median(
                       k / bound_ms for k, _, _ in reads),
                   rounds=len(reads), device=device_name)
        emit(**row)
        check(row["ratio_to_twin"] <= 1.0,
              f"ffn_dh1 float32 at {n} rows: {row['ratio_to_twin']:.3f} x "
              f"its twin: {row}")


def kernel_phase(device_name):
    from lightningdot_tpu_torch.ops import ffn_int8

    randn, g = make_randn(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows += layernorm_rows(dtype, device_name, randn)
        # query buckets; the encode batches (captions at S 32, images at 1
        # + R with R = bucket_len(num_bb + 1) - 1, itm_fast_collate: S 64
        # at num_bb 36, 104 at 100); and for later slices S 65 and 105 (R
        # bucketed without the [CLS] slot, itm.py:261), 128 (the longest
        # text bucket), 192 and 256 (caption buckets); S 37 and head dim 32
        # for the ragged paths (keys padded to 48, head rows to 64)
        for b, s, d in ([(b, s, 64) for b in (1, 8, 64, 256)
                         for s in (16, 32, 64)]
                        + [(128, s, 64) for s in (32, 64, 104)]
                        + [(b, s, 64) for b in (1, 64)
                           for s in (65, 105, 128)]
                        + [(b, s, 64) for b in (8, 64) for s in (192, 256)]
                        + [(64, 37, 64), (64, 64, 32)]
                        + [(EVAL_BATCH, s, 64) for s in EVAL_SEQS]):
            rows.append(attention_row(b, s, d, dtype, device_name, randn, g))
        rows += fused_attention_rows(dtype, device_name, randn)
        if dtype == torch.float32:
            train_attn_f32_yardstick(device_name)
        # query rows (batch x length), the training rows (text 2,048 and
        # image 4,096, also with h1 and gelu(h1) out), then in bfloat16 the
        # encode batches: 128 captions x 32, 128 images x 64 and x 104, and
        # the eval batches of 80 x 64 and 80 x 104
        half = dtype == torch.bfloat16
        for n in (16, 32, 256, 2048, 4096) + (
                (8192, 13312) + EVAL_ROWS if half else ()):
            rows += ffn_rows(n, dtype, device_name, randn,
                             train=n in (2048, 4096))
        # dh1 at the training rows (text 2,048, image 4,096), a ragged
        # count (130) and, in bfloat16, a split plan (256 rows); in float32
        # the narrow tiles (16, 130 rows) and the dist ranks' text rows
        # (1,024)
        for n in (130, 256, 2048, 4096) if half else (16, 130, 1024, 2048,
                                                       4096):
            rows.append(dh1_row(n, dtype, device_name, randn))
        if not half:
            dh1_f32_yardstick(device_name)
    # the int8 FFN takes bfloat16 activations only; per-channel int8
    # weights, quantized as QuantizedDense does, in the [in, out] view of
    # out-major storage
    w1q, s1 = ffn_int8._quant_rows(randn(3072, 768, scale=0.02))
    w2q, s2 = ffn_int8._quant_rows(randn(768, 3072, scale=0.02))
    w1, w2, s1, s2 = w1q.t(), w2q.t(), s1[:, 0], s2[:, 0]
    b1, b2 = randn(3072, scale=0.02), randn(768, scale=0.02)
    # the query batches (16-32 rows), a split plan (256), the encode and
    # training rows, and a ragged count: bit-equal, the same bits again
    for n in (16, 32, 37, 256, 2048, 4096):
        x = randn(n, 768, dtype=torch.bfloat16)
        rows.append(compare(
            "ffn_int8", (n, 768, 3072), torch.bfloat16,
            lambda: ffn_int8.ffn_gelu_int8(x, w1, s1, b1, w2, s2, b2),
            lambda: ffn_int8._ffn_int8_math(x, w1, s1, b1, w2, s2, b2),
            device_name,
            (2 * n * 768 * 2 + 2 * 768 * 3072 + (768 + 3072) * 8,
             4 * n * 768 * 3072, PEAK_OPS["int8"]), exact=True,
            repeat=True))
    rows += adamw_rows(device_name)
    return rows


def _ln_params(h, randn, gen):
    return (torch.rand(h, device="cuda", generator=gen) + 0.5, randn(h))


def _ln_mask_inputs(n, h, dtype, randn, gen, variant):
    """(res, keep, rate) of a LayerNorm site: none (``None``/``ln``), a
    residual (``res``), or a residual and a rate-0.1 mask
    (``res_keep``)."""
    if variant in (None, "ln"):
        return None, None, 0.0
    res = randn(n, h, dtype=dtype)
    if variant == "res":
        return res, None, 0.0
    return res, torch.rand(n, h, device="cuda", generator=gen) < 0.9, 0.1


def ln_fwd_row(n, h, dtype, device_name, randn, gen, variant=None, **kw):
    """B1's forward over [n, h], plain or with its mask-and-add prologue
    (``variant`` res or res_keep): within the twin's tolerance, and with a
    prologue bit-equal to the kernel run on the twin's u. Library:
    ``F.layer_norm`` (on the twin's u, without the add and the mask)."""
    from lightningdot_tpu_torch.ops import layernorm as ln

    isz = torch.finfo(dtype).bits // 8
    eps = 1e-12
    x = randn(n, h, scale=3.0, dtype=dtype) + 1
    res, keep, rate = _ln_mask_inputs(n, h, dtype, randn, gen, variant)
    scale, bias = _ln_params(h, randn, gen)
    u = ln.dal_input(x, res, keep, rate)
    held = {}
    if variant is not None:
        same = torch.equal(
            ln.layer_norm_cuda(x, scale, bias, eps, res, keep, rate),
            ln.layer_norm_cuda(u, scale, bias, eps))
        check(same, f"layernorm {variant} ({n}, {h}) {dtype}: the "
                    f"prologue's u differs from the twin's")
        held = dict(variant=variant, equal_to_kernel_on_twin_u=same)
    nbytes = ((2 if res is None else 3) * n * h * isz + 2 * h * 4
              + (0 if keep is None else n * h))
    return compare(
        "layernorm", (n, h), dtype,
        lambda: ln.layer_norm_cuda(x, scale, bias, eps, res, keep, rate),
        lambda: ln.ln_fwd_math(x, scale, bias, eps, res, keep, rate),
        device_name, (nbytes, (8 if res is None else 11) * n * h,
                      PEAK_OPS["f32"]),
        library=lambda: torch.nn.functional.layer_norm(
            u, (h,), scale.to(dtype), bias.to(dtype), eps), **held, **kw)


def ln_bwd_row(n, h, variant, dtype, device_name, randn, gen, **kw):
    """B1's backward kernel over [n, h] (``variant`` ln, res or
    res_keep): dx and du held as the bf16 tensor-core rows are (a bf16 ulp,
    as accurate against the float32 computation as the twin, the same bits
    again; float32 within 1e-5), dscale and dbias within 1e-5 of their
    peak and repeat-equal. Library: aten's ``native_layer_norm_backward``
    with the statistics computed outside the timed call (without the
    recompute of u and the mask)."""
    from lightningdot_tpu_torch.ops import layernorm as ln

    isz = torch.finfo(dtype).bits // 8
    half = dtype == torch.bfloat16
    eps = 1e-12
    x = randn(n, h, scale=3.0, dtype=dtype) + 1
    g = randn(n, h, dtype=dtype)
    r, k, rate = _ln_mask_inputs(n, h, dtype, randn, gen, variant)
    scale, bias = _ln_params(h, randn, gen)
    args = (x, scale, g, eps, r, k, rate)

    def pick(out):
        """dx and du (one tensor without a mask)."""
        return out[1] if k is None else out[:2]

    got, again = (ln.layer_norm_bwd_cuda(*args) for _ in range(2))
    want = ln.ln_bwd_math(*args)
    param_err = max((a - w).abs().max().item() / w.abs().max().item()
                    for a, w in zip(got[2:], want[2:]))
    param_same = all(torch.equal(a, b) for a, b in zip(got[2:], again[2:]))
    u = ln.dal_input(x, r, k, rate)
    w16, b16 = scale.to(dtype), bias.to(dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(u, [h], w16, b16, eps)
    acts = 2 + (r is not None) + 1 + (k is not None)
    row = compare(
        "layernorm_bwd", (n, h), dtype,
        lambda: pick(ln.layer_norm_bwd_cuda(*args)),
        lambda: pick(ln.ln_bwd_math(*args)), device_name,
        (acts * n * h * isz + (0 if k is None else n * h) + 3 * h * 4,
         20 * n * h, PEAK_OPS["f32"]),
        library=lambda: torch.ops.aten.native_layer_norm_backward(
            g, u, [h], mean, rstd, w16, b16, [True, True, True]),
        reference=(lambda: pick(ln.ln_bwd_math(
            x.float(), scale, g.float(), eps,
            None if r is None else r.float(), k, rate))) if half else None,
        repeat=True, variant=variant, params_rel_err=param_err,
        params_rel_tol=1e-5, params_deterministic=param_same, **kw)
    check(param_err <= 1e-5 and param_same,
          f"layernorm_bwd {variant} ({n}, {h}) {dtype}: dscale and "
          f"dbias off by {param_err} or not repeat-equal")
    return row


def layernorm_rows(dtype, device_name, randn):
    """B1 at the paths' row counts. The forward kernel against its twin at
    32-16,384 rows (the query batches, the training batches of 64 x 32
    text and 64 x 64 image rows, the encode batches of 128 at S 64 and
    104, the eval batches of 80 at S 64 and 104), and with its prologue
    (res; res and a rate-0.1 mask) at 32, 2,048 and 4,096 rows. The
    backward kernel at 130 (ragged), 2,048 and 4,096 rows, without res
    (the plain LayerNorm sites), with res (rate 0) and with res and a
    rate-0.1 mask (the training sites); both at the training step's
    projection head too (64 rows of 1,536, a row over two warps), without
    res. Then the VQA head's widths (``VQA_LN_ROWS``: 3,072, and 6,144
    with ``--vqa_intersection``, at the training batch of 64, the
    validation batch of 256 and a ragged 37), forward and backward,
    without res, and once each with the mask-and-add prologue."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for n, h in ([(n, 768) for n in (32, 2048, 4096, 8192, 13312, 16384)
                  + EVAL_ROWS] + [(64, 1536)]):
        rows.append(ln_fwd_row(n, h, dtype, device_name, randn, gen))
    for n in (32, 2048, 4096):
        for variant in ("res", "res_keep"):
            rows.append(ln_fwd_row(n, 768, dtype, device_name, randn, gen,
                                   variant))
    for n, h in ((130, 768), (2048, 768), (4096, 768), (64, 1536)):
        for variant in ("ln", "res", "res_keep")[:1 if h > 768 else 3]:
            rows.append(ln_bwd_row(n, h, variant, dtype, device_name, randn,
                                   gen))
    for n, h in VQA_LN_ROWS:
        rows.append(ln_fwd_row(n, h, dtype, device_name, randn, gen))
        rows.append(ln_bwd_row(n, h, "ln", dtype, device_name, randn, gen))
    rows.append(ln_fwd_row(64, 6144, dtype, device_name, randn, gen,
                           "res_keep"))
    rows.append(ln_bwd_row(64, 6144, "res_keep", dtype, device_name, randn,
                           gen))
    return rows


def train_attention_rows(b, s, d, dtype, device_name, randn, gen, **kw):
    """B5 at rate 0.1 over [b, s, 12 heads, d], forward and backward,
    against their twins with the same seed; float32 bit for bit, bfloat16
    as the attention rows. Library: SDPA with the additive mask at dropout
    0 (forward; forward and backward for the backward row, captured in a
    CUDA graph like every timed call)."""
    from lightningdot_tpu_torch.ops import attention_fused as af

    dev = torch.device("cuda")
    f = torch.nn.functional
    isz = torch.finfo(dtype).bits // 8
    seed = torch.tensor([0x5EED_0000_1234], device=dev)
    half = dtype == torch.bfloat16
    q, k, v, g = (randn(b, s, 12 * d, dtype=dtype) for _ in range(4))
    lens = torch.randint(1, s + 1, (b,), device=dev, generator=gen)
    bias = ((torch.arange(s, device=dev)[None, :] >= lens[:, None])
            .float() * -10000.0)
    rate = dict(nh=12, rate=0.1, scale=d ** -0.5)
    heads = [t.view(b, s, 12, d).transpose(1, 2) for t in (q, k, v)]
    mask4 = bias[:, None, None, :].to(dtype)
    elems, flops = b * s * 12 * d, 2 * b * 12 * s * s * d
    rows = [compare(
        "attention_train_fwd", (b, s, 12, d), dtype,
        lambda: af.attention_train_fwd(q, k, v, bias, seed, **rate),
        lambda: af._fused_attn_fwd_math(q, k, v, bias, seed, 12, 0.1,
                                        d ** -0.5), device_name,
        (4 * elems * isz + b * s * 4, 2 * flops, _peak(dtype)),
        library=lambda: f.scaled_dot_product_attention(
            *heads, attn_mask=mask4), exact=not half,
        reference=(lambda: af._fused_attn_fwd_math(
            q.float(), k.float(), v.float(), bias, seed, 12, 0.1,
            d ** -0.5)) if half else None, repeat=True, rate=0.1,
        library_rate=0.0, **kw)]
    leaves = [t.detach().clone().requires_grad_() for t in heads]
    g4 = g.view(b, s, 12, d).transpose(1, 2)

    def sdpa_fwd_bwd():
        out = f.scaled_dot_product_attention(*leaves, attn_mask=mask4)
        return torch.autograd.grad(out, leaves, g4)

    rows.append(compare(
        "attention_train_bwd_mma" if half else "attention_train_bwd",
        (b, s, 12, d), dtype,
        lambda: af.attention_train_bwd(q, k, v, bias, seed, g, **rate),
        lambda: af._fused_attn_bwd_math(q, k, v, bias, seed, g, 12, 0.1,
                                        d ** -0.5), device_name,
        (7 * elems * isz + b * s * 4, 5 * flops, _peak(dtype)),
        library=sdpa_fwd_bwd, exact=not half,
        reference=(lambda: af._fused_attn_bwd_math(
            q.float(), k.float(), v.float(), bias, seed, g.float(), 12,
            0.1, d ** -0.5)) if half else None, repeat=True, rate=0.1,
        library_rate=0.0, **kw))
    return rows


def fused_attention_rows(dtype, device_name, randn):
    """The fused training attention at the training shapes: batch 64 at
    text S 32 and image S 64 and 104, [8, 256] (the longest caption
    bucket), and S 37 and head dim 32 for the ragged paths; in float32
    also [128, 104] (a tower's 128 rows with a mined negative)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for b, s, d in ((64, 32, 64), (64, 37, 64), (64, 64, 64), (64, 104, 64),
                    (8, 256, 64), (64, 64, 32)) + (
                        ((128, 104, 64),) if dtype == torch.float32 else ()):
        rows += train_attention_rows(b, s, d, dtype, device_name, randn, gen)
    return rows


def train_attn_f32_yardstick(device_name):
    """B5's float32 kernels against SDPA in float32 at rate 0 (the forward
    against SDPA's forward, the backward against SDPA's forward and
    backward, each in a CUDA graph) at [64, 104] and [128, 104]: kernel /
    SDPA read ``KD_YARDSTICK_ROUNDS`` times in turn, the median and the
    spread. Fails if a median exceeds ``TRAIN_ATTN_F32_RATIO_MAX``."""
    from lightningdot_tpu_torch.ops import attention_fused as af

    f = torch.nn.functional
    dev = torch.device("cuda")
    randn, gen = make_randn(17)
    seed = torch.tensor([0x5EED_0000_1234], device=dev)
    for b, s in TRAIN_ATTN_YARDSTICK_SHAPES:
        d = 64
        q, k, v, g = (randn(b, s, 12 * d) for _ in range(4))
        lens = torch.randint(1, s + 1, (b,), device=dev, generator=gen)
        bias = ((torch.arange(s, device=dev)[None, :] >= lens[:, None])
                .float() * -10000.0)
        kw = dict(nh=12, rate=0.1, scale=d ** -0.5)
        heads = [t.view(b, s, 12, d).transpose(1, 2) for t in (q, k, v)]
        leaves = [t.detach().clone().requires_grad_() for t in heads]
        g4 = g.view(b, s, 12, d).transpose(1, 2)
        mask4 = bias[:, None, None, :]

        def sdpa_fwd_bwd():
            out = f.scaled_dot_product_attention(*leaves, attn_mask=mask4)
            return torch.autograd.grad(out, leaves, g4)

        pairs = (("attention_train_fwd",
                  lambda: af.attention_train_fwd(q, k, v, bias, seed, **kw),
                  lambda: f.scaled_dot_product_attention(*heads,
                                                         attn_mask=mask4)),
                 ("attention_train_bwd",
                  lambda: af.attention_train_bwd(q, k, v, bias, seed, g,
                                                 **kw),
                  sdpa_fwd_bwd))
        for name, kernel, sdpa in pairs:
            reads = [(time_ms(kernel, *RECORDED_TIMING),
                      time_ms(sdpa, *RECORDED_TIMING))
                     for _ in range(KD_YARDSTICK_ROUNDS)]
            ratios = [a / y for a, y in reads]
            row = dict(phase="train_attn_f32_yardstick", kernel=name,
                       shape=[b, s, 12, d], rate=0.1, library_rate=0.0,
                       ms=statistics.median(r[0] for r in reads),
                       sdpa_ms=statistics.median(r[1] for r in reads),
                       ratio=statistics.median(ratios),
                       ratio_min=min(ratios), ratio_max=max(ratios),
                       ratio_max_allowed=TRAIN_ATTN_F32_RATIO_MAX,
                       rounds=len(reads), device=device_name)
            emit(**row)
            check(row["ratio"] <= TRAIN_ATTN_F32_RATIO_MAX,
                  f"{name} float32 at {[b, s]}: {row['ratio']:.3f} x SDPA "
                  f"float32: {row}")


def mask_rows(device_name):
    """The kernels' Philox keep masks, read through the kernels themselves
    at rate 0.1, [32, 64] x 12 heads (1,572,864 draws), each against
    ``philox_keep`` bit for bit: the forward with q = k = 0 and v = I (every
    probability 1/64, so out = the dropped probabilities); the backward's
    dk/dv kernel with g = I (dv = the dropped probabilities, transposed);
    its dq kernel with q = 0, k = I and g v^T = 1 everywhere (g and v the
    first unit vector): dp = keep * mscale, so each dq row (= its ds row)
    takes two values, the larger exactly where kept, and a row with a
    single value is all kept. Then the kept fraction; one seed repeats,
    another differs."""
    from lightningdot_tpu_torch.ops import attention_fused as af

    dev = torch.device("cuda")
    b, s, nh, d = 32, 64, 12, 64
    kw = dict(nh=nh, rate=0.1, scale=0.125)
    zero_bias = torch.zeros((b, s), device=dev)

    def heads(x):
        return x.view(b, s, nh, d).permute(0, 2, 1, 3)

    for dtype in (torch.float32, torch.bfloat16):
        z = torch.zeros((b, s, nh * d), device=dev, dtype=dtype)
        eye = (torch.eye(s, device=dev, dtype=dtype)[None, :, None, :]
               .expand(b, s, nh, d).reshape(b, s, nh * d).contiguous())
        unit = torch.zeros((b, s, nh, d), device=dev, dtype=dtype)
        unit[..., 0] = 1
        unit = unit.reshape(b, s, nh * d)

        def masks(seed):
            out = af.attention_train_fwd(z, z, eye, zero_bias, seed, **kw)
            _, _, dv = af.attention_train_bwd(z, z, z, zero_bias, seed, eye,
                                              **kw)
            dq, _, _ = af.attention_train_bwd(z, eye, unit, zero_bias, seed,
                                              unit, **kw)
            dq = heads(dq).float()
            top = dq.amax(dim=-1, keepdim=True)
            single = (dq == top).all(dim=-1, keepdim=True)
            return (heads(out) != 0, heads(dv).transpose(-1, -2) != 0,
                    (dq == top) | single)

        seed = torch.tensor([20261016], device=dev)
        fwd, bwd, bwd_q = masks(seed)
        again, _, _ = masks(seed.clone())
        other, _, _ = masks(seed + 1)
        want = af.philox_keep(seed, b, nh, s, s, 0.1)
        torch.cuda.synchronize()
        row = dict(phase="mask", dtype=str(dtype).replace("torch.", ""),
                   draws=want.numel(), rate=0.1,
                   fwd_equal=bool(torch.equal(fwd, want)),
                   bwd_equal=bool(torch.equal(bwd, want)),
                   bwd_dq_equal=bool(torch.equal(bwd_q, want)),
                   differ_fwd=int((fwd != want).sum()),
                   differ_bwd=int((bwd != want).sum()),
                   differ_bwd_dq=int((bwd_q != want).sum()),
                   keep_fraction=fwd.float().mean().item(),
                   same_seed_repeats=bool(torch.equal(fwd, again)),
                   other_seed_differs=not bool(torch.equal(fwd, other)),
                   other_seed_agreement=(fwd == other).float().mean().item(),
                   device=device_name)
        emit(**row)
        check(row["fwd_equal"] and row["bwd_equal"] and row["bwd_dq_equal"],
              f"kernel masks differ from philox_keep: {row}")
        check(abs(row["keep_fraction"] - 0.9) <= KEEP_FRACTION_TOL,
              f"keep fraction {row['keep_fraction']} at rate 0.1")
        check(row["same_seed_repeats"] and row["other_seed_differs"],
              f"seeding: {row}")


def adamw_rows(device_name):
    """The AdamW kernel over every parameter of the two fine-tuning towers
    (the ``itm_train`` model's shapes; clip active, weight decay under the
    decay mask), with a float32 and a bfloat16 first moment, and over the
    VQA model (the towers, the intersection head and 3,129 answers) with
    the head's learning-rate factor 10 (``variant`` lr_mul), against its
    twin tensor by tensor: bit for bit. Timed eagerly (``time_eager_ms``):
    the wrapper uploads its pointer table on every call."""
    from lightningdot_tpu_torch.models import BiEncoder
    from lightningdot_tpu_torch.models.vqa import BiEncoderForVQA
    from lightningdot_tpu_torch.ops import adamw
    from lightningdot_tpu_torch.training.optim import decay_mask

    txt_cfg, img_cfg = train_configs(0.1)
    with torch.device("meta"):
        towers = BiEncoder(txt_cfg, img_cfg)
        vqa = BiEncoderForVQA(BiEncoder(txt_cfg, img_cfg), 768,
                              VQA_ANSWERS, intersection=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(dtype)

    kw = dict(step_size=2e-5, lr=2e-5, b1=0.9, b2=0.999, eps=1e-8)
    scale = torch.tensor(0.5, device=dev)
    rows = []
    for meta, m_dtype, variant in ((towers, torch.float32, None),
                                   (towers, torch.bfloat16, None),
                                   (vqa, torch.float32, "lr_mul")):
        mask = decay_mask(meta)
        names = [n for n, _ in meta.named_parameters()]
        shapes = [tuple(p.shape) for _, p in meta.named_parameters()]
        wds = [0.01 if mask[n] else 0.0 for n in names]
        muls = [10.0 if variant and n.startswith("vqa_output.") else 1.0
                for n in names]
        n_params = sum(int(np.prod(s)) for s in shapes)
        p = [randn(s, 0.02) for s in shapes]
        grads = [randn(s, 1e-3) for s in shapes]
        m = [randn(s, 1e-4, m_dtype) for s in shapes]
        v = [randn(s, 1e-4).square() for s in shapes]
        p2, m2, v2 = ([t.clone() for t in ts] for ts in (p, m, v))
        adamw.adamw_cuda(p, grads, m, v, wds, scale, lr_muls=muls, **kw)
        want = [adamw._adamw_math(*a, scale, wd=wd, lr_mul=mul, **kw)
                for *a, wd, mul in zip(p2, grads, m2, v2, wds, muls)]
        torch.cuda.synchronize()
        got_all = torch.cat([t.float().reshape(-1) for trio in zip(p, m, v)
                             for t in trio])
        want_all = torch.cat([t.float().reshape(-1) for trio in want
                              for t in trio])
        err = (got_all - want_all).abs().max().item()
        differ = (got_all != want_all).float().mean().item()
        del got_all, want_all, want

        def twin():
            for a in zip(p2, grads, m2, v2, wds, muls):
                adamw._adamw_math(*a[:4], scale, wd=a[4], lr_mul=a[5], **kw)

        per_param = 28 if m_dtype == torch.float32 else 24
        bound_ms, bound_by = bound(per_param * n_params, 16 * n_params,
                                   PEAK_OPS["f32"])
        row = dict(phase="kernel", kernel="adamw", shape=[n_params],
                   dtype="float32", m_dtype=str(m_dtype).replace("torch.", ""),
                   tensors=len(shapes), max_abs_err=err, tol=0.0,
                   differ_frac=differ,
                   ms=time_eager_ms(lambda: adamw.adamw_cuda(
                       p, grads, m, v, wds, scale, lr_muls=muls, **kw)),
                   plain_ms=time_eager_ms(twin, calls=3, groups=3),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                   device=device_name)
        if variant:
            row.update(variant=variant, model="vqa", lr_mul_tensors=sum(
                mul != 1.0 for mul in muls))
        emit(**row)
        check(differ == 0.0, f"adamw ({m_dtype}, {variant}): {differ:.3%} "
              f"of elements differ from the twin (max {err})")
        rows.append(row)
        del p, grads, m, v, p2, m2, v2
    return rows


def topk_phase(device_name):
    """The approximate top-k of ``topk="approx"`` beside ``torch.topk`` over
    a full-COCO row of scores (123,287 padded to 123,392), top 100."""
    from lightningdot_tpu_torch.serving import approx_topk

    g = torch.Generator(device=DEVICE).manual_seed(1)
    n = -(-CORPUS_SIZE // 128) * 128
    for batch in (1, 64):
        scores = torch.randn((batch, n), device=DEVICE, generator=g)
        approx = approx_topk(scores, TOP, 0.95)[1].tolist()
        exact = torch.topk(scores, TOP, dim=1)[1].tolist()
        emit(phase="topk", batch=batch, n=n, top=TOP, recall=float(np.mean(
            [len(set(a) & set(b)) / TOP for a, b in zip(approx, exact)])),
             approx_ms=time_ms(lambda: approx_topk(scores, TOP, 0.95)),
             exact_ms=time_ms(lambda: torch.topk(scores, TOP, dim=1)),
             device=device_name)


def _kind(name: str) -> str:
    """The kind of a device event, for counting launches: copies (memcpy,
    memset and copy/cast kernels), elementwise kernels, reductions, or
    other (the port's kernels, cuBLAS, ...)."""
    low = name.lower()
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copies"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reductions"
    return "other"


def _profile_activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _device_stats(prof, calls, shares=None):
    """Device busy time per call (the union of the device's kernel and
    copy intervals: the benchmark's ``union_seconds``), the eight costliest
    device kernels, as [name, ms per call, launches per call], and the
    device events per call by kind (``_kind``), of a finished profiler over
    ``calls`` calls; with ``shares`` ({key: regular expression}), also,
    under ``shares[key]``, the device ms per call of the kernels whose names
    match it and their launches per call."""
    spans, by_name, kinds = [], {}, {}
    for e in prof.events():
        if str(e.device_type) != "DeviceType.CUDA":
            continue
        start, end = e.time_range.start, e.time_range.end      # µs
        spans.append((start * 1e3, end * 1e3))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, n + 1)
        kinds[_kind(e.name)] = kinds.get(_kind(e.name), 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    stats = dict(calls=calls,
                 busy_ms=(_TRACE.union_seconds(spans) * 1e3 / calls
                          if spans else None),
                 top=[[name[:70], ms / calls, n / calls]
                      for name, (ms, n) in top],
                 launches_per_call={k: n / calls for k, n in kinds.items()})
    if shares:
        stats["shares"] = {}
        for key, pattern in shares.items():
            mine = [v for name, v in by_name.items()
                    if re.search(pattern, name)]
            stats["shares"][key] = dict(
                pattern=pattern, ms=sum(ms for ms, _ in mine) / calls,
                launches=sum(n for _, n in mine) / calls)
    return stats


def device_profile(fn, calls, shares=None):
    """torch.profiler over ``calls`` calls of ``fn`` (after one warm-up
    call): ``_device_stats``."""
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=_profile_activities()) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _device_stats(prof, calls, shares)


def emit_profile(path, batch, fn, wall_ms, calls=10, shares=None):
    """One profiler row; the idle share is against ``wall_ms``, measured
    without the profiler; each of ``shares`` with its share of the busy
    time (``of_busy``)."""
    stats = device_profile(fn, calls, shares)
    for v in stats.get("shares", {}).values():
        v["of_busy"] = v["ms"] / stats["busy_ms"] if stats["busy_ms"] else None
    emit_profile_stats(path, batch, stats, wall_ms)
    return stats


def emit_profile_stats(path, batch, stats, wall_ms, **extra):
    busy = stats["busy_ms"]
    emit(phase="profile", path=path, batch=batch, wall_ms=wall_ms,
         idle_share=None if busy is None else 1.0 - busy / wall_ms,
         **extra, **stats)


def make_tokenizer(workdir: Path, words):
    """A cased WordPiece vocabulary with BERT-base cased's special ids
    ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103) and the words
    of the queries."""
    from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer

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
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models import BiEncoder, init_tower_
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.serving import Retriever

    cfg = EncoderConfig(**MODEL)
    t0 = time.perf_counter()
    master = BiEncoder(cfg)
    init_tower_(master.txt_model, torch.Generator().manual_seed(args.seed))
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
    r32 = Retriever(model(torch.float32), tok, device=DEVICE)
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
    counts_f32 = launch_counts()
    hold_path("text_f32", counts_f32)
    reset_launch_counts()

    # bfloat16, the serving configuration: plant each query's embedding
    r16 = Retriever(model(torch.bfloat16), tok, device=DEVICE)
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
    p50, batches = {}, {}
    for batch in (1, 8, 64):
        queries = [" ".join(rng.choice(words, 30)) for _ in range(batch)]
        batches[batch] = queries
        idx, scores = r16.retrieve_batch_arrays(queries, top=TOP)
        check(idx.shape == (batch, TOP) and np.isfinite(scores).all(),
              "retrieve_batch_arrays output malformed")
        lat = []
        for _ in range(30):
            t = time.perf_counter()
            r16.retrieve_batch_arrays(queries, top=TOP)
            lat.append((time.perf_counter() - t) * 1e3)
        p50[batch] = statistics.median(lat)
        emit(phase="latency", batch=batch, top=TOP, query_tokens=32,
             p50_ms=p50[batch], p90_ms=float(np.percentile(lat, 90)),
             reps=len(lat), device=device_name)
    counts = launch_counts()
    hold_path("text_bf16", counts)
    for batch in (1, 64):
        emit_profile("text_bf16", batch, lambda: r16.retrieve_batch_arrays(
            batches[batch], top=TOP), p50[batch])
    return r16, dict(counts=counts, counts_f32=counts_f32, state=state,
                     cfg=cfg, vec16=vec16, p50=p50)


def serve_phase(r16):
    from lightningdot_tpu_torch.serving_native import serve_retriever

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


def serve_http_phase(r16):
    """The port's HTTP front end (``serving_http.RetrievalServer`` over
    ``serving_frontend.BatchingFrontend``, ``max_batch`` 64) answers a
    burst of concurrent /search requests: they coalesce into fewer device
    calls than requests, and each ranking is ``ranking_equivalent`` to a
    direct ``retrieve_batch``."""
    from lightningdot_tpu_torch.serving_frontend import BatchingFrontend
    from lightningdot_tpu_torch.serving_http import RetrievalServer

    fe = BatchingFrontend(r16, max_batch=64, max_top=TOP)
    t0 = time.perf_counter()
    fe.warmup()
    warm_s = time.perf_counter() - t0
    queries = CAPTIONS + [c.replace(" .", " at night .") for c in CAPTIONS]
    out = [None] * len(queries)
    errors = []
    with RetrievalServer(fe) as srv:
        start = threading.Barrier(len(queries))

        def call(i):
            url = f"{srv.address}/search?q={quote(queries[i])}&top=10"
            start.wait()
            try:
                with urllib.request.urlopen(url, timeout=120) as r:
                    out[i] = [tuple(x)
                              for x in json.loads(r.read())["results"]]
            except Exception as e:  # reported below, fails the phase
                errors.append(f"{queries[i]!r}: {e!r}")

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "a request hung")
        check(not errors, f"requests failed: {errors}")
    want = [r16.retrieve_batch([q], top=10)[0] for q in queries]
    atol = hold_rankings(out, want, SERVE_RANK_RTOL, "HTTP served vs direct")
    emit(phase="serve_http", server="serving_http", requests=len(queries),
         requests_served=fe.requests_served,
         batches_dispatched=fe.batches_dispatched, warmup_s=warm_s,
         max_rank_score_delta=max_rank_delta(out, want), rank_atol=atol)
    check(fe.requests_served == len(queries)
          and fe.batches_dispatched < fe.requests_served,
          f"requests not coalesced: {fe.batches_dispatched} batches for "
          f"{fe.requests_served} requests")


def loadgen_phase(r16, p50_64_ms, device_name):
    """``serving_native.run_loadgen`` against ``serve_retriever(r16)`` at
    ``LOADGEN_SHARES`` of the rate the batch-64 p50 implies: achieved QPS
    and latency quantiles; no errors on either side."""
    from lightningdot_tpu_torch.serving_native import (run_loadgen,
                                                       serve_retriever)

    saturation = 64 / (p50_64_ms / 1e3)
    srv = serve_retriever(r16)
    try:
        for share in LOADGEN_SHARES:
            before = srv.stats()
            stats = run_loadgen(srv.port, rate=share * saturation,
                                duration_s=LOADGEN_SECONDS, conns=8, top=TOP)
            after = srv.stats()
            batches = after["batches"] - before["batches"]
            emit(phase="loadgen", share=share, saturation_per_s=saturation,
                 offered_per_s=stats["offered_per_s"],
                 achieved_per_s=stats["achieved_per_s"],
                 completed=stats["completed"], p50_ms=stats["p50_ms"],
                 p99_ms=stats["p99_ms"], loadgen_errors=stats["errors"],
                 server_errors=after["errors"] - before["errors"],
                 mean_batch=(after["batched_requests"]
                             - before["batched_requests"]) / max(batches, 1),
                 seconds=LOADGEN_SECONDS, conns=8, device=device_name)
            check(stats["errors"] == 0 and after["errors"] == before["errors"]
                  and stats["completed"] > 0, f"loadgen errors: {stats}, "
                  f"server {after}")
    finally:
        srv.stop()


def write_eval_dbs(root: Path, n_img: int, per_img: int, seed: int,
                   soft_labels: bool = False):
    """An image DB and a text DB in the reference's layout, written with
    the port's writers (``write_feat_db``, ``write_txt_db``): ``n_img``
    images of 10-100 regions of ``IMG_DIM`` float16 features (confidences
    that keep every region at conf_th 0.2; with ``soft_labels``, each
    region's float32 distribution over the ``IMG_LABEL_DIM`` detection
    classes, as MRC reads it), ``per_img`` captions of 4-58 ids each."""
    from lightningdot_tpu_torch.data.feat_db import write_feat_db
    from lightningdot_tpu_torch.data.txt_db import write_txt_db

    rng = np.random.default_rng(seed)
    records, examples = {}, {}
    for i in range(n_img):
        fname = f"coco_test_{i:06d}.npz"
        nbb = int(rng.integers(10, 101))
        xy = rng.random((nbb, 2), dtype=np.float32) * 0.5
        wh = rng.random((nbb, 2), dtype=np.float32) * 0.5
        records[fname] = {
            "features": rng.standard_normal((nbb, IMG_DIM),
                                            dtype=np.float32).astype(
                                                np.float16),
            "norm_bb": np.concatenate([xy, xy + wh, wh], axis=1),
            "conf": np.full((nbb,), 0.7, np.float32)}
        if soft_labels:
            sl = rng.random((nbb, IMG_LABEL_DIM), dtype=np.float32)
            records[fname]["soft_labels"] = sl / sl.sum(-1, keepdims=True)
        for c in range(per_img):
            examples[f"txt_{i:06d}_{c}"] = {
                "input_ids": rng.integers(106, 28996, int(
                    rng.integers(4, 59))).tolist(), "img_fname": fname}
    img_dir, txt_dir = root / "img", root / "txt_db"
    write_feat_db(str(img_dir), records, conf_th=0.2, max_bb=100, min_bb=10)
    write_txt_db(str(txt_dir), examples, {"CLS": 101, "SEP": 102,
                                          "MASK": 103,
                                          "v_range": [106, 28996]})
    return str(txt_dir), str(img_dir)


def run_eval_cli(cmds):
    """``cli/eval_itm.main(cmds)``, keeping what its evaluator returned
    (the model, the vectors, the rankings) and the shapes of the batches
    it encoded beside the CLI's results."""
    from lightningdot_tpu_torch.cli import eval_itm

    kept = {}
    real = eval_itm.eval_model_on_dataloader

    kept["shapes"] = set()

    def logged(loader):
        for b in loader:
            kept["shapes"].add((b["txts"]["input_ids"].shape,
                                b["imgs"]["attention_mask"].shape))
            yield b

    def keep(model, loader, **kw):
        t = time.perf_counter()
        kept["result"] = real(model, logged(loader), **kw)
        kept["seconds"] = time.perf_counter() - t
        kept["model"], kept["loader"] = model, loader
        return kept["result"]

    eval_itm.eval_model_on_dataloader = keep
    try:
        t = time.perf_counter()
        out = eval_itm.main(cmds)["test"]
        kept["cli_seconds"] = time.perf_counter() - t
    finally:
        eval_itm.eval_model_on_dataloader = real
    return out, kept


def _exact_rankings(queries, keys, corpus, k):
    """{query id: (ids, scores)} of NumPy's exact float32 top-k."""
    scores = queries[1] @ corpus.T
    top = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return {q: ([keys[j] for j in row], scores[i, row])
            for i, (q, row) in enumerate(zip(queries[0], top))}


def hold_index(ranked, exact, vectors_q, keys, corpus, what):
    """Each query's ranked ids equal NumPy's exact top-k, ties aside: both
    lists, scored by NumPy, must be ``ranking_equivalent`` within
    ``EVAL_TIE_RTOL`` of the peak score. Returns (queries whose ids
    differ at all, the atol)."""
    from lightningdot_tpu_torch.serving import ranking_equivalent

    col = {key: j for j, key in enumerate(keys)}
    peak = max(float(np.abs(s).max()) for _, s in exact.values())
    atol = EVAL_TIE_RTOL * max(1.0, peak)
    differ = 0
    for q, got_ids in ranked.items():
        want_ids, want_s = exact[q]
        if list(got_ids) == want_ids:
            continue
        differ += 1
        vq = vectors_q[q]
        got = [(i, float(corpus[col[i]] @ vq)) for i in got_ids]
        ok, why = ranking_equivalent(got, list(zip(want_ids, want_s)),
                                     atol=atol)
        check(ok, f"{what}: query {q}: {why}")
    return differ, atol


def eval_phase(args, device_name):
    """The port's ``cli/eval_itm.main`` on the card at
    configs/coco_eval.json's model (BERT-base cased + UNITER-base,
    ``project_dim`` 768, bf16, ``valid_batch_size`` 80) over synthetic DBs
    written by the port's writers: recall, loss, correct ratio, seconds,
    pairs/s and images/s, the batches' shapes (``EVAL_SEQS``, which the
    kernel rows hold); each index against NumPy's exact top-k of the
    same vectors; recall recomputed on the host; the HNSW index's recall
    against the flat index's; the path's launches; a profiler pass over
    one batch; then the same evaluation in float32, card against CPU, on
    a small split."""
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training.evaluator import (BatchEncoder,
                                                           build_index)
    from lightningdot_tpu_torch.utils import metrics

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        txt_dir, img_dir = write_eval_dbs(Path(tmp) / "test", EVAL_IMAGES,
                                          EVAL_CAPTIONS, args.seed + 3)
        emit(phase="setup_eval", seconds=time.perf_counter() - t0,
             images=EVAL_IMAGES, captions=EVAL_IMAGES * EVAL_CAPTIONS)
        cmds = ["--config", "configs/coco_eval.json", "--itm_global_file",
                "", "--test_txt_db", txt_dir, "--test_img_db", img_dir]
        reset_launch_counts()
        res, kept = run_eval_cli(cmds)
        counts = launch_counts()
        hold_path("eval", counts)
        result = kept["result"]
        held = {((EVAL_BATCH, t), (EVAL_BATCH, i)) for t in EVAL_SEQS
                for i in EVAL_SEQS}
        check(kept["shapes"] <= held, f"eval batches at {kept['shapes']}, "
              f"the kernel rows hold {held}")
        emit(phase="eval", images=EVAL_IMAGES,
             captions=EVAL_IMAGES * EVAL_CAPTIONS, batch=EVAL_BATCH,
             shapes=sorted(kept["shapes"]),
             recall_txt2img=res["recall_txt"],
             recall_img2txt=res["recall_img"], loss=res["loss"],
             correct_ratio=res["correct_ratio"],
             eval_seconds=kept["seconds"], cli_seconds=kept["cli_seconds"],
             # each caption's pair encodes its image, as the evaluator
             # does: 5 encodes per distinct image
             pairs_per_s=EVAL_IMAGES * EVAL_CAPTIONS / kept["seconds"],
             images_per_s=EVAL_IMAGES / kept["seconds"],
             device=device_name)
        check(np.isfinite(res["loss"]) and all(
            set(d) == {1, 5, 10} and 0 <= d[1] <= d[5] <= d[10] <= 1
            for d in (res["recall_txt"], res["recall_img"])),
            f"eval results malformed: {res}")

        # the indexes against NumPy's exact top-k, and recall on the host
        txt = result.embeddings["txt"]
        img = result.embeddings["img"]
        t_keys, i_keys = list(txt), list(img)
        t_mat, i_mat = np.stack(list(txt.values())), np.stack(
            list(img.values()))
        check(t_mat.shape[1] == i_mat.shape[1] == 768
              and np.isfinite(t_mat).all() and np.isfinite(i_mat).all(),
              "eval vectors malformed")
        loader = kept["loader"]
        txt_ids = list(loader.dataset.ids)
        fnames = [loader.dataset.train_imgs[i] for i in range(len(txt_ids))]
        exact_t = _exact_rankings((txt_ids, np.stack([txt[t] for t in
                                                      txt_ids])),
                                  i_keys, i_mat, 100)
        exact_i = _exact_rankings((fnames, np.stack([img[f] for f in
                                                     fnames])),
                                  t_keys, t_mat, 100)
        differ_t, atol_t = hold_index(result.rank_results[0], exact_t, txt,
                                      i_keys, i_mat, "image index")
        differ_i, atol_i = hold_index(result.rank_results[1], exact_i, img,
                                      t_keys, t_mat, "text index")
        gt = dict(zip(txt_ids, fnames))
        host_t = metrics.recall_from_ranked_ids(
            txt_ids, {q: r[0] for q, r in exact_t.items()}, gt)
        host_i = metrics.recall_any_from_ranked_ids(
            fnames, {q: r[0] for q, r in exact_i.items()},
            loader.dataset.txt_db.img2txts)

        # the native HNSW index over the same vectors
        t = time.perf_counter()
        hnsw_img = build_index(768, hnsw=True)
        hnsw_img.index_data(list(img.items()))
        hnsw_txt = build_index(768, hnsw=True)
        hnsw_txt.index_data(list(txt.items()))
        build_s = time.perf_counter() - t
        rank_t = {q: r[0] for q, r in zip(txt_ids, hnsw_img.search_knn(
            np.stack([txt[q] for q in txt_ids]), 100))}
        rank_i = {q: r[0] for q, r in zip(fnames, hnsw_txt.search_knn(
            np.stack([img[f] for f in fnames]), 100))}
        hnsw_t = metrics.recall_from_ranked_ids(txt_ids, rank_t, gt)
        hnsw_i = metrics.recall_any_from_ranked_ids(
            fnames, rank_i, loader.dataset.txt_db.img2txts)
        emit(phase="eval_index_check", queries=len(txt_ids),
             image_index_queries_differing=differ_t,
             text_index_queries_differing=differ_i,
             tie_atol=[atol_t, atol_i],
             host_recall_txt2img=host_t, host_recall_img2txt=host_i,
             hnsw_recall_txt2img=hnsw_t, hnsw_recall_img2txt=hnsw_i,
             hnsw_build_s=build_s)
        check(host_t == res["recall_txt"] and host_i == res["recall_img"],
              f"host recall {host_t} {host_i} vs the CLI's {res}")
        check(hnsw_t == res["recall_txt"] and hnsw_i == res["recall_img"],
              f"HNSW recall {hnsw_t} {hnsw_i} vs the flat index's {res}")

        # one encode batch under the profiler, staged as the evaluator
        # stages it (pinned buffers, a side stream)
        encoder = BatchEncoder(kept["model"])
        batch = next(iter(loader))

        def encode():
            encoder(encoder.put(batch))

        lat = []
        for _ in range(6):
            t = time.perf_counter()
            encode()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        emit_profile("eval", EVAL_BATCH, encode, statistics.median(lat[1:]),
                     calls=3)
        del encoder, batch, kept, result

        # float32: the card against the plain path on the CPU
        txt_dir, img_dir = write_eval_dbs(Path(tmp) / "f32", EVAL_F32_IMAGES,
                                          EVAL_F32_CAPTIONS, args.seed + 4)
        cmds = ["--config", "configs/coco_eval.json", "--itm_global_file",
                "", "--test_txt_db", txt_dir, "--test_img_db", img_dir,
                "--compute_dtype", "f32", "--valid_batch_size", "32"]
        card, kept_card = run_eval_cli(cmds)
        cpu, kept_cpu = run_eval_cli(cmds + ["--device", "cpu"])
        errs = [float(np.abs(np.stack(list(kept_card["result"].embeddings[
            side].values())) - np.stack(list(kept_cpu["result"].embeddings[
                side].values()))).max()) for side in ("txt", "img")]
        emit(phase="eval_f32_check", images=EVAL_F32_IMAGES,
             captions=EVAL_F32_IMAGES * EVAL_F32_CAPTIONS,
             recall_card=[card["recall_txt"], card["recall_img"]],
             recall_cpu=[cpu["recall_txt"], cpu["recall_img"]],
             loss_card=card["loss"], loss_cpu=cpu["loss"],
             max_vec_err=max(errs), vec_atol=F32_VEC_ATOL,
             cpu_seconds=kept_cpu["seconds"])
        check(card["recall_txt"] == cpu["recall_txt"]
              and card["recall_img"] == cpu["recall_img"],
              f"float32 recall card {card} vs cpu {cpu}")
        check(max(errs) <= F32_VEC_ATOL,
              f"float32 eval vectors differ by {max(errs)}")
    return counts


class SynthImages:
    """Items in the format of the ITM datasets (what
    ``lightningdot_tpu_torch/data/itm.py::itm_fast_collate`` takes), made
    from ``seed``: ``num_bb`` regions of
    ``IMG_DIM`` float16 features and 7 box features each, as the feature DB stores
    them, and one random caption of 12-30 ids each. Made in bulk before
    the timed encode."""

    def __init__(self, n, num_bb, seed, prefix):
        rng = np.random.default_rng(seed)
        self.feats = rng.standard_normal((n, num_bb, IMG_DIM),
                                         dtype=np.float32).astype(np.float16)
        box = rng.random((n, num_bb, 6), dtype=np.float32)
        self.pos = np.concatenate(
            [box, box[..., 4:5] * box[..., 5:6]], axis=-1).astype(np.float32)
        self.caps = [rng.integers(106, 28996, rng.integers(12, 31)).tolist()
                     for _ in range(n)]
        self.names = [f"{prefix}_{i:06d}.npz" for i in range(n)]
        self.num_bb = num_bb

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        return {"input_ids": [101] + self.caps[i] + [102],
                "img": {"fname": self.names[i], "num_bb": self.num_bb,
                        "img_feat": self.feats[i], "img_pos_feat": self.pos[i],
                        "caption_ids": None},
                "neg_imgs": None, "neg_txts": None,
                "txt_id": self.names[i].replace(".npz", "_txt")}


def image_loader(data, batch):
    from torch.utils.data import DataLoader

    from lightningdot_tpu_torch.data.itm import (CollateConfig,
                                                 itm_fast_collate)

    return DataLoader(data, batch_size=batch, collate_fn=lambda items:
                      itm_fast_collate(items, CollateConfig(
                          fixed_batch=batch)))


def image_phase(args, ctx, device_name):
    """Corpus encoding at full width: both towers in bfloat16 over
    ``IMAGES`` synthetic images with ``NUM_BB`` regions (sequence 1 + 63 =
    64 after the collate's bucketing) and a batch at 100 regions (1 + 103
    = 104), through ``get_model_encoded_vecs``; a profiler pass over one
    batch; then, for a few images, float32 on the card against the CPU
    plain path and bfloat16 against float32 on the card."""
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.data.itm import (CollateConfig,
                                                 itm_fast_collate)
    from lightningdot_tpu_torch.models import BiEncoder, init_tower_
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.serving import get_model_encoded_vecs
    from lightningdot_tpu_torch.training.evaluator import BatchEncoder

    cfg = ctx["cfg"]
    img_cfg = EncoderConfig(**MODEL, img_dim=IMG_DIM)
    t0 = time.perf_counter()
    master = BiEncoder(cfg, img_cfg)
    master.txt_model.load_state_dict(
        {k[len("txt_model."):]: v for k, v in ctx["state"].items()})
    init_tower_(master.img_model, torch.Generator().manual_seed(args.seed + 1))
    state = master.state_dict()

    def model(dtype, device):
        m = BiEncoder(cfg, img_cfg, compute_dtype=dtype)
        m.load_state_dict(state)
        return m.to(device)

    data = SynthImages(IMAGES, NUM_BB, args.seed, "coco")
    data100 = SynthImages(IMG_BATCH, 100, args.seed + 1, "coco100")
    emit(phase="setup_image", seconds=time.perf_counter() - t0,
         images=len(data) + len(data100), num_bb=[NUM_BB, 100])

    m16 = model(torch.bfloat16, DEVICE)
    get_model_encoded_vecs(m16, image_loader(data100, IMG_BATCH))  # warm
    reset_launch_counts()
    rates = {}
    vecs = {}
    for name, d in (("num_bb_36", data), ("num_bb_100", data100)):
        t = time.perf_counter()
        out = get_model_encoded_vecs(m16, image_loader(d, IMG_BATCH))
        seconds = time.perf_counter() - t
        rates[name] = len(d) / seconds
        check(len(out["img_embed"]) == len(d)
              and len(out["txt_embed"]) == len(d),
              f"{name}: {len(out['img_embed'])} images encoded of {len(d)}")
        vecs.update(out["img_embed"])
        emit(phase="image_encode", images=len(d), batch=IMG_BATCH,
             seconds=seconds, images_per_s=rates[name],
             seq_len=1 + (63 if d.num_bb == NUM_BB else 103),
             device=device_name)
    counts = launch_counts()
    hold_path("image_bf16", counts)
    names = data.names + data100.names
    img = np.stack([vecs[n] for n in names])
    check(img.shape == (len(names), cfg.hidden_size)
          and np.isfinite(img).all(),
          "image vectors malformed")
    encoder = BatchEncoder(m16)
    batch = next(iter(image_loader(data, IMG_BATCH)))
    emit_profile("image_bf16", IMG_BATCH,
                 lambda: encoder(encoder.put(batch)),
                 1e3 * IMG_BATCH / rates["num_bb_36"], calls=3)

    # float32 on the card against the plain path on the CPU, and bfloat16
    # against float32 on the card, a few images of each length
    errs, cosines = [], []
    for d in (data, data100):
        batch = itm_fast_collate([d[i] for i in range(4)],
                                 CollateConfig(fixed_batch=4))
        f32_card = BatchEncoder(model(torch.float32, DEVICE))
        f32_cpu = BatchEncoder(model(torch.float32, "cpu"), device="cpu")
        _, card, _ = f32_card(f32_card.put(batch))
        _, cpu, _ = f32_cpu(f32_cpu.put(batch))
        _, half, _ = encoder(encoder.put(batch))
        errs.append(float((card.cpu() - cpu).abs().max()))
        cosines.append(float(torch.nn.functional.cosine_similarity(
            half, card, dim=1).min()))
    emit(phase="image_f32_check", max_vec_err=max(errs), vec_atol=F32_VEC_ATOL,
         min_bf16_cosine_to_f32=min(cosines), cosine_min=BF16_COSINE_MIN,
         images=8, seq_len=[64, 104])
    check(max(errs) <= F32_VEC_ATOL, f"float32 image vectors differ by "
          f"{max(errs)}")
    check(min(cosines) >= BF16_COSINE_MIN,
          f"bfloat16 vs float32 image vectors: cosine {min(cosines)}")
    return dict(vectors=img, names=names, rates=rates, counts=counts)


def int8_phase(args, tok, ctx, img, device_name):
    """The int8 serving configuration: int8 tower, int8 corpus (the image
    tower's vectors first, seeded random vectors after them, 123,287 in
    all) and approximate top-k.

    The control for the cosine bounds: the CPU plain path with the
    activation scale computed by a true division, max / 127 (the JAX
    package's eager form), not a multiply by 1/127. It is a different
    numerics, not a fault: its readings show what the bounds can and cannot
    tell apart."""
    from lightningdot_tpu_torch.models import BiEncoder
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.serving import Retriever, approx_bin_width

    cfg = ctx["cfg"]
    t0 = time.perf_counter()
    model = BiEncoder(cfg, compute_dtype=torch.bfloat16)
    model.load_state_dict(ctx["state"])
    rng = np.random.default_rng(args.seed + 2)
    n_img = img["vectors"].shape[0]
    corpus = np.concatenate([img["vectors"], rng.standard_normal(
        (CORPUS_SIZE - n_img, cfg.hidden_size), dtype=np.float32)])
    ids = img["names"] + [f"coco_{i:06d}" for i in range(n_img, CORPUS_SIZE)]
    kw = dict(quantization="int8", weight_quantization="int8")
    r8 = Retriever(model, tok, device=DEVICE, topk="approx", **kw)
    emit(phase="setup_int8", seconds=time.perf_counter() - t0,
         corpus=list(corpus.shape), image_vectors=n_img)

    reset_launch_counts()
    vec8 = r8.encode_queries(CAPTIONS)
    check(vec8.shape == (len(CAPTIONS), cfg.hidden_size)
          and np.isfinite(vec8).all(), "int8 query vectors malformed")
    vec16 = ctx["vec16"]
    cos = (vec8 * vec16).sum(1) / (np.linalg.norm(vec8, axis=1)
                                   * np.linalg.norm(vec16, axis=1))
    spots = rng.choice(np.arange(n_img, CORPUS_SIZE), len(CAPTIONS),
                       replace=False)
    planted = corpus.copy()
    planted[spots] = vec8
    r8.set_corpus(ids, planted)
    res = rankings(r8, CAPTIONS)
    firsts = [r[0][0] for r in res]
    emit(phase="int8_check", min_cosine_to_bf16=float(cos.min()),
         cosine_min=INT8_BF16_COSINE_MIN, planted_first=sum(
             f == ids[s] for f, s in zip(firsts, spots)),
         queries=len(CAPTIONS),
         min_top1_margin=min(r[0][1] - r[1][1] for r in res))
    check(float(cos.min()) >= INT8_BF16_COSINE_MIN,
          f"int8 vs bfloat16 tower cosine {cos.min()}")
    check(all(f == ids[s] for f, s in zip(firsts, spots)),
          f"planted embeddings not first: {firsts} vs "
          f"{[ids[s] for s in spots]}")

    words = sorted({w for c in CAPTIONS for w in c.split()})
    r8.warmup(tops=(TOP,), batches=(1, 8, 64))
    lat_rows = []
    for batch in (1, 8, 64):
        queries = [" ".join(rng.choice(words, 30)) for _ in range(batch)]
        idx, scores = r8.retrieve_batch_arrays(queries, top=TOP)
        check(idx.shape == (batch, TOP) and np.isfinite(scores).all(),
              "int8 retrieve_batch_arrays output malformed")
        lat = []
        for _ in range(30):
            t = time.perf_counter()
            r8.retrieve_batch_arrays(queries, top=TOP)
            lat.append((time.perf_counter() - t) * 1e3)
        lat_rows.append(dict(batch=batch, queries=queries,
                             p50_ms=statistics.median(lat)))
        emit(phase="latency_int8", batch=batch, top=TOP, query_tokens=32,
             p50_ms=statistics.median(lat),
             p90_ms=float(np.percentile(lat, 90)), reps=len(lat),
             bf16_p50_ms=ctx["p50"][batch], device=device_name)
    counts = launch_counts()
    hold_path("int8_serving", counts)
    for row in (lat_rows[0], lat_rows[-1]):
        emit_profile("int8_serving", row["batch"],
                     lambda: r8.retrieve_batch_arrays(row["queries"],
                                                      top=TOP),
                     row["p50_ms"])

    # approximate against exact top-k of the same int8 scores
    exact = Retriever(model, tok, device=DEVICE, topk="exact", **kw)
    exact.set_corpus(ids, planted)
    queries = lat_rows[-1]["queries"]
    approx_idx, _ = r8.retrieve_batch_arrays(queries, top=TOP)
    exact_idx, _ = exact.retrieve_batch_arrays(queries, top=TOP)
    recall = float(np.mean([len(set(a) & set(b)) / TOP for a, b in
                            zip(approx_idx.tolist(), exact_idx.tolist())]))
    emit(phase="int8_recall", queries=len(queries), top=TOP, recall=recall,
         recall_min=r8.topk_recall, bins=int(
             exact._corpus.shape[0] // approx_bin_width(
                 exact._corpus.shape[0], TOP, r8.topk_recall)))
    check(recall >= r8.topk_recall, f"approximate recall@{TOP} {recall}")
    del exact

    # the int8 tower on the card against the plain path on the CPU
    ref = Retriever(model, tok, device="cpu", topk="approx", **kw)
    ref.set_corpus(ids, planted)
    got = rankings(r8, CAPTIONS)
    want = rankings(ref, CAPTIONS)
    vec_ref = ref.encode_queries(CAPTIONS)
    cos = (vec8 * vec_ref).sum(1) / (np.linalg.norm(vec8, axis=1)
                                     * np.linalg.norm(vec_ref, axis=1))
    emit(phase="int8_card_vs_cpu", max_vec_err=float(
        np.abs(vec8 - vec_ref).max()), min_vec_cosine=float(cos.min()),
        cosine_min=INT8_CARD_COSINE_MIN,
        max_rank_score_delta=max_rank_delta(got, want),
        rank_rtol=INT8_RANK_RTOL, queries=len(CAPTIONS))
    check(float(cos.min()) >= INT8_CARD_COSINE_MIN,
          f"int8 tower card vs cpu cosine {cos.min()}")
    hold_rankings(got, want, INT8_RANK_RTOL, "int8 card vs cpu")

    # the control: read, not held
    from lightningdot_tpu_torch.models import quantized
    from lightningdot_tpu_torch.ops import ffn_int8

    def quant_rows_true_division(xf):
        xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127
        return torch.round(xf / xs).clamp(-127, 127).to(torch.int8), xs

    sound = ffn_int8._quant_rows
    quantized._quant_rows = ffn_int8._quant_rows = quant_rows_true_division
    try:
        vec_ctl = ref.encode_queries(CAPTIONS)
        ctl = rankings(ref, CAPTIONS)
    finally:
        quantized._quant_rows = ffn_int8._quant_rows = sound

    def min_cos(a, b):
        return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                         * np.linalg.norm(b, axis=1))).min())

    peak = max(abs(s) for lst in want for _, s in lst)
    emit(phase="int8_control", control="true-division activation scale, cpu",
         min_cosine_to_cpu=min_cos(vec_ctl, vec_ref),
         min_cosine_to_card=min_cos(vec_ctl, vec8),
         min_cosine_to_bf16=min_cos(vec_ctl, vec16),
         max_rank_score_delta_to_cpu=max_rank_delta(ctl, want),
         rank_rtol_to_cpu=max_rank_delta(ctl, want) / peak)
    return counts


def train_configs(dropout):
    """The fine-tuning towers of configs/coco_ft.json: BERT-base cased and
    UNITER-base (configs/img_base.json: 12 x 768, 12 heads, intermediate
    3072, vocab 28,996, img_dim 2048), both with project_dim 768."""
    from lightningdot_tpu_torch.config import EncoderConfig

    kw = dict(MODEL, project_dim=768, hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    return EncoderConfig(**kw), EncoderConfig(**kw, img_dim=IMG_DIM)


def _grads(model):
    return {n: (p.grad.detach().float().cpu() if p.grad is not None
                else torch.zeros(p.shape))
            for n, p in model.named_parameters()}


def _leaf_rel_l2(got, want):
    """Worst relative L2 over the leaves, each against max(its own norm,
    1e-3 of the largest leaf norm): leaves whose exact gradient cancels
    (attention key biases: 0) would otherwise divide noise by noise."""
    top = max(float(w.norm()) for w in want.values())
    return max(float((got[n] - w).norm()) / max(float(w.norm()), 1e-3 * top)
               for n, w in want.items())


def _cosine(a, b):
    a = torch.cat([t.reshape(-1) for t in a.values()]).double()
    b = torch.cat([t.reshape(-1) for t in b.values()]).double()
    return float(a @ b / (a.norm() * b.norm()))


def bf16_loss_controls(build, batches):
    """|bf16 loss - f32 loss| / f32 loss at dropout 0 on each batch, through
    three valid bf16 attentions: the tensor-core kernel (the path), its twin
    on the card (the bits of the FMA kernel it replaced), and the plain path
    on the CPU. Their spread is the noise of the loss check."""
    from lightningdot_tpu_torch.models import encoder
    from lightningdot_tpu_torch.ops import attention
    from lightningdot_tpu_torch.training.itm_step import (batch_to_device,
                                                          itm_loss_fn)

    def losses(dtype, device):
        m = build(dtype, 0.0).to(device)
        with torch.no_grad():
            return [itm_loss_fn(m, batch_to_device(b, device))[0].item()
                    for b in batches]

    f32 = losses(torch.float32, DEVICE)
    readings = {"kernel_card": losses(torch.bfloat16, DEVICE)}
    kernel = encoder.multi_head_attention
    encoder.multi_head_attention = (
        lambda q, k, v, bias: attention._attention_math(
            q, k, v, bias, q.shape[-1] ** -0.5))
    try:
        readings["twin_card"] = losses(torch.bfloat16, DEVICE)
    finally:
        encoder.multi_head_attention = kernel
    readings["plain_cpu"] = losses(torch.bfloat16, "cpu")
    return {name: [abs(x - y) / abs(y) for x, y in zip(got, f32)]
            for name, got in readings.items()}


def composition_control(step, batches, dropout_gen):
    """The same step with the training attention of PR 5 in place of the
    fused kernels, read beside them: ``ops/fused.py``'s composition (JAX's
    default path) with a bool keep mask drawn by ``torch.rand`` per layer.
    ms/step (p50 of 10) and a profile row, for the launches per step."""
    from lightningdot_tpu_torch.models import encoder
    from lightningdot_tpu_torch.ops import fused

    def composed(q, k, v, bias2d, seed, *, nh, rate):
        b, s, w = q.shape
        keep = torch.rand((b, nh, s, s), device=q.device) < 1.0 - rate
        heads = [t.view(b, s, nh, w // nh) for t in (q, k, v)]
        return fused.attention_prob_dropout(
            *heads, bias2d[:, None, None, :], keep, rate=rate,
            scale=(w // nh) ** -0.5).reshape(b, s, w)

    kernel = encoder.fused_attention_train
    encoder.fused_attention_train = composed
    try:
        step(batches[0], dropout_gen)
        lat = []
        for i in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(batches[i % 4], dropout_gen)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        p50 = statistics.median(lat)
        emit(phase="itm_train_composition", batch=TRAIN_BATCH, steps=10,
             ms_per_step_p50=p50, pairs_per_s=TRAIN_BATCH * 1e3 / p50,
             attention="ops/fused.py composition (PR 5)")
        emit_profile("itm_train_composition", TRAIN_BATCH,
                     lambda: step(batches[0], dropout_gen), p50, calls=3)
    finally:
        encoder.fused_attention_train = kernel


def train_phase(args, device_name):
    """ITM fine-tuning at the configuration of configs/coco_ft.json: both
    towers at full width with project_dim 768 (random weights from
    ``--seed``), bf16 compute over float32 masters, dropout 0.1, batch 64
    of synthetic pairs (num_bb 36 -> image S 64; captions of 12-30 ids ->
    text S 32), the bidirectional in-batch NCE loss, clip 2.0, AdamW (0.9,
    0.999, 1e-8, wd 0) under the linear schedule at lr 2e-5, as
    cli/train_itm.py:160-177 builds them, through ``make_itm_train_step``.

    Speed (p50 of TRAIN_STEPS steps after 3 warm-up steps), a profiler
    pass, eval-after-step against a fresh model, learning on one fixed
    batch, float32 on the card against the plain path on the CPU (with TF32
    products as the control) at dropout 0 and at attention dropout 0.1
    with one step seed on both devices, bfloat16 against float32 on the
    card (with another batch's gradient as the control)."""
    from dataclasses import replace

    from lightningdot_tpu_torch.data.itm import (CollateConfig,
                                                 itm_fast_collate)
    from lightningdot_tpu_torch.models import BiEncoder, init_tower_
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training.itm_step import (
        batch_to_device, itm_loss_fn, make_itm_train_step)
    from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                       schedule_linear)

    t0 = time.perf_counter()
    txt_cfg, img_cfg = train_configs(0.1)
    master = BiEncoder(txt_cfg, img_cfg)
    gen = torch.Generator().manual_seed(args.seed + 3)
    init_tower_(master.txt_model, gen)
    init_tower_(master.img_model, gen)
    state = master.state_dict()
    n_params = sum(p.numel() for p in master.parameters())
    del master
    data = SynthImages(4 * TRAIN_BATCH, NUM_BB, args.seed + 3, "train")
    batches = list(image_loader(data, TRAIN_BATCH))
    check(batches[0]["txts"]["input_ids"].shape[1] == 32
          and batches[0]["imgs"]["attention_mask"].shape[1] == 64,
          "training batches are not at text S 32 and image S 64")

    def build(dtype, dropout, weights=state, attn_dropout=None):
        attn = dropout if attn_dropout is None else attn_dropout
        m = BiEncoder(*(replace(c, hidden_dropout_prob=dropout,
                                attention_probs_dropout_prob=attn)
                        for c in (txt_cfg, img_cfg)), compute_dtype=dtype)
        m.load_state_dict(weights)
        return m.train()

    # memory that earlier phases left allocated on the card: it sits under
    # the step's peak below
    gc.collect()
    emit(phase="setup_train", seconds=time.perf_counter() - t0,
         params=n_params, batch=TRAIN_BATCH, txt_len=32, img_len=64,
         allocated_before_gb=torch.cuda.memory_allocated() / 2 ** 30)

    # speed, at the fine-tuning configuration
    model = build(torch.bfloat16, 0.1)
    step = make_itm_train_step(model, make_optimizer(
        model, schedule_linear(DIST_LR, 0, 1000), max_grad_norm=2.0),
        device=DEVICE)
    dropout_gen = torch.Generator().manual_seed(args.seed)
    for i in range(3):
        step(batches[i % 4], dropout_gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, losses = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        metrics = step(batches[i % 4], dropout_gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"])
    counts = launch_counts()
    losses = [float(x) for x in losses]
    p50 = statistics.median(lat)
    emit(phase="itm_train", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         ms_per_step_p50=p50, ms_per_step_p90=float(np.percentile(lat, 90)),
         pairs_per_s=TRAIN_BATCH * 1e3 / p50,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         loss_first=losses[0], loss_last=losses[-1],
         grad_norm_last=float(metrics["grad_norm"]), device=device_name)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    hold_path("itm_train", counts)
    emit(phase="launches_per_step", path="itm_train", steps=TRAIN_STEPS,
         **{k: n / TRAIN_STEPS for k, n in counts.items()})
    emit_profile("itm_train", TRAIN_BATCH,
                 lambda: step(batches[0], dropout_gen), p50, calls=3)
    composition_control(step, batches, dropout_gen)

    # eval after the steps: the cached bf16 casts must see the new weights
    model.eval()
    sub = batch_to_device(itm_fast_collate([data[i] for i in range(8)],
                                           CollateConfig()), DEVICE)
    fresh = build(torch.bfloat16, 0.1).to(DEVICE).eval()
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        same = torch.equal(model.encode_txt(sub["txts"]),
                           fresh.encode_txt(sub["txts"]))
    emit(phase="train_eval_after_step", equal_to_fresh_model=same)
    check(same, "eval after training steps serves stale weights")
    del model, fresh, step

    # the same step in float32 (--compute_dtype f32, TF32 off), dropout
    # 0.1: every layer's attention through B5's float32 kernels; the share
    # of the device time they take
    model = build(torch.float32, 0.1)
    step = make_itm_train_step(model, make_optimizer(
        model, schedule_linear(DIST_LR, 0, 1000), max_grad_norm=2.0),
        device=DEVICE)
    for i in range(3):
        step(batches[i % 4], dropout_gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, losses = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        metrics = step(batches[i % 4], dropout_gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
    counts_f32_full = launch_counts()
    p50_f32 = statistics.median(lat)
    emit(phase="itm_train_f32_full", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         dtype="float32", dropout=0.1, tf32=False,
         ms_per_step_p50=p50_f32,
         ms_per_step_p90=float(np.percentile(lat, 90)),
         pairs_per_s=TRAIN_BATCH * 1e3 / p50_f32,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         loss_first=losses[0], loss_last=losses[-1], device=device_name)
    check(all(np.isfinite(losses)),
          f"non-finite float32 training loss: {losses}")
    hold_path("itm_train_f32_full", counts_f32_full)
    prof = emit_profile("itm_train_f32_full", TRAIN_BATCH,
                        lambda: step(batches[0], dropout_gen), p50_f32,
                        calls=3, shares={"b5_f32": B5_F32_KERNELS,
                                         "dh1_f32": DH1_F32_KERNELS})
    # the profile's dh1 kernels are the wrapper's launches (a transpose
    # and a GEMM each)
    check(prof["shares"]["dh1_f32"]["launches"] == DH1_F32_DEVICE_KERNELS
          * counts_f32_full["ffn_dh1"] / TRAIN_STEPS,
          f"float32 step: the profile's dh1 kernels {prof['shares']} are "
          f"not the {counts_f32_full['ffn_dh1']} launches of "
          f"{TRAIN_STEPS} steps")
    del model, step

    # learning: one fixed batch, constant lr
    model = build(torch.bfloat16, 0.1)
    step = make_itm_train_step(model, make_optimizer(
        model, LEARN_LR, max_grad_norm=2.0), device=DEVICE)
    curve = [float(step(batches[0], dropout_gen)["loss"])
             for _ in range(LEARN_STEPS)]
    tail = statistics.mean(curve[-5:])
    emit(phase="train_learns", lr=LEARN_LR, steps=LEARN_STEPS,
         loss_first=curve[0], loss_last5_mean=tail,
         bound=LEARN_LOSS_FRAC * curve[0], ln_batch=math.log(TRAIN_BATCH),
         curve=curve[::5])
    check(tail < LEARN_LOSS_FRAC * curve[0],
          f"loss on a fixed batch fell only from {curve[0]} to {tail}")
    del model, step

    # float32, dropout 0, batch 8, from the random init (where the scores
    # spread by ~10, so the gradients carry signal): the card against the
    # plain path on the CPU, two steps; the control is the card with TF32
    # products. The parameters after two steps are judged by the loss they
    # give: Adam scales each element's step by 1/sqrt(v), so an element
    # whose exact gradient is ~0 (the attention key biases, exactly 0) steps
    # by noise of lr size either way; the update's relative L2 is read.
    small = itm_fast_collate(
        [data[i] for i in range(TRAIN_BATCH, TRAIN_BATCH + 8)],
        CollateConfig())
    other = itm_fast_collate(
        [data[i] for i in range(TRAIN_BATCH + 8, TRAIN_BATCH + 16)],
        CollateConfig())
    readings = {}
    for dev in (DEVICE, "cpu"):
        m = build(torch.float32, 0.0)
        st = make_itm_train_step(m, make_optimizer(m, 2e-5,
                                                   max_grad_norm=2.0),
                                 device=dev)
        loss = float(st(small)["loss"])
        grads = _grads(m)
        st(small)
        with torch.no_grad():
            after = itm_loss_fn(m, batch_to_device(small, dev))[0].item()
        update = {n: p.detach().cpu() - state[n]
                  for n, p in m.named_parameters()}
        readings[dev] = (loss, grads, after, update)
        if dev == DEVICE:
            card_model = m
        else:
            del m
    (l_card, g_card, a_card, u_card) = readings[DEVICE]
    (l_cpu, g_cpu, a_cpu, u_cpu) = readings["cpu"]
    card_model.load_state_dict(state)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card_model.zero_grad()
        loss_tf32 = itm_loss_fn(card_model,
                                batch_to_device(small, DEVICE))[0]
        loss_tf32.backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    g_tf32 = _grads(card_model)
    card_model.zero_grad()
    itm_loss_fn(card_model, batch_to_device(other, DEVICE))[0].backward()
    g_other = _grads(card_model)
    del card_model
    diff2 = sum(float((u_card[n] - u).double().square().sum())
                for n, u in u_cpu.items())
    norm2 = sum(float(u.double().square().sum()) for u in u_cpu.values())
    row = dict(
        phase="train_f32_card_vs_cpu", batch=8, loss_card=l_card,
        loss_cpu=l_cpu, loss_rel=abs(l_card - l_cpu) / abs(l_cpu),
        loss_rel_max=TRAIN_F32_LOSS_RTOL,
        grad_leaf_rel_l2=_leaf_rel_l2(g_card, g_cpu),
        grad_rel_l2_max=TRAIN_F32_GRAD_RTOL,
        loss_after_2_steps_card=a_card, loss_after_2_steps_cpu=a_cpu,
        loss_after_2_steps_rel=abs(a_card - a_cpu) / abs(a_cpu),
        update_2_steps_rel_l2=math.sqrt(diff2 / norm2),
        control="float32 card with TF32 products",
        control_loss_rel=abs(loss_tf32.item() - l_cpu) / abs(l_cpu),
        control_grad_leaf_rel_l2=_leaf_rel_l2(g_tf32, g_cpu))
    emit(**row)
    check(row["loss_rel"] <= TRAIN_F32_LOSS_RTOL
          and row["grad_leaf_rel_l2"] <= TRAIN_F32_GRAD_RTOL
          and row["loss_after_2_steps_rel"] <= TRAIN_F32_LOSS_RTOL,
          f"float32 training, card vs cpu: {row}")

    # float32 with attention dropout 0.1 (hidden dropout 0), one step seed
    # on both devices: the kernels on the card and the twins on the CPU
    # must draw the same Philox masks, forward and backward
    drop = {}
    for dev in (DEVICE, "cpu"):
        m = build(torch.float32, 0.0, attn_dropout=0.1)
        st = make_itm_train_step(m, make_optimizer(m, 2e-5,
                                                   max_grad_norm=2.0),
                                 device=dev)
        reset_launch_counts()
        loss = float(st(small, torch.Generator().manual_seed(
            args.seed + 4))["loss"])
        if dev == DEVICE:
            counts_f32 = launch_counts()
        drop[dev] = (loss, _grads(m))
        del m, st
    hold_path("itm_train_f32", counts_f32)
    # the control: TF32 products on the card, the generators the step makes
    # from the same seed (the step itself refuses TF32 in float32)
    m = build(torch.float32, 0.0, attn_dropout=0.1).to(DEVICE)
    seeds = torch.randint(0, 2 ** 62, (3,), generator=torch.Generator()
                          .manual_seed(args.seed + 4))
    gens = [torch.Generator(device=DEVICE).manual_seed(int(x))
            for x in seeds]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ld_tf32 = itm_loss_fn(m, batch_to_device(small, DEVICE), gens)[0]
        ld_tf32.backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    gd_tf32 = _grads(m)
    del m
    (ld_card, gd_card), (ld_cpu, gd_cpu) = drop[DEVICE], drop["cpu"]
    row = dict(
        phase="train_f32_card_vs_cpu_attn_dropout", batch=8,
        attention_dropout=0.1, hidden_dropout=0.0, loss_card=ld_card,
        loss_cpu=ld_cpu, loss_rel=abs(ld_card - ld_cpu) / abs(ld_cpu),
        loss_rel_max=TRAIN_F32_LOSS_RTOL,
        grad_leaf_rel_l2=_leaf_rel_l2(gd_card, gd_cpu),
        grad_rel_l2_max=TRAIN_F32_GRAD_RTOL,
        control="float32 card with TF32 products, the same masks",
        control_loss_rel=abs(ld_tf32.item() - ld_cpu) / abs(ld_cpu),
        control_grad_leaf_rel_l2=_leaf_rel_l2(gd_tf32, gd_cpu))
    emit(**row)
    check(row["loss_rel"] <= TRAIN_F32_LOSS_RTOL
          and row["grad_leaf_rel_l2"] <= TRAIN_F32_GRAD_RTOL,
          f"float32 training with attention dropout, card vs cpu: {row}")

    # bfloat16 against float32 on the card, same weights and batch
    m = build(torch.bfloat16, 0.0).to(DEVICE)
    loss16 = itm_loss_fn(m, batch_to_device(small, DEVICE))[0]
    loss16.backward()
    g16 = _grads(m)
    del m
    more = [itm_fast_collate([data[i] for i in range(j, j + 8)],
                             CollateConfig())
            for j in (TRAIN_BATCH + 16, TRAIN_BATCH + 24)]
    row = dict(phase="train_bf16_vs_f32", batch=8, loss_bf16=loss16.item(),
               loss_f32=l_card,
               loss_rel=abs(loss16.item() - l_card) / abs(l_card),
               loss_rel_max=TRAIN_BF16_LOSS_RTOL,
               loss_control="three bf16 attentions, four batches",
               control_loss_rel=bf16_loss_controls(
                   build, [small, other] + more),
               grad_cosine=_cosine(g16, g_card),
               grad_cosine_min=TRAIN_BF16_COSINE_MIN,
               control="float32 gradient of another batch",
               control_grad_cosine=_cosine(g_other, g_card))
    emit(**row)
    check(row["loss_rel"] <= TRAIN_BF16_LOSS_RTOL
          and row["grad_cosine"] >= TRAIN_BF16_COSINE_MIN,
          f"bfloat16 training vs float32: {row}")
    return dict(counts=counts, counts_f32=counts_f32,
                counts_f32_full=counts_f32_full, n_params=n_params)


class ShapeRecorder:
    """Record the shapes at which the towers and the pre-training heads
    call the kernels' ops, by wrapping those ops where ``models/encoder.py``
    calls them, each key (kind, dtype, ...): in bfloat16 the training
    attention ("attention_train", [B, S], forward and backward), the
    attention ("attention", [B, S]), the FFN (rows; with gradient: the
    forward writing h1 and dh1), ``dropout_add_ln`` and ``layer_norm``
    (rows, hidden, prologue variant; with gradient: the backward kernel
    too); in float32, the cross-encoder teachers' dtype, the attention and
    the FFN (B2's and B3's FMA kernels). :func:`hold_recorded` holds a
    kernel row at each."""

    OPS = ("fused_attention_train", "multi_head_attention",
           "attention_nodrop", "ffn_gelu", "dropout_add_ln", "layer_norm")

    def __init__(self):
        self.seen = set()

    @staticmethod
    def _grad(*tensors):
        return torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)

    def _key(self, name, args, kw):
        x = args[0]
        if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32):
            return None
        dt = str(x.dtype).replace("torch.", "")
        if dt == "float32" and name not in ("multi_head_attention",
                                            "attention_nodrop", "ffn_gelu"):
            return None
        if name == "fused_attention_train":
            return ("attention_train", dt, x.shape[0], x.shape[1])
        if name in ("multi_head_attention", "attention_nodrop"):
            return ("attention", dt, x.shape[0], x.shape[1])
        rows, h = x.numel() // x.shape[-1], x.shape[-1]
        if name == "ffn_gelu":
            return ("ffn", dt, rows, self._grad(*args))
        if name == "dropout_add_ln":
            keep = args[4] if len(args) > 4 else kw.get("keep")
            return ("layernorm", dt, rows, h,
                    "res" if keep is None else "res_keep",
                    self._grad(*args[:4]))
        return ("layernorm", dt, rows, h, None, self._grad(*args[:3]))

    def __enter__(self):
        from lightningdot_tpu_torch.models import encoder

        self._real = {n: getattr(encoder, n) for n in self.OPS}

        def wrap(name):
            real = self._real[name]

            def op(*args, **kw):
                key = self._key(name, args, kw)
                if key is not None:
                    self.seen.add(key)
                return real(*args, **kw)

            return op

        for name in self.OPS:
            setattr(encoder, name, wrap(name))
        return self

    def __exit__(self, *exc):
        from lightningdot_tpu_torch.models import encoder

        for name, real in self._real.items():
            setattr(encoder, name, real)


# the recorded shapes already held by a path's kernel rows
_HELD: set = set()


def hold_recorded(path, seen, device_name):
    """A kernel row (against its twin, with its bound, library call and
    time at ``RECORDED_TIMING``) at every shape a path recorded, in its
    dtype: B2 at each [B, S] (float32 bit for bit, SDPA in float32 beside
    it); B5's forward and backward at each training [B, S]; B3 at each row
    count (float32 within ``TOL``, its twin the cuBLAS float32 pair), with
    h1 out and (bf16) B6's dh1 where a gradient ran; B1's forward at each
    (rows, hidden, variant) and its backward where a gradient ran. A shape
    that an earlier path held is not held again. Returns the rows and the
    kernel shapes."""
    seen = set(seen) - _HELD
    _HELD.update(seen)
    bf16 = torch.bfloat16
    dtypes = {"bfloat16": bf16, "float32": torch.float32}
    randn, gen = make_randn(11)
    kw = dict(timing=RECORDED_TIMING, path=path)
    ffn_rows_seen = {}
    ln_fwd, ln_bwd = set(), set()
    attention, train_attention = set(), set()
    for key in seen:
        kind = key[0]
        if kind == "attention":
            attention.add(key[1:])
        elif kind == "attention_train":
            train_attention.add(key[2:])
        elif kind == "ffn":
            at = key[1:3]
            ffn_rows_seen[at] = ffn_rows_seen.get(at, False) or key[3]
        else:
            _, _, rows, h, variant, grad = key
            ln_fwd.add((rows, h, variant))
            if grad:
                ln_bwd.add((rows, h, variant or "ln"))
    rows = []
    for dt, b, s in sorted(attention):
        rows.append(attention_row(b, s, 64, dtypes[dt], device_name, randn,
                                  gen, **kw))
    for b, s in sorted(train_attention):
        rows += train_attention_rows(b, s, 64, bf16, device_name, randn, gen,
                                     **kw)
    for (dt, n), train in sorted(ffn_rows_seen.items()):
        if dt == "float32":
            check(not torch.backends.cuda.matmul.allow_tf32,
                  f"{path}: TF32 is on")
            rows += ffn_rows(n, torch.float32, device_name, randn, train,
                             plain="cuBLAS float32 GEMM pair, TF32 off",
                             **kw)
            continue
        rows += ffn_rows(n, bf16, device_name, randn, train, **kw)
        if train:
            rows.append(dh1_row(n, bf16, device_name, randn, **kw))
    for n, h, variant in sorted(ln_fwd, key=str):
        rows.append(ln_fwd_row(n, h, bf16, device_name, randn, gen, variant,
                               **kw))
    for n, h, variant in sorted(ln_bwd, key=str):
        rows.append(ln_bwd_row(n, h, variant, bf16, device_name, randn, gen,
                               **kw))
    shapes = sorted({(r["kernel"], tuple(r["shape"]), r.get("variant"),
                      r.get("mode")) for r in rows}, key=str)
    emit(phase="held_shapes", path=path, rows=len(rows),
         attention=sorted(attention), attention_train=sorted(train_attention),
         ffn_rows=sorted(ffn_rows_seen.items()),
         layernorm=sorted(ln_fwd, key=str),
         layernorm_bwd=sorted(ln_bwd, key=str))
    return rows, shapes


class StepProbe:
    """Wrap a driver's step: the wall time of each call (the card
    synchronized after it), its losses, and a torch.profiler window over
    ``profile_calls`` calls from call ``profile_at`` on. The first ``skip``
    calls and the profiled ones are not in the latencies."""

    def __init__(self, profile_at=4, profile_calls=3, skip=0):
        self.lat, self.losses = [], []
        self.profile_at, self.profile_calls = profile_at, profile_calls
        self.skip = skip
        self.stats = None
        self.calls = 0
        self._prof = None

    def wrap(self, step):
        from torch.profiler import profile

        def probed(*args, **kw):
            i = self.calls
            self.calls += 1
            if i == self.profile_at:
                torch.cuda.synchronize()
                self._prof = profile(activities=_profile_activities())
                self._prof.__enter__()
            t = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            in_window = self.profile_at <= i < (self.profile_at
                                                + self.profile_calls)
            if not in_window and i >= self.skip:
                self.lat.append(wall)
            if i == self.profile_at + self.profile_calls - 1:
                self._prof.__exit__(None, None, None)
                self.stats = _device_stats(self._prof, self.profile_calls)
            self.losses.append(out["loss"])
            return out

        return probed


def _patched(module, name, make):
    """Context: ``module.name`` replaced by ``make(original)``."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        real = getattr(module, name)
        setattr(module, name, make(real))
        try:
            yield
        finally:
            setattr(module, name, real)

    return ctx()


def train_itm_cli_phase(args, device_name):
    """The port's ``cli/train_itm.main`` on the card at configs/coco_ft.json
    (BERT-base cased + UNITER-base, ``project_dim`` 768, bf16, batch 64,
    ``valid_batch_size`` 256, linear warmup, clip 2.0) over synthetic DBs
    written by the port's writers: a train split of ``FT_TRAIN_IMAGES`` x 5
    captions and a val/test split of ``FT_VAL_IMAGES`` x 5, for 2 epochs,
    once with a hard negative mined before each epoch and once with two
    micro-batches per update. Held: finite losses, biencoder.best/last
    written, the port's ``eval_itm`` on biencoder.last gives the driver's
    final recall, a model loaded from biencoder.last gives the trained
    model's vectors bit for bit, dropout live after each evaluation (two
    passes under different generators differ), the path's launches, and a
    kernel row at every bf16 shape the runs recorded. Printed: ms/step p50
    and pairs/s, seconds per epoch (training, evaluation, mining), a
    profile row over three steps inside the driver."""
    from lightningdot_tpu_torch.cli import eval_itm, train_itm
    from lightningdot_tpu_torch.config import parse_with_config
    from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
    from lightningdot_tpu_torch.data.itm import CollateConfig, itm_fast_collate
    from lightningdot_tpu_torch.models.factory import build_biencoder
    from lightningdot_tpu_torch.training.trainer_utils import load_dataset
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training.itm_step import batch_to_device

    counts = {}
    recorder = ShapeRecorder()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train = write_eval_dbs(Path(tmp) / "train", FT_TRAIN_IMAGES, 5,
                               args.seed + 5)
        val = write_eval_dbs(Path(tmp) / "val", FT_VAL_IMAGES, 5,
                             args.seed + 6)
        emit(phase="setup_train_itm_cli", seconds=time.perf_counter() - t0,
             train_pairs=FT_TRAIN_IMAGES * 5, val_pairs=FT_VAL_IMAGES * 5,
             reduced=[f"train split {FT_TRAIN_IMAGES} x 5 synthetic pairs "
                      f"(COCO train+restval: 113,287 x 5)",
                      f"val and test split {FT_VAL_IMAGES} x 5 (COCO: "
                      f"5,000 x 5)", "2 epochs (coco_ft.json: 20)",
                      "random weights (no uniter-base.pt)"])
        base = ["--config", FT_CONFIG, "--itm_global_file", "",
                "--img_checkpoint", "none", "--seed", str(args.seed),
                "--train_txt_dbs", train[0], "--train_img_dbs", train[1],
                "--val_txt_db", val[0], "--val_img_db", val[1],
                "--test_txt_db", val[0], "--test_img_db", val[1],
                "--num_train_epochs", "2", "--device", DEVICE]
        for run, extra in (("hard_negatives", ["--num_hard_negatives", "1",
                                               "--sample_init_hard_negatives"]),
                           ("accumulation",
                            ["--gradient_accumulation_steps", "2"])):
            out = str(Path(tmp) / run)
            probe = StepProbe()
            # "eval" after each per-epoch evaluation, then, at the next
            # step: training mode and two passes under other generators
            # that differ
            live = []

            def make_step(real, probe=probe, live=live):
                def build(model, *a, **k):
                    step = probe.wrap(real(model, *a, **k))

                    def checked(batch, generator=None):
                        if live and live[-1] == "eval":
                            sub = batch_to_device(batch, torch.device(DEVICE))
                            with torch.no_grad():
                                outs = [model.apply(sub, [
                                    torch.Generator(DEVICE).manual_seed(
                                        s + i) for i in range(3)])[0]
                                    for s in (1, 7)]
                            live[-1] = (model.training
                                        and not torch.equal(*outs))
                        return step(batch, generator)

                    return checked

                return build

            def mark_eval(real, live=live):
                def evaluate(*a, **k):
                    res = real(*a, **k)
                    live.append("eval")
                    return res

                return evaluate

            reset_launch_counts()
            t = time.perf_counter()
            with recorder, _patched(train_itm, "make_itm_train_step",
                                    make_step), \
                    _patched(train_itm, "eval_model_on_dataloader",
                             mark_eval):
                results, model = train_itm.main(base + extra + [
                    "--output_dir", out])
            cli_s = time.perf_counter() - t
            counts = {k: counts.get(k, 0) + v
                      for k, v in launch_counts().items()}
            losses = [float(x) for x in probe.losses]
            p50 = statistics.median(probe.lat)
            epochs = results["epochs"]
            emit(phase="train_itm_cli", run=run, steps=probe.calls,
                 ms_per_step_p50=p50, pairs_per_s=64 * 1e3 / p50,
                 loss_first=losses[0], loss_last=losses[-1],
                 best_val_recall_mean=results["best_val_recall_mean"],
                 init_mine_s=results["init_mine_s"],
                 epoch_seconds=[{k: e[k] for k in ("train_s", "eval_s",
                                                   "mine_s", "steps")}
                                for e in epochs], cli_seconds=cli_s,
                 device=device_name)
            check(all(np.isfinite(losses)), f"{run}: non-finite loss")
            check(all(os.path.exists(os.path.join(out, f"biencoder.{n}.pt"))
                      for n in ("best", "last")),
                  f"{run}: biencoder.best/last not written")
            # held against the driver
            evaluated = [x for x in live if x != "eval"]
            emit(phase="train_itm_cli_dropout_live", run=run,
                 after_evaluations=evaluated)
            check(evaluated and all(evaluated),
                  f"{run}: dropout not live after an evaluation: {live}")
            got = eval_itm.main([
                "--config", EVAL_CONFIG, "--itm_global_file", "",
                "--test_txt_db", val[0], "--test_img_db", val[1],
                "--valid_batch_size", "256", "--device", DEVICE,
                "--biencoder_checkpoint",
                os.path.join(out, "biencoder.last")])["test"]
            last = epochs[-1]
            same = (got["recall_txt"] == last["recall_txt"]
                    and got["recall_img"] == last["recall_img"])
            ckpt_args = parse_with_config(
                train_itm.build_parser(),
                base + ["--biencoder_checkpoint",
                        os.path.join(out, "biencoder.last")])
            fresh = build_biencoder(ckpt_args).to(DEVICE).eval()
            model.eval()
            ds = load_dataset(ImageDbGroup(0.2, 100, 10, 36), val[0], val[1],
                              ckpt_args, is_train=False)
            ds.new_epoch()
            sub = batch_to_device(itm_fast_collate(
                [ds[i] for i in range(16)], CollateConfig()),
                torch.device(DEVICE))
            with torch.no_grad():
                bits = all(torch.equal(a, b) for a, b in zip(
                    model.apply(sub)[:2], fresh.apply(sub)[:2]))
            emit(phase="train_itm_cli_checkpoint", run=run,
                 eval_cli_recall=[got["recall_txt"], got["recall_img"]],
                 driver_recall=[last["recall_txt"], last["recall_img"]],
                 recall_equal=same, vectors_bit_equal=bits)
            check(same, f"{run}: eval_itm on biencoder.last {got} vs the "
                        f"driver's {last}")
            check(bits, f"{run}: biencoder.last does not give the trained "
                        f"model's vectors")
            emit_profile_stats("train_itm_cli", 64, probe.stats, p50, run=run)
            del model, fresh
    hold_path("train_itm_cli", counts)
    rows, _ = hold_recorded("train_itm_cli", recorder.seen, device_name)
    return dict(counts=counts, rows=rows)


def _real_tokens(batch):
    """Tokens of a pre-training batch's real rows: text and image tokens
    under their attention masks."""
    n = batch["n_valid"]
    return int(np.asarray(batch["txts"]["attention_mask"])[:n].sum()
               + np.asarray(batch["imgs"]["attention_mask"])[:n].sum())


def _flat_grad(model):
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in model.parameters()])


def _same_state(m1, o1, m2, o2):
    """Two models' parameters and two FusedAdamW's count and moments are
    equal bit for bit."""
    if not all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                 m2.parameters())):
        return False
    s1, s2 = o1.state_dict(), o2.state_dict()
    if s1["count"] != s2["count"] or (s1["m"] is None) != (s2["m"] is None):
        return False
    return s1["m"] is None or all(
        torch.equal(s1[k][n], s2[k][n]) for k in ("m", "v") for n in s1[k])


def _loss_and_grad(model, batch, task):
    from lightningdot_tpu_torch.training.pretrain_step import task_loss

    model.zero_grad()
    loss = task_loss(model, batch, task)[0]
    loss.backward()
    return loss.item(), _flat_grad(model)


def _round_mantissa(x, bits):
    """float32 ``x`` rounded to ``bits`` mantissa bits (to nearest, ties
    away from zero), its exponent range kept."""
    drop = 23 - bits
    i = x.view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


@contextlib.contextmanager
def _coarse(model, bits):
    """Context: the float32 ``model`` at a lower precision, every weight
    and the output of every dense layer, LayerNorm and transformer layer
    rounded to ``bits`` mantissa bits, the gradient passed straight
    through the rounding. The weights are restored after."""
    from lightningdot_tpu_torch.models.encoder import (BertLayer, Dense,
                                                       LayerNorm)

    def coarse(mod, inp, out):
        return out + (_round_mantissa(out.detach().contiguous(), bits)
                      - out).detach()

    params = list(model.parameters())
    kept = [p.detach().clone() for p in params]
    hooks = [m.register_forward_hook(coarse) for m in model.modules()
             if isinstance(m, (BertLayer, Dense, LayerNorm))]
    try:
        with torch.no_grad():
            for p in params:
                p.copy_(_round_mantissa(p.detach(), bits))
        yield
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)


def _coarse_reading(model, batch, task, bits):
    """(loss, flat gradient) of the float32 model under ``_coarse``."""
    model.bert.compute_dtype = torch.float32
    with _coarse(model, bits):
        return _loss_and_grad(model, batch, task)


def pretrain_phase(args, device_name):
    """The port's ``cli/pretrain.main`` on the card at
    configs/pretrain_alldata_base.json's model and optimizer (BERT-base
    cased + UNITER-base, ``project_dim`` 768, bf16, 10,240-token batches,
    accumulation 6, betas (0.9, 0.98), eps 1e-6, decay 0.01, clip 5.0) with
    one dataset of its four tasks at coco_cap's ``mix_ratio`` (itm 16, mlm
    8, mrfr 4, mrckl 4) over synthetic DBs with 1,601-way soft labels
    (``PRE_TRAIN_IMAGES`` x 5 captions to train, ``PRE_VAL_IMAGES`` x 5 to
    validate), for ``PRE_UPDATES`` updates. Held: finite losses and
    validation metrics, the path's launches, a kernel row at every bf16
    shape recorded; a resume through ``latest_step_checkpoint`` and
    ``fast_forward``: the restored weights and optimizer state, the task
    stream, and the next update's losses, weights and optimizer state equal
    the uninterrupted run's; per task, float32 card vs CPU (loss, every
    gradient leaf) at 2 layers a tower, with TF32 products as the control,
    and bf16 vs f32 at full depth (loss, gradient cosine) within
    ``PRE_BF16_BOUNDS``, whose control (coarse precision) each bound must
    refuse (mlm's loss bound excepted, ``PRE_CONTROL_COSINE_ONLY``).
    Printed: ms per update and tokens/s per task, a profile row per task.
    """
    from dataclasses import replace

    from lightningdot_tpu_torch.cli import pretrain as cli
    from lightningdot_tpu_torch.config import parse_with_config
    from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
    from lightningdot_tpu_torch.data.loader import MetaLoader
    from lightningdot_tpu_torch.data.pretrain import PretrainCollateConfig
    from lightningdot_tpu_torch.models.bi_encoder import (
        BiEncoder, BiEncoderForPretraining, init_pretrain_heads_)
    from lightningdot_tpu_torch.models.encoder import init_tower_
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training import checkpoints
    from lightningdot_tpu_torch.training.pretrain_step import (
        make_pretrain_step, pretrain_batch_to_device, task_loss)
    from lightningdot_tpu_torch.utils.runtime import step_generator

    recorder = ShapeRecorder()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train = write_eval_dbs(Path(tmp) / "train", PRE_TRAIN_IMAGES, 5,
                               args.seed + 7, soft_labels=True)
        val = write_eval_dbs(Path(tmp) / "val", PRE_VAL_IMAGES, 5,
                             args.seed + 8, soft_labels=True)
        with open(PRE_CONFIG) as f:
            cfg = json.load(f)
        spec = next(d for d in cfg["train_datasets"]
                    if d["name"] == "coco_cap")
        out = str(Path(tmp) / "out")
        cfg.update(
            output_dir=out, img_checkpoint="none", seed=args.seed,
            num_train_steps=PRE_UPDATES, valid_steps=PRE_UPDATES,
            train_datasets=[dict(spec, db=[train[0]], img=[train[1]])],
            val_datasets=[{"name": "coco_cap", "db": [val[0]],
                           "img": [val[1]], "tasks": spec["tasks"]}])
        cfg_path = str(Path(tmp) / "pretrain.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        emit(phase="setup_pretrain", seconds=time.perf_counter() - t0,
             train_examples=PRE_TRAIN_IMAGES * 5,
             val_examples=PRE_VAL_IMAGES * 5, tasks=spec["tasks"],
             mix_ratio=spec["mix_ratio"],
             train_batch_tokens=cfg["train_batch_size"],
             accum=cfg["gradient_accumulation_steps"],
             reduced=["one dataset, coco_cap, of the config's four",
                      f"{PRE_TRAIN_IMAGES} x 5 synthetic examples with "
                      f"random soft labels to train, {PRE_VAL_IMAGES} x 5 "
                      f"to validate",
                      f"{PRE_UPDATES} updates (num_train_steps 300,000)",
                      "random weights (no uniter-base.pt)",
                      "the float32 card-vs-CPU check at 2 layers a tower, "
                      "16 examples a task"])

        kept = {"losses": []}

        def make_opt(real):
            def build(model, opts):
                out = real(model, opts)
                kept["opt"] = out[0]
                return out
            return build

        def make_step(real):
            def build(*a, **k):
                step_for_task = real(*a, **k)

                def for_task(task):
                    step = step_for_task(task)

                    def run(batch, generator=None):
                        metrics = step(batch, generator)
                        kept["losses"].append((task, metrics["loss"]))
                        return metrics
                    return run
                return for_task
            return build

        reset_launch_counts()
        t = time.perf_counter()
        with recorder, _patched(cli, "build_optimizer", make_opt), \
                _patched(cli, "make_pretrain_step", make_step):
            results, model = cli.main(["--config", cfg_path, "--device",
                                       DEVICE])
        cli_s = time.perf_counter() - t
        counts = launch_counts()
        losses = [(task, float(x)) for task, x in kept["losses"]]
        emit(phase="pretrain", updates=PRE_UPDATES,
             micro_batches=len(losses), losses=losses, validation=results,
             cli_seconds=cli_s, device=device_name)
        check(all(np.isfinite(x) for _, x in losses)
              and all(np.isfinite(v) for r in results.values()
                      for v in r.values()), "pretrain: non-finite loss")
        hold_path("pretrain", counts)
        opt = kept["opt"]
        opts = parse_with_config(cli.build_parser(), ["--config", cfg_path])
        accum = opts.gradient_accumulation_steps

        # resume: a fresh model and optimizer from the newest checkpoint
        # equal the uninterrupted ones bit for bit; a task stream
        # fast-forwarded equals one iterated through the micro-batches the
        # driver ran (step and RNG); then each side takes the next update
        # on the iterated stream's next window (data iterators restart on
        # resume, as in the JAX package, so a fast-forwarded stream's
        # batches are not the uninterrupted run's), and the losses, the
        # weights and the optimizer state after it are equal
        found = checkpoints.latest_step_checkpoint(os.path.join(out, "ckpt"))
        check(found is not None and found[1] == PRE_UPDATES,
              f"pretrain: newest checkpoint {found}")
        resumed = cli.build_model(opts, torch.bfloat16).to(DEVICE)
        ropt, _ = cli.build_optimizer(resumed, opts)
        checkpoints.load_checkpoint(found[0], model=resumed, optimizer=ropt)
        restored = _same_state(resumed, ropt, model, opt)
        loaders = cli.create_dataloaders(
            opts.train_datasets, True, opts,
            ImageDbGroup(opts.conf_th, opts.max_bb, opts.min_bb,
                         opts.num_bb), PretrainCollateConfig())
        ran = MetaLoader(loaders, accum_steps=accum, seed=opts.seed)
        it = iter(ran)
        for _ in range(PRE_UPDATES * accum):
            next(it)
        ff = MetaLoader(loaders, accum_steps=accum, seed=opts.seed)
        ff.fast_forward(PRE_UPDATES * accum)
        forwarded = (ff.step == ran.step
                     and ff._rng.getstate() == ran._rng.getstate())
        window = [next(it) for _ in range(accum)]
        name = window[0][0]
        task = name.split("_")[0]
        seen_losses = {}
        with recorder:
            for who, m, o in (("resumed", resumed, ropt),
                              ("uninterrupted", model, opt)):
                m.train()
                step = make_pretrain_step(m, o, accum_steps=accum,
                                          device=DEVICE)(task)
                seen_losses[who] = [float(step(b, step_generator(
                    opts.seed, PRE_UPDATES * accum + i))["loss"])
                    for i, (_, b) in enumerate(window)]
        weight_diff = max(float((p - q).abs().max()) for p, q in zip(
            resumed.parameters(), model.parameters()))
        after = _same_state(resumed, ropt, model, opt)
        emit(phase="pretrain_resume", step=found[1], next_task=name,
             window_tasks=[n for n, _ in window], losses=seen_losses,
             restored_equal=restored, fast_forward_equal=forwarded,
             weights_max_abs_diff_after=weight_diff, state_equal_after=after,
             count=[ropt.count, opt.count])
        check(restored and forwarded and after and weight_diff == 0.0
              and all(n == name for n, _ in window)
              and seen_losses["resumed"] == seen_losses["uninterrupted"]
              and ropt.count == opt.count == PRE_UPDATES + 1,
              f"pretrain: the resume differs: restored {restored}, "
              f"fast-forward {forwarded}, after {after}, weights "
              f"{weight_diff}, losses {seen_losses}")
        del resumed, ropt

        # per task: ms per update and tokens/s, a profile row
        staged = {}
        with recorder:
            for t in spec["tasks"]:
                loader = loaders[f"{t}_coco_cap"][0]
                host = []
                for b in loader:
                    host.append(b)
                    if len(host) == accum:
                        break
                check(len(host) == accum, f"pretrain {t}: a short loader")
                batches = [pretrain_batch_to_device(b, torch.device(DEVICE))
                           for b in host]
                staged[t] = batches
                step = make_pretrain_step(model, opt, accum_steps=accum,
                                          device=DEVICE)(t)
                tokens = sum(_real_tokens(b) for b in host)

                def update(step=step, batches=batches):
                    for i, b in enumerate(batches):
                        step(b, step_generator(opts.seed, 10 ** 6 + i))

                update()
                torch.cuda.synchronize()
                lat = []
                for _ in range(2):
                    t1 = time.perf_counter()
                    update()
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t1) * 1e3)
                ms = statistics.median(lat)
                emit(phase="pretrain_task", task=t, micro_batches=accum,
                     ms_per_update=ms, tokens_per_update=tokens,
                     tokens_per_s=tokens * 1e3 / ms,
                     batch_rows=[int(b["sample_size"]) for b in host],
                     txt_len=[int(b["txts"]["input_ids"].shape[1])
                              for b in host],
                     img_len=[int(b["imgs"]["attention_mask"].shape[1])
                              for b in host], device=device_name)
                emit_profile_stats(f"pretrain_{t}", accum,
                                   device_profile(update, 1), ms)

            # bfloat16 against float32 at full depth, no dropout, per task,
            # beside the control: the float32 reference with its weights and
            # layer outputs rounded to PRE_CONTROL_MANTISSA_BITS bits, which
            # each bound must refuse
            model.eval()
            for t in spec["tasks"]:
                read = {}
                for who, dtype in (("bf16", torch.bfloat16),
                                   ("f32", torch.float32)):
                    model.bert.compute_dtype = dtype
                    read[who] = _loss_and_grad(model, staged[t][0], t)
                read["control"] = _coarse_reading(
                    model, staged[t][0], t, PRE_CONTROL_MANTISSA_BITS)
                model.bert.compute_dtype = torch.bfloat16
                l32, g32 = read["f32"]
                loss_max, cos_min = PRE_BF16_BOUNDS[t]

                def held(who):
                    loss, grad = read[who]
                    rel = abs(loss - l32) / abs(l32)
                    cos = float(grad.double() @ g32.double()
                                / (grad.double().norm() * g32.double().norm()))
                    return rel, cos

                rel, cos = held("bf16")
                ctrl_rel, ctrl_cos = held("control")
                row = dict(phase="pretrain_bf16_vs_f32", task=t,
                           loss_bf16=read["bf16"][0], loss_f32=l32,
                           loss_rel=rel, loss_rel_max=loss_max,
                           grad_cosine=cos, grad_cosine_min=cos_min,
                           control=f"float32 with weights and layer "
                                   f"outputs rounded to "
                                   f"{PRE_CONTROL_MANTISSA_BITS} mantissa bits",
                           control_loss_rel=ctrl_rel,
                           control_grad_cosine=ctrl_cos)
                emit(**row)
                check(rel <= loss_max and cos >= cos_min,
                      f"pretrain {t}: bfloat16 vs float32: {row}")
                check(ctrl_cos < cos_min and (t in PRE_CONTROL_COSINE_ONLY
                                              or ctrl_rel > loss_max),
                      f"pretrain {t}: a bound passes its control: {row}")
                del read
        del model, opt, staged

        # float32 card vs CPU per task, full widths at 2 layers a tower
        cut = dict(num_hidden_layers=2, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
        cfgs = [replace(cli.resolve_encoder_config(c, project_dim=768),
                        **cut) for c in (opts.txt_model_config,
                                         opts.img_model_config)]
        small = BiEncoderForPretraining(BiEncoder(*cfgs))
        gen = torch.Generator().manual_seed(args.seed + 9)
        init_tower_(small.bert.txt_model, gen)
        init_tower_(small.bert.img_model, gen)
        init_pretrain_heads_(small, gen)
        weights = small.state_dict()
        for t in spec["tasks"]:
            loader = loaders[f"{t}_coco_cap"][0]
            batch = loader.collate_fn([loader.dataset[i] for i in range(16)])
            read = {}
            for dev, tf32 in ((DEVICE, False), ("cpu", False),
                              (DEVICE, True)):
                m = BiEncoderForPretraining(BiEncoder(*cfgs))
                m.load_state_dict(weights)
                m.to(dev)
                torch.backends.cuda.matmul.allow_tf32 = tf32
                try:
                    loss = task_loss(m, pretrain_batch_to_device(
                        batch, torch.device(dev)), t)[0]
                    loss.backward()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                read[dev, tf32] = (loss.item(), _grads(m))
                del m
            (lc, gc_), (lp, gp), (lt, gt) = (read[DEVICE, False],
                                             read["cpu", False],
                                             read[DEVICE, True])
            row = dict(phase="pretrain_f32_card_vs_cpu", task=t, batch=16,
                       layers=2, loss_card=lc, loss_cpu=lp,
                       loss_rel=abs(lc - lp) / abs(lp),
                       loss_rel_max=TRAIN_F32_LOSS_RTOL,
                       grad_leaf_rel_l2=_leaf_rel_l2(gc_, gp),
                       grad_rel_l2_max=TRAIN_F32_GRAD_RTOL,
                       control="float32 card with TF32 products",
                       control_loss_rel=abs(lt - lp) / abs(lp),
                       control_grad_leaf_rel_l2=_leaf_rel_l2(gt, gp))
            emit(**row)
            check(row["loss_rel"] <= TRAIN_F32_LOSS_RTOL
                  and row["grad_leaf_rel_l2"] <= TRAIN_F32_GRAD_RTOL,
                  f"pretrain {t}: float32 card vs cpu: {row}")
            check(row["control_loss_rel"] > TRAIN_F32_LOSS_RTOL
                  or row["control_grad_leaf_rel_l2"] > TRAIN_F32_GRAD_RTOL,
                  f"pretrain {t}: the bounds pass their control: {row}")
    rows, _ = hold_recorded("pretrain", recorder.seen, device_name)
    return dict(counts=counts, rows=rows)


# the cross-encoder slice (ROADMAP A9): the teacher is UNITER-base
# (configs/img_base.json: 12 x 768, 12 heads, vocab 28,996, img_dim 2048)
TEACHER_CONFIG = "configs/img_base.json"
# random weights at init scale give nearly one score for every pair (the
# CLS row of a random tower hardly depends on the input), so the teachers
# of these phases carry noise of this std on every parameter: the pairs
# then score apart and rankings mean something
TEACHER_NOISE = 0.05
# the re-ranking split: images x captions (COCO's test split is 5,000 x 5)
# and the small split of the float32 checks. The teacher scores in float32
# (as JAX's): 30 images keep stage 2 at 7,500 pairs (150 text queries x 30
# images + 30 image queries x 100 texts)
RERANK_IMAGES = 30
RERANK_F32_IMAGES = 20
# teacher training's split (self-mining draws 31 negatives a group)
TEACHER_IMAGES = 100
# teacher training: steps per variant, groups per batch, and the
# fixed-batch learning check (LEARN_STEPS steps at LEARN_LR; the mean of
# the last five losses under TEACHER_LEARN_FRAC of the first)
TEACHER_STEPS = 15
TEACHER_GROUPS = 8
TEACHER_LEARN_FRAC = 0.5
# the KD and pre-training KD phases: the KD run's split, and the depth of
# the pre-training KD towers and teacher
KD_IMAGES = 180
PRE_KD_LAYERS = 4
# re-ranking checks: float32 rank scores on the card vs the CPU at 2
# layers (max |delta| over the largest |score|); bf16 vs f32 at 12 layers,
# the cosine of the centered scores of 128 pairs and the top 10 held with
# swaps allowed within RERANK_RANK_RTOL of the f32 score spread; its
# control, float32 with weights and layer outputs rounded to
# PRE_CONTROL_MANTISSA_BITS mantissa bits, must fail one of the two
RERANK_F32_RTOL = 1e-4
RERANK_BF16_COSINE_MIN = 0.99
RERANK_RANK_RTOL = 5e-2
# teacher training, bf16 vs f32 at 12 layers on a fixed batch: |loss
# delta| / loss and the gradient cosine, beside the coarse control
TEACHER_BF16_BOUNDS = (2e-2, 0.99)


def perturb_(model, std, seed):
    """Add normal noise of ``std`` to every parameter (from a CPU
    generator seeded with ``seed``)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * std)
    return model


def make_teacher(cfg, seed, noise=TEACHER_NOISE):
    """A cross-encoder at ``cfg`` with random weights from ``seed`` and
    ``noise``, on the CPU in eval mode."""
    from lightningdot_tpu_torch.models.cross_encoder import (
        CrossEncoder, init_cross_encoder_)

    model = CrossEncoder(cfg)
    init_cross_encoder_(model, torch.Generator().manual_seed(seed))
    return perturb_(model, noise, seed + 1).eval()


def save_teacher_dir(model, path):
    """A teacher directory (config.json + model.pt/.json) that both
    packages' ``load_cross_encoder`` read."""
    from lightningdot_tpu_torch.training.checkpoints import save_checkpoint

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(model.cfg.to_dict(), f)
    save_checkpoint(os.path.join(path, "model"), model=model)
    return path


def _rank_pairs(txt_dir, img_dir, n):
    """``n`` (tokens, features, positions) pairs of the split: caption i
    with image (i * 7) mod images."""
    from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
    from lightningdot_tpu_torch.data.txt_db import TxtTokDb

    tdb = TxtTokDb(txt_dir, -1)
    idb = DetectFeatDb(img_dir, 0.2, 100, 10)
    ids, imgs = list(tdb.ids), sorted(tdb.img2txts)
    toks = [tdb.combine_inputs(tdb[ids[i % len(ids)]]["input_ids"])
            for i in range(n)]
    feats = [idb.get_img_feat(imgs[(i * 7) % len(imgs)]) for i in range(n)]
    return toks, [f for f, _, _ in feats], [p for _, p, _ in feats]


def _held_selection(got, want, k, tol):
    """The top ``k`` of ``got`` against ``want``'s: every pair selected by
    ``got`` scores in ``want`` within ``tol`` of ``want``'s k-th score
    (ties may swap). Returns (held, equal sets)."""
    top_got = set(np.argsort(-got)[:k].tolist())
    order = np.argsort(-want)
    kth = want[order[k - 1]]
    held = all(want[i] >= kth - tol for i in top_got)
    return held, top_got == set(order[:k].tolist())


def rerank_phase(args, device_name):
    """Two-stage retrieval at full width: the port's ``cli/rerank.main`` on
    the card over synthetic DBs of ``RERANK_IMAGES`` x 5 captions (stage 1
    the coco_eval.json bi-encoder, stage 2 a UNITER-base teacher directory
    that the port saved, scored on the fly in float32, as JAX's teacher
    scores): recall dicts, stage-2 pairs/s, the path's launches and a
    kernel row at every bf16 shape it recorded; a profile of one
    ``CrossScorer`` block of 128 pairs in bf16, and the block's time in
    float32; float32
    rank scores on the card against the CPU at 2 layers, beside TF32 as
    the control; bf16 against f32 at 12 layers (score cosine, top-10
    selections), beside float32 at 3 mantissa bits as the control;
    ``cli/inf_itm``'s results.bin on a small split fed back
    through ``--score_file``, whose recall dicts equal the on-the-fly
    run's, both in float32."""
    from dataclasses import replace

    from lightningdot_tpu_torch.cli import inf_itm, rerank
    from lightningdot_tpu_torch.models.factory import resolve_encoder_config
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training import cross_scorer

    recorder = ShapeRecorder()
    cfg = resolve_encoder_config(TEACHER_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        txt_dir, img_dir = write_eval_dbs(Path(tmp) / "db", RERANK_IMAGES, 5,
                                          args.seed + 11)
        small = write_eval_dbs(Path(tmp) / "small", RERANK_F32_IMAGES, 5,
                               args.seed + 12)
        teacher = make_teacher(cfg, args.seed + 13)
        tdir = save_teacher_dir(teacher, str(Path(tmp) / "teacher"))
        emit(phase="setup_rerank", seconds=time.perf_counter() - t0,
             images=RERANK_IMAGES, captions=RERANK_IMAGES * 5,
             teacher_noise=TEACHER_NOISE,
             reduced=[f"{RERANK_IMAGES} x 5 synthetic pairs (COCO test: "
                      f"5,000 x 5)", "random weights with noise (no "
                      "released teacher or LightningDot.pt)",
                      f"the float32 score-file check on {RERANK_F32_IMAGES}"
                      f" x 5", "the float32 card-vs-CPU check at 2 layers"])
        base = ["--config", EVAL_CONFIG, "--itm_global_file", "",
                "--valid_batch_size", str(EVAL_BATCH)]
        timed = {"pairs": 0, "seconds": 0.0}
        real_score = cross_scorer.CrossScorer.score_pairs

        def score_pairs(self, toks, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_score(self, toks, *a)
            timed["seconds"] += time.perf_counter() - t
            timed["pairs"] += len(toks)
            return out

        reset_launch_counts()
        cross_scorer.CrossScorer.score_pairs = score_pairs
        try:
            with recorder:
                t = time.perf_counter()
                out = rerank.main(base + [
                    "--test_txt_db", txt_dir, "--test_img_db", img_dir,
                    "--teacher_checkpoint", tdir, "--device", DEVICE])
                cli_s = time.perf_counter() - t
        finally:
            cross_scorer.CrossScorer.score_pairs = real_score
        counts = launch_counts()
        emit(phase="rerank", images=RERANK_IMAGES,
             stage2_pairs=timed["pairs"], stage2_seconds=timed["seconds"],
             stage2_pairs_per_s=timed["pairs"] / timed["seconds"],
             cli_seconds=cli_s, recall=out, device=device_name)
        n = RERANK_IMAGES
        check(timed["pairs"] == 5 * n * min(100, n) + n * min(100, 5 * n),
              f"rerank: stage 2 scored {timed['pairs']} pairs")
        check(all(np.isfinite(v) for r in out.values() for v in r.values()),
              f"rerank: {out}")
        hold_path("rerank", counts)

        # one CrossScorer block of 128 pairs: p50 and a profile
        model = teacher.to(DEVICE)
        model.compute_dtype = torch.bfloat16
        scorer = cross_scorer.CrossScorer(model, device=DEVICE)
        pairs = _rank_pairs(txt_dir, img_dir, 128)
        lat = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            scorer.score_pairs(*pairs)
            lat.append((time.perf_counter() - t) * 1e3)
        p50 = statistics.median(lat[1:])
        emit_profile("rerank", 128, lambda: scorer.score_pairs(*pairs), p50,
                     calls=5)

        # bf16 against f32 at 12 layers, on the same pairs; the f32 block's
        # time (the CLI's teacher) beside the bf16 one
        read, block_ms = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            model.compute_dtype = dtype
            read[dtype] = scorer.score_pairs(*pairs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            scorer.score_pairs(*pairs)
            block_ms[str(dtype)[6:]] = (time.perf_counter() - t) * 1e3
        emit(phase="rerank_block", pairs=128, ms=block_ms,
             f32_over_bf16=block_ms["float32"] / block_ms["bfloat16"],
             device=device_name)
        # the float32 block (the CLI's teacher): its device costs
        emit_profile("rerank_f32", 128, lambda: scorer.score_pairs(*pairs),
                     block_ms["float32"], calls=3)
        s16, s32 = read[torch.bfloat16], read[torch.float32]
        spread = float(s32.max() - s32.min())
        c16, c32 = s16 - s16.mean(), s32 - s32.mean()
        cos = float(c16 @ c32 / (np.linalg.norm(c16) * np.linalg.norm(c32)))
        held, same = _held_selection(s16, s32, 10,
                                     RERANK_RANK_RTOL * spread)
        with _coarse(model, PRE_CONTROL_MANTISSA_BITS):
            ctrl = scorer.score_pairs(*pairs)
        cc = ctrl - ctrl.mean()
        ctrl_cos = float(cc @ c32 / (np.linalg.norm(cc)
                                     * np.linalg.norm(c32)))
        ctrl_held, _ = _held_selection(ctrl, s32, 10,
                                       RERANK_RANK_RTOL * spread)
        row = dict(phase="rerank_bf16_vs_f32", pairs=128, layers=12,
                   score_spread_f32=spread,
                   max_abs_diff=float(np.abs(s16 - s32).max()),
                   centered_cosine=cos, cosine_min=RERANK_BF16_COSINE_MIN,
                   top10_held=held, top10_equal=same,
                   swap_tol=RERANK_RANK_RTOL * spread,
                   control=f"float32 with weights and layer outputs "
                           f"rounded to {PRE_CONTROL_MANTISSA_BITS} "
                           f"mantissa bits",
                   control_max_abs_diff=float(np.abs(ctrl - s32).max()),
                   control_centered_cosine=ctrl_cos,
                   control_top10_held=ctrl_held)
        emit(**row)
        check(cos >= RERANK_BF16_COSINE_MIN and held,
              f"rerank bf16 vs f32: {row}")
        check(ctrl_cos < RERANK_BF16_COSINE_MIN or not ctrl_held,
              f"rerank bf16 vs f32: the bounds pass their control: {row}")
        del model, scorer, teacher

        # float32 card vs CPU at 2 layers, TF32 as the control
        two = make_teacher(replace(cfg, num_hidden_layers=2), args.seed + 14)
        state = two.state_dict()
        read = {}
        for dev, tf32 in ((DEVICE, False), ("cpu", False), (DEVICE, True)):
            m = make_teacher(replace(cfg, num_hidden_layers=2), 0)
            m.load_state_dict(state)
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                read[dev, tf32] = cross_scorer.CrossScorer(
                    m, device=dev).score_pairs(*pairs)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        want = read["cpu", False]
        peak = float(np.abs(want).max())
        err = float(np.abs(read[DEVICE, False] - want).max()) / peak
        ctrl = float(np.abs(read[DEVICE, True] - want).max()) / peak
        row = dict(phase="rerank_f32_card_vs_cpu", pairs=128, layers=2,
                   score_spread=float(want.max() - want.min()),
                   max_rel_diff=err, max_rel_diff_max=RERANK_F32_RTOL,
                   control="float32 card with TF32 products",
                   control_max_rel_diff=ctrl)
        emit(**row)
        check(err <= RERANK_F32_RTOL, f"rerank f32 card vs cpu: {row}")
        check(ctrl > RERANK_F32_RTOL,
              f"rerank f32 card vs cpu: the bound passes its control: {row}")
        del two, m

        # inf_itm's results.bin through --score_file, against the
        # on-the-fly stage 2, both float32 on the card (small split)
        f32 = ["--compute_dtype", "f32", "--device", DEVICE]
        t = time.perf_counter()
        log, results_bin = inf_itm.main([
            "--txt_db", small[0], "--img_db", small[1], "--checkpoint",
            tdir, "--model_config", TEACHER_CONFIG, "--output_dir",
            str(Path(tmp) / "inf")] + f32)
        inf_s = time.perf_counter() - t
        split = base + ["--test_txt_db", small[0], "--test_img_db",
                        small[1]] + f32
        from_file = rerank.main(split + ["--score_file", results_bin])
        on_the_fly = rerank.main(split + ["--teacher_checkpoint", tdir])
        row = dict(phase="rerank_score_file", images=RERANK_F32_IMAGES,
                   inf_itm=log, inf_itm_seconds=inf_s,
                   pairs_per_s=RERANK_F32_IMAGES ** 2 * 5 / inf_s,
                   equal=from_file == on_the_fly, score_file=from_file,
                   on_the_fly=on_the_fly)
        emit(**row)
        check(from_file == on_the_fly,
              f"rerank: --score_file recall differs from on the fly: {row}")
    rows, _ = hold_recorded("rerank", recorder.seen, device_name)
    return dict(counts=counts, rows=rows)


def _teacher_loss_and_grad(model, batch, sample_size):
    model.zero_grad()
    loss = model.apply(batch, sample_size=sample_size).mean()
    loss.backward()
    return loss.item(), {n: (p.grad.detach().float().cpu()
                             if p.grad is not None else torch.zeros(p.shape))
                         for n, p in model.named_parameters()}


def train_teacher_phase(args, device_name):
    """The port's ``cli/train_teacher.main`` on the card at UNITER-base
    (configs/img_base.json, bf16, dropout 0.1) over the re-ranking DBs:
    ``TEACHER_STEPS`` steps each of the joint variant (``TEACHER_GROUPS``
    groups of 1 + 2 pairs), self-mining (one group of 32 candidates, the
    7 hardest trained) and ``fast`` (the two-stream teacher), each writing
    a teacher directory. Held: finite losses, the directory, the path's
    launches and a kernel row at every bf16 shape recorded; the loss falls
    on a fixed batch; one training step's loss and gradient in float32 on
    the card against the CPU at 2 layers (TF32 the control) and in bf16
    against f32 at 12 layers (``TEACHER_BF16_BOUNDS``, whose control,
    float32 at 3 mantissa bits, each bound must refuse). Printed: ms/step
    p50, pairs/s, a profile row per variant."""
    from dataclasses import replace

    from lightningdot_tpu_torch.cli import train_teacher
    from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
    from lightningdot_tpu_torch.data.itm_rank import (ItmRankDataset,
                                                      itm_rank_collate)
    from lightningdot_tpu_torch.data.loader import PinnedStager, await_staged
    from lightningdot_tpu_torch.data.txt_db import TxtTokDb
    from lightningdot_tpu_torch.models.factory import resolve_encoder_config
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training.optim import make_optimizer

    recorder = ShapeRecorder()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        txt_dir, img_dir = write_eval_dbs(Path(tmp) / "db", TEACHER_IMAGES, 5,
                                          args.seed + 15)
        emit(phase="setup_train_teacher", images=TEACHER_IMAGES,
             reduced=[f"{TEACHER_STEPS} steps a variant (the reference "
                      f"trains 5,000+)", f"{TEACHER_IMAGES} x 5 synthetic "
                      f"pairs", "random weights (no uniter-base.pt)",
                      "the float32 card-vs-CPU check at 2 layers"])
        base = ["--model_config", TEACHER_CONFIG, "--train_txt_db", txt_dir,
                "--train_img_db", img_dir, "--num_train_steps",
                str(TEACHER_STEPS), "--warmup_steps", "1", "--valid_steps",
                str(TEACHER_STEPS), "--seed", str(args.seed), "--device",
                DEVICE]
        variants = {
            "joint": ["--neg_sample_size", "1", "--train_batch_size",
                      str(TEACHER_GROUPS)],
            "self_mining": ["--self_mining", "--neg_sample_size", "31",
                            "--self_mining_hard_size", "7"],
            "fast": ["--model_variant", "fast", "--neg_sample_size", "1",
                     "--train_batch_size", str(TEACHER_GROUPS)]}
        pairs_per_step = {"joint": 3 * TEACHER_GROUPS, "self_mining": 8,
                          "fast": 3 * TEACHER_GROUPS}
        for name, extra in variants.items():
            probe = StepProbe(profile_at=2, profile_calls=3, skip=2)

            def make_step(real, probe=probe):
                def build(*a, **k):
                    return probe.wrap(real(*a, **k))
                return build

            out = Path(tmp) / name
            reset_launch_counts()
            with recorder, _patched(train_teacher, "make_teacher_step",
                                    make_step):
                results, model = train_teacher.main(base + extra + [
                    "--output_dir", str(out)])
            got = launch_counts()
            counts = {k: counts.get(k, 0) + v for k, v in got.items()}
            p50 = statistics.median(probe.lat)
            losses = results["losses"]
            emit(phase="train_teacher", variant=name, steps=len(losses),
                 ms_per_step_p50=p50,
                 pairs_per_s=pairs_per_step[name] * 1e3 / p50,
                 loss_first=losses[0], loss_last=losses[-1],
                 launches=got, device=device_name)
            check(len(losses) == TEACHER_STEPS
                  and all(np.isfinite(losses)), f"teacher {name}: {losses}")
            check((out / "config.json").exists()
                  and (out / "model.pt").exists(),
                  f"teacher {name}: no teacher directory")
            emit_profile_stats("train_teacher", pairs_per_step[name],
                               probe.stats, p50, variant=name)
            del model
        hold_path("train_teacher", counts)

        # a fixed batch of 8 groups
        cfg = replace(resolve_encoder_config(TEACHER_CONFIG),
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
        ds = ItmRankDataset(TxtTokDb(txt_dir, 60),
                            DetectFeatDb(img_dir, 0.2, 100, 10), 1,
                            seed=args.seed)
        host = itm_rank_collate([ds[i] for i in range(TEACHER_GROUPS)])
        host = {k: v for k, v in host.items()
                if k not in ("n_groups", "sample_size", "attn_masks_text",
                             "attn_masks_img")}
        batch = await_staged(PinnedStager(torch.device(DEVICE))(host))

        # learning on the fixed batch, from init-scale weights: with the
        # noise, the first updates saturate the sigmoid scores and the
        # hinge stalls at the margin
        model = make_teacher(cfg, args.seed + 16, noise=0.0).to(DEVICE)
        model.compute_dtype = torch.bfloat16
        model.train()
        opt = make_optimizer(model, LEARN_LR, betas=(0.9, 0.98),
                             adam_eps=1e-6, weight_decay=0.01,
                             max_grad_norm=2.0)
        learn = []
        for _ in range(LEARN_STEPS):
            opt.zero_grad()
            loss = model.apply(batch, sample_size=3).mean()
            loss.backward()
            opt.step()
            learn.append(loss.detach())
        learn = [float(x) for x in learn]
        row = dict(phase="train_teacher_learn", steps=LEARN_STEPS,
                   lr=LEARN_LR, loss_first=learn[0],
                   loss_last5=float(np.mean(learn[-5:])),
                   frac_max=TEACHER_LEARN_FRAC)
        emit(**row)
        check(row["loss_last5"] < TEACHER_LEARN_FRAC * learn[0],
              f"teacher: no learning on a fixed batch: {row}")

        # bf16 against f32 at 12 layers, with the coarse control
        model = make_teacher(cfg, args.seed + 17).to(DEVICE)
        read = {}
        for who, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            model.compute_dtype = dtype
            read[who] = _teacher_loss_and_grad(model, batch, 3)
        model.compute_dtype = torch.float32
        with _coarse(model, PRE_CONTROL_MANTISSA_BITS):
            read["control"] = _teacher_loss_and_grad(model, batch, 3)
        l32, g32 = read["f32"]
        loss_max, cos_min = TEACHER_BF16_BOUNDS

        def held(who):
            loss, grad = read[who]
            return abs(loss - l32) / abs(l32), _cosine(grad, g32)

        rel, cos = held("bf16")
        ctrl_rel, ctrl_cos = held("control")
        row = dict(phase="train_teacher_bf16_vs_f32", layers=12,
                   loss_bf16=read["bf16"][0], loss_f32=l32, loss_rel=rel,
                   loss_rel_max=loss_max, grad_cosine=cos,
                   grad_cosine_min=cos_min,
                   control=f"float32 with weights and layer outputs "
                           f"rounded to {PRE_CONTROL_MANTISSA_BITS} "
                           f"mantissa bits",
                   control_loss_rel=ctrl_rel, control_grad_cosine=ctrl_cos)
        emit(**row)
        check(rel <= loss_max and cos >= cos_min,
              f"teacher bf16 vs f32: {row}")
        check(ctrl_rel > loss_max or ctrl_cos < cos_min,
              f"teacher bf16 vs f32: the bounds pass their control: {row}")
        del model, read

        # float32 card vs CPU at 2 layers
        two = make_teacher(replace(cfg, num_hidden_layers=2), args.seed + 18)
        state = two.state_dict()
        cpu_batch = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                     for k, v in batch.items()}
        read = {}
        for dev, tf32 in ((DEVICE, False), ("cpu", False), (DEVICE, True)):
            m = make_teacher(replace(cfg, num_hidden_layers=2), 0)
            m.load_state_dict(state)
            m.to(dev)
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                read[dev, tf32] = _teacher_loss_and_grad(
                    m, batch if dev == DEVICE else cpu_batch, 3)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        (lc, gc_), (lp, gp), (lt, gt) = (read[DEVICE, False],
                                         read["cpu", False],
                                         read[DEVICE, True])
        row = dict(phase="train_teacher_f32_card_vs_cpu", layers=2,
                   loss_card=lc, loss_cpu=lp,
                   loss_rel=abs(lc - lp) / abs(lp),
                   loss_rel_max=TRAIN_F32_LOSS_RTOL,
                   grad_leaf_rel_l2=_leaf_rel_l2(gc_, gp),
                   grad_rel_l2_max=TRAIN_F32_GRAD_RTOL,
                   control="float32 card with TF32 products",
                   control_loss_rel=abs(lt - lp) / abs(lp),
                   control_grad_leaf_rel_l2=_leaf_rel_l2(gt, gp))
        emit(**row)
        check(row["loss_rel"] <= TRAIN_F32_LOSS_RTOL
              and row["grad_leaf_rel_l2"] <= TRAIN_F32_GRAD_RTOL,
              f"teacher f32 card vs cpu: {row}")
        check(row["control_loss_rel"] > TRAIN_F32_LOSS_RTOL
              or row["control_grad_leaf_rel_l2"] > TRAIN_F32_GRAD_RTOL,
              f"teacher f32 card vs cpu: the bounds pass their control: "
              f"{row}")
    rows, _ = hold_recorded("train_teacher", recorder.seen, device_name)
    return dict(counts=counts, rows=rows)


def _f32_yardstick_calls(name, shape):
    """(kernel, yardstick) calls of B3 or B2 in float32 at a held row's
    shape: the FFN and the twin's cuBLAS float32 pair, the attention and
    SDPA in float32."""
    from lightningdot_tpu_torch.ops import attention, ffn

    randn, gen = make_randn(13)
    if name == "ffn":
        x, w1, b1, w2, b2 = _ffn_inputs(shape[0], torch.float32, randn)
        return (lambda: ffn.ffn_gelu(x, w1, b1, w2, b2),
                lambda: ffn._ffn_math(x, w1, b1, w2, b2)[0])
    b, s, _, d = shape
    q, k, v, bias = _attention_inputs(b, s, d, torch.float32, randn, gen)
    return (lambda: attention.multi_head_attention(q, k, v, bias),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=bias))


def kd_phase(args, device_name):
    """``cli/train_itm.main --teacher_checkpoint`` at configs/coco_ft.json
    (batch 64, bf16) with a UNITER-base teacher directory, one epoch over
    ``KD_IMAGES`` x 5 pairs, beside the same driver without KD: ms/step
    p50 and the device busy of each, the KD term finite, the path's
    launches and a kernel row at every bf16 shape recorded (the teacher's
    640-pair grid: ~107k FFN rows); and the teacher's forward alone on one
    step's grid: its time and device busy."""
    from lightningdot_tpu_torch.cli import train_itm
    from lightningdot_tpu_torch.data.itm import (CollateConfig,
                                                 itm_fast_collate,
                                                 make_teacher_batch)
    from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
    from lightningdot_tpu_torch.data.loader import PinnedStager, await_staged
    from lightningdot_tpu_torch.data.txt_db import TxtTokDb
    from lightningdot_tpu_torch.models.factory import (load_cross_encoder,
                                                       resolve_encoder_config)
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts

    recorder = ShapeRecorder()
    with tempfile.TemporaryDirectory() as tmp:
        txt_dir, img_dir = write_eval_dbs(Path(tmp) / "db", KD_IMAGES, 5,
                                          args.seed + 19)
        tdir = save_teacher_dir(make_teacher(
            resolve_encoder_config(TEACHER_CONFIG), args.seed + 20),
            str(Path(tmp) / "teacher"))
        emit(phase="setup_kd", images=KD_IMAGES, n_teacher=10,
             reduced=[f"1 epoch over {KD_IMAGES} x 5 synthetic pairs",
                      "random weights (no uniter-base.pt or teacher)"])
        base = ["--config", FT_CONFIG, "--itm_global_file", "",
                "--img_checkpoint", "none", "--seed", str(args.seed),
                "--train_txt_dbs", txt_dir, "--train_img_dbs", img_dir,
                "--val_txt_db", txt_dir, "--val_img_db", img_dir,
                "--test_txt_db", "", "--num_train_epochs", "1",
                "--device", DEVICE]
        read = {}
        for run, extra in (("plain", []), ("kd", [
                "--teacher_checkpoint", tdir, "--T", "2.0",
                "--kd_loss_weight", "0.5"])):
            probe = StepProbe(profile_at=2, profile_calls=2, skip=2)
            kd_losses = []

            def make_step(real, probe=probe, kd_losses=kd_losses):
                def build(*a, **k):
                    step = probe.wrap(real(*a, **k))

                    def run_step(batch, generator=None):
                        m = step(batch, generator)
                        if "kd_loss" in m:
                            kd_losses.append(m["kd_loss"])
                        return m
                    return run_step
                return build

            reset_launch_counts()
            with (recorder if run == "kd" else contextlib.nullcontext()), \
                    _patched(train_itm, "make_itm_train_step", make_step):
                results, model = train_itm.main(base + extra + [
                    "--output_dir", str(Path(tmp) / run)])
            got = launch_counts()
            p50 = statistics.median(probe.lat)
            read[run] = dict(p50=p50, busy=probe.stats["busy_ms"])
            emit(phase="kd", run=run, steps=probe.calls, ms_per_step_p50=p50,
                 pairs_per_s=64 * 1e3 / p50,
                 kd_loss=[float(x) for x in kd_losses],
                 best_val_recall_mean=results["best_val_recall_mean"],
                 device=device_name)
            emit_profile_stats("kd", 64, probe.stats, p50, run=run)
            check(all(np.isfinite(float(x)) for x in probe.losses),
                  f"kd {run}: non-finite loss")
            check(run == "plain" or (kd_losses and all(
                np.isfinite(float(x)) for x in kd_losses)),
                f"kd: no finite KD term: {kd_losses}")
            if run == "kd":
                counts = got
            del model
        emit(phase="kd_cost", step_ms_plain=read["plain"]["p50"],
             step_ms_kd=read["kd"]["p50"],
             busy_ms_plain=read["plain"]["busy"],
             busy_ms_kd=read["kd"]["busy"],
             step_ms_ratio=read["kd"]["p50"] / read["plain"]["p50"])
        hold_path("kd", counts)

        # the teacher's forward alone on one step's grid, in float32 as the
        # driver loads it
        teacher = load_cross_encoder(tdir, compute_dtype=torch.float32,
                                     device=DEVICE)
        tdb, idb = TxtTokDb(txt_dir, 60), DetectFeatDb(img_dir, 0.2, 100, 10)
        from lightningdot_tpu_torch.data.itm import ItmFastDataset
        ds = ItmFastDataset(tdb, idb)
        host = itm_fast_collate([ds[i] for i in range(64)], CollateConfig())
        grid = make_teacher_batch(host, 10)
        staged = await_staged(PinnedStager(torch.device(DEVICE))(grid))

        def forward():
            with torch.no_grad():
                return teacher.rank_scores(staged)

        with recorder:
            forward()
        lat = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        p50 = statistics.median(lat)
        rows_ = int(np.asarray(grid["attn_masks"]).shape[1]) * 640
        emit(phase="kd_teacher_forward", pairs=640, dtype="float32",
             joint_len=int(np.asarray(grid["attn_masks"]).shape[1]),
             rows=rows_, ms_p50=p50,
             grid_bytes=int(np.asarray(grid["img_feat"]).nbytes),
             device=device_name)
        emit_profile("kd_teacher", 640, forward, p50, calls=3)
        del teacher, staged
    # the recorded shapes, the float32 teacher's among them (B2 at [640,
    # 167], B3 at its ~107k rows); at the largest, each float32 FMA kernel
    # must be no slower than its yardstick: B3 the twin's cuBLAS float32
    # pair (TF32 off), B2 SDPA in float32, each the median of
    # KD_YARDSTICK_ROUNDS reads taken in turn with the kernel's
    rows, _ = hold_recorded("kd", recorder.seen, device_name)
    for name, yardstick in (("ffn", "plain_ms"), ("attention", "library_ms")):
        mine = [r for r in rows if r["kernel"] == name
                and r["dtype"] == "float32" and r.get("mode") != "train"]
        check(bool(mine), f"kd: no float32 {name} row was held")
        top = max(mine, key=lambda r: math.prod(r["shape"]))
        kernel, other = _f32_yardstick_calls(name, top["shape"])
        reads = [(time_ms(kernel, *RECORDED_TIMING),
                  time_ms(other, *RECORDED_TIMING))
                 for _ in range(KD_YARDSTICK_ROUNDS)]
        del kernel, other
        ms = statistics.median(r[0] for r in reads)
        yard_ms = statistics.median(r[1] for r in reads)
        ratios = [a / b for a, b in reads]
        row = dict(phase="kd_f32_yardstick", kernel=name, shape=top["shape"],
                   ms=ms, yardstick=yardstick, yardstick_ms=yard_ms,
                   ratio=ms / yard_ms, ratio_min=min(ratios),
                   ratio_max=max(ratios), rounds=len(reads),
                   device=device_name)
        emit(**row)
        check(ms <= yard_ms,
              f"kd: the float32 {name} kernel is slower than its "
              f"yardstick at the teacher's largest shape: {row}")
    return dict(counts=counts, rows=rows)


def pretrain_kd_phase(args, device_name):
    """Pre-training with the one-tower teacher: ``cli/pretrain.main`` with
    a ``teacher_checkpoint`` (``UniterForPretraining`` at full width and
    ``PRE_KD_LAYERS`` layers, as the student's towers) for one update of
    each non-itm task of coco_cap (mlm, mrfr, mrckl at mix 1:1:1, the
    config's 10,240-token batches without accumulation), then one update
    per task through ``make_pretrain_step`` with the teacher: finite
    losses and KD terms, ms per update, the path's launches and a kernel
    row at every bf16 shape recorded."""
    from dataclasses import replace

    from lightningdot_tpu_torch.cli import pretrain as cli
    from lightningdot_tpu_torch.config import parse_with_config
    from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
    from lightningdot_tpu_torch.data.pretrain import PretrainCollateConfig
    from lightningdot_tpu_torch.models.cross_encoder import (
        init_cross_encoder_)
    from lightningdot_tpu_torch.models.uniter_pretrain import (
        UniterForPretraining)
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training.checkpoints import save_checkpoint
    from lightningdot_tpu_torch.training.pretrain_step import (
        make_pretrain_step)
    from lightningdot_tpu_torch.utils.runtime import step_generator

    recorder = ShapeRecorder()
    tasks = ("mlm", "mrfr", "mrckl")
    with tempfile.TemporaryDirectory() as tmp:
        train = write_eval_dbs(Path(tmp) / "train", PRE_VAL_IMAGES * 2, 5,
                               args.seed + 21, soft_labels=True)
        cut = str(Path(tmp) / "model.json")
        cfg_t = replace(cli.resolve_encoder_config(TEACHER_CONFIG),
                        num_hidden_layers=PRE_KD_LAYERS)
        with open(cut, "w") as f:
            json.dump(cfg_t.to_dict(), f)
        teacher = UniterForPretraining(cfg_t)
        init_cross_encoder_(teacher, torch.Generator().manual_seed(
            args.seed + 22))
        tdir = Path(tmp) / "teacher"
        os.makedirs(tdir)
        with open(tdir / "config.json", "w") as f:
            json.dump(cfg_t.to_dict(), f)
        save_checkpoint(str(tdir / "model"), model=teacher)
        with open(PRE_CONFIG) as f:
            cfg = json.load(f)
        spec = dict(name="coco_cap", db=[train[0]], img=[train[1]],
                    tasks=list(tasks), mix_ratio=[1, 1, 1])
        cfg.update(output_dir=str(Path(tmp) / "out"), img_checkpoint="none",
                   seed=args.seed, num_train_steps=3, valid_steps=3,
                   gradient_accumulation_steps=1, txt_model_config=cut,
                   img_model_config=cut, model_config=cut,
                   teacher_checkpoint=str(tdir), T=2.0, kd_loss_weight=0.5,
                   train_datasets=[spec],
                   val_datasets=[dict(spec, tasks=["mlm"], mix_ratio=[1])])
        cfg_path = str(Path(tmp) / "pretrain_kd.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        emit(phase="setup_pretrain_kd", layers=PRE_KD_LAYERS, tasks=tasks,
             reduced=[f"{PRE_KD_LAYERS} layers a tower and in the teacher "
                      f"(12)", "accumulation 1 (6)", "3 updates",
                      "random weights"])
        kept = []

        def make_step(real):
            def build(*a, **k):
                for_task = real(*a, **k)

                def wrapped(task):
                    step = for_task(task)

                    def run(batch, generator=None):
                        m = step(batch, generator)
                        kept.append((task, m))
                        return m
                    return run
                return wrapped
            return build

        reset_launch_counts()
        t = time.perf_counter()
        with recorder, _patched(cli, "make_pretrain_step", make_step):
            results, model = cli.main(["--config", cfg_path, "--device",
                                       DEVICE])
        cli_s = time.perf_counter() - t
        counts = launch_counts()
        emit(phase="pretrain_kd", cli_seconds=cli_s,
             updates=[(task, float(m["loss"]), float(m.get("kd_loss",
                                                            float("nan"))))
                      for task, m in kept], validation=results,
             device=device_name)
        check(kept and all("kd_loss" in m and np.isfinite(float(m["kd_loss"]))
                           for _, m in kept),
              f"pretrain_kd: a driver update without a finite KD term")

        # one update per non-itm task through the step, with the teacher
        opts = parse_with_config(cli.build_parser(), ["--config", cfg_path])
        loaders = cli.create_dataloaders(
            opts.train_datasets, True, opts,
            ImageDbGroup(opts.conf_th, opts.max_bb, opts.min_bb,
                         opts.num_bb), PretrainCollateConfig(
                with_teacher=True))
        tmodel = cli.load_teacher(opts, torch.bfloat16, torch.device(DEVICE))
        opt, _ = cli.build_optimizer(model, opts)
        model.train()
        reset_launch_counts()   # the driver's launches are in counts
        with recorder:
            for task in tasks:
                batch = next(iter(loaders[f"{task}_coco_cap"][0]))
                step = make_pretrain_step(model, opt, teacher=tmodel,
                                          kd_loss_weight=0.5, kd_T=2.0,
                                          device=DEVICE)(task)
                m = step(batch, step_generator(args.seed, 0))
                torch.cuda.synchronize()
                t = time.perf_counter()
                m = step(batch, step_generator(args.seed, 1))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                emit(phase="pretrain_kd_task", task=task, ms_per_update=ms,
                     loss=float(m["loss"]), kd_loss=float(m["kd_loss"]),
                     rows=int(batch["sample_size"]), device=device_name)
                check(np.isfinite(float(m["kd_loss"])),
                      f"pretrain_kd {task}: {m}")
        counts = {k: counts.get(k, 0) + v for k, v in launch_counts().items()}
        hold_path("pretrain_kd", counts)
    rows, _ = hold_recorded("pretrain_kd", recorder.seen, device_name)
    return dict(counts=counts, rows=rows)


# VQA fine-tuning (ROADMAP A10): synthetic questions written by the port's
# synth.py (VQA v2 train has 443,757 questions; cut for the run's time,
# widths not cut), questions of up to 20 tokens, 10-100 regions an image
VQA_TRAIN_IMAGES = 400
VQA_VAL_IMAGES = 100
VQA_QUESTIONS = 5
# bf16 vs f32 at 12 layers: the loss (instance BCE summed over the 3,129
# answers) and the cosines of the whole gradient and of the towers' part;
# the control, float32 at PRE_CONTROL_MANTISSA_BITS, must fail one of them.
# An H100 run read 6.1e-5 and 0.99990 (towers 0.99990); the control 5.3e-4
# and 0.98839 (towers 0.98839): the cosine bound sits ~10x from each in
# 1 - cosine, the loss bound 16x above the reading
VQA_BF16_BOUNDS = (1e-3, 0.999)
# data preparation: region files and COCO-style captions per image
PREPRO_IMAGES = 500
PREPRO_CAPTIONS = 5


def vqa_model(layers, dtype, dropout, seed, intersection):
    """``BiEncoderForVQA`` over coco_ft.json's towers (``train_configs``)
    at ``layers`` a tower, 3,129 answers, random weights from ``seed``
    (``init_tower_``, ``init_vqa_head_``), on the CPU."""
    from dataclasses import replace

    from lightningdot_tpu_torch.models import BiEncoder
    from lightningdot_tpu_torch.models.encoder import init_tower_
    from lightningdot_tpu_torch.models.vqa import (BiEncoderForVQA,
                                                   init_vqa_head_)

    txt_cfg, img_cfg = (replace(c, num_hidden_layers=layers)
                        for c in train_configs(dropout))
    bi = BiEncoder(txt_cfg, img_cfg, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    init_tower_(bi.txt_model, gen)
    init_tower_(bi.img_model, gen)
    model = BiEncoderForVQA(bi, txt_cfg.out_size, VQA_ANSWERS,
                            intersection=intersection)
    return init_vqa_head_(model, gen)


def _vqa_loss_and_grad(model, batch):
    from lightningdot_tpu_torch.training.vqa_step import vqa_loss_fn

    model.zero_grad()
    loss = vqa_loss_fn(model, batch)[0]
    loss.backward()
    return loss.item(), _grads(model)


def vqa_phase(args, device_name):
    """The port's ``cli/train_vqa.main`` on the card at configs/coco_ft.json's
    model (BERT-base cased + UNITER-base, ``project_dim`` 768, bf16 over
    float32 masters, dropout 0.1, batch 64, ``valid_batch_size`` 256),
    ``--num_answers`` 3,129 and ``--vqa_lr_mul`` 10, over synthetic DBs
    from the port's ``synth.py`` (``VQA_TRAIN_IMAGES`` x 5 questions to
    train, ``VQA_VAL_IMAGES`` x 5 to validate): one epoch with validation
    with the plain head (LayerNorm 3,072 wide) and one with
    ``--vqa_intersection`` (6,144). Printed: ms/step p50 (the first 2 steps
    left out), questions/s, a profile row (device busy and idle, launches
    per step), the kernel launches per step. Held: finite losses,
    ``vqa.best/last`` written, the path's launches and a kernel row at
    every bf16 shape recorded; float32 on the card against the CPU at 2
    layers a tower, both head forms (the loss before and after 2 steps and
    every gradient leaf at the ITM step's bounds; the control, TF32
    products, must fail them); bf16 against f32 at 12 layers
    (``VQA_BF16_BOUNDS``; the control float32 at 3 mantissa bits); the
    loss falling on a fixed batch; ``evaluate_vqa`` in float32 on the card
    and on the CPU: the same answers and accuracy."""
    from lightningdot_tpu_torch.cli import train_vqa
    from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
    from lightningdot_tpu_torch.data.loader import DataLoader
    from lightningdot_tpu_torch.data.synth import make_synth_dataset
    from lightningdot_tpu_torch.data.txt_db import TxtTokDb
    from lightningdot_tpu_torch.data.vqa import (VqaCollateConfig,
                                                 VqaDataset, VqaEvalDataset,
                                                 vqa_collate)
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training.optim import make_optimizer
    from lightningdot_tpu_torch.training.vqa_step import (
        evaluate_vqa, make_vqa_train_step, vqa_batch_to_device, vqa_loss_fn)

    recorder = ShapeRecorder()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synth = dict(txts_per_img=VQA_QUESTIONS, img_dim=IMG_DIM, min_bb=10,
                     max_bb=100, max_txt_len=23, vqa_answers=VQA_ANSWERS)
        train = make_synth_dataset(str(Path(tmp) / "train"),
                                   n_imgs=VQA_TRAIN_IMAGES,
                                   seed=args.seed + 20, **synth)
        val = make_synth_dataset(str(Path(tmp) / "val"),
                                 n_imgs=VQA_VAL_IMAGES,
                                 seed=args.seed + 21, **synth)
        emit(phase="setup_vqa", seconds=time.perf_counter() - t0,
             train_questions=VQA_TRAIN_IMAGES * VQA_QUESTIONS,
             val_questions=VQA_VAL_IMAGES * VQA_QUESTIONS,
             answers=VQA_ANSWERS,
             reduced=[f"train split {VQA_TRAIN_IMAGES} images x "
                      f"{VQA_QUESTIONS} synthetic questions (VQA v2 train: "
                      f"443,757 questions)",
                      f"validation {VQA_VAL_IMAGES} x {VQA_QUESTIONS} (VQA "
                      f"v2 val: 214,354)", "1 epoch a head form",
                      "random weights (no uniter-base.pt)",
                      "2 layers a tower in the float32 card-vs-CPU checks"])
        base = ["--config", FT_CONFIG, "--img_checkpoint", "none",
                "--seed", str(args.seed), "--train_txt_dbs", train[0],
                "--train_img_dbs", train[1], "--val_txt_db", val[0],
                "--val_img_db", val[1], "--num_answers", str(VQA_ANSWERS),
                "--vqa_lr_mul", "10", "--num_train_epochs", "1",
                "--device", DEVICE]
        reset_launch_counts()
        for head, extra in (("plain", []),
                            ("intersection", ["--vqa_intersection"])):
            probe = StepProbe(profile_at=4, profile_calls=3, skip=2)

            def make_step(real, probe=probe):
                def build(*a, **k):
                    return probe.wrap(real(*a, **k))
                return build

            out = Path(tmp) / head
            before = launch_counts()
            t = time.perf_counter()
            with recorder, _patched(train_vqa, "make_vqa_train_step",
                                    make_step):
                results, model = train_vqa.main(base + extra + [
                    "--output_dir", str(out)])
            cli_s = time.perf_counter() - t
            got = launch_counts()
            losses = [float(x) for x in probe.losses]
            p50 = statistics.median(probe.lat)
            epoch = results["epochs"][0]
            steps = probe.calls
            emit(phase="vqa", head=head,
                 layernorm_width=model.vqa_output["2"].weight.shape[0],
                 steps=steps, timed_steps=len(probe.lat),
                 ms_per_step_p50=p50, questions_per_s=64 * 1e3 / p50,
                 loss_first=losses[0], loss_last=losses[-1],
                 val_acc=epoch["val_acc"], val_loss=epoch["val_loss"],
                 train_s=epoch["train_s"], eval_s=epoch["eval_s"],
                 cli_seconds=cli_s,
                 kernel_launches_per_step={
                     k: (got[k] - before.get(k, 0)) / steps
                     for k in PATH_KERNELS["vqa"]},
                 device=device_name)
            check(len(probe.lat) >= 10 and all(np.isfinite(losses)),
                  f"vqa {head}: {len(probe.lat)} timed steps, losses "
                  f"{losses}")
            check(all((out / f"vqa.{n}.pt").exists()
                      for n in ("best", "last")),
                  f"vqa {head}: vqa.best/last not written")
            emit_profile_stats("vqa", 64, probe.stats, p50, head=head)
            del model
        counts = launch_counts()
        hold_path("vqa", counts)

        ds = VqaDataset(VQA_ANSWERS, TxtTokDb(train[0], 60),
                        DetectFeatDb(train[1], 0.2, 100, 10, 36))
        small = vqa_collate([ds[i] for i in range(8)])
        fixed = vqa_collate([ds[i] for i in range(8, 8 + 64)])

        # float32, dropout 0, 2 layers a tower: the card against the plain
        # path on the CPU, the loss before and after two steps (the head
        # at 10x the learning rate) and every gradient leaf; the control is
        # the card with TF32 products. The two steps take the loss from
        # ~2,900 to ~440 (the head learns the answers' prior; Adam moves
        # every head weight by ~lr a step whatever its gradient's size), so
        # the delta after them is read against the loss they started from:
        # against the loss after them it read 3.2e-5 (intersection head,
        # an H100 run), float32 noise amplified by that fall
        for intersection in (False, True):
            read = {}
            for dev in (DEVICE, "cpu"):
                m = vqa_model(2, torch.float32, 0.0, args.seed + 22,
                              intersection)
                opt = make_optimizer(m, 2e-5, betas=(0.9, 0.98),
                                     adam_eps=1e-6, weight_decay=0.01,
                                     max_grad_norm=2.0, first_lr_step=1,
                                     lr_mul={"vqa_output.": 10.0})
                st = make_vqa_train_step(m, opt, device=dev)
                loss = float(st(small)["loss"])
                grads = _grads(m)
                st(small)
                with torch.no_grad():
                    after = vqa_loss_fn(m, vqa_batch_to_device(
                        small, torch.device(dev)))[0].item()
                read[dev] = (loss, grads, after)
                del m, st, opt
            m = vqa_model(2, torch.float32, 0.0, args.seed + 22,
                          intersection).to(DEVICE)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                lt, gt = _vqa_loss_and_grad(
                    m, vqa_batch_to_device(small, torch.device(DEVICE)))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            del m
            (lc, gc_, ac), (lp, gp, ap) = read[DEVICE], read["cpu"]
            row = dict(phase="vqa_f32_card_vs_cpu", layers=2, batch=8,
                       head="intersection" if intersection else "plain",
                       loss_card=lc, loss_cpu=lp,
                       loss_rel=abs(lc - lp) / abs(lp),
                       loss_rel_max=TRAIN_F32_LOSS_RTOL,
                       grad_leaf_rel_l2=_leaf_rel_l2(gc_, gp),
                       grad_rel_l2_max=TRAIN_F32_GRAD_RTOL,
                       loss_after_2_steps_card=ac,
                       loss_after_2_steps_cpu=ap,
                       loss_after_2_steps_rel=abs(ac - ap) / abs(lp),
                       loss_after_2_steps_rel_to_itself=abs(ac - ap)
                       / abs(ap),
                       control="float32 card with TF32 products",
                       control_loss_rel=abs(lt - lp) / abs(lp),
                       control_grad_leaf_rel_l2=_leaf_rel_l2(gt, gp))
            emit(**row)
            check(row["loss_rel"] <= TRAIN_F32_LOSS_RTOL
                  and row["grad_leaf_rel_l2"] <= TRAIN_F32_GRAD_RTOL
                  and row["loss_after_2_steps_rel"] <= TRAIN_F32_LOSS_RTOL,
                  f"vqa f32 card vs cpu: {row}")
            check(row["control_loss_rel"] > TRAIN_F32_LOSS_RTOL
                  or row["control_grad_leaf_rel_l2"] > TRAIN_F32_GRAD_RTOL,
                  f"vqa f32 card vs cpu: the bounds pass their control: "
                  f"{row}")

        # bf16 against f32 at 12 layers (the intersection head, LayerNorm
        # 6,144), with the coarse control
        model = vqa_model(12, torch.float32, 0.0, args.seed + 23,
                          True).to(DEVICE)
        sub = vqa_batch_to_device(small, torch.device(DEVICE))
        read = {}
        for who, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            model.biencoder.compute_dtype = dtype
            read[who] = _vqa_loss_and_grad(model, sub)
        model.biencoder.compute_dtype = torch.float32
        with _coarse(model, PRE_CONTROL_MANTISSA_BITS):
            read["control"] = _vqa_loss_and_grad(model, sub)
        l32, g32 = read["f32"]
        loss_max, cos_min = VQA_BF16_BOUNDS

        def towers(grad):
            return {n: g for n, g in grad.items()
                    if n.startswith("biencoder.")}

        def held(who):
            """|loss delta| / loss, the cosine of the whole gradient and
            that of the towers' part (the head's fc2 gradient, large and
            formed after the towers, would dominate the whole)."""
            loss, grad = read[who]
            return (abs(loss - l32) / abs(l32), _cosine(grad, g32),
                    _cosine(towers(grad), towers(g32)))

        def passes(rel, cos, cos_towers):
            return rel <= loss_max and min(cos, cos_towers) >= cos_min

        got, ctrl = held("bf16"), held("control")
        row = dict(phase="vqa_bf16_vs_f32", layers=12, batch=8,
                   head="intersection", loss_bf16=read["bf16"][0],
                   loss_f32=l32, loss_rel=got[0], loss_rel_max=loss_max,
                   grad_cosine=got[1], towers_grad_cosine=got[2],
                   grad_cosine_min=cos_min,
                   control=f"float32 with weights and layer outputs "
                           f"rounded to {PRE_CONTROL_MANTISSA_BITS} "
                           f"mantissa bits",
                   control_loss_rel=ctrl[0], control_grad_cosine=ctrl[1],
                   control_towers_grad_cosine=ctrl[2])
        emit(**row)
        check(passes(*got), f"vqa bf16 vs f32: {row}")
        check(not passes(*ctrl),
              f"vqa bf16 vs f32: the bounds pass their control: {row}")
        del model, read, sub

        # learning: one fixed batch of 64, constant lr, the head at 10x
        model = vqa_model(12, torch.bfloat16, 0.1, args.seed + 24, False)
        step = make_vqa_train_step(model, make_optimizer(
            model, LEARN_LR, betas=(0.9, 0.98), adam_eps=1e-6,
            weight_decay=0.01, max_grad_norm=2.0,
            lr_mul={"vqa_output.": 10.0}), device=DEVICE)
        model.train()
        gen = torch.Generator().manual_seed(args.seed + 25)
        curve = [float(step(fixed, gen)["loss"]) for _ in range(LEARN_STEPS)]
        tail = statistics.mean(curve[-5:])
        emit(phase="vqa_learns", lr=LEARN_LR, lr_mul=10, steps=LEARN_STEPS,
             loss_first=curve[0], loss_last5_mean=tail,
             bound=LEARN_LOSS_FRAC * curve[0], curve=curve[::5])
        check(tail < LEARN_LOSS_FRAC * curve[0],
              f"vqa: loss on a fixed batch fell only from {curve[0]} to "
              f"{tail}")
        del model, step

        # evaluate_vqa in float32 (2 layers, weights with noise 0.2 so
        # that the answers vary between questions: at their init scale the
        # towers give nearly one vector for every input): card against CPU
        model = perturb_(vqa_model(2, torch.float32, 0.0, args.seed + 26,
                                   False), 0.2, args.seed + 27)
        vds = VqaEvalDataset(VQA_ANSWERS, TxtTokDb(val[0], -1),
                             DetectFeatDb(val[1], 0.2, 100, 10, 36))
        cfg = VqaCollateConfig(fixed_batch=256)
        loader = DataLoader(vds, batch_size=256,
                            collate_fn=lambda items: vqa_collate(items, cfg))
        card = evaluate_vqa(model.to(DEVICE), loader, device=DEVICE)
        cpu = evaluate_vqa(model.to("cpu"), loader, device="cpu")
        same = sum(card["results"][q] == a for q, a in cpu["results"].items())
        row = dict(phase="vqa_eval_f32_card_vs_cpu", layers=2,
                   questions=cpu["n_ex"], acc_card=card["acc"],
                   acc_cpu=cpu["acc"], loss_card=card["loss"],
                   loss_cpu=cpu["loss"], answers_equal=same,
                   distinct_answers=len(set(cpu["results"].values())))
        emit(**row)
        check(card["results"] == cpu["results"]
              and card["acc"] == cpu["acc"],
              f"vqa evaluate_vqa, card vs cpu: {row}")
        del model
    rows, _ = hold_recorded("vqa", recorder.seen, device_name)
    return dict(counts=counts, rows=rows)


def prepro_phase(args, device_name):
    """The port's ``cli/prepro.py`` (host work) on ``PREPRO_IMAGES`` region
    files (10-100 regions of 2,048 float16 features, ``.npz`` as the
    reference's extractor writes them) and a COCO-style caption annotation
    JSON of ``PREPRO_CAPTIONS`` captions an image over a full-size
    synthetic WordPiece vocab (``synth_wordpiece_vocab``): the ``img`` and
    ``txt`` tasks, images/s and captions/s. Held: the port's readers give
    back every record (features, boxes at float16, the tokenized captions);
    then ``cli/eval_itm`` runs on the card over the prepared DBs for one
    pass (recall finite), to show that prepro's output feeds the card."""
    import json as _json

    from lightningdot_tpu_torch.cli import eval_itm, prepro
    from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
    from lightningdot_tpu_torch.data.synth import synth_wordpiece_vocab
    from lightningdot_tpu_torch.data.txt_db import TxtTokDb

    rng = np.random.default_rng(args.seed + 30)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "npz" / "coco_val2014"
        src.mkdir(parents=True)
        t0 = time.perf_counter()
        truth = {}
        for i in range(PREPRO_IMAGES):
            nbb = int(rng.integers(10, 101))
            xy = rng.random((nbb, 2), dtype=np.float32) * 0.5
            wh = rng.random((nbb, 2), dtype=np.float32) * 0.5
            name = f"coco_val2014_{i:012d}.npz"
            arrays = dict(
                features=rng.standard_normal((nbb, IMG_DIM),
                                             dtype=np.float32).astype(
                                                 np.float16),
                norm_bb=np.concatenate([xy, xy + wh, wh], axis=1),
                conf=np.full((nbb,), 0.7, np.float32))
            np.savez(src / name, **arrays)
            truth[name] = arrays
        vocab = Path(tmp) / "vocab.txt"
        roots, conts = synth_wordpiece_vocab(str(vocab), seed=args.seed)
        captions = []
        for i in range(PREPRO_IMAGES):
            for c in range(PREPRO_CAPTIONS):
                words = [roots[j] + (conts[k] if k % 3 == 0 else "")
                         for j, k in zip(
                             rng.integers(0, len(roots), 12),
                             rng.integers(0, len(conts), 12))]
                captions.append({"id": i * PREPRO_CAPTIONS + c,
                                 "image_id": i, "caption": " ".join(
                                     words[:int(rng.integers(5, 13))])})
        ann = Path(tmp) / "captions_val2014.json"
        ann.write_text(_json.dumps({"annotations": captions}))
        write_s = time.perf_counter() - t0

        out_img = Path(tmp) / "img"
        t = time.perf_counter()
        prepro.main(["img", "--img_dir", str(src), "--output", str(out_img)])
        img_s = time.perf_counter() - t
        txt_db = Path(tmp) / "txt_db"
        t = time.perf_counter()
        prepro.main(["txt", "--annotation", str(ann), "--output",
                     str(txt_db), "--format", "caption", "--split",
                     "val2014", "--vocab", str(vocab)])
        txt_s = time.perf_counter() - t

        img_dir = out_img / "coco_val2014"
        db = DetectFeatDb(str(img_dir), 0.2, 100, 10)
        img_ok = all(
            np.array_equal(db[name][0], arr["features"])
            and np.array_equal(db[name][1], arr["norm_bb"].astype(
                np.float16)) for name, arr in truth.items())
        tok = prepro.get_tokenizer("bert-base-cased", str(vocab))
        txt = TxtTokDb(str(txt_db), -1)
        txt_ok = sorted(txt.ids, key=int) == [str(c["id"])
                                              for c in captions] and all(
            txt[str(c["id"])]["input_ids"]
            == prepro.bert_tokenize(tok, c["caption"])[0]
            and txt[str(c["id"])]["img_fname"]
            == f"coco_val2014_{c['image_id']:012d}.npz" for c in captions)
        row = dict(phase="prepro", images=PREPRO_IMAGES,
                   captions=len(captions), write_inputs_s=write_s,
                   img_s=img_s, images_per_s=PREPRO_IMAGES / img_s,
                   txt_s=txt_s, captions_per_s=len(captions) / txt_s,
                   native_tokenizer=tok.native, img_records_equal=img_ok,
                   txt_records_equal=txt_ok, device=device_name,
                   note="host work: the card is not used")
        emit(**row)
        check(img_ok and txt_ok, f"prepro: a record did not come back: "
                                 f"{row}")
        t = time.perf_counter()
        got = eval_itm.main([
            "--config", EVAL_CONFIG, "--itm_global_file", "",
            "--test_txt_db", str(txt_db), "--test_img_db", str(img_dir),
            "--valid_batch_size", "256", "--device", DEVICE])["test"]
        recalls = list(got["recall_txt"].values()) + list(
            got["recall_img"].values())
        emit(phase="prepro_eval_itm", seconds=time.perf_counter() - t,
             recall_txt=got["recall_txt"], recall_img=got["recall_img"],
             loss=got["loss"])
        check(all(np.isfinite(recalls)) and np.isfinite(got["loss"]),
              f"prepro: eval_itm over the prepared DBs: {got}")


# ---------------------------------------------------------------------------
# dist (ROADMAP A11): two ranks on the one card over gloo, the driver under
# torch.distributed.run, NCCL at world 1, the corpus over a DeviceMesh
# ---------------------------------------------------------------------------

# rows per rank (the global batch is 64, coco_ft.json's), the held steps,
# and more bf16 steps for timing only. Two held steps: the second runs on
# the weights the first updated, so every bound reads a step after an
# update, and the ranks keep the whole run well inside its 1,200 s limit
DIST_LOCAL_BATCH = 32
DIST_STEPS = 2
DIST_TIMED_STEPS = 3
# float32 with TF32 off, two ranks against one process on the global
# batch: each step's loss, and the final weights (relative L2 per leaf,
# against the leaf's own norm): the bounds of the driver's parity with
# the JAX driver (tests/test_torch_train_itm_cli.py)
DIST_LOSS_RTOL = 1e-5
DIST_LEAF_RTOL = 1e-4
# the held steps run at coco_ft.json's peak learning rate without warmup,
# so that an AdamW step moves every element that has a gradient by ~lr
# (2e-5; ~1e-3 of a leaf's norm a step). Beside the bounds above, the
# whole model's difference from one process over the update one process
# made (||W_ranks - W_one|| / ||W_one - W_0||, every leaf in one norm):
# a no-op or a wrong update reads ~1 there
DIST_LR = 2e-5
DIST_UPDATE_RTOL = 1e-3
# (name, dtype, hard negatives per item)
DIST_VARIANTS = (("f32", "float32", 0), ("f32_hn", "float32", 1),
                 ("bf16", "bfloat16", 0))
# a planted fault that the float32 bounds must refuse, run by the same
# ranks: the row gather's backward without its all-reduce (each rank
# keeps only its own queries' gradient of its rows; the parameter
# gradients are still summed, so the ranks stay bit-equal)
DIST_FAULT = ("f32_fault", "float32", 0)
# KD and VQA across the ranks (ROADMAP A13, A14), DIST_STEPS steps each
# on the same rows as the ITM variants, against one process on the global
# batch: KD's UNITER-base teacher (TEACHER_CONFIG) in float32, its T, the
# term's weight and n_teacher (min(10, 64): rank 0's first rows); the VQA
# head (VQA_ANSWERS answers) at DIST_VQA_LR_MUL the learning rate, plain
# (its LayerNorm 3,072 wide) and with the intersection (6,144). (name,
# dtype[, intersection])
DIST_KD_T = 2.0
DIST_KD_WEIGHT = 1.0
DIST_KD_TEACHERS = 10
DIST_KD_VARIANTS = (("kd_f32", "float32"), ("kd_bf16", "bfloat16"))
DIST_VQA_VARIANTS = (("vqa_f32", "float32", False),
                     ("vqa_bf16", "bfloat16", False),
                     ("vqa_bf16_x", "bfloat16", True))
DIST_VQA_LR_MUL = 10.0
# the planted faults that the float32 bounds must refuse: every rank
# differentiates the whole KD term (the step's 1/W share undone), and the
# VQA step without its gradient all-reduce
DIST_KD_FAULT = ("kd_fault", "float32")
DIST_VQA_FAULT = ("vqa_fault", "float32", False)
# the driver under torch.distributed.run: train and val split images (x 5
# captions, or VQA questions), one epoch
DIST_DRIVER_IMAGES = (64, 16)
# the sharded corpus: two shards on the one card; the index check's corpus
# and k (k wider than a shard of 256 rows)
DIST_INDEX_ROWS = 500
DIST_INDEX_K = 300
DIST_WORKER_TIMEOUT = 600
# the keys of the driver's results JSON that hold seconds: they differ
# from rank to rank; every other key must agree
DIST_TIMING_KEYS = ("init_mine_s", "train_s", "eval_s", "mine_s")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _dist_master(seed):
    """coco_ft.json's towers at full width (dropout 0), random weights from
    ``seed`` with noise of 0.02 on every leaf, so that no leaf starts at
    zero: an Adam step on a leaf whose exact gradient is 0 (the attention
    key biases) is rounding noise, and a zero leaf would be all noise."""
    from lightningdot_tpu_torch.models import BiEncoder, init_tower_

    master = BiEncoder(*train_configs(0.0))
    gen = torch.Generator().manual_seed(seed)
    init_tower_(master.txt_model, gen)
    init_tower_(master.img_model, gen)
    return perturb_(master, 0.02, seed + 1).state_dict()


def _dist_batches(seed, negs):
    """DIST_STEPS global batches of 2 x DIST_LOCAL_BATCH items (the batch
    one process's collate makes: all positives, then all negatives), and
    each rank's part of each."""
    from lightningdot_tpu_torch.data.itm import (CollateConfig,
                                                 itm_fast_collate)

    n = 2 * DIST_LOCAL_BATCH
    data = SynthImages(DIST_STEPS * n * (1 + negs), NUM_BB, seed, "dist")
    glob, local = [], [[], []]
    for s in range(DIST_STEPS):
        rows = n * (1 + negs)
        b = itm_fast_collate([data[i] for i in range(s * rows,
                                                     (s + 1) * rows)],
                             CollateConfig(fixed_batch=rows))

        def take(idx):
            return {"txts": {k: v[idx] for k, v in b["txts"].items()},
                    "imgs": {k: v[idx] for k, v in b["imgs"].items()},
                    "caps": None,
                    "valid_mask": np.ones((len(idx) // (1 + negs),),
                                          np.float32)}

        glob.append(take(np.arange(rows)))
        for r in range(2):
            pos = np.arange(r * DIST_LOCAL_BATCH, (r + 1) * DIST_LOCAL_BATCH)
            local[r].append(take(np.concatenate(
                [pos] + [n + pos] * negs)))
    return glob, local


def _dist_step(state, dtype, negs, device, dropout=0.0, **step_kw):
    """coco_ft.json's step (clip 2.0, AdamW, the linear schedule from lr
    DIST_LR without warmup) on a model holding ``state``; ``step_kw`` go
    to ``make_itm_train_step`` (KD's ``kd_fn``)."""
    from lightningdot_tpu_torch.models import BiEncoder
    from lightningdot_tpu_torch.training.itm_step import make_itm_train_step
    from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                       schedule_linear)

    model = BiEncoder(*train_configs(dropout),
                      compute_dtype=getattr(torch, dtype))
    model.load_state_dict(state)
    model.train()
    step = make_itm_train_step(model, make_optimizer(
        model, schedule_linear(DIST_LR, 0, 1000), max_grad_norm=2.0),
        num_hard_negatives=negs, device=device, **step_kw)
    return model, step


def _timed_steps(step, batches, gen_of, kd_losses=None):
    """Each step's loss and wall time (the card synchronized around it);
    ``kd_losses`` collects the KD term where the step has one."""
    losses, lat = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(b, gen_of(i))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        if kd_losses is not None:
            kd_losses.append(float(m["kd_loss"]))
    return losses, lat


def _dist_kd_fn(teacher, fault=False):
    """KD's term at DIST_KD_T over DIST_KD_TEACHERS images; ``fault``: the
    DIST_KD_FAULT, every rank differentiating the whole term (the step
    adds 1/W of what it is handed)."""
    from lightningdot_tpu_torch.training.itm_step import make_kd_fn

    kd_fn = make_kd_fn(teacher, T=DIST_KD_T, n_teacher=DIST_KD_TEACHERS)
    if not fault:
        return kd_fn
    return lambda batch, embs: (kd_fn(batch, embs)
                                * torch.distributed.get_world_size())


def _dist_kd_batches(seed):
    """The ITM variants' global batches with the one-process teacher grid,
    as the one-process driver stages it (the ranks take ``_dist_batches``'
    parts: their step builds their blocks)."""
    from lightningdot_tpu_torch.data.itm import make_teacher_batch

    n = 2 * DIST_LOCAL_BATCH
    return [dict(b, sample_size=n, teacher=make_teacher_batch(
        dict(b, sample_size=n), DIST_KD_TEACHERS))
        for b in _dist_batches(seed, 0)[0]]


def _dist_vqa_batches(seed):
    """The ITM variants' rows as VQA batches: soft targets of 1-3 of the
    VQA_ANSWERS answers a question (scores 1/3, 2/3 or 1, as
    ``make_synth_dataset`` draws them); global and each rank's part."""
    glob, local = _dist_batches(seed, 0)
    rng = np.random.default_rng(seed + 7)
    n = 2 * DIST_LOCAL_BATCH
    for s, b in enumerate(glob):
        t = np.zeros((n, VQA_ANSWERS), np.float32)
        for i in range(n):
            k = int(rng.integers(1, 4))
            t[i, rng.choice(VQA_ANSWERS, k, replace=False)] = \
                rng.integers(1, 4, k) / 3.0
        b["targets"] = t
        for r in range(2):
            local[r][s]["targets"] = t[r * DIST_LOCAL_BATCH:
                                       (r + 1) * DIST_LOCAL_BATCH]
    return glob, local


_DIST_VQA_MASTERS: dict = {}


def _dist_vqa_master(state, seed, intersection):
    """The VQA model over the ITM variants' towers (``state``), its head
    drawn from ``seed`` (``init_vqa_head_``) with noise of 0.02 (no leaf
    starts at zero, as ``_dist_master``), on the CPU: the same weights in
    every process. Kept for the process's later variants."""
    from lightningdot_tpu_torch.models import BiEncoder
    from lightningdot_tpu_torch.models.vqa import (BiEncoderForVQA,
                                                   init_vqa_head_)

    key = (seed, intersection)
    if key not in _DIST_VQA_MASTERS:
        bi = BiEncoder(*train_configs(0.0))
        bi.load_state_dict(state)
        model = BiEncoderForVQA(bi, bi.txt_cfg.out_size, VQA_ANSWERS,
                                intersection=intersection)
        init_vqa_head_(model, torch.Generator().manual_seed(seed))
        perturb_(model.vqa_output, 0.02, seed + 1)
        _DIST_VQA_MASTERS[key] = model
    return _DIST_VQA_MASTERS[key]


def _dist_vqa_step(state, seed, dtype, intersection, device):
    """The VQA driver's optimizer (UNITER's betas, eps and decay, clip 2.0,
    the head at DIST_VQA_LR_MUL the learning rate DIST_LR) and step on a
    copy of the master weights (``_dist_vqa_master``)."""
    import copy

    from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                       schedule_linear)
    from lightningdot_tpu_torch.training.vqa_step import make_vqa_train_step

    model = copy.deepcopy(_dist_vqa_master(state, seed, intersection))
    model.biencoder.compute_dtype = getattr(torch, dtype)
    model.train()
    opt = make_optimizer(model, schedule_linear(DIST_LR, 0, 1000),
                         betas=(0.9, 0.98), adam_eps=1e-6, weight_decay=0.01,
                         max_grad_norm=2.0, first_lr_step=1,
                         lr_mul={"vqa_output.": DIST_VQA_LR_MUL})
    return model, make_vqa_train_step(model, opt, device=device)


class _CollectiveClock:
    """Host-clock time of each collective (the card synchronized before
    and after), by kind: the gradient all-reduce (the flat buffers), the
    row gathers' all-reduce in the backward, and the all-gathers (rows,
    valid masks, metrics)."""

    def __init__(self, grad_numel):
        self.grad_numel = grad_numel
        self.ms = {}
        self._real = {}

    def _wrap(self, name, fn):
        def timed(tensor_or_list, *a, **k):
            t = tensor_or_list if name == "all_reduce" else a[0]
            kind = name
            if name == "all_reduce":
                kind = ("grad_all_reduce" if t.numel() >= self.grad_numel
                        else "gather_backward_all_reduce")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tensor_or_list, *a, **k)
            torch.cuda.synchronize()
            ms, n = self.ms.get(kind, (0.0, 0))
            self.ms[kind] = (ms + (time.perf_counter() - t0) * 1e3, n + 1)
            return out
        return timed

    def __enter__(self):
        dist = torch.distributed
        for name in ("all_reduce", "all_gather"):
            self._real[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(name, self._real[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(torch.distributed, name, fn)


def dist_worker(cfg):
    """One rank of the ``steps`` scenario (``dist_phase``): every variant's
    DIST_STEPS steps on this rank's part of the global batches, the
    launch counts, losses, step times and a weight digest (the DIST_FAULT
    variant with the gather's backward broken); rank 0 saves the float32
    variants' weights; then DIST_TIMED_STEPS more bf16 steps and one more
    step under the profiler and the collective clock, at coco_ft.json's
    dropout 0.1 (each rank's masks keyed on its rank). Rank 0 records the
    bf16 shapes at which its steps call the kernels (``ShapeRecorder``).
    The ``nccl1`` scenario: the bf16 steps without a group, again without
    one (the control), and in an NCCL group of one, bit for bit."""
    from lightningdot_tpu_torch.ops import _build, launch_counts, \
        reset_launch_counts
    from lightningdot_tpu_torch.parallel import mesh
    from lightningdot_tpu_torch.parallel.mesh import initialize_distributed
    from lightningdot_tpu_torch.utils.misc import state_digest
    from lightningdot_tpu_torch.utils.runtime import step_generator

    rank, world = cfg["rank"], cfg["world"]
    device = torch.device(DEVICE, cfg["device_index"])
    torch.cuda.set_device(device)
    _build.lib()
    state = torch.load(cfg["master"])
    out = {}
    if cfg["scenario"] == "nccl1":
        glob, _ = _dist_batches(cfg["seed"], 0)
        runs = {}
        for run in ("no_group", "no_group_again", "nccl_world_1"):
            if run == "nccl_world_1":
                initialize_distributed(
                    "nccl", init_method=f"tcp://127.0.0.1:{cfg['port']}",
                    world_size=1, rank=0)
            model, step = _dist_step(state, "bfloat16", 0, device)
            losses, _ = _timed_steps(step, glob, lambda i: None)
            runs[run] = (losses, {k: v.detach().cpu() for k, v in
                                  model.state_dict().items()})
            del model, step
        base_l, base_w = runs["no_group"]
        for run in ("no_group_again", "nccl_world_1"):
            losses, w = runs[run]
            out[run] = dict(losses=losses, losses_equal=losses == base_l,
                            weights_equal=all(torch.equal(w[k], v)
                                              for k, v in base_w.items()))
        out["backend"] = torch.distributed.get_backend()
        torch.distributed.destroy_process_group()
        print("DIST " + json.dumps(out), flush=True)
        return 0

    initialize_distributed(cfg["backend"],
                           init_method=f"tcp://127.0.0.1:{cfg['port']}",
                           world_size=world, rank=rank)
    recorder = ShapeRecorder()

    def broken_backward(real):
        return staticmethod(
            lambda ctx, g: g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows])

    for name, dtype, negs in cfg["variants"]:
        _, local = _dist_batches(cfg["seed"], negs)
        model, step = _dist_step(state, dtype, negs, device)
        reset_launch_counts()
        with (_patched(mesh._GatherRows, "backward", broken_backward)
              if name == DIST_FAULT[0] else contextlib.nullcontext()), \
                (recorder if rank == 0 and dtype == "bfloat16"
                 else contextlib.nullcontext()):
            losses, lat = _timed_steps(step, local[rank], lambda i: None)
        counts = launch_counts()
        row = dict(losses=losses, ms=lat, counts=counts,
                   digest=state_digest(model), device=str(device),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        if rank == 0 and dtype == "float32":
            torch.save({k: v.detach().cpu() for k, v in
                        model.state_dict().items()},
                       os.path.join(cfg["workdir"], f"{name}.pt"))
        if dtype == "bfloat16":
            del model, step
            model, step = _dist_step(state, dtype, negs, device, 0.1)

            def gen(i):
                return step_generator(cfg["seed"], i, rank)

            reset_launch_counts()
            with recorder if rank == 0 else contextlib.nullcontext():
                _, row["timed_ms"] = _timed_steps(
                    step, (local[rank] * 2)[:DIST_TIMED_STEPS], gen)
            row["timed_counts"] = launch_counts()
            # the gradient buffers are the only collectives this large
            clock = _CollectiveClock(
                sum(p.numel() for p in model.parameters()) // 4)
            with clock:
                step(local[rank][0], gen(DIST_TIMED_STEPS))
            row["collective_ms"] = clock.ms
            from torch.profiler import profile
            with profile(activities=_profile_activities()) as prof:
                step(local[rank][0], gen(DIST_TIMED_STEPS + 1))
                torch.cuda.synchronize()
            row["profile_collectives"] = sorted(
                ([e.key, e.cpu_time_total / 1e3, e.count]
                 for e in prof.key_averages()
                 if any(w in e.key.lower() for w in (
                     "all_reduce", "allreduce", "all_gather", "allgather",
                     "gloo", "nccl"))),
                key=lambda r: -r[1])[:8]
            row["profile"] = _device_stats(prof, 1)
        out[name] = row
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    if cfg.get("teacher_dir"):
        out.update(_dist_kd_vqa_ranks(cfg, state, device, recorder))
    out["shapes"] = sorted(recorder.seen, key=str)
    torch.distributed.destroy_process_group()
    print("DIST " + json.dumps(out), flush=True)
    return 0


def _dist_kd_vqa_ranks(cfg, state, device, recorder):
    """One rank's KD and VQA variants (``dist_worker``), DIST_STEPS steps
    each on this rank's rows at dropout 0: the losses (and KD's term),
    step times, launch counts and a weight digest; rank 0 saves the
    float32 variants' weights and records the shapes of the bf16 ones (the
    float32 teacher's grid among them). The planted faults run on the
    same ranks."""
    from lightningdot_tpu_torch.models.factory import load_cross_encoder
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training import vqa_step
    from lightningdot_tpu_torch.utils.misc import state_digest

    rank = cfg["rank"]
    out = {}

    def run(name, dtype, model, step, batches, fault, kd):
        reset_launch_counts()
        kd_losses = [] if kd else None
        with fault, (recorder if rank == 0 and dtype == "bfloat16"
                     else contextlib.nullcontext()):
            losses, lat = _timed_steps(step, batches, lambda i: None,
                                       kd_losses)
        out[name] = dict(losses=losses, kd_losses=kd_losses, ms=lat,
                         counts=launch_counts(), digest=state_digest(model),
                         device=str(device),
                         peak_mem_gb=torch.cuda.max_memory_allocated()
                         / 2 ** 30)
        if rank == 0 and dtype == "float32":
            torch.save({k: v.detach().cpu() for k, v in
                        model.state_dict().items()},
                       os.path.join(cfg["workdir"], f"{name}.pt"))

    teacher = load_cross_encoder(cfg["teacher_dir"],
                                 compute_dtype=torch.float32, device=device)
    _, local = _dist_batches(cfg["seed"], 0)
    for name, dtype in DIST_KD_VARIANTS + (DIST_KD_FAULT,):
        model, step = _dist_step(
            state, dtype, 0, device, kd_fn=_dist_kd_fn(
                teacher, fault=name == DIST_KD_FAULT[0]),
            kd_loss_weight=DIST_KD_WEIGHT)
        run(name, dtype, model, step, local[rank],
            contextlib.nullcontext(), kd=True)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    del teacher
    _, local = _dist_vqa_batches(cfg["seed"])
    for name, dtype, intersection in DIST_VQA_VARIANTS + (DIST_VQA_FAULT,):
        model, step = _dist_vqa_step(state, cfg["seed"], dtype,
                                     intersection, device)
        fault = (_patched(vqa_step, "all_reduce_grads_",
                          lambda real: lambda params: None)
                 if name == DIST_VQA_FAULT[0] else contextlib.nullcontext())
        run(name, dtype, model, step, local[rank], fault, kd=False)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    _DIST_VQA_MASTERS.clear()
    return out


def _start_dist(cfgs):
    """One ``chip_smoke.py --dist_worker`` process per config, all started
    together."""
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist_worker",
         json.dumps(c)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for c in cfgs]


def _collect_dist(procs, timeout=DIST_WORKER_TIMEOUT):
    """Wait for every worker of ``_start_dist``; each one's DIST result."""
    outs = [""] * len(procs)
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=timeout)[0]
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                outs[i] += p.communicate()[0]
    results = []
    for p, o in zip(procs, outs):
        check(p.returncode == 0, f"dist worker failed (rc {p.returncode}):"
              f"\n{o[-4000:]}")
        lines = [ln for ln in o.splitlines() if ln.startswith("DIST ")]
        check(len(lines) == 1, f"dist worker printed no result:\n{o[-4000:]}")
        results.append(json.loads(lines[0][len("DIST "):]))
    return results


def _dist_leaf_rel_l2(got, want):
    """Worst relative L2 over the leaves, each against its own norm (the
    driver parity test's measure)."""
    return max(float((got[k].double() - w.double()).norm())
               / max(float(w.double().norm()), 1e-12)
               for k, w in want.items())


def _dist_drivers(args, workdir, teacher_dir, device_name):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    lightningdot_tpu_torch.cli.<driver> ... --device cuda:0 --dist_backend
    gloo`` over synthetic DBs, one epoch, the three drivers at once:
    ``train_itm``, ``train_itm --teacher_checkpoint`` (KD across the ranks)
    and ``train_vqa`` (3,129 answers, the head at 10x the learning rate).
    Each writes exactly one set of checkpoints (rank 0's), and both ranks
    print the same results JSON, seconds aside."""
    from lightningdot_tpu_torch.data.synth import make_synth_dataset

    n_train, n_val = DIST_DRIVER_IMAGES
    train = write_eval_dbs(workdir / "train", n_train, 5, args.seed + 31)
    val = write_eval_dbs(workdir / "val", n_val, 5, args.seed + 32)
    synth = dict(txts_per_img=5, img_dim=IMG_DIM, min_bb=10, max_bb=100,
                 max_txt_len=23, vqa_answers=VQA_ANSWERS)
    vqa_train = make_synth_dataset(str(workdir / "vqa_train"),
                                   n_imgs=n_train, seed=args.seed + 35,
                                   **synth)
    vqa_val = make_synth_dataset(str(workdir / "vqa_val"), n_imgs=n_val,
                                 seed=args.seed + 36, **synth)
    itm = ["--config", FT_CONFIG, "--itm_global_file", "",
           "--img_checkpoint", "none", "--seed", str(args.seed),
           "--train_txt_dbs", train[0], "--train_img_dbs", train[1],
           "--val_txt_db", val[0], "--val_img_db", val[1],
           "--test_txt_db", "", "--num_train_epochs", "1"]
    runs = {
        "train_itm": ("train_itm", itm, "biencoder.", "best_val_recall_mean"),
        "train_itm_kd": ("train_itm", itm + [
            "--teacher_checkpoint", teacher_dir, "--T", "2.0",
            "--kd_loss_weight", "0.5"], "biencoder.",
            "best_val_recall_mean"),
        "train_vqa": ("train_vqa", [
            "--config", FT_CONFIG, "--img_checkpoint", "none", "--seed",
            str(args.seed), "--train_txt_dbs", vqa_train[0],
            "--train_img_dbs", vqa_train[1], "--val_txt_db", vqa_val[0],
            "--val_img_db", vqa_val[1], "--num_answers", str(VQA_ANSWERS),
            "--vqa_lr_mul", "10", "--num_train_epochs", "1"], "vqa.",
            "best_val_acc")}
    procs = {}
    t = time.perf_counter()
    for name, (module, cli, _, _) in runs.items():
        out = workdir / name
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "2", "--master_port", str(_free_port()),
             "-m", f"lightningdot_tpu_torch.cli.{module}"] + cli + [
                "--output_dir", str(out), "--device", DEVICE + ":0",
                "--dist_backend", "gloo"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=DIST_WORKER_TIMEOUT)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    seconds = time.perf_counter() - t

    def strip(r):
        return {k: ([strip(e) for e in v] if k == "epochs" else v)
                for k, v in r.items() if k not in DIST_TIMING_KEYS}

    for name, (module, _, prefix, first_key) in runs.items():
        stdout, stderr = outs[name]
        proc = procs[name]
        check(proc.returncode == 0, f"torch.distributed.run {name} failed "
              f"(rc {proc.returncode}):\n{stdout[-2000:]}\n"
              f"{stderr[-4000:]}")
        # each rank prints its results JSON last, into one pipe: two lines
        # may run together, so each object is decoded where it starts
        decoder = json.JSONDecoder()
        results = [decoder.raw_decode(stdout, m.start())[0] for m in
                   re.finditer(r'\{"' + first_key + '"', stdout)]
        out = workdir / name
        files = sorted(os.listdir(out))
        written = sorted(f for f in files if f.startswith(prefix))
        row = dict(phase="dist_driver", driver=name, ranks=2,
                   backend="gloo", device=DEVICE + ":0",
                   cli_seconds_all_three=seconds, results=len(results),
                   same_results=len(results) == 2
                   and strip(results[0]) == strip(results[1]),
                   result=strip(results[0]) if results else None,
                   written=written, temporaries=[f for f in files
                                                 if f.endswith(".tmp")],
                   train_images=n_train, val_images=n_val,
                   nvidia_smi=smi_line(), card=device_name)
        if "epochs" in (results[0] if results else {}):
            row["steps_per_rank"] = [e["steps"] for e in results[0]["epochs"]]
        emit(**row)
        check(row["same_results"], f"dist driver {name}: the ranks' results "
              f"differ or are missing: {results}\n{stdout[-3000:]}\n"
              f"{stderr[-3000:]}")
        check(written == [f"{prefix}{w}.{e}" for w in ("best", "last")
                          for e in ("json", "pt")]
              and not row["temporaries"],
              f"dist driver {name}: not one writer: {row}")


def _dist_corpus(args, tok, device_name):
    """The corpus over ``DeviceMesh([cuda:0, cuda:0])``: the bf16 and the
    int8 Retriever (int8 tower and corpus) rank the queries as the
    unsharded ones do, and ``DenseShardedIndex`` as ``DenseFlatIndex``
    with k wider than a shard; ties within EVAL_TIE_RTOL of the peak
    score may swap."""
    from lightningdot_tpu_torch.index import DenseFlatIndex, DenseShardedIndex
    from lightningdot_tpu_torch.models import BiEncoder, init_tower_
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.parallel.mesh import DeviceMesh
    from lightningdot_tpu_torch.serving import Retriever

    mesh = DeviceMesh([DEVICE + ":0", DEVICE + ":0"])
    cfg = train_configs(0.0)[0]
    model = BiEncoder(cfg, compute_dtype=torch.bfloat16)
    init_tower_(model.txt_model, torch.Generator().manual_seed(args.seed + 33))
    rng = np.random.default_rng(args.seed + 33)
    corpus = rng.standard_normal((CORPUS_SIZE, cfg.out_size),
                                 dtype=np.float32)
    ids = [f"coco_{i:06d}" for i in range(CORPUS_SIZE)]
    counts = {}
    for quant, wq in ((None, None), ("int8", "int8")):
        kw = dict(quantization=quant, weight_quantization=wq)
        plain = Retriever(model, tok, device=DEVICE, **kw)
        plain.set_corpus(ids, corpus)
        want = rankings(plain, CAPTIONS)
        del plain
        sharded = Retriever(model, tok, device=DEVICE, mesh=mesh, **kw)
        sharded.set_corpus(ids, corpus)
        reset_launch_counts()
        got = rankings(sharded, CAPTIONS)
        counts[quant or "bf16"] = launch_counts()
        atol = hold_rankings(got, want, EVAL_TIE_RTOL,
                             f"dist sharded Retriever {quant or 'bf16'}")
        emit(phase="dist_sharded_retriever", corpus=quant or "bf16",
             tower=wq or "bf16", shards=[str(d) for d in mesh],
             shard_rows=[int(c.shape[0]) for c in sharded._corpus],
             queries=len(CAPTIONS), top=TOP, tie_atol=atol,
             ids_equal=[[i for i, _ in g] == [i for i, _ in w]
                        for g, w in zip(got, want)], device=device_name)
        del sharded
    hold_path("dist_sharded_bf16", counts["bf16"])
    hold_path("dist_sharded_int8", counts["int8"])
    vecs = rng.standard_normal((DIST_INDEX_ROWS, cfg.out_size),
                               dtype=np.float32)
    data = [(f"v{i}", v) for i, v in enumerate(vecs)]
    q = rng.standard_normal((16, cfg.out_size), dtype=np.float32)
    flat = DenseFlatIndex(cfg.out_size, device=DEVICE)
    flat.index_data(data)
    shard = DenseShardedIndex(cfg.out_size, mesh)
    shard.index_data(data)
    got = [list(zip(i, map(float, s))) for i, s in
           shard.search_knn(q, DIST_INDEX_K)]
    want = [list(zip(i, map(float, s))) for i, s in
            flat.search_knn(q, DIST_INDEX_K)]
    atol = hold_rankings(got, want, EVAL_TIE_RTOL, "dist DenseShardedIndex")
    emit(phase="dist_sharded_index", rows=DIST_INDEX_ROWS, k=DIST_INDEX_K,
         shard_rows=[int(c.shape[0]) for c, _ in shard._corpus],
         tie_atol=atol, ids_equal=[[i for i, _ in g] == [i for i, _ in w]
                                   for g, w in zip(got, want)].count(True),
         queries=len(q))
    return counts


def _dist_one_process(state, seed):
    """One process on each variant's global batches: the losses, the
    float32 variants' final weights, and the bf16 step's time at dropout
    0.1 (DIST_TIMED_STEPS steps); for the plain float32 variant also the
    control of the bf16 bounds, the same steps of the float32 model with
    its weights and layer outputs rounded to PRE_CONTROL_MANTISSA_BITS
    mantissa bits (``_coarse``)."""
    from lightningdot_tpu_torch.utils.runtime import step_generator

    one = {}
    for name, dtype, negs in DIST_VARIANTS:
        glob, _ = _dist_batches(seed, negs)
        model, step = _dist_step(state, dtype, negs, DEVICE)
        row = dict(losses=_timed_steps(step, glob, lambda i: None)[0])
        if dtype == "bfloat16":
            del model, step
            model, step = _dist_step(state, dtype, negs, DEVICE, 0.1)
            row["timed_ms"] = _timed_steps(
                step, (glob * 2)[:DIST_TIMED_STEPS],
                lambda i: step_generator(seed, i))[1]
        else:
            row["weights"] = {k: v.detach().cpu() for k, v in
                              model.state_dict().items()}
        if name == "f32":
            del model, step
            model, step = _dist_step(state, dtype, negs, DEVICE)
            with _coarse(model, PRE_CONTROL_MANTISSA_BITS):
                row["coarse_losses"] = _timed_steps(step, glob,
                                                    lambda i: None)[0]
        one[name] = row
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    return one


def _update_rel(got, want, master):
    """||got - want|| / ||want - master|| over every leaf in one norm, and
    the update's own size ||want - master|| / ||master||."""
    diff = upd = base = 0.0
    for k, w in want.items():
        w, m = w.double(), master[k].double()
        diff += float((got[k].double() - w).norm()) ** 2
        upd += float((w - m).norm()) ** 2
        base += float(m.norm()) ** 2
    return math.sqrt(diff / upd), math.sqrt(upd / base)


def _rel_per_step(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _hold_dist_ranks(ranks, one, master, workdir, backend, what, smi,
                     device_name):
    """Two ranks' variants against one process (``_dist_one_process``):
    the ranks' losses and weights equal to each other; float32 within
    DIST_LOSS_RTOL per step, DIST_LEAF_RTOL per leaf and DIST_UPDATE_RTOL
    of the update from ``master``, where the DIST_FAULT variant must fail;
    bf16 at every step within TRAIN_BF16_LOSS_RTOL of one process's bf16
    and float32, where the control (float32 at PRE_CONTROL_MANTISSA_BITS
    bits) must fail; each path's launches; then the bf16 step's time
    against one process's, the collectives' times and a profile row.
    Returns rank 0's bf16 row."""
    for name, dtype, negs in DIST_VARIANTS + (DIST_FAULT,):
        r0, r1 = ranks[0][name], ranks[1][name]
        fault = name == DIST_FAULT[0]
        o = one["f32" if fault else name]
        row = dict(phase="dist_ranks_vs_one_process", backend=backend,
                   devices=[r0["device"], r1["device"]], variant=name,
                   dtype=dtype, hard_negatives=negs, lr=DIST_LR,
                   losses_ranks=[r0["losses"], r1["losses"]],
                   losses_one_process=o["losses"],
                   losses_equal_across_ranks=r0["losses"] == r1["losses"],
                   weights_bit_equal_across_ranks=r0["digest"]
                   == r1["digest"], loss_rel=_rel_per_step(r0["losses"],
                                                           o["losses"]),
                   peak_mem_gb=[r0["peak_mem_gb"], r1["peak_mem_gb"]])
        check(row["losses_equal_across_ranks"]
              and row["weights_bit_equal_across_ranks"],
              f"dist {backend} {name}: the ranks disagree: {row}")
        if dtype == "float32":
            got = torch.load(os.path.join(workdir, f"{name}.pt"))
            upd_rel, upd_size = _update_rel(got, o["weights"], master)
            row.update(loss_rel_max=DIST_LOSS_RTOL,
                       leaf_rel_l2=_dist_leaf_rel_l2(got, o["weights"]),
                       leaf_rel_l2_max=DIST_LEAF_RTOL,
                       update_rel_l2=upd_rel,
                       update_rel_l2_max=DIST_UPDATE_RTOL,
                       update_size_rel_l2=upd_size,
                       update_size_worst_leaf=_dist_leaf_rel_l2(
                           master, o["weights"]))
            held = (row["loss_rel"] <= DIST_LOSS_RTOL
                    and row["leaf_rel_l2"] <= DIST_LEAF_RTOL
                    and upd_rel <= DIST_UPDATE_RTOL)
            if fault:
                row["control"] = ("planted fault: the gather's backward "
                                  "without its all-reduce; must fail")
            emit(**row)
            if fault:
                check(not held, f"dist {backend}: the planted fault passed "
                      f"the float32 bounds, which cannot see it: {row}")
                continue
            check(held, f"dist {backend} {name}: two ranks vs one process: "
                  f"{row}")
            hold_path("dist_f32", r0["counts"])
            continue
        # bf16 at every step against one process's bf16 and float32 (the
        # same weights and batches), beside the control
        f32_one = one["f32"]["losses"]
        row.update(
            bf16_vs_one_process_bf16_rel=row.pop("loss_rel"),
            bf16_vs_f32_rel=_rel_per_step(r0["losses"], f32_one),
            bf16_vs_f32_rel_max=TRAIN_BF16_LOSS_RTOL,
            one_process_bf16_vs_f32_rel=_rel_per_step(o["losses"], f32_one),
            control=f"one process, float32 rounded to "
                    f"{PRE_CONTROL_MANTISSA_BITS} mantissa bits; must fail",
            control_vs_f32_rel=_rel_per_step(one["f32"]["coarse_losses"],
                                             f32_one))
        emit(**row)
        check(row["bf16_vs_one_process_bf16_rel"] <= TRAIN_BF16_LOSS_RTOL
              and row["bf16_vs_f32_rel"] <= TRAIN_BF16_LOSS_RTOL,
              f"dist {backend} bf16: {row}")
        check(row["control_vs_f32_rel"] > TRAIN_BF16_LOSS_RTOL,
              f"dist {backend} bf16: the control passed the bound, which "
              f"cannot tell bf16 from it: {row}")
        hold_path("dist", r0["timed_counts"])
        bf16 = r0
    ms2 = statistics.median(bf16["timed_ms"])
    ms1 = statistics.median(one["bf16"]["timed_ms"])
    emit(phase="dist_step_time", backend=backend, dtype="bfloat16",
         global_batch=2 * DIST_LOCAL_BATCH, what=what,
         ms_per_step_two_ranks_p50=ms2, ms_per_step_one_process_p50=ms1,
         ratio=ms2 / ms1, timed_steps=DIST_TIMED_STEPS,
         collective_ms_one_step=bf16["collective_ms"],
         profile_collectives=bf16["profile_collectives"],
         nvidia_smi=smi, card=device_name)
    emit_profile_stats("dist", 2 * DIST_LOCAL_BATCH, bf16["profile"], ms2,
                       rank=0, backend=backend)
    return bf16


def _dist_kd_vqa_one_process(state, seed, teacher_dir):
    """One process on the KD and VQA variants' global batches (the KD grid
    built on the host, as the one-process driver stages it): the losses
    (and KD's term), step times and the float32 variants' final weights;
    VQA also in float32 with the intersection head (the bf16 bound's
    float32 reference) and its master weights."""
    from lightningdot_tpu_torch.models.factory import load_cross_encoder

    teacher = load_cross_encoder(teacher_dir, compute_dtype=torch.float32,
                                 device=DEVICE)
    one = {}

    def run(name, dtype, model, step, batches, kd):
        kd_losses = [] if kd else None
        losses, lat = _timed_steps(step, batches, lambda i: None, kd_losses)
        one[name] = dict(losses=losses, kd_losses=kd_losses, ms=lat)
        if dtype == "float32":
            one[name]["weights"] = {k: v.detach().cpu() for k, v in
                                    model.state_dict().items()}

    glob = _dist_kd_batches(seed)
    for name, dtype in DIST_KD_VARIANTS:
        model, step = _dist_step(state, dtype, 0, DEVICE,
                                 kd_fn=_dist_kd_fn(teacher),
                                 kd_loss_weight=DIST_KD_WEIGHT)
        run(name, dtype, model, step, glob, kd=True)
        del model, step
    del teacher, glob
    glob, _ = _dist_vqa_batches(seed)
    for name, dtype, intersection in DIST_VQA_VARIANTS + (
            ("vqa_f32_x", "float32", True),):
        model, step = _dist_vqa_step(state, seed, dtype, intersection,
                                     DEVICE)
        run(name, dtype, model, step, glob, kd=False)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    one["vqa_master"] = {k: v.detach().clone() for k, v in _dist_vqa_master(
        state, seed, False).state_dict().items()}
    _DIST_VQA_MASTERS.clear()
    return one


def _hold_dist_kd_vqa(ranks, one, state, workdir, smi, device_name):
    """Two ranks' KD and VQA variants against one process on the global
    batch: the ranks' losses and weights equal to each other; float32
    within DIST_LOSS_RTOL per step (KD's term too), DIST_LEAF_RTOL per leaf
    and DIST_UPDATE_RTOL of one process's update, where the planted faults
    must fail; bf16 at every step within TRAIN_BF16_LOSS_RTOL of one
    process's bf16 and float32; each path's launches; the step times of
    two ranks against one process's. Returns the paths' launch counts."""
    counts = {}
    faults = (DIST_KD_FAULT[0], DIST_VQA_FAULT[0])
    for name, dtype, *head in (DIST_KD_VARIANTS + (DIST_KD_FAULT,)
                               + DIST_VQA_VARIANTS + (DIST_VQA_FAULT,)):
        kd = name.startswith("kd")
        r0, r1 = ranks[0][name], ranks[1][name]
        ref = {DIST_KD_FAULT[0]: "kd_f32",
               DIST_VQA_FAULT[0]: "vqa_f32"}.get(name, name)
        o = one[ref]
        row = dict(phase="dist_kd_vqa_vs_one_process", backend="gloo",
                   variant=name, dtype=dtype, path="kd" if kd else "vqa",
                   head=("intersection" if head and head[0] else "plain")
                   if not kd else None, lr=DIST_LR,
                   losses_ranks=[r0["losses"], r1["losses"]],
                   losses_one_process=o["losses"],
                   kd_losses_ranks=r0["kd_losses"],
                   kd_losses_one_process=o["kd_losses"],
                   losses_equal_across_ranks=r0["losses"] == r1["losses"],
                   weights_bit_equal_across_ranks=r0["digest"]
                   == r1["digest"],
                   loss_rel=_rel_per_step(r0["losses"], o["losses"]),
                   ms_two_ranks_p50=statistics.median(r0["ms"]),
                   ms_one_process_p50=statistics.median(o["ms"]),
                   peak_mem_gb=[r0["peak_mem_gb"], r1["peak_mem_gb"]],
                   nvidia_smi=smi, card=device_name)
        agree = (row["losses_equal_across_ranks"]
                 and row["weights_bit_equal_across_ranks"])
        if kd:
            # the KD term's part of the loss delta, read against the loss
            row["kd_loss_rel"] = max(
                abs(a - b) / abs(w) for a, b, w in zip(
                    r0["kd_losses"], o["kd_losses"], o["losses"]))
        if name in faults:
            row["control"] = ("planted fault: " + (
                "every rank differentiates the whole KD term" if kd else
                "no gradient all-reduce") + "; must fail")
        else:
            check(agree, f"dist {name}: the ranks disagree: {row}")
        if dtype == "float32":
            master = state if kd else one["vqa_master"]
            got = torch.load(os.path.join(workdir, f"{name}.pt"))
            upd_rel, upd_size = _update_rel(got, o["weights"], master)
            row.update(loss_rel_max=DIST_LOSS_RTOL,
                       leaf_rel_l2=_dist_leaf_rel_l2(got, o["weights"]),
                       leaf_rel_l2_max=DIST_LEAF_RTOL, update_rel_l2=upd_rel,
                       update_rel_l2_max=DIST_UPDATE_RTOL,
                       update_size_rel_l2=upd_size)
            held = (agree and row["loss_rel"] <= DIST_LOSS_RTOL
                    and row.get("kd_loss_rel", 0.0) <= DIST_LOSS_RTOL
                    and row["leaf_rel_l2"] <= DIST_LEAF_RTOL
                    and upd_rel <= DIST_UPDATE_RTOL)
            emit(**row)
            if name in faults:
                check(not held, f"dist {name}: the planted fault passed the "
                      f"float32 bounds, which cannot see it: {row}")
                continue
            check(held, f"dist {name}: two ranks vs one process: {row}")
            counts[f"dist_{row['path']}_f32"] = r0["counts"]
            continue
        f32 = one[("kd_f32" if kd else "vqa_f32_x" if head[0]
                   else "vqa_f32")]["losses"]
        row.update(bf16_vs_one_process_bf16_rel=row.pop("loss_rel"),
                   bf16_vs_f32_rel=_rel_per_step(r0["losses"], f32),
                   bf16_vs_f32_rel_max=TRAIN_BF16_LOSS_RTOL,
                   one_process_bf16_vs_f32_rel=_rel_per_step(o["losses"],
                                                             f32))
        emit(**row)
        check(row["bf16_vs_one_process_bf16_rel"] <= TRAIN_BF16_LOSS_RTOL
              and row["bf16_vs_f32_rel"] <= TRAIN_BF16_LOSS_RTOL,
              f"dist {name} bf16: {row}")
        path = f"dist_{row['path']}"
        counts[path] = {k: v + counts.get(path, {}).get(k, 0)
                        for k, v in r0["counts"].items()}
    for path, c in sorted(counts.items()):
        hold_path(path, c)
    return counts


def dist_phase(args, device_name):
    """ROADMAP A11 on the card. Two ranks on the one card over gloo
    (processes of this script), each with DIST_LOCAL_BATCH rows of a
    global batch of 64, DIST_STEPS ITM steps at coco_ft.json's full width
    through the kernels, in float32 (TF32 off), float32 with one hard
    negative per item, and bf16, held against one process on the global
    batch (``_hold_dist_ranks``); the same ranks' KD steps (a UNITER-base
    teacher in float32; float32, bf16 and a planted fault) and VQA steps
    (3,129 answers, both head forms in bf16; float32 and a planted fault),
    held the same way (``_hold_dist_kd_vqa``); then the ITM, KD and VQA
    drivers under torch.distributed.run (one writer, one result each);
    NCCL at world 1 bit-equal to no group; where there are two cards, two
    NCCL ranks a card each held as the gloo ranks are (ITM); the sharded
    corpus."""
    from lightningdot_tpu_torch.models.factory import resolve_encoder_config

    smi = smi_line()
    gc.collect()
    torch.cuda.empty_cache()   # what earlier phases cached, for the ranks
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        master = work / "master.pt"
        state = _dist_master(args.seed + 30)
        torch.save(state, master)
        base = dict(master=str(master), workdir=tmp, seed=args.seed + 30,
                    variants=DIST_VARIANTS + (DIST_FAULT,))
        teacher_dir = save_teacher_dir(make_teacher(
            resolve_encoder_config(TEACHER_CONFIG), args.seed + 34),
            str(work / "teacher"))
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _collect_dist(_start_dist([
            dict(base, scenario="steps", rank=r, world=2, backend="gloo",
                 port=port, device_index=0, teacher_dir=teacher_dir)
            for r in range(2)]))
        emit(phase="dist_setup", backend="gloo", world=2,
             devices=[r[DIST_VARIANTS[0][0]]["device"] for r in ranks],
             local_batch=DIST_LOCAL_BATCH, global_batch=2 * DIST_LOCAL_BATCH,
             steps=DIST_STEPS, workers_seconds=time.perf_counter() - t0,
             nvidia_smi=smi, card=device_name)
        one = _dist_one_process(state, args.seed + 30)
        gloo = _hold_dist_ranks(
            ranks, one, state, tmp, "gloo", "two processes sharing one H100 over "
            "gloo's host copies against one process: not a scaling number",
            smi, device_name)
        kd_vqa = _hold_dist_kd_vqa(
            ranks, _dist_kd_vqa_one_process(state, args.seed + 30,
                                            teacher_dir),
            state, tmp, smi, device_name)

        # NCCL at world 1 runs beside the drivers: none is timed
        t0 = time.perf_counter()
        nccl1 = _start_dist([dict(base, scenario="nccl1", rank=0, world=1,
                                  port=_free_port(), device_index=0)])
        _dist_drivers(args, work, teacher_dir, device_name)
        driver_s = time.perf_counter() - t0
        (n1,) = _collect_dist(nccl1)
        emit(phase="dist_nccl_world_1", backend=n1["backend"],
             no_group_again=n1["no_group_again"],
             nccl_world_1=n1["nccl_world_1"],
             seconds=time.perf_counter() - t0,
             two_nccl_ranks="ran" if cards >= 2 else
             f"not run: {cards} card")
        check(n1["no_group_again"]["losses_equal"]
              and n1["no_group_again"]["weights_equal"],
              f"dist: the step is not repeatable without a group: {n1}")
        check(n1["nccl_world_1"]["losses_equal"]
              and n1["nccl_world_1"]["weights_equal"],
              f"dist: NCCL at world 1 differs from no group: {n1}")
        if cards >= 2:
            port = _free_port()
            _hold_dist_ranks(_collect_dist(_start_dist([
                dict(base, scenario="steps", rank=r, world=2, backend="nccl",
                     port=port, device_index=r) for r in range(2)])),
                one, state, tmp, "nccl", "two processes, a card each, over NCCL, "
                "against one process", smi, device_name)
        del one, state

        t0 = time.perf_counter()
        counts = _dist_corpus(args, make_tokenizer(work, [
            w for c in CAPTIONS for w in c.split()]), device_name)
        emit(phase="dist_done", driver_seconds=driver_s,
             corpus_seconds=time.perf_counter() - t0)
    rows, _ = hold_recorded("dist", [tuple(k) for k in ranks[0]["shapes"]],
                            device_name)
    return dict(counts=gloo["timed_counts"], sharded=counts, rows=rows,
                kd_vqa=kd_vqa)


def examples_phase(args, device_name):
    """The port's examples on the card at their widths (ROADMAP A15):
    ``examples/demo_retrieval_torch.py``'s ``main()`` (BERT-base cased and
    UNITER-base in bf16, 64 synthetic images encoded, two queries), each
    top 5 equal to ``Retriever.retrieve_query`` on the retriever it built;
    then ``examples/serve_http_torch.py``'s ``build`` behind
    ``RetrievalServer`` on a free port: one ``/search?q=...&top=5``,
    equal to a direct ``retrieve_query``. The demo's launches are held."""
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.serving_http import RetrievalServer

    demo = _load_file("examples", "demo_retrieval_torch.py")
    built = []

    def keep(real):
        def build(*a, **k):
            built.append(real(*a, **k))
            return built[-1]
        return build

    reset_launch_counts()
    t = time.perf_counter()
    with _patched(demo, "build", keep):
        got = demo.main([])
    demo_s = time.perf_counter() - t
    counts = launch_counts()
    (retriever,) = built
    want = {q: retriever.retrieve_query(q, top=5) for q in demo.QUERIES}
    emit(phase="examples_demo", seconds=demo_s,
         corpus=retriever.corpus_size, device=str(retriever.device),
         top5=got, equal_to_retrieve_query=got == want, card=device_name)
    check(got == want and all(len(v) == 5 and all(np.isfinite(s) for _, s
                                                  in v)
                              for v in got.values()),
          f"examples: the demo's answers {got} are not retrieve_query's "
          f"{want}")
    hold_path("examples", counts)
    del retriever, built[:]

    serve = _load_file("examples", "serve_http_torch.py")
    query = "two dogs play in the park"
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        frontend = serve.build(tmp)
        build_s = time.perf_counter() - t
        with RetrievalServer(frontend) as srv:
            url = f"{srv.address}/search?q={quote(query)}&top=5"
            with urllib.request.urlopen(url, timeout=120) as r:
                body = json.loads(r.read())
        answer = [tuple(x) for x in body["results"]]
        direct = frontend.retriever.retrieve_query(query, top=5)
    emit(phase="examples_serve_http", build_seconds=build_s,
         corpus=frontend.retriever.corpus_size, top5=answer,
         equal_to_retrieve_query=answer == direct, card=device_name)
    check(answer == direct, f"examples: /search answered {answer}, "
          f"retrieve_query {direct}")
    return counts


# the Moonlight tower (configs/moonlight_16b_a3b_card.json, one card's cut
# of benchmark/configs/lightningdot-moonlight-16b-a3b.json): its kernel rows
# at the fine-tuning step's shapes, batch 512 captions padded to 32 tokens
# (13.9 real on average), 8 of each MoE layer's 64 experts held, top 6
MOON_BATCH, MOON_SEQ, MOON_REAL = 512, 32, 13.9
MOON_HIDDEN, MOON_LATENT, MOON_HEADS = 2048, 512, 16
MOON_QK, MOON_V, MOON_ROPE = 192, 128, 64
MOON_EXPERTS, MOON_HELD, MOON_TOPK = 64, 8, 6
MOON_INTER = {"routed": 1408, "shared": 2816, "dense": 11264}
MOON_EPS, MOON_THETA = 1e-5, 50000.0
# the step whose launches and host syncs are held: 3 layers of the cut
# (the dense layer and two MoE layers) at batch 64 beside the image tower
MOON_STEP_LAYERS, MOON_STEP_BATCH, MOON_STEP_REGIONS = 3, 64, 103
MOON_SPANS = ("moe.route", "moe.experts", "moe.shared", "moe.combine",
              "mla.attention")


def moon_rms_rows(device_name, randn):
    """B1's RMS mode, forward and backward, at the tower's widths (hidden
    2,048 and the 512-d KV latent) over the step's 16,384 token rows and a
    ragged 37: within the twin's tolerance, as accurate as the twin against
    the float32 computation, the same bits again. Library: ``F.rms_norm``
    (forward)."""
    from lightningdot_tpu_torch.ops import layernorm as ln

    bf16, rows = torch.bfloat16, []
    n = MOON_BATCH * MOON_SEQ
    for r, h in ((n, MOON_HIDDEN), (n, MOON_LATENT), (37, MOON_HIDDEN)):
        x = randn(r, h, dtype=bf16)
        scale = 1 + randn(h, scale=0.1)
        g = randn(r, h, dtype=bf16)
        rows.append(compare(
            "rmsnorm", (r, h), bf16,
            lambda: ln.rms_norm_cuda(x, scale, MOON_EPS),
            lambda: ln.rms_fwd_math(x, scale, MOON_EPS), device_name,
            (2 * r * h * 2 + h * 4, 4 * r * h, PEAK_OPS["f32"]),
            library=lambda: torch.nn.functional.rms_norm(
                x, (h,), scale.to(bf16), MOON_EPS),
            reference=lambda: ln.rms_fwd_math(x.float(), scale, MOON_EPS),
            repeat=True))
        # dx held as the forward is; dscale, float32 sums over the rows in
        # another order, within 1e-5 of its peak
        ds, ds_twin = (fn(x, scale, g, MOON_EPS)[1] for fn in (
            ln.rms_norm_bwd_cuda, ln.rms_bwd_math))
        ds_err = ((ds - ds_twin).abs().max()
                  / ds_twin.abs().max().clamp(min=1.0)).item()
        rows.append(compare(
            "rmsnorm_bwd", (r, h), bf16,
            lambda: ln.rms_norm_bwd_cuda(x, scale, g, MOON_EPS)[0],
            lambda: ln.rms_bwd_math(x, scale, g, MOON_EPS)[0], device_name,
            (3 * r * h * 2 + 2 * h * 4, 8 * r * h, PEAK_OPS["f32"]),
            reference=lambda: ln.rms_bwd_math(x.float(), scale, g.float(),
                                              MOON_EPS)[0],
            repeat=True, dscale_rel_err=ds_err))
        check(ds_err <= TOL[torch.float32],
              f"rmsnorm_bwd ({r}, {h}): dscale off by {ds_err} of its peak")
    return rows


def moon_rope_rows(device_name, randn):
    """RoPE (``csrc/rope.cu``) on the rope dims of q (16 heads) and of k_pe
    (one head, shared by all) at the step's [512, 32], forward and inverse
    (its backward): within the twin's tolerance, as accurate as the twin,
    the same bits again."""
    from lightningdot_tpu_torch.ops import rope

    bf16, rows = torch.bfloat16, []
    for heads in (MOON_HEADS, 1):
        x = randn(MOON_BATCH, MOON_SEQ, heads, MOON_ROPE, dtype=bf16)
        for inverse in (False, True):
            rows.append(compare(
                "rope", tuple(x.shape), bf16,
                lambda: rope.rope_cuda(x, MOON_THETA, inverse),
                lambda: rope.rope_math(x, MOON_THETA, inverse), device_name,
                (2 * x.numel() * 2, 3 * x.numel(), PEAK_OPS["f32"]),
                reference=lambda: rope.rope_math(x.float(), MOON_THETA,
                                                 inverse),
                repeat=True, **({"variant": "inverse"} if inverse else {})))
    return rows


def moon_mla_rows(device_name, randn, g):
    """MLA's attention (``csrc/mla_attention.cu``: bf16 rows staged by
    16-byte cp.async, products on mma.sync, p and ds as hi/lo bf16 pairs):
    q/k 192, v 128, 16 heads, causal with pad keys masked, at [512, S] for
    S 32 (the step's rung), 40 (not a multiple of 16), 48 and 64 on ragged
    lengths that include 1 and S, forward and backward: within the twin's
    tolerance, as accurate as the twin against the float32 computation, the
    same bits again; the forward faster than SDPA, the backward faster than
    its twin. The bound counts the bytes of the whole padded tensors and
    the (query, key) pairs of real queries, the only ones the kernels
    compute. Library: SDPA with the same boolean mask (forward)."""
    from lightningdot_tpu_torch.ops import mla_attention as mla

    bf16, rows = torch.bfloat16, []
    b, nh, sc = MOON_BATCH, MOON_HEADS, MOON_QK ** -0.5
    for s in (MOON_SEQ, 40, 48, 64):
        q, k = (randn(b, s, nh, MOON_QK, dtype=bf16) for _ in range(2))
        v, go = (randn(b, s, nh, MOON_V, dtype=bf16) for _ in range(2))
        lens = torch.randint(3, s + 1, (b,), device="cuda", generator=g)
        lens[0], lens[-1] = 1, s
        key_ok = (torch.arange(s, device="cuda")[None]
                  < lens[:, None]).float()
        allowed = mla._allowed(key_ok, s, True)
        f32 = [t.float() for t in (q, k, v)]
        o, lse = mla.mla_attention_cuda(q, k, v, key_ok, sc)
        pairs = float((lens * (lens + 1) // 2).sum()) * nh
        fwd = compare(
            "mla_attention", (b, s, nh, MOON_QK), bf16,
            lambda: mla.mla_attention_cuda(q, k, v, key_ok, sc)[0],
            lambda: mla.mla_attention_math(q, k, v, key_ok, sc)[0],
            device_name,
            (2 * (q.numel() + k.numel() + 2 * v.numel()),
             2 * pairs * (MOON_QK + MOON_V), PEAK_OPS["bf16"]),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=allowed, scale=sc),
            reference=lambda: mla.mla_attention_math(*f32, key_ok, sc)[0],
            repeat=True)
        bwd = compare(
            "mla_attention_bwd", (b, s, nh, MOON_QK), bf16,
            lambda: mla.mla_attention_bwd_cuda(q, k, v, o, go, key_ok, lse,
                                               sc),
            lambda: mla.mla_attention_bwd_math(q, k, v, o, go, key_ok, lse,
                                               sc), device_name,
            (2 * (2 * q.numel() + 2 * k.numel() + 3 * v.numel()),
             2 * pairs * (3 * MOON_QK + 2 * MOON_V), PEAK_OPS["bf16"]),
            reference=lambda: mla.mla_attention_bwd_math(
                *f32, o.float(), go.float(), key_ok, lse, sc),
            repeat=True)
        rows += [fwd, bwd]
        check(fwd["ms"] < fwd["library_ms"],
              f"mla_attention S {s}: {fwd['ms']} ms, SDPA "
              f"{fwd['library_ms']} ms")
        check(bwd["ms"] < bwd["plain_ms"],
              f"mla_attention_bwd S {s}: {bwd['ms']} ms, its twin "
              f"{bwd['plain_ms']} ms")
    return rows


def _head(out, total):
    """The rows the groups hold of a grouped kernel's output (the kernels
    leave the rest unwritten, the twins zero)."""
    if isinstance(out, tuple):
        return tuple(t[:total] for t in out)
    return out[:total]


def moon_moe_rows(device_name, randn, g):
    """The grouped SwiGLU GEMMs (``csrc/moe_gemm.cu``, ``moe_gemm``) in
    every form the step runs (the gate/up GEMM with its SwiGLU epilogue,
    the down GEMM, the SwiGLU backward, dx, and both weight gradients): for
    the routed experts over 16,384 tokens (13.9 of 32 real) that choose 6
    of 64 experts at random, 8 held; for the shared experts and the dense
    layer over the real rows as one group. Then the routing's gather and
    scatter kernels: ``moe_combine``, ``moe_scatter_rows`` and
    ``moe_route_grad``. Each within the twin's tolerance on the rows the
    groups hold, as accurate as the twin against the float32 computation
    (``moe_route_grad``, float32 out, within 1e-5), the same bits again.
    The twins read the groups' offsets on the host, so they are timed
    eagerly."""
    from lightningdot_tpu_torch.ops import moe

    bf16, rows = torch.bfloat16, []
    n, h = MOON_BATCH * MOON_SEQ, MOON_HIDDEN
    real = torch.rand(n, device="cuda", generator=g) < MOON_REAL / MOON_SEQ
    sel = torch.topk(randn(n, MOON_EXPERTS), MOON_TOPK, dim=-1).indices
    routed = moe.route(sel, 0, MOON_HELD, real)
    for block, r in (("routed", routed), ("shared", moe.real_rows(real)),
                     ("dense", moe.real_rows(real))):
        inter, groups = MOON_INTER[block], r.offsets.shape[0] - 1
        off, tok, cap = r.offsets, r.tok, r.rows
        total = int(off[-1])
        x = randn(n, h, scale=0.5, dtype=bf16)
        w_gu = randn(groups, 2 * inter, h, scale=0.02, dtype=bf16)
        w_down = randn(groups, h, inter, scale=0.02, dtype=bf16)
        dy = randn(cap, h, dtype=bf16)
        dgu = randn(cap, 2 * inter, dtype=bf16)
        gate, up, act = moe.gate_up(x, tok, off, w_gu, cap)
        f = {name: t.float() for name, t in (
            ("x", x), ("w_gu", w_gu), ("w_down", w_down), ("dy", dy),
            ("dgu", dgu), ("gate", gate), ("up", up), ("act", act))}
        # bytes of one weight stack, and of a [total, width] bf16 block
        wb, rb = 2 * groups * h * inter, lambda width: 2 * total * width
        flops = 2 * total * h * inter
        forms = {
            "gate_up": (
                lambda: moe.gate_up(x, tok, off, w_gu, cap),
                lambda: moe.gate_up_math(x, tok, off, w_gu, cap),
                lambda: moe.gate_up_math(f["x"], tok, off, f["w_gu"], cap),
                2 * wb + rb(h) + rb(3 * inter), 2 * flops),
            "down": (
                lambda: moe.down(act, off, w_down, cap),
                lambda: moe.rows_times_math(act, off, w_down, True, cap),
                lambda: moe.rows_times_math(f["act"], off, f["w_down"],
                                            True, cap),
                wb + rb(inter) + rb(h), flops),
            "swiglu_bwd": (
                lambda: moe.swiglu_bwd(dy, off, w_down, gate, up, cap),
                lambda: moe.swiglu_bwd_math(dy, off, w_down, gate, up, cap),
                lambda: moe.swiglu_bwd_math(f["dy"], off, f["w_down"],
                                            f["gate"], f["up"], cap),
                wb + rb(h) + rb(4 * inter), flops),
            "dx": (
                lambda: moe.dx_rows(dgu, off, w_gu, cap),
                lambda: moe.rows_times_math(dgu, off, w_gu, False, cap),
                lambda: moe.rows_times_math(f["dgu"], off, f["w_gu"], False,
                                            cap),
                2 * wb + rb(2 * inter) + rb(h), 2 * flops),
            "weights_gu": (
                lambda: moe.weight_grad(dgu, x, tok, off),
                lambda: moe.weight_grad_math(dgu, x, tok, off),
                lambda: moe.weight_grad_math(f["dgu"], f["x"], tok, off),
                2 * wb + rb(2 * inter) + rb(h), 2 * flops),
            "weights_down": (
                lambda: moe.weight_grad(dy, act, None, off),
                lambda: moe.weight_grad_math(dy, act, None, off),
                lambda: moe.weight_grad_math(f["dy"], f["act"], None, off),
                wb + rb(h) + rb(inter), flops)}
        for form, (kernel, twin, ref, nbytes, ops) in forms.items():
            rows_out = not form.startswith("weights")
            cut = (lambda fn: lambda: _head(fn(), total)) if rows_out else (
                lambda fn: fn)
            rows.append(compare(
                "moe_gemm", (n, h, inter), bf16, cut(kernel), cut(twin),
                device_name, (nbytes, ops, PEAK_OPS["bf16"]),
                reference=cut(ref), repeat=True, plain_eager=True,
                variant=form, block=block, rows=total, groups=groups))
        del gate, up, act, dy, dgu, f
    r, total = routed, int(routed.offsets[-1])
    y = randn(r.rows, h, dtype=bf16)
    gt = randn(n, h, dtype=bf16)
    w = torch.rand(n, MOON_TOPK, device="cuda", generator=g)
    slots = n * MOON_TOPK * 8
    rows.append(compare(
        "moe_combine", (n, h), bf16, lambda: moe.combine(y, r.pos, w),
        lambda: moe.combine_math(y, r.pos, w), device_name,
        (2 * (total + n) * h + slots, 2 * total * h, PEAK_OPS["f32"]),
        reference=lambda: moe.combine_math(y.float(), r.pos, w),
        repeat=True, plain_eager=True, rows=total))
    rows.append(compare(
        "moe_scatter_rows", (n, h), bf16,
        lambda: moe.scatter_rows(gt, r, w)[:total],
        lambda: moe.scatter_rows_math(gt, r, w)[:total], device_name,
        (2 * 2 * total * h + 8 * total, total * h, PEAK_OPS["f32"]),
        reference=lambda: moe.scatter_rows_math(gt.float(), r, w)[:total],
        repeat=True, plain_eager=True, rows=total))
    # the gradient reads the cotangent of the tokens with a held slot only
    held = int((r.pos >= 0).any(1).sum())
    rows.append(compare(
        "moe_route_grad", (n, h), torch.float32,
        lambda: moe.route_grad(gt, y, r.pos),
        lambda: moe.route_grad_math(gt, y, r.pos), device_name,
        (2 * (held + total) * h + slots, 2 * total * h, PEAK_OPS["f32"]),
        repeat=True, plain_eager=True, rows=total, tokens_held=held))
    return rows


# the bf16 projections at the cell's shapes (batch 512: 16,384 text rows,
# 53,248 image rows): MLA's q (2,048 -> 3,072) and kv_b (512 -> 4,096), no
# bias; the image tower's 768 -> 768, with one
MOON_PRODUCTS = (("mla_q", MOON_BATCH * MOON_SEQ, MOON_HIDDEN,
                  MOON_HEADS * MOON_QK, False),
                 ("mla_kv_b", MOON_BATCH * MOON_SEQ, MOON_LATENT,
                  MOON_HEADS * (MOON_QK - MOON_ROPE + MOON_V), False),
                 ("image_dense", MOON_BATCH * 104, 768, 768, True))


def _bf16_ulp(x):
    """The spacing of bfloat16 values at each magnitude of ``x``."""
    exponent = torch.frexp(x.to(torch.bfloat16).float()).exponent
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def moon_round_rows(device_name, randn):
    """``mm_round`` (the product rounded inside cuBLAS, the bf16 cotangent
    taken as it comes) against the chain it replaced (``mm_f32``, the
    float32 bias add, ``.to(bf16)``, whose backward casts the cotangent to
    float32 and back and rounds each gradient in a pass of its own), forward
    and backward at the cell's shapes, under the product rule that
    importing the port sets (``ops/matmul.py``). Each output (y, da, db) is
    held within a bf16 ulp of the float32 product of the same operands,
    with the share of its elements that differ from that product rounded;
    the bias gradient within 1e-5 of the chain's. Both are timed in a CUDA
    graph."""
    from lightningdot_tpu_torch.ops.matmul import mm_f32, mm_round

    bf16, rows = torch.bfloat16, []
    for name, m, k, n, with_bias in MOON_PRODUCTS:
        a = randn(m, k, dtype=bf16)
        b = randn(k, n, scale=k ** -0.5, dtype=bf16)
        bias = randn(n, scale=0.5) if with_bias else None
        g = randn(m, n, dtype=bf16)
        operands = (a, b) + ((bias,) if with_bias else ())

        def fwd_bwd(product):
            # fresh leaves every call: a leaf's gradient accumulator
            # keeps the stream of the leaf's first use, and a backward
            # captured in a graph may touch no other stream
            def run():
                leaves = tuple(t.detach().requires_grad_(True)
                               for t in operands)
                y = product(*leaves)
                return (y,) + torch.autograd.grad(y, leaves, g)
            return run

        new = fwd_bwd(mm_round)
        chain = fwd_bwd(lambda a, b, bias=None: (
            mm_f32(a, b) if bias is None else mm_f32(a, b) + bias
        ).to(bf16))
        got, old = new(), chain()
        with torch.no_grad():
            exact = (mm_f32(a, b) + (0 if bias is None else bias),
                     mm_f32(g, b.t()), mm_f32(a.t(), g))
        held = {}
        for label, x, x_old, x32 in zip(("y", "da", "db"), got, old,
                                        exact):
            diff = (x.float() - x32).abs()
            held[f"{label}_differ_frac"] = (
                x != x32.to(bf16)).float().mean().item()
            held[f"{label}_chain_differ_frac"] = (
                x != x_old).float().mean().item()
            held[f"{label}_max_ulps"] = (
                diff / _bf16_ulp(x32)).max().item()
        if with_bias:
            held["dbias_rel_err"] = ((got[3] - old[3]).abs().max()
                                     / old[3].abs().max()).item()
        del got, old, exact
        row = dict(phase="rounded_product", kernel="mm_round",
                   variant=name, shape=[m, k, n], dtype="bfloat16",
                   bias=with_bias, **held, ms=time_ms(new, 5, 5),
                   chain_ms=time_ms(chain, 5, 5), device=device_name)
        emit(**row)
        check(all(held[f"{x}_max_ulps"] <= 1.0 for x in ("y", "da",
                                                          "db")),
              f"mm_round {name}: more than a bf16 ulp from the float32 "
              f"product: {held}")
        check(not with_bias or held["dbias_rel_err"] <= 1e-5,
              f"mm_round {name}: bias gradient off: {held}")
        rows.append(row)
        del a, b, bias, g, operands
    return rows


def moon_step(device_name):
    """One fine-tuning step of a 3-layer cut of the tower (the dense layer
    and two MoE layers; batch 64, captions of 8-32 tokens) beside the
    image tower in bf16 through ``make_itm_train_step``, after a warm-up
    step, in eval mode (no dropout: the image tower's dropout seeds are a
    host upload): launch counters reset just before it and read after it,
    under ``torch.cuda.set_sync_debug_mode("error")``, so that a host sync
    anywhere in the step, the routing's included, raises; its spans and
    the MoE counters recorded, and ``mm_round``'s calls held to one a bf16
    projection. Returns the launch counts."""
    from lightningdot_tpu_torch.config import EncoderConfig, MoonlightConfig
    from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
    from lightningdot_tpu_torch.models.encoder import init_tower_
    from lightningdot_tpu_torch.models.moonlight import init_moonlight_
    from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
    from lightningdot_tpu_torch.training.itm_step import (batch_to_device,
                                                          make_itm_train_step)
    from lightningdot_tpu_torch.training.optim import make_optimizer
    from lightningdot_tpu_torch.utils import tracing

    with open(Path(__file__).parent / "configs"
              / "moonlight_16b_a3b_card.json") as f:
        cut = json.load(f)
    cfg = MoonlightConfig.from_dict(dict(
        cut, num_hidden_layers=MOON_STEP_LAYERS, project_dim=768))
    img_cfg = EncoderConfig(project_dim=768)
    model = BiEncoder(cfg, img_cfg, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    init_moonlight_(model.txt_model, gen)
    init_tower_(model.img_model, gen)
    model.eval()
    opt = make_optimizer(model, 2e-5, max_grad_norm=2.0)
    step = make_itm_train_step(model, opt, device=torch.device(DEVICE))
    b, s, r = MOON_STEP_BATCH, MOON_SEQ, MOON_STEP_REGIONS
    gen = torch.Generator().manual_seed(1)
    lens = torch.randint(8, s + 1, (b,), generator=gen)
    mask = (torch.arange(s)[None] < lens[:, None]).long()
    ids = torch.randint(999, cut["vocab_size"], (b, s), generator=gen) * mask
    batch = batch_to_device({
        "txts": {"input_ids": ids, "attention_mask": mask,
                 "position_ids": torch.arange(s).expand(b, s)},
        "imgs": {"input_ids": torch.full((b, 1), 101),
                 "attention_mask": torch.ones(b, r + 1, dtype=torch.long),
                 "img_feat": torch.rand(b, r, IMG_DIM, generator=gen),
                 "img_pos_feat": torch.rand(b, r, 7, generator=gen)}},
        torch.device(DEVICE))
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    raised = None
    with tracing.recording():
        tracing.clear()
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = step(batch)
        except RuntimeError as e:       # a host sync
            raised = str(e)[:400]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counts = launch_counts()
        recs = tracing.records()
    spans = sorted({x.name for x in recs})
    counters = {name: [x.counts[name] for x in recs
                       if x.name == "moe.route" and name in x.counts]
                for name in ("routed_rows", "max_expert_rows")}
    # every bf16 projection is one rounded product: MLA's four a layer, the
    # image tower's two embedding projections and four a layer, two in each
    # projection head; each counts once in the forward and once in the
    # backward, on the step's phases
    want_rounded = (4 * MOON_STEP_LAYERS + 2
                    + 4 * img_cfg.num_hidden_layers + 4)
    rounded_on = {name: sum(x.counts.get("rounded_products", 0)
                            for x in recs if x.name == name)
                  for name in ("step.forward", "step.backward")}
    emit(phase="moonlight_step", layers=MOON_STEP_LAYERS, batch=b,
         raised=raised, loss=None if raised else float(metrics["loss"]),
         spans=spans, **counters, rounded_products_on=rounded_on,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, card=device_name)
    check(raised is None, f"moonlight: the step synced the host: {raised}")
    check(set(MOON_SPANS) <= set(spans),
          f"moonlight: spans {spans} lack one of {MOON_SPANS}")
    check(len(counters["routed_rows"]) == MOON_STEP_LAYERS - 1
          and all(0 < m <= t for m, t in zip(counters["max_expert_rows"],
                                             counters["routed_rows"])),
          f"moonlight: MoE counters {counters}")
    check(all(v == want_rounded for v in rounded_on.values()),
          f"moonlight: rounded products {rounded_on} on the step's phases, "
          f"{want_rounded} projections")
    del step, opt, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def moonlight_phase(args, device_name):
    """The Moonlight tower's kernels against their twins at the
    fine-tuning step's shapes, its bf16 projections against the chain they
    replaced, then one step held to no host sync, its launches and rounded
    products held (``moonlight``). Returns {"rows", "counts"}."""
    randn, g = make_randn(args.seed + 24)
    rows = moon_rms_rows(device_name, randn)
    rows += moon_rope_rows(device_name, randn)
    rows += moon_mla_rows(device_name, randn, g)
    rows += moon_moe_rows(device_name, randn, g)
    rows += moon_round_rows(device_name, randn)
    gc.collect()
    torch.cuda.empty_cache()
    counts = moon_step(device_name)
    hold_path("moonlight", counts)
    return {"rows": rows, "counts": counts}


REPLACES = {
    "layernorm": ("lightningdot_tpu_torch/csrc/layernorm.cu",
                  "lightningdot_tpu/ops/layernorm.py:30"),
    # the jnp VJP that XLA fuses on the TPU (with fused.py's _dal_bwd)
    "layernorm_bwd": ("lightningdot_tpu_torch/csrc/layernorm.cu",
                      "lightningdot_tpu/ops/layernorm.py:74"),
    "attention": ("lightningdot_tpu_torch/csrc/attention_mma.cu",
                  "lightningdot_tpu/ops/attention.py:87"),
    "ffn_mma": ("lightningdot_tpu_torch/csrc/ffn_mma.cu",
                "lightningdot_tpu/ops/ffn.py:77"),
    "ffn": ("lightningdot_tpu_torch/csrc/ffn.cu",
            "lightningdot_tpu/ops/ffn.py:77"),
    "ffn_int8": ("lightningdot_tpu_torch/csrc/ffn_int8.cu",
                 "lightningdot_tpu/ops/experimental/ffn_int8_pallas.py:24"),
    "ffn_dh1_mma": ("lightningdot_tpu_torch/csrc/ffn_mma.cu",
                    "lightningdot_tpu/ops/experimental/ffn_dh1.py:28"),
    "ffn_dh1": ("lightningdot_tpu_torch/csrc/ffn.cu",
                "lightningdot_tpu/ops/experimental/ffn_dh1.py:28"),
    "adamw": ("lightningdot_tpu_torch/csrc/adamw.cu",
              "lightningdot_tpu/ops/experimental/adamw_pallas.py:27"),
    "attention_train_fwd": (
        "lightningdot_tpu_torch/csrc/attention_mma.cu",
        "lightningdot_tpu/ops/experimental/attention_fused.py:117"),
    "attention_train_bwd_mma": (
        "lightningdot_tpu_torch/csrc/attention_mma_bwd.cu",
        "lightningdot_tpu/ops/experimental/attention_fused.py:136"),
    "attention_train_bwd": (
        "lightningdot_tpu_torch/csrc/attention_fused.cu",
        "lightningdot_tpu/ops/experimental/attention_fused.py:136"),
}
# the Moonlight tower's kernels, which no TPU kernel precedes
REPLACES.update({
    name: (f"lightningdot_tpu_torch/csrc/{source}.cu", None)
    for name, source in (
        ("rmsnorm", "layernorm"), ("rmsnorm_bwd", "layernorm"),
        ("mla_attention", "mla_attention"),
        ("mla_attention_bwd", "mla_attention"), ("rope", "rope"),
        ("moe_gemm", "moe_gemm"), ("moe_combine", "moe_gemm"),
        ("moe_scatter_rows", "moe_gemm"), ("moe_route_grad", "moe_gemm"))})
# the row each kernel reports in the kernels line: the serving shape (batch
# 64, 32 tokens, bf16) for the serving kernels; the training step's image
# tower (64 x 64 rows, bf16) for dh1 and the training attention; every
# parameter with a float32 first moment for AdamW; the float32 FMA forms of
# the FFN, dh1 and the backward at the bf16 rows' shapes. The bf16 attention
# forwards run the tensor-core kernel, the source named above
REPORT_ROW = {"layernorm": ([2048, 768], "bfloat16"),
              "layernorm_bwd": ([4096, 768], "bfloat16"),
              "attention": ([64, 32, 12, 64], "bfloat16"),
              "ffn_mma": ([2048, 768, 3072], "bfloat16"),
              "ffn": ([2048, 768, 3072], "float32"),
              "ffn_int8": ([2048, 768, 3072], "bfloat16"),
              "ffn_dh1_mma": ([4096, 768, 3072], "bfloat16"),
              "ffn_dh1": ([4096, 768, 3072], "float32"),
              "adamw": (None, "float32"),
              "attention_train_fwd": ([64, 64, 12, 64], "bfloat16"),
              "attention_train_bwd_mma": ([64, 64, 12, 64], "bfloat16"),
              "attention_train_bwd": ([64, 64, 12, 64], "float32"),
              # the Moonlight step's shapes: 16,384 token rows, [512, 32]
              # captions, the routed experts' gate/up GEMM
              "rmsnorm": ([16384, 2048], "bfloat16"),
              "rmsnorm_bwd": ([16384, 2048], "bfloat16"),
              "mla_attention": ([512, 32, 16, 192], "bfloat16"),
              "mla_attention_bwd": ([512, 32, 16, 192], "bfloat16"),
              "rope": ([512, 32, 16, 64], "bfloat16"),
              "moe_gemm": ([16384, 2048, 1408], "bfloat16"),
              "moe_combine": ([16384, 2048], "bfloat16"),
              "moe_scatter_rows": ([16384, 2048], "bfloat16"),
              "moe_route_grad": ([16384, 2048], "float32")}
# the LayerNorm rows' variant the kernels line reports: the forward without
# a prologue; the backward of the training sites (res and a mask)
REPORT_VARIANT = {"layernorm_bwd": "res_keep", "moe_gemm": "gate_up"}
# the path whose launch count the kernels line reports for each kernel
REPORT_PATH = {"layernorm": "text_bf16", "layernorm_bwd": "itm_train",
               "attention": "text_bf16",
               "ffn_mma": "text_bf16", "ffn": "text_f32",
               "ffn_int8": "int8_serving", "ffn_dh1_mma": "itm_train",
               "ffn_dh1": "itm_train_f32",
               "adamw": "itm_train", "attention_train_fwd": "itm_train",
               "attention_train_bwd_mma": "itm_train",
               "attention_train_bwd": "itm_train_f32_full",
               **{name: "moonlight" for name in PATH_KERNELS["moonlight"]
                  if name not in PATH_KERNELS["dist_vqa"]}}


def kernel_entries(rows, paths, names):
    """The kernels line: for each kernel of ``names`` its report row (the
    shape, dtype and variant above) and its launches on its report
    path."""
    kernels = []
    for name in names:
        source, replaces = REPLACES[name]
        shape, dtype = REPORT_ROW[name]
        rep = [r for r in rows if r["kernel"] == name
               and (shape is None or r["shape"] == shape)
               and r["dtype"] == dtype and r.get("mode") != "train"
               and r.get("variant") == REPORT_VARIANT.get(name)
               and r.get("m_dtype", "float32") == "float32"][0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[REPORT_PATH[name]][name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=rep["shape"], dtype=dtype, path=REPORT_PATH[name],
            passed=True))
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist_worker", default=None,
                    help=argparse.SUPPRESS)   # one rank of dist_phase
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.dist_worker is not None:
        return dist_worker(json.loads(args.dist_worker))
    from lightningdot_tpu_torch.ops import _build

    device_name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    emit(phase="setup", torch=torch.__version__, cuda=torch.version.cuda,
         device=device_name, nvidia_smi=smi)
    t0 = time.perf_counter()
    _build.lib()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds)
    # the tensor-core kernels' register files: the attention forward, one
    # kernel per bucket of keys (32, 64, 128, 256) and epilogue (0
    # deferred, 1 normalized); the backward's dq and dk/dv kernels; the
    # FFN's GEMM (epilogue 0 fc1, 1 fc2, 2 dh1) and its split pass; the
    # int8 FFN's GEMM (0 fc1, 1 fc2) and its split pass; and the float32
    # FMA kernels: the FFN's GEMM, gemm_kernel<epilogue> (0 fc1, 1 fc2)
    # and narrow_kernel<epilogue, rows a thread>, the attention
    # (attention_kernel<dropout>: 1 is the training forward) and the
    # training attention's backward (bwd_q_kernel, bwd_kv_kernel<tile>)
    for name, (regs, spill_st, spill_ld) in sorted(
            _build.ptxas_report("attention_mma").items()):
        keys, epilogue = re.search(r"kernelILi(\d+)ELi(\d)E", name).groups()
        emit(phase="resources", kernel="attention_mma", keys=16 * int(keys),
             epilogue=("deferred", "normalized")[int(epilogue)],
             registers=regs, spill_store_bytes=spill_st,
             spill_load_bytes=spill_ld)
    # the LayerNorm kernels: <dtype, vectors per thread, res, keep>
    for name, (regs, spill_st, spill_ld) in sorted(
            _build.ptxas_report("layernorm").items()):
        entry = re.search(r"(layernorm_\w+?_kernel)", name).group(1)
        targs = re.findall(r"L[ib](\d+)E", name)
        if targs:
            dt = "bf16" if "bfloat16" in name else "f32"
            entry += f"<{','.join([dt] + targs)}>"
        emit(phase="resources", kernel="layernorm", entry=entry,
             registers=regs, spill_store_bytes=spill_st,
             spill_load_bytes=spill_ld)
    for stem in ("attention_mma_bwd", "ffn_mma", "ffn_int8", "ffn",
                 "attention", "attention_fused", "moe_gemm", "mla_attention",
                 "rope"):
        for name, (regs, spill_st, spill_ld) in sorted(
                _build.ptxas_report(stem).items()):
            entry = re.search(r"\d([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?",
                              name)
            targs = re.findall(r"L[ib](\d+)E", entry.group(2) or "")
            emit(phase="resources", kernel=stem, entry=entry.group(1) + (
                f"<{','.join(targs)}>" if targs else ""),
                 registers=regs, spill_store_bytes=spill_st,
                 spill_load_bytes=spill_ld)

    mask_rows(device_name)
    rows = kernel_phase(device_name)
    topk_phase(device_name)
    with tempfile.TemporaryDirectory() as tmp:
        words = [w for c in CAPTIONS for w in c.split()] + ["at", "night"]
        t0 = time.perf_counter()
        tok = make_tokenizer(Path(tmp), words)
        emit(phase="tokenizer", native=tok.native,
             seconds=time.perf_counter() - t0)
        r16, ctx = main_path(args, tok, device_name)
        serve_phase(r16)
        serve_http_phase(r16)
        loadgen_phase(r16, ctx["p50"][64], device_name)
        del r16
        paths = {"text_f32": ctx["counts_f32"], "text_bf16": ctx["counts"]}
        img = image_phase(args, ctx, device_name)
        paths["image_bf16"] = img["counts"]
        paths["int8_serving"] = int8_phase(args, tok, ctx, img, device_name)
        del ctx, img
    paths["eval"] = eval_phase(args, device_name)
    train = train_phase(args, device_name)
    paths["itm_train"] = train["counts"]
    paths["itm_train_f32"] = train["counts_f32"]
    paths["itm_train_f32_full"] = train["counts_f32_full"]
    paths["train_itm_cli"] = train_itm_cli_phase(args, device_name)["counts"]
    paths["pretrain"] = pretrain_phase(args, device_name)["counts"]
    paths["rerank"] = rerank_phase(args, device_name)["counts"]
    paths["train_teacher"] = train_teacher_phase(args, device_name)["counts"]
    paths["kd"] = kd_phase(args, device_name)["counts"]
    paths["pretrain_kd"] = pretrain_kd_phase(args, device_name)["counts"]
    paths["vqa"] = vqa_phase(args, device_name)["counts"]
    prepro_phase(args, device_name)
    dist = dist_phase(args, device_name)
    paths["dist"] = dist["counts"]
    paths["dist_sharded_int8"] = dist["sharded"]["int8"]
    paths.update(dist["kd_vqa"])
    paths["examples"] = examples_phase(args, device_name)
    moon = moonlight_phase(args, device_name)
    rows += moon["rows"]
    paths["moonlight"] = moon["counts"]
    check(all(any(c[name] > 0 for c in paths.values()) for name in REPLACES),
          f"a kernel was launched on no path: {paths}")

    kernels = kernel_entries(rows, paths, REPLACES)
    check("jax" not in sys.modules, "jax was imported")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
