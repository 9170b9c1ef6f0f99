"""``utils/tracing.py``: spans and counters recorded only under
torch.profiler or ``recording()``, nested by thread, with ids, a bounded
buffer, the wall clock's offset and the kernels' launch counts; and the
spans of the ITM step's feed and phases and of ``CrossScorer.score_pairs``
with the positions their collates padded."""
import functools
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.data.itm import CollateConfig, itm_fast_collate
from lightningdot_tpu_torch.data.loader import (DataLoader, DevicePrefetcher,
                                                PinnedStager)
from lightningdot_tpu_torch.data.padding import bucket_len
from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
from lightningdot_tpu_torch.models.cross_encoder import CrossEncoder
from lightningdot_tpu_torch.ops import launch_counts, reset_launch_counts
from lightningdot_tpu_torch.training.cross_scorer import CrossScorer
from lightningdot_tpu_torch.training.itm_step import make_itm_train_step
from lightningdot_tpu_torch.training.optim import make_optimizer
from lightningdot_tpu_torch.utils import tracing

KERNELS = ["layernorm", "layernorm_bwd", "attention", "ffn", "ffn_mma",
           "ffn_int8", "ffn_dh1", "ffn_dh1_mma", "adamw",
           "attention_train_fwd", "attention_train_bwd",
           "attention_train_bwd_mma", "rmsnorm", "rmsnorm_bwd",
           "mla_attention", "mla_attention_bwd", "rope", "moe_gemm",
           "moe_combine", "moe_scatter_rows", "moe_route_grad"]
SMALL = dict(vocab_size=300, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=128, img_dim=16)
STEP_PHASES = ["step.to_device", "step.forward", "step.backward",
               "step.optimizer"]


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with no records and no launches counted,
    so that the launch counters other test files read stay zero."""
    tracing.clear()
    reset_launch_counts()
    yield
    tracing.clear()
    reset_launch_counts()


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_nothing_is_recorded_with_recording_off():
    with tracing.span("outer") as s:
        tracing.count("n", 3)
        tracing.launched("ffn")
    assert s is None and tracing.records() == []
    assert tracing.span("a") is tracing.span("b")     # one shared context
    assert launch_counts()["ffn"] == 1


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_nested_spans_carry_parent_thread_and_id(how):
    ctx = (profile(activities=[ProfilerActivity.CPU]) if how == "profiler"
           else tracing.recording())
    with ctx:
        with tracing.span("call"):
            with tracing.span("call.a"):
                with tracing.span("call.a.b"):
                    pass
            with tracing.span("call.c", id=77):
                pass
        with tracing.span("other", id=5):
            pass
    with tracing.span("after"):
        pass
    recs = tracing.records()
    assert [r.name for r in recs] == ["call", "call.a", "call.a.b", "call.c",
                                      "other"]
    call, a, b, c, other = recs
    me = threading.get_ident()
    assert {r.thread for r in recs} == {me}
    assert (call.parent, a.parent, b.parent, c.parent, other.parent) == (
        None, call.index, a.index, call.index, None)
    assert call.id == a.id == b.id == call.index
    assert (c.id, other.id) == (77, 5)
    for inner, outer in ((a, call), (b, a), (c, call)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= \
            outer.end_ns
    assert a.end_ns <= c.start_ns


def test_count_lands_on_the_innermost_span_of_its_own_thread():
    opened, counted = threading.Event(), threading.Event()

    def other():
        with tracing.span("worker"):
            opened.set()
            tracing.count("items", 2)
            counted.wait(10)

    with tracing.recording():
        t = threading.Thread(target=other)
        with tracing.span("outer"):
            t.start()
            assert opened.wait(10)
            tracing.count("items", 1)
            with tracing.span("inner"):
                tracing.count("items", 5)
                tracing.count("bytes", 7)
            counted.set()
        t.join(10)
    assert not t.is_alive()
    tracing.count("items", 100)                 # no open span: dropped
    recs = {r.name: r for r in tracing.records()}
    assert recs["outer"].counts == {"items": 1}
    assert recs["inner"].counts == {"items": 5, "bytes": 7}
    assert recs["worker"].counts == {"items": 2}
    assert recs["worker"].thread != recs["outer"].thread
    assert recs["worker"].parent is None


def test_count_lands_on_the_spans_of_the_thread_it_is_given():
    """A backward on the card runs on autograd's device thread while the
    caller waits inside a span (``ops.matmul.mm_round``'s backward): it
    counts on the caller's open spans."""
    with tracing.recording():
        with tracing.span("caller"):
            spans = tracing.open_spans()
            t = threading.Thread(
                target=lambda: tracing.count("rounded_products", 3, spans))
            t.start()
            t.join(10)
            assert not t.is_alive()
        t = threading.Thread(
            target=lambda: tracing.count("rounded_products", 5, spans))
        t.start()                               # nothing open: dropped
        t.join(10)
        assert not t.is_alive()
    assert [r.counts for r in tracing.records()] == [
        {"rounded_products": 3}]


def test_the_buffer_drops_the_oldest_records_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "_STATE", tracing._State(capacity=4))
    with tracing.recording():
        for i in range(7):
            with tracing.span(f"s{i}"):
                pass
    assert [r.name for r in tracing.records()] == ["s3", "s4", "s5", "s6"]
    assert tracing.dropped() == 3
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_wall_offset_puts_a_span_on_the_wall_clock():
    before = time.time_ns()
    with tracing.recording():
        with tracing.span("now"):
            pass
    after = time.time_ns()
    (rec,) = tracing.records()
    start = rec.start_ns + tracing.wall_offset_ns()
    assert before - 1_000_000 <= start <= after + 1_000_000


def test_launch_counts_read_the_module_and_land_on_open_spans():
    """A launch counts on the spans open meanwhile on launching threads: a
    backward's, made on another thread (autograd's on the card), on the
    span its caller waits in; none on a thread that launches nothing."""
    assert list(launch_counts()) == KERNELS
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    opened, done = threading.Event(), threading.Event()

    def collate():
        with tracing.span("collate"):
            opened.set()
            done.wait(10)

    def backward():
        tracing.launched("ffn_dh1")
        tracing.launched("ffn_dh1")

    with tracing.recording():
        loader = threading.Thread(target=collate)
        loader.start()
        assert opened.wait(10)
        with tracing.span("step"):
            tracing.launched("ffn")
            with tracing.span("step.backward"):
                autograd = threading.Thread(target=backward)
                autograd.start()
                autograd.join(10)
        done.set()
        loader.join(10)
        with tracing.span("idle"):
            pass
    assert not loader.is_alive() and not autograd.is_alive()
    counts = launch_counts()
    assert counts == dict(dict.fromkeys(KERNELS, 0), ffn=1, ffn_dh1=2)
    recs = {r.name: r for r in tracing.records()}
    assert recs["step"].counts == {"launches": 3}
    assert recs["step.backward"].counts == {"launches": 2}
    assert recs["idle"].counts == recs["collate"].counts == {}
    reset_launch_counts()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _item(rng, i, n_neg=0):
    def img(j):
        n = int(rng.integers(3, 30))
        return {"fname": j, "img_feat": rng.random((n, 16), np.float32),
                "img_pos_feat": rng.random((n, 7), np.float32),
                "num_bb": n, "caption_ids": None}

    def ids():
        return [101] + list(rng.integers(200, 300,
                                         int(rng.integers(2, 20)))) + [102]

    return {"txt_id": i, "input_ids": ids(), "img": img(i),
            "neg_imgs": [img(100 + j) for j in range(n_neg)] if n_neg
            else None,
            "neg_txts": [ids() for _ in range(n_neg)] if n_neg else None}


def _real_positions(batch, n_neg):
    """The mask positions of the real items' rows: positives first, then
    the negatives item by item; fixed-batch copies come after each."""
    bs, n = batch["sample_size"], batch["n_valid"]
    total = 0
    for sub in ("txts", "imgs"):
        mask = batch[sub]["attention_mask"]
        total += int(mask[:n].sum() + mask[bs:bs + n * n_neg].sum())
    return total


@pytest.mark.parametrize("n_items, fixed, n_neg", [(3, 4, 0), (4, 0, 1),
                                                   (2, 3, 2)])
def test_collate_counts_padded_and_real_positions(n_items, fixed, n_neg):
    rng = np.random.default_rng(n_items)
    items = [_item(rng, i, n_neg) for i in range(n_items)]
    with tracing.recording():
        with tracing.span("collate"):
            batch = itm_fast_collate(items, CollateConfig(fixed_batch=fixed))
    (rec,) = tracing.records()
    assert rec.counts["positions"] == (batch["txts"]["input_ids"].size
                                       + batch["imgs"]["attention_mask"].size)
    assert rec.counts["real_positions"] == _real_positions(batch, n_neg)
    assert rec.counts["real_positions"] < rec.counts["positions"]


def _arrays(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _arrays(v)
    elif isinstance(x, np.ndarray):
        yield x


def test_itm_step_feed_and_phases_are_spans_in_order():
    torch.manual_seed(0)
    model = BiEncoder(EncoderConfig(**SMALL, project_dim=8),
                      EncoderConfig(**SMALL, project_dim=8))
    model.train()
    step = make_itm_train_step(model, make_optimizer(model, 1e-3),
                               device="cpu")
    rng = np.random.default_rng(1)
    dataset = [_item(rng, i) for i in range(10)]
    loader = DataLoader(dataset, batch_size=4, collate_fn=functools.partial(
        itm_fast_collate, cfg=CollateConfig(fixed_batch=4)))
    hosts = []
    with tracing.recording():
        for batch in DevicePrefetcher(loader, put=PinnedStager("cpu")):
            hosts.append(batch.host)
            step(batch, torch.Generator().manual_seed(len(hosts)))
    recs = tracing.records()
    me = threading.get_ident()

    collates = _by_name(recs, "loader.collate")
    assert [r.id for r in collates] == [0, 1, 2]
    assert all(r.thread != me and r.parent is None for r in collates)
    for r, host in zip(collates, hosts):
        assert r.counts["positions"] == (host["txts"]["input_ids"].size
                                         + host["imgs"]["attention_mask"]
                                         .size)
        assert r.counts["real_positions"] == _real_positions(host, 0)
    assert hosts[-1]["n_valid"] == 2          # the short batch's copies pad
    waits = _by_name(recs, "loader.wait")
    assert [r.id for r in waits][:3] == [0, 1, 2]
    assert all(r.thread == me for r in waits)
    stages = _by_name(recs, "stage")
    assert [r.counts["bytes"] for r in stages] == [
        sum(a.nbytes for a in _arrays(h)) for h in hosts]

    mine = [r for r in recs if r.thread == me]
    steps = _by_name(mine, "step")
    assert len(steps) == 3
    for s in steps:
        children = [r for r in mine if r.parent == s.index]
        assert [r.name for r in children] == STEP_PHASES
        assert all(r.id == s.id and s.start_ns <= r.start_ns
                   and r.end_ns <= s.end_ns for r in children)
    # the feed of batch k+1 is staged before step k runs
    names = [r.name for r in mine if r.parent is None]
    assert names[:5] == ["loader.wait", "stage", "loader.wait", "stage",
                         "step"]


def test_cross_scorer_blocks_are_spans_in_order():
    torch.manual_seed(0)
    scorer = CrossScorer(CrossEncoder(EncoderConfig(**SMALL)), pair_block=4,
                         device="cpu")
    rng = np.random.default_rng(2)
    items = [_item(rng, i) for i in range(10)]
    toks = [it["input_ids"] for it in items]
    feats = [it["img"]["img_feat"] for it in items]
    boxes = [it["img"]["img_pos_feat"] for it in items]
    with tracing.recording():
        scores = scorer.score_pairs(toks, feats, boxes)
    assert scores.shape == (10,)
    recs = tracing.records()
    call = recs[0]
    assert call.name == "score.call" and call.counts["pairs"] == 10
    children = [r for r in recs if r.parent == call.index]
    assert [r.name for r in children] == (
        ["score.collate", "score.stage", "score.launch"] * 3
        + ["score.pull"])
    assert all(r.id == call.id for r in children)
    (stage0,) = [r for r in recs if r.parent == children[1].index]
    assert stage0.name == "stage" and stage0.counts["bytes"] > 0
    # blocks are cut from the pairs in order of (text rung, region count)
    order = sorted(range(10), key=lambda i: (
        bucket_len(len(toks[i]), scorer.txt_buckets), feats[i].shape[0]))
    for k, rec in enumerate(_by_name(recs, "score.collate")):
        part = order[4 * k:4 * k + 4]
        host = scorer.block([toks[i] for i in part], [feats[i] for i in part],
                            [boxes[i] for i in part])
        assert rec.counts["positions"] == host["attn_masks"].size
        assert rec.counts["real_positions"] == sum(
            len(toks[i]) + feats[i].shape[0] for i in part)
    last = _by_name(recs, "score.collate")[-1]
    assert last.counts["real_positions"] < last.counts["positions"] / 2
