"""The port stands alone: it imports nothing of ``jax`` or
``lightningdot_tpu``, its own copies of the JAX package's JAX-free modules
give the originals' outputs, and its entry points run on the card unless
asked for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lightningdot_tpu import const as jconst
from lightningdot_tpu.config import EncoderConfig as JEncoderConfig
from lightningdot_tpu.data import itm as jitm
from lightningdot_tpu.data import padding as jpadding
from lightningdot_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from lightningdot_tpu_torch import const
from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.data import itm, padding
from lightningdot_tpu_torch.data.tokenizer import WordPieceTokenizer

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lightningdot_tpu_torch"
SMALL = dict(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=48, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)


def _port_modules():
    return sorted(PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "lightningdot_tpu")


@pytest.mark.parametrize("path", _port_modules() + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "bench_torch_serving.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    """An ``ast`` walk: no ``import``/``from`` of jax or lightningdot_tpu,
    at any depth of the file (function-level imports included)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    names = [".".join(p.relative_to(ROOT).with_suffix("").parts)
             for p in _port_modules()]
    names = [n[:-len(".__init__")] if n.endswith(".__init__") else n
             for n in names]
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightningdot_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=ROOT)


# ---------------------------------------------------------------------------
# The copies give the originals' outputs
# ---------------------------------------------------------------------------

def test_config_and_constants_copies_match_jax():
    path = str(ROOT / "configs" / "img_base.json")
    got = EncoderConfig.from_json_file(path)
    want = JEncoderConfig.from_json_file(path)
    assert got.to_dict() == want.to_dict()
    assert (got.head_dim, got.out_size) == (want.head_dim, want.out_size)
    assert EncoderConfig(project_dim=768).out_size == 768
    for name in ("IMG_DIM", "IMG_CLS_TOKEN_ID", "TXT_LEN_BUCKETS",
                 "IMG_LEN_BUCKETS", "CAP_LEN_BUCKETS"):
        assert getattr(const, name) == getattr(jconst, name), name


def test_padding_copies_match_jax():
    for ladder in (const.TXT_LEN_BUCKETS, const.IMG_LEN_BUCKETS,
                   const.CAP_LEN_BUCKETS):
        for n in range(0, ladder[-1] + 6):
            assert padding.bucket_len(n, ladder) == jpadding.bucket_len(
                n, ladder)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 99, rng.integers(1, 20)).tolist()
            for _ in range(5)]
    np.testing.assert_array_equal(padding.pad_ids(seqs, 16),
                                  jpadding.pad_ids(seqs, 16))
    np.testing.assert_array_equal(padding.pad_mask([3, 20, 0], 16),
                                  jpadding.pad_mask([3, 20, 0], 16))
    feats = [rng.standard_normal((n, 4)).astype(np.float16)
             for n in (3, 9, 1)]
    np.testing.assert_array_equal(padding.pad_feats(feats, 8),
                                  jpadding.pad_feats(feats, 8))
    np.testing.assert_array_equal(padding.position_ids(3, 7),
                                  jpadding.position_ids(3, 7))


CAPTIONS = ["A man riding a horse on the beach .",
            "Two dogs, playing in the snow; next to a fence!",
            "A café in Zürich (naïve) — 東京 at night",
            "unknownword and [MASK] tokens\tsplit\nacross lines"]


@pytest.mark.parametrize("native", [True, False])
def test_tokenizer_copy_matches_jax(tmp_path, native):
    words = sorted({w.strip(".,;!()") for c in CAPTIONS for w in c.split()})
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "##s", "##ing", "do",
                "##gs", "東", "京", "café", "(", ")", ",", ";", "!", "—"]
             + words)
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    got = WordPieceTokenizer(str(path), use_native=native)
    want = JTokenizer(str(path), use_native=native)
    assert got.native == want.native == native
    for text in CAPTIONS:
        assert got.encode(text) == want.encode(text)
        assert got.tokenize(text) == want.tokenize(text)
        assert got.encode_words(text) == want.encode_words(text)
    assert got.cls_token_id == 101 and got.vocab_size == want.vocab_size


def _item(rng, i, num_bb, negs=0, captions=False):
    def img(name, nbb):
        feat = rng.standard_normal((nbb, 16)).astype(np.float16)
        pos = rng.random((nbb, 7)).astype(np.float32)
        cap = (rng.integers(106, 999, rng.integers(5, 70)).tolist()
               if captions else None)
        return {"fname": name, "img_feat": feat, "img_pos_feat": pos,
                "num_bb": nbb, "caption_ids": cap}

    return {"txt_id": f"t{i}",
            "input_ids": rng.integers(106, 999, rng.integers(3, 40)).tolist(),
            "img": img(f"i{i}", num_bb),
            "neg_imgs": ([img(f"n{i}_{k}", num_bb) for k in range(negs)]
                         if negs else None),
            "neg_txts": ([rng.integers(106, 999, 9).tolist()
                          for _ in range(negs)] if negs else None)}


def _assert_same(got, want):
    assert type(got) is type(want) or (got is None and want is None)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("num_bb,negs,captions,fixed", [
    (36, 0, False, 0), (100, 0, False, 0), (36, 1, True, 6),
    (100, 2, False, 8)])
def test_itm_collate_copy_matches_jax(num_bb, negs, captions, fixed):
    rng = np.random.default_rng(num_bb + negs)
    items = [_item(rng, i, num_bb, negs, captions) for i in range(5)]
    got = itm.itm_fast_collate(items, itm.CollateConfig(fixed_batch=fixed))
    want = jitm.itm_fast_collate(items,
                                 jitm.CollateConfig(fixed_batch=fixed))
    _assert_same(got, want)
    assert got["imgs"]["attention_mask"].shape[1] == (64 if num_bb == 36
                                                      else 104)


@pytest.mark.parametrize("bs,n_teacher,num_bb", [(4, 2, 36), (6, 6, 100),
                                                 (5, 10, 36)])
def test_teacher_batch_copy_matches_jax(bs, n_teacher, num_bb):
    """``make_teacher_batch`` (the KD pair grid) against its original on
    one collated batch: every array equal, the feature grids pooled
    arrays (whole, so the pool and the stager take them), and a batch
    smaller than ``n_teacher`` refused by both."""
    rng = np.random.default_rng(bs)
    batch = itm.itm_fast_collate([_item(rng, i, num_bb) for i in range(bs)])
    if bs < n_teacher:
        for mod in (itm, jitm):
            with pytest.raises(ValueError, match="n_teacher"):
                mod.make_teacher_batch(batch, n_teacher)
        return
    got = itm.make_teacher_batch(batch, n_teacher)
    _assert_same(got, jitm.make_teacher_batch(batch, n_teacher))
    assert got["img_feat"].base is None and got["img_pos_feat"].base is None
    assert got["input_ids"].shape[0] == bs * n_teacher


def test_device_copies_read_pooled_arrays_through_their_pinned_tensor(
        monkeypatch):
    """The step helpers copy a pooled array through the page-locked tensor
    it views (``loader.host_tensor``), which torch's pinned allocator
    tracks, never through a bare ``from_numpy`` view of the same memory:
    an asynchronous copy from such a view is untracked, and the block
    could be handed out again while the copy still reads it (the
    validation batches of pre-training and the steps' own copies)."""
    from lightningdot_tpu_torch.data import loader
    from lightningdot_tpu_torch.training import itm_step, pretrain_step

    feat = np.zeros((2, 3), np.float32)
    through = torch.full((2, 3), 7.0)
    monkeypatch.setattr(loader, "pinned_tensor",
                        lambda a: through if a is feat else None)
    cpu = torch.device("cpu")
    got = pretrain_step.pretrain_batch_to_device(
        {"imgs": {"img_feat": feat}, "n_valid": 2}, cpu)
    assert torch.equal(got["imgs"]["img_feat"], through)
    got = itm_step.batch_to_device({"imgs": {"img_feat": feat}}, cpu)
    assert torch.equal(got["imgs"]["img_feat"], through)
    other = np.ones((2, 3), np.float32)
    assert torch.equal(loader.host_tensor(other), torch.ones(2, 3))


# ---------------------------------------------------------------------------
# Entry points: the card by default, the CPU when asked
# ---------------------------------------------------------------------------

class _Tok:
    cls_token_id = 101

    def encode(self, text):
        return [101] + [110 + len(w) for w in text.split()] + [102]


def _model():
    from lightningdot_tpu_torch.models import BiEncoder, init_tower_

    model = BiEncoder(EncoderConfig(**SMALL),
                      EncoderConfig(**SMALL, img_dim=16))
    gen = torch.Generator().manual_seed(0)
    init_tower_(model.txt_model, gen)
    init_tower_(model.img_model, gen)
    return model


def _batch():
    rng = np.random.default_rng(1)
    return itm.itm_fast_collate([_item(rng, i, 5) for i in range(3)])


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """With no card, Retriever, BatchEncoder and the trainer raise unless
    given ``device="cpu"``, and then they run."""
    from lightningdot_tpu_torch.serving import Retriever
    from lightningdot_tpu_torch.training.evaluator import BatchEncoder
    from lightningdot_tpu_torch.training.itm_step import make_itm_train_step
    from lightningdot_tpu_torch.training.optim import make_fused_adamw

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _model()
    opt = make_fused_adamw(model, 1e-4)
    for make in (lambda: Retriever(model, _Tok()),
                 lambda: BatchEncoder(model),
                 lambda: make_itm_train_step(model, opt)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    r = Retriever(model, _Tok(), device="cpu")
    r.set_corpus(["a", "b"], np.eye(2, 32, dtype=np.float32))
    assert len(r.retrieve_query("a dog", top=2)) == 2
    encoder = BatchEncoder(model, device="cpu")
    txt, img, _ = encoder(encoder.put(_batch()))
    assert txt.shape == img.shape == (3, 32) and txt.device.type == "cpu"
    model.train()
    step = make_itm_train_step(model, opt, device="cpu")
    metrics = step(_batch())
    assert np.isfinite(metrics["loss"].item())
    assert metrics["grad_norm"].device.type == "cpu"


def test_run_loadgen_copy_matches_jax():
    """The port's ``run_loadgen`` and the JAX package's drive the same
    native load generator against one native server (a stand-in device
    returning fixed arrays) and agree on what was served; a dead port
    raises in both."""
    from lightningdot_tpu.serving_native import run_loadgen as jrun
    from lightningdot_tpu_torch.serving_native import (NativeRetrievalServer,
                                                       run_loadgen)

    def retrieve(queries, k):
        n = len(queries)
        return (np.tile(np.arange(k, dtype=np.int32), (n, 1)),
                np.tile(np.linspace(1, 0, k, dtype=np.float32), (n, 1)))

    srv = NativeRetrievalServer([f"img_{i}" for i in range(50)], retrieve,
                                max_batch=8, max_top=10)
    try:
        got = run_loadgen(srv.port, rate=400, duration_s=0.5, conns=2,
                          top=10)
        want = jrun(srv.port, rate=400, duration_s=0.5, conns=2, top=10)
    finally:
        srv.stop()
    assert got.keys() == want.keys()
    for stats in (got, want):
        assert stats["errors"] == 0 and stats["completed"] >= 150
        assert stats["offered_per_s"] == 400
    for run in (run_loadgen, jrun):
        with pytest.raises(RuntimeError, match="ldloadgen failed"):
            run(srv.port, rate=100, duration_s=0.2, conns=1)


# ---------------------------------------------------------------------------
# the training drivers' copies: logging, preemption, config groups, const
# ---------------------------------------------------------------------------

def test_logging_copies_match_jax(tmp_path):
    """``RunningMeter`` (NaN guard included), ``MetricsLogger`` records and
    ``NoOp`` against lightningdot_tpu/utils/logging.py."""
    import json

    from lightningdot_tpu.utils import logging as jlog
    from lightningdot_tpu_torch.utils import logging as plog

    got, want = plog.RunningMeter("loss"), jlog.RunningMeter("loss")
    assert got.val == want.val == 0.0
    for v in (3.0, 2.5, float("nan"), 1.0):
        got(v)
        want(v)
        assert got.val == want.val and str(got) == str(want)
    records = []
    for mod, name in ((plog, "p.jsonl"), (jlog, "j.jsonl")):
        sink = mod.MetricsLogger()
        sink.log_metric("dropped", 1.0)      # no file yet: ignored
        sink.create(str(tmp_path / name))
        sink.set_step(5)
        sink.log_metric("loss", 2.0)
        sink.log_scalar_dict({"R@1": 0.5}, prefix="val")
        sink.log_metric("lr", 1e-4, step=9)
        with open(tmp_path / name) as f:
            records.append([{k: v for k, v in json.loads(line).items()
                             if k != "t"} for line in f])
    assert records[0] == records[1]
    assert plog.NoOp().anything(1, x=2) is None


def test_preemption_copy_matches_jax():
    from lightningdot_tpu.utils.preemption import PreemptionGuard as JGuard
    from lightningdot_tpu_torch.utils.preemption import PreemptionGuard

    got, want = PreemptionGuard(sim_after_step=4), JGuard(sim_after_step=4)
    assert ([got.check(s) for s in range(1, 7)]
            == [want.check(s) for s in range(1, 7)])
    assert got.sync() == want.sync()


def test_training_config_groups_match_jax():
    """All four option groups, as the training drivers register them:
    every port flag is a JAX flag with its default, and a reference
    config parses to the same values."""
    import argparse

    from lightningdot_tpu import config as jconfig
    from lightningdot_tpu_torch import config

    def parser(mod):
        p = argparse.ArgumentParser()
        for group in (mod.default_params, mod.add_itm_params,
                      mod.add_logging_params, mod.add_kd_params):
            group(p)
        return p

    cmds = ["--config", str(ROOT / "configs" / "coco_ft.json"),
            "--num_hard_negatives", "2", "--sample_init_hard_negatives",
            "--optim_state_dtype", "bfloat16", "--log_result_step", "7"]
    got = config.parse_with_config(parser(config), cmds)
    want = config.parse_with_config(parser(jconfig), cmds)
    assert vars(got).keys() <= vars(want).keys()
    assert vars(got) == {k: v for k, v in vars(want).items()
                         if k in vars(got)}
    # the port registers only the flags it reads: the TPU knob, the
    # multi-host ones (A11), and flags no driver reads
    unread = {"kernel_backend", "dp_size", "preempt_check_steps",
              "steps_per_hard_neg", "seperate_caption_encoder",
              "n_workers", "img_meta", "fp16", "negative_size",
              "compressed_db", "project_name", "expr_name_prefix"}
    assert vars(want).keys() - vars(got).keys() == unread


# the JAX CLIs' flags that the port's do not register: the option
# groups' unread flags (above) and, in rerank, the logging and KD groups,
# which it never reads; train_teacher's validation DBs, which neither
# package reads
_GROUPS_UNREAD = {"kernel_backend", "dp_size", "preempt_check_steps",
                  "steps_per_hard_neg", "seperate_caption_encoder",
                  "n_workers", "img_meta", "fp16", "negative_size",
                  "compressed_db", "project_name", "expr_name_prefix"}


@pytest.mark.parametrize("name,unread", [
    ("rerank", _GROUPS_UNREAD | {"log_result_step", "save_all_epochs",
                                 "sim_preempt_step", "T",
                                 "kd_loss_weight"}),
    ("inf_itm", set()),
    ("train_teacher", {"val_txt_db", "val_img_db"})])
def test_cross_encoder_cli_flags_match_jax(name, unread):
    """Each A9 CLI registers the JAX CLI's flags with their defaults, less
    the flags nothing reads, plus ``--device``."""
    import importlib

    def flags(mod):
        parser = importlib.import_module(f"{mod}.cli.{name}").build_parser()
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    got, want = flags("lightningdot_tpu_torch"), flags("lightningdot_tpu")
    assert got.keys() - want.keys() == {"device"}
    assert want.keys() - got.keys() == unread
    assert {k: got[k] for k in want.keys() & got.keys()} == \
        {k: want[k] for k in want.keys() & got.keys()}


def test_pretraining_constants_match_jax():
    for name in ("IMG_LABEL_DIM", "BUCKET_SIZE"):
        assert getattr(const, name) == getattr(jconst, name), name
