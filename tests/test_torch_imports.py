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
    ROOT / "chip_smoke.py", ROOT / "scripts" / "bench_torch_serving.py",
    ROOT / "examples" / "demo_retrieval_torch.py",
    ROOT / "examples" / "serve_http_torch.py"],
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


def test_misc_copies_match_jax():
    """utils/misc.py: the parameter count and the model comparison of the
    JAX package's (test_serving.py:100), on the same weights, and
    ``host_all_gather`` of one process."""
    import jax

    from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder
    from lightningdot_tpu.utils import misc as jmisc
    from lightningdot_tpu_torch.models import (BiEncoder, load_tower_,
                                               tower_state_dict_from_jax)
    from lightningdot_tpu_torch.utils import misc

    jparams = JBiEncoder(JEncoderConfig(**SMALL), JEncoderConfig(
        **SMALL, img_dim=16)).init(jax.random.PRNGKey(0))
    model = BiEncoder(EncoderConfig(**SMALL))
    load_tower_(model.txt_model, tower_state_dict_from_jax(
        jax.tree.map(np.asarray, jparams["txt_model"])))
    assert misc.num_of_parameters(model) == jmisc.num_of_parameters(
        jparams["txt_model"])
    sd = model.state_dict()
    other = {k: v.clone() for k, v in sd.items()}
    assert misc.compare_models(sd, other, verbose=False) == 0
    other["txt_model.bert.pooler.dense.bias"] += 1.0
    assert misc.compare_models(sd, other, verbose=False) == 1
    assert misc.host_all_gather({"a": 1}) == jmisc.host_all_gather(
        {"a": 1}) == [{"a": 1}]
    twin = BiEncoder(EncoderConfig(**SMALL))
    twin.load_state_dict(sd)
    assert misc.state_digest(twin) == misc.state_digest(model)
    twin.load_state_dict(other)
    assert misc.state_digest(twin) != misc.state_digest(model)


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
    # the port registers only the flags it reads: not the TPU knob, nor
    # flags no driver reads; the mesh size comes with the drivers that
    # train across processes (add_dist_params)
    unread = {"kernel_backend", "dp_size",
              "steps_per_hard_neg", "seperate_caption_encoder",
              "n_workers", "img_meta", "fp16", "negative_size",
              "compressed_db", "project_name", "expr_name_prefix"}
    assert vars(want).keys() - vars(got).keys() == unread


# the JAX CLIs' flags that the port's do not register: the option
# groups' unread flags (above) and, in rerank, the logging and KD groups,
# which it never reads; train_teacher's validation DBs, which neither
# package reads
_GROUPS_UNREAD = {"kernel_backend", "dp_size",
                  "steps_per_hard_neg", "seperate_caption_encoder",
                  "n_workers", "img_meta", "fp16", "negative_size",
                  "compressed_db", "project_name", "expr_name_prefix"}


@pytest.mark.parametrize("name,unread", [
    ("rerank", _GROUPS_UNREAD | {"log_result_step", "save_all_epochs",
                                 "sim_preempt_step", "preempt_check_steps",
                                 "T", "kd_loss_weight"}),
    ("inf_itm", set()),
    ("train_teacher", {"val_txt_db", "val_img_db"})])
def test_cross_encoder_cli_flags_match_jax(name, unread):
    """Each A9 CLI registers the JAX CLI's flags with their defaults, less
    the flags nothing reads, plus ``--device`` (and, in train_teacher,
    which trains across processes, ``--dist_backend``)."""
    import importlib

    def flags(mod):
        parser = importlib.import_module(f"{mod}.cli.{name}").build_parser()
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    got, want = flags("lightningdot_tpu_torch"), flags("lightningdot_tpu")
    port_only = {"device"} | ({"dist_backend"} if name == "train_teacher"
                              else set())
    assert got.keys() - want.keys() == port_only
    assert want.keys() - got.keys() == unread
    assert {k: got[k] for k in want.keys() & got.keys()} == \
        {k: want[k] for k in want.keys() & got.keys()}


@pytest.mark.parametrize("name,unread", [
    ("train_itm", _GROUPS_UNREAD - {"dp_size"}),
    ("pretrain", {"kernel_backend"})])
def test_training_cli_flags_match_jax(name, unread):
    """The drivers that train across processes register the JAX CLI's
    flags with their defaults (``--dp_size`` and ``--preempt_check_steps``
    among them), less the flags nothing reads, plus ``--device`` and
    ``--dist_backend`` (and train_itm's ``--vocab_file``)."""
    import importlib

    def flags(mod):
        parser = importlib.import_module(f"{mod}.cli.{name}").build_parser()
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    got, want = flags("lightningdot_tpu_torch"), flags("lightningdot_tpu")
    assert got.keys() - want.keys() == {"device", "dist_backend"} | (
        {"vocab_file"} if name == "train_itm" else set())
    assert want.keys() - got.keys() == unread
    assert {k: got[k] for k in want.keys() & got.keys()} == \
        {k: want[k] for k in want.keys() & got.keys()}


def test_pretraining_constants_match_jax():
    for name in ("IMG_LABEL_DIM", "BUCKET_SIZE"):
        assert getattr(const, name) == getattr(jconst, name), name


# ---------------------------------------------------------------------------
# data preparation (ROADMAP A12) and the VQA driver (A10)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(vqa_answers=9), dict(
    with_soft_labels=True, n_labels=11)], ids=["vqa", "soft_labels"])
def test_synth_copy_matches_jax(tmp_path, kw):
    """``make_synth_dataset`` writes the JAX function's records, read back
    through each package's readers; ``synth_wordpiece_vocab`` the same
    vocab."""
    from lightningdot_tpu.data import synth as jsynth
    from lightningdot_tpu.data.feat_db import DetectFeatDb as JFeatDb
    from lightningdot_tpu.data.txt_db import TxtTokDb as JTxtDb
    from lightningdot_tpu_torch.data import synth
    from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
    from lightningdot_tpu_torch.data.txt_db import TxtTokDb

    args = dict(n_imgs=5, txts_per_img=3, img_dim=8, min_bb=3, max_bb=7,
                max_txt_len=12, seed=4, **kw)
    got = synth.make_synth_dataset(str(tmp_path / "p"), **args)
    want = jsynth.make_synth_dataset(str(tmp_path / "j"), **args)
    for cls in (TxtTokDb, JTxtDb):
        a, b = cls(got[0], -1), cls(want[0], -1)
        assert a.ids == b.ids and all(a[i] == b[i] for i in b.ids)
    for cls in (DetectFeatDb, JFeatDb):
        a = cls(got[1], conf_th=0.2, max_bb=7, min_bb=3)
        b = cls(want[1], conf_th=0.2, max_bb=7, min_bb=3)
        assert a.name2nbb == b.name2nbb
        for name in b.name2nbb:
            got_arrays, want_arrays = a.get_dump(name), b.get_dump(name)
            assert got_arrays.keys() == want_arrays.keys()
            assert ("soft_labels" in want_arrays) == bool(
                kw.get("with_soft_labels"))
            for key, arr in want_arrays.items():
                np.testing.assert_array_equal(got_arrays[key], arr)
    pv = synth.synth_wordpiece_vocab(str(tmp_path / "pv.txt"), n_roots=50,
                                     n_conts=40, total=90, seed=2)
    jv = jsynth.synth_wordpiece_vocab(str(tmp_path / "jv.txt"), n_roots=50,
                                      n_conts=40, total=90, seed=2)
    assert pv == jv
    assert (tmp_path / "pv.txt").read_text() == \
        (tmp_path / "jv.txt").read_text()


def test_lz4_and_lmdb_copies_match_jax(tmp_path):
    from lightningdot_tpu.data import lz4frame as jlzf
    from lightningdot_tpu.data.lmdb_reader import open_lmdb as jopen
    from lightningdot_tpu_torch.data import lz4frame as lzf
    from lightningdot_tpu_torch.data.lmdb_reader import open_lmdb
    from tests.lmdb_fixture import write_lmdb
    from tests.test_lmdb_ingest import _stored_frame

    rng = np.random.default_rng(0)
    blob = rng.bytes(5000)
    frame = _stored_frame(blob)
    assert lzf.decompress(frame) == jlzf.decompress(frame) == blob
    assert lzf._py_decompress(frame) == blob
    assert lzf.content_size(frame) == jlzf.content_size(frame) == 5000
    assert lzf.xxh32(blob, 7) == jlzf.xxh32(blob, 7)
    items = {f"k{i:04d}".encode(): rng.bytes(int(rng.integers(1, 3000)))
             for i in range(300)}
    write_lmdb(str(tmp_path / "db"), items)
    with open_lmdb(str(tmp_path / "db"), backend="pure") as a, \
            jopen(str(tmp_path / "db"), backend="pure") as b:
        assert list(a.items()) == list(b.items())
        assert len(a) == len(b) == 300


def test_prepro_helper_copies_match_jax(tmp_path):
    """The tokenization of records, the meta, each annotation format's
    records, the generated-caption log parser and the msgpack_numpy
    decoder give the JAX CLI's outputs."""
    import json

    from lightningdot_tpu.cli import prepro as jprepro
    from lightningdot_tpu.data.synth import synth_wordpiece_vocab
    from lightningdot_tpu_torch.cli import prepro

    vocab = str(tmp_path / "vocab.txt")
    roots, conts = synth_wordpiece_vocab(vocab, n_roots=300, n_conts=200,
                                         total=600, seed=1)
    tok = prepro.get_tokenizer("bert-base-cased", vocab)
    jtok = jprepro.get_tokenizer("bert-base-cased", vocab)
    rng = np.random.default_rng(3)
    texts = [" ".join(roots[i] + (conts[j] if k else "")
                      for i, j, k in rng.integers(0, 200, (6, 3)))
             + " ." for _ in range(20)]
    for t in texts:
        assert prepro.bert_tokenize(tok, t) == jprepro.bert_tokenize(jtok, t)
    assert prepro.meta_for(tok) == jprepro.meta_for(jtok)
    images = [{"filename": f"COCO_val2014_{i:012d}.jpg", "sentences": [
        {"sentid": 10 * i + j, "raw": texts[(i + j) % 20]}
        for j in range(3)]} for i in range(4)]
    assert prepro.process_image_text_retrieval(
        images, tok, "coco", "val2014") == \
        jprepro.process_image_text_retrieval(images, jtok, "coco", "val2014")
    caps = {"annotations": [{"id": i, "image_id": 7 + i % 2,
                             "caption": texts[i]} for i in range(6)]}
    assert prepro.process_caption(caps, tok, "train2014") == \
        jprepro.process_caption(caps, jtok, "train2014")
    log = tmp_path / "rt.log"
    log.write_text("\n".join(texts[:5] + ["", "image 42.jpg:"]
                             + texts[5:10] + ["", "image 7.jpg:"]))
    assert prepro.parse_rt_log(str(log)) == jprepro.parse_rt_log(str(log))
    arr = np.arange(6, dtype=np.float16).reshape(2, 3)
    rec = {b"features": {b"nd": True, b"type": b"<f2", b"kind": b"",
                         b"shape": [2, 3], b"data": arr.tobytes()},
           b"name": [b"x", {b"nested": 1}]}
    got = prepro._decode_msgpack_numpy(rec)
    want = jprepro._decode_msgpack_numpy(rec)
    np.testing.assert_array_equal(got["features"], want["features"])
    assert json.dumps(got["name"], default=str) == \
        json.dumps(want["name"], default=str)


def _prepro_flags(main):
    """{task: {flag: default}} of a prepro CLI's parser, read by stopping
    ``main`` at its parse."""
    import argparse

    class Got(Exception):
        pass

    def grab(self, *a, **k):
        raise Got(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        main(["img"])
    except Got as e:
        parser = e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {task: {a.dest: (a.default, tuple(a.choices or ()))
                   for a in p._actions if a.dest != "help"}
            for task, p in sub.choices.items()}


def test_vqa_and_prepro_cli_flags_match_jax():
    """``train_vqa`` registers the JAX CLI's flags with their defaults
    (``--dp_size`` among them, since it trains across processes), less the
    option groups' flags that nothing reads, plus ``--device`` and
    ``--dist_backend``; ``prepro`` has the JAX CLI's tasks, flags, defaults
    and choices."""
    from lightningdot_tpu.cli import prepro as jprepro
    from lightningdot_tpu.cli import train_vqa as jtrain_vqa
    from lightningdot_tpu_torch.cli import prepro, train_vqa

    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}

    got, want = (flags(m.build_parser()) for m in (train_vqa, jtrain_vqa))
    assert got.keys() - want.keys() == {"device", "dist_backend"}
    assert want.keys() - got.keys() == (_GROUPS_UNREAD - {"dp_size"}) \
        & want.keys()
    assert {k: got[k] for k in want.keys() & got.keys()} == \
        {k: want[k] for k in want.keys() & got.keys()}
    assert _prepro_flags(prepro.main) == _prepro_flags(jprepro.main)
