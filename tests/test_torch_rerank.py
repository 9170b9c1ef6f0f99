"""The port's re-ranking path (``training/cross_scorer.py``,
``cli/inf_itm.py``, ``cli/rerank.py``, ``load_cross_encoder``) against the
JAX package's (tests/test_rerank_e2e.py's cases) on the same weights.

Sizes: ``make_synth_dataset`` DBs of 10 images x 2 captions (img_dim 32,
5-10 regions), the tiny BERT (hidden 32, 2 layers, 4 heads, vocab 28,996)
for both the bi-encoder and the cross-encoder, weights from the JAX
package with std-0.2 noise, written once as reference-layout ``.pt`` files
that both packages read. float32. Tolerances: pair scores and the score
matrix within 1e-5; recall dicts equal.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig as JCfg
from lightningdot_tpu.data.synth import make_synth_dataset
from lightningdot_tpu.data.txt_db import TxtTokDb as JTxtTokDb
from lightningdot_tpu.models import checkpoint_torch as jckpt
from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder
from lightningdot_tpu.models.cross_encoder import CrossEncoder as JCross
from lightningdot_tpu.training.cross_scorer import CrossScorer as JScorer
from lightningdot_tpu_torch.cli import inf_itm, rerank
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.padding import bucket_len
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.models.factory import load_cross_encoder
from lightningdot_tpu_torch.training.checkpoints import save_checkpoint
from lightningdot_tpu_torch.training.cross_scorer import CrossScorer
from lightningdot_tpu_torch.utils import tracing

SMALL = {"vocab_size": 28996, "hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 64,
         "max_position_embeddings": 64, "img_dim": 32,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
ATOL = 1e-5


def _noisy(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.2 * r.standard_normal(
        x.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The DBs, a model config, a cross-encoder .pt and a bi-encoder .pt
    (the reference's layouts), and the JAX cross-encoder."""
    root = tmp_path_factory.mktemp("rr")
    txt_dir, img_dir = make_synth_dataset(
        str(root / "db"), n_imgs=10, txts_per_img=2, img_dim=32, min_bb=5,
        max_bb=10, max_txt_len=20, seed=3)
    cfg = str(root / "small.json")
    with open(cfg, "w") as f:
        json.dump(SMALL, f)
    jcfg = JCfg(**SMALL)
    jce = JCross(jcfg)
    ce_params = _noisy(jce.init(jax.random.PRNGKey(0)), 1)
    jckpt.save_cross_encoder_pt(str(root / "ce.pt"), ce_params)
    jbi = JBiEncoder(jcfg, jcfg)
    jckpt.save_biencoder_pt(str(root / "bi.pt"),
                            _noisy(jbi.init(jax.random.PRNGKey(2)), 3))
    return dict(root=root, txt=txt_dir, img=img_dir, cfg=cfg, jce=jce,
                ce_params=jax.tree.map(jnp.asarray, ce_params))


def _pairs(world, n):
    tdb = TxtTokDb(world["txt"], -1)
    idb = DetectFeatDb(world["img"], 0.2, 10, 5)
    ids = list(tdb.ids)[:n]
    toks = [tdb.combine_inputs(tdb[t]["input_ids"]) for t in ids]
    imgs = sorted(tdb.img2txts)
    feats = [idb.get_img_feat(imgs[i % len(imgs)]) for i in range(n)]
    return toks, [f for f, _, _ in feats], [p for _, p, _ in feats]


@pytest.mark.parametrize("use_itm_head", [False, True])
def test_cross_scorer_matches_jax(world, use_itm_head):
    toks, feats, poss = _pairs(world, 19)     # a ragged last block
    model = load_cross_encoder(str(world["root"] / "ce.pt"),
                               model_config=world["cfg"], device="cpu")
    got = CrossScorer(model, pair_block=8, use_itm_head=use_itm_head,
                      device="cpu").score_pairs(toks, feats, poss)
    want = JScorer(world["jce"], world["ce_params"], pair_block=8,
                   use_itm_head=use_itm_head).score_pairs(toks, feats, poss)
    assert got.shape == (19,) and np.ptp(want) > 0.05
    np.testing.assert_allclose(got, want, atol=ATOL)


def _ragged_pairs(seed, n, txt_lens, regions):
    """``n`` pairs in shuffled order: captions of ``txt_lens`` tokens and
    images of ``regions`` regions (img_dim 32), both drawn from ranges."""
    r = np.random.default_rng(seed)
    toks, feats, poss = [], [], []
    for _ in range(n):
        length = int(r.integers(*txt_lens))
        toks.append([101] + r.integers(1000, 20000, length - 2).tolist()
                    + [102])
        nb = int(r.integers(*regions))
        feats.append(r.random((nb, 32), np.float32))
        poss.append(r.random((nb, 7), np.float32))
    return toks, feats, poss


def _scorer_seeing_blocks(world, pair_block):
    """A CPU scorer whose ``block`` records each launched block's pairs
    (text lengths and region counts) and its padded (L, R), as the
    benchmark's runner wraps it."""
    model = load_cross_encoder(str(world["root"] / "ce.pt"),
                               model_config=world["cfg"], device="cpu")
    scorer = CrossScorer(model, pair_block=pair_block, device="cpu")
    seen, make_block = [], scorer.block

    def observed(toks, feats, poss):
        host = make_block(toks, feats, poss)
        seen.append(([len(t) for t in toks], [f.shape[0] for f in feats],
                     host["input_ids"].shape[1],
                     host["img_feat"].shape[1]))
        return host

    scorer.block = observed
    return scorer, seen, make_block


def _consecutive_positions(make_block, toks, feats, poss, b):
    """The joint positions of each block cut in input order."""
    return [make_block(toks[st:st + b], feats[st:st + b],
                       poss[st:st + b])["attn_masks"].shape
            for st in range(0, len(toks), b)]


def test_sorted_blocks_return_scores_in_input_order(world):
    toks, feats, poss = _ragged_pairs(5, 29, (4, 41), (5, 61))
    model = load_cross_encoder(str(world["root"] / "ce.pt"),
                               model_config=world["cfg"], device="cpu")
    scorer = CrossScorer(model, pair_block=8, device="cpu")
    got = scorer.score_pairs(toks, feats, poss)       # a ragged last block
    alone = np.array([scorer.score_pairs([t], [f], [p])[0]
                      for t, f, p in zip(toks, feats, poss)])
    assert got.shape == (29,) and np.ptp(alone) > 0.05
    np.testing.assert_allclose(got, alone, atol=ATOL)


def test_sorted_blocks_pad_to_their_own_rungs(world):
    toks, feats, poss = _ragged_pairs(6, 45, (4, 41), (5, 61))
    scorer, seen, make_block = _scorer_seeing_blocks(world, 8)
    with tracing.recording():
        scorer.score_pairs(toks, feats, poss)
    collates = [r for r in tracing.records() if r.name == "score.collate"]
    assert len(seen) == len(collates) == 6
    keys = []
    for lens, regs, L, R in seen:
        assert L == bucket_len(max(lens), scorer.txt_buckets)
        assert R == bucket_len(max(regs), scorer.img_buckets)
        keys += [(bucket_len(n, scorer.txt_buckets), r)
                 for n, r in zip(lens, regs)]
    assert keys == sorted(keys)       # the blocks follow one sorted order
    assert sum(r.counts["real_positions"] for r in collates) == sum(
        len(t) + f.shape[0] for t, f in zip(toks, feats))
    consecutive = _consecutive_positions(make_block, toks, feats, poss, 8)
    assert sum(r.counts["positions"] for r in collates) < sum(
        b * s for b, s in consecutive)


def test_one_rung_call_launches_the_consecutive_shapes(world):
    toks, feats, poss = _ragged_pairs(7, 21, (17, 33), (41, 49))
    scorer, seen, make_block = _scorer_seeing_blocks(world, 8)
    scorer.score_pairs(toks, feats, poss)
    launched = [(8, L + R) for _, _, L, R in seen]
    assert launched == [(8, 32 + 48)] * 3
    assert launched == _consecutive_positions(make_block, toks, feats, poss,
                                              8)


def _teacher_dir(world):
    """The teacher directory of the port (config.json + model.pt)."""
    d = world["root"] / "teacher_port"
    if not (d / "config.json").exists():
        model = load_cross_encoder(str(world["root"] / "ce.pt"),
                                   model_config=world["cfg"], device="cpu")
        os.makedirs(d, exist_ok=True)
        (d / "config.json").write_text(json.dumps(SMALL))
        save_checkpoint(str(d / "model"), model=model)
    return str(d)


def test_teacher_directories_read_across_packages(world):
    from lightningdot_tpu.models.factory import load_cross_encoder as jload
    from lightningdot_tpu.training.checkpoints import (
        save_checkpoint as jsave)

    toks, feats, poss = _pairs(world, 8)
    jmodel, jparams = jload(_teacher_dir(world))
    want = JScorer(world["jce"], world["ce_params"], pair_block=8
                   ).score_pairs(toks, feats, poss)
    np.testing.assert_allclose(
        JScorer(jmodel, jparams, pair_block=8).score_pairs(toks, feats, poss),
        want, atol=ATOL)
    jdir = world["root"] / "teacher_jax"
    os.makedirs(jdir, exist_ok=True)
    (jdir / "config.json").write_text(json.dumps(SMALL))
    jsave(str(jdir / "model"), model=world["ce_params"])   # model.npz
    model = load_cross_encoder(str(jdir), device="cpu")
    np.testing.assert_allclose(
        CrossScorer(model, pair_block=8, device="cpu").score_pairs(
            toks, feats, poss), want, atol=ATOL)


def _inf(mod, world, out, checkpoint):
    return mod.main(["--txt_db", world["txt"], "--img_db", world["img"],
                     "--checkpoint", checkpoint, "--model_config",
                     world["cfg"], "--output_dir", str(out), "--max_bb",
                     "10", "--min_bb", "5", "--batch_size", "16",
                     "--compute_dtype", "f32"]
                    + (["--device", "cpu"] if mod is inf_itm else []))


def _rerank(mod, world, *extra):
    out = mod.main(["--txt_model_config", world["cfg"], "--img_model_config",
                    world["cfg"], "--test_txt_db", world["txt"],
                    "--test_img_db", world["img"], "--valid_batch_size", "8",
                    "--max_bb", "10", "--min_bb", "5", "--compute_dtype",
                    "f32", "--biencoder_checkpoint",
                    str(world["root"] / "bi.pt"), *extra]
                   + (["--device", "cpu"] if mod is rerank else []))
    return json.loads(json.dumps(out, default=float))


def test_inf_itm_and_rerank_from_the_score_file_match_jax(world, tmp_path):
    from lightningdot_tpu.cli import inf_itm as jinf
    from lightningdot_tpu.cli import rerank as jrerank

    ce = str(world["root"] / "ce.pt")
    got_log, got_bin = _inf(inf_itm, world, tmp_path / "port", ce)
    want_log, want_bin = _inf(jinf, world, tmp_path / "jax", ce)
    assert got_log == want_log
    with open(got_bin, "rb") as f:
        got_mat, got_t, got_i = pickle.load(f)
    with open(want_bin, "rb") as f:
        want_mat, want_t, want_i = pickle.load(f)
    assert (got_t, got_i) == (want_t, want_i)
    assert got_mat.shape == (20, 10)
    np.testing.assert_allclose(got_mat, want_mat, atol=ATOL)
    # each package's rerank reads the other's results.bin
    want = _rerank(jrerank, world, "--score_file", want_bin)
    assert _rerank(rerank, world, "--score_file", want_bin) == want
    assert _rerank(rerank, world, "--score_file", got_bin) == want
    assert _rerank(jrerank, world, "--score_file", got_bin) == want
    assert "rerank_txt_top100" in want and "stage1_txt" in want


def test_rerank_on_the_fly_matches_jax(world):
    from lightningdot_tpu.cli import rerank as jrerank

    teacher = _teacher_dir(world)
    got = _rerank(rerank, world, "--teacher_checkpoint", teacher)
    want = _rerank(jrerank, world, "--teacher_checkpoint", teacher)
    assert got == want and "rerank_img_top10" in got


def test_rerank_with_oracle_scores_recovers_candidates(world, tmp_path):
    txt_db = JTxtTokDb(world["txt"], -1)
    txt_ids = list(txt_db.ids)
    img_ids = sorted({txt_db.txt2img[t] for t in txt_ids})
    mat = np.zeros((len(txt_ids), len(img_ids)), np.float32)
    for i, t in enumerate(txt_ids):
        mat[i, img_ids.index(txt_db.txt2img[t])] = 1.0
    oracle = str(tmp_path / "results.bin")
    with open(oracle, "wb") as f:
        pickle.dump((mat, txt_ids, img_ids), f)
    out = _rerank(rerank, world, "--score_file", oracle)
    assert out["rerank_img_top10"]["1"] == pytest.approx(
        out["stage1_img"]["10"], abs=1e-9)
    assert out["rerank_img_top100"]["1"] == pytest.approx(
        out["stage1_img"]["100"], abs=1e-9)


def test_rerank_entry_points_run_on_the_card_by_default(world, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ce = str(world["root"] / "ce.pt")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_cross_encoder(ce, model_config=world["cfg"])
    model = load_cross_encoder(ce, model_config=world["cfg"], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CrossScorer(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inf_itm.main(["--txt_db", world["txt"], "--img_db", world["img"],
                      "--checkpoint", ce, "--model_config", world["cfg"],
                      "--output_dir", str(tmp_path), "--max_bb", "10",
                      "--min_bb", "5"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rerank.main(["--txt_model_config", world["cfg"],
                     "--img_model_config", world["cfg"], "--test_txt_db",
                     world["txt"], "--test_img_db", world["img"],
                     "--max_bb", "10", "--min_bb", "5",
                     "--teacher_checkpoint", _teacher_dir(world)])


class _Captured(Exception):
    pass


@pytest.mark.parametrize("cli", ["rerank", "train_itm"])
def test_teacher_computes_in_float32_as_jax(world, monkeypatch, tmp_path,
                                            cli):
    """The cross-encoder teacher of ``cli/rerank.py`` and
    ``cli/train_itm.py --teacher_checkpoint`` computes in float32 whatever
    ``--compute_dtype`` is, as JAX's does (cli/train_itm.py:54-59,
    cli/rerank.py), and scores as JAX's teacher: under ``--compute_dtype
    bf16`` the loaded teacher is float32 and its scores are the JAX
    float32 teacher's within 1e-5."""
    from lightningdot_tpu_torch.cli import train_itm

    mod = rerank if cli == "rerank" else train_itm
    got = []
    real = mod.load_cross_encoder

    def capture(*a, **k):
        got.append(real(*a, **k))
        if cli == "train_itm":
            raise _Captured
        return got[-1]

    monkeypatch.setattr(mod, "load_cross_encoder", capture)
    teacher = _teacher_dir(world)
    if cli == "rerank":
        _rerank(rerank, world, "--teacher_checkpoint", teacher,
                "--compute_dtype", "bf16")
    else:
        with pytest.raises(_Captured):
            train_itm.main([
                "--txt_model_config", world["cfg"], "--img_model_config",
                world["cfg"], "--itm_global_file", "", "--img_checkpoint",
                "none", "--train_txt_dbs", world["txt"], "--train_img_dbs",
                world["img"], "--val_txt_db", world["txt"], "--val_img_db",
                world["img"], "--teacher_checkpoint", teacher,
                "--compute_dtype", "bf16", "--output_dir", str(tmp_path),
                "--device", "cpu"])
    (model,) = got
    assert model.compute_dtype == torch.float32
    toks, feats, poss = _pairs(world, 8)
    want = JScorer(world["jce"], world["ce_params"], pair_block=8
                   ).score_pairs(toks, feats, poss)
    np.testing.assert_allclose(
        CrossScorer(model, pair_block=8, device="cpu").score_pairs(
            toks, feats, poss), want, atol=ATOL)
