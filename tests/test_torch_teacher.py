"""The port's teacher training (``cli/train_teacher.py``,
``training/hn_teacher.py``, ``data/itm_rank.py`` and the ``data/itm.py``
candidate datasets) against the JAX package's (tests/test_train_teacher.py
and tests/test_teacher_hardneg.py's cases).

Sizes: ``make_synth_dataset`` DBs of 8 images x 2 captions (img_dim 32,
5-10 regions), the tiny BERT (hidden 32, 2 layers, 4 heads; the Fast image
stream 1 layer), dropout 0, float32. Both drivers start from one
reference-layout ``.pt`` of JAX weights with std-0.2 noise. Tolerances:
per-step losses within 1e-5 relative, final weights within 1e-4 relative
L2 per leaf; mined maps and dataset items equal.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig as JCfg
from lightningdot_tpu.data import feat_db as jfeat_db
from lightningdot_tpu.data import itm as jitm
from lightningdot_tpu.data import itm_rank as jrank
from lightningdot_tpu.data import txt_db as jtxt_db
from lightningdot_tpu.data.synth import make_synth_dataset
from lightningdot_tpu.models import checkpoint_torch as jckpt
from lightningdot_tpu.models.cross_encoder import (CrossEncoder as JCross,
                                                   CrossEncoderFast as JFast)
from lightningdot_tpu.training import hn_teacher as jhn
from lightningdot_tpu_torch.cli import train_teacher
from lightningdot_tpu_torch.data import feat_db, itm, itm_rank, txt_db
from lightningdot_tpu_torch.models.weights import (
    cross_encoder_fast_state_dict_from_jax, cross_encoder_state_dict_from_jax)
from lightningdot_tpu_torch.training import hn_teacher

SMALL = {"vocab_size": 28996, "hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 64,
         "max_position_embeddings": 64, "img_dim": 32,
         "num_hidden_layers_img": 1,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}


def _noisy(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.2 * r.standard_normal(
        x.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("teach")
    txt_dir, img_dir = make_synth_dataset(
        str(root / "db"), n_imgs=8, txts_per_img=2, img_dim=32, min_bb=5,
        max_bb=10, max_txt_len=20, seed=4)
    cfg = str(root / "small.json")
    with open(cfg, "w") as f:
        json.dump(SMALL, f)
    params = _noisy(JCross(JCfg(**SMALL)).init(jax.random.PRNGKey(0)), 1)
    jckpt.save_cross_encoder_pt(str(root / "ce.pt"), params)
    return dict(root=root, txt=txt_dir, img=img_dir, cfg=cfg, params=params)


def _dbs(world, jax_side, max_txt_len=60):
    t, f = (jtxt_db, jfeat_db) if jax_side else (txt_db, feat_db)
    return (t.TxtTokDb(world["txt"], max_txt_len),
            f.DetectFeatDb(world["img"], 0.2, 10, 5))


def _run(world, out, variant, jax_side, checkpoint, steps=6):
    args = ["--model_config", world["cfg"], "--train_txt_db", world["txt"],
            "--train_img_db", world["img"], "--output_dir", str(out),
            "--checkpoint", checkpoint, "--learning_rate", "1e-3",
            "--num_train_steps", str(steps), "--warmup_steps", "2",
            "--valid_steps", "3", "--max_bb", "10", "--min_bb", "5",
            "--compute_dtype", "f32", "--seed", "5"]
    args += {"joint": ["--neg_sample_size", "1", "--train_batch_size", "2"],
             "hard_neg": ["--neg_sample_size", "1", "--hard_neg_size", "1",
                          "--hard_neg_pool_size", "3",
                          "--inf_minibatch_size", "4",
                          "--steps_per_hard_neg", "3",
                          "--train_batch_size", "2"],
             "self_mining": ["--self_mining", "--neg_sample_size", "5",
                             "--self_mining_hard_size", "2"],
             "fast": ["--model_variant", "fast", "--neg_sample_size", "1",
                      "--train_batch_size", "2"]}[variant]
    if not jax_side:
        return train_teacher.main(args + ["--device", "cpu"])
    from lightningdot_tpu.cli import train_teacher as jteach
    from lightningdot_tpu.data import padding as jpad

    losses = []

    class Record(jpad.Recycler):      # the JAX driver's per-step losses
        def push(self, batch, ready=None):
            losses.append(float(ready))
            super().push(batch, ready=ready)

    real = jpad.Recycler
    jpad.Recycler = Record
    try:
        _, state = jteach.main(args)
    finally:
        jpad.Recycler = real
    return losses, state.params


def _fast_checkpoints(world):
    """A joint .pt for JAX (whose Fast warm start draws img_bert from
    PRNGKey(seed) and refuses img_bert keys, ROADMAP §C) and the same
    weights with that img_bert for the port."""
    jp = str(world["root"] / "ce.pt")
    pp = world["root"] / "fast_port.pt"
    if not pp.exists():
        img_bert = JFast(JCfg(**SMALL)).init(jax.random.PRNGKey(5))[
            "img_bert"]
        tree = dict(world["params"], bert=world["params"]["uniter"],
                    img_bert=jax.tree.map(np.asarray, img_bert))
        del tree["uniter"]
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                    cross_encoder_fast_state_dict_from_jax(tree).items()},
                   pp)
    return jp, str(pp)


@pytest.mark.parametrize("variant", ["joint", "hard_neg", "self_mining",
                                     "fast"])
def test_train_teacher_matches_jax(world, tmp_path, variant):
    ckpt = str(world["root"] / "ce.pt")
    port_ckpt = ckpt
    if variant == "fast":
        ckpt, port_ckpt = _fast_checkpoints(world)
    want_losses, want_params = _run(world, tmp_path / "jax", variant, True,
                                    ckpt)
    got, model = _run(world, tmp_path / "port", variant, False, port_ckpt)
    assert len(got["losses"]) == len(want_losses) == 6
    for g, w in zip(got["losses"], want_losses):
        assert abs(g - w) <= 1e-5 * max(abs(w), 1e-6), (got, want_losses)
    assert np.ptp(want_losses) > 0
    want = (cross_encoder_fast_state_dict_from_jax if variant == "fast"
            else cross_encoder_state_dict_from_jax)(
        jax.tree.map(np.asarray, want_params))
    sd = model.state_dict()
    assert set(sd) == set(want)
    # a leaf below a millionth of the largest (the Fast image stream's
    # zero-init key biases, whose exact gradient is 0: softmax ignores a
    # per-row shift) is float32 residue, held against that floor
    floor = 1e-6 * max(np.linalg.norm(w) for w in want.values())
    for k, w in want.items():
        g = sd[k].numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w),
                                                   floor), k
    # the teacher directory: config.json + model.pt, read by JAX
    out = tmp_path / "port"
    assert (out / "config.json").exists() and (out / "model.pt").exists()
    if variant != "fast":
        from lightningdot_tpu.models.factory import load_cross_encoder
        _, jparams = load_cross_encoder(str(out))
        for k, w in cross_encoder_state_dict_from_jax(
                jax.tree.map(np.asarray, jparams)).items():
            np.testing.assert_array_equal(sd[k].numpy(), w, err_msg=k)


def test_teacher_preemption_saves_directory(world, tmp_path):
    results, _ = train_teacher.main([
        "--model_config", world["cfg"], "--train_txt_db", world["txt"],
        "--train_img_db", world["img"], "--output_dir", str(tmp_path),
        "--neg_sample_size", "1", "--train_batch_size", "4",
        "--num_train_steps", "1000", "--warmup_steps", "2",
        "--max_bb", "10", "--min_bb", "5", "--compute_dtype", "f32",
        "--sim_preempt_step", "3", "--device", "cpu"])
    assert len(results["losses"]) == 3
    assert (tmp_path / "config.json").exists()
    assert (tmp_path / "model.pt").exists() and (
        tmp_path / "model.json").exists()


def test_train_teacher_runs_on_the_card_by_default(world, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_teacher.main(["--model_config", world["cfg"],
                            "--train_txt_db", world["txt"],
                            "--train_img_db", world["img"],
                            "--output_dir", str(tmp_path)])


def test_get_hard_negs_topk_with_a_seeded_scorer(world):
    """``get_hard_negs`` against JAX's over the same pools and a seeded,
    deterministic scorer (scores drawn once per (text, image) pair, no
    ties): equal maps."""
    r = np.random.default_rng(7)
    table = {}

    def scorer(batch):
        key = batch["gt_txt_id"]
        return np.asarray([table.setdefault((key, im), r.random())
                           for im in batch["neg_img_ids"]], np.float32)

    pools = [b for b in (itm.ItmHardNegDataset(*_dbs(world, False), 6,
                                               seed=3)[i]
                         for i in range(16))]
    got = hn_teacher.get_hard_negs(scorer, pools, 3, pipeline_depth=2)
    want = jhn.get_hard_negs(scorer, pools, 3, pipeline_depth=5)
    assert got == want
    for txt, imgs in got[0].items():
        scores = {im: table[(txt, im)] for im in
                  next(b for b in pools if b["gt_txt_id"] == txt)[
                      "neg_img_ids"]}
        assert set(imgs) == set(sorted(scores, key=scores.get)[-3:])


def _same_item(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_item(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_item(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("name", ["ItmRankDataset", "ItmRankDatasetHardNeg",
                                  "ItmRankDatasetHardNegFromText",
                                  "ItmRankDatasetHardNegFromImage",
                                  "ItmValDataset", "ItmHardNegDataset"])
def test_teacher_datasets_match_jax(world, tmp_path, name):
    """Each copied dataset against its original: the same items from the
    same seed, and the same collated batches."""
    mod, jmod = ((itm, jitm) if name in ("ItmValDataset",
                                         "ItmHardNegDataset")
                 else (itm_rank, jrank))
    kw = {"ItmRankDataset": dict(neg_sample_size=2, seed=1),
          "ItmRankDatasetHardNeg": dict(neg_sample_size=1, hard_neg_size=2,
                                        seed=1),
          "ItmRankDatasetHardNegFromText": dict(neg_sample_size=3, seed=1),
          "ItmRankDatasetHardNegFromImage": dict(neg_sample_size=3, seed=1),
          "ItmValDataset": dict(mini_batch_size=4),
          "ItmHardNegDataset": dict(mini_batch_size=4, seed=1)}[name]
    got = getattr(mod, name)(*_dbs(world, False), **kw)
    want = getattr(jmod, name)(*_dbs(world, True), **kw)
    if name == "ItmRankDatasetHardNeg":
        maps = tmp_path / "hn"
        os.makedirs(maps)
        (maps / "txt2hardimgs_rank0.json").write_text(json.dumps(
            {t: [want.img_name_list[0]] for t in want.ids[:5]}))
        (maps / "img2hardtxts.json").write_text(json.dumps(
            {want.img_name_list[1]: want.ids[:3]}))
        got.reload_hard_negs(str(maps))
        want.reload_hard_negs(str(maps))
    assert len(got) == len(want)
    items = [(got[i], want[i]) for i in range(len(want))]
    for g, w in items:
        _same_item(g, w)
    if name in ("ItmRankDataset", "ItmRankDatasetHardNeg"):
        _same_item(itm_rank.itm_rank_collate([g for g, _ in items[:3]]),
                   jrank.itm_rank_collate([w for _, w in items[:3]]))
    if name.endswith(("FromText", "FromImage")):
        _same_item(itm_rank.itm_rank_hn_collate([items[0][0]]),
                   jrank.itm_rank_hn_collate([items[0][1]]))
