"""Triplet-ranking datasets for cross-encoder (teacher) training (the
port's copy of lightningdot_tpu/data/itm_rank.py; reference
uniter_model/data/itm.py:198-447).

``ItmRankDataset`` (itm.py:198-249): each item packs the ground-truth
pair, ``neg_sample_size`` negative-image pairs and ``neg_sample_size``
negative-text pairs (1 + 2n joint sequences, positive first) for the
sigmoid-triplet loss with ``sample_size = 1 + 2n`` (model/itm.py:43-51).
``ItmRankDatasetHardNeg`` mixes in mined hard negatives;
``ItmRankDatasetHardNegFromText`` / ``...FromImage`` are the self-mining
candidate groups; ``itm_rank_collate`` / ``itm_rank_hn_collate`` batch
them.
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Dict, List, Sequence

import numpy as np

from lightningdot_tpu_torch import const
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.padding import (bucket_len, pad_feats,
                                                 pad_ids, pad_mask,
                                                 position_ids)
from lightningdot_tpu_torch.data.pretrain import _sample_negative
from lightningdot_tpu_torch.data.txt_db import TxtTokDb, get_ids_and_lens


def _init_id_maps(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                  neg_sample_size: int, seed: int) -> None:
    """Shared shard-restricted id-map setup (encodes the no-positive-leak
    invariant: img2txts is built from THIS shard's ids only, so a mined
    negative can never be another shard's positive). One implementation
    for ItmRankDataset and the self-mining group datasets."""
    assert neg_sample_size > 0, "need at least 1 negative sample"
    self.txt_db = txt_db
    self.img_db = img_db
    _, self.ids = get_ids_and_lens(txt_db)
    txt2img = txt_db.txt2img
    self.txt2img = {i: txt2img[i] for i in self.ids}
    self.img2txts = defaultdict(list)
    for id_, img in self.txt2img.items():
        self.img2txts[img].append(id_)
    self.img_name_list = list(self.img2txts.keys())
    self.neg_sample_size = neg_sample_size
    self.rng = random.Random(seed)


class ItmRankDataset:
    def __init__(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                 neg_sample_size: int = 1, seed: int = 0):
        _init_id_maps(self, txt_db, img_db, neg_sample_size, seed)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int) -> List[Dict[str, Any]]:
        gt_txt_id = self.ids[i]
        gt_img = self.txt2img[gt_txt_id]
        id_pairs = [(gt_txt_id, gt_img)]
        neg_imgs = _sample_negative(self.img_name_list, [gt_img],
                                    self.neg_sample_size, self.rng)
        neg_txts = _sample_negative(self.ids, self.img2txts[gt_img],
                                    self.neg_sample_size, self.rng)
        id_pairs += [(gt_txt_id, im) for im in neg_imgs]
        id_pairs += [(t, gt_img) for t in neg_txts]

        inputs = []
        for txt_id, img_id in id_pairs:
            ex = self.txt_db[txt_id]
            feat, pos, nbb = self.img_db.get_img_feat(img_id)
            inputs.append({
                "input_ids": self.txt_db.combine_inputs(ex["input_ids"]),
                "img_feat": feat, "img_pos_feat": pos, "num_bb": nbb,
            })
        return inputs


class ItmRankDatasetHardNeg(ItmRankDataset):
    """Triplet groups mixing mined hard negatives with random negatives.

    Parity: ItmRankDatasetHardNeg (uniter_model/data/itm.py:252-303) — each
    item packs [gt pair, ``hard_neg_size`` hard-image pairs, ``hard_neg_size``
    hard-text pairs, ``neg_sample_size`` random-image pairs,
    ``neg_sample_size`` random-text pairs]; hard candidates come from the
    miner's JSON maps (training.hn_teacher.compute_hard_neg).
    """

    def __init__(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                 neg_sample_size: int = 1, hard_neg_size: int = 1,
                 seed: int = 0):
        assert hard_neg_size > 0, \
            "ItmRankDatasetHardNeg needs at least 1 hard negative sample"
        super().__init__(txt_db, img_db, max(neg_sample_size, 1), seed=seed)
        self.neg_sample_size = neg_sample_size
        self.hard_neg_size = hard_neg_size
        self.txt2hardimgs: Dict[str, List[str]] = {}
        self.img2hardtxts: Dict[str, List[str]] = {}

    def reload_hard_negs(self, hard_neg_dir: str, rank: int = 0) -> None:
        """Load the miner's output (train_itm.py:61-65)."""
        import json
        import os

        with open(os.path.join(hard_neg_dir,
                               f"txt2hardimgs_rank{rank}.json")) as f:
            self.txt2hardimgs = json.load(f)
        with open(os.path.join(hard_neg_dir, "img2hardtxts.json")) as f:
            self.img2hardtxts = json.load(f)

    def _sample_hard(self, pool, fallback_population, exclude):
        pool = list(pool)
        if len(pool) >= self.hard_neg_size:
            return self.rng.sample(pool, self.hard_neg_size)
        top_up = _sample_negative(fallback_population, list(exclude) + pool,
                                  self.hard_neg_size - len(pool), self.rng)
        return pool + top_up

    def __getitem__(self, i: int) -> List[Dict[str, Any]]:
        gt_txt_id = self.ids[i]
        gt_img = self.txt2img[gt_txt_id]
        id_pairs = [(gt_txt_id, gt_img)]
        if self.hard_neg_size > 0:
            assert self.txt2hardimgs, \
                "call reload_hard_negs() (or compute_hard_neg) first"
            # the miner can legitimately produce short (or missing) lists —
            # an image may appear in fewer than hard_neg_size random pools
            # (train_itm.py:346-351 'not enough negatives'). Keep the group
            # width STATIC by topping up with random negatives.
            hard_imgs = self._sample_hard(
                self.txt2hardimgs.get(gt_txt_id, ()),
                self.img_name_list, [gt_img])
            hard_txts = self._sample_hard(
                self.img2hardtxts.get(gt_img, ()),
                self.ids, self.img2txts[gt_img])
            id_pairs += [(gt_txt_id, im) for im in hard_imgs]
            id_pairs += [(t, gt_img) for t in hard_txts]
        if self.neg_sample_size > 0:
            neg_imgs = _sample_negative(self.img_name_list, [gt_img],
                                        self.neg_sample_size, self.rng)
            neg_txts = _sample_negative(self.ids, self.img2txts[gt_img],
                                        self.neg_sample_size, self.rng)
            id_pairs += [(gt_txt_id, im) for im in neg_imgs]
            id_pairs += [(t, gt_img) for t in neg_txts]

        inputs = []
        for txt_id, img_id in id_pairs:
            ex = self.txt_db[txt_id]
            feat, pos, nbb = self.img_db.get_img_feat(img_id)
            inputs.append({
                "input_ids": self.txt_db.combine_inputs(ex["input_ids"]),
                "img_feat": feat, "img_pos_feat": pos, "num_bb": nbb,
            })
        assert len(inputs) == (1 + 2 * self.neg_sample_size
                               + 2 * self.hard_neg_size)
        return inputs


class _RankGroupDataset:
    """Shared id-map setup for the self-mining candidate-group datasets."""

    def __init__(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                 neg_sample_size: int = 1, seed: int = 0,
                 txt_buckets: Sequence[int] = const.TXT_LEN_BUCKETS,
                 img_buckets: Sequence[int] = const.IMG_LEN_BUCKETS):
        _init_id_maps(self, txt_db, img_db, neg_sample_size, seed)
        self.txt_name_list = list(self.txt2img.keys())
        self.txt_buckets = txt_buckets
        self.img_buckets = img_buckets

    def __len__(self):
        return len(self.ids)


class ItmRankDatasetHardNegFromText(_RankGroupDataset):
    """Candidate groups for in-batch self-mining, text shared.

    Parity: ItmRankDatasetHardNegFromText (uniter_model/data/itm.py:340-385)
    — item i is one group: text i against [gt image + ``neg_sample_size``
    random images] (gt first). Consumed by CrossEncoderHardNeg with
    ``sample_from='t'`` (text emitted once, [1, L], broadcast on device).
    """

    def __getitem__(self, i: int) -> Dict[str, Any]:
        gt_txt_id = self.ids[i]
        gt_img = self.txt2img[gt_txt_id]
        input_ids = self.txt_db.combine_inputs(
            self.txt_db[gt_txt_id]["input_ids"])
        neg_imgs = _sample_negative(self.img_name_list, [gt_img],
                                    self.neg_sample_size, self.rng)
        img_ids = [gt_img] + neg_imgs

        feats, poss, nbbs = [], [], []
        for im in img_ids:
            f, p, n = self.img_db.get_img_feat(im)
            feats.append(f)
            poss.append(p)
            nbbs.append(n)
        n = len(img_ids)
        L = bucket_len(len(input_ids), self.txt_buckets)
        R = bucket_len(max(nbbs), self.img_buckets)
        return {
            "input_ids": pad_ids([input_ids], L),            # [1, L] shared
            "position_ids": position_ids(1, L),
            "img_feat": pad_feats(feats, R),
            "img_pos_feat": pad_feats(poss, R),
            "attn_masks": np.concatenate(
                [pad_mask([len(input_ids)] * n, L), pad_mask(nbbs, R)],
                axis=1),
            "sample_size": n,
        }


class ItmRankDatasetHardNegFromImage(_RankGroupDataset):
    """Candidate groups for in-batch self-mining, image shared.

    Parity: ItmRankDatasetHardNegFromImage (uniter_model/data/itm.py:388-442)
    — item i is one group: image of text i against [text i +
    ``neg_sample_size`` random texts] (gt first). Consumed by
    CrossEncoderHardNeg with ``sample_from='i'``.
    """

    def __getitem__(self, i: int) -> Dict[str, Any]:
        gt_txt_id = self.ids[i]
        gt_img = self.txt2img[gt_txt_id]
        gt_txts = self.img2txts[gt_img]

        feat, pos, nbb = self.img_db.get_img_feat(gt_img)
        neg_txts = _sample_negative(self.txt_name_list, gt_txts,
                                    self.neg_sample_size, self.rng)
        txt_ids = [gt_txt_id] + neg_txts
        toks = [self.txt_db.combine_inputs(self.txt_db[t]["input_ids"])
                for t in txt_ids]
        n = len(txt_ids)
        L = bucket_len(max(len(t) for t in toks), self.txt_buckets)
        R = bucket_len(nbb, self.img_buckets)
        return {
            "input_ids": pad_ids(toks, L),
            "position_ids": position_ids(n, L),
            "img_feat": pad_feats([feat], R),                # [1, R, D] shared
            "img_pos_feat": pad_feats([pos], R),
            "attn_masks": np.concatenate(
                [pad_mask([len(t) for t in toks], L),
                 pad_mask([nbb] * n, R)], axis=1),
            "sample_size": n,
        }


def itm_rank_hn_collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One self-mining group per step (itm_rank_hnv2_collate,
    uniter_model/data/itm.py:445-447)."""
    assert len(items) == 1
    return items[0]


def itm_rank_collate(items: List[List[Dict[str, Any]]],
                     txt_buckets: Sequence[int] = const.TXT_LEN_BUCKETS,
                     img_buckets: Sequence[int] = const.IMG_LEN_BUCKETS
                     ) -> Dict[str, Any]:
    """Flatten groups into one joint batch; positive first per group."""
    sample_size = len(items[0])
    assert all(len(g) == sample_size for g in items)
    flat = [p for g in items for p in g]
    n = len(flat)
    toks = [p["input_ids"] for p in flat]
    L = bucket_len(max(len(t) for t in toks), txt_buckets)
    nbbs = [p["num_bb"] for p in flat]
    R = bucket_len(max(nbbs), img_buckets)
    txt_mask = pad_mask([len(t) for t in toks], L)
    img_mask = pad_mask(nbbs, R)
    return {
        "input_ids": pad_ids(toks, L),
        "position_ids": position_ids(n, L),
        "img_feat": pad_feats([p["img_feat"] for p in flat], R),
        "img_pos_feat": pad_feats([p["img_pos_feat"] for p in flat], R),
        "attn_masks": np.concatenate([txt_mask, img_mask], axis=1),
        # split masks for the two-stream Fast variant (the reference collate
        # emits these separately too, uniter_model/data/itm.py:305-337)
        "attn_masks_text": txt_mask,
        "attn_masks_img": img_mask,
        "sample_size": sample_size,
        "n_groups": len(items),
    }
