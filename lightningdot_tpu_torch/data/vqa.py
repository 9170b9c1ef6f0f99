"""VQA dataset and collates (the port's copy of
lightningdot_tpu/data/vqa.py).

Parity: dvl/data/vqa.py:11-145 — ``_get_vqa_target`` scatters the soft
answer scores into a dense [num_answers] vector; ``VqaDataset`` pairs each
question with its image's region features plus that target;
``vqa_collate`` emits the bi-encoder two-tower batch (question text in
'txts', image regions behind a [CLS] token in 'imgs') consumed by
``BiEncoderForVisualQuestionAnswering.forward`` (dvl/models/bi_encoder.py:
704-718); ``VqaEvalDataset``/``vqa_eval_collate`` emit the joint
text+regions sequence for a cross-encoder scorer (targets optional).

The same bucket ladders and fixed-batch padding (``n_valid``/
``valid_mask``) as the JAX package: a numpy-only host path whose batches
take a few fixed shapes, the shapes the card's kernels are held at.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

from lightningdot_tpu_torch import const
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.padding import (bucket_len, pad_feats,
                                                 pad_ids, pad_mask,
                                                 position_ids)
from lightningdot_tpu_torch.data.txt_db import TxtTokDb, get_ids_and_lens


def vqa_target(example: Dict[str, Any], num_answers: int) -> np.ndarray:
    """Dense soft-score target (dvl/data/vqa.py:11-17).

    example['target'] = {'labels': [answer ids], 'scores': [soft scores]};
    absent/empty target -> all zeros (unlabelled eval questions).
    """
    target = np.zeros((num_answers,), np.float32)
    t = example.get("target") or {}
    labels, scores = t.get("labels"), t.get("scores")
    if labels and scores:
        target[np.asarray(labels, np.int64)] = np.asarray(scores, np.float32)
    return target


class VqaDataset:
    """Question + image regions + soft target (dvl/data/vqa.py:20-42).

    ``lens`` (txt len + num regions) feeds TokenBucketSampler, matching
    DetectFeatTxtTokDataset's bucketing key.
    """

    def __init__(self, num_answers: int, txt_db: TxtTokDb,
                 img_db: DetectFeatDb):
        self.txt_db = txt_db
        self.img_db = img_db
        self.num_answers = num_answers
        self.txt_lens, self.ids = get_ids_and_lens(txt_db)
        txt2img = txt_db.txt2img
        self.lens = [tl + img_db.name2nbb[txt2img[id_]]
                     for tl, id_ in zip(self.txt_lens, self.ids)]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        id_ = self.ids[i]
        return self._item(id_, self.txt_db[id_])

    def _item(self, id_: str, ex: Dict[str, Any]) -> Dict[str, Any]:
        feat, pos, nbb = self.img_db.get_img_feat(ex["img_fname"])
        return {
            "qid": id_,
            "input_ids": self.txt_db.combine_inputs(ex["input_ids"]),
            "img_feat": feat,
            "img_pos_feat": pos,
            "num_bb": nbb,
            "target": vqa_target(ex, self.num_answers),
        }


@dataclasses.dataclass(frozen=True)
class VqaCollateConfig:
    txt_buckets: Sequence[int] = const.TXT_LEN_BUCKETS
    img_buckets: Sequence[int] = const.IMG_LEN_BUCKETS
    fixed_batch: int = 0          # pad partial batches to this size (0 = off)
    img_cls_id: int = const.IMG_CLS_TOKEN_ID


def vqa_collate(items: List[Dict[str, Any]],
                cfg: VqaCollateConfig = VqaCollateConfig()) -> Dict[str, Any]:
    """Two-tower VQA batch (dvl/data/vqa.py:45-90, static-shape edition).

    'txts' carries the question tokens; 'imgs' carries [CLS] + regions —
    the same sub-batch contract as itm_fast_collate, so
    ``BiEncoderForVQA.apply`` consumes it unchanged. ``valid_mask`` zeroes
    the loss of fixed-batch pad rows.
    """
    bs = len(items)
    n_valid = bs
    if cfg.fixed_batch and bs < cfg.fixed_batch:
        items = items + [items[-1]] * (cfg.fixed_batch - bs)
        bs = cfg.fixed_batch

    input_ids = [it["input_ids"] for it in items]
    L = bucket_len(max(len(t) for t in input_ids), cfg.txt_buckets)
    txt_batch = {
        "input_ids": pad_ids(input_ids, L),
        "attention_mask": pad_mask([len(t) for t in input_ids], L),
        "position_ids": position_ids(bs, L),
    }

    nbbs = [it["num_bb"] for it in items]
    R = bucket_len(max(nbbs) + 1, cfg.img_buckets) - 1
    img_batch = {
        "input_ids": np.full((bs, 1), cfg.img_cls_id, np.int32),
        "attention_mask": pad_mask([n + 1 for n in nbbs], R + 1),
        "img_feat": pad_feats([it["img_feat"] for it in items], R),
        "img_pos_feat": pad_feats([it["img_pos_feat"] for it in items], R),
    }

    return {
        "qids": [it["qid"] for it in items[:n_valid]],
        "txts": txt_batch,
        "imgs": img_batch,
        "caps": None,
        "targets": np.stack([it["target"] for it in items], axis=0),
        "sample_size": bs,
        "n_valid": n_valid,
        "valid_mask": (np.arange(bs) < n_valid).astype(np.float32),
    }


class VqaEvalDataset(VqaDataset):
    """Eval items — target may be absent on test splits
    (dvl/data/vqa.py:93-111)."""

    def __getitem__(self, i: int) -> Dict[str, Any]:
        id_ = self.ids[i]
        ex = self.txt_db[id_]  # single DB read shared with _item
        item = self._item(id_, ex)
        item["has_target"] = "target" in ex
        return item


def vqa_eval_collate(items: List[Dict[str, Any]],
                     cfg: VqaCollateConfig = VqaCollateConfig()
                     ) -> Dict[str, Any]:
    """Joint text+regions batch for a cross-encoder scorer
    (dvl/data/vqa.py:114-145).

    Emits the cross_encoder sub-batch contract (attn_masks_text /
    attn_masks_img); ``targets`` is None when the split is unlabelled
    (matching the reference's targets=None branch, vqa.py:124-127).
    """
    bs = len(items)
    n_valid = bs
    if cfg.fixed_batch and bs < cfg.fixed_batch:
        items = items + [items[-1]] * (cfg.fixed_batch - bs)
        bs = cfg.fixed_batch

    input_ids = [it["input_ids"] for it in items]
    L = bucket_len(max(len(t) for t in input_ids), cfg.txt_buckets)
    nbbs = [it["num_bb"] for it in items]
    R = bucket_len(max(nbbs), cfg.img_buckets)

    has_target = all(it.get("has_target", True) for it in items)
    targets = (np.stack([it["target"] for it in items], axis=0)
               if has_target else None)
    return {
        "qids": [it["qid"] for it in items[:n_valid]],
        "input_ids": pad_ids(input_ids, L),
        "position_ids": position_ids(bs, L),
        "img_feat": pad_feats([it["img_feat"] for it in items], R),
        "img_pos_feat": pad_feats([it["img_pos_feat"] for it in items], R),
        "attn_masks_text": pad_mask([len(t) for t in input_ids], L),
        "attn_masks_img": pad_mask(nbbs, R),
        "gather_index": None,
        "targets": targets,
        "sample_size": bs,
        "n_valid": n_valid,
        "valid_mask": (np.arange(bs) < n_valid).astype(np.float32),
    }
