"""The ITM dataset and collate (the port's copies of ``ItmFastDataset``,
``CollateConfig`` and ``itm_fast_collate``,
lightningdot_tpu/data/itm.py:27-192; reference dvl/data/itm.py:30-288).

Items are the dicts of :class:`ItmFastDataset`:
``input_ids``, ``img`` (``fname``, ``img_feat`` [R, 2048], ``img_pos_feat``
[R, 7], ``num_bb``, ``caption_ids``), ``neg_imgs``/``neg_txts`` (hard
negatives or None) and ``txt_id``. The collate pads up the ladders of
:mod:`lightningdot_tpu_torch.const` and emits numpy arrays; it serves as the
``collate_fn`` of a ``torch.utils.data.DataLoader``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from lightningdot_tpu_torch import const
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.padding import (bucket_len, pad_feats,
                                                 pad_ids, pad_mask,
                                                 position_ids)
from lightningdot_tpu_torch.data.txt_db import TxtTokDb, get_ids_and_lens


class ItmFastDataset:
    """The port's copy of ``ItmFastDataset`` (lightningdot_tpu/data/itm.py:
    27-112; reference dvl/data/itm.py:30-122): one item per text of the
    text DB, paired with its image, and per-epoch resampling of hard
    negatives (``new_epoch``)."""

    def __init__(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                 num_hard_negatives: int = 0, img_meta: Optional[dict] = None,
                 tokenizer=None):
        self.txt_db = txt_db
        self.img_db = img_db
        self.txt_lens, self.ids = get_ids_and_lens(txt_db)
        self.ids_2_idx = {idx: i for i, idx in enumerate(self.ids)}
        self.num_hard_negatives = num_hard_negatives
        if img_meta is not None and tokenizer is None:
            raise ValueError("img_meta (caption blending) requires a "
                             "tokenizer — fail here, not deep in a "
                             "dataloader worker")
        self.img_meta = img_meta
        self.tokenizer = tokenizer
        self.train_imgs: Optional[List[str]] = None
        self.neg_imgs: Optional[List[Optional[List[str]]]] = None
        self.lens: List[int] = []

    def new_epoch(self, hard_negatives_img: Optional[dict] = None,
                  hard_negatives_txt: Optional[dict] = None) -> None:
        """Resample labels/negatives each epoch (itm.py:51-66)."""
        txt2img = self.txt_db.txt2img  # cached map beats per-record decode
        self.lens = []
        self.train_imgs, self.neg_imgs = [], []
        self.train_txts, self.neg_txts = [], []
        for id_, tl in zip(self.ids, self.txt_lens):
            img_fname = txt2img[id_]
            self.train_imgs.append(img_fname)
            self.train_txts.append(id_)
            if hard_negatives_img is not None and self.num_hard_negatives > 0:
                if hard_negatives_txt is None:
                    raise ValueError(
                        "hard_negatives_img and hard_negatives_txt must be "
                        "provided together (one-sided negatives would "
                        "crash mid-iteration)")
                self.neg_imgs.append(
                    list(hard_negatives_img[id_][:self.num_hard_negatives]))
                self.neg_txts.append(
                    list(hard_negatives_txt[img_fname][:self.num_hard_negatives]))
            else:
                self.neg_imgs.append(None)
                self.neg_txts.append(None)
            self.lens.append(tl + self.img_db.name2nbb[img_fname])

    def __len__(self) -> int:
        return len(self.ids)

    def _caption_ids(self, img_fname: str) -> Optional[List[int]]:
        """Concatenated multi-caption ids (itm.py:111-114)."""
        if self.img_meta is None:
            return None
        toks = [self.tokenizer.encode(c, add_special_tokens=False)
                + [self.tokenizer.sep_token_id]
                for c in self.img_meta[img_fname]["caption_multiple"]]
        return [self.tokenizer.cls_token_id] + sum(toks, [])

    def _img_entry(self, fname: str) -> Dict[str, Any]:
        feat, pos, nbb = self.img_db.get_img_feat(fname)
        return {"fname": fname, "img_feat": feat, "img_pos_feat": pos,
                "num_bb": nbb, "caption_ids": self._caption_ids(fname)}

    def __getitem__(self, i: int) -> Dict[str, Any]:
        if self.train_imgs is None:
            self.new_epoch()
        id_ = self.ids[i]
        example = self.txt_db[id_]
        img_fname = self.train_imgs[i]

        item = {
            "txt_id": id_,
            "input_ids": self.txt_db.combine_inputs(example["input_ids"]),
            "img": self._img_entry(img_fname),
            "neg_imgs": None,
            "neg_txts": None,
        }
        if self.neg_imgs[i] is not None:
            item["neg_imgs"] = [self._img_entry(f) for f in self.neg_imgs[i]]
            item["neg_txts"] = [
                self.txt_db.combine_inputs(
                    self.txt_db[t]["input_ids"])
                for t in self.neg_txts[i]]
        return item


@dataclasses.dataclass(frozen=True)
class CollateConfig:
    txt_buckets: Sequence[int] = const.TXT_LEN_BUCKETS
    img_buckets: Sequence[int] = const.IMG_LEN_BUCKETS
    cap_buckets: Sequence[int] = const.CAP_LEN_BUCKETS
    fixed_batch: int = 0          # pad partial batches to this size (0 = off)
    img_cls_id: int = const.IMG_CLS_TOKEN_ID


def itm_fast_collate(items: List[Dict[str, Any]],
                     cfg: CollateConfig = CollateConfig()) -> Dict[str, Any]:
    """Items -> one batch (dvl/data/itm.py:203-288, padded to the ladders).

    Sub-batches:
      txts: positives then hard-negative texts [bs + n_neg_txt, L]
      imgs: positives then hard-negative images [bs + n_neg_img, 1 + R]
      caps: positives (+ hard-negative image captions) or None
    With ``cfg.fixed_batch``, a short batch repeats its last item up to that
    size; ``n_valid`` and ``valid_mask`` mark the real items.
    """
    bs = len(items)
    n_valid = bs
    if cfg.fixed_batch and bs < cfg.fixed_batch:
        items = items + [items[-1]] * (cfg.fixed_batch - bs)
        bs = cfg.fixed_batch

    input_ids = [it["input_ids"] for it in items]
    neg_txt_ids = []
    imgs = [it["img"] for it in items]
    neg_imgs = []
    if items[0]["neg_imgs"] is not None:
        for it in items:
            neg_imgs.extend(it["neg_imgs"])
            neg_txt_ids.extend(it["neg_txts"])

    all_txt = input_ids + neg_txt_ids
    length = bucket_len(max(len(t) for t in all_txt), cfg.txt_buckets)
    txt_batch = {
        "input_ids": pad_ids(all_txt, length),
        "attention_mask": pad_mask([len(t) for t in all_txt], length),
        "position_ids": position_ids(len(all_txt), length),
    }

    all_imgs = imgs + neg_imgs
    nbbs = [im["num_bb"] for im in all_imgs]
    regions = bucket_len(max(nbbs) + 1, cfg.img_buckets) - 1
    n_img = len(all_imgs)
    img_batch = {
        "input_ids": np.full((n_img, 1), cfg.img_cls_id, np.int32),
        "attention_mask": pad_mask([n + 1 for n in nbbs], regions + 1),
        "img_feat": pad_feats([im["img_feat"] for im in all_imgs], regions),
        "img_pos_feat": pad_feats([im["img_pos_feat"] for im in all_imgs],
                                  regions),
    }

    if imgs[0]["caption_ids"] is not None:
        all_caps = [im["caption_ids"] for im in all_imgs]
        cap_len = bucket_len(max(len(c) for c in all_caps), cfg.cap_buckets)
        cap_batch = {
            "input_ids": pad_ids(all_caps, cap_len),
            "attention_mask": pad_mask([len(c) for c in all_caps], cap_len),
            "position_ids": position_ids(len(all_caps), cap_len),
        }
    else:
        cap_batch = None

    return {
        "txts": txt_batch,
        "imgs": img_batch,
        "caps": cap_batch,
        "sample_size": bs,
        "n_valid": n_valid,
        "valid_mask": (np.arange(bs) < n_valid).astype(np.float32),
        "pos_ctx_indices": np.arange(bs, dtype=np.int32),
        "neg_ctx_indices": np.arange(bs, n_img, dtype=np.int32),
        "txt_index": [it["txt_id"] for it in items],
        "img_fname": [im["fname"] for im in all_imgs[:bs]],
    }
