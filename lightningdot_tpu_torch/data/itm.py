"""The ITM datasets and collate (the port's copies of ``ItmFastDataset``,
``CollateConfig`` and ``itm_fast_collate``,
lightningdot_tpu/data/itm.py:27-192; reference dvl/data/itm.py:30-288; and
of the cross-encoder's ``ItmValDataset``, ``ItmHardNegDataset`` and
``make_teacher_batch``, :194-362).

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
from lightningdot_tpu_torch.data.padding import (_pool_get, bucket_len,
                                                 pad_feats, pad_ids, pad_mask,
                                                 position_ids)
from lightningdot_tpu_torch.data.txt_db import TxtTokDb, get_ids_and_lens
from lightningdot_tpu_torch.utils import tracing


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
    size; ``n_valid`` and ``valid_mask`` mark the real items. Counts on the
    open span (``utils/tracing.py``): the text and image ``positions``
    after padding, and the ``real_positions`` of the real items and their
    negatives among them.
    """
    bs = len(items)
    n_valid = bs
    real_items = items
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

    real = 0
    for it in real_items:
        txts = [it["input_ids"]] + list(it["neg_txts"] or [])
        ims = [it["img"]] + list(it["neg_imgs"] or [])
        real += (sum(min(len(t), length) for t in txts)
                 + sum(min(im["num_bb"], regions) + 1 for im in ims))
    tracing.count("positions", len(all_txt) * length + n_img * (regions + 1))
    tracing.count("real_positions", real)

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


class ItmValDataset:
    """Per-text candidate groups for the cross-encoder (the port's copy of
    ``ItmValDataset``, lightningdot_tpu/data/itm.py:194-275; reference
    dvl/data/itm.py:291-363): item i pairs text i with its image and the
    ``mini_batch_size - 1`` images after it in corpus order (wrapped), as
    one joint batch."""

    def __init__(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                 mini_batch_size: int = 400):
        self.txt_db = txt_db
        self.img_db = img_db
        _, self.ids = get_ids_and_lens(txt_db)
        self.txt2img = txt_db.txt2img
        self.img2txts = txt_db.img2txts
        self.all_img_ids = list(self.img2txts.keys())
        self._img_pos = {im: j for j, im in enumerate(self.all_img_ids)}
        assert len(self.img2txts) >= mini_batch_size > 0
        self.bs = mini_batch_size

    def __len__(self):
        return len(self.ids)

    def _get_batch_ids(self, i: int):
        """itm.py:303-322."""
        gt_txt_id = self.ids[i]
        gt_img_id = self.txt2img[gt_txt_id]
        j = self._img_pos[gt_img_id]
        neg_st = j + 1
        neg_end = neg_st + self.bs - 1
        if neg_end > len(self.all_img_ids):
            neg_end -= len(self.all_img_ids)
            neg_img_ids = (self.all_img_ids[neg_st:]
                           + self.all_img_ids[:neg_end])
        else:
            neg_img_ids = self.all_img_ids[neg_st:neg_end]
        assert len(neg_img_ids) == self.bs - 1
        return gt_img_id, neg_img_ids

    def __getitem__(self, i: int) -> Dict[str, Any]:
        gt_img_id, neg_img_ids = self._get_batch_ids(i)
        return self.get_batch(i, [gt_img_id] + neg_img_ids, bucket=True)

    def get_batch(self, i: int, img_ids: List[str],
                  bucket: bool = False) -> Dict[str, Any]:
        """Text i paired with each of ``img_ids`` (itm.py:343-380);
        ``bucket`` pads up the ladders."""
        ex = self.txt_db[self.ids[i]]
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        feats, poss, nbbs = [], [], []
        for im in img_ids:
            f, p, n = self.img_db.get_img_feat(im)
            feats.append(f)
            poss.append(p)
            nbbs.append(n)
        n = len(img_ids)
        if bucket:
            L = bucket_len(len(input_ids), const.TXT_LEN_BUCKETS)
            R = bucket_len(max(nbbs), const.IMG_LEN_BUCKETS)
        else:
            L = len(input_ids)
            R = max(nbbs)
        return {
            "input_ids": pad_ids([input_ids] * n, L),
            "position_ids": position_ids(n, L),
            "img_feat": pad_feats(feats, R),
            "img_pos_feat": pad_feats(poss, R),
            "attn_masks_text": pad_mask([len(input_ids)] * n, L),
            "attn_masks_img": pad_mask(nbbs, R),
            "gather_index": None,
            "img_ids": img_ids,
            "txt_id": self.ids[i],
        }


class ItmHardNegDataset(ItmValDataset):
    """Random candidate pools for the teacher's hard-negative mining (the
    port's copy of ``ItmHardNegDataset``, lightningdot_tpu/data/itm.py:
    278-313; reference uniter_model/data/itm.py:529-549): item i pairs
    text i with ``mini_batch_size`` images drawn from the corpus without
    its own, and carries ``gt_txt_id`` / ``neg_img_ids``."""

    def __init__(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                 mini_batch_size: int = 400, seed: int = 0):
        super().__init__(txt_db, img_db, mini_batch_size)
        import random as _random

        self.rng = _random.Random(seed)

    def _get_batch_ids(self, i: int):
        gt_txt_id = self.ids[i]
        gt_img_id = self.txt2img[gt_txt_id]
        if len(self.all_img_ids) > self.bs:
            cand = self.rng.sample(self.all_img_ids, self.bs + 1)
            neg_img_ids = [im for im in cand if im != gt_img_id][:self.bs]
        else:
            neg_img_ids = [im for im in self.all_img_ids if im != gt_img_id]
        assert len(neg_img_ids) == self.bs, "not enough neg samples"
        return gt_img_id, neg_img_ids

    def __getitem__(self, i: int) -> Dict[str, Any]:
        _, neg_img_ids = self._get_batch_ids(i)
        batch = self.get_batch(i, neg_img_ids, bucket=True)
        batch["gt_txt_id"] = self.ids[i]
        batch["neg_img_ids"] = neg_img_ids
        return batch


def make_teacher_batch(batch: Dict[str, Any], n_teacher: int
                       ) -> Dict[str, np.ndarray]:
    """The cross-encoder's KD sub-batch (the port's copy of
    ``make_teacher_batch``, lightningdot_tpu/data/itm.py:316-362; reference
    itm_fast_collate_kd, dvl/data/itm.py:165-173): the first ``n_teacher``
    images paired with every positive text, pair order text i *
    n_teacher + image j, the image side's [CLS] mask column dropped. The
    tiled feature grids are pooled arrays (page-locked once a card stages
    batches), so a ``PinnedStager`` copies them to the card without a
    pageable bounce. ``bs < n_teacher`` raises."""
    bs = int(batch["sample_size"])
    if bs < n_teacher:
        raise ValueError(
            f"KD needs batch size >= n_teacher ({bs} < {n_teacher}); "
            f"lower n_teacher or raise train_batch_size")
    txt_ids = np.asarray(batch["txts"]["input_ids"][:bs])
    txt_mask = np.asarray(batch["txts"]["attention_mask"][:bs])
    img_feat = np.asarray(batch["imgs"]["img_feat"][:n_teacher])
    img_pos = np.asarray(batch["imgs"]["img_pos_feat"][:n_teacher])
    img_mask = np.asarray(batch["imgs"]["attention_mask"][:n_teacher, 1:])

    def tile_pooled(src, reps):
        out = _pool_get((src.shape[0] * reps,) + src.shape[1:], src.dtype)
        out.reshape((reps,) + src.shape)[...] = src[None]
        return out

    input_ids = np.repeat(txt_ids, n_teacher, axis=0)
    txt_mask_r = np.repeat(txt_mask, n_teacher, axis=0)
    L = input_ids.shape[1]
    return {
        "input_ids": input_ids,
        "position_ids": position_ids(input_ids.shape[0], L),
        "img_feat": tile_pooled(img_feat, bs),
        "img_pos_feat": tile_pooled(img_pos, bs),
        "attn_masks": np.concatenate([txt_mask_r, np.tile(img_mask, (bs, 1))],
                                     axis=1),
        "gather_index": None,
    }
