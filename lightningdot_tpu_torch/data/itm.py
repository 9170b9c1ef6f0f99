"""The ITM collate (the port's copy of ``CollateConfig`` and
``itm_fast_collate``, lightningdot_tpu/data/itm.py:115-192; reference
dvl/data/itm.py:203-288).

Items are dicts in the format of the JAX package's ``ItmFastDataset``:
``input_ids``, ``img`` (``fname``, ``img_feat`` [R, 2048], ``img_pos_feat``
[R, 7], ``num_bb``, ``caption_ids``), ``neg_imgs``/``neg_txts`` (hard
negatives or None) and ``txt_id``. The collate pads up the ladders of
:mod:`lightningdot_tpu_torch.const` and emits numpy arrays; it serves as the
``collate_fn`` of a ``torch.utils.data.DataLoader``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

from lightningdot_tpu_torch import const
from lightningdot_tpu_torch.data.padding import (bucket_len, pad_feats,
                                                 pad_ids, pad_mask,
                                                 position_ids)


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
