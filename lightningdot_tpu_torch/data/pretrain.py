"""Pre-training datasets and collates: MLM, MRFR, MRC(-kl), ITM (the port's
copy of lightningdot_tpu/data/pretrain.py:52-464).

Parity targets:
  * MLM masking 15% / 80-10-10 with the at-least-one rule
    (dvl/data/mlm.py:16-53) and the MlmDataset two-tower batch layout
    (mlm.py:56-165);
  * MRFR/MRC region masking with at-least-one (dvl/data/mrm.py:13-39),
    feature/soft-label targets and input feature zeroing (mrm.py:28-39);
  * pre-train ITM with negative-pair sampling probability
    (dvl/data/itm_pre.py:60-156, ``_sample_negative_rand``).

Static shapes, as in the JAX package (PARITY.md, "Known deviations"):
  * masked-token/region losses use fixed-size position arrays
    (``masked_positions/labels/weights``) instead of boolean gathers; the
    cap is generous (overflow beyond it is dropped, probability <1% at the
    default rates) and at least one mask is always present;
  * sequence lengths go up bucket ladders; batch sizes are padded to a
    multiple of ``batch_pad`` with zero-weighted dummy rows.

``_teacher_fields`` builds the joint-input sub-batch of the one-tower KD
teacher (``models/uniter_pretrain.py``) when ``with_teacher`` is set.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Sequence

import numpy as np

from lightningdot_tpu_torch import const
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.padding import (_pool_get, bucket_len,
                                                 pad_feats, pad_ids, pad_mask,
                                                 position_ids)
from lightningdot_tpu_torch.data.txt_db import TxtTokDb, get_ids_and_lens

MAX_MASKED_TOKENS = 16    # >= ceil(0.15 * 64) + slack — scale this
MAX_MASKED_REGIONS = 32   # (cfg.max_masked_tokens) with longer text ladders

_MASK_OVERFLOW_WARNED = [False]


def _warn_mask_overflow(n_masked: int, cap: int) -> None:
    if not _MASK_OVERFLOW_WARNED[0]:
        _MASK_OVERFLOW_WARNED[0] = True
        import logging

        logging.getLogger(__name__).warning(
            "an example has %d masked tokens but max_masked_tokens=%d — "
            "the overflow is masked in the input with no loss signal; "
            "raise PretrainCollateConfig.max_masked_tokens for long text",
            n_masked, cap)


def random_word(tokens: List[int], vocab_range, mask: int,
                rng: random.Random) -> tuple[List[int], List[int]]:
    """BERT-style masking (mlm.py:16-53): 15% selected; of those 80% MASK,
    10% random, 10% kept; -1 labels elsewhere; at least one mask."""
    tokens = list(tokens)
    output_label = []
    for i, token in enumerate(tokens):
        prob = rng.random()
        if prob < 0.15:
            prob /= 0.15
            if prob < 0.8:
                tokens[i] = mask
            elif prob < 0.9:
                tokens[i] = rng.randrange(vocab_range[0], vocab_range[1])
            output_label.append(token)
        else:
            output_label.append(-1)
    if all(o == -1 for o in output_label):
        output_label[0] = tokens[0]
        tokens[0] = mask
    return tokens, output_label


def _get_img_mask(mask_prob: float, num_bb: int, rng: random.Random
                  ) -> np.ndarray:
    """mrm.py:13-19."""
    img_mask = np.asarray([rng.random() < mask_prob for _ in range(num_bb)])
    if not img_mask.any():
        img_mask[rng.randrange(num_bb)] = True
    return img_mask


def _sample_negative(sample_pool, ground_truths, num_sample,
                     rng: random.Random):
    """_sample_negative_rand (itm_pre.py:39-44)."""
    gts = set(ground_truths)
    n_free = sum(1 for p in sample_pool if p not in gts)
    if n_free < num_sample:
        # rejection sampling can never terminate (every num_sample-subset
        # of the pool must contain an excluded element — e.g. tiny shards
        # or hard_neg_size close to the pool): fail loudly, don't hang
        raise ValueError(
            f"cannot draw {num_sample} negatives: only {n_free} non-"
            f"ground-truth candidates in a pool of {len(sample_pool)}")
    outputs = ground_truths[:1]
    while any(o in gts for o in outputs):
        outputs = rng.sample(sample_pool, num_sample)
    return outputs


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

class _PairDataset:
    """Shared base: txt example + its image features (DetectFeatTxtTokDataset
    equivalent, data.py:227-251)."""

    def __init__(self, txt_db: TxtTokDb, img_db: DetectFeatDb,
                 seed: int = 0):
        self.txt_db = txt_db
        self.img_db = img_db
        self.txt_lens, self.ids = get_ids_and_lens(txt_db)
        txt2img = txt_db.txt2img
        self.lens = [tl + img_db.name2nbb[txt2img[i]]
                     for tl, i in zip(self.txt_lens, self.ids)]
        self.seed = seed
        self.rng = random.Random(seed)  # epoch-level draws only
        self._epoch = 0

    def advance_epoch(self):
        """Salt for item_rng so masks re-draw each epoch (the reference's
        continuously-advancing stream also gives fresh masks per epoch)."""
        self._epoch += 1

    def item_rng(self, i) -> random.Random:
        """Per-ITEM mask rng, keyed (seed, epoch, index).

        Unlike a shared stream, the draw is independent of iteration order
        and of which loader thread fetches the item — so the mask datasets
        are safe under the multi-worker DataLoader and bit-reproducible
        across hosts regardless of batch order. Masking-rule parity with
        the reference is unchanged (the reference's torch stream differs
        from any python stream anyway; the rules are what's tested).

        hash() of an int tuple is deterministic across processes
        (PYTHONHASHSEED only randomizes str/bytes hashing)."""
        return random.Random(hash((self.seed, self._epoch, i)))

    def __len__(self):
        return len(self.ids)

    def example(self, i):
        return self.txt_db[self.ids[i]]


class MlmDataset(_PairDataset):
    """dvl/data/mlm.py:56-94."""

    def __getitem__(self, i):
        ex = self.example(i)
        tokens, labels = random_word(ex["input_ids"], self.txt_db.v_range,
                                     self.txt_db.mask, self.item_rng(i))
        input_ids = [self.txt_db.cls_] + tokens + [self.txt_db.sep]
        labels = [-1] + labels + [-1]
        feat, pos, nbb = self.img_db.get_img_feat(ex["img_fname"])
        return {"input_ids": input_ids, "txt_labels": labels,
                "img_feat": feat, "img_pos_feat": pos, "num_bb": nbb}


class MrfrDataset(_PairDataset):
    """dvl/data/mrm.py:42-73."""

    def __init__(self, mask_prob: float, txt_db, img_db, seed: int = 0):
        super().__init__(txt_db, img_db, seed)
        self.mask_prob = mask_prob

    def __getitem__(self, i):
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        feat, pos, nbb = self.img_db.get_img_feat(ex["img_fname"])
        img_mask = _get_img_mask(self.mask_prob, nbb, self.item_rng(i))
        return {"input_ids": input_ids, "img_feat": feat,
                "img_pos_feat": pos, "num_bb": nbb, "img_mask": img_mask}


class MrcDataset(_PairDataset):
    """dvl/data/mrm.py:161-195 (needs soft_labels in the feature DB)."""

    def __init__(self, mask_prob: float, txt_db, img_db, seed: int = 0):
        super().__init__(txt_db, img_db, seed)
        self.mask_prob = mask_prob

    def __getitem__(self, i):
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        # stored dtypes end to end (get_dump's astype-to-f32 of the f16
        # features cost ~40 ms/batch on the host; the model casts on
        # device and the MRC targets are the soft labels, not features)
        nbb = self.img_db.name2nbb[ex["img_fname"]]
        dump = self.img_db.load_arrays(ex["img_fname"])
        feat = dump["features"][:nbb]
        bb = dump["norm_bb"][:nbb].astype(np.float32, copy=False)
        pos = np.concatenate([bb, bb[:, 4:5] * bb[:, 5:6]], axis=-1)
        soft_labels = dump["soft_labels"][:nbb].astype(np.float32,
                                                       copy=False)
        img_mask = _get_img_mask(self.mask_prob, nbb, self.item_rng(i))
        return {"input_ids": input_ids, "img_feat": feat,
                "img_pos_feat": pos, "num_bb": nbb,
                "img_mask": img_mask, "soft_labels": soft_labels}


class ItmPreDataset(_PairDataset):
    """dvl/data/itm_pre.py:60-108 (ItmDataset with neg_sample_p)."""

    def __init__(self, txt_db, img_db, neg_sample_p: float = 0.0,
                 seed: int = 0):
        super().__init__(txt_db, img_db, seed)
        self.neg_sample_p = neg_sample_p
        # sorted: a raw set() iterates in str-hash order, which varies per
        # process (PYTHONHASHSEED) and would defeat the seeded sampling's
        # cross-run/cross-host bit-reproducibility
        self.all_imgs = sorted({txt_db[i]["img_fname"] for i in self.ids})
        self.new_epoch()

    def new_epoch(self):
        """itm_pre.py:77-90."""
        np_rng = np.random.default_rng(self.rng.randrange(2 ** 31))
        self.labels = np_rng.choice(
            [0, 1], size=len(self.ids),
            p=[self.neg_sample_p, 1 - self.neg_sample_p])
        self.lens = []
        self.train_imgs = []
        for i, (id_, tl) in enumerate(zip(self.ids, self.txt_lens)):
            img_fname = self.txt_db[id_]["img_fname"]
            if self.labels[i] == 0:
                img_fname = _sample_negative(self.all_imgs, [img_fname], 1,
                                             self.rng)[0]
            self.train_imgs.append(img_fname)
            self.lens.append(tl + self.img_db.name2nbb[img_fname])

    def __getitem__(self, i):
        ex = self.example(i)
        input_ids = self.txt_db.combine_inputs(ex["input_ids"])
        feat, pos, nbb = self.img_db.get_img_feat(self.train_imgs[i])
        return {"input_ids": input_ids, "img_feat": feat,
                "img_pos_feat": pos, "num_bb": nbb,
                "target": int(self.labels[i])}


# ---------------------------------------------------------------------------
# collates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PretrainCollateConfig:
    txt_buckets: Sequence[int] = const.TXT_LEN_BUCKETS
    img_buckets: Sequence[int] = const.IMG_LEN_BUCKETS
    batch_pad: int = 16
    max_masked_tokens: int = MAX_MASKED_TOKENS
    max_masked_regions: int = MAX_MASKED_REGIONS
    img_cls_id: int = const.IMG_CLS_TOKEN_ID
    img_label_dim: int = const.IMG_LABEL_DIM
    # attach the joint-input teacher sub-batch for pretrain KD
    # (mlm.py:132-163 attn_masks_teacher + gather_index_uniter)
    with_teacher: bool = False


def _gather_index_uniter(txt_lens: List[int], nbbs: List[int], L: int,
                         out_size: int) -> np.ndarray:
    """True joint compaction (uniter data.py:297-305): regions of example i
    start right after its tl_i text tokens; text is padded to L."""
    n = len(txt_lens)
    gi = np.broadcast_to(np.arange(out_size, dtype=np.int32),
                         (n, out_size)).copy()
    for i, (tl, nbb) in enumerate(zip(txt_lens, nbbs)):
        gi[i, tl:tl + nbb] = L + np.arange(nbb, dtype=np.int32)
    return gi


def _teacher_fields(items, txts, imgs, L: int, R: int) -> Dict[str, Any]:
    """Joint-input sub-batch for the one-tower teacher (batch_2_teacher,
    pretrain.py:211-229 + mlm.py:132-163)."""
    n = len(items)
    txt_lens = [int(m.sum()) for m in txts["attention_mask"]]
    nbbs = [it["num_bb"] for it in items]
    out_size = L + R
    attn = np.zeros((n, out_size), np.int32)
    for i, (tl, nbb) in enumerate(zip(txt_lens, nbbs)):
        attn[i, :tl + nbb] = 1
    teacher = {
        "input_ids": txts["input_ids"],
        "position_ids": txts["position_ids"],
        "img_feat": imgs["img_feat"],
        "img_pos_feat": imgs["img_pos_feat"],
        "attn_masks": attn,
        "gather_index": _gather_index_uniter(txt_lens, nbbs, L, out_size),
    }
    if "img_masks" in imgs:
        teacher["img_masks"] = imgs["img_masks"]
    return teacher, txt_lens


def _pad_batch(items: List[dict], pad_to: int) -> tuple[List[dict], int]:
    n_valid = len(items)
    if pad_to > 1 and n_valid % pad_to:
        items = items + [items[-1]] * (pad_to - n_valid % pad_to)
    return items, n_valid


def _two_tower_base(items, cfg: PretrainCollateConfig, img_masks=None):
    """Common txts/imgs sub-batches (mlm_collate layout, mlm.py:135-153)."""
    n = len(items)
    txt_ids = [it["input_ids"] for it in items]
    L = bucket_len(max(len(t) for t in txt_ids), cfg.txt_buckets)
    txts = {
        "input_ids": pad_ids(txt_ids, L),
        "attention_mask": pad_mask([len(t) for t in txt_ids], L),
        "position_ids": position_ids(n, L),
    }
    nbbs = [it["num_bb"] for it in items]
    R = bucket_len(max(nbbs) + 1, cfg.img_buckets) - 1
    imgs = {
        "input_ids": np.full((n, 1), cfg.img_cls_id, np.int32),
        "attention_mask": pad_mask([b + 1 for b in nbbs], R + 1),
        "img_feat": pad_feats([it["img_feat"] for it in items], R),
        "img_pos_feat": pad_feats([it["img_pos_feat"] for it in items], R),
    }
    if img_masks is not None:
        imgs["img_masks"] = img_masks
    return txts, imgs, L, R


def mlm_collate(items: List[dict],
                cfg: PretrainCollateConfig = PretrainCollateConfig()
                ) -> Dict[str, Any]:
    items, n_valid = _pad_batch(items, cfg.batch_pad)
    txts, imgs, L, R = _two_tower_base(items, cfg)
    n, M = len(items), cfg.max_masked_tokens
    positions = np.zeros((n, M), np.int32)
    labels = np.zeros((n, M), np.int32)
    weights = np.zeros((n, M), np.float32)
    for i, it in enumerate(items):
        all_idx = [j for j, l in enumerate(it["txt_labels"]) if l != -1]
        if len(all_idx) > M:
            # the overflowed tokens were already [MASK]ed in input_ids but
            # lose their loss signal — the default M assumes <=64-token
            # text; raise cfg.max_masked_tokens for longer ladders
            _warn_mask_overflow(len(all_idx), M)
        idx = all_idx[:M]
        positions[i, :len(idx)] = idx
        labels[i, :len(idx)] = [it["txt_labels"][j] for j in idx]
        if i < n_valid:
            weights[i, :len(idx)] = 1.0
    batch = {"txts": txts, "imgs": imgs, "caps": None,
             "masked_positions": positions, "masked_labels": labels,
             "masked_weights": weights, "n_valid": n_valid,
             "sample_size": n}
    if cfg.with_teacher:
        teacher, _ = _teacher_fields(items, txts, imgs, L, R)
        # text occupies the joint prefix, so the teacher's masked positions
        # equal the student's text positions
        teacher["masked_positions"] = positions
        teacher["masked_labels"] = labels
        teacher["masked_weights"] = weights
        batch["teacher"] = teacher
    return batch


def _region_mask_arrays(items, cfg, R, with_soft_labels: bool, n_valid: int):
    """Static-size masked-region tensors; positions are +1 for the image
    tower's [CLS] slot (dvl identity-gather layout, mrm.py:65)."""
    n, M = len(items), cfg.max_masked_regions
    positions = np.zeros((n, M), np.int32)
    weights = np.zeros((n, M), np.float32)
    img_masks = np.zeros((n, R), np.int32)
    if with_soft_labels:
        tgt_dim = items[0]["soft_labels"].shape[-1]
    else:
        tgt_dim = items[0]["img_feat"].shape[-1]
    # multi-MB target tensor comes from the recycling pool (cold pages are
    # catastrophically slow on some hosts — data/padding.py pool notes)
    feat_targets = _pool_get((n, M, tgt_dim), np.float32)
    for i, it in enumerate(items):
        mask = it["img_mask"]
        img_masks[i, :len(mask)] = mask
        idx = np.nonzero(mask)[0][:M]
        positions[i, :len(idx)] = idx + 1
        # zero only the tail rows: a full-buffer memset would touch the
        # whole multi-MB pooled target tensor before the loop overwrites
        # most of it (pad_feats uses the same per-row pattern)
        feat_targets[i, len(idx):] = 0
        if with_soft_labels:
            feat_targets[i, :len(idx)] = it["soft_labels"][idx]
        else:
            feat_targets[i, :len(idx)] = it["img_feat"][idx]
        if i < n_valid:
            weights[i, :len(idx)] = 1.0
    return positions, weights, img_masks, feat_targets


def mrfr_collate(items: List[dict],
                 cfg: PretrainCollateConfig = PretrainCollateConfig()
                 ) -> Dict[str, Any]:
    items, n_valid = _pad_batch(items, cfg.batch_pad)
    txts, imgs, L, R = _two_tower_base(items, cfg)
    # the reference both zeroes the masked input features (_mask_img_feat,
    # mrm.py:36-39) and passes img_masks so the model adds the mask
    # embedding (model.py:262-266) — reproduce both
    positions, weights, img_masks, feat_targets = _region_mask_arrays(
        items, cfg, R, with_soft_labels=False, n_valid=n_valid)
    # zero the masked region rows IN PLACE (the pad_feats output is
    # exclusively ours). Identical to the reference's multiply by
    # (1 - mask) since mask is {0,1} — and numpy f16 arithmetic is
    # software-emulated (~125 ms/batch for the broadcast multiply!),
    # while boolean-index assignment is a memset.
    imgs["img_feat"][img_masks.astype(bool)] = 0
    imgs["img_masks"] = img_masks
    batch = {"txts": txts, "imgs": imgs, "caps": None,
             "img_masked_positions": positions,
             "img_masked_weights": weights,
             "feat_targets": feat_targets, "n_valid": n_valid,
             "sample_size": len(items)}
    if cfg.with_teacher:
        teacher, txt_lens = _teacher_fields(items, txts, imgs, L, R)
        # joint-sequence region positions: tl_i + region_idx (the student's
        # positions carry region_idx + 1 for the image-CLS offset)
        tpos = positions - 1 + np.asarray(txt_lens, np.int32)[:, None]
        teacher["img_masked_positions"] = np.where(weights > 0, tpos, 0)
        teacher["img_masked_weights"] = weights
        teacher["feat_targets"] = feat_targets
        batch["teacher"] = teacher
    return batch


def mrc_collate(items: List[dict],
                cfg: PretrainCollateConfig = PretrainCollateConfig()
                ) -> Dict[str, Any]:
    items, n_valid = _pad_batch(items, cfg.batch_pad)
    txts, imgs, L, R = _two_tower_base(items, cfg)
    positions, weights, img_masks, label_targets = _region_mask_arrays(
        items, cfg, R, with_soft_labels=True, n_valid=n_valid)
    imgs["img_feat"][img_masks.astype(bool)] = 0
    imgs["img_masks"] = img_masks
    batch = {"txts": txts, "imgs": imgs, "caps": None,
             "img_masked_positions": positions,
             "img_masked_weights": weights,
             "label_targets": label_targets, "n_valid": n_valid,
             "sample_size": len(items)}
    if cfg.with_teacher:
        teacher, txt_lens = _teacher_fields(items, txts, imgs, L, R)
        tpos = positions - 1 + np.asarray(txt_lens, np.int32)[:, None]
        teacher["img_masked_positions"] = np.where(weights > 0, tpos, 0)
        teacher["img_masked_weights"] = weights
        teacher["label_targets"] = label_targets
        batch["teacher"] = teacher
    return batch


def itm_pre_collate(items: List[dict],
                    cfg: PretrainCollateConfig = PretrainCollateConfig()
                    ) -> Dict[str, Any]:
    items, n_valid = _pad_batch(items, cfg.batch_pad)
    txts, imgs, L, R = _two_tower_base(items, cfg)
    n = len(items)
    targets = np.asarray([it["target"] for it in items], np.int32)
    weights = (np.arange(n) < n_valid).astype(np.float32)
    return {"txts": txts, "imgs": imgs, "caps": None,
            "targets": targets, "weights": weights,
            "pos_ctx_indices": np.arange(n, dtype=np.int32),
            "n_valid": n_valid, "sample_size": n}
