"""Retrieval metrics (the port's copy of lightningdot_tpu/utils/metrics.py:
21-101).

Two recall formulations exist in the reference and both are reproduced:

  * kNN-result recall (dvl/trainer.py:173-190): given per-query ranked db-id
    lists from the index, recall@K for text->image (single ground truth,
    trainer.py:174-179) and image->text (any of img2txt's texts,
    trainer.py:181-188).
  * score-matrix recall (uniter_model/eval/itm.py:6-53): [n_txt, n_img]
    matrix + id mappings -> ir/tr R@1/5/10 + means.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np

RECALL_KS = (1, 5, 10)


def recall_from_ranked_ids(query_ids: Sequence[Any],
                           ranked_db_ids: Mapping[Any, Sequence[Any]],
                           gt_of_query: Mapping[Any, Any],
                           ks: Sequence[int] = RECALL_KS) -> Dict[int, float]:
    """Text->image recall: one ground-truth id per query (trainer.py:173-179)."""
    recall = {k: 0 for k in ks}
    for q in query_ids:
        ranked = list(ranked_db_ids[q])
        for k in ks:
            recall[k] += gt_of_query[q] in ranked[:k]
    # denominator = queries actually counted: dividing by the MAPPING size
    # would inflate recall past 1.0 when query_ids carries duplicates (the
    # evaluator's dicts dedupe) or deflate it when the mapping has extras
    n = max(len(query_ids), 1)
    return {k: v / n for k, v in recall.items()}


def recall_any_from_ranked_ids(query_ids: Sequence[Any],
                               ranked_db_ids: Mapping[Any, Sequence[Any]],
                               gts_of_query: Mapping[Any, Sequence[Any]],
                               ks: Sequence[int] = RECALL_KS
                               ) -> Dict[int, float]:
    """Image->text recall: hit if ANY ground truth in top-k
    (trainer.py:181-188; queries deduplicated per np.unique there)."""
    recall = {k: 0 for k in ks}
    uniq = list(dict.fromkeys(query_ids))
    for q in uniq:
        ranked = list(ranked_db_ids[q])
        for k in ks:
            recall[k] += any(t in ranked[:k] for t in gts_of_query[q])
    n = max(len(uniq), 1)  # see recall_from_ranked_ids
    return {k: v / n for k, v in recall.items()}


def itm_eval(score_matrix: np.ndarray, txt_ids: Sequence[Any],
             img_ids: Sequence[Any], txt2img: Mapping[Any, Any],
             img2txts: Mapping[Any, Sequence[Any]]) -> Dict[str, float]:
    """Score-matrix recall (uniter_model/eval/itm.py:6-53 semantics).

    score_matrix: [n_txt, n_img]. 'img_r*' = image retrieval (text query),
    'txt_r*' = text retrieval (image query) — naming as in the reference.
    """
    score_matrix = np.asarray(score_matrix)
    n_txt, n_img = score_matrix.shape

    # image retrieval: rank images for each text query
    img2j = {i: j for j, i in enumerate(img_ids)}
    rank_txt = np.argsort(-score_matrix, axis=1)[:, :10]
    gt_j = np.asarray([img2j[txt2img[t]] for t in txt_ids])[:, None]
    hits = rank_txt == gt_j
    pos = np.where(hits.any(axis=1), hits.argmax(axis=1), 10)
    ir_r1 = float((pos < 1).mean())
    ir_r5 = float((pos < 5).mean())
    ir_r10 = float((pos < 10).mean())

    # text retrieval: rank texts for each image
    txt2i = {t: i for i, t in enumerate(txt_ids)}
    rank_img = np.argsort(-score_matrix, axis=0)[:10, :]
    tr_r1 = tr_r5 = tr_r10 = 0
    for j, img_id in enumerate(img_ids):
        gt_is = {txt2i[t] for t in img2txts[img_id] if t in txt2i}
        col = rank_img[:, j]
        # col has min(10, n_txt) rows — range over its real length
        found = [r for r in range(col.shape[0]) if col[r] in gt_is]
        rank = found[0] if found else 10
        tr_r1 += rank < 1
        tr_r5 += rank < 5
        tr_r10 += rank < 10
    tr_r1 /= n_img
    tr_r5 /= n_img
    tr_r10 /= n_img

    tr_mean = (tr_r1 + tr_r5 + tr_r10) / 3
    ir_mean = (ir_r1 + ir_r5 + ir_r10) / 3
    return {
        "txt_r1": tr_r1, "txt_r5": tr_r5, "txt_r10": tr_r10,
        "txt_r_mean": tr_mean,
        "img_r1": ir_r1, "img_r5": ir_r5, "img_r10": ir_r10,
        "img_r_mean": ir_mean,
        "r_mean": (tr_mean + ir_mean) / 2,
    }
