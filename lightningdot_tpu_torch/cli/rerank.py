"""Two-stage retrieval (the port's ``rerank``, lightningdot_tpu/cli/rerank.py;
reference rerank.py): stage 1 encodes the split with the bi-encoder,
indexes both sides and retrieves the top 100 per query in both directions
with recall@{1,5,10,20,50,100} (rerank.py:149-214); stage 2 re-scores the
top-{10,20,50,100} candidates with cross-encoder scores and reports the
recall after re-ranking (rerank.py:256-292).

Stage 2's scores come from ``--score_file`` (the pickled (score_matrix,
txt_ids, img_ids) of either package's ``inf_itm``, rerank.py:227-233) or
from ``--teacher_checkpoint``, a cross-encoder that scores the retrieved
candidates on the fly: the max-threshold candidates of every query, once
per direction, through one :class:`CrossScorer` pass. The teacher
computes in float32 whatever ``--compute_dtype`` (the bi-encoder's) is,
as JAX's.

It runs on the card by default, or on the CPU with ``--device cpu``.

Usage:
  python -m lightningdot_tpu_torch.cli.rerank --config configs/coco_eval.json \
      --biencoder_checkpoint ... --teacher_checkpoint teacher_dir
"""
from __future__ import annotations

import argparse
import itertools
import json
import pickle
import time

import numpy as np

import torch

from lightningdot_tpu_torch.config import (add_itm_params, default_params,
                                           parse_with_config, print_args)
from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
from lightningdot_tpu_torch.data.itm import CollateConfig, itm_fast_collate
from lightningdot_tpu_torch.models.factory import (build_biencoder,
                                                   load_cross_encoder)
from lightningdot_tpu_torch.training.cross_scorer import CrossScorer
from lightningdot_tpu_torch.training.evaluator import eval_model_on_dataloader
from lightningdot_tpu_torch.training.trainer_utils import (build_dataloader,
                                                           load_dataset)
from lightningdot_tpu_torch.utils.logging import LOGGER
from lightningdot_tpu_torch.utils.runtime import setup_runtime

RECALL_TOPS = (1, 5, 10, 20, 50, 100)
RERANK_THRESHOLDS = (10, 20, 50, 100)


def build_parser():
    parser = argparse.ArgumentParser("rerank", allow_abbrev=False)
    default_params(parser)
    add_itm_params(parser)
    parser.add_argument("--teacher_checkpoint", default=None, type=str,
                        help="cross-encoder that scores stage 2 on the fly")
    parser.add_argument("--score_file", default=None, type=str,
                        help="pickled (score_matrix, txt_ids, img_ids)")
    parser.add_argument("--num_tops", default=100, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="default: the CUDA card (raises without "
                             "one); 'cpu' runs the plain PyTorch path")
    return parser


def main(cmds=None):
    """-> the recall dicts of both stages; prints them as JSON last."""
    args = parse_with_config(build_parser(), cmds)
    print_args(args, LOGGER.info)
    setup_runtime(args)

    model = build_biencoder(args, seed=args.seed)
    vector_size = model.txt_cfg.out_size

    all_img_dbs = ImageDbGroup(args.conf_th, args.max_bb, args.min_bb,
                               args.num_bb)
    dataset = load_dataset(all_img_dbs, args.test_txt_db, args.test_img_db,
                           args, is_train=False)
    dataset.new_epoch()
    collate = lambda items: itm_fast_collate(  # noqa: E731
        items, CollateConfig(fixed_batch=args.valid_batch_size))
    dataloader = build_dataloader(dataset, collate, False, args)
    img2txt = dataset.txt_db.img2txts
    txt2img = dict(itertools.chain(
        *[[(v, k) for v in vals] for k, vals in img2txt.items()]))

    # ---- stage 1: dense retrieval (rerank.py:149-214) ----------------------
    result = eval_model_on_dataloader(model, dataloader, img2txt=img2txt,
                                      no_eval=True, vector_size=vector_size,
                                      device=args.device)
    indexer_img, indexer_txt = result.indexers
    txt_emb, img_emb = result.embeddings["txt"], result.embeddings["img"]
    txt_ids = list(txt_emb.keys())
    img_ids = list(img_emb.keys())

    # stage-1 candidate depth: at least the recall table, deeper if asked
    depth = max(max(RECALL_TOPS), args.num_tops)
    t0 = time.time()
    res_img = indexer_img.search_knn(np.stack(list(txt_emb.values())), depth)
    res_txt = indexer_txt.search_knn(np.stack(list(img_emb.values())), depth)
    search_time = time.time() - t0

    ranking_res_img = {t: r[0] for t, r in zip(txt_ids, res_img)}
    ranking_res_txt = {f: r[0] for f, r in zip(img_ids, res_txt)}

    recall_img2 = {k: 0 for k in RECALL_TOPS}
    for t in txt_ids:
        r = ranking_res_img[t]
        for top in recall_img2:
            recall_img2[top] += txt2img[t] in r[:top]
    recall_txt2 = {k: 0 for k in RECALL_TOPS}
    for f in img_ids:
        r = ranking_res_txt[f]
        for top in recall_txt2:
            recall_txt2[top] += any(t in r[:top] for t in img2txt[f])
    recall_img2 = {k: v / len(txt_ids) for k, v in recall_img2.items()}
    recall_txt2 = {k: v / len(img_ids) for k, v in recall_txt2.items()}
    LOGGER.info("stage-1 search time: %.2fs "
                "(%d txt + %d img queries)",
                search_time, len(txt_ids), len(img_ids))
    LOGGER.info("img retrieval (dense): %s", recall_img2)
    LOGGER.info("txt retrieval (dense): %s", recall_txt2)

    # ---- stage 2: cross-encoder rescoring ---------------------------------
    out = {"stage1_img": recall_img2, "stage1_txt": recall_txt2}
    get_pair_score = _load_pair_scorer(args, dataset, txt_ids)
    if get_pair_score is None:
        print(json.dumps(out, default=float))
        return out

    score_txt_queries, score_img_queries = get_pair_score
    max_th = min(max(RERANK_THRESHOLDS), depth)
    # the max-threshold candidates of every query, scored once per
    # direction (one pull of the scores each); the thresholds slice them
    t0 = time.time()
    cand_scores_img = score_txt_queries(
        [(t, list(ranking_res_img[t][:max_th])) for t in txt_ids])
    cand_scores_txt = score_img_queries(
        [(f, list(ranking_res_txt[f][:max_th])) for f in img_ids])
    stage2_s = time.time() - t0
    n_pairs = max_th * (len(txt_ids) + len(img_ids))
    LOGGER.info("stage 2: %d pairs in %.2fs", n_pairs, stage2_s)

    for threshold in RERANK_THRESHOLDS:
        recall_rerank = {1: 0, 5: 0, 10: 0}
        for txt_id in txt_ids:
            cands = list(ranking_res_img[txt_id][:threshold])
            scores = cand_scores_img[txt_id][:threshold]
            order = np.argsort(-scores)[:10]
            reranked = [cands[i] for i in order]
            for top in recall_rerank:
                recall_rerank[top] += txt2img[txt_id] in reranked[:top]
        rec = {k: v / len(txt_ids) for k, v in recall_rerank.items()}
        LOGGER.info("rerank ir top-%d: %s", threshold, rec)
        out[f"rerank_img_top{threshold}"] = rec

    for threshold in RERANK_THRESHOLDS:
        recall_rerank = {1: 0, 5: 0, 10: 0}
        for img_id in img_ids:
            cands = list(ranking_res_txt[img_id][:threshold])
            scores = cand_scores_txt[img_id][:threshold]
            order = np.argsort(-scores)[:10]
            reranked = [cands[i] for i in order]
            for top in recall_rerank:
                recall_rerank[top] += any(t in reranked[:top]
                                          for t in img2txt[img_id])
        rec = {k: v / len(img_ids) for k, v in recall_rerank.items()}
        LOGGER.info("rerank tr top-%d: %s", threshold, rec)
        out[f"rerank_txt_top{threshold}"] = rec

    print(json.dumps(out, default=float))
    return out


def _load_pair_scorer(args, dataset, txt_ids):
    """(score_txt_queries, score_img_queries), each scoring all queries of
    a direction in one call: ``score_txt_queries([(txt_id, [img_ids]),
    ...]) -> {txt_id: scores}`` and the converse; None where no score
    source is configured."""
    if args.score_file:
        with open(args.score_file, "rb") as f:
            tup = pickle.load(f)
        scores_mat, f_txt_ids, f_img_ids = tup[0], tup[1], tup[2]
        scores_mat = np.asarray(scores_mat)
        ti = {t: i for i, t in enumerate(f_txt_ids)}
        ii = {im: i for i, im in enumerate(f_img_ids)}

        def score_txt_queries(items):
            return {t: np.asarray([scores_mat[ti[t]][ii[im]] for im in ims])
                    for t, ims in items}

        def score_img_queries(items):
            return {im: np.asarray([scores_mat[ti[t]][ii[im]] for t in ts])
                    for im, ts in items}

        return score_txt_queries, score_img_queries

    if args.teacher_checkpoint:
        teacher = load_cross_encoder(args.teacher_checkpoint,
                                     model_config=args.img_model_config,
                                     compute_dtype=torch.float32,
                                     device=args.device)
        scorer = CrossScorer(teacher, device=args.device)
        txt_db = dataset.txt_db
        img_db = dataset.img_db
        tok_cache = {t: txt_db.combine_inputs(txt_db[t]["input_ids"])
                     for t in txt_ids}
        feat_cache = {}

        def feats(im):
            if im not in feat_cache:
                f, p, _ = img_db.get_img_feat(im)
                feat_cache[im] = (f, p)
            return feat_cache[im]

        def _score_flat(items, pair_of):
            toks, fs, ps, counts = [], [], [], []
            for q, cands in items:
                counts.append(len(cands))
                for c in cands:
                    tok, (f, p) = pair_of(q, c)
                    toks.append(tok)
                    fs.append(f)
                    ps.append(p)
            flat = scorer.score_pairs(toks, fs, ps)
            out, pos = {}, 0
            for (q, _), n in zip(items, counts):
                out[q] = flat[pos:pos + n]
                pos += n
            return out

        def score_txt_queries(items):
            return _score_flat(
                items, lambda t, im: (tok_cache[t], feats(im)))

        def score_img_queries(items):
            return _score_flat(
                items, lambda im, t: (tok_cache[t], feats(im)))

        return score_txt_queries, score_img_queries

    LOGGER.info("no score_file / teacher_checkpoint: skipping stage 2")
    return None


if __name__ == "__main__":
    main()
