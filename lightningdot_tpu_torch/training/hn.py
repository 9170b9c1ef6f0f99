"""Hard-negative mining (the port's copy of lightningdot_tpu/training/hn.py;
reference dvl/hn.py): after each epoch, re-encode the train set, retrieve
the top min(max(2n + 10, 50), 1000) neighbours of each query from the
dense index (hn.py:53), strip the ground truths (hn.py:57-58) and sample
``num_hard_negatives`` (hn.py:62-63); the img <-> txt <-> dataset mappings
come from img2txts.json (hn.py:29-42).

Mining encodes through :func:`~lightningdot_tpu_torch.training.evaluator.
eval_model_on_dataloader`, which puts the model in eval mode: a driver
that trains on afterwards turns training mode back on.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import random
from typing import Dict, List, Optional, Tuple

import torch

from lightningdot_tpu_torch.training.evaluator import eval_model_on_dataloader
from lightningdot_tpu_torch.training.trainer_utils import build_dataloader
from lightningdot_tpu_torch.utils.logging import LOGGER


def get_img_txt_mappings(train_txt_dbs: List[str]):
    """hn.py:29-42 (``get_img_txt_mappings``, hn.py:22)."""
    train_jsons = []
    for db_folder in train_txt_dbs:
        with open(os.path.join(db_folder, "img2txts.json")) as f:
            train_jsons.append(json.load(f))
    train_img2txt: Dict[str, List[str]] = dict(
        collections.ChainMap(*train_jsons))
    train_txt2img = dict(itertools.chain(
        *[[(v, k) for v in vals] for k, vals in train_img2txt.items()]))

    train_img2set = dict(collections.ChainMap(
        *[{k: v for k in tj} for tj, v in zip(train_jsons, train_txt_dbs)]))
    train_txt2set = {t: train_img2set[im] for t, im in train_txt2img.items()}

    train_set2img = collections.defaultdict(list)
    train_set2txt = collections.defaultdict(list)
    for img_id, set_id in train_img2set.items():
        train_set2img[set_id].append(img_id)
        train_set2txt[set_id] += train_img2txt[img_id]
    return (train_img2txt, train_txt2img, train_img2set, train_txt2set,
            train_set2img, train_set2txt)


def random_hard_neg(fname2id, num_hard_negatives, id2set, set2id,
                    rng: random.Random = random):
    """hn.py:17-26 (``random_hard_neg``, hn.py:46): random same-dataset
    negatives excluding the positive(s), element-wise where the ground
    truth is a list (the reference's ``not in`` compared the whole list)."""
    hard_negs = {}
    for i in fname2id:
        gts = fname2id[i]
        gt_set = set(gts) if isinstance(gts, (list, tuple, set)) else {gts}
        pool = set2id[id2set[i]]
        if not any(c not in gt_set for c in pool):
            raise ValueError(
                f"no non-ground-truth negatives available for {i!r} in set "
                f"{id2set[i]!r} (pool size {len(pool)})")
        while True:
            hard_neg = rng.choices(pool, k=num_hard_negatives)
            if not gt_set & set(hard_neg):
                break
        hard_negs[i] = hard_neg
    return hard_negs


def sampled_hard_negatives(model, train_datasets, collate_func, args,
                           train_img2txt, train_txt2img,
                           rng: random.Random = random,
                           device: Optional[torch.device] = None
                           ) -> Tuple[dict, dict]:
    """hn.py:45-66 (``sampled_hard_negatives``, hn.py:75) ->
    (hard_negs_txt, hard_negs_img): img -> [txt ids], txt id -> [img
    fnames]. The ground truths are removed in order (a set difference
    would iterate in per-process hash order and defeat the seeded
    ``rng``), and a pool shorter than ``num_hard_negatives`` raises (the
    collate assumes 1 + n rows per item)."""
    hard_negs_txt_all, hard_negs_img_all = [], []
    for dset in train_datasets:
        dset.new_epoch()
        loader = build_dataloader(dset, collate_func, True, args,
                                  args.valid_batch_size)
        num_hard_sampled = min(max(args.num_hard_negatives * 2 + 10, 50), 1000)
        result = eval_model_on_dataloader(
            model, loader, img2txt=train_img2txt, num_tops=num_hard_sampled,
            vector_size=model.txt_cfg.out_size, device=device)
        rank_txt_res, rank_img_res = result.rank_results
        hard_neg_img = {k: list(v) for k, v in rank_txt_res.items()}
        hard_neg_txt = {k: list(v) for k, v in rank_img_res.items()}

        for k, v in hard_neg_img.items():
            if train_txt2img[k] in v:
                v.remove(train_txt2img[k])
        hard_neg_txt = {
            k: [x for x in v if x not in set(train_img2txt[k])]
            for k, v in hard_neg_txt.items()}

        def sample(pool, what, k):
            if len(pool) < args.num_hard_negatives:
                raise ValueError(
                    f"only {len(pool)} hard-negative candidates for {what} "
                    f"{k!r} (need {args.num_hard_negatives}); lower "
                    f"--num_hard_negatives or enlarge the candidate pool")
            return rng.sample(pool, args.num_hard_negatives)

        hard_negs_txt_all.append(
            {k: sample(v, "img", k) for k, v in hard_neg_txt.items()})
        hard_negs_img_all.append(
            {k: sample(v, "txt", k) for k, v in hard_neg_img.items()})
    hard_negs_txt = dict(collections.ChainMap(*hard_negs_txt_all))
    hard_negs_img = dict(collections.ChainMap(*hard_negs_img_all))
    LOGGER.info("mined hard negatives for %d txts / %d imgs",
                len(hard_negs_img), len(hard_negs_txt))
    return hard_negs_txt, hard_negs_img
