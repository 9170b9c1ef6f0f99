"""The teacher's hard-negative mining over random candidate pools
(counterpart of lightningdot_tpu/training/hn_teacher.py; reference
get_hard_negs / compute_hard_neg, uniter_model/train_itm.py:50-65,306-365).

For every text, the eval-mode teacher scores a random pool of
``mini_batch_size`` images (``ItmHardNegDataset`` batches) and the top
``hard_negative_num`` stay; for every image, the scores it received
across all pools are gathered and its top texts stay. The maps are
written as JSON and reloaded into ``ItmRankDatasetHardNeg``.

The score functions stage each pool through pinned buffers
(``PinnedStager``) and return the scores on the device; ``get_hard_negs``
keeps ``pipeline_depth`` pools in flight before it pulls the oldest.
Across processes each rank mines its rank-strided shard of texts, and the
image -> texts map merges every rank's texts (``compute_hard_neg``).
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from lightningdot_tpu_torch.data.loader import PinnedStager, await_staged
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.parallel.mesh import barrier, is_main_process
from lightningdot_tpu_torch.utils.logging import LOGGER
from lightningdot_tpu_torch.utils.misc import host_all_gather


def _scoring(model, device, keys, fn) -> Callable:
    device = resolve_device(device)
    model.to(device)
    stager = PinnedStager(device)

    @torch.no_grad()
    def score(batch):
        staged = await_staged(stager({k: batch[k] for k in keys}))
        was_training = model.training
        model.eval()
        try:
            return fn(staged)
        finally:
            model.train(was_training)

    return score


def make_joint_score_fn(model, device=None) -> Callable:
    """``score(batch) -> [pool]`` eval-mode rank scores of the joint
    cross-encoder over the ``ItmHardNegDataset`` / ``ItmValDataset``
    layout (split masks, joined here) (``make_joint_score_fn``,
    hn_teacher.py:31-56). The model's weights are its own, so a re-mining
    pass sees the trained ones."""
    keys = ("input_ids", "position_ids", "img_feat", "img_pos_feat",
            "attn_masks")
    inner = _scoring(model, device, keys,
                     lambda b: model.rank_scores(b)[:, 0])

    def fn(batch):
        joint = dict(batch, attn_masks=np.concatenate(
            [batch["attn_masks_text"], batch["attn_masks_img"]], axis=1))
        return inner(joint)

    return fn


def make_fast_score_fn(model, device=None) -> Callable:
    """``score(batch) -> [pool]`` eval-mode cosine scores of
    ``CrossEncoderFast`` (``make_fast_score_fn``, hn_teacher.py:59-71)."""
    keys = ("input_ids", "position_ids", "img_feat", "img_pos_feat",
            "attn_masks_text", "attn_masks_img")
    return _scoring(model, device, keys, model.rank_scores)


def _host(scores) -> np.ndarray:
    if isinstance(scores, torch.Tensor):
        scores = scores.float().cpu().numpy()
    return np.asarray(scores, np.float32)


def get_hard_negs(score_fn: Callable, loader, hard_negative_num: int = 20,
                  *, pipeline_depth: int = 8
                  ) -> Tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    """(txt2hardimgs, img2hardtxts) (train_itm.py:306-365;
    ``get_hard_negs``, hn_teacher.py:74-134). ``loader`` yields
    ``ItmHardNegDataset`` batches; ``score_fn(batch)`` returns the pool's
    scores (a tensor on any device, or numpy)."""
    LOGGER.info("start running hard negative extraction")
    st = time.time()
    txt2hardimgs: Dict[str, List[str]] = {}
    img_to_score_txts = defaultdict(list)
    in_flight = deque()

    def drain_one():
        dev_scores, txt, imgs = in_flight.popleft()
        scores = _host(dev_scores)
        k = min(hard_negative_num, len(imgs))
        hard_idx = np.argpartition(-scores, k - 1)[:k]
        txt2hardimgs[txt] = [imgs[int(i)] for i in hard_idx]
        for i, img in enumerate(imgs):
            img_to_score_txts[img].append((float(scores[i]), txt))

    for batch in loader:
        in_flight.append((score_fn(batch), batch["gt_txt_id"],
                          batch["neg_img_ids"]))
        if len(in_flight) >= pipeline_depth:
            drain_one()
    while in_flight:
        drain_one()

    LOGGER.info("start computing hard texts from images...")
    n_less_neg = 0
    img2hardtxts: Dict[str, List[str]] = {}
    for img, score_txts in img_to_score_txts.items():
        if len(score_txts) < hard_negative_num:
            img2hardtxts[img] = [t for _, t in score_txts]
            n_less_neg += 1
        else:
            s = np.asarray([sc for sc, _ in score_txts], np.float32)
            top = np.argpartition(-s, hard_negative_num - 1)
            img2hardtxts[img] = [score_txts[int(i)][1]
                                 for i in top[:hard_negative_num]]
    if n_less_neg:
        LOGGER.info("Warning: %d images did not sample enough negatives",
                    n_less_neg)
    LOGGER.info("hard negative extraction finished in %d seconds",
                int(time.time() - st))
    return txt2hardimgs, img2hardtxts


def compute_hard_neg(score_fn: Callable, loader, datasets,
                     hard_negative_num: int, hard_neg_dir: str,
                     rank: int = 0) -> None:
    """Mine, write the JSON maps, and reload them into the training
    dataset(s) (train_itm.py:50-65; ``compute_hard_neg``,
    hn_teacher.py:137-171). Across processes each rank writes its own
    text -> images map (it trains on its own text shard), the image ->
    texts map gathers every rank's texts and rank 0 alone writes it, and
    no rank reloads before the files are written (a barrier)."""
    txt2hardimgs, img2hardtxts = get_hard_negs(score_fn, loader,
                                               hard_negative_num)
    merged: dict = {}
    for part in host_all_gather(img2hardtxts):
        for img, txts in part.items():
            merged.setdefault(img, []).extend(txts)
    os.makedirs(hard_neg_dir, exist_ok=True)
    with open(os.path.join(hard_neg_dir,
                           f"txt2hardimgs_rank{rank}.json"), "w") as f:
        json.dump(txt2hardimgs, f)
    if is_main_process():
        with open(os.path.join(hard_neg_dir, "img2hardtxts.json"),
                  "w") as f:
            json.dump(merged, f)
    barrier()
    if not isinstance(datasets, (list, tuple)):
        datasets = [datasets]
    for dset in datasets:
        dset.reload_hard_negs(hard_neg_dir, rank=rank)
