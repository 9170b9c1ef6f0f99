"""Batched cross-encoder pair scoring (counterpart of
lightningdot_tpu/training/cross_scorer.py; the teacher inference of
uniter_model/inf_itm.py and train_itm.py:437-460).

The re-ranker's stage 2 and ``cli/inf_itm.py`` score (text, image) pairs
in blocks of ``pair_block`` pairs, each padded up the text and region
ladders. Every pair is scored on its own, so a call's pairs are put in
order of (text rung, region count) before they are cut into blocks: each
block then holds pairs of like length and pads only to its own longest
pair's rungs. Every block is staged through pinned buffers on a side
stream (``PinnedStager``) and launched without waiting on the host; the
scores stay on the device, are pulled once at the end and put back in the
order of the call's pairs (cross_scorer.py:53-94).

Spans (``utils/tracing.py``): ``score.call`` around a call (counting its
``pairs``), and inside it per block ``score.collate`` (counting the joint
``positions`` after padding and the ``real_positions`` of the block's own
pairs), ``score.stage`` and ``score.launch``, then ``score.pull``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from lightningdot_tpu_torch.data.loader import PinnedStager, await_staged
from lightningdot_tpu_torch.data.padding import (Recycler, bucket_len,
                                                 pad_feats, pad_ids, pad_mask,
                                                 position_ids)
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.utils import tracing


class CrossScorer:
    """Scores (text, image) pairs with the joint cross-encoder's rank head,
    or with ``use_itm_head`` the ITM logit margin (logit 1 - logit 0). The
    model moves to ``device`` (None: the card, raising where there is
    none) and scores in eval mode without a gradient."""

    def __init__(self, model, *, pair_block: int = 128,
                 txt_buckets: Sequence[int] = (16, 32, 64),
                 img_buckets: Sequence[int] = tuple(range(16, 105, 8)),
                 use_itm_head: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.pair_block = pair_block
        self.txt_buckets = txt_buckets
        self.img_buckets = img_buckets
        self.use_itm_head = use_itm_head
        self.stager = PinnedStager(self.device)

    def block(self, txt_tokens, img_feats, img_pos_feats) -> dict:
        """The host batch of one block of at most ``pair_block`` pairs,
        padded to ``pair_block`` rows with copies of the last pair."""
        n_valid, b = len(txt_tokens), self.pair_block
        tok, feats, poss = list(txt_tokens), list(img_feats), list(
            img_pos_feats)
        if n_valid < b:
            tok += [tok[-1]] * (b - n_valid)
            feats += [feats[-1]] * (b - n_valid)
            poss += [poss[-1]] * (b - n_valid)
        L = bucket_len(max(len(t) for t in tok), self.txt_buckets)
        R = bucket_len(max(f.shape[0] for f in feats), self.img_buckets)
        tracing.count("positions", b * (L + R))
        tracing.count("real_positions", sum(
            min(len(t), L) + min(f.shape[0], R)
            for t, f in zip(txt_tokens, img_feats)))
        return {
            "input_ids": pad_ids(tok, L),
            "position_ids": position_ids(b, L),
            "img_feat": pad_feats(feats, R),
            "img_pos_feat": pad_feats(poss, R),
            "attn_masks": np.concatenate(
                [pad_mask([len(t) for t in tok], L),
                 pad_mask([f.shape[0] for f in feats], R)], axis=1),
        }

    @torch.no_grad()
    def score_batch(self, batch) -> torch.Tensor:
        """[B] float32 scores of one staged (or CPU) joint batch, on the
        device."""
        was_training = self.model.training
        self.model.eval()
        try:
            if self.use_itm_head:
                logits, _ = self.model.itm_scores(batch, compute_loss=False)
                return logits[:, 1] - logits[:, 0]
            return self.model.rank_scores(batch)[:, 0]
        finally:
            self.model.train(was_training)

    def score_pairs(self, txt_tokens: List[Sequence[int]],
                    img_feats: List[np.ndarray],
                    img_pos_feats: List[np.ndarray]) -> np.ndarray:
        """-> float32 [n_pairs]; pair i is (txt_tokens[i], image i)."""
        n = len(txt_tokens)
        if n == 0:
            return np.zeros((0,), np.float32)
        b = self.pair_block
        # blocks of like pairs: a stable order by (text rung, region count)
        order = sorted(range(n), key=lambda i: (
            bucket_len(len(txt_tokens[i]), self.txt_buckets),
            img_feats[i].shape[0]))
        recycler = Recycler(enabled=self.device.type == "cuda")
        pending = []
        try:
            with tracing.span("score.call"):
                tracing.count("pairs", n)
                for st in range(0, n, b):
                    part = order[st:st + b]
                    with tracing.span("score.collate"):
                        host = self.block([txt_tokens[i] for i in part],
                                          [img_feats[i] for i in part],
                                          [img_pos_feats[i] for i in part])
                    with tracing.span("score.stage"):
                        staged = await_staged(self.stager(host))
                    with tracing.span("score.launch"):
                        pending.append(
                            self.score_batch(staged)[:min(b, n - st)])
                    done = None
                    if self.device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record()
                    recycler.push(host, ready=done)
                # one device -> host pull for every block
                with tracing.span("score.pull"):
                    sorted_scores = torch.cat(pending).float().cpu().numpy()
                scores = np.empty_like(sorted_scores)
                scores[order] = sorted_scores
                return scores
        finally:
            recycler.flush()

    def score_matrix(self, txt_tokens: List[Sequence[int]],
                     img_feats: List[np.ndarray],
                     img_pos_feats: List[np.ndarray]) -> np.ndarray:
        """The full [n_txt, n_img] matrix (inf_itm), pulled once."""
        n_txt, n_img = len(txt_tokens), len(img_feats)
        flat = self.score_pairs([t for t in txt_tokens for _ in range(n_img)],
                                list(img_feats) * n_txt,
                                list(img_pos_feats) * n_txt)
        return flat.reshape(n_txt, n_img)
