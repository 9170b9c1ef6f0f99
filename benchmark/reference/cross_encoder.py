"""UNITER-base's cross-encoder in plain float32 PyTorch: the joint text and
region sequence through the layers, the tanh pooler of the [CLS] row and
the scalar rank head (uniter_model/model/itm.py's
UniterForImageTextRetrieval, as ``cli/rerank.py`` scores with it), in eval
mode. Nothing of the program is imported.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from reference.bert import (Params, Precision, _linear, bert_layout, dense,
                            encoder, pad_rows, region_embeddings,
                            text_embeddings)


def layout(cfg: dict):
    h = cfg["model"]["hidden_size"]
    return (bert_layout(cfg["model"], "bert.", True)
            + _linear("itm_output", 2, h) + _linear("rank_output", 1, h))


@torch.no_grad()
def rank_scores(p: Params, caps: Sequence[np.ndarray],
                regions: Sequence[Tuple[np.ndarray, np.ndarray]], cfg: dict,
                prec: Precision, device) -> torch.Tensor:
    """float32 [B] rank logits of pairs (caption i, image i)."""
    c = cfg["model"]
    ids, tmask = pad_rows([torch.as_tensor(x, dtype=torch.int64,
                                           device=device) for x in caps],
                          max(len(x) for x in caps))
    n_reg = max(f.shape[0] for f, _ in regions)
    feat, rmask = pad_rows([torch.as_tensor(f, device=device).float()
                            for f, _ in regions], n_reg)
    boxes, _ = pad_rows([torch.as_tensor(b, device=device).float()
                         for _, b in regions], n_reg)
    pos = torch.arange(ids.shape[1], device=device).expand(*ids.shape)
    h = torch.cat([text_embeddings(p, "bert.", ids, pos, c, None),
                   region_embeddings(p, "bert.", feat, boxes, c, prec, None)],
                  dim=1)
    h = encoder(h, torch.cat([tmask, rmask], dim=1), p, "bert.", c, prec,
                None)
    pooled = torch.tanh(dense(h[:, 0], p, "bert.pooler.dense", prec))
    return dense(pooled, p, "rank_output", prec)[:, 0]
