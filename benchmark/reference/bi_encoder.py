"""LightningDOT's bi-encoder in plain float32 PyTorch: the text and image
towers with their projection heads, the bidirectional in-batch loss, and
clipped AdamW steps, as the reference fine-tunes (dvl/models/bi_encoder.py,
train_itm.py; the AdamW of transformers 2.x: eps on the uncorrected
sqrt(v), the bias correction in the step size).

A configuration file gives ``text`` and ``image`` (BERT-base cased and
UNITER-base widths) and ``project_dim``. Inputs are the benchmark's raw
captions (token id arrays, [CLS] ... [SEP]) and regions ((features,
boxes) arrays); the reference pads them itself. Nothing of the program is
imported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.bert import (Dropout, Params, Precision, _linear, _norm,
                            bert_layout, dense, encoder, layer_norm,
                            pad_rows, region_embeddings, text_embeddings)

CLS_ID = 101


def tower_layout(cfg: dict, pre: str, image: bool, project_dim: int):
    h = cfg["hidden_size"]
    return (bert_layout(cfg, f"{pre}bert.", image)
            + _linear(f"{pre}encode_proj.0", 2 * h, h)
            + _norm(f"{pre}encode_proj.2", 2 * h)
            + _linear(f"{pre}encode_proj.3", project_dim, 2 * h))


def layout(cfg: dict):
    pd = cfg["project_dim"]
    return (tower_layout(cfg["text"], "txt_model.", False, pd)
            + tower_layout(cfg["image"], "img_model.", True, pd))


def _project(x, p: Params, pre: str, cfg: dict, prec: Precision):
    y = F.gelu(dense(x, p, f"{pre}encode_proj.0", prec))
    y = layer_norm(y, p, f"{pre}encode_proj.2", cfg["layer_norm_eps"])
    return dense(y, p, f"{pre}encode_proj.3", prec)


def text_vectors(p: Params, caps: Sequence[np.ndarray], length: int,
                 cfg: dict, prec: Precision, drop: Optional[Dropout],
                 device) -> torch.Tensor:
    """[B, project_dim] of captions padded to ``length``."""
    c = cfg["text"]
    ids, mask = pad_rows([torch.as_tensor(x, dtype=torch.int64,
                                          device=device) for x in caps],
                         length)
    pos = torch.arange(length, device=device).expand(len(caps), length)
    h = text_embeddings(p, "txt_model.bert.", ids, pos, c, drop)
    h = encoder(h, mask, p, "txt_model.bert.", c, prec, drop)
    return _project(h[:, 0], p, "txt_model.", c, prec)


def image_vectors(p: Params, regions: Sequence[Tuple[np.ndarray,
                                                     np.ndarray]],
                  n_regions: int, cfg: dict, prec: Precision,
                  drop: Optional[Dropout], device) -> torch.Tensor:
    """[B, project_dim] of images, their regions padded to ``n_regions``,
    after a [CLS] token (type 0, position 0)."""
    c = cfg["image"]
    feat, rmask = pad_rows([torch.as_tensor(f, device=device).float()
                            for f, _ in regions], n_regions)
    boxes, _ = pad_rows([torch.as_tensor(b, device=device).float()
                         for _, b in regions], n_regions)
    b = len(regions)
    zeros = torch.zeros((b, 1), dtype=torch.int64, device=device)
    cls = text_embeddings(p, "img_model.bert.", zeros + CLS_ID, zeros, c,
                          drop)
    img = region_embeddings(p, "img_model.bert.", feat, boxes, c, prec, drop)
    mask = torch.cat([torch.ones_like(zeros), rmask], dim=1)
    h = encoder(torch.cat([cls, img], dim=1), mask, p, "img_model.bert.", c,
                prec, drop)
    return _project(h[:, 0], p, "img_model.", c, prec)


def itm_loss(txt: torch.Tensor, img: torch.Tensor,
             prec: Precision) -> torch.Tensor:
    """The mean of both directions' in-batch NLL, positives on the
    diagonal."""
    idx = torch.arange(txt.shape[0], device=txt.device)

    def nll(q, ctx):
        return -torch.log_softmax(prec.mm(q, ctx.t()), dim=1)[idx,
                                                              idx].mean()

    return 0.5 * nll(img, txt) + 0.5 * nll(txt, img)


def pass_generators(step_seed: int, device) -> List[torch.Generator]:
    """The (text, image, caption) passes' generators of a step handed the
    CPU generator seeded ``step_seed``: three seeds drawn by
    ``torch.randint(0, 2**62, (3,))`` from it, one generator each on the
    device."""
    cpu = torch.Generator().manual_seed(int(step_seed))
    seeds = torch.randint(0, 2 ** 62, (3,), generator=cpu)
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def train_steps(state: Params, batches: Sequence[dict],
                step_seeds: Sequence[int], cfg: dict, job: dict,
                prec: Precision, *, half: bool = False) -> dict:
    """Run ``len(batches)`` fine-tuning steps from ``state`` (left as it
    is). A batch is {"captions", "regions", "txt_len", "img_len"} (the
    padded lengths: the dropout draws follow the padded shapes). ``half``
    plants a fault: the loss of the first half of each batch only.

    Returns {"losses": [float], "grad_norms": {name: norm of step 1's
    clipped gradient}, "change_norms": {name: norm of the change of the
    parameters over the steps}}."""
    device = next(iter(state.values())).device
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.items()}
    names = list(params)
    m = {k: torch.zeros_like(v) for k, v in state.items()}
    v2 = {k: torch.zeros_like(v) for k, v in state.items()}
    b1, b2, eps = job["betas"][0], job["betas"][1], job["adam_eps"]
    lr, max_norm = job["learning_rate"], job["max_grad_norm"]
    t_cfg, i_cfg = cfg["text"], cfg["image"]
    losses, grad_norms = [], {}
    for t, (batch, seed) in enumerate(zip(batches, step_seeds), start=1):
        g_txt, g_img, _ = pass_generators(seed, device)
        txt = text_vectors(params, batch["captions"], batch["txt_len"], cfg,
                           prec, Dropout(g_txt, t_cfg["hidden_dropout_prob"],
                                         t_cfg["attention_probs_dropout_prob"],
                                         t_cfg["num_hidden_layers"]), device)
        img = image_vectors(params, batch["regions"], batch["img_len"] - 1,
                            cfg, prec,
                            Dropout(g_img, i_cfg["hidden_dropout_prob"],
                                    i_cfg["attention_probs_dropout_prob"],
                                    i_cfg["num_hidden_layers"]), device)
        if half:
            n = txt.shape[0] // 2
            txt, img = txt[:n], img[:n]
        loss = itm_loss(txt, img, prec)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)]
        with torch.no_grad():
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = max_norm / torch.clamp(norm, min=max_norm)
            step_size = lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
            for k, g in zip(names, grads):
                g = g * scale
                if t == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(b1).add_((1.0 - b1) * g)
                v2[k].mul_(b2).add_((1.0 - b2) * g * g)
                params[k].sub_(step_size * m[k] / (v2[k].sqrt() + eps))
        losses.append(float(loss.detach()))
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(params[k] - state[k]))
                  for k in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
