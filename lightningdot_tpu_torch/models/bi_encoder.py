"""Two-tower bi-encoder and its in-batch loss (counterpart of
lightningdot_tpu/models/bi_encoder.py:37-167).

Built in eval mode; ``train()`` turns dropout on, with the masks drawn from
the generators passed to :meth:`BiEncoder.apply`. The training step's
bidirectional loss is ``training/itm_step.py``; :class:`BiEncoderNllLoss`
is the one-directional form the evaluator reports. The pre-training heads
are a later slice of the port (ROADMAP.md, queue A).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.models.encoder import ImageEncoder, TextEncoder
from lightningdot_tpu_torch.ops import mm_f32


def dot_product_scores(q_vectors: torch.Tensor,
                       ctx_vectors: torch.Tensor) -> torch.Tensor:
    """q [n1, D] x ctx [n2, D] -> float32 [n1, n2] (reference
    bi_encoder.py:54-68), accumulated in float32."""
    return mm_f32(q_vectors, ctx_vectors.t())


class BiEncoderNllLoss:
    """In-batch contrastive NLL (the port's ``BiEncoderNllLoss.calc``,
    lightningdot_tpu/models/bi_encoder.py:51-91; reference
    dvl/models/bi_encoder.py:613-665)."""

    @staticmethod
    def calc(q_vectors: torch.Tensor, ctx_vectors: torch.Tensor,
             caption_vectors: Optional[torch.Tensor], positive_idx,
             hard_negative_idx=None, caption_score_weight: float = 0.1,
             reduction: str = "mean", col_valid=None):
        """Returns (loss, correct_prediction_count, scores), float32 on the
        vectors' device.

        ``positive_idx``: int [n_q] of the positive ctx column per query.
        ``col_valid``: optional [n_ctx] 0/1 mask: invalid context columns
        (fixed-size batch padding duplicates) are excluded from every OTHER
        row's softmax denominator (each row's own positive stays unmasked).
        ``hard_negative_idx`` is accepted for the reference's signature and
        unused, as there.
        """
        del hard_negative_idx
        scores = dot_product_scores(q_vectors, ctx_vectors)
        if caption_vectors is not None and caption_score_weight != 0:
            scores_cap = dot_product_scores(q_vectors, caption_vectors)
            scores = ((1 - caption_score_weight) * scores
                      + caption_score_weight * scores_cap)
        positive_idx = torch.as_tensor(positive_idx, dtype=torch.int64,
                                       device=scores.device)
        if col_valid is not None:
            col_valid = torch.as_tensor(col_valid, dtype=scores.dtype,
                                        device=scores.device)
            col_mask = (1.0 - col_valid)[None, :] * -1e30
            diag = torch.nn.functional.one_hot(
                positive_idx, scores.shape[1]).to(scores.dtype)
            scores = scores + col_mask * (1.0 - diag)
        log_probs = torch.log_softmax(scores, dim=1)
        nll = -log_probs.gather(1, positive_idx[:, None])[:, 0]
        if reduction == "mean":
            loss = nll.mean()
        elif reduction == "sum":
            loss = nll.sum()
        else:
            loss = nll
        correct = (log_probs.argmax(dim=1) == positive_idx).sum()
        return loss, correct, scores


class BiEncoder(nn.Module):
    """The two towers; ``txt_model.*`` and ``img_model.*`` state-dict keys
    as in the reference's fine-tune checkpoints (bi_encoder.py:203-219).
    Without ``img_cfg`` only the text tower is built (the query server
    needs no image tower)."""

    def __init__(self, txt_cfg: EncoderConfig,
                 img_cfg: Optional[EncoderConfig] = None, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.txt_cfg = txt_cfg
        self.img_cfg = img_cfg
        self.compute_dtype = compute_dtype
        self.txt_model = TextEncoder(txt_cfg)
        self.img_model = ImageEncoder(img_cfg) if img_cfg is not None else None
        self.train(False)

    def encode_txt(self, sb: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Text sub-batch (input_ids, attention_mask, position_ids) ->
        pooled [B, out] in the compute dtype."""
        _, pooled = self.txt_model(sb["input_ids"], sb["attention_mask"],
                                   sb["position_ids"],
                                   dtype=self.compute_dtype,
                                   generator=generator)
        return pooled

    def encode_img(self, sb: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Image sub-batch (input_ids [B, 1], attention_mask, img_feat,
        img_pos_feat, optional img_masks) -> pooled [B, out] in the compute
        dtype."""
        if self.img_model is None:
            raise ValueError("this BiEncoder was built without an image "
                             "tower (img_cfg=None)")
        _, pooled = self.img_model(sb["input_ids"], sb["attention_mask"],
                                   sb["img_feat"], sb["img_pos_feat"],
                                   img_masks=sb.get("img_masks"),
                                   dtype=self.compute_dtype,
                                   generator=generator)
        return pooled

    def apply(self, batch: Dict[str, Any],
              generators: Optional[Sequence[torch.Generator]] = None):
        """batch{'txts', 'imgs', 'caps'} -> (txt, img, cap) pooled vectors,
        None where the sub-batch is missing (bi_encoder.py:146-167).

        ``generators``: (txt, img, cap), one per pass, as JAX splits one key
        three ways; needed in training mode with dropout."""
        g_txt, g_img, g_cap = generators or (None, None, None)
        txt = img = cap = None
        if batch.get("txts") is not None:
            txt = self.encode_txt(batch["txts"], g_txt)
        if batch.get("imgs") is not None:
            img = self.encode_img(batch["imgs"], g_img)
        caps = batch.get("caps")
        if caps is not None and caps.get("input_ids") is not None:
            cap = self.encode_txt(caps, g_cap)
        return txt, img, cap
