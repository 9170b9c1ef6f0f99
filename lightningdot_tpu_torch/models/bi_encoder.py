"""Two-tower bi-encoder (counterpart of
lightningdot_tpu/models/bi_encoder.py:37-48,93-167).

Built in eval mode; ``train()`` turns dropout on, with the masks drawn from
the generators passed to :meth:`BiEncoder.apply`. The ITM loss is
``training/itm_step.py``; the pre-training heads are a later slice of the
port (ROADMAP.md, queue A).
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
