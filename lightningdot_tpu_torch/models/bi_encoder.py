"""Two-tower bi-encoder, text side only (counterpart of
lightningdot_tpu/models/bi_encoder.py:37-48,93-131).

The image tower, the losses and the pre-training heads are later slices of
the port (ROADMAP.md, queue A).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from lightningdot_tpu.config import EncoderConfig
from lightningdot_tpu_torch.models.encoder import TextEncoder
from lightningdot_tpu_torch.ops import mm_f32


def dot_product_scores(q_vectors: torch.Tensor,
                       ctx_vectors: torch.Tensor) -> torch.Tensor:
    """q [n1, D] x ctx [n2, D] -> float32 [n1, n2] (reference
    bi_encoder.py:54-68), accumulated in float32."""
    return mm_f32(q_vectors, ctx_vectors.t())


class BiEncoder(nn.Module):
    """The text tower of the bi-encoder; ``txt_model.*`` state-dict keys as
    in the reference's fine-tune checkpoints (bi_encoder.py:203-219)."""

    def __init__(self, txt_cfg: EncoderConfig,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.txt_cfg = txt_cfg
        self.compute_dtype = compute_dtype
        self.txt_model = TextEncoder(txt_cfg)

    def encode_txt(self, sb: Dict[str, Any]) -> torch.Tensor:
        """Text sub-batch (input_ids, attention_mask, position_ids) ->
        pooled [B, out] in the compute dtype."""
        _, pooled = self.txt_model(sb["input_ids"], sb["attention_mask"],
                                   sb["position_ids"],
                                   dtype=self.compute_dtype)
        return pooled
