"""The VQA head on the bi-encoder (counterpart of
lightningdot_tpu/models/vqa.py; reference BiEncoderForVisualQuestionAnswering,
dvl/models/bi_encoder.py:683-734).

The towers' pooled vectors, concatenated as ``[q, ctx]`` (or, with
``intersection``, ``[q, ctx, q*ctx, q+ctx]``), go through the answer head
Linear -> GELU -> LayerNorm -> Linear, with the scores in float32, and an
elementwise BCE-with-logits against the soft targets. The head's
LayerNorm spans 4x (8x with ``intersection``) the towers' output width:
3,072 and 6,144 at ``out_size`` 768, through B1's kernels on the card
(``ops/layernorm.py``). Parameter names are the reference's
(``biencoder.txt_model.*``, ``biencoder.img_model.*``, and
``vqa_output.{0,2,3}`` for its ``nn.Sequential(Linear, GELU, LayerNorm,
Linear)``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
from lightningdot_tpu_torch.models.encoder import Dense, LayerNorm
from lightningdot_tpu_torch.ops import gelu

LN_EPS = 1e-12   # the JAX head's layer_norm default (ops/layernorm.py)


def bce_with_logits(scores: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """``F.binary_cross_entropy_with_logits(reduction='none')`` in the
    JAX package's form: max(s, 0) - s t + log1p(exp(-|s|)), float32."""
    t = targets.float()
    return (torch.clamp(scores, min=0) - scores * t
            + torch.log1p(torch.exp(-scores.abs())))


class BiEncoderForVQA(nn.Module):
    """``BiEncoderForVQA`` (vqa.py:24-63) over the port's
    :class:`BiEncoder`. Built in eval mode, as the towers are."""

    def __init__(self, biencoder: BiEncoder, hidden_size: int,
                 num_answer: int, intersection: bool = False):
        super().__init__()
        self.biencoder = biencoder
        self.hidden_size = hidden_size
        self.num_answer = num_answer
        self.intersection = intersection
        h = hidden_size * (2 if intersection else 1) * 2
        self.vqa_output = nn.ModuleDict({"0": Dense(h, 2 * h),
                                         "2": LayerNorm(2 * h, LN_EPS),
                                         "3": Dense(2 * h, num_answer)})
        self.train(False)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.biencoder.compute_dtype

    def apply(self, batch: Dict[str, Any],
              generators: Optional[Sequence[torch.Generator]] = None,
              targets: Optional[torch.Tensor] = None,
              compute_loss: bool = False) -> torch.Tensor:
        """batch{'txts', 'imgs'} -> float32 scores [B, num_answer], or with
        ``compute_loss`` the elementwise BCE against ``targets``
        (``apply``, vqa.py:43-63). ``generators`` as in
        :meth:`BiEncoder.apply` (dropout in training mode)."""
        q, ctx, _ = self.biencoder.apply(
            {"txts": batch["txts"], "imgs": batch["imgs"], "caps": None},
            generators)
        if self.intersection:
            pooled = torch.cat([q, ctx, q * ctx, q + ctx], dim=1)
        else:
            pooled = torch.cat([q, ctx], dim=1)
        head = self.vqa_output
        dtype = self.compute_dtype
        hdn = gelu(head["0"](pooled.to(dtype), dtype))
        hdn = head["2"](hdn)
        scores = head["3"](hdn, dtype).float()
        if compute_loss:
            return bce_with_logits(scores, targets)
        return scores


@torch.no_grad()
def init_vqa_head_(model: BiEncoderForVQA, generator: torch.Generator
                   ) -> BiEncoderForVQA:
    """Random head weights as ``BiEncoderForVQA.init`` draws them
    (vqa.py:31-41): normal(0, 0.02) kernels, zero biases, a unit LayerNorm
    scale. ``generator`` lives on the CPU (JAX draws other numbers from
    its key)."""
    for name in ("0", "3"):
        dense = model.vqa_output[name]
        dense.weight.copy_(torch.randn(dense.weight.shape,
                                       generator=generator) * 0.02)
        dense.bias.zero_()
    ln = model.vqa_output["2"]
    ln.weight.fill_(1.0)
    ln.bias.zero_()
    return model
