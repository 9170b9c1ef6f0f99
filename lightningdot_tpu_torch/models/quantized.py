"""The int8 text tower of the serving path (counterpart of
lightningdot_tpu/serving.py:34-139: ``quantize_text_tower``,
``_dense_int8`` and ``encode_text_int8``).

Every dense layer holds an int8 kernel with a float32 scale per output
channel (max |w| over the column, floor 1e-8, / 127) and its float32 bias;
activations are quantized per row on the fly, multiplied in int32 and
rescaled in float32 (``_dense_int8``). LayerNorms and biases stay float32.
The embedding tables and the embedding LayerNorm are rounded to bfloat16,
so the embedding sum runs in bfloat16 (serving.py:53-54, 104-105). The
tower is built from a float32
:class:`~lightningdot_tpu_torch.models.encoder.TextEncoder` and never
trained: its weights are buffers, its LayerNorms frozen copies.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from lightningdot_tpu_torch.models.encoder import (Dense, LayerNorm,
                                                   TextEncoder, attention_bias)
from lightningdot_tpu_torch.ops import (ffn_gelu_int8, gelu, mm_int8,
                                        multi_head_attention)
from lightningdot_tpu_torch.ops.ffn_int8 import _quant_rows
from lightningdot_tpu_torch.ops.fused import dropout_add_ln


def _dense_int8(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """int8 weight x per-row int8 activation dense (serving.py:81-95):
    int32 product, then acc * row scale * channel scale + bias in float32,
    rounded to bfloat16. ``kernel`` int8 [in, out]."""
    shape = x.shape
    xq, xs = _quant_rows(x.reshape(-1, shape[-1]).float())
    y = mm_int8(xq, kernel).float() * xs * scale + bias
    return y.to(torch.bfloat16).reshape(*shape[:-1], kernel.shape[1])


class QuantizedDense(nn.Module):
    """One int8 dense layer: ``weight`` int8 [out, in] (the torch Linear
    layout), ``scale`` and ``bias`` float32 [out]."""

    def __init__(self, dense: Dense):
        super().__init__()
        # quantized on the CPU, where "/ 127" is a true division as in the
        # JAX package's (eager) quantize_text_tower, so that every device
        # serves the same int8 weights
        device = dense.weight.device
        w = dense.weight.detach().float().cpu()
        scale = torch.clamp(w.abs().amax(dim=1), min=1e-8) / 127.0
        q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
        self.register_buffer("weight", q.contiguous().to(device))
        self.register_buffer("scale", scale.to(device))
        self.register_buffer("bias", dense.bias.detach().float().clone())

    @property
    def kernel(self) -> torch.Tensor:
        """The int8 kernel in the JAX package's [in, out] layout (a view)."""
        return self.weight.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense_int8(x, self.kernel, self.scale, self.bias)


def _frozen_ln(ln: LayerNorm, round_bf16: bool = False) -> LayerNorm:
    """A copy of ``ln`` with its float32 parameters frozen (rounded to
    bfloat16 first where the JAX package stores them so)."""
    ln = copy.deepcopy(ln).requires_grad_(False)
    if round_bf16:
        for p in ln.parameters():
            p.copy_(p.to(torch.bfloat16))
    return ln


class _QuantizedLayer(nn.Module):
    """One BertLayer on int8 weights (``body`` of encode_text_int8,
    serving.py:109-128)."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        sa, out = layer.attention.self, layer.attention.output
        self.num_heads, self.head_dim = layer.num_heads, layer.head_dim
        self.query = QuantizedDense(sa.query)
        self.key = QuantizedDense(sa.key)
        self.value = QuantizedDense(sa.value)
        self.output = QuantizedDense(out.dense)
        self.attn_ln = _frozen_ln(out.LayerNorm)
        self.intermediate = QuantizedDense(layer.intermediate.dense)
        self.mlp_output = QuantizedDense(layer.output.dense)
        self.mlp_ln = _frozen_ln(layer.output.LayerNorm)

    def forward(self, h: torch.Tensor, mask_bias: torch.Tensor
                ) -> torch.Tensor:
        b, s, hidden = h.shape
        heads = (b, s, self.num_heads, self.head_dim)
        ctx = multi_head_attention(self.query(h).view(heads),
                                   self.key(h).view(heads),
                                   self.value(h).view(heads), mask_bias)
        # ln(x + res) (serving.py:122, 127): both operands are bfloat16, so
        # the LayerNorm kernel takes the residual in its prologue
        ln = self.attn_ln
        a = dropout_add_ln(self.output(ctx.reshape(b, s, hidden)), h,
                           ln.weight, ln.bias, None, rate=0.0, eps=ln.eps)
        fc1, fc2, ln = self.intermediate, self.mlp_output, self.mlp_ln
        o = ffn_gelu_int8(a, fc1.kernel, fc1.scale, fc1.bias, fc2.kernel,
                          fc2.scale, fc2.bias)
        return dropout_add_ln(o, a, ln.weight, ln.bias, None, rate=0.0,
                              eps=ln.eps)


class QuantizedTextEncoder(nn.Module):
    """The int8 serving tower: ``QuantizedTextEncoder(tower)`` quantizes a
    float32 text tower per output channel (``quantize_text_tower``,
    serving.py:34-78) and lives on the tower's device. :meth:`forward` is
    ``encode_text_int8``."""

    @torch.no_grad()
    def __init__(self, tower: TextEncoder):
        super().__init__()
        emb = tower.bert.embeddings
        for name in ("word_embeddings", "position_embeddings",
                     "token_type_embeddings"):
            self.register_buffer(name, getattr(emb, name).weight.detach()
                                 .to(torch.bfloat16).clone())
        self.emb_ln = _frozen_ln(emb.LayerNorm, round_bf16=True)
        self.layers = nn.ModuleList(_QuantizedLayer(layer)
                                    for layer in tower.bert.encoder.layer)
        self.proj: Optional[nn.ModuleList] = None
        if tower.encode_proj is not None:
            fc1, _, ln, fc2 = tower.encode_proj
            self.proj = nn.ModuleList([QuantizedDense(fc1),
                                       _frozen_ln(ln),
                                       QuantizedDense(fc2)])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        """-> pooled bfloat16 [B, out] (serving.py:98-139)."""
        # bfloat16 tables, summed in bfloat16 (text_embeddings, dtype bf16)
        x = (self.word_embeddings[input_ids]
             + self.position_embeddings[position_ids]
             + self.token_type_embeddings[0])
        h = self.emb_ln(x)
        bias = attention_bias(attention_mask)
        for layer in self.layers:
            h = layer(h, bias)
        pooled = h[:, 0]
        if self.proj is not None:
            fc1, ln, fc2 = self.proj
            pooled = fc2(ln(gelu(fc1(pooled))))
        return pooled
