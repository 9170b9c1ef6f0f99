"""Moonlight-16B-A3B (DeepSeek-V3's block, arXiv 2412.19437) as the
bi-encoder's text tower, as decoder LLMs are used as embedders (E5-Mistral,
arXiv 2401.00368; LLM2CLIP, arXiv 2411.04997).

No JAX counterpart: the JAX package's towers are BERT's. The equations,
with x the hidden rows [B, S, H]:

    h_0 = E[ids]                                   (no position embedding)
    a   = h + MLA(RMSNorm(h))
    h'  = a + FFN(RMSNorm(a))                      (each layer)
    pooled = RMSNorm(h_L)[last real token]         (the closing token)
    out = projection_head(pooled)                  (TextEncoder's head)

    MLA(x): q = W_q x -> heads x (q_nope 128 | q_pe 64)
            [c | k_pe] = W_kva x (512 | 64), c <- RMSNorm(c)
            [k_nope | v] = W_kvb c -> heads x (128 | 128); k_pe one head
            q_pe, k_pe <- RoPE(theta 50,000, positions 0 ... S - 1), in
              DeepSeek-V3's layout (ops/rope.py)
            o = softmax(q k^T / sqrt(192)), causal, pad keys masked, then
              times v; out = W_o o

    FFN, layer 0:  W_down(silu(W_gate x) * W_up x), I 11,264
    FFN, layers 1...: DeepSeekMoE
            s = sigmoid(W_r x) in float32 over all router experts
            top-6 by s + b (b the selection bias, a buffer, not trained)
            w_k = 2.446 s_k / sum of the 6 chosen s
            y = sum over chosen k that this card holds of w_k E_k(x) + S(x)
            E_k SwiGLU at I 1,408; S the shared experts, one SwiGLU at
            I 2 x 1,408

Departures from the published model: no dropout; no balance loss (the
router learns only through w); the card holds ``n_routed_experts`` of the
router's experts (``first_held_expert`` on) and adds only their part;
the gate and up weights are stacked, [2 I, H] (W_gate's rows first), and a
layer's experts stacked, [E, 2 I, H] and [E, H, I]; padding tokens go
through no feed-forward block and attend to nothing (their output there
is 0): they follow the real tokens, so the causal mask keeps them from
every real token. Every product is in the compute dtype with float32 sums
(bf16 on the card; the kernels take no float32); norms and the router in
float32.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from lightningdot_tpu_torch.config import MoonlightConfig
from lightningdot_tpu_torch.models.encoder import Dense, LayerNorm
from lightningdot_tpu_torch.ops import gelu, mm_f32
from lightningdot_tpu_torch.ops.layernorm import rms_norm
from lightningdot_tpu_torch.ops.mla_attention import mla_attention
from lightningdot_tpu_torch.ops.moe import (real_rows, route, routed_experts,
                                            swiglu)
from lightningdot_tpu_torch.ops.rope import rope
from lightningdot_tpu_torch.utils import tracing


class Weight(nn.Module):
    """A bias-free weight ``weight`` [..., out, in] as stored, which the
    SwiGLU and grouped kernels take whole."""

    def __init__(self, *shape: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape))


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x.contiguous(), self.weight, self.eps)


class MLA(nn.Module):
    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        self.q_proj = Dense(h, nh * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = Dense(
            h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = Dense(
            cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            bias=False)
        self.o_proj = Dense(nh * cfg.v_head_dim, h, bias=False)

    def forward(self, x, key_ok, dtype):
        c = self.cfg
        b, s, _ = x.shape
        nh, dn, dr = c.num_attention_heads, c.qk_nope_head_dim, \
            c.qk_rope_head_dim
        q = self.q_proj(x, dtype).view(b, s, nh, dn + dr)
        kva = self.kv_a_proj_with_mqa(x, dtype)
        lat = self.kv_a_layernorm(kva[..., :c.kv_lora_rank])
        kv = self.kv_b_proj(lat, dtype).view(b, s, nh, dn + c.v_head_dim)
        q_pe = rope(q[..., dn:].contiguous(), c.rope_theta)
        k_pe = rope(kva[..., c.kv_lora_rank:].reshape(b, s, 1, dr)
                    .contiguous(), c.rope_theta)
        qq = torch.cat([q[..., :dn], q_pe], dim=-1)
        kk = torch.cat([kv[..., :dn], k_pe.expand(b, s, nh, dr)], dim=-1)
        o = mla_attention(qq, kk, kv[..., dn:].contiguous(), key_ok,
                          1.0 / math.sqrt(dn + dr), causal=True)
        return self.o_proj(o.reshape(b, s, nh * c.v_head_dim), dtype)


class DenseMLP(nn.Module):
    """SwiGLU of every token: ``gate_up_proj`` [2 I, H], ``down_proj``
    [H, I]."""

    def __init__(self, h: int, inter: int, span: str = "ffn.dense"):
        super().__init__()
        self.gate_up_proj = Weight(2 * inter, h)
        self.down_proj = Weight(h, inter)
        self.span = span

    def forward(self, x2, dtype, rows=None):
        """``rows``: the real tokens' rows (``ops/moe.py::real_rows``);
        padding's output is then 0."""
        return swiglu(x2.to(dtype), self.gate_up_proj.weight.to(dtype),
                      self.down_proj.weight.to(dtype), self.span, rows)


class Router(nn.Module):
    """``weight`` [router experts, H] and the selection bias
    ``e_score_correction_bias`` (a buffer: not trained)."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_router,
                                               cfg.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(cfg.n_router))


class Experts(nn.Module):
    """The held experts, stacked: ``gate_up_proj`` [E, 2 I, H],
    ``down_proj`` [E, H, I]."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        e, h, i = (cfg.n_routed_experts, cfg.hidden_size,
                   cfg.moe_intermediate_size)
        self.gate_up_proj = Weight(e, 2 * i, h)
        self.down_proj = Weight(e, h, i)


class MoE(nn.Module):
    """A DeepSeekMoE layer told which experts it holds. ``choices``: set
    it to a list and each forward appends its top-k indices (int64
    [tokens, topk], on the device)."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = DenseMLP(
            cfg.hidden_size, cfg.n_shared_experts * cfg.moe_intermediate_size,
            "moe.shared")
        self.choices: Optional[List[torch.Tensor]] = None

    def forward(self, x2, real, dtype, rows=None):
        c = self.cfg
        with tracing.span("moe.route") as recording:
            scores = torch.sigmoid(mm_f32(x2.float(), self.gate.weight.t()))
            biased = scores.detach() + self.gate.e_score_correction_bias
            sel = torch.topk(biased, c.num_experts_per_tok, dim=-1).indices
            s_sel = scores.gather(1, sel)
            if c.norm_topk_prob:
                s_sel = s_sel / s_sel.sum(-1, keepdim=True)
            w = c.routed_scaling_factor * s_sel
            routing = route(sel, c.first_held_expert, c.n_routed_experts,
                            real)
            if self.choices is not None:
                self.choices.append(sel.detach())
            if recording is not None:
                tracing.count("routed_rows", routing.offsets[-1])
                tracing.count("max_expert_rows", (
                    routing.offsets[1:] - routing.offsets[:-1]).max())
        shared = self.shared_experts(x2, dtype, rows)
        ex = self.experts
        routed = routed_experts(x2.to(dtype), w,
                                ex.gate_up_proj.weight.to(dtype),
                                ex.down_proj.weight.to(dtype), routing)
        return routed + shared


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MoonlightConfig, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = (DenseMLP(cfg.hidden_size, cfg.intermediate_size)
                    if self.dense else MoE(cfg))

    def forward(self, h, key_ok, real, dtype, rows=None):
        b, s, hid = h.shape
        a = h + self.self_attn(self.input_layernorm(h), key_ok, dtype)
        x2 = self.post_attention_layernorm(a).reshape(b * s, hid)
        y = (self.mlp(x2, dtype, rows) if self.dense
             else self.mlp(x2, real, dtype, rows))
        return a + y.reshape(b, s, hid)


class _Model(nn.Module):
    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class MoonlightTextEncoder(nn.Module):
    """The text tower: ``model.*`` (DeepSeek-V3's keys, with the stacked
    weights above) plus ``encode_proj``, TextEncoder's projection head.
    Built in eval mode; it has no dropout, so train() changes nothing."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        cfg.check()
        self.cfg = cfg
        self.model = _Model(cfg)
        self.encode_proj: Optional[nn.Sequential] = None
        if cfg.project_dim > 0:
            h = cfg.hidden_size
            self.encode_proj = nn.Sequential(
                Dense(h, 2 * h), nn.GELU(),
                LayerNorm(2 * h, cfg.layer_norm_eps),
                Dense(2 * h, cfg.project_dim))
        self.train(False)

    def moe_layers(self) -> List[MoE]:
        return [layer.mlp for layer in self.model.layers if not layer.dense]

    def projection_head(self, pooled, dtype):
        fc1, _, ln, fc2 = self.encode_proj
        return fc2(ln(gelu(fc1(pooled, dtype))), dtype)

    def forward(self, input_ids, attention_mask, position_ids=None, *,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                head: bool = True):
        """-> (sequence [B, S, H] after the final norm, pooled [B, out]).
        ``position_ids`` and ``generator`` are taken for the BERT towers'
        signature: positions are 0 ... S - 1 and nothing drops."""
        del position_ids, generator
        b, s = input_ids.shape
        h = self.model.embed_tokens(input_ids).to(dtype)
        key_ok = attention_mask.float().contiguous()
        real = attention_mask.reshape(-1) > 0
        # the feed-forward blocks take the real tokens' rows only: padding
        # follows every real token of its caption, so under the causal mask
        # it reaches no real token, and it is not pooled
        rows = real_rows(real)
        for layer in self.model.layers:
            h = layer(h, key_ok, real, dtype, rows)
        h = self.model.norm(h)
        last = (attention_mask.long().sum(1) - 1).clamp(min=0)
        pooled = h[torch.arange(b, device=h.device), last]
        if head and self.encode_proj is not None:
            pooled = self.projection_head(pooled, dtype)
        return h, pooled


# random selection biases: a common part, which selection ignores, about
# the size of the sigmoid scores, and differences well under the scores'
# spread over tokens, so that the tokens, not the biases, choose experts
SELECTION_BIAS_MEAN, SELECTION_BIAS_STD = 0.5, 0.005


@torch.no_grad()
def init_moonlight_(tower: MoonlightTextEncoder, generator: torch.Generator
                    ) -> MoonlightTextEncoder:
    """Random weights: normal(0, initializer_range) for every matrix and
    the embedding table, unit norm scales, zero head biases, and the
    selection biases normal(SELECTION_BIAS_MEAN, SELECTION_BIAS_STD).
    ``generator`` lives on the CPU; the weights are copied to the tower's
    device."""
    std = tower.cfg.initializer_range
    for name, p in tower.named_parameters():
        if p.dim() >= 2:
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    for moe in tower.moe_layers():
        b = moe.gate.e_score_correction_bias
        b.copy_(SELECTION_BIAS_MEAN + torch.randn(b.shape, generator=generator)
                * SELECTION_BIAS_STD)
    return tower
