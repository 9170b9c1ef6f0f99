"""Operations and bytes of the Moonlight text tower's work
(``configs/lightningdot-moonlight-16b-a3b.json``), counted from shapes and
from the program's routing counters, as ``harness/counts.py`` counts the
BERT towers': an operation is a multiply or an add, bytes count each input
read once and each output written once (bf16 activations and weights,
float32 norm scales and routing weights).

``cfg`` is the configuration file's object (the DeepSeek-V3 keys at its top
level). ``routed`` is a number of routed rows: (token, expert) pairs sent to
held experts, as the program's ``moe.route`` spans count them.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

Work = Tuple[float, float]      # (bytes, operations)
BF16 = 2


def n_moe(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def mla_projection_flops(cfg: dict) -> float:
    """Forward operations of one token's MLA projections."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    lat = cfg["kv_lora_rank"]
    return 2.0 * (h * nh * dq + h * (lat + cfg["qk_rope_head_dim"])
                  + lat * nh * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"])
                  + nh * cfg["v_head_dim"] * h)


def causal_pairs(length: int) -> int:
    """(query, key) pairs a sequence of ``length`` real tokens scores."""
    return length * (length + 1) // 2


def attention_flops(length: int, cfg: dict) -> float:
    """q k^T and p v over the causal pairs of one sequence, all heads."""
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return (2.0 * causal_pairs(length) * cfg["num_attention_heads"]
            * (dq + cfg["v_head_dim"]))


def swiglu_flops(rows: float, h: int, inter: int) -> float:
    """Forward operations of a SwiGLU block over ``rows`` rows."""
    return 6.0 * rows * h * inter


def text_forward_flops(lens: Iterable[int], cfg: dict, routed: float,
                       project_dim: int) -> float:
    """Forward operations of the text tower over sequences of the given
    real lengths, with ``routed`` routed rows over its MoE layers."""
    h = cfg["hidden_size"]
    i_s = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    n_router = cfg.get("router_experts") or cfg["n_routed_experts"]
    per_token = (cfg["num_hidden_layers"] * mla_projection_flops(cfg)
                 + cfg["first_k_dense_replace"] * swiglu_flops(
                     1, h, cfg["intermediate_size"])
                 + n_moe(cfg) * (swiglu_flops(1, h, i_s) + 2.0 * h * n_router))
    total = 0.0
    for length in lens:
        length = int(length)
        total += length * per_token + cfg["num_hidden_layers"] * \
            attention_flops(length, cfg)
        total += 2.0 * (h * 2 * h + 2 * h * project_dim)
    return total + swiglu_flops(routed, h, cfg["moe_intermediate_size"])


def swiglu_gemms(rows: float, h: int, inter: int, groups: int,
                 recompute: bool) -> List[Work]:
    """The grouped GEMMs of one SwiGLU block's forward and backward over
    ``rows`` rows and ``groups`` weight matrices (``ops/moe.py``): the
    gate/up GEMM (writing G, U and act) and the down GEMM, again in the
    backward where they are recomputed (the routed experts), then dact (with
    dG, dU), dx rows and the two weight gradients."""
    e = BF16
    w = groups * inter * h * e            # one weight matrix of each group
    gate_up = (rows * h * e + 2 * w + 3 * rows * inter * e,
               4.0 * rows * h * inter)
    down = (rows * inter * e + w + rows * h * e, 2.0 * rows * inter * h)
    dact = (rows * h * e + w + 2 * rows * inter * e + 2 * rows * inter * e,
            2.0 * rows * h * inter)
    dx = (2 * rows * inter * e + 2 * w + rows * h * e, 4.0 * rows * inter * h)
    d_down = (rows * h * e + rows * inter * e + w, 2.0 * rows * h * inter)
    d_gu = (2 * rows * inter * e + rows * h * e + 2 * w,
            4.0 * rows * inter * h)
    out = [gate_up, down] * (2 if recompute else 1)
    return out + [dact, dx, d_down, d_gu]


def step_gemms(tokens: int, routed: float, steps: int,
               cfg: dict) -> List[Work]:
    """Every grouped GEMM of ``steps`` training steps of ``tokens`` real
    tokens each (the dense layer's and the shared experts' rows: the
    program leaves padding out), ``routed`` routed rows over all of them
    (spread evenly
    over the layers and steps: the operations are linear in the rows, and
    each layer reads its weights once)."""
    h, i_m = cfg["hidden_size"], cfg["moe_intermediate_size"]
    i_s = cfg["n_shared_experts"] * i_m
    calls = steps * n_moe(cfg)
    out = []
    for _ in range(steps):
        out += cfg["first_k_dense_replace"] * swiglu_gemms(
            tokens, h, cfg["intermediate_size"], 1, False)
        out += n_moe(cfg) * swiglu_gemms(tokens, h, i_s, 1, False)
    if calls:
        out += calls * swiglu_gemms(routed / calls, h, i_m,
                                    cfg["n_routed_experts"], True)
    return out


def attention_work(b: int, s: int, lens: Iterable[int], cfg: dict,
                   backward: bool) -> Work:
    """One launch of the MLA attention kernel over [b, s] (every head):
    the causal pairs of the real tokens' operations; bytes of q, k, v and
    o (and, backward, dO read, dq, dk, dv written)."""
    nh = cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    rows = b * s * nh
    ops = sum(attention_flops(int(n), cfg) for n in lens)
    if not backward:
        return (BF16 * rows * (2 * dq + 2 * dv) + 4 * rows, ops)
    return (BF16 * rows * (4 * dq + 4 * dv) + 4 * rows, 2.0 * ops)


def norm_bytes(tokens: int, cfg: dict) -> float:
    """Bytes of one step's RMS norms (the RMS mode of ``csrc/layernorm.cu``),
    forward (read x, write out) and backward (read x and dO, write dx):
    each layer's two norms of H and its latent norm, and the final norm."""
    h, lat = cfg["hidden_size"], cfg["kv_lora_rank"]
    width = cfg["num_hidden_layers"] * (2 * h + lat) + h
    return 5.0 * BF16 * tokens * width


def rope_bytes(tokens: int, cfg: dict) -> float:
    """Bytes of one step's RoPE launches: each layer's query heads and its
    one key head, read and written, forward and (inverse) backward."""
    heads = cfg["num_attention_heads"] + 1
    return (2 * 2.0 * BF16 * cfg["num_hidden_layers"] * tokens * heads
            * cfg["qk_rope_head_dim"])


def combine_bytes(tokens: int, rows: float, k: int, cfg: dict) -> float:
    """One block's combining launches (forward: its rows into the tokens;
    backward: the dx rows into the tokens) for ``rows`` rows of ``k``
    slots a token: the rows read, the tokens written, the slots' rows and
    weights read."""
    return 2 * (BF16 * (rows + tokens) * cfg["hidden_size"]
                + 8.0 * tokens * k)


def step_combine_bytes(tokens: int, real: int, routed: float,
                       cfg: dict) -> float:
    """A step's combining launches over ``tokens`` padded tokens, ``real``
    of them real, ``routed`` routed rows a MoE layer: each MoE layer's
    routed experts and shared experts, and the dense layer."""
    k = cfg["num_experts_per_tok"]
    return (n_moe(cfg) * (combine_bytes(tokens, routed, k, cfg)
                          + combine_bytes(tokens, real, 1, cfg))
            + cfg["first_k_dense_replace"] * combine_bytes(tokens, real, 1,
                                                           cfg))


def scatter_bytes(rows: float, cfg: dict) -> float:
    """One block's copy of each row's cotangent, scaled by its weight: the
    rows read and written, their slots read."""
    return 2.0 * BF16 * rows * cfg["hidden_size"] + 8.0 * rows


def step_scatter_bytes(real: int, routed: float, cfg: dict) -> float:
    """A step's copies: each MoE layer's routed rows and real rows (the
    shared experts'), and the dense layer's real rows."""
    return (n_moe(cfg) * (scatter_bytes(routed, cfg)
                          + scatter_bytes(real, cfg))
            + cfg["first_k_dense_replace"] * scatter_bytes(real, cfg))


def route_grad_bytes(tokens: int, rows: float, cfg: dict) -> float:
    """One MoE layer-step's routing-weight gradients: the expert rows read
    and the slots' rows read and gradients written (the tokens' cotangents,
    read again for each of their slots, are left out: a lower bound)."""
    return (BF16 * rows * cfg["hidden_size"]
            + 8.0 * tokens * cfg["num_experts_per_tok"])
