"""Moonlight-16B-A3B (DeepSeek-V3's block) as the text tower of LightningDOT's
bi-encoder, in plain float32 PyTorch: the reference the port's Moonlight
tower (``lightningdot_tpu_torch/models/moonlight.py``) is held to.

It imports neither package of this repository. Parameters are a plain
``{name: tensor}`` dict under the port's state-dict keys (``layout``).
Every product goes through ``mm`` in float32 (TF32 must be off: the caller
sets ``torch.backends.cuda.matmul.allow_tf32 = False``), or, for the
benchmark's control, with both operands of every product, forward and
backward, rounded to fp8 e4m3 under a per-tensor scale (``prec="fp8"``).

The text tower (layer equations as in the port's module docstring):

    h = E[ids]; per layer a = h + MLA(RMSNorm(h)), h = a + FFN(RMSNorm(a))
    pooled = RMSNorm(h)[last real token], then Linear-GELU-LN-Linear

MLA: q = W_q x (heads x (128 + 64)); [c | k_pe] = W_kva x; c = RMSNorm(c);
[k_nope | v] = W_kvb c; RoPE (theta from the config, positions 0 ... S - 1)
on q_pe and the one shared k_pe head, in DeepSeek-V3's published layout
(modeling_deepseek.py: the pairs (x[2i], x[2i + 1]) rotated by angle
p / theta^(2i / 64) and written de-interleaved, first the 32 "real" parts
then the 32 "imaginary" ones); softmax(q k^T / sqrt(192)) over keys
j <= i that are real; o = p v; W_o o.

FFN: layer 0 SwiGLU (I = intermediate_size). MoE layers: s = sigmoid(W_r x)
over all router experts, top-k by s + b, w_k = scale s_k / sum of the
chosen s, y = sum over chosen held k of w_k E_k(x) + S(x). ``held`` =
(first, count) names the experts whose weights ``p`` holds; ``replay``
gives the top-k choices to use instead of the reference's own, layer by
layer (the program's, so that a near tie that bf16 breaks the other way
does not move the comparison), and ``log`` receives the reference's own
choices beside them.

The image tower is UNITER-base's as LightningDOT fine-tunes it (post-LN
BERT layers, erf GELU, an additive -10000 key mask, the region feature and
box embeddings, the projection head of the [CLS] row); ``drop`` replays a
training step's dropout (an object with ``hidden(x)`` and
``attention(layer, probs)``), None for none.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
MASK_BIAS = -10000.0
FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 under a per-tensor scale (its largest |value|
    to 448), back in float32."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8(a) @ fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = fp8(g)
        return g8 @ fp8(b).transpose(-1, -2), fp8(a).transpose(-1, -2) @ g8


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    if prec == "f32":
        return a @ b
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {prec!r}")


def linear(x: torch.Tensor, w: torch.Tensor, prec: str,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = mm(x.reshape(-1, x.shape[-1]), w.t(), prec)
    if b is not None:
        y = y + b
    return y.reshape(*x.shape[:-1], w.shape[0])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def text_layout(cfg: dict, project_dim: int, pre: str = "txt_model.",
                experts: Optional[int] = None) -> List[Tuple[str, tuple]]:
    """Names and shapes of the text tower (``experts``: how many experts
    each MoE layer holds; the config's ``n_routed_experts`` by default)."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    lat, i_m = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    e = cfg["n_routed_experts"] if experts is None else experts
    n_router = cfg.get("router_experts") or cfg["n_routed_experts"]
    m = pre + "model."
    out = [(f"{m}embed_tokens.weight", (cfg["vocab_size"], h))]
    for n in range(cfg["num_hidden_layers"]):
        lp = f"{m}layers.{n}."
        out += [(f"{lp}input_layernorm.weight", (h,)),
                (f"{lp}self_attn.q_proj.weight", (nh * (dn + dr), h)),
                (f"{lp}self_attn.kv_a_proj_with_mqa.weight", (lat + dr, h)),
                (f"{lp}self_attn.kv_a_layernorm.weight", (lat,)),
                (f"{lp}self_attn.kv_b_proj.weight", (nh * (dn + dv), lat)),
                (f"{lp}self_attn.o_proj.weight", (h, nh * dv)),
                (f"{lp}post_attention_layernorm.weight", (h,))]
        if n < cfg["first_k_dense_replace"]:
            i = cfg["intermediate_size"]
            out += [(f"{lp}mlp.gate_up_proj.weight", (2 * i, h)),
                    (f"{lp}mlp.down_proj.weight", (h, i))]
        else:
            i_s = cfg["n_shared_experts"] * i_m
            out += [(f"{lp}mlp.gate.weight", (n_router, h)),
                    (f"{lp}mlp.gate.e_score_correction_bias", (n_router,)),
                    (f"{lp}mlp.experts.gate_up_proj.weight", (e, 2 * i_m, h)),
                    (f"{lp}mlp.experts.down_proj.weight", (e, h, i_m)),
                    (f"{lp}mlp.shared_experts.gate_up_proj.weight",
                     (2 * i_s, h)),
                    (f"{lp}mlp.shared_experts.down_proj.weight", (h, i_s))]
    out += [(f"{m}norm.weight", (h,))]
    return out + head_layout(pre, h, project_dim)


def head_layout(pre: str, h: int, project_dim: int):
    return [(f"{pre}encode_proj.0.weight", (2 * h, h)),
            (f"{pre}encode_proj.0.bias", (2 * h,)),
            (f"{pre}encode_proj.2.weight", (2 * h,)),
            (f"{pre}encode_proj.2.bias", (2 * h,)),
            (f"{pre}encode_proj.3.weight", (project_dim, 2 * h)),
            (f"{pre}encode_proj.3.bias", (project_dim,))]


def image_layout(cfg: dict, project_dim: int, pre: str = "img_model."):
    """UNITER-base's tower and its projection head."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    b = pre + "bert."

    def lin(name, o, n):
        return [(f"{name}.weight", (o, n)), (f"{name}.bias", (o,))]

    def norm(name, n):
        return [(f"{name}.weight", (n,)), (f"{name}.bias", (n,))]

    out = [(f"{b}embeddings.word_embeddings.weight", (cfg["vocab_size"], h)),
           (f"{b}embeddings.position_embeddings.weight",
            (cfg["max_position_embeddings"], h)),
           (f"{b}embeddings.token_type_embeddings.weight",
            (cfg["type_vocab_size"], h))]
    out += norm(f"{b}embeddings.LayerNorm", h)
    for n in range(cfg["num_hidden_layers"]):
        lp = f"{b}encoder.layer.{n}."
        for part in ("query", "key", "value"):
            out += lin(f"{lp}attention.self.{part}", h, h)
        out += lin(f"{lp}attention.output.dense", h, h)
        out += norm(f"{lp}attention.output.LayerNorm", h)
        out += lin(f"{lp}intermediate.dense", i, h)
        out += lin(f"{lp}output.dense", h, i)
        out += norm(f"{lp}output.LayerNorm", h)
    out += lin(f"{b}pooler.dense", h, h)
    ip = f"{b}img_embeddings."
    out += lin(f"{ip}img_linear", h, cfg["img_dim"])
    out += norm(f"{ip}img_layer_norm", h)
    out += lin(f"{ip}pos_linear", h, cfg["pos_dim"])
    out += norm(f"{ip}pos_layer_norm", h)
    out += [(f"{ip}mask_embedding.weight", (2, cfg["img_dim"]))]
    out += norm(f"{ip}LayerNorm", h)
    return out + head_layout(pre, h, project_dim)


# ---------------------------------------------------------------------------
# the text tower
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, heads, d] -> RoPE at positions 0 ... S - 1, DeepSeek-V3's
    layout (see the module docstring)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def mla(x: torch.Tensor, mask: torch.Tensor, p: Params, lp: str, cfg: dict,
        prec: str) -> torch.Tensor:
    b, s, _ = x.shape
    nh = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    lat = cfg["kv_lora_rank"]
    a = f"{lp}self_attn."
    q = linear(x, p[f"{a}q_proj.weight"], prec).view(b, s, nh, dn + dr)
    kva = linear(x, p[f"{a}kv_a_proj_with_mqa.weight"], prec)
    c = rms_norm(kva[..., :lat], p[f"{a}kv_a_layernorm.weight"],
                 cfg["rms_norm_eps"])
    kv = linear(c, p[f"{a}kv_b_proj.weight"], prec).view(b, s, nh, dn + dv)
    q_pe = rope(q[..., dn:], cfg["rope_theta"])
    k_pe = rope(kva[..., lat:].reshape(b, s, 1, dr), cfg["rope_theta"])
    qq = torch.cat([q[..., :dn], q_pe], -1).transpose(1, 2)
    kk = torch.cat([kv[..., :dn], k_pe.expand(b, s, nh, dr)],
                   -1).transpose(1, 2)
    v = kv[..., dn:].transpose(1, 2)
    scores = mm(qq, kk.transpose(-1, -2), prec) / math.sqrt(dn + dr)
    ok = (mask[:, None, None, :] > 0) & torch.ones(
        s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
    o = mm(probs, v, prec).transpose(1, 2).reshape(b, s, nh * dv)
    return linear(o, p[f"{a}o_proj.weight"], prec)


def swiglu(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor,
           prec: str) -> torch.Tensor:
    inter = w_gu.shape[0] // 2
    gu = linear(x, w_gu, prec)
    return linear(F.silu(gu[..., :inter]) * gu[..., inter:], w_down, prec)


def moe(x2: torch.Tensor, real: torch.Tensor, p: Params, lp: str,
        cfg: dict, prec: str, held: Tuple[int, int],
        sel: Optional[torch.Tensor] = None, log: Optional[list] = None,
        shared: bool = True, weights_from: Optional[Callable] = None
        ) -> torch.Tensor:
    """A DeepSeekMoE layer on rows x2 [N, H]: the routed part of the held
    experts (``held`` = (first, count), ``p`` holding their weights in that
    order), plus the shared experts where ``shared``. ``sel`` [N, k]: the
    choices to use (else the reference's own); ``log`` gets (own, used).
    ``weights_from(s, b)``: the scores the routing weights are taken from
    (default s, the published rule; a check plants another)."""
    m = f"{lp}mlp."
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(x2 @ p[f"{m}gate.weight"].t())
    bias = p[f"{m}gate.e_score_correction_bias"]
    own = torch.topk(scores.detach() + bias, k, dim=-1).indices
    if sel is None:
        sel = own
    if log is not None:
        log.append((own, sel))
    if weights_from is not None:
        scores = weights_from(scores, bias)
    s_sel = scores.gather(1, sel)
    if cfg.get("norm_topk_prob", True):
        s_sel = s_sel / s_sel.sum(-1, keepdim=True)
    w = cfg["routed_scaling_factor"] * s_sel
    first, count = held
    y = torch.zeros_like(x2)
    w_gu = p[f"{m}experts.gate_up_proj.weight"]
    w_down = p[f"{m}experts.down_proj.weight"]
    for e in range(count):
        hit = (sel == first + e) & real[:, None]
        rows = hit.any(1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        we = (w * hit).sum(1)[rows, None]
        y = y.index_add(0, rows, we * swiglu(x2[rows], w_gu[e], w_down[e],
                                              prec))
    if shared:
        y = y + swiglu(x2, p[f"{m}shared_experts.gate_up_proj.weight"],
                       p[f"{m}shared_experts.down_proj.weight"], prec)
    return y


def text_tower(p: Params, ids: torch.Tensor, mask: torch.Tensor, cfg: dict,
               prec: str = "f32", *, pre: str = "txt_model.",
               held: Optional[Tuple[int, int]] = None,
               replay: Optional[Sequence[torch.Tensor]] = None,
               log: Optional[list] = None, head: bool = True,
               weights_from: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sequence [B, S, H] after the final norm, pooled [B, out]) of ids
    [B, S] with mask [B, S] (1 real, right-padded). ``replay``: each MoE
    layer's choices [B S, k], in layer order; ``weights_from``: as
    :func:`moe`'s."""
    if held is None:
        held = (cfg.get("first_held_expert", 0), cfg["n_routed_experts"])
    b, s = ids.shape
    m = pre + "model."
    eps = cfg["rms_norm_eps"]
    h = p[f"{m}embed_tokens.weight"][ids]
    real = mask.reshape(-1) > 0
    n_moe = 0
    for n in range(cfg["num_hidden_layers"]):
        lp = f"{m}layers.{n}."
        a = h + mla(rms_norm(h, p[f"{lp}input_layernorm.weight"], eps), mask,
                    p, lp, cfg, prec)
        x2 = rms_norm(a, p[f"{lp}post_attention_layernorm.weight"],
                      eps).reshape(b * s, -1)
        if n < cfg["first_k_dense_replace"]:
            y = swiglu(x2, p[f"{lp}mlp.gate_up_proj.weight"],
                       p[f"{lp}mlp.down_proj.weight"], prec)
        else:
            sel = None if replay is None else replay[n_moe]
            y = moe(x2, real, p, lp, cfg, prec, held, sel, log,
                    weights_from=weights_from)
            n_moe += 1
        h = a + y.reshape(b, s, -1)
    h = rms_norm(h, p[f"{m}norm.weight"], eps)
    pooled = h[torch.arange(b, device=h.device), mask.long().sum(1) - 1]
    if head:
        pooled = project(pooled, p, pre, prec)
    return h, pooled


def project(x: torch.Tensor, p: Params, pre: str, prec: str,
            eps: float = 1e-12) -> torch.Tensor:
    """LightningDOT's projection head: Linear-GELU-LayerNorm-Linear."""
    e = f"{pre}encode_proj."
    y = F.gelu(linear(x, p[f"{e}0.weight"], prec, p[f"{e}0.bias"]))
    y = F.layer_norm(y, (y.shape[-1],), p[f"{e}2.weight"], p[f"{e}2.bias"],
                     eps)
    return linear(y, p[f"{e}3.weight"], prec, p[f"{e}3.bias"])


def route_mismatch(log: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   real: torch.Tensor) -> Tuple[int, int]:
    """(choices of real tokens where the reference's own top-k set differs
    from the used one, choices in all), over the logged layers."""
    differ = total = 0
    for own, used in log:
        o, u = own[real].sort(1).values, used[real].sort(1).values
        differ += int((o.unsqueeze(2) != u.unsqueeze(1)).all(2).sum())
        total += o.numel()
    return differ, total


# ---------------------------------------------------------------------------
# the image tower (UNITER-base) and the loss
# ---------------------------------------------------------------------------

def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def _dense(x, p, name, prec):
    return linear(x, p[f"{name}.weight"], prec, p[f"{name}.bias"])


def image_tower(p: Params, feat: torch.Tensor, boxes: torch.Tensor,
                rmask: torch.Tensor, cfg: dict, prec: str = "f32",
                drop=None, pre: str = "img_model.") -> torch.Tensor:
    """pooled [B, out] of regions feat [B, R, img_dim], boxes [B, R, 7],
    rmask [B, R], after a [CLS] token (id 101, position 0, type 0)."""
    b = pre + "bert."
    eps = cfg["layer_norm_eps"]
    nb = feat.shape[0]
    emb = (p[f"{b}embeddings.word_embeddings.weight"][101]
           + p[f"{b}embeddings.position_embeddings.weight"][0]
           + p[f"{b}embeddings.token_type_embeddings.weight"][0])
    cls = _ln(emb.expand(nb, 1, -1), p, f"{b}embeddings.LayerNorm", eps)
    if drop is not None:
        cls = drop.hidden(cls)
    ip = f"{b}img_embeddings."
    im = _ln(_dense(feat, p, f"{ip}img_linear", prec), p,
             f"{ip}img_layer_norm", eps)
    ps = _ln(_dense(boxes, p, f"{ip}pos_linear", prec), p,
             f"{ip}pos_layer_norm", eps)
    img = _ln(im + ps + p[f"{b}embeddings.token_type_embeddings.weight"][1],
              p, f"{ip}LayerNorm", eps)
    if drop is not None:
        img = drop.hidden(img)
    h = torch.cat([cls, img], 1)
    mask = torch.cat([torch.ones_like(rmask[:, :1]), rmask], 1)
    bias = (1.0 - mask.float())[:, None, None, :] * MASK_BIAS
    nh = cfg["num_attention_heads"]
    for n in range(cfg["num_hidden_layers"]):
        lp = f"{b}encoder.layer.{n}."
        bs, s, hid = h.shape
        d = hid // nh

        def heads(name):
            return _dense(h, p, f"{lp}attention.self.{name}", prec).view(
                bs, s, nh, d).transpose(1, 2)

        q, k, v = heads("query"), heads("key"), heads("value")
        probs = torch.softmax(mm(q, k.transpose(-1, -2), prec) / math.sqrt(d)
                              + bias, dim=-1)
        if drop is not None:
            probs = drop.attention(n, probs)
        ctx = mm(probs, v, prec).transpose(1, 2).reshape(bs, s, hid)
        a = _dense(ctx, p, f"{lp}attention.output.dense", prec)
        if drop is not None:
            a = drop.hidden(a)
        h1 = _ln(a + h, p, f"{lp}attention.output.LayerNorm", eps)
        o = _dense(F.gelu(_dense(h1, p, f"{lp}intermediate.dense", prec)), p,
                   f"{lp}output.dense", prec)
        if drop is not None:
            o = drop.hidden(o)
        h = _ln(o + h1, p, f"{lp}output.LayerNorm", eps)
    return project(h[:, 0], p, pre, prec, eps)


def itm_loss(txt: torch.Tensor, img: torch.Tensor,
             prec: str = "f32") -> torch.Tensor:
    """The mean of both directions' in-batch NLL, positives on the
    diagonal."""
    idx = torch.arange(txt.shape[0], device=txt.device)

    def nll(q, ctx):
        return -torch.log_softmax(mm(q, ctx.t(), prec), dim=1)[idx,
                                                              idx].mean()

    return 0.5 * nll(img, txt) + 0.5 * nll(txt, img)
