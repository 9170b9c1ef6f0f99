"""Plain float32 PyTorch BERT / UNITER layers: the benchmark's reference.

It follows the published models (BERT, Devlin et al. 2019; UNITER, Chen
et al. 2020; LightningDOT, Sun et al. 2021): post-LN layers, erf GELU, an
additive -10000 key mask, UNITER's region embedding (feature and box
linears, each LayerNorm-ed, plus the type-1 embedding, LayerNorm-ed), and
LightningDOT's Linear-GELU-LayerNorm-Linear projection of the [CLS] row.
Parameters are a plain ``{name: tensor}`` dict under the reference
checkpoints' state-dict keys. Nothing of the program is imported.

Every product goes through :class:`Precision`: float32 (products in
float32, TF32 off), or the control, which rounds each operand of every
product (forward and backward) to TF32 and accumulates in float32.

Dropout is replayed from the seeds a training step was handed
(:class:`Dropout`): hidden-state sites draw ``torch.rand`` from the pass's
generator in the order the layers run, and attention probabilities keep by
counter-based Philox4x32-10 keyed per layer, a frozen copy of the port's
documented draw (``philox_keep``, ``site_seeds``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

MASK_BIAS = -10000.0
Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, half away from zero (the
    tensor cores' ``cvt.rna.tf32.f32``)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        return (r(g) @ r(b).transpose(-1, -2),
                r(a).transpose(-1, -2) @ r(g), None)


class Precision:
    """``f32``, or the control: ``tf32``."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return a @ b
        return _RoundedMatmul.apply(a, b, _tf32)


# ---------------------------------------------------------------------------
# dropout, replayed
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_GOLDEN = 0x9E3779B97F4A7C15
_M64 = 0xFFFFFFFFFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    p1 = b * (a & 0xFFFF)
    p2 = b * (a >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (s >> 32), s & _M32


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit
    words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_keep(seed: int, b: int, h: int, s: int, t: int, rate: float,
                device) -> torch.Tensor:
    """bool [b, h, s, t]: element (i, n, r, c) keeps iff word ``c % 4`` of
    philox4x32((c // 4, r, n, i), (seed lo, seed hi)) is below
    (1 - rate) * 2**32."""
    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    words = philox4x32(
        (axis((t + 3) // 4, 3), axis(s, 2), axis(h, 1), axis(b, 0)),
        (seed & _M32, (seed >> 32) & _M32))
    words = [w.expand(b, h, s, (t + 3) // 4) for w in words]
    bits = torch.stack(words, dim=-1).reshape(b, h, s, -1)[..., :t]
    return bits < int(min((1.0 - rate) * 4294967296.0, 4294967295.0))


def _splitmix64(x: int) -> int:
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def site_seeds(base: int, n: int) -> List[int]:
    """The 64-bit Philox seeds of ``n`` layers from a pass's seed."""
    return [_splitmix64((base + i * _GOLDEN) & _M64) for i in range(n)]


class Dropout:
    """The keep masks of one pass of a training step."""

    def __init__(self, generator: torch.Generator, hidden_rate: float,
                 attention_rate: float, n_layers: int):
        self.gen = generator
        self.hidden_rate, self.attention_rate = hidden_rate, attention_rate
        self.seeds = site_seeds(generator.initial_seed(), n_layers)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.gen,
                          device=self.gen.device) < 1.0 - self.hidden_rate
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.hidden_rate))

    def attention(self, layer: int, probs: torch.Tensor) -> torch.Tensor:
        b, h, s, t = probs.shape
        rate = self.attention_rate
        keep = philox_keep(self.seeds[layer], b, h, s, t, rate, probs.device)
        return probs * keep.to(probs.dtype) * (1.0 / (1.0 - rate))


# ---------------------------------------------------------------------------
# layouts: names and shapes of the reference checkpoints
# ---------------------------------------------------------------------------

def _linear(name: str, n_out: int, n_in: int):
    return [(f"{name}.weight", (n_out, n_in)), (f"{name}.bias", (n_out,))]


def _norm(name: str, n: int):
    return [(f"{name}.weight", (n,)), (f"{name}.bias", (n,))]


def bert_layout(cfg: dict, pre: str, image: bool):
    """``BertModel`` (embeddings, layers, pooler), with UNITER's
    ``img_embeddings`` where ``image``."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    out = [(f"{pre}embeddings.word_embeddings.weight",
            (cfg["vocab_size"], h)),
           (f"{pre}embeddings.position_embeddings.weight",
            (cfg["max_position_embeddings"], h)),
           (f"{pre}embeddings.token_type_embeddings.weight",
            (cfg["type_vocab_size"], h))]
    out += _norm(f"{pre}embeddings.LayerNorm", h)
    for n in range(cfg["num_hidden_layers"]):
        lp = f"{pre}encoder.layer.{n}."
        for part in ("query", "key", "value"):
            out += _linear(f"{lp}attention.self.{part}", h, h)
        out += _linear(f"{lp}attention.output.dense", h, h)
        out += _norm(f"{lp}attention.output.LayerNorm", h)
        out += _linear(f"{lp}intermediate.dense", i, h)
        out += _linear(f"{lp}output.dense", h, i)
        out += _norm(f"{lp}output.LayerNorm", h)
    out += _linear(f"{pre}pooler.dense", h, h)
    if image:
        ip = f"{pre}img_embeddings."
        out += _linear(f"{ip}img_linear", h, cfg["img_dim"])
        out += _norm(f"{ip}img_layer_norm", h)
        out += _linear(f"{ip}pos_linear", h, cfg["pos_dim"])
        out += _norm(f"{ip}pos_layer_norm", h)
        out += [(f"{ip}mask_embedding.weight", (2, cfg["img_dim"]))]
        out += _norm(f"{ip}LayerNorm", h)
    return out


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, p: Params, name: str,
          prec: Precision) -> torch.Tensor:
    w = p[f"{name}.weight"]
    y = prec.mm(x.reshape(-1, x.shape[-1]), w.t())
    return (y + p[f"{name}.bias"]).reshape(*x.shape[:-1], w.shape[0])


def layer_norm(x: torch.Tensor, p: Params, name: str,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def text_embeddings(p: Params, pre: str, ids: torch.Tensor,
                    pos_ids: torch.Tensor, cfg: dict,
                    drop: Optional[Dropout]) -> torch.Tensor:
    e = (p[f"{pre}embeddings.word_embeddings.weight"][ids]
         + p[f"{pre}embeddings.position_embeddings.weight"][pos_ids]
         + p[f"{pre}embeddings.token_type_embeddings.weight"][0])
    e = layer_norm(e, p, f"{pre}embeddings.LayerNorm", cfg["layer_norm_eps"])
    return drop.hidden(e) if drop is not None else e


def region_embeddings(p: Params, pre: str, feat: torch.Tensor,
                      boxes: torch.Tensor, cfg: dict, prec: Precision,
                      drop: Optional[Dropout]) -> torch.Tensor:
    eps, ip = cfg["layer_norm_eps"], f"{pre}img_embeddings."
    im = layer_norm(dense(feat.float(), p, f"{ip}img_linear", prec), p,
                    f"{ip}img_layer_norm", eps)
    ps = layer_norm(dense(boxes.float(), p, f"{ip}pos_linear", prec), p,
                    f"{ip}pos_layer_norm", eps)
    e = layer_norm(im + ps
                   + p[f"{pre}embeddings.token_type_embeddings.weight"][1],
                   p, f"{ip}LayerNorm", eps)
    return drop.hidden(e) if drop is not None else e


def bert_layer(h: torch.Tensor, bias: torch.Tensor, p: Params, lp: str,
               cfg: dict, prec: Precision, drop: Optional[Dropout],
               index: int) -> torch.Tensor:
    b, s, hid = h.shape
    nh = cfg["num_attention_heads"]
    d = hid // nh
    eps = cfg["layer_norm_eps"]

    def heads(name):
        return dense(h, p, f"{lp}attention.self.{name}", prec).view(
            b, s, nh, d).transpose(1, 2)

    q, k, v = heads("query"), heads("key"), heads("value")
    probs = torch.softmax(prec.mm(q, k.transpose(-1, -2)) / math.sqrt(d)
                          + bias, dim=-1)
    if drop is not None:
        probs = drop.attention(index, probs)
    ctx = prec.mm(probs, v).transpose(1, 2).reshape(b, s, hid)
    a = dense(ctx, p, f"{lp}attention.output.dense", prec)
    if drop is not None:
        a = drop.hidden(a)
    h1 = layer_norm(a + h, p, f"{lp}attention.output.LayerNorm", eps)
    inter = F.gelu(dense(h1, p, f"{lp}intermediate.dense", prec))
    o = dense(inter, p, f"{lp}output.dense", prec)
    if drop is not None:
        o = drop.hidden(o)
    return layer_norm(o + h1, p, f"{lp}output.LayerNorm", eps)


def encoder(h: torch.Tensor, mask: torch.Tensor, p: Params, pre: str,
            cfg: dict, prec: Precision,
            drop: Optional[Dropout]) -> torch.Tensor:
    bias = (1.0 - mask.float())[:, None, None, :] * MASK_BIAS
    for n in range(cfg["num_hidden_layers"]):
        h = bert_layer(h, bias, p, f"{pre}encoder.layer.{n}.", cfg, prec,
                       drop, n)
    return h


def pad_rows(rows: List[torch.Tensor], length: int) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """[n_i, ...] tensors -> ([B, length, ...] zero-padded, [B, length]
    mask)."""
    out = rows[0].new_zeros((len(rows), length, *rows[0].shape[1:]))
    mask = torch.zeros((len(rows), length), dtype=torch.int64,
                       device=rows[0].device)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
        mask[i, :r.shape[0]] = 1
    return out, mask
