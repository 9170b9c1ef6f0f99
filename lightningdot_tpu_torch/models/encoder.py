"""The BERT text and image towers (counterpart of
lightningdot_tpu/models/encoder.py).

Modules are named after the reference's torch state-dict keys
(``bert.embeddings.word_embeddings.weight``,
``bert.encoder.layer.{i}.attention.self.query.weight`` stored [out, in],
``encode_proj.{0,2,3}.*``), so a released tower state dict loads with
``load_state_dict`` and ``map_tower(tower.state_dict())`` gives the JAX
tree.

Math parity with the JAX package (and through it the reference): post-LN
BERT layers, erf GELU, additive -10000 key mask, pooled output = the raw
CLS hidden, optional Linear-GELU-LN-Linear projection head. Parameters are
float32 masters; ``dtype`` selects the compute dtype. Each dense layer
multiplies in that dtype, accumulates in float32, adds its float32 bias and
rounds once (``encoder._dense``). LayerNorm scales and biases stay float32.

A tower is built in eval mode, deterministic as the JAX package's default
(``deterministic=True``). ``train()`` turns dropout on (``_dropout``,
encoder.py:235-248): embedding dropout and the ``use_fused`` branch of
``_bert_layer`` (:286-376) with its attention kernel branch (:308-324,
``ops/attention_fused.py``). Hidden dropout draws from the ``generator``
passed to ``forward``; the attention masks come from Philox seeds derived
from that generator's seed. Every op has a gradient (``ops/fused.py``,
``ops/attention_fused.py``, the FFN and LayerNorm Functions), so a loss
through a tower reaches the float32 masters.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.ops import (attention_nodrop, ffn_gelu,
                                        fused_attention_train, gelu,
                                        layer_norm, mm_f32, mm_round,
                                        multi_head_attention)
from lightningdot_tpu_torch.ops.attention import MAX_SEQ
from lightningdot_tpu_torch.ops.attention_fused import site_seeds
from lightningdot_tpu_torch.ops.fused import (apply_keep, dropout_add_ln,
                                              keep_mask)

MASK_BIAS = -10000.0  # uniter_model/model/model.py:365


def _drops(module: nn.Module, rate: float,
           generator: Optional[torch.Generator]) -> bool:
    """Whether a dropout site of ``module`` drops: training mode and a rate
    above 0. A site that drops needs a generator, as JAX's needs a key."""
    if not module.training or rate == 0.0:
        return False
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator "
                         "(pass generator=...)")
    return True


def _draw(module: nn.Module, rate: float, shape,
          generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """The keep mask of one dropout site, or None where it does not drop."""
    if not _drops(module, rate, generator):
        return None
    return keep_mask(shape, rate, generator)


def _attention_seeds(module: nn.Module, rate: float, n: int,
                     generator: Optional[torch.Generator],
                     device: torch.device) -> Optional[torch.Tensor]:
    """int64 [n] Philox seeds of ``n`` attention-dropout sites, or None where
    they do not drop: a function of ``generator.initial_seed()`` (the host
    seed it was made from), so one step seed gives one set of masks on the
    card and on the CPU, with no device sync. A generator seeds the masks of
    one forward pass: the training step makes fresh ones every step."""
    if not _drops(module, rate, generator):
        return None
    return site_seeds(generator.initial_seed(), n, device)


def _dropout(module, x, rate, generator):
    """Inverted dropout (``_dropout``, encoder.py:235-248)."""
    keep = _draw(module, rate, x.shape, generator)
    return x if keep is None else apply_keep(x, keep, rate)


class Dense(nn.Linear):
    """``nn.Linear`` with the numerics of ``encoder._dense``: the one
    projection layer of every tower (BERT's with a bias, Moonlight's MLA
    without).

    :meth:`kernel` gives the weight in the compute dtype and the [in, out]
    layout. The JAX package casts the float32 masters on every call; this
    casts once per (dtype, device) and keeps the copy until the weight
    changes (its version counter moves on an in-place update such as
    ``load_state_dict``, and ``training.optim.FusedAdamW`` moves it after
    each step). The numbers are the same. Where the weight needs a
    gradient, the cast is made on every call, in the graph. Below float32
    the product, the bias and the rounding are one ``mm_round``.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias)
        self._kernels: Dict[tuple, Tuple[int, torch.Tensor]] = {}

    def kernel(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(dtype).t()
        key = (dtype, w.device, w.data_ptr())
        hit = self._kernels.get(key)
        if hit is None or hit[0] != w._version:
            with torch.no_grad():
                cast = w.detach().to(dtype).t().contiguous()
            self._kernels = {key: (w._version, cast)}
            hit = self._kernels[key]
        return hit[1]

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shape = x.shape
        if dtype != torch.float32:
            y = mm_round(x.reshape(-1, shape[-1]).to(dtype),
                         self.kernel(dtype), self.bias)
            return y.reshape(*shape[:-1], self.out_features)
        y = mm_f32(x.reshape(-1, shape[-1]).to(dtype), self.kernel(dtype))
        if self.bias is not None:
            y = y + self.bias
        return y.to(dtype).reshape(*shape[:-1], self.out_features)


class LayerNorm(nn.Module):
    """LayerNorm with float32 ``weight`` (scale) and ``bias``; the kernel on
    CUDA (ops.layer_norm)."""

    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Embeddings(nn.Module):
    """Word + position + type-0 embeddings -> LN (``text_embeddings``,
    lightningdot_tpu/models/encoder.py:251; reference model.py:233-246)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.dropout = cfg.hidden_dropout_prob
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, input_ids, position_ids, dtype, generator=None):
        words = self.word_embeddings(input_ids)
        pos = self.position_embeddings(position_ids)
        types = self.token_type_embeddings.weight[0]
        # summed in float32, then cast, then LN (encoder.py:255-261)
        emb = self.LayerNorm((words + pos + types).to(dtype))
        return _dropout(self, emb, self.dropout, generator)


class ImgEmbeddings(nn.Module):
    """Region features -> embeddings (``img_embeddings``,
    lightningdot_tpu/models/encoder.py:265-283; reference model.py:249-273):
    img_linear + LN, pos_linear + LN, + the type embedding, joint LN. Keys
    as ``checkpoint_torch.export_tower(with_img=True)`` writes them."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.dropout = cfg.hidden_dropout_prob
        self.img_linear = Dense(cfg.img_dim, h)
        self.img_layer_norm = LayerNorm(h, eps)
        self.pos_linear = Dense(cfg.pos_dim, h)
        self.pos_layer_norm = LayerNorm(h, eps)
        self.mask_embedding = nn.Embedding(2, cfg.img_dim)
        self.LayerNorm = LayerNorm(h, eps)

    def forward(self, img_feat, img_pos_feat, type_embedding, img_masks,
                dtype, generator=None):
        if img_masks is not None:
            # row 0 of mask_embedding counts as zero on every forward
            # (model.py:264); the stored weight is left as it is
            table = self.mask_embedding.weight
            table = torch.cat([torch.zeros_like(table[:1]), table[1:]])
            img_feat = img_feat + table[img_masks.long()]
        im = self.img_layer_norm(self.img_linear(img_feat.to(dtype), dtype))
        pos = self.pos_layer_norm(self.pos_linear(img_pos_feat.to(dtype),
                                                  dtype))
        emb = self.LayerNorm(im + pos + type_embedding.to(dtype))
        return _dropout(self, emb, self.dropout, generator)


class _SelfAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.query = Dense(h, h)
        self.key = Dense(h, h)
        self.value = Dense(h, h)


class _DenseLN(nn.Module):
    """``dense`` + ``LayerNorm`` pair (attention.output and output)."""

    def __init__(self, in_dim: int, out_dim: int, eps: float):
        super().__init__()
        self.dense = Dense(in_dim, out_dim)
        self.LayerNorm = LayerNorm(out_dim, eps)


class _Attention(nn.Module):
    def __init__(self, h: int, eps: float):
        super().__init__()
        self.self = _SelfAttention(h)
        self.output = _DenseLN(h, h, eps)


class _Intermediate(nn.Module):
    def __init__(self, h: int, inter: int):
        super().__init__()
        self.dense = Dense(h, inter)


class BertLayer(nn.Module):
    """One post-LN BertLayer (``_bert_layer``,
    lightningdot_tpu/models/encoder.py:286-376).

    Inference (eval mode, no gradient): the attention kernel and plain
    LayerNorms, the deterministic branch. Training, or wherever a gradient
    is needed: the ``use_fused`` branch, two ``dropout_add_ln`` drawing
    their keep masks from ``generator`` in training mode, and attention by
    the fused training kernel on the raw projections where attention
    dropout is on (JAX's ``LDOT_ATTN_KERNEL=1`` branch, encoder.py:308-324,
    the kernel's own Philox masks from ``attn_seed``), else
    ``attention_nodrop`` (``_attention_nodrop``). The FFN is ``ffn_gelu``
    in both.
    """

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.eps = eps
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        self.attention = _Attention(h, eps)
        self.intermediate = _Intermediate(h, cfg.intermediate_size)
        self.output = _DenseLN(cfg.intermediate_size, h, eps)

    def forward(self, hidden, mask_bias, dtype, generator=None,
                attn_seed: Optional[torch.Tensor] = None):
        """``attn_seed``: the int64 [1] Philox seed of this layer's attention
        dropout (``BertEncoderStack`` passes one per layer); drawn from
        ``generator`` where it is None."""
        b, s, h = hidden.shape
        nh = self.num_heads
        sa = self.attention.self
        q, k, v = (sa.query(hidden, dtype), sa.key(hidden, dtype),
                   sa.value(hidden, dtype))
        if attn_seed is None:
            attn_seed = _attention_seeds(self, self.attn_dropout, 1,
                                         generator, hidden.device)
        if attn_seed is not None:
            # raw [B, S, H]: the kernel splits the heads by strides
            ctx = fused_attention_train(q, k, v, mask_bias.reshape(b, s),
                                        attn_seed, nh=nh,
                                        rate=self.attn_dropout)
        else:
            # projection-native [B, S, heads, dim]: the kernel reads it by
            # strides
            q, k, v = (t.view(b, s, nh, self.head_dim) for t in (q, k, v))
            if torch.is_grad_enabled() and q.requires_grad:
                ctx = attention_nodrop(q, k, v, mask_bias)
            else:
                ctx = multi_head_attention(q, k, v, mask_bias)
        out = self.attention.output
        dense = out.dense(ctx.reshape(b, s, h), dtype)
        keep = _draw(self, self.hidden_dropout, dense.shape, generator)
        attn_out = dropout_add_ln(dense, hidden, out.LayerNorm.weight,
                                  out.LayerNorm.bias, keep,
                                  rate=self.hidden_dropout, eps=self.eps)
        fc1, fc2 = self.intermediate.dense, self.output.dense
        ffn = ffn_gelu(attn_out, fc1.kernel(dtype).contiguous(), fc1.bias,
                       fc2.kernel(dtype).contiguous(), fc2.bias)
        keep = _draw(self, self.hidden_dropout, ffn.shape, generator)
        ln = self.output.LayerNorm
        return dropout_add_ln(ffn, attn_out, ln.weight, ln.bias, keep,
                              rate=self.hidden_dropout, eps=self.eps)


class BertEncoderStack(nn.Module):
    """The layer loop (``encoder_stack``, encoder.py:397)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, mask_bias, dtype, generator=None,
                n_layers: Optional[int] = None):
        """``n_layers`` runs only the first layers (``encode_image_only``'s
        truncation, encoder.py:536-538)."""
        layers = self.layer[:n_layers] if n_layers is not None else self.layer
        seeds = _attention_seeds(self, self.attn_dropout, len(layers),
                                 generator, hidden.device)
        for i, layer in enumerate(layers):
            hidden = layer(hidden, mask_bias, dtype, generator,
                           None if seeds is None else seeds[i:i + 1])
        return hidden


class _Pooler(nn.Module):
    """The tanh pooler (``pooler``, encoder.py:442; reference
    layer.py:173-185). The retrieval towers keep it only so that
    checkpoints round-trip; the cross-encoder scores through it."""

    def __init__(self, h: int):
        super().__init__()
        self.dense = Dense(h, h)

    def forward(self, hidden: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        """tanh(dense(row 0)) in the compute dtype."""
        return torch.tanh(self.dense(hidden[:, 0], dtype))


class BertModel(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.embeddings = Embeddings(cfg)
        self.encoder = BertEncoderStack(cfg)
        self.pooler = _Pooler(cfg.hidden_size)


def attention_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] {0,1} mask -> additive float32 [B, 1, 1, S] bias
    (encoder.py:429-432; reference model.py:362-365)."""
    return ((1.0 - attention_mask.float()) * MASK_BIAS)[:, None, None, :]


def check_joint_length(s: int, device: torch.device, what: str) -> None:
    """The card's attention kernels take at most ``ops.attention.MAX_SEQ``
    keys (ROADMAP §C); a joint sequence above that raises here, with its
    parts, where JAX would fall back to XLA."""
    if device.type == "cuda" and s > MAX_SEQ:
        raise ValueError(f"{what}: joint sequence of {s} rows exceeds the "
                         f"card attention kernels' {MAX_SEQ} keys")


def encode_joint(bert: "BertModel", input_ids, position_ids, img_feat,
                 img_pos_feat, attention_mask, *, gather_index=None,
                 img_masks=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Joint text + image forward -> [B, S, H] (``encode_joint``,
    encoder.py:541-572; reference UniterModel.forward, model.py:356-387):
    the text embeddings (type 0) then the region embeddings (type 1)
    concatenated, optionally compacted by ``gather_index`` [B, S_out]
    (model.py:347-354), through the stack. ``bert`` holds
    ``img_embeddings``."""
    txt = bert.embeddings(input_ids, position_ids, dtype, generator)
    img_type = bert.embeddings.token_type_embeddings.weight[1]
    img = bert.img_embeddings(img_feat, img_pos_feat, img_type, img_masks,
                              dtype, generator)
    emb = torch.cat([txt, img], dim=1)
    if gather_index is not None:
        idx = torch.as_tensor(gather_index, device=emb.device).long()
        emb = torch.gather(emb, 1, idx[:, :, None].expand(-1, -1,
                                                          emb.shape[-1]))
    check_joint_length(emb.shape[1], emb.device,
                       f"encode_joint ({input_ids.shape[1]} text + "
                       f"{img_feat.shape[1]} regions)")
    return bert.encoder(emb, attention_bias(attention_mask), dtype,
                        generator)


def encode_image_only(bert: "BertModel", attention_mask, img_feat,
                      img_pos_feat, *, img_masks=None,
                      dtype: torch.dtype = torch.float32,
                      generator: Optional[torch.Generator] = None,
                      n_layers: Optional[int] = None) -> torch.Tensor:
    """Regions only, no [CLS] token -> [B, R, H] (``encode_image_only``,
    encoder.py:513-538; reference UniterModel.forward with
    ``input_ids=None``, the Fast teacher's image stream). ``n_layers``
    truncates the stack."""
    img_type = bert.embeddings.token_type_embeddings.weight[1]
    emb = bert.img_embeddings(img_feat, img_pos_feat, img_type, img_masks,
                              dtype, generator)
    check_joint_length(emb.shape[1], emb.device, "encode_image_only")
    return bert.encoder(emb, attention_bias(attention_mask), dtype,
                        generator, n_layers=n_layers)


def encode_text_seq(bert: "BertModel", input_ids, attention_mask,
                    position_ids, *, dtype: torch.dtype = torch.float32,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Text only -> [B, L, H] (``encode_text(project=False)``'s sequence,
    encoder.py:451-470), on any ``BertModel``."""
    emb = bert.embeddings(input_ids, position_ids, dtype, generator)
    return bert.encoder(emb, attention_bias(attention_mask), dtype,
                        generator)


class TextEncoder(nn.Module):
    """The text tower: ``bert.*`` plus the optional ``encode_proj`` head
    (reference dvl/models/bi_encoder.py:76-128). Built in eval mode."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.encode_proj: Optional[nn.Sequential] = None
        if cfg.project_dim > 0:
            h = cfg.hidden_size
            self.encode_proj = nn.Sequential(
                Dense(h, 2 * h), nn.GELU(),
                LayerNorm(2 * h, cfg.layer_norm_eps),
                Dense(2 * h, cfg.project_dim))
        self.train(False)

    def projection_head(self, pooled, dtype):
        """Linear-GELU-LN-Linear (``projection_head``, encoder.py:435)."""
        fc1, _, ln, fc2 = self.encode_proj
        return fc2(ln(gelu(fc1(pooled, dtype))), dtype)

    def forward(self, input_ids, attention_mask, position_ids, *,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                head: bool = True):
        """-> (sequence [B, S, H], pooled [B, out]) (``encode_text``,
        encoder.py:451). ``generator`` draws the dropout masks in training
        mode. ``head=False`` skips the projection head (pooled is then the
        CLS row), for callers that read only the sequence."""
        seq = encode_text_seq(self.bert, input_ids, attention_mask,
                              position_ids, dtype=dtype, generator=generator)
        pooled = seq[:, 0, :]
        if head and self.encode_proj is not None:
            pooled = self.projection_head(pooled, dtype)
        return seq, pooled


class ImageEncoder(TextEncoder):
    """The image tower: a text tower whose ``bert`` also holds
    ``img_embeddings`` (reference dvl/models/bi_encoder.py:131-196)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__(cfg)
        self.bert.img_embeddings = ImgEmbeddings(cfg)
        self.train(False)

    def forward(self, input_ids, attention_mask, img_feat, img_pos_feat, *,
                img_masks=None, dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                head: bool = True):
        """-> (sequence [B, 1+R, H], pooled [B, out]) (``encode_image``,
        encoder.py:473-510).

        ``input_ids`` [B, 1] holds the [CLS] id (101, dvl/data/itm.py:74)
        at position 0 with type 0; the R regions follow with type 1.
        ``attention_mask`` [B, 1+R]; ``img_feat`` [B, R, img_dim];
        ``img_pos_feat`` [B, R, 7]; ``img_masks`` optional [B, R] {0, 1};
        ``head`` as for the text tower.
        """
        bert = self.bert
        txt = bert.embeddings(input_ids, torch.zeros_like(input_ids), dtype,
                              generator)
        img_type = bert.embeddings.token_type_embeddings.weight[1]
        img = bert.img_embeddings(img_feat, img_pos_feat, img_type,
                                  img_masks, dtype, generator)
        seq = bert.encoder(torch.cat([txt, img], dim=1),
                           attention_bias(attention_mask), dtype, generator)
        pooled = seq[:, 0, :]
        if head and self.encode_proj is not None:
            pooled = self.projection_head(pooled, dtype)
        return seq, pooled


@torch.no_grad()
def init_tower_(tower: TextEncoder, generator: torch.Generator
                ) -> TextEncoder:
    """Random weights for a text or image tower as the JAX package
    initialises them (encoder.py:55-157): normal(0, initializer_range) for
    dense kernels and embedding tables (``img_linear``, ``pos_linear`` and
    ``mask_embedding`` included), zero biases, unit LayerNorm scales, and a
    zero row for the padding id 0. ``generator`` lives on the CPU; the
    weights are copied to the tower's device."""
    std = tower.cfg.initializer_range
    for module in tower.modules():
        if isinstance(module, (Dense, nn.Embedding)):
            w = torch.randn(module.weight.shape, generator=generator) * std
            module.weight.copy_(w)
        if isinstance(module, Dense):
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    tower.bert.embeddings.word_embeddings.weight[0].zero_()
    return tower
