"""The UNITER joint cross-encoder: the KD teacher and the second-stage
re-ranker (counterpart of lightningdot_tpu/models/cross_encoder.py;
reference uniter_model/model/itm.py:12-195).

:class:`CrossEncoder` (UniterForImageTextRetrieval, itm.py:12-53) encodes
text and regions jointly, pools row 0 through the tanh pooler, and scores
with the scalar ``rank_output`` head under the sigmoid-triplet loss; it
also carries the 2-way ``itm_output`` head of UNITER pre-training's ITM
with the optional OT distance (model.py:627-672). :class:`CrossEncoderHardNeg`
self-mines its hard negatives in the batch (itm.py:56-137);
:class:`CrossEncoderFast` scores the cosine of two streams (itm.py:140-195).

Parameters carry the reference's names (``bert.*``, ``itm_output.*``,
``rank_output.*``; Fast adds ``img_bert.*``), so a released teacher loads
with ``load_state_dict``. Models are built in eval mode; ``train()`` turns
dropout on, with masks drawn from the ``generator`` passed in. Where JAX
passes ``deterministic``, the port reads the module's mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.models.encoder import (BertModel, Dense,
                                                   ImgEmbeddings, encode_image_only,
                                                   encode_joint,
                                                   encode_text_seq)
from lightningdot_tpu_torch.models.ot import optimal_transport_dist


def sigmoid_triplet_loss(rank_scores: torch.Tensor, sample_size: int,
                         margin: float) -> torch.Tensor:
    """Sigmoid-margin triplet loss over candidate groups, positive first
    (``sigmoid_triplet_loss``, cross_encoder.py:25-31; itm.py:43-51) ->
    [groups, sample_size - 1]."""
    scores = torch.sigmoid(rank_scores).reshape(-1, sample_size)
    return torch.clamp(margin + scores[:, 1:] - scores[:, :1], min=0.0)


def uniter_model(cfg: EncoderConfig) -> BertModel:
    """A ``BertModel`` with ``img_embeddings`` (UniterModel's layout)."""
    bert = BertModel(cfg)
    bert.img_embeddings = ImgEmbeddings(cfg)
    return bert


def _expand(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.expand(n, *x.shape[1:]) if x.shape[0] == 1 else x


class CrossEncoder(nn.Module):
    """The joint cross-encoder (``CrossEncoder``, cross_encoder.py:34-187).
    Built in eval mode."""

    def __init__(self, cfg: EncoderConfig, margin: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.margin = margin
        self.compute_dtype = compute_dtype
        self.bert = uniter_model(cfg)
        self.itm_output = Dense(cfg.hidden_size, 2)
        self.rank_output = Dense(cfg.hidden_size, 1)
        self.train(False)

    @torch.no_grad()
    def init_output(self) -> "CrossEncoder":
        """Seed the rank head from the itm head's row 1 (itm.py:23-26)."""
        self.rank_output.weight.copy_(self.itm_output.weight[1:2])
        self.rank_output.bias.copy_(self.itm_output.bias[1:2])
        return self

    def encode(self, batch: Dict[str, Any],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Joint sequence [B, S, H] in the compute dtype."""
        return encode_joint(
            self.bert, batch["input_ids"], batch["position_ids"],
            batch["img_feat"], batch["img_pos_feat"], batch["attn_masks"],
            gather_index=batch.get("gather_index"),
            img_masks=batch.get("img_masks"), dtype=self.compute_dtype,
            generator=generator)

    def pooled(self, batch, generator=None) -> torch.Tensor:
        return self.bert.pooler(self.encode(batch, generator),
                                self.compute_dtype)

    def rank_scores(self, batch: Dict[str, Any],
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """float32 [B, 1] rank logits (itm.py:36-41)."""
        return self.rank_output(self.pooled(batch, generator),
                                self.compute_dtype).float()

    def apply(self, batch: Dict[str, Any], *, compute_loss: bool = True,
              generator: Optional[torch.Generator] = None,
              sample_size: Optional[int] = None, **_):
        """Rank logits, or the triplet loss over ``sample_size`` groups
        (itm.py:28-53; ``sample_size`` defaults to ``batch['sample_size']``)."""
        rank = self.rank_scores(batch, generator)
        if not compute_loss:
            return rank
        if sample_size is None:
            sample_size = batch["sample_size"]
        return sigmoid_triplet_loss(rank, int(sample_size), self.margin)

    def mine_and_apply(self, batch: Dict[str, Any], *, hard_size: int,
                       sample_from: str = "t",
                       generator: Optional[torch.Generator] = None):
        """In-batch self-mined hard-negative triplet loss
        (``mine_and_apply``, cross_encoder.py:87-137; reference
        UniterForImageTextRetrievalHardNeg, itm.py:63-137): score the whole
        candidate group in eval mode without a gradient (row 0 is the
        positive), keep the top ``hard_size`` negatives, and train on
        [positive + hard negatives]. The hard batch is a gather on the
        device, so nothing waits on the host. ``sample_from='t'`` shares
        the text across the group, ``'i'`` the image."""
        batch = dict(batch)
        n = batch["attn_masks"].shape[0]
        if sample_from == "t":
            batch["input_ids"] = _expand(batch["input_ids"], n)
        elif sample_from == "i":
            batch["img_feat"] = _expand(batch["img_feat"], n)
            batch["img_pos_feat"] = _expand(batch["img_pos_feat"], n)
        else:
            raise ValueError(f"sample_from={sample_from!r}")
        batch["position_ids"] = _expand(batch["position_ids"], n)

        was_training = self.training
        self.eval()      # the scoring pass draws no dropout (itm.py:82-86)
        try:
            with torch.no_grad():
                scores = self.rank_scores(batch)[:, 0]
        finally:
            self.train(was_training)
        hard = torch.topk(scores[1:], hard_size).indices
        indices = torch.cat([torch.zeros(1, dtype=hard.dtype,
                                         device=hard.device), hard + 1])
        hard_batch = {k: (v.index_select(0, indices)
                          if isinstance(v, torch.Tensor) and v.dim()
                          and v.shape[0] == n else v)
                      for k, v in batch.items() if v is not None}
        # the base class's triplet forward (itm.py:87-89 super().forward)
        return CrossEncoder.apply(self, hard_batch, compute_loss=True,
                                  generator=generator,
                                  sample_size=hard_size + 1)

    def itm_scores(self, batch: Dict[str, Any], *,
                   generator: Optional[torch.Generator] = None,
                   targets=None, ot_inputs=None, ot_pos_only: bool = False,
                   compute_loss: bool = True):
        """UNITER pre-training's ITM head and the optional OT loss
        (``itm_scores``, cross_encoder.py:139-187; model.py:627-672) ->
        (nll [B] or logits [B, 2], OT loss or None)."""
        seq = self.encode(batch, generator)
        pooled = self.bert.pooler(seq, self.compute_dtype)
        logits = self.itm_output(pooled, self.compute_dtype).float()
        ot_loss = None
        if ot_inputs is not None:
            if batch.get("gather_index") is not None:
                # a compacting gather_index puts each example's regions at
                # its true text length, so a split at the padded length
                # would hand region rows to OT as text; the reference
                # un-scatters first (model.py:640-653)
                raise NotImplementedError(
                    "itm_scores OT with a compacting gather_index needs "
                    "the ot_scatter un-compaction; pass uncompacted "
                    "batches (gather_index=None) for OT")
            tl = batch["input_ids"].shape[1]
            dist = optimal_transport_dist(
                seq[:, :tl].float(), seq[:, tl:].float(),
                ot_inputs["txt_pad"], ot_inputs["img_pad"])
            zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
            pos = torch.where(targets == 1, dist, zero)
            ot_loss = pos if ot_pos_only else (
                pos, torch.where(targets == 0, dist, zero))
        if compute_loss:
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(1, targets.long()[:, None])[:, 0]
            return nll, ot_loss
        return logits, ot_loss


class CrossEncoderHardNeg(CrossEncoder):
    """The self-mining teacher (``CrossEncoderHardNeg``,
    cross_encoder.py:190-215; reference itm.py:56-137): in training mode
    ``apply`` mines the group's ``hard_size`` hardest negatives; in eval
    mode it is the base class."""

    def __init__(self, cfg: EncoderConfig, margin: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32,
                 hard_size: int = 16):
        super().__init__(cfg, margin, compute_dtype)
        self.hard_size = hard_size

    def apply(self, batch, *, compute_loss=True, generator=None,
              sample_size=None, sample_from: str = "t"):
        if compute_loss and self.training:
            return self.mine_and_apply(batch, hard_size=self.hard_size,
                                       sample_from=sample_from,
                                       generator=generator)
        return super().apply(batch, compute_loss=compute_loss,
                             generator=generator, sample_size=sample_size)


class CrossEncoderFast(nn.Module):
    """The two-stream cosine teacher (``CrossEncoderFast``,
    cross_encoder.py:218-311; reference UniterForImageTextRetrievalFast,
    itm.py:140-195): the full-depth ``bert`` tower encodes the text, an
    ``img_bert`` tower of ``cfg.num_hidden_layers_img`` layers encodes the
    regions (no [CLS]), and the score is the cosine of the two tanh-pooled
    rows. Both towers keep UniterModel's whole layout, ``img_bert``'s
    unused text embeddings included, so checkpoints load strictly."""

    def __init__(self, cfg: EncoderConfig, margin: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.margin = margin
        self.compute_dtype = compute_dtype
        self.bert = uniter_model(cfg)
        self.img_bert = uniter_model(self.img_cfg)
        self.itm_output = Dense(cfg.hidden_size, 2)
        self.rank_output = Dense(cfg.hidden_size, 1)
        self.train(False)

    @property
    def img_cfg(self) -> EncoderConfig:
        return dataclasses.replace(
            self.cfg, num_hidden_layers=self.cfg.num_hidden_layers_img)

    init_output = CrossEncoder.init_output

    def rank_scores(self, batch: Dict[str, Any],
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """float32 [B] cosine scores (itm.py:166-183). A text shared by
        the group ([1, L] ids) is encoded once and its pooled row
        broadcast, in eval mode only: under dropout each pair draws its own
        masks."""
        dtype = self.compute_dtype
        n = batch["attn_masks_img"].shape[0]
        ids = batch["input_ids"]
        shared = (ids.shape[0] == 1 and n > 1
                  and (not self.training or generator is None))
        if ids.shape[0] == 1 and not shared:
            ids = ids.expand(n, *ids.shape[1:])
        pos = batch["position_ids"].expand(ids.shape[0],
                                           batch["position_ids"].shape[-1])
        txt_mask = batch["attn_masks_text"]
        if shared and txt_mask.shape[0] != 1:
            txt_mask = txt_mask[:1]
        txt_seq = encode_text_seq(self.bert, ids, txt_mask, pos, dtype=dtype,
                                  generator=generator)
        pooled_txt = self.bert.pooler(txt_seq, dtype)
        if shared:
            pooled_txt = pooled_txt.expand(n, *pooled_txt.shape[1:])
        img_seq = encode_image_only(
            self.img_bert, batch["attn_masks_img"],
            _expand(batch["img_feat"], n), _expand(batch["img_pos_feat"], n),
            dtype=dtype, generator=generator)
        pooled_img = self.img_bert.pooler(img_seq, dtype)
        t, v = pooled_txt.float(), pooled_img.float()
        eps = 1e-8   # torch.nn.CosineSimilarity's default
        return ((t * v).sum(-1)
                / (torch.clamp(torch.linalg.norm(t, dim=-1), min=eps)
                   * torch.clamp(torch.linalg.norm(v, dim=-1), min=eps)))

    def apply(self, batch, *, compute_loss=True, generator=None,
              sample_size=None, **_):
        """The triplet loss over ``sample_size`` groups (itm.py:185-195)."""
        rank = self.rank_scores(batch, generator)
        if not compute_loss:
            return rank
        if sample_size is None:
            sample_size = batch["sample_size"]
        return sigmoid_triplet_loss(rank, int(sample_size), self.margin)


@torch.no_grad()
def init_cross_encoder_(model: nn.Module, generator: torch.Generator
                        ) -> nn.Module:
    """Random weights as the JAX package's ``init`` draws them
    (normal(0, initializer_range) kernels and tables, zero biases, unit
    LayerNorm scales, a zero padding row), from a CPU ``generator``; the
    numbers differ from JAX's PRNGKey draw."""
    from lightningdot_tpu_torch.models.encoder import LayerNorm

    std = model.cfg.initializer_range
    for module in model.modules():
        if isinstance(module, (Dense, nn.Embedding)):
            module.weight.copy_(torch.randn(module.weight.shape,
                                            generator=generator) * std)
        if isinstance(module, Dense):
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for bert in (getattr(model, "bert", None), getattr(model, "img_bert",
                                                       None)):
        if isinstance(bert, BertModel):
            bert.embeddings.word_embeddings.weight[0].zero_()
    return model
