"""Two-tower bi-encoder, its in-batch loss and its pre-training heads
(counterpart of lightningdot_tpu/models/bi_encoder.py).

Built in eval mode; ``train()`` turns dropout on, with the masks drawn from
the generators passed to :meth:`BiEncoder.apply`. The training step's
bidirectional loss is ``training/itm_step.py``; :class:`BiEncoderNllLoss`
is the one-directional form the evaluator reports.
:class:`BiEncoderForPretraining` (bi_encoder.py:174-422) puts the MLM,
MRFR, MRC(-kl) and ITM heads on the towers' sequences, under the
reference's state-dict names.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.models.encoder import (Dense, ImageEncoder,
                                                   LayerNorm, TextEncoder)
from lightningdot_tpu_torch.ops import gelu, mm_f32
from lightningdot_tpu_torch.parallel.mesh import (gather_batch_rows,
                                                  gather_rows, process_index)


def dot_product_scores(q_vectors: torch.Tensor,
                       ctx_vectors: torch.Tensor) -> torch.Tensor:
    """q [n1, D] x ctx [n2, D] -> float32 [n1, n2] (reference
    bi_encoder.py:54-68), accumulated in float32."""
    return mm_f32(q_vectors, ctx_vectors.t())


class BiEncoderNllLoss:
    """In-batch contrastive NLL (the port's ``BiEncoderNllLoss.calc``,
    lightningdot_tpu/models/bi_encoder.py:51-91; reference
    dvl/models/bi_encoder.py:613-665)."""

    @staticmethod
    def calc(q_vectors: torch.Tensor, ctx_vectors: torch.Tensor,
             caption_vectors: Optional[torch.Tensor], positive_idx,
             hard_negative_idx=None, caption_score_weight: float = 0.1,
             reduction: str = "mean", col_valid=None):
        """Returns (loss, correct_prediction_count, scores), float32 on the
        vectors' device.

        ``positive_idx``: int [n_q] of the positive ctx column per query.
        ``col_valid``: optional [n_ctx] 0/1 mask: invalid context columns
        (fixed-size batch padding duplicates) are excluded from every OTHER
        row's softmax denominator (each row's own positive stays unmasked).
        ``hard_negative_idx`` is accepted for the reference's signature and
        unused, as there.
        """
        del hard_negative_idx
        scores = dot_product_scores(q_vectors, ctx_vectors)
        if caption_vectors is not None and caption_score_weight != 0:
            scores_cap = dot_product_scores(q_vectors, caption_vectors)
            scores = ((1 - caption_score_weight) * scores
                      + caption_score_weight * scores_cap)
        positive_idx = torch.as_tensor(positive_idx, dtype=torch.int64,
                                       device=scores.device)
        if col_valid is not None:
            col_valid = torch.as_tensor(col_valid, dtype=scores.dtype,
                                        device=scores.device)
            col_mask = (1.0 - col_valid)[None, :] * -1e30
            diag = torch.nn.functional.one_hot(
                positive_idx, scores.shape[1]).to(scores.dtype)
            scores = scores + col_mask * (1.0 - diag)
        log_probs = torch.log_softmax(scores, dim=1)
        nll = -log_probs.gather(1, positive_idx[:, None])[:, 0]
        if reduction == "mean":
            loss = nll.mean()
        elif reduction == "sum":
            loss = nll.sum()
        else:
            loss = nll
        correct = (log_probs.argmax(dim=1) == positive_idx).sum()
        return loss, correct, scores


class BiEncoder(nn.Module):
    """The two towers; ``txt_model.*`` and ``img_model.*`` state-dict keys
    as in the reference's fine-tune checkpoints (bi_encoder.py:203-219).
    Without ``img_cfg`` only the text tower is built (the query server
    needs no image tower). ``fix_txt_encoder`` / ``fix_img_encoder`` run
    that tower without a gradient (JAX's ``stop_gradient``)."""

    def __init__(self, txt_cfg: EncoderConfig,
                 img_cfg: Optional[EncoderConfig] = None, *,
                 compute_dtype: torch.dtype = torch.float32,
                 fix_txt_encoder: bool = False,
                 fix_img_encoder: bool = False):
        super().__init__()
        self.txt_cfg = txt_cfg
        self.img_cfg = img_cfg
        self.compute_dtype = compute_dtype
        self.fix_txt_encoder = fix_txt_encoder
        self.fix_img_encoder = fix_img_encoder
        self.txt_model = TextEncoder(txt_cfg)
        self.img_model = ImageEncoder(img_cfg) if img_cfg is not None else None
        self.train(False)

    def encode_txt(self, sb: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   sequence: bool = False) -> torch.Tensor:
        """Text sub-batch (input_ids, attention_mask, position_ids) ->
        pooled [B, out] (or the sequence [B, S, H]) in the compute
        dtype."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.fix_txt_encoder):
            seq, pooled = self.txt_model(
                sb["input_ids"], sb["attention_mask"], sb["position_ids"],
                dtype=self.compute_dtype, generator=generator,
                head=not sequence)
        return seq if sequence else pooled

    def encode_img(self, sb: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   sequence: bool = False) -> torch.Tensor:
        """Image sub-batch (input_ids [B, 1], attention_mask, img_feat,
        img_pos_feat, optional img_masks) -> pooled [B, out] (or the
        sequence [B, 1+R, H]) in the compute dtype."""
        if self.img_model is None:
            raise ValueError("this BiEncoder was built without an image "
                             "tower (img_cfg=None)")
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.fix_img_encoder):
            seq, pooled = self.img_model(
                sb["input_ids"], sb["attention_mask"], sb["img_feat"],
                sb["img_pos_feat"], img_masks=sb.get("img_masks"),
                dtype=self.compute_dtype, generator=generator,
                head=not sequence)
        return seq if sequence else pooled

    def apply(self, batch: Dict[str, Any],
              generators: Optional[Sequence[torch.Generator]] = None,
              sequence: bool = False):
        """batch{'txts', 'imgs', 'caps'} -> (txt, img, cap) pooled vectors
        (or, with ``sequence``, the towers' sequences), None where the
        sub-batch is missing (bi_encoder.py:146-167).

        ``generators``: (txt, img, cap), one per pass, as JAX splits one key
        three ways; needed in training mode with dropout."""
        g_txt, g_img, g_cap = generators or (None, None, None)
        txt = img = cap = None
        if batch.get("txts") is not None:
            txt = self.encode_txt(batch["txts"], g_txt, sequence)
        if batch.get("imgs") is not None:
            img = self.encode_img(batch["imgs"], g_img, sequence)
        caps = batch.get("caps")
        if caps is not None and caps.get("input_ids") is not None:
            cap = self.encode_txt(caps, g_cap, sequence)
        return txt, img, cap


# ---------------------------------------------------------------------------
# Pre-training heads
# ---------------------------------------------------------------------------

class _Transform(nn.Module):
    """Dense -> GELU -> LayerNorm (BertPredictionHeadTransform,
    layer.py:189-203), its parameters named as the reference's."""

    def __init__(self, h: int, eps: float):
        super().__init__()
        self.dense = Dense(h, h)
        self.LayerNorm = LayerNorm(h, eps)


class _LMPredictions(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.transform = _Transform(cfg.hidden_size, cfg.layer_norm_eps)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class _MlmHead(nn.Module):
    """``cls.predictions`` (BertOnlyMLMHead, layer.py:205-233); the decoder
    weight is the image tower's word table, read at call time."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.predictions = _LMPredictions(cfg)


class _FeatRegress(nn.Module):
    """``feat_regress`` (RegionFeatureRegression, model.py:390-403): net =
    Linear, GELU, LayerNorm; the output weight is ``img_linear``'s."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.net = nn.Sequential(Dense(h, h), nn.GELU(),
                                 LayerNorm(h, cfg.layer_norm_eps))
        self.bias = nn.Parameter(torch.zeros(cfg.img_dim))


class _RegionClassifier(nn.Module):
    """``region_classifier`` (RegionClassification, model.py:406-416): net
    = Linear, GELU, LayerNorm, Linear."""

    def __init__(self, cfg: EncoderConfig, label_dim: int):
        super().__init__()
        h = cfg.hidden_size
        self.net = nn.Sequential(Dense(h, h), nn.GELU(),
                                 LayerNorm(h, cfg.layer_norm_eps),
                                 Dense(h, label_dim))


def _transform(dense: Dense, ln: LayerNorm, hidden: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return ln(gelu(dense(hidden, dtype)))


def _tied_logits(h: torch.Tensor, weight: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """h [..., H] against a tied [N, H] weight -> float32 [..., N]
    (``jnp.dot(h, w.T.astype(dtype), preferred_element_type=float32)``).
    The cast is made on every call, in the graph where a gradient is
    needed, so it never outlives an optimizer update."""
    shape = h.shape
    out = mm_f32(h.reshape(-1, shape[-1]).to(dtype), weight.to(dtype).t())
    return out.reshape(*shape[:-1], weight.shape[0])


def mrc_loss_from_logits(logits: torch.Tensor, label_targets: torch.Tensor,
                         task: str) -> torch.Tensor:
    """KL (mrc-kl) or hard-label CE over region classes
    (``mrc_loss_from_logits``, bi_encoder.py:238-251). The log of the
    targets is taken of the clamped value, so the branch not taken holds
    no -inf whose gradient would be NaN."""
    t = label_targets.float()
    logp = torch.log_softmax(logits, dim=-1)
    if "kl" in task:
        pos = t > 0
        safe_log = torch.where(pos, torch.log(torch.clamp(t, min=1e-30)),
                               torch.zeros_like(t))
        return torch.where(pos, t * (safe_log - logp), torch.zeros_like(t))
    hard = torch.argmax(t[..., 1:], dim=-1) + 1
    return -logp.gather(-1, hard[..., None])[..., 0]


def _cls_concat_fuse(seq: torch.Tensor, other_cls: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Cross-tower CLS fusion (bi_encoder.py:253-261)."""
    if mode == "add":
        return seq + other_cls
    if mode == "multiply":
        return seq * other_cls
    if mode == "":
        return seq
    raise NotImplementedError(f"cls_concat={mode!r}")


def _gather_positions(seq: torch.Tensor, positions) -> torch.Tensor:
    """[B, S, H], [B, M] -> [B, M, H]: a fixed-size gather."""
    idx = torch.as_tensor(positions, device=seq.device).long()
    return torch.gather(seq, 1, idx[:, :, None].expand(-1, -1,
                                                       seq.shape[-1]))


class BiEncoderForPretraining(nn.Module):
    """MLM + MRFR + MRC(-kl) + ITM on the bi-encoder
    (``BiEncoderForPretraining``, bi_encoder.py:270-422; reference
    bi_encoder.py:293-563).

    State-dict keys as the reference's: ``bert.txt_model.*`` and
    ``bert.img_model.*`` (``self.bert``, bi_encoder.py:299), then
    ``cls.predictions.*``, ``feat_regress.*``, ``region_classifier.*`` and
    ``itm_output.*``. Two weights are tied, each one ``Parameter`` whose
    gradient sums both uses: the MLM decoder is the IMAGE tower's word
    table (bi_encoder.py:319-325) and the feature regression's weight is
    ``img_linear``'s (:358-365). The heads read the image tower's
    config, as JAX's ``cfg``. Built in eval mode.
    """

    def __init__(self, bi_encoder: BiEncoder, *, cls_concat: str = "",
                 img_label_dim: int = 1601):
        super().__init__()
        self.bert = bi_encoder
        self.cls_concat = cls_concat
        self.img_label_dim = img_label_dim
        cfg = bi_encoder.img_cfg
        self.cls = _MlmHead(cfg)
        self.feat_regress = _FeatRegress(cfg)
        self.region_classifier = _RegionClassifier(cfg, img_label_dim)
        self.itm_output = Dense(cfg.hidden_size, 2)
        self.train(False)

    @property
    def cfg(self) -> EncoderConfig:
        return self.bert.img_cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.bert.compute_dtype

    def apply(self, batch: Dict[str, Any], task: str, generators=None):
        """Dispatch on the task (bi_encoder.py:295-311)."""
        if task == "mlm":
            return self.forward_mlm(batch, generators)
        if task == "mrfr":
            return self.forward_mrfr(batch, generators)
        if task == "itm":
            return self.forward_itm(batch, generators)
        if task.startswith("mrc"):
            return self.forward_mrc(batch, task, generators)
        raise ValueError(f"invalid task {task}")

    def _dual_sequences(self, batch, generators):
        txt_seq, img_seq, _ = self.bert.apply(batch, generators,
                                              sequence=True)
        return txt_seq, img_seq

    def mlm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The MLM head (``apply_mlm_head``, bi_encoder.py:206-215): float32
        logits over the vocabulary."""
        p = self.cls.predictions
        h = _transform(p.transform.dense, p.transform.LayerNorm, hidden,
                       self.compute_dtype)
        word = self.bert.img_model.bert.embeddings.word_embeddings.weight
        return _tied_logits(h, word, self.compute_dtype) + p.bias

    def forward_mlm(self, batch, generators=None):
        """MLM with image-CLS fusion (bi_encoder.py:327-345) -> (nll
        [B*M], logits [B, M, V], weights [B*M]). The -1 labels of padded
        slots are clamped to 0 for the gather; their weight is 0."""
        txt_seq, img_seq = self._dual_sequences(batch, generators)
        seq = _cls_concat_fuse(txt_seq, img_seq[:, 0:1, :], self.cls_concat)
        hidden = _gather_positions(seq, batch["masked_positions"])
        logits = self.mlm_logits(hidden)
        labels = torch.as_tensor(batch["masked_labels"],
                                 device=logits.device).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(2, torch.clamp(labels, min=0)[:, :, None])[:, :, 0]
        weights = torch.as_tensor(batch["masked_weights"],
                                  device=logits.device).float()
        return nll.reshape(-1), logits, weights.reshape(-1)

    def forward_mrfr(self, batch, generators=None):
        """Masked region feature regression (bi_encoder.py:347-368) ->
        (squared error [B, M, img_dim], prediction, weights [B, M])."""
        txt_seq, img_seq = self._dual_sequences(batch, generators)
        seq = _cls_concat_fuse(img_seq, txt_seq[:, 0:1, :], self.cls_concat)
        hidden = _gather_positions(seq, batch["img_masked_positions"])
        fr = self.feat_regress
        h = _transform(fr.net[0], fr.net[2], hidden, self.compute_dtype)
        img_linear = self.bert.img_model.bert.img_embeddings.img_linear
        # img_linear's weight is [H, img_dim]: its transpose is the output
        pred = _tied_logits(h, img_linear.weight.t(),
                            self.compute_dtype) + fr.bias
        target = torch.as_tensor(batch["feat_targets"],
                                 device=pred.device).float()
        weights = torch.as_tensor(batch["img_masked_weights"],
                                  device=pred.device).float()
        return torch.square(pred - target), pred, weights

    def forward_mrc(self, batch, task: str, generators=None):
        """Masked region classification (bi_encoder.py:370-389) -> (loss
        [B, M, L] (kl) or [B, M], logits [B, M, L], weights [B, M])."""
        txt_seq, img_seq = self._dual_sequences(batch, generators)
        seq = _cls_concat_fuse(img_seq, txt_seq[:, 0:1, :], self.cls_concat)
        hidden = _gather_positions(seq, batch["img_masked_positions"])
        rc = self.region_classifier
        h = _transform(rc.net[0], rc.net[2], hidden, self.compute_dtype)
        logits = rc.net[3](h, self.compute_dtype).float()
        weights = torch.as_tensor(batch["img_masked_weights"],
                                  device=logits.device).float()
        targets = torch.as_tensor(batch["label_targets"],
                                  device=logits.device)
        return mrc_loss_from_logits(logits, targets, task), logits, weights

    def forward_mrm_nce(self, *args, **kwargs):
        """MRM-NCE is dead in the reference too (bi_encoder.py:389-392)."""
        raise NotImplementedError("nce does not work")

    def forward_itm(self, batch, generators=None, compute_loss=True):
        """Bidirectional in-batch contrastive ITM (bi_encoder.py:401-422).
        The positives are the diagonal of the batch's score matrix
        (``arange``, not the collate's ``pos_ctx_indices``), and the
        padded duplicates are masked as context columns through the
        batch's ``weights``. In a process group the contexts are the
        global batch's rows and the positives their global indices (rank x
        n + arange; the collate's local ``pos_ctx_indices`` would point
        rank 1's rows at rank 0's images): each rank returns its own rows'
        losses against every rank's contexts (bi_encoder.py:394-420)."""
        txt, img, _ = self.bert.apply(batch, generators)
        n = txt.shape[0]
        txt_all, img_all = gather_batch_rows((txt, img), n)
        col_valid = batch.get("weights")
        if col_valid is not None:
            col_valid = gather_rows(torch.as_tensor(
                col_valid, device=txt.device).float())
        pos_idx = process_index() * n + torch.arange(n, device=txt.device)
        loss1, correct1, _ = BiEncoderNllLoss.calc(
            txt, img_all, None, pos_idx, None, 0.0, reduction="none",
            col_valid=col_valid)
        loss2, correct2, _ = BiEncoderNllLoss.calc(
            img, txt_all, None, pos_idx, None, 0.0, reduction="none",
            col_valid=col_valid)
        loss = loss1 * 0.5 + loss2 * 0.5
        if compute_loss:
            return loss, None
        return loss, None, correct1 * 0.5 + correct2 * 0.5


@torch.no_grad()
def init_pretrain_heads_(model: BiEncoderForPretraining,
                         generator: torch.Generator
                         ) -> BiEncoderForPretraining:
    """Random head weights as JAX's ``init_pretrain_heads``
    (bi_encoder.py:174-203): normal(0, initializer_range) kernels, zero
    biases (the MLM and feature-regression output biases too), unit
    LayerNorm scales. ``generator`` lives on the CPU."""
    std = model.cfg.initializer_range
    for head in (model.cls, model.feat_regress, model.region_classifier,
                 model.itm_output):
        for module in head.modules():
            if isinstance(module, Dense):
                module.weight.copy_(torch.randn(module.weight.shape,
                                                generator=generator) * std)
                module.bias.zero_()
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    model.cls.predictions.bias.zero_()
    model.feat_regress.bias.zero_()
    return model
