"""The one-tower UNITER pre-training model, pre-training's KD teacher
(counterpart of lightningdot_tpu/models/uniter_pretrain.py; reference
UniterForPretraining, uniter_model/model/model.py:419-701).

Text and regions are encoded jointly (``encode_joint``, with the
``gather_index`` compaction of the teacher sub-batch) under MLM, MRFR,
MRC(-kl) and ITM heads. The MLM decoder is UNITER's own word table
(model.py:425-426) and the feature regression's weight its ``img_linear``
(model.py:427-429). Parameters carry the reference's names (``bert.*``,
``cls.predictions.*``, ``feat_regress.*``, ``region_classifier.*``,
``itm_output.*``). Built in eval mode: as a teacher it runs without
dropout or gradient (``task_logits``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.models.bi_encoder import (_FeatRegress, _MlmHead,
                                                      _RegionClassifier,
                                                      _gather_positions,
                                                      _tied_logits, _transform,
                                                      mrc_loss_from_logits)
from lightningdot_tpu_torch.models.cross_encoder import uniter_model
from lightningdot_tpu_torch.models.encoder import Dense, encode_joint


class UniterForPretraining(nn.Module):
    """``UniterForPretraining`` (uniter_pretrain.py:28-114)."""

    def __init__(self, cfg: EncoderConfig, img_label_dim: int = 1601,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.img_label_dim = img_label_dim
        self.compute_dtype = compute_dtype
        self.bert = uniter_model(cfg)
        self.cls = _MlmHead(cfg)
        self.feat_regress = _FeatRegress(cfg)
        self.region_classifier = _RegionClassifier(cfg, img_label_dim)
        self.itm_output = Dense(cfg.hidden_size, 2)
        self.train(False)

    def encode(self, batch: Dict[str, Any], generator=None) -> torch.Tensor:
        return encode_joint(
            self.bert, batch["input_ids"], batch["position_ids"],
            batch["img_feat"], batch["img_pos_feat"], batch["attn_masks"],
            gather_index=batch.get("gather_index"),
            img_masks=batch.get("img_masks"), dtype=self.compute_dtype,
            generator=generator)

    def forward_mlm(self, batch, generator=None):
        """model.py:508-527 on the fixed masked positions -> (nll [B*M],
        logits [B, M, V], weights [B*M])."""
        hidden = _gather_positions(self.encode(batch, generator),
                                   batch["masked_positions"])
        p = self.cls.predictions
        h = _transform(p.transform.dense, p.transform.LayerNorm, hidden,
                       self.compute_dtype)
        logits = _tied_logits(h, self.bert.embeddings.word_embeddings.weight,
                              self.compute_dtype) + p.bias
        labels = torch.as_tensor(batch["masked_labels"],
                                 device=logits.device).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(2, torch.clamp(labels, min=0)[:, :, None])[:, :, 0]
        weights = torch.as_tensor(batch["masked_weights"],
                                  device=logits.device).float()
        return nll.reshape(-1), logits, weights.reshape(-1)

    def forward_mrfr(self, batch, generator=None):
        """model.py:562-579; the positions index the joint sequence."""
        hidden = _gather_positions(self.encode(batch, generator),
                                   batch["img_masked_positions"])
        fr = self.feat_regress
        h = _transform(fr.net[0], fr.net[2], hidden, self.compute_dtype)
        img_linear = self.bert.img_embeddings.img_linear
        pred = _tied_logits(h, img_linear.weight.t(),
                            self.compute_dtype) + fr.bias
        target = torch.as_tensor(batch["feat_targets"],
                                 device=pred.device).float()
        weights = torch.as_tensor(batch["img_masked_weights"],
                                  device=pred.device).float()
        return torch.square(pred - target), pred, weights

    def forward_mrc(self, batch, task: str, generator=None):
        """model.py:675-701."""
        hidden = _gather_positions(self.encode(batch, generator),
                                   batch["img_masked_positions"])
        rc = self.region_classifier
        h = _transform(rc.net[0], rc.net[2], hidden, self.compute_dtype)
        logits = rc.net[3](h, self.compute_dtype).float()
        weights = torch.as_tensor(batch["img_masked_weights"],
                                  device=logits.device).float()
        targets = torch.as_tensor(batch["label_targets"],
                                  device=logits.device)
        return mrc_loss_from_logits(logits, targets, task), logits, weights

    def forward_itm(self, batch, generator=None):
        """model.py:627-672: the 2-way head over the tanh pooler."""
        pooled = self.bert.pooler(self.encode(batch, generator),
                                  self.compute_dtype)
        logits = self.itm_output(pooled, self.compute_dtype).float()
        targets = torch.as_tensor(batch["targets"],
                                  device=logits.device).long()
        logp = torch.log_softmax(logits, dim=-1)
        return (-logp.gather(1, targets[:, None])[:, 0], logits,
                batch.get("weights"))

    def task_logits(self, batch: Dict[str, Any], task: str) -> torch.Tensor:
        """The teacher's predictions for KD (pretrain.py:409-428)."""
        if task == "mlm":
            return self.forward_mlm(batch)[1]
        if task == "mrfr":
            return self.forward_mrfr(batch)[1]
        if task.startswith("mrc"):
            return self.forward_mrc(batch, task)[1]
        if task == "itm":
            return self.forward_itm(batch)[1]
        raise ValueError(task)

