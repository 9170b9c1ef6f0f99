"""Corpus encoding over host batches (counterpart of
lightningdot_tpu/training/evaluator.py:32-72, ``BatchEncoder``).

The evaluation loop around it (``eval_model_on_dataloader``, the indexes
and recall) is a later slice of the port (ROADMAP.md, queue A item 6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models.bi_encoder import BiEncoder


class BatchEncoder:
    """Encode the numpy batches of
    :func:`lightningdot_tpu_torch.data.itm.itm_fast_collate` with both
    towers: the model moves to ``device`` (``None``: the card, raising
    where there is none; ``"cpu"`` runs the plain PyTorch path), each
    sub-batch follows it through :meth:`BiEncoder.apply`, and the vectors
    come back as float32, still on the device.

    Token ids are checked against each tower's vocabulary on the host: the
    JAX package's ``jnp.take`` would return NaN rows for an id past the
    table, torch would fail on the device.
    """

    def __init__(self, model: BiEncoder, *,
                 device: Optional[torch.device] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    def _sub_batch(self, sb: Optional[Dict[str, Any]], vocab: int):
        if sb is None:
            return None
        ids = np.asarray(sb["input_ids"])
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError(f"token ids outside the vocabulary [0, {vocab})")
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in sb.items() if v is not None}

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, Any]):
        """-> (txt, img, cap) pooled vectors, None where the batch has no
        such sub-batch."""
        model = self.model
        img_cfg = model.img_cfg or model.txt_cfg   # encode_img raises if None
        out = model.apply({
            "txts": self._sub_batch(batch.get("txts"),
                                    model.txt_cfg.vocab_size),
            "imgs": self._sub_batch(batch.get("imgs"), img_cfg.vocab_size),
            "caps": self._sub_batch(batch.get("caps"),
                                    model.txt_cfg.vocab_size)})
        return tuple(v.float() if v is not None else None for v in out)
