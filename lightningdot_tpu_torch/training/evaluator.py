"""Corpus encoding and retrieval evaluation (counterpart of
lightningdot_tpu/training/evaluator.py:32-196).

:class:`BatchEncoder` stages host batches and encodes them with both
towers; :func:`encoded_batches` runs a loader through it.
:func:`eval_model_on_dataloader` (dvl/trainer.py:113-190) encodes every
batch, builds an image and a text index, searches both directions and
reports recall@{1,5,10}; :func:`get_indexer` (trainer.py:93-110) encodes
one side into an index. Batches are staged to the card one ahead through
pinned buffers (:class:`~lightningdot_tpu_torch.data.loader.
DevicePrefetcher`), vectors and losses stay on the device until one pull
at the end, and the flat index scores on the same device. The corpus
encoder (``serving.get_model_encoded_vecs``) stages its batches the same
way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from lightningdot_tpu_torch.data.loader import (DevicePrefetcher,
                                                PinnedStager, StagedBatch,
                                                await_staged)
from lightningdot_tpu_torch.data.padding import Recycler
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.index import DenseFlatIndex, DenseShardedIndex
from lightningdot_tpu_torch.models.bi_encoder import (BiEncoder,
                                                      BiEncoderNllLoss)
from lightningdot_tpu_torch.utils import metrics as M

_SUB_BATCHES = ("txts", "imgs", "caps")


class BatchEncoder:
    """Encode the batches of
    :func:`lightningdot_tpu_torch.data.itm.itm_fast_collate` with both
    towers: the model moves to ``device`` (``None``: the card, raising
    where there is none; ``"cpu"`` runs the plain PyTorch path), and the
    vectors come back as float32, still on the device.

    Every batch goes one way: :meth:`put` checks its token ids on the host
    and stages it to the device, and calling the encoder on the staged
    batch runs :meth:`BiEncoder.apply`. The ids are checked before any
    copy: the JAX package's ``jnp.take`` would return NaN rows for an id
    past the table, torch would fail on the device.
    """

    def __init__(self, model: BiEncoder, *,
                 device: Optional[torch.device] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # made before any loader starts, so that the pooled feature
        # buffers are page-locked from the first batch on (on the card)
        self._stager = PinnedStager(self.device)

    def _vocab(self, key: str) -> int:
        cfg = (self.model.img_cfg or self.model.txt_cfg if key == "imgs"
               else self.model.txt_cfg)   # encode_img raises if no tower
        return cfg.vocab_size

    def put(self, batch: Dict[str, Any]) -> StagedBatch:
        """Check a host batch's ids and stage its arrays to the device
        (the ``put`` of a :class:`DevicePrefetcher`)."""
        for key in _SUB_BATCHES:
            sb = batch.get(key)
            if sb is None:
                continue
            ids = np.asarray(sb["input_ids"])
            vocab = self._vocab(key)
            if ids.size and (ids.min() < 0 or ids.max() >= vocab):
                raise ValueError(
                    f"token ids outside the vocabulary [0, {vocab})")
        return self._stager(batch)

    @torch.inference_mode()
    def __call__(self, staged: StagedBatch):
        """A batch from :meth:`put` -> (txt, img, cap) pooled vectors, None
        where the batch has no such sub-batch. The current stream waits
        for the batch's copies first."""
        await_staged(staged)
        out = self.model.apply({k: staged.get(k) for k in _SUB_BATCHES})
        return tuple(v.float() if v is not None else None for v in out)


@dataclasses.dataclass
class EvalResult:
    loss: float
    correct_ratio: float
    indexers: Tuple[Any, Any]                      # (img, txt)
    recall: Tuple[Optional[dict], Optional[dict]]  # (txt->img, img->txt)
    rank_results: Tuple[Optional[dict], Optional[dict]]
    embeddings: Dict[str, Dict[str, np.ndarray]]


def build_index(vector_size: int, *, mesh=None, hnsw: bool = False,
                device: Optional[Union[str, torch.device]] = None):
    """Index factory (evaluator.py:84-92; trainer.py:97-100,122-127: the
    ``--hnsw_index`` switch): the native HNSW on the host, the exact index
    sharded over ``mesh`` (a ``DeviceMesh``), or the exact flat index on
    ``device``."""
    if hnsw:
        from lightningdot_tpu_torch.index.hnsw import DenseHNSWFlatIndexer

        return DenseHNSWFlatIndexer(vector_size)
    if mesh is not None:
        return DenseShardedIndex(vector_size, mesh)
    return DenseFlatIndex(vector_size, device=device)


def encoded_batches(encoder: BatchEncoder, dataloader):
    """(batch, txt, img, cap) per batch of ``dataloader``, each staged one
    ahead through :meth:`BatchEncoder.put`. On the card a spent batch's
    host arrays go back to the buffer pool once the event of its copies
    has passed: the pooled feature buffers are page-locked and the copies
    read them directly (:func:`~lightningdot_tpu_torch.data.padding.
    pin_pool`)."""
    recycler = Recycler(enabled=encoder.device.type == "cuda")
    try:
        for batch in DevicePrefetcher(dataloader, put=encoder.put):
            txt, img, cap = encoder(batch)
            yield batch, txt, img, cap
            recycler.push(batch.host, ready=batch.event)
    finally:
        recycler.flush()


def eval_model_on_dataloader(model: BiEncoder, dataloader, *,
                             img2txt: Optional[dict] = None,
                             num_tops: int = 100, no_eval: bool = False,
                             vector_size: int = 768,
                             caption_score_weight: float = 0.0,
                             mesh=None, hnsw: bool = False,
                             device: Optional[torch.device] = None
                             ) -> EvalResult:
    """trainer.py:113-190 semantics (evaluator.py:95-176). The model's
    weights are its own (the JAX function takes them as ``params``); it
    runs on ``device`` (:class:`BatchEncoder`), where the flat indexes live
    too; with a ``mesh`` the indexes shard over its devices."""
    if not no_eval and img2txt is None:
        raise ValueError("img2txt is required unless no_eval=True (the "
                         "img->txt recall needs the ground-truth mapping)")
    encoder = BatchEncoder(model, device=device)
    batches, total_samples = 0, 0
    loss_chunks: List[torch.Tensor] = []     # device scalars, pulled once
    correct_chunks: List[torch.Tensor] = []
    txt_vec_chunks: List[torch.Tensor] = []
    img_vec_chunks: List[torch.Tensor] = []
    txt_ids: List[Any] = []
    img_fnames: List[Any] = []

    for batch, txt, img, cap in encoded_batches(encoder, dataloader):
        n_valid = batch["n_valid"]
        # in-batch diagnostic loss over the REAL rows only (padded rows are
        # duplicates and would bias the metric)
        loss, correct, _ = BiEncoderNllLoss.calc(
            txt[:n_valid], img[:n_valid],
            cap[:n_valid] if cap is not None else None,
            torch.arange(n_valid, device=txt.device), None,
            caption_score_weight)
        loss_chunks.append(loss)
        correct_chunks.append(correct)
        batches += 1
        total_samples += n_valid

        txt_vec_chunks.append(txt[:n_valid])
        img_vec_chunks.append(img[:n_valid])
        txt_ids.extend(batch["txt_index"][:n_valid])
        img_fnames.extend(batch["img_fname"][:n_valid])

    # one device->host pull for the whole corpus (and the metrics)
    txt_np = torch.cat(txt_vec_chunks).cpu().numpy()
    img_np = torch.cat(img_vec_chunks).cpu().numpy()
    total_loss = float(torch.stack(loss_chunks).sum())
    total_correct = int(torch.stack(correct_chunks).sum())

    # dict semantics of the reference: later duplicates overwrite
    # (trainer.py:151-152), and queries keep insertion order
    txt_embedding = {i: v for i, v in zip(txt_ids, txt_np)}
    img_embedding = {f: v for f, v in zip(img_fnames, img_np)}

    indexer_img = build_index(vector_size, mesh=mesh, hnsw=hnsw,
                              device=encoder.device)
    indexer_img.index_data(list(img_embedding.items()))
    indexer_txt = build_index(vector_size, mesh=mesh, hnsw=hnsw,
                              device=encoder.device)
    indexer_txt.index_data(list(txt_embedding.items()))

    avg_loss = total_loss / max(batches, 1)
    correct_ratio = total_correct / max(float(total_samples), 1.0)

    if no_eval:
        return EvalResult(avg_loss, correct_ratio,
                          (indexer_img, indexer_txt), (None, None),
                          (None, None),
                          {"txt": txt_embedding, "img": img_embedding})

    # text -> image retrieval (trainer.py:167-168)
    query_txt = np.stack([txt_embedding[i] for i in txt_ids])
    res_txt = indexer_img.search_knn(query_txt, num_tops)
    rank_txt_res = {q: r[0] for q, r in zip(txt_ids, res_txt)}

    # image -> text retrieval (trainer.py:170-171)
    query_img = np.stack([img_embedding[f] for f in img_fnames])
    res_img = indexer_txt.search_knn(query_img, num_tops)
    rank_img_res = {q: r[0] for q, r in zip(img_fnames, res_img)}

    gt_img_of_txt = {t: f for t, f in zip(txt_ids, img_fnames)}
    recall_txt = M.recall_from_ranked_ids(txt_ids, rank_txt_res, gt_img_of_txt)
    recall_img = M.recall_any_from_ranked_ids(img_fnames, rank_img_res,
                                              img2txt)

    return EvalResult(avg_loss, correct_ratio, (indexer_img, indexer_txt),
                      (recall_txt, recall_img), (rank_txt_res, rank_img_res),
                      {"txt": txt_embedding, "img": img_embedding})


def get_indexer(model: BiEncoder, dataloader, *, vector_size: int = 768,
                img_retrieval: bool = True, mesh=None, hnsw: bool = False,
                device: Optional[torch.device] = None):
    """trainer.py:93-110 (evaluator.py:179-196): encode one side and build
    its index (sharded over ``mesh`` where one is given)."""
    encoder = BatchEncoder(model, device=device)
    embedding = {}
    for batch, txt, img, _ in encoded_batches(encoder, dataloader):
        n_valid = batch["n_valid"]
        if img_retrieval:
            vecs = img[:n_valid].cpu().numpy()
            keys = batch["img_fname"][:n_valid]
        else:
            vecs = txt[:n_valid].cpu().numpy()
            keys = batch["txt_index"][:n_valid]
        embedding.update({k: v for k, v in zip(keys, vecs)})
    index = build_index(vector_size, mesh=mesh, hnsw=hnsw,
                        device=encoder.device)
    index.index_data(list(embedding.items()))
    return index
