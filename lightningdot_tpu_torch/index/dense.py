"""Exact inner-product top-k on the card (the port's ``DenseFlatIndex``,
lightningdot_tpu/index/dense.py:78-210; reference FAISS ``IndexFlatIP``,
dvl/indexer/faiss_indexers.py:63-87).

The whole corpus lives on the device as a float32 [N_pad, D] matrix whose
padding rows carry a -1e30 score bias. A block of queries is one float32
product against it (TF32 off: JAX's ``Precision.HIGHEST``, dense.py:40,58)
followed by ``torch.topk``. Where the [Q, N] score matrix would pass
``SCORE_BUDGET``, the corpus is scored chunk by chunk with a running
top-k merge (dense.py:44-75), so the full matrix is never allocated. The
scoring is a plain product and top-k: the JAX package computes it outside
any Pallas kernel too.

:class:`DenseShardedIndex` shards the corpus over a
:class:`~lightningdot_tpu_torch.parallel.mesh.DeviceMesh` (dense.py:
213-300): each shard scores its rows on its device and keeps its top k,
and the candidates are gathered to the first device for the global top k.

Serialization keeps the reference's two-file layout
(faiss_indexers.py:35-57): ``<file>.index.npy`` (the float32 vectors) and
``<file>.index_meta.dpr`` (the pickled index -> db-id list), so either
package reads the other's files.
"""
from __future__ import annotations

import pickle
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.ops.matmul import full_f32

NEG_INF = -1e30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _topk_scores(queries: torch.Tensor, corpus: torch.Tensor,
                 pad_bias: torch.Tensor, k: int):
    """[Q, D] x [N, D] -> (scores [Q, k], idx [Q, k]); padding rows are
    biased to -1e30 (dense.py:36-41)."""
    with full_f32():
        scores = queries @ corpus.t()
    return torch.topk(scores + pad_bias[None, :], k, dim=1)


def _topk_scores_chunked(queries: torch.Tensor, corpus: torch.Tensor,
                         pad_bias: torch.Tensor, k: int, chunk: int):
    """Streaming top-k (dense.py:44-75): each corpus chunk is scored and
    its top k merged into a running top k, so the [Q, N] score matrix is
    never allocated."""
    q_n = queries.shape[0]
    best_s = torch.full((q_n, k), NEG_INF, dtype=torch.float32,
                        device=queries.device)
    best_i = torch.zeros((q_n, k), dtype=torch.int64, device=queries.device)
    for start in range(0, corpus.shape[0], chunk):
        s, i = _topk_scores(queries, corpus[start:start + chunk],
                            pad_bias[start:start + chunk], k)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, i + start], dim=1)
        best_s, sel = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, sel)
    return best_s, best_i


def merge_shard_topk(parts, k: int, device: torch.device):
    """The top k over every shard's candidates, on ``device``: ``parts``
    holds each shard's (scores [Q, k_i], global ids [Q, k_i])."""
    scores = torch.cat([s.to(device) for s, _ in parts], dim=1)
    ids = torch.cat([i.to(device) for _, i in parts], dim=1)
    best, sel = torch.topk(scores, k, dim=1)
    return best, torch.gather(ids, 1, sel)


class DenseFlatIndex:
    """Exact inner-product index on one device.

    ``device=None`` is the card, and raises where there is none; ``"cpu"``
    runs on the CPU. API parity: DenseFlatIndexer (faiss_indexers.py:63-87).
    """

    # cap on the transient [Q, N] score matrix before switching to the
    # streaming chunked top-k (elements; 256M float32 = 1 GB)
    SCORE_BUDGET = 256 * 1024 * 1024
    CORPUS_CHUNK = 16384

    def __init__(self, vector_sz: int, buffer_size: int = 50000,
                 device: Optional[Union[str, torch.device]] = None):
        self.vector_sz = vector_sz
        self.buffer_size = buffer_size
        self.device = resolve_device(device)
        self.index_id_to_db_id: List[Any] = []
        self._chunks: List[np.ndarray] = []
        self._corpus: Optional[torch.Tensor] = None   # built lazily
        self._pad_bias: Optional[torch.Tensor] = None
        self._n_real = 0
        self._n_pad = 0

    # -- building ------------------------------------------------------------
    def index_data(self, data: Sequence[Tuple[Any, np.ndarray]]) -> None:
        """Add [(db_id, vector)] (faiss_indexers.py:69-80)."""
        if not len(data):
            return
        ids = [t[0] for t in data]
        vecs = np.ascontiguousarray(
            np.stack([np.asarray(t[1], np.float32).reshape(-1)
                      for t in data]))
        if vecs.shape[1] != self.vector_sz:
            raise ValueError(
                f"vector size {vecs.shape[1]} != index size {self.vector_sz}")
        self.index_id_to_db_id.extend(ids)
        self._chunks.append(vecs)
        self._corpus = None

    @property
    def ntotal(self) -> int:
        return len(self.index_id_to_db_id)

    def _padded_matrix(self, multiple: int) -> Tuple[np.ndarray, np.ndarray]:
        """The vectors padded with zero rows to a multiple of ``multiple``,
        and the [N_pad] score bias (-1e30 on the padding rows)."""
        if not self._chunks:
            raise ValueError("index is empty")
        mat = np.concatenate(self._chunks, axis=0)
        self._chunks = [mat]
        self._n_real = mat.shape[0]
        self._n_pad = _round_up(self._n_real, multiple)
        padded = np.zeros((self._n_pad, self.vector_sz), np.float32)
        padded[:self._n_real] = mat
        bias = np.zeros((self._n_pad,), np.float32)
        bias[self._n_real:] = NEG_INF
        return padded, bias

    def _build(self) -> None:
        if self._corpus is None:
            n = sum(c.shape[0] for c in self._chunks)
            # align to the streaming chunk whenever an 8192-query block
            # over this corpus would pass SCORE_BUDGET, so the chunked
            # top-k applies when it is needed (dense.py:132-148)
            mat, bias = self._padded_matrix(
                self.CORPUS_CHUNK if n * 8192 > self.SCORE_BUDGET else 128)
            self._corpus = torch.from_numpy(mat).to(self.device)
            self._pad_bias = torch.from_numpy(bias).to(self.device)

    # -- searching -----------------------------------------------------------
    def _search_block(self, qb: torch.Tensor, k: int):
        n = self._corpus.shape[0]
        if (qb.shape[0] * n > self.SCORE_BUDGET
                and n % self.CORPUS_CHUNK == 0 and k <= self.CORPUS_CHUNK):
            return _topk_scores_chunked(qb, self._corpus, self._pad_bias, k,
                                        self.CORPUS_CHUNK)
        return _topk_scores(qb, self._corpus, self._pad_bias, k)

    @torch.inference_mode()
    def search_knn(self, query_vectors: np.ndarray, top_docs: int,
                   block: int = 8192
                   ) -> List[Tuple[List[Any], np.ndarray]]:
        """[(db_ids, scores)] per query (faiss_indexers.py:82-87)."""
        self._build()
        k = min(top_docs, self._n_real)
        q = np.asarray(query_vectors, np.float32)
        if q.ndim == 1:
            q = q[None]
        n = self._n_pad
        if k > self.CORPUS_CHUNK or n % self.CORPUS_CHUNK != 0:
            # the chunked top-k cannot apply: keep the transient [Q, N]
            # score matrix under SCORE_BUDGET by shrinking the query block
            block = min(block, max(128, self.SCORE_BUDGET // n // 128 * 128))
        results = []
        for start in range(0, q.shape[0], block):
            qb = torch.from_numpy(np.ascontiguousarray(
                q[start:start + block])).to(self.device)
            scores, idx = self._search_block(qb, k)
            for row_idx, row_sc in zip(idx.cpu().numpy(),
                                       scores.cpu().numpy()):
                results.append(
                    ([self.index_id_to_db_id[i] for i in row_idx], row_sc))
        return results

    # -- persistence (faiss_indexers.py:35-57 layout) ------------------------
    def serialize(self, file: str) -> None:
        mat = np.concatenate(self._chunks, axis=0)
        np.save(file + ".index.npy", mat)
        with open(file + ".index_meta.dpr", "wb") as f:
            pickle.dump(self.index_id_to_db_id, f)

    def deserialize_from(self, file: str) -> None:
        """Load a pair of files written by either package's ``serialize``.
        The meta file is a pickle: load only files you trust."""
        mat = np.load(file + ".index.npy")
        with open(file + ".index_meta.dpr", "rb") as f:
            self.index_id_to_db_id = pickle.load(f)
        if mat.shape[0] != len(self.index_id_to_db_id):
            raise ValueError(f"{file}: {mat.shape[0]} vectors for "
                             f"{len(self.index_id_to_db_id)} ids")
        self._chunks = [np.asarray(mat, np.float32)]
        self._corpus = None


# Alias matching the reference class name (drop-in for imports).
DenseFlatIndexer = DenseFlatIndex


class DenseShardedIndex(DenseFlatIndex):
    """The corpus sharded over a :class:`~lightningdot_tpu_torch.parallel.
    mesh.DeviceMesh` (``DenseShardedIndex``, dense.py:213-300): shard i,
    rows [i x N_pad / n, (i + 1) x N_pad / n), lives on the mesh's i-th
    device; a query block is scored on every shard, each keeps its top
    min(k, shard rows) (streaming above ``SCORE_BUDGET``, as the flat
    index), its ids offset by the shard's first row, and the candidates
    are gathered to the first device for the global top k."""

    def __init__(self, vector_sz: int, mesh, buffer_size: int = 50000):
        super().__init__(vector_sz, buffer_size, device=mesh.devices[0])
        self.mesh = mesh

    def _build(self) -> None:
        if self._corpus is None:
            n = sum(c.shape[0] for c in self._chunks)
            n_dev = self.mesh.size
            # the flat index's alignment rule, per shard
            multiple = (self.CORPUS_CHUNK
                        if n * 8192 > self.SCORE_BUDGET * n_dev
                        else 128) * n_dev
            mat, bias = self._padded_matrix(multiple)
            per = self._n_pad // n_dev
            self._corpus = [
                (torch.from_numpy(mat[i * per:(i + 1) * per]).to(dev),
                 torch.from_numpy(bias[i * per:(i + 1) * per]).to(dev))
                for i, dev in enumerate(self.mesh)]

    def _search_block(self, qb: torch.Tensor, k: int):
        parts = []
        for i, (shard, bias) in enumerate(self._corpus):
            rows = shard.shape[0]
            # a shard can be narrower than k (mining asks for pools up to
            # 1000 on thin shards): the shards' candidates together still
            # hold the global top k (dense.py:251-258)
            k_local = min(k, rows)
            q = qb.to(shard.device, non_blocking=True)
            if (q.shape[0] * rows > self.SCORE_BUDGET
                    and rows % self.CORPUS_CHUNK == 0
                    and k_local <= self.CORPUS_CHUNK):
                s, idx = _topk_scores_chunked(q, shard, bias, k_local,
                                              self.CORPUS_CHUNK)
            else:
                s, idx = _topk_scores(q, shard, bias, k_local)
            parts.append((s, idx + i * rows))
        return merge_shard_topk(parts, k, self.device)
