"""Interactive text->image query serving (counterpart of
lightningdot_tpu/serving.py:23-31,142-441).

Encode a corpus once, then serve text queries: tokenize -> one text-tower
forward -> scores against the corpus held on the device -> top-k
(reference retrieve_query, dvl/utils.py:204-211). The duck-typed frontends
of the JAX package (``serving_native.serve_retriever``,
``serving_frontend.BatchingFrontend``, ``serving_http``) serve this
:class:`Retriever` as they are.

This slice serves the bfloat16 (or float32) tower, a bfloat16 corpus and
exact top-k. The int8 corpus, the int8 tower and approximate top-k are the
next slice (ROADMAP.md, queue A item 3b).
"""
from __future__ import annotations

import pickle
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lightningdot_tpu.data.padding import bucket_len
from lightningdot_tpu_torch.models.bi_encoder import (BiEncoder,
                                                      dot_product_scores)

QUERY_LEN_BUCKETS = (16, 32, 64)
# batch sizes are padded up this ladder, as in the JAX package, so a server
# that coalesces arbitrary batch sizes runs a bounded set of shapes
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_NEXT_SLICE = ("ROADMAP.md queue A item 3b (int8 serving options and "
               "approximate top-k)")


class Retriever:
    """Serve text->image retrieval against a pre-encoded corpus.

    ``model`` holds the weights; the Retriever moves it to ``device``
    (default: where its parameters are) and runs it in its
    ``compute_dtype``.
    """

    def __init__(self, model: BiEncoder, tokenizer, *,
                 device: Optional[torch.device] = None,
                 query_buckets: Sequence[int] = QUERY_LEN_BUCKETS,
                 quantization: Optional[str] = None,
                 weight_quantization: Optional[str] = None,
                 topk: str = "exact",
                 batch_buckets: Sequence[int] = BATCH_BUCKETS):
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantization!r}")
        if weight_quantization not in (None, "int8"):
            raise ValueError(
                f"unknown weight_quantization {weight_quantization!r}")
        if topk not in ("exact", "approx"):
            raise ValueError(f"unknown topk {topk!r}")
        for name, value in (("quantization", quantization),
                            ("weight_quantization", weight_quantization)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet: {_NEXT_SLICE}")
        if topk != "exact":
            raise NotImplementedError(
                f"topk={topk!r} is not ported yet: {_NEXT_SLICE}")
        if device is None:
            device = next(model.parameters()).device
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.query_buckets = tuple(query_buckets)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.quantization = quantization
        self.topk = topk
        self._corpus: Optional[torch.Tensor] = None   # [N_pad, D] bfloat16
        self._bias: Optional[torch.Tensor] = None     # [N_pad] float32
        self._ids: List[Any] = []

    # -- corpus --------------------------------------------------------------
    def set_corpus(self, ids: Sequence[Any], vectors: np.ndarray) -> None:
        """Hold ``vectors`` [N, D] on the device as bfloat16, rows padded to
        a multiple of 128; padding rows carry a -1e30 score bias."""
        n = vectors.shape[0]
        n_pad = -(-n // 128) * 128
        mat = np.zeros((n_pad, vectors.shape[1]), np.float32)
        mat[:n] = vectors
        bias = np.zeros((n_pad,), np.float32)
        bias[n:] = -1e30
        self._place(mat, bias)
        self._ids = list(ids)

    def _place(self, mat: np.ndarray, bias: np.ndarray) -> None:
        # round to bfloat16 on the device: one upload of float32, no
        # float32 copy kept
        self._corpus = torch.from_numpy(mat).to(self.device).to(
            torch.bfloat16)
        self._bias = torch.from_numpy(bias).to(self.device)

    def save_corpus(self, path: str) -> None:
        """``path.corpus.npz`` (vecs as float32, bias) + ``path.ids.pkl``:
        the JAX package's format, so either package loads the other's."""
        np.savez(path + ".corpus.npz",
                 vecs=self._corpus.float().cpu().numpy(),
                 bias=self._bias.cpu().numpy())
        with open(path + ".ids.pkl", "wb") as f:
            pickle.dump((self._ids, self.quantization), f)

    def load_corpus(self, path: str) -> None:
        """Load a corpus written by either package's ``save_corpus``. The
        ids file is a pickle: load only files you trust."""
        data = np.load(path + ".corpus.npz")
        with open(path + ".ids.pkl", "rb") as f:
            ids, quant = pickle.load(f)
        if quant != self.quantization:
            raise ValueError(
                f"corpus saved with quantization={quant!r}, retriever has "
                f"{self.quantization!r}")
        self._place(np.asarray(data["vecs"], np.float32),
                    np.asarray(data["bias"], np.float32))
        self._ids = list(ids)

    @property
    def corpus_size(self) -> int:
        """Number of indexed corpus entries (excludes padding rows)."""
        return len(self._ids)

    @property
    def ids(self) -> List[Any]:
        """Corpus db_ids, in index order (pairs with retrieve_batch_arrays)."""
        return self._ids

    # -- query ---------------------------------------------------------------
    def _batch_bucket(self, n: int) -> int:
        """Bucketed batch size. Above the top bucket, round up to a
        multiple of it: never truncate a query batch."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        top_b = self.batch_buckets[-1]
        return -(-n // top_b) * top_b

    def _pad_token(self, token_lists) -> int:
        """Token of the padding rows: the tokenizer's [CLS] where it has
        one, else the first real query's first token (always a valid id)."""
        cls = getattr(self.tokenizer, "cls_token_id", None)
        return int(cls) if cls is not None else int(token_lists[0][0])

    def _token_batch(self, queries: Sequence[str]):
        token_lists = [self.tokenizer.encode(q) for q in queries]
        length = bucket_len(max(len(t) for t in token_lists),
                            self.query_buckets)
        n = len(queries)
        nb = self._batch_bucket(n)
        ids = np.zeros((nb, length), np.int64)
        mask = np.zeros((nb, length), np.int64)
        for i, t in enumerate(token_lists):
            t = t[:length]
            ids[i, :len(t)] = t
            mask[i, :len(t)] = 1
        # padding rows: one live token each (an all-masked row would
        # softmax over nothing); their results are sliced away
        ids[n:, 0] = self._pad_token(token_lists)
        mask[n:, 0] = 1
        vocab = self.model.txt_cfg.vocab_size
        if ids.min() < 0 or ids.max() >= vocab:
            raise ValueError(f"token ids outside the vocabulary [0, {vocab})")
        return ids, mask

    @torch.inference_mode()
    def _encode(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        ids_t = torch.from_numpy(ids).to(self.device)
        pos = torch.arange(ids.shape[1], device=self.device).expand(
            ids.shape)
        return self.model.encode_txt({
            "input_ids": ids_t,
            "attention_mask": torch.from_numpy(mask).to(self.device),
            "position_ids": pos})

    def encode_queries(self, queries: Sequence[str]) -> np.ndarray:
        """Query embeddings [n, D] as float32 (in the compute dtype's
        precision), through the same padding as the query path."""
        ids, mask = self._token_batch(queries)
        return self._encode(ids, mask)[:len(queries)].float().cpu().numpy()

    @torch.inference_mode()
    def _search(self, vec: torch.Tensor, k: int):
        scores = dot_product_scores(vec.to(self._corpus.dtype), self._corpus)
        return torch.topk(scores + self._bias, k, dim=1)

    def warmup(self, tops: Sequence[int] = (100,),
               batches: Sequence[int] = (1,)) -> None:
        """Run every (batch bucket, length bucket, k) once, so that real
        queries find the kernels built, the weights cast and the library
        handles made (the same duty as the JAX package's precompiles;
        ``serve_retriever`` warms every batch bucket it can emit)."""
        for length in self.query_buckets:
            for nb in sorted({self._batch_bucket(b) for b in batches}):
                ids = np.zeros((nb, length), np.int64)
                mask = np.ones((nb, length), np.int64)
                vec = self._encode(ids, mask)
                for top in tops:
                    self._search(vec, min(top, len(self._ids)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def retrieve_batch_arrays(self, queries: Sequence[str], top: int = 100
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Array-level batched query path: ``(idx int32 [n,k], scores f32
        [n,k])`` ranked, with ``idx`` indexing :attr:`ids`. The hot serving
        interface: no per-result Python work."""
        ids, mask = self._token_batch(queries)
        k = min(top, len(self._ids))
        scores, idx = self._search(self._encode(ids, mask), k)
        n = len(queries)
        return (idx[:n].to(torch.int32).cpu().numpy(),
                scores[:n].cpu().numpy())

    def retrieve_batch(self, queries: Sequence[str], top: int = 100
                       ) -> List[List[Tuple[Any, float]]]:
        """Batched query path -> [[(db_id, score), ...] ranked] per query."""
        idx, scores = self.retrieve_batch_arrays(queries, top=top)
        return [[(self._ids[i], float(s)) for i, s in zip(row_i, row_s)]
                for row_i, row_s in zip(idx, scores)]

    def retrieve_query(self, query: str, top: int = 100
                       ) -> List[Tuple[Any, float]]:
        """dvl/utils.py:204-211 semantics -> [(db_id, score)] ranked."""
        return self.retrieve_batch([query], top=top)[0]


def ranking_equivalent(got, want, *, atol: float) -> Tuple[bool, str]:
    """Whether two ``[(id, score), ...]`` rankings agree up to score ties
    (counterpart of lightningdot_tpu/serving.py:391-441).

    The same query scored in another batch composition or on another
    device sums in another order, so items whose scores differ by less
    than that jitter may swap ranks, and swap in or out at the top-k
    boundary. Equivalence requires:

    1. neither list repeats an id;
    2. rank-wise scores match within ``atol``;
    3. every id in both lists has scores within ``atol`` (it moved only
       inside a tie band);
    4. every id in only one list is a boundary tie: its score is within
       ``atol`` of the other list's last score.

    ``atol`` is required: the caller states the resolution it accepts.
    Returns ``(ok, reason)``, ``reason`` naming the first violation.
    """
    if len(got) != len(want):
        return False, f"length {len(got)} != {len(want)}"
    for name, lst in (("got", got), ("want", want)):
        ids = [i for i, _ in lst]
        if len(set(ids)) != len(ids):
            return False, f"duplicate ids in {name}"
    if not got:
        return True, ""
    for p, ((_, gs), (_, ws)) in enumerate(zip(got, want)):
        if abs(gs - ws) > atol:
            return False, (f"rank {p}: score {gs:.6g} vs {ws:.6g} "
                           f"(atol {atol:.3g})")
    g_score = {i: float(s) for i, s in got}
    w_score = {i: float(s) for i, s in want}
    for i in g_score.keys() & w_score.keys():
        if abs(g_score[i] - w_score[i]) > atol:
            return False, (f"id {i!r}: score {g_score[i]:.6g} vs "
                           f"{w_score[i]:.6g} (atol {atol:.3g})")
    for only, src, other_last, name in (
            (g_score.keys() - w_score.keys(), g_score, float(want[-1][1]),
             "got"),
            (w_score.keys() - g_score.keys(), w_score, float(got[-1][1]),
             "want")):
        for i in only:
            if abs(src[i] - other_last) > atol:
                return False, (f"id {i!r} only in {name}, score "
                               f"{src[i]:.6g} not a boundary tie with "
                               f"{other_last:.6g} (atol {atol:.3g})")
    return True, ""
