"""Interactive text->image query serving and corpus encoding
(counterpart of lightningdot_tpu/serving.py:23-31,142-464).

Encode a corpus once (:func:`get_model_encoded_vecs`), then serve text
queries: tokenize -> one text-tower forward -> scores against the corpus
held on the device -> top-k (reference retrieve_query,
dvl/utils.py:204-211). :func:`lightningdot_tpu_torch.serving_native.
serve_retriever` puts the native C++ HTTP server in front of it.

The tower runs in bfloat16 (or float32), or on int8 weights
(``weight_quantization="int8"``); the corpus is bfloat16 or per-vector int8
(``quantization="int8"``); top-k is exact or approximate (``topk="approx"``,
:func:`approx_topk`). With a ``mesh`` (a ``DeviceMesh``) the corpus is
sharded over its devices, one row block each, and each shard's top k is
merged into the global top k on the tower's device.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lightningdot_tpu_torch.data.padding import bucket_len
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.index.dense import merge_shard_topk
from lightningdot_tpu_torch.models.bi_encoder import (BiEncoder,
                                                      dot_product_scores)
from lightningdot_tpu_torch.models.quantized import QuantizedTextEncoder
from lightningdot_tpu_torch.ops import mm_int8
from lightningdot_tpu_torch.ops.ffn_int8 import INV_127
from lightningdot_tpu_torch.training.evaluator import (BatchEncoder,
                                                       encoded_batches)

QUERY_LEN_BUCKETS = (16, 32, 64)
# batch sizes are padded up this ladder, as in the JAX package, so a server
# that coalesces arbitrary batch sizes runs a bounded set of shapes
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def approx_bin_width(n: int, k: int, recall: float) -> int:
    """The widest power-of-two bin width w that divides ``n`` and leaves
    ``bins = n / w`` >= k bins with (1 - 1/bins)^(k-1) >= ``recall``; 1
    means exact.

    When each bin keeps only its maximum and the true top k fall into bins
    independently and uniformly, (1 - 1/bins)^(k-1) is the chance that the
    k-th of them survives (none of the k - 1 above it shares its bin): the
    sizing rule of XLA's ApproxTopK, which ``jax.lax.approx_max_k`` uses.
    Every item above the k-th survives more often, so the expected recall,
    (bins / k)(1 - (1 - 1/bins)^k), is higher still (0.987 for k = 100 at
    recall 0.95 over full COCO).
    """
    w = 1
    while (n % (2 * w) == 0 and n // (2 * w) >= k
           and (1.0 - 2 * w / n) ** (k - 1) >= recall):
        w *= 2
    return w


def approx_topk(scores: torch.Tensor, k: int, recall: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over the last axis of [B, N] ``scores``, sorted
    (counterpart of ``jax.lax.approx_max_k`` with its final exact top-k,
    lightningdot_tpu/serving.py:318-323, which torch lacks).

    Column i falls into bin i mod (N / w) for the width w of
    :func:`approx_bin_width`; each bin keeps its maximum, and an exact
    ``torch.topk`` runs over the bin maxima. Strided bins spread
    neighbouring corpus entries apart. A plain torch op: the JAX package
    computes this outside Pallas too.
    """
    b, n = scores.shape
    w = approx_bin_width(n, k, recall)
    if w == 1:
        return torch.topk(scores, k, dim=1)
    bins = n // w
    best, row = scores.view(b, w, bins).max(dim=1)
    values, cand = torch.topk(best, k, dim=1)
    return values, torch.gather(row, 1, cand) * bins + cand


class Retriever:
    """Serve text->image retrieval against a pre-encoded corpus.

    ``model`` holds the weights; the Retriever moves it to ``device``
    (``None``: the card, raising where there is none, or the first device
    of ``mesh``; ``"cpu"`` runs the plain PyTorch path) and runs it in its
    ``compute_dtype``.
    """

    def __init__(self, model: BiEncoder, tokenizer, *,
                 device: Optional[torch.device] = None, mesh=None,
                 query_buckets: Sequence[int] = QUERY_LEN_BUCKETS,
                 quantization: Optional[str] = None,
                 weight_quantization: Optional[str] = None,
                 topk: str = "exact", topk_recall: float = 0.95,
                 batch_buckets: Sequence[int] = BATCH_BUCKETS):
        """``quantization="int8"`` holds the corpus as per-vector int8 with
        float32 scales and scores it in int32; ``weight_quantization=
        "int8"`` runs the query tower on int8 weights
        (:class:`~lightningdot_tpu_torch.models.quantized.
        QuantizedTextEncoder`; the float tower then stays where it is);
        ``topk="approx"`` takes :func:`approx_topk`,
        its bins sized so that recall is at least ``topk_recall``
        (lightningdot_tpu/serving.py:145-159). ``mesh`` shards the corpus
        over a ``DeviceMesh``: rows aligned to 128 x its size, shard i on
        its i-th device, each shard's exact or approximate top k merged
        exactly (serving.py:147,172,188,213-226)."""
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantization!r}")
        if weight_quantization not in (None, "int8"):
            raise ValueError(
                f"unknown weight_quantization {weight_quantization!r}")
        if topk not in ("exact", "approx"):
            raise ValueError(f"unknown topk {topk!r}")
        self.mesh = mesh
        self.device = resolve_device(
            device if device is not None or mesh is None
            else mesh.devices[0])
        # the int8 tower is quantized from the float tower where that lies
        # and alone goes to the device
        self._qtower = (QuantizedTextEncoder(model.txt_model).to(self.device)
                        if weight_quantization == "int8" else None)
        self.model = (model if self._qtower is not None
                      else model.to(self.device)).eval()
        self.tokenizer = tokenizer
        self.query_buckets = tuple(query_buckets)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.quantization = quantization
        self.weight_quantization = weight_quantization
        self.topk = topk
        self.topk_recall = topk_recall
        # [N_pad, D] bfloat16, or int8 with float32 [N_pad] scales; with a
        # mesh, a list of each shard's on its device
        self._corpus: Optional[torch.Tensor] = None
        self._scales: Optional[torch.Tensor] = None
        self._bias: Optional[torch.Tensor] = None     # [N_pad] float32
        self._ids: List[Any] = []

    # -- corpus --------------------------------------------------------------
    def set_corpus(self, ids: Sequence[Any], vectors: np.ndarray) -> None:
        """Hold ``vectors`` [N, D] on the device, rows padded to a multiple
        of 128; padding rows carry a -1e30 score bias. bfloat16, or with
        ``quantization="int8"`` per-vector int8: scale max(max|v| / 127,
        1e-12), values round(v / scale) clipped to +-127, computed in numpy
        exactly as the JAX package does (serving.py:186-203)."""
        n = vectors.shape[0]
        n_pad = -(-n // 128) * 128
        mat = np.zeros((n_pad, vectors.shape[1]), np.float32)
        mat[:n] = vectors
        bias = np.zeros((n_pad,), np.float32)
        bias[n:] = -1e30
        scales = None
        if self.quantization == "int8":
            scales = np.maximum(np.abs(mat).max(axis=1) / 127.0, 1e-12)
            mat = np.clip(np.rint(mat / scales[:, None]), -127, 127
                          ).astype(np.int8)
            scales = scales.astype(np.float32)
        self._place(mat, bias, scales)
        self._ids = list(ids)

    def _place(self, mat: np.ndarray, bias: np.ndarray,
               scales: Optional[np.ndarray]) -> None:
        def put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def put_corpus(a: np.ndarray, dev: torch.device) -> torch.Tensor:
            # a float corpus rounds to bfloat16 on the device: one upload
            # of float32, no float32 copy kept
            t = put(a, dev)
            return t if t.dtype == torch.int8 else t.to(torch.bfloat16)

        if self.mesh is None:
            self._corpus = put_corpus(mat, self.device)
            self._bias = put(bias, self.device)
            self._scales = (put(scales, self.device) if scales is not None
                            else None)
            return
        n_dev = self.mesh.size
        n_pad = -(-mat.shape[0] // (128 * n_dev)) * 128 * n_dev
        extra = n_pad - mat.shape[0]
        if extra:   # a corpus saved unsharded: pad it to the mesh
            mat = np.concatenate([mat, np.zeros((extra, mat.shape[1]),
                                                mat.dtype)])
            bias = np.concatenate([bias, np.full(extra, -1e30, np.float32)])
            if scales is not None:
                scales = np.concatenate([scales, np.full(extra, 1e-12,
                                                         np.float32)])
        per = n_pad // n_dev
        rows = [slice(i * per, (i + 1) * per) for i in range(n_dev)]
        self._corpus = [put_corpus(mat[r], d) for r, d in zip(rows,
                                                              self.mesh)]
        self._bias = [put(bias[r], d) for r, d in zip(rows, self.mesh)]
        self._scales = (None if scales is None else
                        [put(scales[r], d) for r, d in zip(rows, self.mesh)])

    def save_corpus(self, path: str) -> None:
        """``path.corpus.npz`` (vecs as float32 or int8, bias, and the int8
        scales) + ``path.ids.pkl``: the JAX package's format, so either
        package loads the other's."""
        def host(x):   # a shard list is concatenated in shard order
            return (torch.cat([t.cpu() for t in x]) if isinstance(x, list)
                    else x.cpu())

        vecs = host(self._corpus)
        arrays = {"vecs": (vecs if vecs.dtype == torch.int8
                           else vecs.float()).numpy(),
                  "bias": host(self._bias).numpy()}
        if self._scales is not None:
            arrays["scales"] = host(self._scales).numpy()
        np.savez(path + ".corpus.npz", **arrays)
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
        vecs = data["vecs"]
        self._place(vecs if vecs.dtype == np.int8
                    else np.asarray(vecs, np.float32),
                    np.asarray(data["bias"], np.float32),
                    np.asarray(data["scales"], np.float32)
                    if "scales" in data.files else None)
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
        mask_t = torch.from_numpy(mask).to(self.device)
        pos = torch.arange(ids.shape[1], device=self.device).expand(
            ids.shape)
        if self._qtower is not None:
            return self._qtower(ids_t, mask_t, pos)
        return self.model.encode_txt({
            "input_ids": ids_t, "attention_mask": mask_t,
            "position_ids": pos})

    def encode_queries(self, queries: Sequence[str]) -> np.ndarray:
        """Query embeddings [n, D] as float32 (in the compute dtype's
        precision; the int8 tower's with ``weight_quantization="int8"``),
        through the same padding as the query path."""
        ids, mask = self._token_batch(queries)
        return self._encode(ids, mask)[:len(queries)].float().cpu().numpy()

    def _shard_topk(self, vec: torch.Tensor, corpus: torch.Tensor,
                    bias: torch.Tensor, scales: Optional[torch.Tensor],
                    k: int):
        if scales is not None:
            # symmetric per-query int8, int32 scores rescaled in float32
            # (serving.py:303-313)
            q_scale = torch.clamp(vec.abs().amax(dim=-1, keepdim=True),
                                  min=1e-12).float() * INV_127
            q = torch.round(vec.float() / q_scale).clamp(-127, 127).to(
                torch.int8)
            scores = mm_int8(q, corpus.t()).float() * q_scale * scales
        else:
            scores = dot_product_scores(vec.to(corpus.dtype), corpus)
        biased = scores + bias
        if self.topk == "approx":
            return approx_topk(biased, k, self.topk_recall)
        return torch.topk(biased, k, dim=1)

    @torch.inference_mode()
    def _search(self, vec: torch.Tensor, k: int):
        if self.mesh is None:
            return self._shard_topk(vec, self._corpus, self._bias,
                                    self._scales, k)
        # every shard's top min(k, rows), ids offset by the shard's first
        # row, merged exactly on the tower's device
        parts = []
        scales = self._scales or [None] * len(self._corpus)
        for i, (corpus, bias, sc) in enumerate(zip(self._corpus, self._bias,
                                                   scales)):
            rows = corpus.shape[0]
            s, idx = self._shard_topk(vec.to(corpus.device), corpus, bias,
                                      sc, min(k, rows))
            parts.append((s, idx + i * rows))
        return merge_shard_topk(parts, k, self.device)

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


def get_model_encoded_vecs(model: BiEncoder, dataloader, *,
                           device: Optional[torch.device] = None
                           ) -> Dict[str, Any]:
    """Encode a whole dataloader with both towers (counterpart of
    lightningdot_tpu/serving.py:444-464; reference dvl/utils.py:214-233):
    {'img_embed': {img_fname: vec}, 'caption_embed': {img_fname: vec},
    'txt_embed': {txt_id: vec}, 'img_name': [img_fname, ...]}, float32
    numpy vectors. The model's weights are its own (the JAX function takes
    them as ``params``); it runs on ``device`` (:class:`BatchEncoder`).
    Batches are staged as the evaluator stages them
    (:func:`encoded_batches`), and the vectors stay on the device until
    one pull at the end."""
    encoder = BatchEncoder(model, device=device)
    fnames: List[Any] = []
    tids: List[Any] = []
    chunks: Dict[str, List[torch.Tensor]] = {"img": [], "cap": [], "txt": []}
    for batch, txt, img, cap in encoded_batches(encoder, dataloader):
        n_valid = batch["n_valid"]
        fnames.extend(batch["img_fname"][:n_valid])
        tids.extend(batch["txt_index"][:n_valid])
        for key, vec in (("img", img), ("cap", cap), ("txt", txt)):
            if vec is not None:
                chunks[key].append(vec[:n_valid])
    rows = {k: torch.cat(v).cpu().numpy() if v else []
            for k, v in chunks.items()}
    # dict semantics of the reference: later duplicates overwrite
    return {"img_embed": dict(zip(fnames, rows["img"])),
            "caption_embed": dict(zip(fnames, rows["cap"])),
            "txt_embed": dict(zip(tids, rows["txt"])),
            "img_name": fnames}


def display_img(img_meta: dict, name: str, img_only: bool = False) -> None:
    """Show image ``name`` of ``img_meta`` and print its annotation and
    first caption (the port's copy of ``display_img``,
    lightningdot_tpu/serving.py:467-478; reference dvl/utils.py:191-202).
    Needs matplotlib, imported here, and the image files on disk."""
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    img = mpimg.imread(img_meta[name]["img_file"])
    plt.imshow(img)
    plt.show()
    if not img_only:
        print("annotation")
        print("\t" + "\n\t".join(img_meta[name]["annotation"]))
        print("caption")
        print("\t" + img_meta[name]["caption"][0])
