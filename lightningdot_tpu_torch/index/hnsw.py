"""HNSW approximate index, host-side over the shared native C++ engine
(the port's copy of ``hnsw_lib`` and ``DenseHNSWFlatIndexer``,
lightningdot_tpu/index/hnsw.py:22-167).

Parity: DenseHNSWFlatIndexer (dvl/indexer/faiss_indexers.py:90-155): the
same dot-product -> L2 conversion through an extra dimension
(faiss_indexers.py:100-131: store sqrt(phi - |v|^2) as dim d+1; query with
aux 0), the default parameters store_n=512 / efSearch=128 /
efConstruction=200, the all-at-once indexing requirement, and the
serialize/deserialize API. The engine is ``native/hnsw.cc``, built by the
port's :mod:`lightningdot_tpu_torch.native`; both packages run the same
library, so they return the same results and read each other's files.
"""
from __future__ import annotations

import ctypes
import pickle
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from lightningdot_tpu_torch.native import load_native

_configured = False


def hnsw_lib() -> Optional[ctypes.CDLL]:
    global _configured
    lib = load_native("hnsw")
    if lib is None or _configured:
        return lib
    _configured = True
    lib.hnsw_new.restype = ctypes.c_void_p
    lib.hnsw_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_add_batch.restype = ctypes.c_int
    lib.hnsw_add_batch.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64]
    lib.hnsw_add_batch_mt.restype = ctypes.c_int
    lib.hnsw_add_batch_mt.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int64, ctypes.c_int]
    lib.hnsw_size.restype = ctypes.c_int64
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_search.restype = ctypes.c_int
    lib.hnsw_search.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                                ctypes.POINTER(ctypes.c_float)]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    lib.hnsw_dim.restype = ctypes.c_int
    lib.hnsw_dim.argtypes = [ctypes.c_void_p]
    return lib


class DenseHNSWFlatIndexer:
    """faiss_indexers.py:90-155 API on the native HNSW."""

    def __init__(self, vector_sz: int, buffer_size: int = 50000,
                 store_n: int = 512, ef_search: int = 128,
                 ef_construction: int = 200, build_threads: int = 0):
        lib = hnsw_lib()
        if lib is None:
            raise RuntimeError("native hnsw library unavailable")
        self._lib = lib
        self.vector_sz = vector_sz
        self.buffer_size = buffer_size
        self.ef_search = ef_search
        self.store_n = store_n
        self.ef_construction = ef_construction
        self._h = lib.hnsw_new(vector_sz + 1, store_n, ef_construction)
        # 0 = all cores, like faiss's OpenMP build; unlike faiss the
        # parallel build is deterministic in the thread count (hnsw.cc::
        # add_batch_mt: frozen-snapshot searches + in-order link apply)
        import os
        self.build_threads = build_threads or (os.cpu_count() or 1)
        self.index_id_to_db_id: List[Any] = []
        self.phi = 0.0

    def index_data(self, data: Sequence[Tuple[Any, np.ndarray]]) -> None:
        """faiss_indexers.py:107-138: one-shot indexing with the phi norm."""
        if not len(data):  # empty shard: no-op, like DenseFlatIndex
            return
        if self.ntotal > 0:  # phi==0 (all-zero vectors) must still trip it
            raise RuntimeError(
                "DPR HNSWF index needs to index all data at once, "
                "results will be unpredictable otherwise.")
        vecs = np.stack([np.asarray(v, np.float32).reshape(-1)
                         for _, v in data])
        if vecs.shape[1] != self.vector_sz:
            # the native add reads n*(vector_sz+1) floats — a mismatched
            # width would read out of bounds / corrupt the index
            raise ValueError(
                f"vector size {vecs.shape[1]} != index size {self.vector_sz}")
        norms = (vecs ** 2).sum(axis=1)
        phi = float(norms.max())
        aux = np.sqrt(np.maximum(phi - norms, 0.0)).astype(np.float32)
        hnsw_vecs = np.ascontiguousarray(
            np.concatenate([vecs, aux[:, None]], axis=1))
        rc = self._lib.hnsw_add_batch_mt(
            self._h, hnsw_vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hnsw_vecs.shape[0], self.build_threads)
        if rc != 0:  # native add caught an exception (likely bad_alloc)
            raise MemoryError("native HNSW build failed; the index is "
                              "partially built and should be discarded")
        self.index_id_to_db_id.extend(t[0] for t in data)
        self.phi = phi

    @property
    def ntotal(self) -> int:
        return int(self._lib.hnsw_size(self._h))

    def search_knn(self, query_vectors: np.ndarray, top_docs: int
                   ) -> List[Tuple[List[Any], np.ndarray]]:
        q = np.asarray(query_vectors, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.vector_sz:
            raise ValueError(
                f"query size {q.shape[1]} != index size {self.vector_sz}")
        aux = np.zeros((q.shape[0], 1), np.float32)
        q = np.ascontiguousarray(np.concatenate([q, aux], axis=1))
        k = min(top_docs, self.ntotal)
        results = []
        out_ids = np.zeros((k,), np.int32)
        out_d = np.zeros((k,), np.float32)
        for row in q:
            n = self._lib.hnsw_search(
                self._h, row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                k, max(self.ef_search, k),
                out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            ids = [self.index_id_to_db_id[i] for i in out_ids[:n]]
            results.append((ids, -out_d[:n].copy()))  # smaller L2 = better
        return results

    def serialize(self, file: str) -> None:
        # hnsw_save checks every fwrite and returns -1 on failure (a full
        # disk must not look like a saved index)
        if self._lib.hnsw_save(self._h,
                               (file + ".index.hnsw").encode()) != 0:
            raise OSError(f"hnsw_save failed for {file}.index.hnsw "
                          f"(disk full / unwritable?)")
        with open(file + ".index_meta.dpr", "wb") as f:
            pickle.dump((self.index_id_to_db_id, self.phi), f)

    def deserialize_from(self, file: str) -> None:
        h = self._lib.hnsw_load((file + ".index.hnsw").encode())
        if not h:
            raise OSError(f"cannot load hnsw index from {file}")
        dim = int(self._lib.hnsw_dim(h))
        if dim != self.vector_sz + 1:
            self._lib.hnsw_free(h)
            raise ValueError(
                f"index on disk has dim {dim - 1}, this indexer expects "
                f"{self.vector_sz} (queries would read out of bounds)")
        self._lib.hnsw_free(self._h)
        self._h = h
        with open(file + ".index_meta.dpr", "rb") as f:
            self.index_id_to_db_id, self.phi = pickle.load(f)

    def __del__(self):
        try:
            self._lib.hnsw_free(self._h)
        except Exception:
            pass
