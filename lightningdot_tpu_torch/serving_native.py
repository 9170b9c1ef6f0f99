"""Native (C++) HTTP serving front end over the port's Retriever (the
port's copy of ``serve_retriever`` and ``NativeRetrievalServer``,
lightningdot_tpu/serving_native.py:35-162), and of ``run_loadgen``
(:164-185), the open-loop load generator over ``native/ldloadgen.cc``.

``native/ldserve.cc`` does socket IO, HTTP parsing, micro-batch assembly
and JSON formatting; Python (and the card) is entered once per batch
through a ctypes callback into ``Retriever.retrieve_batch_arrays``.

Endpoints and JSON schema:
    GET /search?q=<text>&top=<k> -> {"query":..., "results":[[id, score]..]}
    GET /healthz                 -> {"ok": true, "corpus": N}

The reference serves one query at a time (retrieve_query,
dvl/utils.py:204-211); batching behind a real server is the production
shape of the same capability.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import weakref
from typing import Optional, Sequence

import numpy as np

from lightningdot_tpu_torch.native import build_native, load_native

_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_char),
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float))


def _lib():
    lib = load_native("ldserve")
    if lib is None:
        raise RuntimeError("native ldserve library unavailable "
                           "(g++ build failed?)")
    lib.ldserve_start.restype = ctypes.c_int
    lib.ldserve_start.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        _CB, ctypes.c_void_p]
    lib.ldserve_port.restype = ctypes.c_int
    lib.ldserve_port.argtypes = [ctypes.c_int]
    lib.ldserve_stats.argtypes = [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint64)]
    lib.ldserve_stop.argtypes = [ctypes.c_int]
    return lib


def _stop_native(lib, handle, cb) -> None:
    """Module-level so weakref.finalize never resurrects the server object;
    holding ``cb`` keeps the callback trampoline alive until the C++ side
    has joined its threads."""
    lib.ldserve_stop(handle)
    del cb


class NativeRetrievalServer:
    """Own a C++ HTTP server; device calls arrive as per-batch callbacks.

    ``retrieve_arrays(queries, k) -> (idx int32 [n,k], scores f32 [n,k])``
    is the only Python hook — pass ``Retriever.retrieve_batch_arrays`` (or
    any callable with that contract, e.g. a simulator for host-side load
    tests). The single C++ dispatcher thread serializes device calls, like
    BatchingFrontend's dispatch thread.
    """

    def __init__(self, ids: Sequence, retrieve_arrays, port: int = 0,
                 max_batch: int = 64, max_wait_ms: float = 1.0,
                 max_top: int = 100):
        self._lib = _lib()
        self._retrieve = retrieve_arrays
        # the retriever clamps k to the corpus size (serving.py
        # retrieve_batch_arrays); the server's k must match or the cb's
        # (n, k) shape check fails on every batch for small corpora
        max_top = max(1, min(max_top, len(ids)))
        self.max_top = max_top
        id_strs = [str(i).encode("utf-8") for i in ids]
        blob = b"".join(id_strs)
        offs = np.zeros(len(id_strs) + 1, np.int32)
        np.cumsum([len(s) for s in id_strs], out=offs[1:])

        def cb(user, q_blob, q_off, n, k, out_idx, out_scores):
            try:
                raw = ctypes.string_at(q_blob, q_off[n])
                queries = [raw[q_off[i]:q_off[i + 1]].decode(
                    "utf-8", "replace") for i in range(n)]
                idx, scores = self._retrieve(queries, k)
                idx = np.ascontiguousarray(idx, np.int32)
                scores = np.ascontiguousarray(scores, np.float32)
                if idx.shape != (n, k) or scores.shape != (n, k):
                    return 2
                ctypes.memmove(out_idx, idx.ctypes.data, idx.nbytes)
                ctypes.memmove(out_scores, scores.ctypes.data,
                               scores.nbytes)
                return 0
            except Exception:
                import traceback
                traceback.print_exc()
                return 1

        self._cb = _CB(cb)  # keep a reference: C holds the pointer
        handle = self._lib.ldserve_start(
            port, max_batch, max_wait_ms, max_top, blob,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(id_strs), self._cb, None)
        if handle < 0:
            raise OSError(-handle, "ldserve_start failed")
        self._handle = handle
        self.port = self._lib.ldserve_port(handle)
        # GC / interpreter-exit safety net: the C++ server threads hold a
        # raw pointer to the ctypes trampoline (self._cb); if this object
        # were collected without stop(), the next request would call into
        # freed memory. The finalizer owns references to (lib, cb) so the
        # trampoline outlives the native server no matter how we go down
        # (weakref.finalize also runs at interpreter exit).
        self._finalizer = weakref.finalize(
            self, _stop_native, self._lib, handle, self._cb)

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.ldserve_stats(self._handle, out)
        return {"requests": out[0], "batches": out[1],
                "batched_requests": out[2], "errors": out[3]}

    def stop(self) -> None:
        if self._handle is not None:
            self._finalizer()  # idempotent: runs _stop_native exactly once
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def serve_retriever(retriever, port: int = 0, max_batch: int = 64,
                    max_wait_ms: float = 1.0, max_top: int = 100,
                    warmup: bool = True) -> NativeRetrievalServer:
    """Start the native server over a live :class:`serving.Retriever`."""
    if warmup:
        # the C++ dispatcher coalesces ARBITRARY batch sizes <= max_batch;
        # retrieve_batch_arrays buckets them (serving.BATCH_BUCKETS), so
        # warming every reachable bucket makes the steady state stall-free
        # (kernels built, weights cast, library handles made)
        batches = ([b for b in retriever.batch_buckets if b <= max_batch]
                   or [max_batch])
        if batches[-1] < max_batch:
            batches.append(max_batch)
        retriever.warmup(tops=(max_top,), batches=batches)
    return NativeRetrievalServer(
        retriever.ids, retriever.retrieve_batch_arrays, port=port,
        max_batch=max_batch, max_wait_ms=max_wait_ms, max_top=max_top)


def run_loadgen(port: int, rate: float, duration_s: float = 5.0,
                conns: int = 8, top: int = 100,
                timeout: Optional[float] = None) -> dict:
    """Run the native open-loop load generator (``native/build/ldloadgen``,
    built through :func:`~lightningdot_tpu_torch.native.build_native`)
    against ``127.0.0.1:port`` at ``rate`` requests/s over ``conns``
    connections for ``duration_s`` seconds; returns its stats dict
    (offered and achieved rates, latency quantiles, errors). A failed
    build or run raises ``RuntimeError``."""
    exe = build_native("build/ldloadgen")
    out = subprocess.run(
        [str(exe), str(port), str(rate), str(duration_s), str(conns),
         str(top)],
        capture_output=True, text=True,
        timeout=timeout or (duration_s + 30))
    if out.returncode != 0:
        raise RuntimeError(f"ldloadgen failed: {out.stdout} {out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])
