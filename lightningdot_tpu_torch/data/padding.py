"""Padding to a fixed ladder of lengths, and the host batch-buffer pool
(the port's copy of lightningdot_tpu/data/padding.py:33-204).

Batches are padded up a bucket ladder (:mod:`lightningdot_tpu_torch.const`)
instead of to each batch's own maximum (dvl/data/itm.py:231-252): padding
is fully masked, so the math is the same, and a run meets a bounded set of
shapes.

Large feature batches come from a small pool of recycled arrays
(``_pool_get``), because rotating multi-MB allocations through a threaded
loader serves every batch from fresh pages and pays first-touch faults in
the collate. Once a consumer copies batches to the card (:func:`pin_pool`),
the pooled arrays are page-locked, so the collate writes the one host copy
that the card's copy engine reads. Consumer loops return spent batches
through :class:`Recycler`, gated on a CUDA event recorded after the copies
that read them.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)
_CLAMP_WARNED: set = set()

_POOL: dict = {}
_POOL_LOCK = threading.Lock()
_POOL_MIN_BYTES = 1 << 20   # pool only multi-MB feature batches
# live buffers per shape: loader workers in flight, the prefetch queue and
# what the consumer still holds
_POOL_PER_KEY = 12
_PINNED = False


def pin_pool() -> None:
    """Allocate the pooled arrays page-locked from now on (needs a card):
    a copy to the card then reads them directly (the ``PinnedStager`` of
    :mod:`lightningdot_tpu_torch.data.loader`), and the :class:`Recycler`
    holds each until the event of its copies has passed."""
    global _PINNED
    _PINNED = True


def pinned_tensor(a: np.ndarray) -> Optional[torch.Tensor]:
    """The page-locked tensor that a pooled array views whole, or None.
    Copies read it through the tensor, so that torch's pinned-memory
    allocator keeps the block until they are done if the array is freed
    before that."""
    t = a.base
    if (isinstance(t, torch.Tensor) and t.data_ptr() == a.ctypes.data
            and tuple(t.shape) == a.shape and t.is_pinned()):
        return t
    return None


def _pool_get(shape, dtype) -> np.ndarray:
    key = (tuple(shape), np.dtype(dtype).str)
    with _POOL_LOCK:
        free = _POOL.get(key)
        if free:
            return free.pop()
    if _PINNED:
        like = torch.from_numpy(np.empty(0, dtype))
        return torch.empty(tuple(shape), dtype=like.dtype,
                           pin_memory=True).numpy()
    return np.empty(shape, dtype)


def recycle(tree) -> None:
    """Return a batch's large numpy arrays to the pool.

    Safe only once nothing else reads the arrays. Views are not pooled,
    except the whole-tensor views of :func:`pinned_tensor`. Shared
    references inside one batch are deduplicated by object identity."""
    seen: set = set()

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif (isinstance(x, np.ndarray) and x.nbytes >= _POOL_MIN_BYTES
              and (x.base is None or pinned_tensor(x) is not None)
              and id(x) not in seen):
            seen.add(id(x))
            key = (x.shape, x.dtype.str)
            with _POOL_LOCK:
                free = _POOL.setdefault(key, [])
                if len(free) < _POOL_PER_KEY:
                    free.append(x)

    walk(tree)


class Recycler:
    """Recycle spent host batches once the work that read them provably ran
    (the port's ``Recycler``, lightningdot_tpu/data/padding.py:78-139).

    ``push(batch, ready=event)`` returns a batch to the pool only when (a)
    at least ``slack`` newer batches were pushed after it and (b) its
    readiness object reports done: a ``torch.cuda.Event`` recorded after
    the device work that read the batch (``query()``; for a staged batch,
    the event of its copies out of the page-locked pool), or None for work
    that is already complete. Batches whose event never completes are
    dropped un-pooled once ``slack + max_pending`` newer batches sit behind
    them (a plain free: it never corrupts, it only loses the page reuse).

    ``enabled`` is the caller's to decide, where the JAX version asks its
    backend: pass True where the device copies batches out of host memory
    (a CUDA device), False where tensors may alias the numpy arrays (the
    CPU, through ``torch.from_numpy``). Disabled, ``push`` does nothing.
    """

    def __init__(self, *, enabled: bool, slack: int = 1,
                 max_pending: int = 8):
        self.enabled = enabled
        self.slack = slack
        self.max_pending = max_pending
        self._q: deque = deque()

    @staticmethod
    def _ready(ref) -> bool:
        return ref is None or bool(ref.query())

    def push(self, host_batch, ready: Optional[object] = None) -> None:
        """Queue a spent batch; ``ready`` is an event recorded after the
        work that consumed it."""
        if not self.enabled:
            return
        self._q.append((host_batch, ready))
        while len(self._q) > self.slack:
            batch, ref = self._q[0]
            if self._ready(ref):
                self._q.popleft()
                recycle(batch)
            elif len(self._q) > self.slack + self.max_pending:
                self._q.popleft()        # not provably done: plain free
            else:
                break

    def flush(self) -> None:
        """End of loop: pool what is provably done, free the rest."""
        while self._q:
            batch, ref = self._q.popleft()
            if self._ready(ref):
                recycle(batch)


def bucket_len(n: int, buckets: Sequence[int]) -> int:
    """The first bucket >= n; above the top bucket, the top bucket (the
    padders then truncate), with one warning per ladder."""
    for b in buckets:
        if n <= b:
            return b
    key = tuple(buckets)
    if key not in _CLAMP_WARNED:
        _CLAMP_WARNED.add(key)
        logger.warning(
            "sequence length %d exceeds the top bucket %d and will be "
            "truncated (ladder %s); raise the ladder or pre-truncate "
            "upstream if this is corpus data", n, buckets[-1], buckets)
    return buckets[-1]


def pad_ids(seqs: List[Sequence[int]], length: int, pad: int = 0
            ) -> np.ndarray:
    out = np.full((len(seqs), length), pad, np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = np.asarray(s[:n], np.int32)
    return out


def pad_mask(lens: Sequence[int], length: int) -> np.ndarray:
    out = np.zeros((len(lens), length), np.int32)
    for i, n in enumerate(lens):
        out[i, :min(n, length)] = 1
    return out


def pad_feats(feats: List[np.ndarray], length: int,
              dtype=None) -> np.ndarray:
    """B x [T_i, D] -> [B, length, D] zero-padded (data.py:270-283). Keeps
    the source dtype when it is uniform (float16 region features stay
    float16; the model casts on the device); mixed dtypes promote to
    float32; ``dtype`` forces one."""
    d = feats[0].shape[-1]
    if dtype is None:
        dtype = feats[0].dtype
        if any(f.dtype != dtype for f in feats):
            dtype = np.float32
    out = _pool_get((len(feats), length, d), dtype)
    for i, f in enumerate(feats):
        n = min(f.shape[0], length)
        out[i, :n] = f[:n]
        out[i, n:] = 0
    return out


def position_ids(batch: int, length: int) -> np.ndarray:
    return np.broadcast_to(np.arange(length, dtype=np.int32),
                           (batch, length)).copy()
