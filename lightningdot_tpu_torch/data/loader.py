"""Batching and device prefetch (the port's copies of ``TokenBucketSampler``
and ``DataLoader``, lightningdot_tpu/data/loader.py:27-262, and a PyTorch
``DevicePrefetcher`` in place of :265; reference
uniter_model/data/loader.py):

  * :class:`TokenBucketSampler`: token-budget batching
    (uniter_model/data/sampler.py:11-56 semantics).
  * :class:`DataLoader`: index shuffling + collate with background-thread
    prefetch (the host-side half of PrefetchLoader).
  * :class:`DevicePrefetcher`: runs ``put`` one batch ahead. With
    :class:`PinnedStager` as ``put``, the next batch's arrays go through
    pinned host buffers and ``non_blocking`` copies on a side stream while
    the current batch computes, and the consumer's stream waits on an
    event recorded after the copies (the CUDA side-stream copy of
    loader.py:83-138).

  * :class:`MetaLoader`: pre-training's multi-task sampling
    (loader.py:293-348).
  * :class:`DistributedSampler`: an epoch-seeded shuffle partitioned over
    ranks (loader.py:68-120); pre-training's fixed-row batches across
    processes use it.
"""
from __future__ import annotations

import queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from lightningdot_tpu_torch.data.padding import pin_pool, pinned_tensor
from lightningdot_tpu_torch.utils import tracing


class TokenBucketSampler:
    """The port's copy of ``TokenBucketSampler``
    (lightningdot_tpu/data/loader.py:27-65; reference
    uniter_model/data/sampler.py:11-56): shuffle -> bucket -> sort by
    length -> fill to the token budget. One seed gives the JAX package's
    batches."""

    def __init__(self, lens: Sequence[int], bucket_size: int, batch_size: int,
                 droplast: bool = False, size_multiple: int = 8,
                 seed: Optional[int] = None):
        self._lens = lens
        self._max_tok = batch_size
        self._bucket_size = bucket_size
        self._droplast = droplast
        self._size_mul = size_multiple
        self._rng = random.Random(seed)

    def __iter__(self) -> Iterator[List[int]]:
        ids = list(range(len(self._lens)))
        self._rng.shuffle(ids)
        buckets = [sorted(ids[i:i + self._bucket_size],
                          key=lambda i: self._lens[i], reverse=True)
                   for i in range(0, len(ids), self._bucket_size)]
        batches = []
        for bucket in buckets:
            max_len = 0
            batch_indices: List[int] = []
            for st in range(0, len(bucket), self._size_mul):
                indices = bucket[st:st + self._size_mul]
                max_len = max(max_len, max(self._lens[i] for i in indices))
                if (max_len * (len(batch_indices) + self._size_mul)
                        > self._max_tok):
                    if not batch_indices:
                        raise ValueError(
                            "max_tokens too small / max_seq_len too long")
                    batches.append(batch_indices)
                    batch_indices = list(indices)
                else:
                    batch_indices.extend(indices)
            if not self._droplast and batch_indices:
                batches.append(batch_indices)
        self._rng.shuffle(batches)
        return iter(batches)


class DistributedSampler:
    """Epoch-seeded per-rank batch sampler (the port's copy of
    lightningdot_tpu/data/loader.py:68-120; uniter sampler.py:59-116): the
    whole index list is shuffled with ``seed + epoch`` before the rank
    partition, so examples move between ranks every epoch, and wrap-around
    padding repeats indices until every rank has ``num_samples``. Call
    ``set_epoch`` each epoch, or every epoch replays one permutation."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 batch_size: int = 1, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)

    def __iter__(self):
        indices = list(range(self.dataset_len))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(indices)
        while len(indices) < self.total_size:
            indices += indices[:self.total_size - len(indices)]
        indices = indices[self.rank:self.total_size:self.num_replicas]
        assert len(indices) == self.num_samples
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk



class DataLoader:
    """Minimal map-style loader: sampler/batching + threaded collate (the
    port's copy of ``DataLoader``, lightningdot_tpu/data/loader.py:120-262).
    Batches come out in the sampler's order whatever ``num_workers``."""

    def __init__(self, dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, drop_last: bool = False,
                 collate_fn: Callable = None, sampler=None,
                 seed: Optional[int] = None, prefetch: int = 2,
                 on_epoch: Optional[Callable] = None,
                 num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or (lambda x: x)
        self.sampler = sampler
        self._rng = random.Random(seed)
        # queue.Queue treats maxsize<=0 as UNBOUNDED — clamp so
        # prefetch=0 cannot silently collate the whole epoch ahead
        self._prefetch = max(1, prefetch)
        # >1: N threads each fetch+collate WHOLE batches concurrently; the
        # consumer reorders by sequence number, so batch order is identical
        # to num_workers=1. Items of one batch stay on one thread. Only use
        # with datasets whose __getitem__ is deterministic (the ITM
        # fine-tune datasets pre-sample their epoch; the pre-train datasets
        # draw masks from per-item (seed, epoch, index) rngs). numpy/ldkv
        # release the GIL, so collate threads genuinely overlap.
        self.num_workers = num_workers
        # called at the start of every epoch (TokenBucketSamplerForItm's
        # new_epoch hook, dvl/data/itm_pre.py:20-29)
        self._on_epoch = on_epoch

    def _batches(self) -> Iterator[List[int]]:
        if self.sampler is not None:
            yield from iter(self.sampler)
            return
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                continue
            yield chunk

    def __len__(self) -> int:
        if self.sampler is not None:
            try:
                return len(self.sampler)
            except (TypeError, ValueError):
                raise ValueError(
                    "length unknown with a token-bucket sampler")
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        if self._on_epoch is not None:
            self._on_epoch()
        # num_workers=1 runs the same pipeline with one worker thread:
        # identical ordering and single-threaded __getitem__ semantics
        # (a bespoke single-worker path previously duplicated the
        # bounded-put / stop-event / error protocol with drift hazards)
        yield from self._iter_multi(max(1, self.num_workers))

    def _iter_multi(self, n_workers: int):
        """Order-preserving N-thread batch pipeline (see num_workers).

        Spans (``utils/tracing.py``), each with the batch's sequence number
        as its id: ``loader.collate`` on a worker thread (its items and
        collate), ``loader.wait`` on the consumer's (a blocking get).

        A ticket semaphore bounds total in-flight batches (queued +
        reorder-buffered): without it, one slow in-order batch would let
        the workers collate the whole epoch into the reorder buffer."""
        max_ahead = max(self._prefetch, n_workers) + n_workers
        tickets = threading.Semaphore(max_ahead)
        q: queue.Queue = queue.Queue(maxsize=max(self._prefetch, n_workers))
        stop = threading.Event()
        gen = enumerate(self._batches())
        gen_lock = threading.Lock()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def _acquire_ticket() -> bool:
            while not stop.is_set():
                if tickets.acquire(timeout=0.2):
                    return True
            return False

        def worker():
            while not stop.is_set():
                if not _acquire_ticket():
                    return
                with gen_lock:
                    try:
                        seq, batch_idx = next(gen)
                    except StopIteration:
                        break
                    except BaseException as e:
                        _put(("err", None, e))
                        return
                try:
                    with tracing.span("loader.collate", id=seq):
                        items = [self.dataset[i] for i in batch_idx]
                        out = self.collate_fn(items)
                except BaseException as e:
                    _put(("err", None, e))
                    return
                if not _put(("ok", seq, out)):
                    return
            _put(("done", None, None))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        buffered = {}
        next_seq = 0
        done = 0
        try:
            while done < n_workers:
                with tracing.span("loader.wait", id=next_seq):
                    kind, seq, item = q.get()
                if kind == "err":
                    raise item
                if kind == "done":
                    done += 1
                    continue
                buffered[seq] = item
                while next_seq in buffered:
                    yield buffered.pop(next_seq)
                    next_seq += 1
                    tickets.release()
            # all workers finished; drain any stragglers in order
            while next_seq in buffered:
                yield buffered.pop(next_seq)
                next_seq += 1
                tickets.release()
        finally:
            stop.set()



class StagedBatch(dict):
    """A batch whose arrays were staged to the device by
    :class:`PinnedStager`: ``event`` (None on the CPU) marks the end of its
    copies, and ``host`` is the host batch it came from."""

    event: Optional[torch.cuda.Event] = None
    host: Any = None


def _map_arrays(x, fn):
    if isinstance(x, dict):
        return {k: _map_arrays(v, fn) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return fn(x)
    return x


def _tensors(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, torch.Tensor):
        yield x


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """The tensor through which a copy to the card reads ``a``: the
    page-locked tensor that a pooled array views (so that torch's pinned
    allocator tracks an asynchronous copy and keeps the block until it is
    done, even if the array is freed first), else the array itself."""
    t = pinned_tensor(a)
    return t if t is not None else torch.from_numpy(np.ascontiguousarray(a))


class PinnedStager:
    """``put`` for :class:`DevicePrefetcher`: every numpy array of a batch
    (nested dicts included; lists and scalars pass through) becomes a
    tensor on ``device``. On a CUDA device each array is copied with
    ``non_blocking=True`` on a side stream, and an event is recorded after
    the copies: a pooled array is page-locked already
    (:func:`~lightningdot_tpu_torch.data.padding.pin_pool`, turned on here)
    and is read in place; any other array is first copied into a pinned
    buffer (``pin_memory``; torch's pinned-memory allocator keeps the
    buffer until its copy is done). On the CPU the tensors alias the
    arrays. Each call is a ``stage`` span (``utils/tracing.py``) that
    counts the ``bytes`` staged and the ``unpooled_bytes`` among them that
    went through ``pin_memory``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            pin_pool()

    def __call__(self, batch) -> StagedBatch:
        def to_dev(a):
            tracing.count("bytes", a.nbytes)
            if self.stream is None:
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)
            t = pinned_tensor(a)
            if t is None:
                tracing.count("unpooled_bytes", a.nbytes)
                t = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            return t.to(self.device, non_blocking=True)

        with tracing.span("stage"):
            if self.stream is None:
                staged = StagedBatch(_map_arrays(batch, to_dev))
            else:
                with torch.cuda.stream(self.stream):
                    staged = StagedBatch(_map_arrays(batch, to_dev))
                    staged.event = torch.cuda.Event()
                    staged.event.record(self.stream)
        staged.host = batch
        return staged


def await_staged(batch):
    """Make the current stream wait for a staged batch's copies; its
    tensors, allocated on the side stream, are marked as used by the
    current stream so the allocator does not reuse them early. Returns
    the batch; anything without an event passes through."""
    event = getattr(batch, "event", None)
    if event is not None:
        current = torch.cuda.current_stream()
        current.wait_event(event)
        for t in _tensors(batch):
            t.record_stream(current)
    return batch


class DevicePrefetcher:
    """Wrap a host-batch iterable; run ``put`` one batch ahead (the port's
    ``DevicePrefetcher``, lightningdot_tpu/data/loader.py:265-290).

    ``put`` is any callable (the JAX signature); with a
    :class:`PinnedStager` (or a callable returning its
    :class:`StagedBatch`), batch N+1's copies run on a side stream while
    batch N computes, and each batch is yielded only after the consumer's
    current stream has been made to wait on its copies' event.
    """

    def __init__(self, loader, put: Callable[[Any], Any]):
        self.loader = loader
        self.put = put

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            nxt = self.put(next(it))
        except StopIteration:
            return
        for host_batch in it:
            cur, nxt = nxt, self.put(host_batch)
            yield await_staged(cur)
        yield await_staged(nxt)


class MetaLoader:
    """Multi-task sampling loader (the port's copy of ``MetaLoader``,
    lightningdot_tpu/data/loader.py:293-348; reference loader.py:13-53).

    loaders: name -> loader or (loader, ratio). The task is re-drawn every
    ``accum_steps`` steps from a seeded RNG, so one seed gives one task
    sequence.
    """

    def __init__(self, loaders: Dict[str, Any], accum_steps: int = 1,
                 seed: int = 0):
        self.name2loader = {}
        self.name2iter = {}
        self.sampling_pools: List[str] = []
        for n, l in loaders.items():
            if isinstance(l, tuple):
                l, r = l
            else:
                r = 1
            self.name2loader[n] = l
            self.name2iter[n] = iter(l)
            self.sampling_pools.extend([n] * r)
        self.accum_steps = accum_steps
        self.step = 0
        self._rng = random.Random(seed)

    def __iter__(self):
        """Runs indefinitely (loader.py:35-53)."""
        task = self.sampling_pools[0]
        while True:
            if self.step % self.accum_steps == 0:
                task = self._rng.choice(self.sampling_pools)
            self.step += 1
            iter_ = self.name2iter[task]
            try:
                batch = next(iter_)
            except StopIteration:
                iter_ = iter(self.name2loader[task])
                try:
                    batch = next(iter_)
                except StopIteration:
                    raise ValueError(
                        f"task {task!r} loader yielded no batches (empty "
                        f"dataset or drop_last ate the only batch)") from None
                self.name2iter[task] = iter_
            yield task, batch

    def fast_forward(self, n_steps: int) -> None:
        """Advance the task stream to micro-step ``n_steps`` without
        touching data: a resumed run continues the task SEQUENCE where the
        interrupted one stopped (data iterators restart)."""
        while self.step < n_steps:
            if self.step % self.accum_steps == 0:
                self._rng.choice(self.sampling_pools)
            self.step += 1
