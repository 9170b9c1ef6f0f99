"""Micro-batching front end for the real-time retriever (the port's copy
of ``BatchingFrontend``, lightningdot_tpu/serving_frontend.py:31-207).

The reference serves queries one at a time (``retrieve_query``,
dvl/utils.py:204-211). A query costs the card far less per query in a
batch than alone, so a deployment coalesces concurrent requests into one
device call.

``BatchingFrontend`` is that coalescer: callers submit queries from any
thread; a single dispatch thread drains the queue, groups up to
``max_batch`` requests (waiting at most ``max_wait_ms`` after the first),
issues one ``retrieve_batch`` per group, and hands the results to a
resolve thread that completes the per-request futures. One dispatch thread
keeps device calls serialized, while request threads only block on their
own future.

Requests with different ``top`` values batch together: the call runs at
the fixed ``max_top`` and each result is sliced to its request's ``top``
(the top-k output is sorted).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, List, Optional, Sequence, Tuple


class BatchingFrontend:
    """Coalesce concurrent ``retrieve(query)`` calls into batched device
    calls against a :class:`lightningdot_tpu_torch.serving.Retriever`."""

    def __init__(self, retriever, max_batch: int = 64,
                 max_wait_ms: float = 2.0,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 max_top: int = 100):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.retriever = retriever
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        # every dispatch runs at this fixed k and slices per request, so
        # a client-controlled k never reaches the device call
        self.max_top = max_top
        # group sizes pad up this ladder, so the device sees a bounded set
        # of shapes (each warmed once by warmup())
        self.batch_buckets = sorted(b for b in set(batch_buckets)
                                    if b <= max_batch) or [max_batch]
        if self.batch_buckets[-1] < max_batch:
            self.batch_buckets.append(max_batch)
        # deque + condition instead of queue.Queue: the dispatcher drains a
        # whole group under ONE lock acquisition (queue.Queue pays a lock +
        # condition round per item)
        self._pending: deque = deque()
        self._cond = threading.Condition()
        # serializes every retriever call: the dispatch thread holds it per
        # batch, warmup() holds it from the caller thread, so device calls
        # never run concurrently
        self._call_lock = threading.Lock()
        self._results: "queue.Queue" = queue.Queue()
        self._closed = False
        self.batches_dispatched = 0      # instrumentation (tests, metrics)
        self.requests_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ldot-serving-dispatch")
        # future resolution runs off the dispatch thread so the next device
        # call starts while the previous batch's callers are woken
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True,
                                          name="ldot-serving-resolve")
        self._thread.start()
        self._resolver.start()

    # -- client API ----------------------------------------------------------
    def submit(self, query: str, top: int = 100) -> "Future":
        """Enqueue a query; the future resolves to [(db_id, score)].

        ``top`` must be in [1, max_top] (the device call always runs at
        max_top; results slice per request)."""
        if not 1 <= top <= self.max_top:
            raise ValueError(f"top must be in [1, {self.max_top}]")
        fut: Future = Future()
        with self._cond:
            # checked under the lock: a submit racing close() must either
            # enqueue before the dispatcher's final drain or raise
            if self._closed:
                raise RuntimeError("frontend is closed")
            self._pending.append((query, top, fut))
            self._cond.notify()
        return fut

    def retrieve(self, query: str, top: int = 100
                 ) -> List[Tuple[Any, float]]:
        """Blocking convenience wrapper (retrieve_query semantics)."""
        return self.submit(query, top).result()

    def retrieve_many(self, queries: Sequence[str], top: int = 100):
        """Submit a burst, wait for all (preserves order)."""
        futs = [self.submit(q, top) for q in queries]
        return [f.result() for f in futs]

    def warmup(self, top: Optional[int] = None, query: str = "warmup"
               ) -> None:
        """Run one call per batch bucket (at ``query``'s length bucket and
        the dispatch k = max_top), so that real requests find the kernels
        built and the weights cast. Safe on a live frontend: each call
        takes the device-call lock."""
        for b in self.batch_buckets:
            with self._call_lock:
                self.retriever.retrieve_batch(
                    [query] * b, top=self.max_top if top is None else top)

    def close(self) -> None:
        """Drain outstanding requests and stop the worker threads."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify()          # wake the dispatcher
        self._thread.join()
        self._results.put(None)          # dispatcher done -> stop resolver
        self._resolver.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch loop ---------------------------------------------------------
    def _drain_locked(self, group):
        """Move up to max_batch pending items into group (cond held)."""
        take = min(self.max_batch - len(group), len(self._pending))
        for _ in range(take):
            group.append(self._pending.popleft())

    def _next_group(self):
        """Block for the first request, then drain up to max_batch more,
        waiting at most max_wait_s for stragglers. None = shutdown."""
        group: list = []
        with self._cond:
            while not self._pending and not self._closed:
                self._cond.wait()
            if not self._pending and self._closed:
                return None
            self._drain_locked(group)
            t_end = time.monotonic() + self.max_wait_s
            while len(group) < self.max_batch and not self._closed:
                timeout = t_end - time.monotonic()
                if timeout <= 0:
                    break
                self._cond.wait(timeout)
                self._drain_locked(group)
        return group

    def _loop(self) -> None:
        while True:
            group = self._next_group()
            if group is None:
                break
            queries = [q for q, _, _ in group]
            k = self.max_top  # fixed k: one device shape per bucket
            # pad the group up the batch-bucket ladder so every dispatch
            # runs one of a bounded set of shapes
            nb = next(b for b in self.batch_buckets if b >= len(queries))
            padded = queries + [""] * (nb - len(queries))
            try:
                with self._call_lock:
                    results = self.retriever.retrieve_batch(padded, top=k)
            except Exception as e:  # resolve, don't kill the dispatcher
                self._results.put((group, e))
                continue
            self.batches_dispatched += 1
            self.requests_served += len(group)
            self._results.put((group, results))
        # shutdown: fail anything still queued (close() raced new submits)
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
        if leftovers:
            self._results.put((leftovers, RuntimeError("frontend closed")))

    def _resolve_loop(self) -> None:
        while True:
            got = self._results.get()
            if got is None:
                break
            group, results = got
            if isinstance(results, BaseException):
                for _, _, fut in group:
                    try:
                        fut.set_exception(results)
                    except InvalidStateError:
                        pass             # caller cancelled; result dropped
            else:
                for (_, top, fut), res in zip(group, results):
                    try:
                        fut.set_result(res[:top])
                    except InvalidStateError:
                        pass             # caller cancelled; result dropped
