"""Request micro-batching for the serving surface (a copy of
raglite_tpu/utils/microbatch.py, repaired to keep one batch in flight).

A device scan amortizes over the query batch: one [B, N] program costs
little more than [1, N] (the int4 route serves B <= 32 in one launch), so a
server handling concurrent single-query requests should coalesce them into
one device program.  ``MicroBatcher`` does that with a leader/follower
protocol: the first thread to enqueue becomes the leader, waits up to
``max_wait_ms`` for followers (or until ``max_batch``), swaps the queue,
runs the batch function once, and distributes results.  Under a single
in-flight request the added latency is exactly ``max_wait_ms``; under load
the wait is dominated by batching wins.  ``max_batch=32`` is the int4
route's B <= 32.

One batch runs at a time: a leader takes the run lock before it swaps the
queue, so requests that arrive while a batch runs gather under the next
leader instead of each leading a batch of its own that runs beside it.
Requests beyond ``max_batch`` stay queued, and the first of them is made
the next leader.

The reference has no analogue: its SQL engine executes per query
(raglite/_search.py:65-141), and its server story is
"scale out PostgreSQL".
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

__all__ = ["MicroBatcher", "KeyedMicroBatcher"]


class MicroBatcher:
    """Coalesce concurrent ``submit(item)`` calls into ``batch_fn(items)``.

    ``batch_fn`` receives the items in arrival order and must return one
    result per item, in order.  Exceptions from ``batch_fn`` propagate to
    every waiter of that batch.
    """

    def __init__(
        self,
        batch_fn: Callable[[list[Any]], list[Any]],
        *,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        timeout_s: float = 60.0,
    ) -> None:
        self._batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._running = threading.Lock()
        self._pending: list[list[Any]] = []  # [item, result, error, Event, leads]
        self._full = threading.Event()  # leader wakes early at max_batch
        #: Recent batch sizes (observability; bounded so a long-running
        #: server does not grow one int per executed batch forever).
        self.batch_sizes: deque[int] = deque(maxlen=256)

    def submit(self, item: Any) -> Any:
        entry: list[Any] = [item, None, None, threading.Event(), False]
        with self._lock:
            self._pending.append(entry)
            leader = len(self._pending) == 1
            if len(self._pending) >= self.max_batch:
                self._full.set()
        if leader:
            self._full.wait(self.max_wait_ms / 1000.0)
        elif not entry[3].wait(self.timeout_s):
            with self._lock:
                if not entry[3].is_set():  # unanswered: leave the queue, so no one promotes it
                    self._pending = [e for e in self._pending if e is not entry]
                    msg = "micro-batch leader did not complete in time"
                    raise TimeoutError(msg)
        if leader or entry[4]:
            self._run_batch()
        if entry[2] is not None:
            raise entry[2]
        return entry[1]

    def _run_batch(self) -> None:
        with self._running:  # one batch in flight
            with self._lock:
                batch, self._pending = self._pending[: self.max_batch], self._pending[self.max_batch :]
                self._full.clear()
                if self._pending:  # the overflow's first request leads it
                    self._pending[0][4] = True
                    self._pending[0][3].set()
                    if len(self._pending) >= self.max_batch:
                        self._full.set()
            try:
                results = self._batch_fn([e[0] for e in batch])
                if len(results) != len(batch):  # defensive: api contract
                    msg = f"batch_fn returned {len(results)} results for {len(batch)} items"
                    raise RuntimeError(msg)
                for e, r in zip(batch, results):
                    e[1] = r
            except Exception as exc:  # propagate to every waiter
                for e in batch:
                    e[2] = exc
            finally:
                self.batch_sizes.append(len(batch))
                for e in batch:
                    e[3].set()


class KeyedMicroBatcher:
    """One :class:`MicroBatcher` per compatibility key.

    Requests are only batchable when they run the same program — same
    search method, result count, and metadata filter — so callers submit
    with a key describing that signature."""

    def __init__(
        self,
        batch_fn_for_key: Callable[[Any], Callable[[list[Any]], list[Any]]],
        *,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        max_keys: int = 64,
    ) -> None:
        self._factory = batch_fn_for_key
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._max_keys = max_keys
        self._lock = threading.Lock()
        #: LRU-bounded: webchat keys embed client-controlled parameters
        #: (num_results, the metadata filter), so an unbounded map would be
        #: request-driven memory growth on a long-running server.
        self._batchers: OrderedDict[Any, MicroBatcher] = OrderedDict()

    def submit(self, key: Any, item: Any) -> Any:
        with self._lock:
            batcher = self._batchers.get(key)
            if batcher is None:
                batcher = MicroBatcher(
                    self._factory(key),
                    max_batch=self._max_batch,
                    max_wait_ms=self._max_wait_ms,
                )
                self._batchers[key] = batcher
                while len(self._batchers) > self._max_keys:
                    self._batchers.popitem(last=False)  # evict LRU
            else:
                self._batchers.move_to_end(key)
        return batcher.submit(item)
