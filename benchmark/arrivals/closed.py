"""Closed-loop clients: each sends its next request when the last returns.

``clients`` threads share one cursor over the query pool.  A request is
``batch`` consecutive pool positions.  Each client records, per request,
when it was sent and when its answers were in hand (``time.perf_counter``),
the first position it carried and whether it raised, as a tuple of plain
numbers (``benchmark.load.Request``): the records add nothing for the
garbage collector to scan, so the harness does not set off collections
that the program alone would not.  Answers are kept for the positions of
``keep`` alone (the check's sample), the latest answer of each with its
time.  The clients run from the end of warm-up through the measured
window; when the window closes they send nothing more and finish what they
hold.
"""

from __future__ import annotations

import threading
import time
import traceback

from benchmark.load import Request

__all__ = ["ClosedLoop", "make"]


def make(call, pool: list[str], traffic: dict, keep: set[int]) -> "ClosedLoop":
    return ClosedLoop(call, pool, int(traffic.get("clients", 1)), int(traffic.get("batch", 1)), keep)


class ClosedLoop:
    def __init__(self, call, pool: list[str], clients: int, batch: int, keep: set[int]) -> None:
        self.call = call
        self.pool = pool
        self.clients = clients
        self.batch = batch
        self.keep = keep
        self.records: list[Request] = []
        #: position -> (time answered, answer), for the positions of ``keep``.
        self.answers: dict[int, tuple[float, list]] = {}
        self._cursor = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _next(self) -> int:
        with self._lock:
            start = self._cursor
            self._cursor += self.batch
        return start

    def _client(self) -> None:
        local: list[Request] = []
        n = len(self.pool)
        while not self._stop.is_set():
            start = self._next()
            positions = [(start + i) % n for i in range(self.batch)]
            queries = [self.pool[p] for p in positions]
            sent = time.perf_counter()
            try:
                answers = self.call(queries)
            except Exception:  # a failed request counts as failed, and the client goes on
                local.append(Request(sent, time.perf_counter(), start % n, self.batch, traceback.format_exc(limit=4)))
                continue
            done = time.perf_counter()
            local.append(Request(sent, done, start % n, self.batch))
            for p, a in zip(positions, answers):
                if p in self.keep:
                    self.answers[p] = (done, a)
        with self._lock:
            self.records.extend(local)

    def start(self) -> None:
        for i in range(self.clients):
            t = threading.Thread(target=self._client, name=f"client-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def sent(self) -> int:
        """Requests sent so far (a warm-up's progress)."""
        with self._lock:
            return self._cursor // self.batch

    def stop(self, timeout: float = 120.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            msg = f"clients still running {timeout} s after the window closed: {alive}"
            raise RuntimeError(msg)
