"""Spans and counters the benchmark records around the program's calls.

In the traced run a metric's reader asks for a span on a module or class
attribute of the program (``span("raglite_tpu_torch.search:embed_queries")``);
the attribute is replaced by a wrapper that records, per call, its start
and end on ``time.perf_counter`` and the number of items its first argument
holds, and is put back when the run ends.  Each attribute is wrapped once,
however many readers ask for it.  The untraced run wraps nothing.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time

__all__ = ["Spans"]


class Spans:
    def __init__(self) -> None:
        self.records: dict[str, list[tuple[float, float, int]]] = {}
        self._saved: list[tuple[object, str, object]] = []
        self._lock = threading.Lock()

    def span(self, target: str) -> list[tuple[float, float, int]]:
        """The records of ``module:attr`` or ``module:Class.attr``, wrapping
        it on the first request."""
        if target in self.records:
            return self.records[target]
        module, _, path = target.partition(":")
        owner = importlib.import_module(module)
        *parents, attr = path.split(".")
        for p in parents:
            owner = getattr(owner, p)
        original = getattr(owner, attr)
        records: list[tuple[float, float, int]] = []
        lock = self._lock
        is_method = bool(parents) and isinstance(owner, type)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            items = args[1] if is_method else args[0]
            start = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                end = time.perf_counter()
                with lock:
                    records.append((start, end, len(items) if hasattr(items, "__len__") else 1))

        setattr(owner, attr, wrapper)
        self._saved.append((owner, attr, original))
        self.records[target] = records
        return records

    def within(self, target: str, lo: float, hi: float) -> list[tuple[float, float, int]]:
        """Records of ``target`` that ended inside [lo, hi]."""
        with self._lock:
            return [r for r in self.records.get(target, []) if lo <= r[1] <= hi]

    def mean_ms(self, target: str, lo: float, hi: float) -> float | None:
        """Mean milliseconds of the calls of ``target`` that ended inside
        [lo, hi] (None where there were none)."""
        calls = self.within(target, lo, hi)
        return 1e3 * sum(e - s for s, e, _ in calls) / len(calls) if calls else None

    def restore(self) -> None:
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved.clear()
