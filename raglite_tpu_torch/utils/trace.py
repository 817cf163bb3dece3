"""Tracing and profiling (counterpart of raglite_tpu/utils/trace.py).

- :func:`phase` — a context manager timing a named pipeline phase on the
  host's clock.  Timings aggregate into a process-global registry
  (:func:`report`), and each phase is also a
  ``torch.profiler.record_function`` range, so phases show up on the
  timeline when a profiler trace is active.  A phase adds no device
  synchronisation: it times what the host spent, as the JAX one does.
- :func:`trace_session` — wraps ``torch.profiler.profile`` (CPU and, where
  there is a card, CUDA activities) around a block and writes a Chrome
  trace (Perfetto, chrome://tracing) into a directory.
- :class:`Progress` — a zero-dependency progress meter (the tqdm analogue)
  that stays silent when stderr is not a TTY.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

__all__ = ["phase", "report", "reset", "trace_session", "Progress"]

_LOCK = threading.Lock()
_TIMINGS: dict[str, list[float]] = defaultdict(list)


@contextmanager
def phase(name: str) -> Iterator[None]:
    """Time a named phase; nest freely.  Shows up in :func:`report` and on
    the profiler's timeline when a trace is active."""
    import torch.profiler

    start = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        elapsed = time.perf_counter() - start
        with _LOCK:
            _TIMINGS[name].append(elapsed)


def report() -> dict[str, dict[str, float]]:
    """Aggregated phase timings: {phase: {count, total_s, mean_s, max_s}}."""
    with _LOCK:
        return {
            name: {
                "count": len(samples),
                "total_s": sum(samples),
                "mean_s": sum(samples) / len(samples),
                "max_s": max(samples),
            }
            for name, samples in _TIMINGS.items()
            if samples
        }


def reset() -> None:
    with _LOCK:
        _TIMINGS.clear()


@contextmanager
def trace_session(log_dir: str) -> Iterator[Path]:
    """Capture a torch.profiler trace around a block; the Chrome trace is
    written to ``log_dir`` when the block ends (its path is yielded)."""
    import torch
    import torch.profiler

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    root = Path(log_dir)
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"trace.{os.getpid()}.{time.time_ns()}.json"
    with torch.profiler.profile(activities=activities) as profiler:
        yield path
    profiler.export_chrome_trace(str(path))


class Progress:
    """Minimal progress meter (the reference's tqdm analogue).  Prints a
    carriage-return line on TTY stderr; silent otherwise (CI/pytest)."""

    def __init__(self, total: int, desc: str = "", *, stream=None) -> None:
        self.total = max(total, 1)
        self.desc = desc
        self.count = 0
        self._stream = stream if stream is not None else sys.stderr
        self._tty = hasattr(self._stream, "isatty") and self._stream.isatty()
        self._start = time.perf_counter()

    def update(self, n: int = 1) -> None:
        self.count += n
        if not self._tty:
            return
        elapsed = time.perf_counter() - self._start
        rate = self.count / elapsed if elapsed > 0 else 0.0
        self._stream.write(
            f"\r{self.desc}: {self.count}/{self.total} ({rate:.1f}/s)"
        )
        self._stream.flush()

    def __enter__(self) -> "Progress":
        return self

    def __exit__(self, *exc) -> None:
        # One terminating newline whenever a \r status line was written:
        # totals are sometimes estimates, so this is the only place the
        # line ends.
        if self._tty and self.count > 0:
            self._stream.write("\n")
            self._stream.flush()
