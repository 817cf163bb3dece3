"""The device trace of the traced run, reduced to what the readers need.

``torch.profiler`` (CPU and CUDA activities) runs from before the traced
slice to after it; the slice's bounds are taken on the profiler's own clock
(wall-clock nanoseconds, as ``time.time_ns``).  The reduction keeps, inside
the slice:

- every device activity (kernels, copies, sets) clipped to the slice, and
  their union's length, the seconds the device was busy;
- device time by name;
- the gaps between device activities, each labelled by the innermost host
  operation running at its midpoint.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["DeviceTrace", "Profiled"]


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    by_name: dict[str, float]
    counts: dict[str, int]
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)


class Profiled:
    """Start with :meth:`start`, mark the slice with :meth:`open` and
    :meth:`close`, then :meth:`reduce` once."""

    def __init__(self) -> None:
        self._prof = None
        self.lo_ns = self.hi_ns = 0

    def start(self) -> None:
        import torch.profiler as tp

        self._prof = tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def open(self) -> None:
        self.lo_ns = time.time_ns()

    def close(self) -> None:
        self.hi_ns = time.time_ns()

    def reduce(self) -> DeviceTrace:
        self._prof.__exit__(None, None, None)
        lo, hi = self.lo_ns, self.hi_ns
        dev_s, dev_e, dev_n = [], [], []
        host = []
        from torch.autograd import DeviceType

        for ev in self._prof.profiler.kineto_results.events():
            s, e = ev.start_ns(), ev.end_ns()
            if e <= lo or s >= hi:
                continue
            if ev.device_type() == DeviceType.CUDA:
                dev_s.append(max(s, lo))
                dev_e.append(min(e, hi))
                dev_n.append(ev.name())
            elif not ev.is_async():
                host.append((s, e, ev.name()))
        self._prof = None
        window_s = (hi - lo) / 1e9
        if not dev_s:
            return DeviceTrace(window_s, 0.0, {}, {})
        starts, ends = np.array(dev_s, np.int64), np.array(dev_e, np.int64)
        order = np.argsort(starts, kind="stable")
        starts, ends = starts[order], ends[order]
        # Union of intervals: a new run starts where the start passes every earlier end.
        reach = np.maximum.accumulate(ends)
        new = np.ones(len(starts), bool)
        new[1:] = starts[1:] > reach[:-1]
        first = np.flatnonzero(new)
        run_start = starts[first]
        run_end = reach[np.concatenate([first[1:] - 1, [len(starts) - 1]])]
        busy = float(np.sum(run_end - run_start)) / 1e9
        by_name: dict[str, float] = {}
        counts: dict[str, int] = {}
        for n, s, e in zip(dev_n, dev_s, dev_e):
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
            counts[n] = counts.get(n, 0) + 1
        gap_lo = np.concatenate([[lo], run_end])
        gap_hi = np.concatenate([run_start, [hi]])
        lengths = gap_hi - gap_lo
        top = np.argsort(-lengths)[:10]
        host.sort()
        host_s = np.array([h[0] for h in host], np.int64) if host else np.zeros(0, np.int64)
        gaps = []
        for i in top:
            if lengths[i] <= 0:
                continue
            mid = (gap_lo[i] + gap_hi[i]) // 2
            label = "host outside torch operations"
            # The innermost host operation around the midpoint: the latest start that still covers it.
            last = int(np.searchsorted(host_s, mid, side="right")) - 1
            for j in range(last, max(-1, last - 5000), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            gaps.append((label, float(lengths[i]) / 1e9))
        return DeviceTrace(window_s, busy, by_name, counts, gaps)
