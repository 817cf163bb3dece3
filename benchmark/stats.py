"""Arithmetic over all requests of a window, and the spread of runs."""

from __future__ import annotations

import math
import statistics

__all__ = ["nearest_rank", "spread"]


def nearest_rank(values: list[float], q: float) -> float:
    """The ``q``-quantile of all values by the nearest-rank rule: the
    smallest value with at least ``q`` of the values at or below it."""
    if not values:
        return math.nan
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def spread(values: list[float]) -> float:
    """Distance between the first and the third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
