"""The 95th percentile, by the nearest-rank rule, of the time from a
client's send to its results in hand, over every request completed in the
window; a failed request counts as a miss (infinitely late).  Where the
percentile falls on a failed request the metric is left out: the run is
not correct then."""

import math

from benchmark.stats import nearest_rank


def read(ctx):
    times = [(r.done - r.sent) * 1e3 if r.error is None else math.inf for r in ctx.records]
    p95 = nearest_rank(times, 0.95)
    return None if not math.isfinite(p95) else p95
