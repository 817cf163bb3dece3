"""Rate and tail arithmetic over every request of the window."""

import math

from benchmark.load import Request
from benchmark.run import Cell, Context, load_plugin
from benchmark.stats import nearest_rank, spread


def _ctx(records, window=(0.0, 10.0)):
    cell = Cell("x", 1, {}, {"entry": "search.vector_search_batch"}, {}, [], [])
    return Context(cell, window, records, {}, None, 4096)


def test_p95_is_over_all_requests_and_sees_a_planted_stall():
    # 1,000 requests of 10 ms, then a stall holds 60 of them for 500 ms: a
    # median of chunks would hide it, the tail over all requests may not.
    records = [Request(i * 0.01, i * 0.01 + 0.010, i, 1) for i in range(1000)]
    records += [Request(5.0, 5.5, i, 1) for i in range(60)]
    p95 = load_plugin("metrics", "search_p95_ms").read(_ctx(records))
    assert math.isclose(p95, 500.0, rel_tol=1e-9)
    assert math.isclose(load_plugin("metrics", "search_p95_ms").read(_ctx(records[:1000])), 10.0, rel_tol=1e-6)


def test_failed_requests_count_as_misses_and_not_as_answers():
    records = [Request(0.0, 0.01, i, 1) for i in range(90)]
    records += [Request(0.0, 0.02, i, 1, "boom") for i in range(10)]
    ctx = _ctx(records, (0.0, 2.0))
    assert load_plugin("metrics", "search_qps").read(ctx) == 45.0
    assert load_plugin("metrics", "search_p95_ms").read(ctx) is None


def test_rate_counts_queries_of_batched_requests():
    records = [Request(0.0, 0.5, 0, 32) for _ in range(10)]
    assert load_plugin("metrics", "search_qps").read(_ctx(records, (0.0, 4.0))) == 80.0


def test_nearest_rank_and_spread():
    assert nearest_rank(list(range(1, 101)), 0.95) == 95
    assert nearest_rank([3.0], 0.95) == 3.0
    assert math.isclose(spread([1.0, 2.0, 3.0, 4.0, 5.0]), (4.5 - 1.5) / 3.0)
