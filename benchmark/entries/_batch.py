"""An entry that sends each request as one call of a batch function of
``raglite_tpu_torch.search``, with the traffic's ``request`` fields as its
keyword arguments."""

from __future__ import annotations

from benchmark.corpus import ordinal_of
from benchmark.entries import Entry


def batch_entry(fn: str, traffic: dict, config) -> Entry:
    from raglite_tpu_torch import search

    request = dict(traffic.get("request", {}))
    batch = int(traffic.get("batch", 1))

    def call(queries: list[str]):
        results = getattr(search, fn)(queries, **request, config=config)
        return [[(ordinal_of(i), float(s)) for i, s in zip(ids, scores)] for ids, scores in results]

    def warm(pool: list[str]) -> None:
        call(pool[:batch])  # the one batch shape the traffic makes

    return Entry(call, warm)
