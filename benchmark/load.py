"""What every arrival process records of a request.

A traffic file names its arrival process (``"arrivals": "<name>"``), which
``arrivals/<name>.py`` implements: ``make(call, pool, traffic, keep)``
returns a loop with ``start()``, ``sent()`` (requests sent so far),
``stop()``, ``records`` (one :class:`Request` each) and ``answers``
(position -> (time answered, answer), for the positions of ``keep``).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["Request"]


class Request(NamedTuple):
    sent: float
    done: float
    start: int  # first pool position
    count: int  # positions, from ``start``, modulo the pool
    error: str | None = None

    def positions(self, pool: int) -> list[int]:
        return [(self.start + i) % pool for i in range(self.count)]
