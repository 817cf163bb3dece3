"""The program's entry points a traffic file may drive, one file each.

``entries/<name>.py`` is the entry a traffic file names (``"entry":
"<name>"``).  It gives:

- ``ANSWER``: the kind of its answers, which ``judges/<ANSWER>.py`` judges;
- ``BATCH``: the program attribute (``module:attr``) that each request
  reaches as one batch call, which the batch metrics span;
- ``make(traffic, config)``: an :class:`Entry` bound to the program's
  config.

Each entry turns a list of query texts (one request: one query, or a
batch) into one answer per query, ``[(chunk ordinal, score), ...]``, by
calling the program the way its users do.  Module attributes are looked
up at each call, so the traced run's wrappers see every call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass
class Entry:
    call: Callable[[list[str]], list[list[tuple[int, float]]]]
    #: Runs every shape the traffic makes once (``warm(pool)``), before
    #: the traffic's own warm-up requests.
    warm: Callable[[list[str]], None]
