"""Shape padding helpers (counterpart of raglite_tpu/utils/padding.py).

PyTorch runs eagerly and needs no padding to bound recompiles; the port
keeps these two policies where padding is semantics: bucket-multiple row
counts for the scans, and the encoder's 128-token length buckets that
decide which texts share a forward pass.
"""

from __future__ import annotations

__all__ = ["bucket", "round_up"]


def round_up(n: int, multiple: int) -> int:
    """Smallest positive multiple of ``multiple`` that is >= ``n``
    (``multiple`` itself for ``n <= 0``)."""
    return max(multiple, -(-n // multiple) * multiple)


def bucket(n: int, minimum: int = 256) -> int:
    """Round up to a power of two, starting at ``minimum``."""
    size = minimum
    while size < n:
        size *= 2
    return size
