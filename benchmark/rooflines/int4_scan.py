"""Bytes one stage-1 int4 scan call must move, and the kernels that make it.

Frozen from the repository's kernel table (PERF.md section 6, the
``time_kernels`` bound of ``chip_smoke.py`` as of this benchmark's first
version): the packed rows (N x d / 2 bytes), a float32 scale and a float32
bias a row, the int8 query tile (B x d) and the per-bucket outputs (B x L x
8 bytes: a float32 score and an int32 id), each read or written once.  N is
the scanned rows padded to whole buckets (L = 4,096 buckets).  At N =
1,249,280, B = 1: 0.1462 ms at d = 768 and 0.1939 ms at d = 1,024 at
3.35 TB/s.  The int8 operations (2 B N d at 1,979 TOP/s) bound no shape
the cells run.
"""

import math

NUM_BUCKETS = 4096
#: Device kernels of one call (``csrc/mma_scan.cuh``): the int4 instance
#: of the tensor-core scan and the merge of its splits.
KERNELS = ("mma_scan_kernel<true", "merge_splits_kernel")


def scanned_rows(rows: int) -> int:
    return math.ceil(rows / NUM_BUCKETS) * NUM_BUCKETS


def call_bytes(rows: int, dim: int, batch: float) -> float:
    n = scanned_rows(rows)
    return n * dim / 2 + n * 8 + batch * dim + batch * NUM_BUCKETS * 8


def is_call_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def is_launch(name: str) -> bool:
    """The one kernel every call launches once (the scan itself)."""
    return KERNELS[0] in name
