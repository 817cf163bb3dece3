"""Device-resident dense vector index (counterpart of raglite_tpu/index/dense.py).

The index is the chunk-embedding matrix itself, resident on the device:

- rows  [capacity, d]   sub-vector embeddings (bf16 by default, or int8
                        with per-row scales, or f16/f32)
- row_chunk [capacity]  row -> chunk ordinal (multi-vector grouping)
- valid [capacity]      tombstone mask (deletes flip bits, never rebuild)

The canonical copy is a host mirror (f16, power-of-two growth); the device
copy is refreshed by one bulk upload when the mirror is reallocated, by an
in-place write of the appended rows otherwise, and by a re-upload of the
mask alone after deletes.

Search routes as the JAX package does (``search_chunks_device``), with the
device test ``device.type == "cuda"`` where the JAX package tests for a
TPU backend; the thresholds are the JAX package's, kept as semantics:

- more than 131,072 rows, B <= 32, d % 256 == 0, ``use_int4_stage1``, on
  CUDA: the two-stage route (the int4 kernel, then an exact rescore of
  max(256, 2 x hits) candidates);
- B <= 32 otherwise, unless the single-stage kernel applies: one exact scan
  (``_dense_search``) and the multi-vector group-max;
- ``use_pallas``, B <= 32, at least 16 x 1024 rows, approximate, on CUDA:
  the single-stage kernel (``fused_scan_topk``).

PyTorch has no ``approx_max_k``, so the plain scan is always exact; every
top-k puts the lower index first on ties, as ``jax.lax.top_k`` does.

With ``num_devices > 1`` the device copies split into contiguous row shards,
one per device of ``index_devices`` (parallel/mesh.py; shards may share a
card), and the capacity rounds to ``INT4_NUM_BUCKETS`` x the shard count,
so every shard holds whole int4 buckets.  Appends write into the shard that
owns the rows, tombstones flip bits there.  One device is one shard: every
index scans through parallel/sharded.py, the int4 route (with whole buckets
per shard when there are several) through ``sharded_int4_two_stage`` and
the exact scan through ``sharded_topk_search``; only the single-stage
kernel stays single-device, as in the JAX package.  The row -> chunk map
stays whole on the first device, where the merged winners' multi-vector
group-max runs.

``search_chunks_device`` runs each route as one program, the JAX package's
``_int4_two_stage_chunks`` (:func:`int4_two_stage_chunks`),
``_dense_search_chunks_fused`` (:func:`dense_search_chunks`) and its
single-stage scan with the group-max (:func:`fused_scan_chunks`).  On one
card each is replayed from a CUDA graph per key (utils/graphs.py): the
route, the batch, the hit and result counts, whether a row mask and an
adapter enter, and the index's ``generation``.  A graph reads the device
arrays at the addresses it was captured with, so every change to an array
a program reads (growth, an append, an upload, the int4 copy, the
tombstone mask, the adapter) bumps the generation and drops the graphs.
The queries and the row mask are copied into each key's static buffers.
Size rule: the dense route's key stays eager where its f32 copy of the rows
and its [B, N] scores would exceed :data:`GRAPH_SCAN_BYTES` in the graph's
pool (above ~300,000 rows at d = 768; there its launches are a few per cent
of its time).  A sharded index runs every route eagerly.
"""

from __future__ import annotations

import hashlib
import threading
from functools import lru_cache
from typing import TYPE_CHECKING

import numpy as np
import torch

from raglite_tpu_torch.config import checked_device
from raglite_tpu_torch.ops.fused_scan import (
    DEFAULT_NUM_BUCKETS,
    INT4_NUM_BUCKETS,
    INT4_STAGE1_CANDIDATES,
    _topk_stable,
    fused_scan_topk,
    pack_rows_int4,
    quantize_rows_int8,
)
from raglite_tpu_torch.parallel.mesh import index_devices, split_rows
from raglite_tpu_torch.parallel.sharded import sharded_int4_two_stage, sharded_topk_search
from raglite_tpu_torch.types import DistanceMetric
from raglite_tpu_torch.utils.graphs import ProgramGraphs
from raglite_tpu_torch.utils.padding import round_up as _round_up
from raglite_tpu_torch.utils.precision import full_f32_matmul

if TYPE_CHECKING:
    from raglite_tpu_torch.config import RAGLiteConfig
    from raglite_tpu_torch.store import Store

#: Index sizes up to this scan exactly; above it the JAX package turns
#: approximate, and the two-stage and single-stage kernel routes open.
EXACT_TOPK_MAX_ROWS = 131_072

_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "int8": torch.int8,
}
_DTYPE_NAMES = {dt: name for name, dt in _DTYPES.items()}
#: Pool bytes above which a dense-route key runs eagerly (module docstring).
GRAPH_SCAN_BYTES = 1 << 30


def _dense_search(
    rows: torch.Tensor,  # [N, d] storage dtype (int8 => row_scale required)
    row_sqnorm: torch.Tensor,  # [N] f32 (for l2)
    valid: torch.Tensor,  # [N] bool
    queries: torch.Tensor,  # [B, d] f32
    row_scale: torch.Tensor | None = None,
    *,
    num_hits: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distance matmul + masked exact top-k: (scores [B, K], row ids [B, K])."""
    if rows.dtype == torch.int8:
        q_abs = queries.abs().amax(dim=1)
        q_s = torch.where(q_abs > 0, q_abs / 127.0, torch.ones_like(q_abs))
        q_i8 = torch.clamp(torch.round(queries / q_s[:, None]), -127, 127)
        # Integer products and sums below 2^24 for d <= 1040: exact in f32.
        with full_f32_matmul():
            sims = q_i8 @ rows.to(torch.float32).T
        sims = sims * (q_s[:, None] * row_scale[None, :])
    else:
        q = queries.to(rows.dtype).to(torch.float32)
        with full_f32_matmul():
            sims = q @ rows.to(torch.float32).T
    if metric == "l2":
        sims = 2.0 * sims - row_sqnorm[None, :]
    sims = sims.masked_fill(~valid[None, :], float("-inf"))
    return _topk_stable(sims, num_hits)


def _group_max_topk(
    scores: torch.Tensor,  # [B, K] descending sub-vector scores
    row_ids: torch.Tensor,  # [B, K]
    row_chunk: torch.Tensor,  # [capacity] row -> chunk ordinal (-1 for padding)
    *,
    num_results: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-vector group-max + final chunk ranking on the device.

    ``scores`` arrive sorted descending, so a chunk's first occurrence
    carries its max; later ones are masked by a pairwise comparison.
    Returns (scores [B, R] f32, chunk ordinals [B, R] int64); empty slots
    carry -inf and ordinal -1.  (The JAX package packs both into one f32
    array, with a bitcast variant for ordinals of 2^24 and above; int64
    holds every ordinal exactly, so the port needs neither.)"""
    k = scores.shape[1]
    chunks = row_chunk[row_ids.to(torch.int64)].to(torch.int64)  # [B, K]
    same = chunks[:, None, :] == chunks[:, :, None]  # [B, K, K]
    tri = torch.ones((k, k), dtype=torch.bool, device=scores.device).tril(diagonal=-1)
    is_repeat = (same & tri[None]).any(dim=-1)
    chunk_scores = scores.masked_fill(is_repeat, float("-inf"))
    final_scores, pos = _topk_stable(chunk_scores, min(num_results, k))
    final_chunks = chunks.gather(1, pos)
    final_chunks = final_chunks.masked_fill(torch.isneginf(final_scores), -1)
    return final_scores, final_chunks


def _adapted(queries: torch.Tensor, adapter: torch.Tensor | None) -> torch.Tensor:
    return queries if adapter is None else queries @ adapter.T


def int4_two_stage_chunks(
    packed: list[torch.Tensor],  # [Np, d//2] int4-packed rows per shard
    scale4: list[torch.Tensor],  # [Np] f32
    rows: list[torch.Tensor],  # [N, d] full-precision rows (rescore)
    row_scale: list[torch.Tensor] | None,  # [N] f32 (int8 rows)
    row_sqnorm: list[torch.Tensor],  # [N] f32 (l2)
    valid: list[torch.Tensor],  # [N] bool (tombstones and row mask)
    row_chunk: torch.Tensor,  # [capacity] row -> chunk ordinal, first device
    queries: torch.Tensor,  # [B, d] f32
    adapter: torch.Tensor | None = None,  # [d, d]
    *,
    num_hits: int,
    num_results: int,
    candidates: int,
    metric: str,
    devices: list[torch.device],
    num_buckets: int = INT4_NUM_BUCKETS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_int4_two_stage_chunks`` as one program: the
    adapter, every shard's int4 scan and rescore (``sharded_int4_two_stage``),
    the merge and the multi-vector group-max.  Returns (scores [B, R],
    ordinals [B, R])."""
    scores, idx = sharded_int4_two_stage(
        packed, scale4, rows, row_scale, row_sqnorm, valid, _adapted(queries, adapter),
        num_hits=num_hits, candidates=candidates, metric=metric, devices=devices, num_buckets=num_buckets,
    )
    return _group_max_topk(scores, idx, row_chunk, num_results=num_results)


def dense_search_chunks(
    rows: list[torch.Tensor],
    row_sqnorm: list[torch.Tensor],
    valid: list[torch.Tensor],
    row_chunk: torch.Tensor,
    queries: torch.Tensor,
    row_scale: list[torch.Tensor] | None = None,
    adapter: torch.Tensor | None = None,
    *,
    num_hits: int,
    num_results: int,
    metric: str,
    devices: list[torch.device],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_dense_search_chunks_fused`` (exact) as one
    program: the adapter, every shard's exact scan and top-k
    (``sharded_topk_search``), the merge and the group-max."""
    scores, idx = sharded_topk_search(
        rows, row_sqnorm, valid, _adapted(queries, adapter), row_scale,
        num_hits=num_hits, metric=metric, devices=devices,
    )
    return _group_max_topk(scores, idx, row_chunk, num_results=num_results)


def fused_scan_chunks(
    rows: torch.Tensor,
    row_sqnorm: torch.Tensor,
    valid: torch.Tensor,
    row_chunk: torch.Tensor,
    queries: torch.Tensor,
    row_scale: torch.Tensor | None = None,
    adapter: torch.Tensor | None = None,
    *,
    num_hits: int,
    num_results: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The single-stage route as one program (the JAX package dispatches
    ``bucketed_max_scan``'s top-k and ``_group_max_topk`` apart): the
    adapter, the bucket scan kernel and its top-k (``fused_scan_topk``),
    the group-max; one device."""
    scores, idx = fused_scan_topk(
        rows, row_sqnorm, valid, _adapted(queries, adapter), num_hits=num_hits, metric=metric, row_scale=row_scale,
    )
    return _group_max_topk(scores, idx, row_chunk, num_results=num_results)


def fetch_scored(scores: torch.Tensor, ordinals: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(scores [B, k] f32, ordinals [B, k] int64) to the host in ONE
    device-to-host copy (f64 holds both exactly)."""
    b = scores.shape[0]
    both = torch.cat([scores.to(torch.float64), ordinals.to(torch.float64)]).cpu().numpy()
    return both[:b].astype(np.float32), both[b:].astype(np.int64)


class DenseIndex:
    """Host-mirrored, device-resident dense index synced from a Store."""

    def __init__(
        self,
        *,
        dim: int,
        dtype: str = "bfloat16",
        metric: DistanceMetric = "cosine",
        num_devices: int = 1,
        use_pallas: bool = True,
        use_int4_stage1: bool = True,
        device: torch.device | str = "cuda",
    ) -> None:
        self.dim = dim
        self.metric: DistanceMetric = metric
        self._dtype = _DTYPES[dtype]
        self.use_pallas = use_pallas
        self.use_int4_stage1 = use_int4_stage1
        self.device = checked_device(device)
        #: One device per row shard (0 = one per card); the first holds the
        #: row -> chunk map and the merged results.
        self.devices = index_devices(num_devices, self.device)
        self.device = self.devices[0]
        self.num_devices = len(self.devices)
        self.num_rows = 0
        self.capacity = 0
        # Host mirror (canonical).
        self._host_rows: np.ndarray | None = np.zeros((0, dim), dtype=np.float16)
        self._host_valid = np.zeros((0,), dtype=np.bool_)
        self.row_chunk = np.zeros((0,), dtype=np.int64)
        self.chunk_ids: list[str] = []
        # Device copies, one tensor per row shard (lists of length
        # num_devices).
        self._rows: list[torch.Tensor] | None = None
        self._sqnorm: list[torch.Tensor] | None = None
        self._valid: list[torch.Tensor] | None = None
        self._scale: list[torch.Tensor] | None = None  # int8 dequant scales
        self._packed4: list[torch.Tensor] | None = None  # int4 stage-1 copy
        self._scale4: list[torch.Tensor] | None = None
        self._dev_row_chunk: torch.Tensor | None = None  # whole, on the first device
        self._dirty = True  # full upload required
        self._valid_dirty = False
        self._dev_rows_synced = 0
        self._synced_version = -1
        self._synced_generation = 0
        self._synced_deleted = 0
        #: (host adapter, its device copy), replaced as one pair so that
        #: threads searching at once never see a copy of another adapter.
        self._adapter: tuple[np.ndarray, torch.Tensor] | None = None
        self._row_mask_cache: dict = {}
        #: Which route served the last search: "int4_two_stage",
        #: "fused_scan" (single-stage kernel) or "dense" (plain exact scan).
        self.last_route: str | None = None
        #: Serializes sync() and every search against concurrent server
        #: threads: a search holds it from its device refresh until its
        #: scan is enqueued, so no sync replaces an array it reads.
        #: Reentrant: the fused hybrid search holds it across a sync and
        #: its search (search.py:_hybrid_fused_batch).
        self._sync_lock = threading.RLock()
        #: Bumped by every change to a device array the search programs
        #: read (under the sync lock); part of every program key.
        self.generation = 0
        #: The search programs, replayed from CUDA graphs on one card.
        self.programs = ProgramGraphs(self.device, capture=self.num_devices == 1, capture_if=self._captured)

    def _bump(self) -> None:
        """A device array the programs read changed: drop their graphs."""
        self.generation += 1
        self.programs.clear()

    def _captured(self, key: tuple) -> bool:
        """The size rule (module docstring): a dense-route key ``(route,
        B, ...)`` is captured while its f32 row copy and [B, N] scores fit
        GRAPH_SCAN_BYTES."""
        route, batch = key[0], key[1]
        return route != "dense" or self.capacity * 4 * (self.dim + batch) <= GRAPH_SCAN_BYTES

    @property
    def shard_rows(self) -> int:
        """Rows per shard (capacity / num_devices)."""
        return self.capacity // self.num_devices

    # --- Build / mutate (host mirror) ------------------------------------

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        self._dirty = True
        self._bump()
        # A multiple of the shard count x the int4 bucket count: the rows
        # split evenly, every shard holds whole buckets, no scan ever pads.
        new_cap = _round_up(max(needed, 2 * max(self.capacity, 1)), INT4_NUM_BUCKETS * self.num_devices)
        rows = np.zeros((new_cap, self.dim), dtype=np.float16)
        rows[: self.num_rows] = self._host_rows[: self.num_rows]
        valid = np.zeros((new_cap,), dtype=np.bool_)
        valid[: self.num_rows] = self._host_valid[: self.num_rows]
        self._host_rows, self._host_valid = rows, valid
        self.capacity = new_cap

    def append_chunks(self, matrices: list[np.ndarray], chunk_ids: list[str]) -> None:
        """Append all sub-vector rows of a batch of chunks in one shot."""
        if not matrices:
            return
        counts = [m.shape[0] for m in matrices]
        total = int(sum(counts))
        base_ord = len(self.chunk_ids)
        self.chunk_ids.extend(chunk_ids)
        self._ensure_capacity(self.num_rows + total)
        stacked = np.concatenate([np.asarray(m, dtype=np.float16) for m in matrices], axis=0)
        self._host_rows[self.num_rows : self.num_rows + total] = stacked
        self._host_valid[self.num_rows : self.num_rows + total] = True
        new_row_chunk = np.repeat(base_ord + np.arange(len(counts), dtype=np.int64), counts)
        self.row_chunk = np.concatenate([self.row_chunk, new_row_chunk])
        self.num_rows += total

    def rebuild(self, store: "Store") -> None:
        self.chunk_ids = []
        self.num_rows = self.capacity = 0
        self._host_rows = np.zeros((0, self.dim), dtype=np.float16)
        self._host_valid = np.zeros((0,), dtype=np.bool_)
        self.row_chunk = np.zeros((0,), dtype=np.int64)
        self.append_chunks(
            [store.embeddings[cid] for cid in store.chunk_order], list(store.chunk_order)
        )
        self._apply_tombstones(store)
        self._dirty = True
        self._bump()
        self._synced_version = store.version
        self._synced_generation = store.generation

    def _apply_tombstones(self, store: "Store") -> None:
        """Flip the valid bit of every row of a tombstoned chunk."""
        if not store.deleted_chunks:
            self._synced_deleted = 0
            return
        deleted = store.deleted_chunks
        chunk_alive = np.fromiter(
            (cid not in deleted for cid in self.chunk_ids), dtype=np.bool_, count=len(self.chunk_ids)
        )
        new_valid = chunk_alive[self.row_chunk]
        if not np.array_equal(new_valid, self._host_valid[: self.num_rows]):
            self._host_valid[: self.num_rows] = new_valid
            self._valid_dirty = True
            self._bump()
        self._synced_deleted = len(deleted)

    def sync(self, store: "Store") -> None:
        """Incremental append when the store only grew; mask update on
        deletes; full rebuild after a compaction.  Thread-safe."""
        if self._synced_version == store.version and self._synced_generation == store.generation:
            return
        with self._sync_lock:
            self._sync_locked(store)

    def _sync_locked(self, store: "Store") -> None:
        if self._synced_version == store.version and self._synced_generation == store.generation:
            return
        n_known = len(self.chunk_ids)
        if (
            self._synced_generation == store.generation
            and len(store.chunk_order) >= n_known
            and store.chunk_order[:n_known] == self.chunk_ids
        ):
            new_ids = store.chunk_order[n_known:]
            if new_ids:
                self.append_chunks([store.embeddings[cid] for cid in new_ids], new_ids)
            if len(store.deleted_chunks) != self._synced_deleted:
                self._apply_tombstones(store)
        else:
            self.rebuild(store)
        self._synced_version = store.version
        self._synced_generation = store.generation

    # --- Device copies ----------------------------------------------------

    def _refresh_device(self) -> None:
        if self._rows is not None and not self._dirty:
            if self._dev_rows_synced != self.num_rows:
                self._append_to_device()
            if self._valid_dirty:
                self._upload_valid()
            return
        self._full_upload()

    def _upload_valid(self) -> None:
        """Re-ship only the tombstone mask: deletes never re-upload rows."""
        c = self.shard_rows
        self._valid = [
            torch.from_numpy(self._host_valid[s * c : (s + 1) * c].copy()).to(dev)
            for s, dev in enumerate(self.devices)
        ]
        self._valid_dirty = False
        self._bump()

    def _device_rows(self, host_f16: np.ndarray, device: torch.device):
        """(rows in the storage dtype, int8 scales or None, sqnorm) on
        ``device`` for a block of host rows."""
        x = torch.from_numpy(np.ascontiguousarray(host_f16)).to(device).to(torch.float32)
        if self._dtype == torch.int8:
            rows, scale = quantize_rows_int8(x)
            deq = rows.to(torch.float32) * scale[:, None]
            return rows, scale, (deq * deq).sum(dim=1)
        return x.to(self._dtype), None, (x * x).sum(dim=1)

    def _append_to_device(self) -> None:
        """Write only the rows appended since the last sync, in place into
        the preallocated device arrays of the shards that own them (the JAX
        package rebuilds them with ``dynamic_update_slice``)."""
        start, end = self._dev_rows_synced, self.num_rows
        c = self.shard_rows
        for s, dev in enumerate(self.devices):
            lo, hi = max(start, s * c), min(end, (s + 1) * c)
            if lo >= hi:
                continue
            rows, scale, sqnorm = self._device_rows(self._host_rows[lo:hi], dev)
            a, b = lo - s * c, hi - s * c
            self._rows[s][a:b] = rows
            self._sqnorm[s][a:b] = sqnorm
            if scale is not None:
                self._scale[s][a:b] = scale
            self._valid[s][a:b] = torch.from_numpy(self._host_valid[lo:hi]).to(dev)
        self._dev_row_chunk[start:end] = torch.from_numpy(self.row_chunk[start:end]).to(self.device)
        self._dev_rows_synced = end
        self._packed4 = None  # the stage-1 copy is stale; rebuilt lazily
        self._bump()

    def _full_upload(self) -> None:
        c = self.shard_rows
        shards = [self._device_rows(self._host_rows[s * c : (s + 1) * c], dev) for s, dev in enumerate(self.devices)]
        self._rows = [r for r, _, _ in shards]
        self._scale = [sc for _, sc, _ in shards] if self._dtype == torch.int8 else None
        self._sqnorm = [q for _, _, q in shards]
        row_chunk = np.full((self.capacity,), -1, dtype=np.int64)
        row_chunk[: len(self.row_chunk)] = self.row_chunk
        self._dev_row_chunk = torch.from_numpy(row_chunk).to(self.device)
        self._upload_valid()
        self._dirty = False
        self._dev_rows_synced = self.num_rows
        self._packed4 = None
        self._bump()

    def _ensure_packed4(self) -> None:
        """Build the int4-packed stage-1 copy of every shard from its device
        rows (one elementwise pass; +d/2 bytes per row of device memory)."""
        if self._packed4 is not None:
            return
        packed4, scale4 = [], []
        for s in range(self.num_devices):
            packed, sc4 = pack_rows_int4(self._rows[s], None if self._scale is None else self._scale[s])
            target = _round_up(packed.shape[0], INT4_NUM_BUCKETS)
            if target != packed.shape[0]:  # single-device from_device_arrays
                pad = target - packed.shape[0]
                packed = torch.cat([packed, packed.new_zeros((pad, packed.shape[1]))])
                sc4 = torch.cat([sc4, sc4.new_ones(pad)])
            packed4.append(packed.contiguous())
            scale4.append(sc4.contiguous())
        self._packed4, self._scale4 = packed4, scale4
        self._bump()

    # --- Search -----------------------------------------------------------

    def _adapter_device(self, adapter: np.ndarray | torch.Tensor | None) -> torch.Tensor | None:
        """Device copy of the query adapter, re-made only when the given
        object changes (compared with ``is``; a new one bumps the
        generation)."""
        if adapter is None:
            return None
        cached = self._adapter
        if cached is None or cached[0] is not adapter:
            dev = (
                adapter.to(self.device) if isinstance(adapter, torch.Tensor)
                else torch.as_tensor(np.asarray(adapter, dtype=np.float32), device=self.device)
            )
            cached = (adapter, dev)
            self._adapter = cached
            self._bump()
        return cached[1]

    def _row_mask_full(self, row_mask: np.ndarray | torch.Tensor | None) -> torch.Tensor | None:
        """A row filter mask padded to the capacity, [capacity] bool on the
        first device, cached by content digest (up to 4 entries)."""
        if row_mask is None:
            return None
        if isinstance(row_mask, torch.Tensor):
            return row_mask.to(self.device)
        mask_np = np.asarray(row_mask, dtype=np.bool_)
        key = (hashlib.blake2b(mask_np.tobytes(), digest_size=16).digest(), len(mask_np), self.capacity)
        hit = self._row_mask_cache.get(key)
        if hit is not None:
            return hit
        padded = np.zeros((self.capacity,), dtype=np.bool_)
        padded[: len(mask_np)] = mask_np
        dev = torch.from_numpy(padded).to(self.device)
        if len(self._row_mask_cache) >= 4:
            self._row_mask_cache.pop(next(iter(self._row_mask_cache)))
        self._row_mask_cache[key] = dev
        return dev

    def _valid_shards(self, valid: list[torch.Tensor], mask: torch.Tensor | None) -> list[torch.Tensor]:
        """Each shard's valid mask, ANDed with a [capacity] row filter
        (:meth:`_row_mask_full`) split like the rows."""
        if mask is None:
            return valid
        return [v & m.to(v.device) for v, m in zip(valid, mask.split(self.shard_rows))]

    def _queries(self, queries, adapter=None) -> torch.Tensor:
        """The queries on the first device, the adapter applied."""
        queries_dev = torch.as_tensor(np.asarray(queries, dtype=np.float32), device=self.device)
        return _adapted(queries_dev, self._adapter_device(adapter))

    def search(
        self,
        queries: np.ndarray,
        *,
        num_hits: int,
        row_mask: np.ndarray | None = None,
        adapter: np.ndarray | None = None,
        exact: bool | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top ``num_hits`` sub-vector rows per query: (scores [B, K],
        row ids [B, K]); masked rows score -inf.  ``exact=True`` bypasses
        the single-stage kernel."""
        if self.num_rows == 0:
            b = queries.shape[0]
            return (np.full((b, num_hits), -np.inf), np.zeros((b, num_hits), dtype=np.int64))
        scores, idx = self._scan_device(
            queries, num_hits=num_hits, row_mask=row_mask, adapter=adapter, exact=exact
        )
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy().astype(np.int64)
        if scores.shape[1] < num_hits:
            pad = num_hits - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)))
        return scores, idx

    def _scan_device(
        self, queries, *, num_hits: int, row_mask, adapter, exact: bool | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Scan returning device tensors (scores [B, K], row ids [B, K]):
        the single-stage kernel on one device, else each shard's exact scan
        (the JAX package's sharded route ignores ``exact`` too)."""
        with self._sync_lock:  # the device arrays stay this generation's until the scan is enqueued
            self._refresh_device()
            queries_dev = self._queries(queries, adapter)
            valid = self._valid_shards(self._valid, self._row_mask_full(row_mask))
            k = min(num_hits, self.capacity)
            if self._route(queries.shape[0], exact, int4=False) == "fused_scan":
                self.last_route = "fused_scan"
                return fused_scan_topk(
                    self._rows[0], self._sqnorm[0], valid[0], queries_dev,
                    num_hits=k, metric=self.metric, row_scale=None if self._scale is None else self._scale[0],
                )
            self.last_route = "dense"
            return sharded_topk_search(
                self._rows, self._sqnorm, valid, queries_dev, self._scale,
                num_hits=k, metric=self.metric, devices=self.devices,
            )

    def search_chunks(
        self,
        queries: np.ndarray,
        *,
        num_hits: int,
        num_results: int,
        row_mask: np.ndarray | None = None,
        adapter: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top ``num_results`` chunks per query, one host fetch:
        (chunk_scores [B, R] f32, chunk_ordinals [B, R] int64); slots past
        the last real hit have score -inf and ordinal -1."""
        b = queries.shape[0]
        if self.num_rows == 0:
            return (
                np.full((b, num_results), -np.inf, dtype=np.float32),
                np.full((b, num_results), -1, dtype=np.int64),
            )
        scores, ordinals = self.search_chunks_device(
            queries, num_hits=num_hits, num_results=num_results, row_mask=row_mask, adapter=adapter
        )
        chunk_scores, chunk_ordinals = fetch_scored(scores, ordinals)
        chunk_ordinals[~np.isfinite(chunk_scores)] = -1
        if chunk_scores.shape[1] < num_results:
            pad = num_results - chunk_scores.shape[1]
            chunk_scores = np.pad(chunk_scores, ((0, 0), (0, pad)), constant_values=-np.inf)
            chunk_ordinals = np.pad(chunk_ordinals, ((0, 0), (0, pad)), constant_values=-1)
        return chunk_scores, chunk_ordinals

    def search_chunks_device(
        self,
        queries,
        *,
        num_hits: int,
        num_results: int,
        row_mask: np.ndarray | None = None,
        adapter: np.ndarray | None = None,
        exact: bool | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device half of :meth:`search_chunks`: (scores [B, R], ordinals
        [B, R] int64) left on the device, copies the caller may keep.
        Routes as the module docstring says, records the route in
        ``last_route``, and runs the route's program (from its graph on
        one card)."""
        if isinstance(queries, torch.Tensor):
            queries = queries.to(torch.float32)
        else:
            queries = np.asarray(queries, dtype=np.float32)
        batch = queries.shape[0]
        # Under the sync lock from the refresh to the enqueued program: the
        # arrays a program closes over and the generation in its key are
        # one generation's, and no bump frees them while it is captured or
        # replayed (the entry then keeps them alive, utils/graphs.py).
        with self._sync_lock:
            route = self._route(batch, exact)
            self._refresh_device()
            if route == "int4_two_stage":
                self._ensure_packed4()
            self.last_route = route
            hits = min(num_hits, self.capacity)
            adapter_dev = self._adapter_device(adapter)
            mask = self._row_mask_full(row_mask)
            program = self._chunks_program(route, num_hits=hits, num_results=num_results, adapter=adapter_dev)
            key = (route, batch, hits, num_results, mask is not None, adapter_dev is not None, self.generation)
            inputs = (queries,) if mask is None else (queries, mask)
            return self.programs(key, program, *inputs)

    def _route(self, batch: int, exact: bool | None, *, int4: bool = True) -> str:
        """The module docstring's routing (``int4`` False: a row search,
        which never takes the two-stage route)."""
        if exact is None:
            exact = self.num_rows <= EXACT_TOPK_MAX_ROWS
        if int4 and self._use_int4_stage1(batch, exact):
            return "int4_two_stage"
        if self.num_devices == 1 and not exact and self._use_fused_kernel(batch):
            return "fused_scan"
        return "dense"

    def _chunks_program(self, route: str, *, num_hits: int, num_results: int, adapter: torch.Tensor | None):
        """The route's program over this generation's device arrays:
        ``(queries [B, d] f32[, row mask [capacity] bool]) -> (scores,
        ordinals)``."""
        rows, sqnorm, valid, scale, row_chunk = self._rows, self._sqnorm, self._valid, self._scale, self._dev_row_chunk
        packed4, scale4, devices, metric = self._packed4, self._scale4, self.devices, self.metric

        def program(queries: torch.Tensor, mask: torch.Tensor | None = None):
            v = self._valid_shards(valid, mask)
            if route == "int4_two_stage":
                return int4_two_stage_chunks(
                    packed4, scale4, rows, scale, sqnorm, v, row_chunk, queries, adapter,
                    num_hits=num_hits, num_results=num_results, metric=metric, devices=devices,
                    # The rescore pool always covers the hits with headroom.
                    candidates=max(INT4_STAGE1_CANDIDATES, 2 * num_hits),
                )
            if route == "fused_scan":
                return fused_scan_chunks(
                    rows[0], sqnorm[0], v[0], row_chunk, queries, None if scale is None else scale[0], adapter,
                    num_hits=num_hits, num_results=num_results, metric=metric,
                )
            return dense_search_chunks(
                rows, sqnorm, v, row_chunk, queries, scale, adapter,
                num_hits=num_hits, num_results=num_results, metric=metric, devices=devices,
            )

        return program

    @classmethod
    def from_device_arrays(
        cls,
        rows: torch.Tensor,  # [N, d] storage dtype, already on the device
        row_chunk: torch.Tensor,  # [N] row -> chunk ordinal
        *,
        row_scale: torch.Tensor | None = None,  # [N] f32 (int8 rows)
        metric: DistanceMetric = "cosine",
        num_devices: int = 1,
    ) -> "DenseIndex":
        """Search-only index over device-resident arrays (no host mirror of
        the rows), for embeddings produced on the device that must not
        round-trip through host memory.  With ``num_devices > 1`` the arrays
        split into that many equal row shards (``index_devices`` of the rows'
        device; a shard on that device is a view).  A single-device int4
        stage's packed copy pads to a multiple of INT4_NUM_BUCKETS
        (``_ensure_packed4``); a sharded one takes the int4 route only when
        every shard holds whole buckets.  Mutation and :meth:`save` need the
        host mirror and are unsupported here."""
        n, dim = rows.shape
        index = cls(
            dim=dim, dtype=_DTYPE_NAMES[rows.dtype], metric=metric, num_devices=num_devices, device=rows.device,
        )
        index.num_rows = index.capacity = n
        if metric == "l2":
            deq = rows.to(torch.float32)
            if row_scale is not None:
                deq = deq * row_scale[:, None]
            sqnorm = (deq * deq).sum(dim=1)
        else:
            sqnorm = torch.zeros((n,), dtype=torch.float32, device=rows.device)
        valid = torch.ones((n,), dtype=torch.bool, device=rows.device)
        index._rows, index._sqnorm, index._valid = (split_rows(x, index.devices) for x in (rows, sqnorm, valid))
        index._scale = None if row_scale is None else split_rows(row_scale, index.devices)
        index._dev_row_chunk = row_chunk.to(device=index.device, dtype=torch.int64)
        # The host mirror of the row -> chunk map: metadata filters build
        # their row masks from it (an empty map would turn every filtered
        # search into an empty one).
        index.row_chunk = row_chunk.cpu().numpy().astype(np.int64)
        index._host_rows = None  # no host mirror
        index.chunk_ids = []
        index._dirty = False
        index._dev_rows_synced = n
        index._bump()
        return index

    # --- Checkpoint / resume ----------------------------------------------

    def save(self, path: str) -> None:
        """Persist the index (host mirror + manifest) so a reload skips
        re-embedding.  The layout is the JAX package's: ``manifest.json``,
        ``rows.npy`` (the f16 host mirror), ``valid.npy``, ``row_chunk.npy``;
        an index saved by either package loads in the other."""
        import json
        from pathlib import Path

        if self._host_rows is None:
            msg = "an index built from device arrays has no host mirror to save"
            raise ValueError(msg)
        root = Path(path)
        root.mkdir(parents=True, exist_ok=True)
        np.save(root / "rows.npy", self._host_rows[: self.num_rows])
        np.save(root / "valid.npy", self._host_valid[: self.num_rows])
        np.save(root / "row_chunk.npy", self.row_chunk)
        (root / "manifest.json").write_text(
            json.dumps(
                {
                    "dim": self.dim,
                    "metric": self.metric,
                    "dtype": _DTYPE_NAMES[self._dtype],
                    "num_rows": self.num_rows,
                    "num_devices": self.num_devices,
                    "chunk_ids": self.chunk_ids,
                }
            )
        )

    @classmethod
    def load(
        cls, path: str, *, num_devices: int | None = None, device: torch.device | str = "cuda"
    ) -> "DenseIndex":
        """Load an index written by :meth:`save` (or the JAX package's) onto
        ``device``, in ``num_devices`` row shards (default: the saved
        count); the device copy is uploaded at the first search."""
        import json
        from pathlib import Path

        root = Path(path)
        manifest = json.loads((root / "manifest.json").read_text())
        index = cls(
            dim=manifest["dim"],
            dtype=manifest["dtype"],
            metric=manifest["metric"],
            num_devices=num_devices if num_devices is not None else manifest["num_devices"],
            device=device,
        )
        rows = np.load(root / "rows.npy")
        valid = np.load(root / "valid.npy")
        index._ensure_capacity(rows.shape[0])
        index._host_rows[: rows.shape[0]] = rows
        index._host_valid[: valid.shape[0]] = valid
        index.num_rows = int(manifest["num_rows"])
        index.row_chunk = np.load(root / "row_chunk.npy").astype(np.int64)
        index.chunk_ids = list(manifest["chunk_ids"])
        index._dirty = True
        index._bump()
        return index

    def _use_int4_stage1(self, batch: int, exact: bool) -> bool:
        """Two-stage int4 routing: small batches on large indexes on CUDA
        (the kernel is the point: half the bytes of the int8 scan);
        ``exact=True`` bypasses it.  A sharded index takes the sharded
        variant (parallel/sharded.py)."""
        return (
            self.use_int4_stage1
            and not exact
            and batch <= 32
            and self.dim % 256 == 0
            and self.device.type == "cuda"
            and self.num_rows > EXACT_TOPK_MAX_ROWS
            # Only a sharded index needs whole buckets per shard: a single
            # device pads its packed copy.
            and (self.num_devices == 1 or self.capacity % (INT4_NUM_BUCKETS * self.num_devices) == 0)
        )

    def _use_fused_kernel(self, batch: int) -> bool:
        """The single-stage CUDA scan for small batches on large indexes."""
        return (
            self.use_pallas
            and batch <= 32
            and self.device.type == "cuda"
            and self.num_rows >= 16 * DEFAULT_NUM_BUCKETS
        )

    def rows_for_chunk(self, chunk_ordinal: int) -> np.ndarray:
        return np.flatnonzero(self.row_chunk == chunk_ordinal)


@lru_cache(maxsize=8)
def _index_for_store(
    store_path: str, dim: int, dtype: str, metric: str, num_devices: int,
    use_pallas: bool, use_int4_stage1: bool, device: str,
) -> DenseIndex:
    return DenseIndex(
        dim=dim, dtype=dtype, metric=metric, num_devices=num_devices,
        use_pallas=use_pallas, use_int4_stage1=use_int4_stage1, device=device,
    )


def dense_index_from_config(config: "RAGLiteConfig") -> DenseIndex:
    """Cached device index per (store, embedder geometry, device), synced."""
    from raglite_tpu_torch.models.encoder import embedding_dim
    from raglite_tpu_torch.store import store_from_config

    index = _index_for_store(
        config.store_path,
        embedding_dim(config),
        config.embedding_dtype,
        config.vector_search_distance_metric,
        config.num_devices,
        config.use_pallas,
        config.use_int4_stage1,
        str(config.torch_device()),
    )
    index.sync(store_from_config(config))
    return index
