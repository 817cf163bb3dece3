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
    full_f32_matmul,
    fused_scan_topk,
    pack_rows_int4,
    quantize_rows_int8,
)
from raglite_tpu_torch.parallel.mesh import index_devices, split_rows
from raglite_tpu_torch.parallel.sharded import sharded_int4_two_stage, sharded_topk_search
from raglite_tpu_torch.types import DistanceMetric
from raglite_tpu_torch.utils.padding import round_up as _round_up

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
        #: Serializes sync() against concurrent server threads.
        self._sync_lock = threading.Lock()

    @property
    def shard_rows(self) -> int:
        """Rows per shard (capacity / num_devices)."""
        return self.capacity // self.num_devices

    # --- Build / mutate (host mirror) ------------------------------------

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        self._dirty = True
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

    # --- Search -----------------------------------------------------------

    def _adapter_device(self, adapter: np.ndarray | None) -> torch.Tensor | None:
        """Device copy of the query adapter, re-uploaded only when the host
        object changes (compared with ``is``)."""
        if adapter is None:
            return None
        if isinstance(adapter, torch.Tensor):
            return adapter.to(self.device)
        cached = self._adapter
        if cached is None or cached[0] is not adapter:
            cached = (adapter, torch.as_tensor(np.asarray(adapter, dtype=np.float32), device=self.device))
            self._adapter = cached
        return cached[1]

    def device_row_mask(self, row_mask: np.ndarray | None) -> list[torch.Tensor] | None:
        """Device copies of a row filter mask, padded to the capacity and
        split like the rows (one per shard), cached by content digest (up to
        4 entries)."""
        if row_mask is None:
            return None
        if isinstance(row_mask, torch.Tensor):
            return [m.to(dev) for m, dev in zip(row_mask.split(self.shard_rows), self.devices)]
        mask_np = np.asarray(row_mask, dtype=np.bool_)
        key = (hashlib.blake2b(mask_np.tobytes(), digest_size=16).digest(), len(mask_np), self.capacity)
        hit = self._row_mask_cache.get(key)
        if hit is not None:
            return hit
        padded = np.zeros((self.capacity,), dtype=np.bool_)
        padded[: len(mask_np)] = mask_np
        c = self.shard_rows
        dev = [torch.from_numpy(padded[s * c : (s + 1) * c]).to(d) for s, d in enumerate(self.devices)]
        if len(self._row_mask_cache) >= 4:
            self._row_mask_cache.pop(next(iter(self._row_mask_cache)))
        self._row_mask_cache[key] = dev
        return dev

    def _valid_shards(self, row_mask) -> list[torch.Tensor]:
        """Each shard's valid mask, ANDed with the row filter."""
        if row_mask is None:
            return self._valid
        return [v & m for v, m in zip(self._valid, self.device_row_mask(row_mask))]

    def _queries(self, queries, adapter=None) -> torch.Tensor:
        """The queries on the first device, the adapter applied."""
        queries_dev = torch.as_tensor(np.asarray(queries, dtype=np.float32), device=self.device)
        adapter_dev = self._adapter_device(adapter)
        return queries_dev if adapter_dev is None else queries_dev @ adapter_dev.T

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
        self._refresh_device()
        queries_dev = self._queries(queries, adapter)
        k = min(num_hits, self.capacity)
        if exact is None:
            exact = self.num_rows <= EXACT_TOPK_MAX_ROWS
        if self.num_devices == 1 and not exact and self._use_fused_kernel(queries.shape[0]):
            self.last_route = "fused_scan"
            return fused_scan_topk(
                self._rows[0], self._sqnorm[0], self._valid_shards(row_mask)[0], queries_dev,
                num_hits=k, metric=self.metric, row_scale=None if self._scale is None else self._scale[0],
            )
        self.last_route = "dense"
        return sharded_topk_search(
            self._rows, self._sqnorm, self._valid_shards(row_mask), queries_dev, self._scale,
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
        [B, R] int64) left on the device.  Routes as the module docstring
        says and records the route in ``last_route``."""
        batch = queries.shape[0]
        exact_resolved = self.num_rows <= EXACT_TOPK_MAX_ROWS if exact is None else exact
        if self._use_int4_stage1(batch, exact_resolved):
            self._refresh_device()
            self._ensure_packed4()
            self.last_route = "int4_two_stage"
            hits = min(num_hits, self.capacity)
            # The rescore pool always covers the hits with headroom.
            candidates = max(INT4_STAGE1_CANDIDATES, 2 * hits)
            scores, idx = sharded_int4_two_stage(
                self._packed4, self._scale4, self._rows, self._scale, self._sqnorm,
                self._valid_shards(row_mask), self._queries(queries, adapter),
                num_hits=hits, candidates=candidates, metric=self.metric,
                devices=self.devices, num_buckets=INT4_NUM_BUCKETS,
            )
        else:
            scores, idx = self._scan_device(
                queries, num_hits=num_hits, row_mask=row_mask, adapter=adapter, exact=exact
            )
        # The multi-vector group-max, after the merge, on the first device.
        return _group_max_topk(scores, idx, self._dev_row_chunk, num_results=num_results)

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
