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
Multi-device sharding is not ported yet (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import hashlib
import threading
from functools import lru_cache
from typing import TYPE_CHECKING

import numpy as np
import torch

from raglite_tpu_torch.ops.fused_scan import (
    DEFAULT_NUM_BUCKETS,
    INT4_NUM_BUCKETS,
    INT4_STAGE1_CANDIDATES,
    _topk_stable,
    full_f32_matmul,
    fused_scan_topk,
    int4_two_stage_block,
    pack_rows_int4,
    quantize_rows_int8,
)
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


def _dense_search_chunks_fused(
    rows, row_sqnorm, valid, row_chunk, queries, row_scale=None, adapter=None,
    *, num_hits: int, num_results: int, metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Small-batch path: adapter matmul + exact scan + group-max."""
    if adapter is not None:
        queries = queries @ adapter.T
    scores, idx = _dense_search(
        rows, row_sqnorm, valid, queries, row_scale, num_hits=num_hits, metric=metric
    )
    return _group_max_topk(scores, idx, row_chunk, num_results=num_results)


def _int4_two_stage_chunks(
    packed: torch.Tensor,  # [Np, d//2] int4-packed rows
    scale4: torch.Tensor,  # [Np] f32
    rows: torch.Tensor,  # [Np, d] full-precision rows for the rescore
    row_scale: torch.Tensor | None,
    row_sqnorm: torch.Tensor,
    valid: torch.Tensor,
    row_chunk: torch.Tensor,
    queries: torch.Tensor,  # [B, d] f32
    adapter: torch.Tensor | None = None,
    *,
    num_hits: int,
    num_results: int,
    candidates: int,
    metric: str,
    num_buckets: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage path: int4 scan over the packed copy -> top-``candidates``
    -> exact rescore against the full rows -> multi-vector group-max."""
    if adapter is not None:
        queries = queries @ adapter.T
    sc, ridx = int4_two_stage_block(
        packed, scale4, rows, row_scale, row_sqnorm, valid, queries,
        num_hits=num_hits, candidates=candidates, metric=metric, num_buckets=num_buckets,
    )
    return _group_max_topk(sc, ridx, row_chunk, num_results=num_results)


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
        if num_devices != 1:
            msg = "multi-GPU indexes are ROADMAP queue 1 item 10"
            raise NotImplementedError(msg)
        self.dim = dim
        self.metric: DistanceMetric = metric
        self._dtype = _DTYPES[dtype]
        self.use_pallas = use_pallas
        self.use_int4_stage1 = use_int4_stage1
        self.device = torch.device(device)
        self.num_devices = 1
        self.num_rows = 0
        self.capacity = 0
        # Host mirror (canonical).
        self._host_rows = np.zeros((0, dim), dtype=np.float16)
        self._host_valid = np.zeros((0,), dtype=np.bool_)
        self.row_chunk = np.zeros((0,), dtype=np.int64)
        self.chunk_ids: list[str] = []
        # Device copies.
        self._dev_rows: torch.Tensor | None = None
        self._dev_sqnorm: torch.Tensor | None = None
        self._dev_valid: torch.Tensor | None = None
        self._dev_scale: torch.Tensor | None = None  # int8 dequant scales
        self._dev_row_chunk: torch.Tensor | None = None
        self._dev_packed4: torch.Tensor | None = None  # int4 stage-1 copy
        self._dev_scale4: torch.Tensor | None = None
        self._dirty = True  # full upload required
        self._valid_dirty = False
        self._dev_rows_synced = 0
        self._synced_version = -1
        self._synced_generation = 0
        self._synced_deleted = 0
        self._adapter_host: np.ndarray | None = None
        self._adapter_dev: torch.Tensor | None = None
        self._row_mask_cache: dict = {}
        #: Which route served the last search: "int4_two_stage",
        #: "fused_scan" (single-stage kernel) or "dense" (plain exact scan).
        self.last_route: str | None = None
        #: Serializes sync() against concurrent server threads.
        self._sync_lock = threading.Lock()

    # --- Build / mutate (host mirror) ------------------------------------

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        self._dirty = True
        # A multiple of the int4 bucket count, so no scan ever pads.
        new_cap = _round_up(max(needed, 2 * max(self.capacity, 1)), INT4_NUM_BUCKETS)
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
        if self._dev_rows is not None and not self._dirty:
            if self._dev_rows_synced != self.num_rows:
                self._append_to_device()
            if self._valid_dirty:
                self._upload_valid()
            return
        self._full_upload()

    def _upload_valid(self) -> None:
        """Re-ship only the tombstone mask: deletes never re-upload rows."""
        self._dev_valid = torch.from_numpy(self._host_valid.copy()).to(self.device)
        self._valid_dirty = False

    def _device_rows(self, host_f16: np.ndarray):
        """(rows in the storage dtype, int8 scales or None, sqnorm) on the
        device for a block of host rows."""
        x = torch.from_numpy(np.ascontiguousarray(host_f16)).to(self.device).to(torch.float32)
        if self._dtype == torch.int8:
            rows, scale = quantize_rows_int8(x)
            deq = rows.to(torch.float32) * scale[:, None]
            return rows, scale, (deq * deq).sum(dim=1)
        return x.to(self._dtype), None, (x * x).sum(dim=1)

    def _append_to_device(self) -> None:
        """Write only the rows appended since the last sync, in place into
        the preallocated device arrays (the JAX package rebuilds them with
        ``dynamic_update_slice``)."""
        start, end = self._dev_rows_synced, self.num_rows
        rows, scale, sqnorm = self._device_rows(self._host_rows[start:end])
        self._dev_rows[start:end] = rows
        self._dev_sqnorm[start:end] = sqnorm
        if scale is not None:
            self._dev_scale[start:end] = scale
        self._dev_valid[start:end] = torch.from_numpy(self._host_valid[start:end]).to(self.device)
        self._dev_row_chunk[start:end] = torch.from_numpy(self.row_chunk[start:end]).to(self.device)
        self._dev_rows_synced = end
        self._dev_packed4 = None  # the stage-1 copy is stale; rebuilt lazily

    def _full_upload(self) -> None:
        self._dev_rows, self._dev_scale, self._dev_sqnorm = self._device_rows(self._host_rows)
        row_chunk = np.full((self.capacity,), -1, dtype=np.int64)
        row_chunk[: len(self.row_chunk)] = self.row_chunk
        self._dev_row_chunk = torch.from_numpy(row_chunk).to(self.device)
        self._upload_valid()
        self._dirty = False
        self._dev_rows_synced = self.num_rows
        self._dev_packed4 = None

    def _ensure_packed4(self) -> None:
        """Build the int4-packed stage-1 copy from the device rows (one
        elementwise pass; +d/2 bytes per row of device memory)."""
        if self._dev_packed4 is None:
            packed, scale4 = pack_rows_int4(self._dev_rows, self._dev_scale)
            target = _round_up(packed.shape[0], INT4_NUM_BUCKETS)
            if target != packed.shape[0]:
                pad = target - packed.shape[0]
                packed = torch.cat([packed, packed.new_zeros((pad, packed.shape[1]))])
                scale4 = torch.cat([scale4, scale4.new_ones(pad)])
            self._dev_packed4, self._dev_scale4 = packed.contiguous(), scale4.contiguous()

    # --- Search -----------------------------------------------------------

    def _adapter_device(self, adapter: np.ndarray | None) -> torch.Tensor | None:
        """Device copy of the query adapter, re-uploaded only when the host
        object changes (compared with ``is``)."""
        if adapter is None:
            return None
        if isinstance(adapter, torch.Tensor):
            return adapter.to(self.device)
        if self._adapter_host is not adapter:
            self._adapter_host = adapter
            self._adapter_dev = torch.as_tensor(
                np.asarray(adapter, dtype=np.float32), device=self.device
            )
        return self._adapter_dev

    def device_row_mask(self, row_mask: np.ndarray | None) -> torch.Tensor | None:
        """Capacity-padded device copy of a row filter mask, cached by
        content digest (up to 4 entries)."""
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

    def _valid_with(self, row_mask) -> torch.Tensor:
        valid = self._dev_valid
        if row_mask is not None:
            valid = valid & self.device_row_mask(row_mask)
        return valid

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(np.asarray(queries, dtype=np.float32), device=self.device)

    def search(
        self,
        queries: np.ndarray,
        *,
        num_hits: int,
        row_mask: np.ndarray | None = None,
        adapter: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top ``num_hits`` sub-vector rows per query: (scores [B, K],
        row ids [B, K]); masked rows score -inf."""
        if self.num_rows == 0:
            b = queries.shape[0]
            return (np.full((b, num_hits), -np.inf), np.zeros((b, num_hits), dtype=np.int64))
        scores, idx = self._scan_device(queries, num_hits=num_hits, row_mask=row_mask, adapter=adapter)
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
        """Scan returning device tensors (scores [B, K], row ids [B, K])."""
        self._refresh_device()
        queries_dev = self._queries(queries)
        adapter_dev = self._adapter_device(adapter)
        if adapter_dev is not None:
            queries_dev = queries_dev @ adapter_dev.T
        valid = self._valid_with(row_mask)
        k = min(num_hits, self.capacity)
        if exact is None:
            exact = self.num_rows <= EXACT_TOPK_MAX_ROWS
        if not exact and self._use_fused_kernel(queries.shape[0]):
            self.last_route = "fused_scan"
            return fused_scan_topk(
                self._dev_rows, self._dev_sqnorm, valid, queries_dev,
                num_hits=k, metric=self.metric, row_scale=self._dev_scale,
            )
        self.last_route = "dense"
        return _dense_search(
            self._dev_rows, self._dev_sqnorm, valid, queries_dev, self._dev_scale,
            num_hits=k, metric=self.metric,
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
            return _int4_two_stage_chunks(
                self._dev_packed4, self._dev_scale4, self._dev_rows, self._dev_scale,
                self._dev_sqnorm, self._valid_with(row_mask), self._dev_row_chunk,
                self._queries(queries), self._adapter_device(adapter),
                num_hits=hits,
                num_results=num_results,
                # The rescore pool always covers the hits with headroom.
                candidates=max(INT4_STAGE1_CANDIDATES, 2 * hits),
                metric=self.metric,
                num_buckets=INT4_NUM_BUCKETS,
            )
        if batch <= 32 and not (not exact_resolved and self._use_fused_kernel(batch)):
            self._refresh_device()
            self.last_route = "dense"
            return _dense_search_chunks_fused(
                self._dev_rows, self._dev_sqnorm, self._valid_with(row_mask),
                self._dev_row_chunk, self._queries(queries), self._dev_scale,
                self._adapter_device(adapter),
                num_hits=min(num_hits, self.capacity), num_results=num_results, metric=self.metric,
            )
        scores, idx = self._scan_device(
            queries, num_hits=num_hits, row_mask=row_mask, adapter=adapter, exact=exact
        )
        return _group_max_topk(scores, idx, self._dev_row_chunk, num_results=num_results)

    def _use_int4_stage1(self, batch: int, exact: bool) -> bool:
        """Two-stage int4 routing: small batches on large indexes on CUDA
        (the kernel is the point: half the bytes of the int8 scan);
        ``exact=True`` bypasses it."""
        return (
            self.use_int4_stage1
            and not exact
            and batch <= 32
            and self.dim % 256 == 0
            and self.device.type == "cuda"
            and self.num_rows > EXACT_TOPK_MAX_ROWS
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
