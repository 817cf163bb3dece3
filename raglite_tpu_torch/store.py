"""Host-side document/chunk store.

Replaces the reference's SQL backends (DuckDB / PostgreSQL,
raglite/_database.py:518-646) with an append-only
columnar store designed for the 10M-chunk north star:

- **Append-only chunk log**: ``chunk_order`` only ever grows; deletes mark
  tombstones (``deleted_chunks``) instead of renumbering, so the device
  index maps deletes to an O(1) valid-mask flip rather than a rebuild
  (replacing DuckDB's delete + ``hnsw_compact_index`` + FTS rebuild,
  _delete.py:130-178).  Compaction rewrites the log when the tombstone
  fraction crosses a threshold.
- **Segment persistence**: each ``save()`` appends one segment directory
  (records msgpack + stacked fp16 embeddings ``.npy``) holding only the
  chunks added since the previous save, plus a small rewritten head file
  (documents/metadata/evals/tombstones).  Saving N new chunks is O(N),
  not O(corpus); loading memory-maps the per-segment embedding files so
  resident memory stays bounded.
- **Metadata ordinal postings**: per (field, value) lists of chunk
  ordinals maintained incrementally on insert, so a filtered search
  computes its chunk mask from the postings union/intersection in
  O(matching) instead of an O(corpus) Python scan (the reference plans
  filters inside SQL, _search.py:96-141).

The store is the durable checkpoint (the reference treats its database the
same way, SURVEY §5.4); device indexes (index/dense.py, index/keyword.py)
rebuild or incrementally sync from it.

Concurrency mirrors the reference: an ``lru_cache``d store per path
(_database.py:518), and a ``FileLock`` serializing cross-process writers
(_insert.py:213-219).
"""

from __future__ import annotations

import json
import shutil
from dataclasses import asdict
from functools import lru_cache
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np

from raglite_tpu_torch.documents import Chunk, Document, Eval
from raglite_tpu_torch.types import ChunkId, DocumentId

if TYPE_CHECKING:
    from raglite_tpu_torch.config import RAGLiteConfig

_FORMAT_VERSION = 3


def _msgpack():
    """msgpack, imported only by the persistence code: a ":memory:" store
    never needs it."""
    import msgpack

    return msgpack

#: Compact the chunk log when tombstones exceed this fraction of it.
COMPACTION_TOMBSTONE_FRACTION = 0.5


class _Segment:
    """Lazy random access to one on-disk segment (format v3).

    v3 segments add sidecars beside the embeddings so a 10M-chunk store
    opens without decoding a single chunk record (VERDICT r2 task #7):

    - ``records.msgpack``   concatenated INDIVIDUALLY-packed records
    - ``records.idx.npy``   int64 byte offsets [n+1] into records.msgpack
    - ``ids.msgpack``       the n chunk ids (for chunk_order)
    - ``aux.msgpack``       {"doc_table": [...], "meta_table": [[k, v], ...]}
    - ``aux.npz``           doc_idx int32[n], chunk_index int32[n],
                            meta_<j> int64[...] local ordinals per meta pair

    Record payloads and embeddings are memory-mapped; decoding happens per
    touched record, so resident memory is O(touched), not O(corpus).
    """

    def __init__(self, seg_dir: Path, start: int) -> None:
        self.dir = seg_dir
        self.start = start  # global ordinal of this segment's first chunk
        self._offsets = np.load(seg_dir / "records.idx.npy", mmap_mode="r")
        self.n = int(self._offsets.shape[0]) - 1
        self._buf: np.memmap | None = None
        self._aux: dict | None = None
        self._aux_npz = None
        self._emb: np.ndarray | None = None
        self._emb_bounds: np.ndarray | None = None

    @staticmethod
    def is_v3(seg_dir: Path) -> bool:
        return (seg_dir / "records.idx.npy").exists()

    def ids(self) -> list[str]:
        return _msgpack().unpackb((self.dir / "ids.msgpack").read_bytes(), raw=False)

    def record(self, local: int) -> dict[str, Any]:
        if self._buf is None:
            self._buf = np.memmap(self.dir / "records.msgpack", dtype=np.uint8, mode="r")
        lo, hi = int(self._offsets[local]), int(self._offsets[local + 1])
        return _msgpack().unpackb(self._buf[lo:hi].tobytes(), raw=False)

    def embedding(self, local: int) -> np.ndarray:
        if self._emb is None:
            self._emb = np.load(self.dir / "embeddings.npy", mmap_mode="r")
            counts = np.load(self.dir / "counts.npy")
            self._emb_bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        lo, hi = int(self._emb_bounds[local]), int(self._emb_bounds[local + 1])
        return self._emb[lo:hi]

    def aux(self) -> tuple[dict, Any]:
        if self._aux is None:
            self._aux = _msgpack().unpackb((self.dir / "aux.msgpack").read_bytes(), raw=False)
            self._aux_npz = np.load(self.dir / "aux.npz", mmap_mode="r")
        return self._aux, self._aux_npz


class _LazyChunks:
    """MutableMapping-shaped chunk-record table: an overlay dict for
    unsaved/absorbed records plus on-demand decodes from v3 segments.
    Deleted ids resolve through ``removed`` (the store's tombstone set).

    Iteration/len decode nothing (ids come from the ordinal map), but
    ``values()``/``items()`` touch every record — hot paths must not call
    them (Store keeps sidecar-driven equivalents)."""

    def __init__(
        self,
        overlay: dict[str, Chunk],
        segments: list[_Segment],
        ordinal_of: dict[str, int],
        removed: set[str],
    ) -> None:
        self.overlay = overlay
        self._segments = segments
        self._starts = [s.start for s in segments]
        self._ordinal_of = ordinal_of
        self.removed = removed

    def _segment_record(self, cid: str) -> dict[str, Any] | None:
        ordinal = self._ordinal_of.get(cid)
        if ordinal is None:
            return None
        import bisect

        i = bisect.bisect_right(self._starts, ordinal) - 1
        if i < 0:
            return None
        seg = self._segments[i]
        local = ordinal - seg.start
        if local >= seg.n:
            return None
        rec = seg.record(local)
        return rec if rec.get("index", -1) >= 0 and rec.get("id") == cid else None

    def __getitem__(self, cid: str) -> Chunk:
        chunk = self.overlay.get(cid)
        if chunk is not None:
            return chunk
        if cid in self.removed:
            raise KeyError(cid)
        rec = self._segment_record(cid)
        if rec is None:
            raise KeyError(cid)
        return Chunk(
            id=rec["id"],
            document_id=rec["document_id"],
            index=rec["index"],
            headings=rec["headings"],
            body=rec["body"],
            metadata_=rec["metadata_"],
        )

    def get(self, cid: str, default: Chunk | None = None) -> Chunk | None:
        try:
            return self[cid]
        except KeyError:
            return default

    def __setitem__(self, cid: str, chunk: Chunk) -> None:
        # NOTE: does not clear a tombstone for the same id — matches the
        # eager dict semantics (tombstones are per-id and independently
        # tracked in store.deleted_chunks).
        self.overlay[cid] = chunk

    def __delitem__(self, cid: str) -> None:
        existed = self.overlay.pop(cid, None) is not None
        if not existed and self._ordinal_of.get(cid) is None:
            raise KeyError(cid)
        self.removed.add(cid)

    def __contains__(self, cid: str) -> bool:
        return self.get(cid) is not None

    def __iter__(self):
        seen = set(self.overlay)
        yield from self.overlay
        for cid in self._ordinal_of:
            if cid not in seen and cid not in self.removed:
                yield cid

    def __len__(self) -> int:
        n = len(self.overlay)
        for cid in self._ordinal_of:
            if cid not in self.overlay and cid not in self.removed:
                n += 1
        return n

    def keys(self):
        return list(self)

    def values(self):
        return [self[cid] for cid in self]

    def items(self):
        return [(cid, self[cid]) for cid in self]

    def pop(self, cid: str, default: Chunk | None = None) -> Chunk | None:
        found = self.get(cid)
        if found is None:
            return default
        del self[cid]
        return found

    def discard(self, cid: str) -> None:
        """Remove without decoding (deletes must not fault records in)."""
        self.overlay.pop(cid, None)
        if cid in self._ordinal_of:
            self.removed.add(cid)


class _LazyEmbeddings:
    """Mapping-shaped embedding table: overlay for unsaved matrices plus
    per-touch views into the segments' memory-mapped fp16 files."""

    def __init__(
        self,
        overlay: dict[str, np.ndarray],
        segments: list[_Segment],
        ordinal_of: dict[str, int],
    ) -> None:
        self.overlay = overlay
        self._segments = segments
        self._starts = [s.start for s in segments]
        self._ordinal_of = ordinal_of

    def __getitem__(self, cid: str) -> np.ndarray:
        matrix = self.overlay.get(cid)
        if matrix is not None:
            return matrix
        ordinal = self._ordinal_of.get(cid)
        if ordinal is None:
            raise KeyError(cid)
        import bisect

        i = bisect.bisect_right(self._starts, ordinal) - 1
        if i < 0:
            raise KeyError(cid)
        seg = self._segments[i]
        local = ordinal - seg.start
        if local >= seg.n:
            raise KeyError(cid)
        return seg.embedding(local)

    def get(self, cid: str, default: np.ndarray | None = None) -> np.ndarray | None:
        try:
            return self[cid]
        except KeyError:
            return default

    def __setitem__(self, cid: str, matrix: np.ndarray) -> None:
        self.overlay[cid] = matrix

    def __contains__(self, cid: str) -> bool:
        return cid in self.overlay or cid in self._ordinal_of

    def __iter__(self):
        seen = set(self.overlay)
        yield from self.overlay
        for cid in self._ordinal_of:
            if cid not in seen:
                yield cid

    def __len__(self) -> int:
        n = len(self.overlay)
        for cid in self._ordinal_of:
            if cid not in self.overlay:
                n += 1
        return n

    def values(self):
        return [self[cid] for cid in self]

    def items(self):
        return [(cid, self[cid]) for cid in self]


class Store:
    """In-memory tables over an append-only chunk log, with optional
    segment-directory persistence."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.persistent = path != ":memory:"
        self.documents: dict[DocumentId, Document] = {}
        self.chunks: dict[ChunkId, Chunk] = {}
        #: Chunk ids in insertion order — append-only; this IS the device
        #: index row-group order.  Deletes tombstone, never remove.
        self.chunk_order: list[ChunkId] = []
        #: Tombstoned chunk ids (still present in chunk_order/embeddings
        #: until compaction; masked out of every search).
        self.deleted_chunks: set[ChunkId] = set()
        #: Multi-vector embedding matrix per chunk (np.float16 [m, d];
        #: views into mmap'd segment files after a load).
        self.embeddings: dict[ChunkId, np.ndarray] = {}
        #: Metadata field name -> known values (reference: Metadata table,
        #: _database.py:465-472; drives self-query filter extraction).
        self.metadata: dict[str, list[Any]] = {}
        #: field -> value -> chunk ordinals holding it (powers O(matching)
        #: filtered search instead of an O(corpus) scan).  Split in two so a
        #: lazy open can adopt segment sidecar arrays without decoding
        #: records: `_meta_postings` holds loaded base arrays (np.int64) or
        #: rebuilt lists; `_meta_overlay` collects incremental inserts.
        self._meta_postings: dict[str, dict[Any, Any]] = {}
        self._meta_overlay: dict[str, dict[Any, list[int]]] = {}
        #: v3 lazy-open state (empty when the store is eager/in-memory).
        self._lazy_segments: list[_Segment] = []
        self._ordinal_of: dict[ChunkId, int] = {}
        #: Auxiliary state, e.g. the query adapter (reference: IndexMetadata
        #: table, _database.py:433-462) — persisted WITHOUT pickle.
        self.index_metadata: dict[str, Any] = {}
        self.evals: dict[str, Eval] = {}
        #: Monotonic counter bumped on every mutation; device indexes
        #: compare it to decide when to resync.
        self.version = 0
        #: Monotonic counter bumped on every compaction (device indexes
        #: must full-rebuild when it changes).
        self.generation = 0
        #: Chunks [0:_saved_chunks) are already persisted in segments.
        self._saved_chunks = 0
        #: Segment directory names this store tracks, in chunk-log order.
        #: The head lists exactly these — never whatever happens to be on
        #: disk — so an orphan dir from a crashed save is never adopted.
        self._segments: list[str] = []
        #: Segments superseded by a compaction; deleted only AFTER the next
        #: save has durably written their replacement + head.
        self._stale_segments: list[str] = []
        #: (version, generation, segments) of the on-disk head as of our
        #: last load/save.  save() compares this against the actual head to
        #: detect a concurrent writer (whose segments and tombstones must be
        #: absorbed, not silently orphaned by our head rewrite).
        self._disk_state: tuple[int, int, tuple[str, ...]] = (0, 0, ())
        #: Documents THIS instance deleted — a concurrent-writer absorb must
        #: not re-adopt them (their records live on in the other writer's
        #: stale head until our save lands).
        self._locally_deleted_documents: set[DocumentId] = set()
        if self.persistent:
            Path(path).mkdir(parents=True, exist_ok=True)
            self._load()

    # --- Concurrency ----------------------------------------------------

    def write_lock(self):
        """Cross-process writer lock (reference: _insert.py:213-219)."""
        if self.persistent:
            from filelock import FileLock

            return FileLock(str(Path(self.path) / ".lock"))
        import contextlib

        return contextlib.nullcontext()

    # --- Mutations ------------------------------------------------------

    def add_document(self, document: Document) -> None:
        record = Document(
            id=document.id,
            filename=document.filename,
            url=document.url,
            metadata_=document.metadata_,
            content=None,  # content is never persisted (reference: _database.py:78)
        )
        self.documents[document.id] = record
        self._locally_deleted_documents.discard(document.id)
        self.version += 1

    def _post_metadata(self, ordinal: int, metadata: dict[str, Any]) -> None:
        for key, value in metadata.items():
            values = value if isinstance(value, list) else [value]
            for v in values:
                if isinstance(v, (str, int, float, bool)):
                    self._meta_overlay.setdefault(key, {}).setdefault(v, []).append(ordinal)

    def add_chunks(self, chunks: list[Chunk], embeddings: list[np.ndarray]) -> None:
        for chunk, matrix in zip(chunks, embeddings):
            ordinal = len(self.chunk_order)
            self.chunks[chunk.id] = chunk
            self.chunk_order.append(chunk.id)
            if self._ordinal_of:
                self._ordinal_of[chunk.id] = ordinal
            self.embeddings[chunk.id] = np.asarray(matrix, dtype=np.float16)
            self._post_metadata(ordinal, chunk.metadata_)
        self.version += 1

    def _chunk_ids_for_documents(self, doomed: set[DocumentId]) -> list[ChunkId]:
        """Alive chunk ids belonging to the given documents.  Lazy stores
        answer from the segments' doc-index sidecars (vectorized, no record
        decode); eager stores scan the dict."""
        if isinstance(self.chunks, _LazyChunks):
            out = {
                cid
                for cid, chunk in self.chunks.overlay.items()
                if chunk.document_id in doomed
            }
            for seg in self._lazy_segments:
                aux, npz = seg.aux()
                targets = [i for i, d in enumerate(aux["doc_table"]) if d in doomed]
                if not targets:
                    continue
                hits = np.flatnonzero(
                    np.isin(np.asarray(npz["doc_idx"]), np.asarray(targets, np.int32))
                )
                for local in hits:
                    cid = self.chunk_order[seg.start + int(local)]
                    if cid not in self.deleted_chunks:
                        out.add(cid)
            return sorted(out)
        return [cid for cid, chunk in list(self.chunks.items()) if chunk.document_id in doomed]

    def delete_documents(self, document_ids: list[DocumentId]) -> list[ChunkId]:
        """Tombstone every chunk of the given documents (O(doc chunks), no
        renumbering); compaction reclaims space when tombstones dominate."""
        doomed = set(document_ids)
        removed = self._chunk_ids_for_documents(doomed)
        for cid in removed:
            if isinstance(self.chunks, _LazyChunks):
                self.chunks.discard(cid)  # decode-free tombstone
            else:
                self.chunks.pop(cid, None)
            self.deleted_chunks.add(cid)
        for did in document_ids:
            self.documents.pop(did, None)
            self._locally_deleted_documents.add(did)
        for eid in [e for e, ev in self.evals.items() if ev.document_id in doomed]:
            del self.evals[eid]
        self.version += 1
        if (
            self.chunk_order
            and len(self.deleted_chunks) / len(self.chunk_order) > COMPACTION_TOMBSTONE_FRACTION
        ):
            self.compact()
        return removed

    def compact(self) -> None:
        """Rewrite the chunk log without tombstones (the analogue of the
        reference's ``hnsw_compact_index`` + FTS rebuild postlude).

        A lazily-opened store materializes its records here (compaction is
        inherently O(corpus): every surviving record is rewritten by the
        next save anyway)."""
        alive = [cid for cid in self.chunk_order if cid not in self.deleted_chunks]
        self.chunk_order = alive
        self.embeddings = {cid: np.asarray(self.embeddings[cid]) for cid in alive}
        if isinstance(self.chunks, _LazyChunks):
            self.chunks = {
                cid: chunk
                for cid in alive
                if (chunk := self.chunks.get(cid)) is not None
            }
            self._lazy_segments = []
            self._ordinal_of = {}
        self.deleted_chunks = set()
        self._meta_postings = {}
        self._meta_overlay = {}
        for ordinal, cid in enumerate(alive):
            self._post_metadata(ordinal, self.chunks[cid].metadata_)
        self.generation += 1
        self.version += 1
        # All current segments are superseded, but they stay on disk until
        # the NEXT save() has durably written the compacted replacement and
        # the head that references it — a crash mid-compaction must never
        # lose the only copy of the embeddings.  (In-memory mmap views into
        # the old files stay valid even after unlink on POSIX.)
        self._stale_segments.extend(self._segments)
        self._segments = []
        self._saved_chunks = 0  # next save rewrites the full log

    def update_metadata(self, values: dict[str, set[Any]]) -> None:
        for key, vals in values.items():
            existing = self.metadata.setdefault(key, [])
            for v in vals:
                if v not in existing:
                    existing.append(v)
        self.version += 1

    def prune_metadata(self) -> None:
        """Drop metadata values no remaining document holds
        (reference: _delete.py:67-104; recomputed from the surviving
        documents, so no argument is needed)."""
        remaining: dict[str, set[Any]] = {}
        for doc in self.documents.values():
            for key, value in doc.metadata_.items():
                vals = value if isinstance(value, list) else [value]
                remaining.setdefault(key, set()).update(
                    v for v in vals if isinstance(v, (str, int, float, bool))
                )
        for key in list(self.metadata):
            kept = [v for v in self.metadata[key] if v in remaining.get(key, set())]
            if kept:
                self.metadata[key] = kept
            else:
                del self.metadata[key]
        self.version += 1

    def set_index_metadata(self, key: str, value: Any) -> None:
        self.index_metadata[key] = value
        self.version += 1

    def add_evals(self, evals: list[Eval]) -> None:
        for ev in evals:
            self.evals[ev.id] = ev
        self.version += 1

    # --- Queries --------------------------------------------------------

    def has_document(self, document_id: DocumentId) -> bool:
        return document_id in self.documents

    @property
    def num_alive_chunks(self) -> int:
        return len(self.chunk_order) - len(self.deleted_chunks)

    @property
    def num_embedding_vectors(self) -> int:
        """Total sub-vectors across all chunks.  Lazy stores answer from the
        segments' count files (stats must not materialize 10M views)."""
        if isinstance(self.embeddings, _LazyEmbeddings):
            total = sum(
                int(np.load(seg.dir / "counts.npy").sum()) for seg in self._lazy_segments
            )
            return total + sum(m.shape[0] for m in self.embeddings.overlay.values())
        return sum(m.shape[0] for m in self.embeddings.values())

    def alive_chunk_ids(self) -> list[ChunkId]:
        if not self.deleted_chunks:
            return list(self.chunk_order)
        return [cid for cid in self.chunk_order if cid not in self.deleted_chunks]

    def alive_mask(self) -> np.ndarray | None:
        """Bool mask over chunk ordinals, or None when nothing is deleted
        (cached per store version — searches call this per query)."""
        if not self.deleted_chunks:
            return None
        cached = getattr(self, "_alive_mask_cache", None)
        if cached is not None and cached[0] == self.version:
            return cached[1]
        mask = np.ones(len(self.chunk_order), dtype=np.bool_)
        deleted = self.deleted_chunks
        for i, cid in enumerate(self.chunk_order):
            if cid in deleted:
                mask[i] = False
        self._alive_mask_cache = (self.version, mask)
        return mask

    def get_chunk(self, chunk_id: ChunkId) -> Chunk | None:
        chunk = self.chunks.get(chunk_id)
        if chunk is not None:
            chunk.document = self.documents.get(chunk.document_id)
            chunk._embedding_matrix = self.embeddings.get(chunk_id)
        return chunk

    def neighbor_chunks(self, chunk: Chunk, offsets: tuple[int, ...] = (-1, 1)) -> list[Chunk]:
        """Chunks adjacent by (document_id, index) (reference: _search.py:311-330).

        O(1) per neighbor via a (document_id, index) map cached per store
        version — span retrieval at 10M chunks must not scan the table."""
        cached = getattr(self, "_position_cache", None)
        if cached is None or cached[0] != self.version:
            if isinstance(self.chunks, _LazyChunks):
                # Sidecar-driven build: doc/index arrays, no record decode.
                position = {}
                for seg in self._lazy_segments:
                    aux, npz = seg.aux()
                    doc_table = aux["doc_table"]
                    doc_idx = np.asarray(npz["doc_idx"])
                    chunk_index = np.asarray(npz["chunk_index"])
                    for local in np.flatnonzero(doc_idx >= 0):
                        cid = self.chunk_order[seg.start + int(local)]
                        if cid not in self.deleted_chunks:
                            position[(doc_table[int(doc_idx[local])], int(chunk_index[local]))] = cid
                for cid, c in self.chunks.overlay.items():  # newest wins
                    position[(c.document_id, c.index)] = cid
            else:
                position = {(c.document_id, c.index): cid for cid, c in self.chunks.items()}
            self._position_cache = (self.version, position)
        else:
            position = cached[1]
        out = []
        for off in offsets:
            cid = position.get((chunk.document_id, chunk.index + off))
            if cid is not None:
                found = self.get_chunk(cid)
                if found is not None:
                    out.append(found)
        return out

    def chunk_metadata_matches(self, chunk: Chunk, metadata_filter: dict[str, Any]) -> bool:
        """JSON-containment semantics: every filter key's value (or any of a
        list of values) must appear in the chunk's metadata
        (reference: _search.py:96-141, _delete.py:56-60)."""
        for key, wanted in metadata_filter.items():
            have = chunk.metadata_.get(key)
            have_list = have if isinstance(have, list) else [have]
            wanted_list = wanted if isinstance(wanted, list) else [wanted]
            if not any(w in have_list for w in wanted_list):
                return False
        return True

    def chunk_mask_for_filter(self, metadata_filter: dict[str, Any]) -> np.ndarray:
        """Bool mask over chunk ordinals matching the filter, from the
        incremental metadata postings: O(matching ordinals) per query, vs
        the reference's COUNT-probe SQL filter planning (_search.py:96-141)
        and round 1's O(corpus) Python scan.  Tombstoned chunks are masked.
        Falls back to the slow scan only for unindexable (non-scalar)
        filter values."""
        n = len(self.chunk_order)
        mask: np.ndarray | None = None
        for key, wanted in metadata_filter.items():
            wanted_list = wanted if isinstance(wanted, list) else [wanted]
            if not all(isinstance(w, (str, int, float, bool)) for w in wanted_list):
                return self._chunk_mask_scan(metadata_filter)
            key_mask = np.zeros(n, dtype=np.bool_)
            for postings in (self._meta_postings.get(key, {}), self._meta_overlay.get(key, {})):
                for w in wanted_list:
                    ords = postings.get(w)
                    if ords is not None and len(ords):
                        key_mask[np.asarray(ords, dtype=np.int64)] = True
            mask = key_mask if mask is None else (mask & key_mask)
            if not mask.any():
                return mask
        if mask is None:
            mask = np.ones(n, dtype=np.bool_)
        alive = self.alive_mask()
        if alive is not None:
            mask &= alive
        return mask

    def _chunk_mask_scan(self, metadata_filter: dict[str, Any]) -> np.ndarray:
        mask = np.zeros(len(self.chunk_order), dtype=np.bool_)
        for i, cid in enumerate(self.chunk_order):
            chunk = self.chunks.get(cid)
            mask[i] = chunk is not None and self.chunk_metadata_matches(chunk, metadata_filter)
        return mask

    # --- Persistence ----------------------------------------------------

    def _chunk_record(self, cid: ChunkId) -> dict[str, Any]:
        c = self.chunks.get(cid)
        if c is None:  # tombstoned before ever being saved
            return {"id": cid, "document_id": "", "index": -1, "headings": "",
                    "body": "", "metadata_": {}}
        return {
            "id": c.id,
            "document_id": c.document_id,
            "index": c.index,
            "headings": c.headings,
            "body": c.body,
            "metadata_": c.metadata_,
        }

    def _write_segment_records(self, seg_dir: Path, new_ids: list[ChunkId]) -> None:
        """Write the v3 record stream + lazy-access sidecars (offsets, ids,
        doc/position/meta aux) so a later open touches no record bytes."""
        offsets = [0]
        with open(seg_dir / "records.msgpack", "wb") as fh:
            for cid in new_ids:
                payload = _msgpack().packb(self._chunk_record(cid), use_bin_type=True)
                fh.write(payload)
                offsets.append(offsets[-1] + len(payload))
        np.save(seg_dir / "records.idx.npy", np.asarray(offsets, dtype=np.int64))
        (seg_dir / "ids.msgpack").write_bytes(_msgpack().packb(list(new_ids), use_bin_type=True))
        # Aux sidecars: per-record document + chunk index (drives neighbor/
        # span lookup and delete-by-document) and localized metadata
        # postings (drives filtered search) — all loadable as flat arrays.
        doc_table: list[str] = []
        doc_index: dict[str, int] = {}
        doc_idx = np.full(len(new_ids), -1, dtype=np.int32)
        chunk_index = np.full(len(new_ids), -1, dtype=np.int32)
        meta_locals: dict[tuple[str, Any], list[int]] = {}
        for local, cid in enumerate(new_ids):
            chunk = self.chunks.get(cid)
            if chunk is None:  # tombstoned before ever being saved
                continue
            di = doc_index.get(chunk.document_id)
            if di is None:
                di = doc_index[chunk.document_id] = len(doc_table)
                doc_table.append(chunk.document_id)
            doc_idx[local] = di
            chunk_index[local] = chunk.index
            for key, value in chunk.metadata_.items():
                values = value if isinstance(value, list) else [value]
                for v in values:
                    if isinstance(v, (str, int, float, bool)):
                        meta_locals.setdefault((key, v), []).append(local)
        meta_table = [[k, v] for (k, v) in meta_locals]
        arrays = {
            "doc_idx": doc_idx,
            "chunk_index": chunk_index,
        }
        for j, key in enumerate(meta_locals):
            arrays[f"meta_{j}"] = np.asarray(meta_locals[key], dtype=np.int64)
        (seg_dir / "aux.msgpack").write_bytes(
            _msgpack().packb({"doc_table": doc_table, "meta_table": meta_table}, use_bin_type=True)
        )
        np.savez(seg_dir / "aux.npz", **arrays)

    def save(self) -> None:
        """Append a segment with the not-yet-persisted chunk-log suffix and
        rewrite the (small) head: O(new chunks), not O(corpus).

        Callers hold :meth:`write_lock`; under it, a head that moved since
        our last load/save means another process committed segments our
        in-memory state never saw — absorb them first, or the head rewrite
        would orphan that writer's data (silent cross-process loss)."""
        if not self.persistent:
            return
        root = Path(self.path)
        self.absorb_concurrent()
        new_ids = self.chunk_order[self._saved_chunks :]
        if new_ids:
            seg_name = f"seg-{self.generation:04d}-{self._saved_chunks:010d}"
            seg_dir = root / "segments" / seg_name
            seg_dir.mkdir(parents=True, exist_ok=True)
            self._write_segment_records(seg_dir, new_ids)
            counts = np.asarray(
                [self.embeddings[cid].shape[0] for cid in new_ids], dtype=np.int64
            )
            stacked = np.concatenate(
                [np.asarray(self.embeddings[cid]) for cid in new_ids], axis=0
            )
            np.save(seg_dir / "embeddings.npy", stacked.astype(np.float16))
            np.save(seg_dir / "counts.npy", counts)
            self._saved_chunks = len(self.chunk_order)
            self._segments.append(seg_name)
        head = {
            "format_version": _FORMAT_VERSION,
            "version": self.version,
            "generation": self.generation,
            "documents": [
                {k: v for k, v in asdict(d).items() if k != "content"}
                for d in self.documents.values()
            ],
            "metadata": self.metadata,
            "evals": [asdict(e) for e in self.evals.values()],
            "deleted_chunks": sorted(self.deleted_chunks),
            # Exactly the tracked segments: a crashed save's orphan dir must
            # never be adopted (it would resurrect uncommitted chunks).
            "segments": list(self._segments),
        }
        tmp = root / "head.msgpack.tmp"
        tmp.write_bytes(_msgpack().packb(head, use_bin_type=True))
        tmp.replace(root / "head.msgpack")
        self._disk_state = (self.version, self.generation, tuple(self._segments))
        self._save_index_metadata(root)
        # The head no longer references compaction-superseded segments;
        # NOW they are safe to delete.
        for stale in self._stale_segments:
            stale_dir = root / "segments" / stale
            if stale_dir.exists():
                shutil.rmtree(stale_dir)
        self._stale_segments = []
        # Drop pre-segment (format v1) files once superseded.
        for legacy in ("records.msgpack", "embeddings.npy", "embedding_counts.npy",
                       "manifest.json"):
            legacy_path = root / legacy
            if legacy_path.exists():
                legacy_path.unlink()
        # The head rewrite has durably committed our deletes; forgetting the
        # local tombstones now (a) bounds the set on long-lived instances and
        # (b) lets a later legitimate re-insert of the same document id by
        # ANOTHER process be absorbed instead of silently dropped.
        self._locally_deleted_documents.clear()

    def _load(self) -> None:
        root = Path(self.path)
        if (root / "head.msgpack").exists():
            self._load_segmented(root)
        elif (root / "records.msgpack").exists():
            self._load_legacy_v1(root)
        # What this instance has seen on disk: a later absorb_concurrent()
        # replays the log only if another writer moved the head since.  (The
        # JAX package leaves this unset, so its first write after an open
        # replays the whole log and bumps the generation, which makes every
        # device index rebuild.)
        self._disk_state = (self.version, self.generation, tuple(self._segments))
        self._load_index_metadata(root)
        if self._lazy_segments:
            return  # postings came from the aux sidecars — no record decode
        # Eager open (legacy formats / in-memory): rebuild the metadata
        # postings by scanning records, O(corpus), once per open.
        self._meta_postings = {}
        self._meta_overlay = {}
        for ordinal, cid in enumerate(self.chunk_order):
            chunk = self.chunks.get(cid)
            if chunk is not None:
                self._post_metadata(ordinal, chunk.metadata_)

    @staticmethod
    def _read_segment_records(seg_dir: Path) -> list[dict[str, Any]]:
        """All records of one segment: v3 streams decode via Unpacker, v2
        segments hold one packed list."""
        raw = (seg_dir / "records.msgpack").read_bytes()
        if _Segment.is_v3(seg_dir):
            import io

            return list(_msgpack().Unpacker(io.BytesIO(raw), raw=False))
        return _msgpack().unpackb(raw, raw=False)

    @staticmethod
    def _read_log(
        root: Path, head: dict[str, Any]
    ) -> tuple[list[ChunkId], dict[ChunkId, Chunk], dict[ChunkId, np.ndarray]]:
        """Read the chunk log the head describes: ordered ids, alive chunk
        records, and per-chunk views into memory-mapped embedding files."""
        deleted = set(head.get("deleted_chunks", []))
        order: list[ChunkId] = []
        chunks: dict[ChunkId, Chunk] = {}
        embeddings: dict[ChunkId, np.ndarray] = {}
        for seg_name in head.get("segments", []):
            seg_dir = root / "segments" / seg_name
            records = Store._read_segment_records(seg_dir)
            counts = np.load(seg_dir / "counts.npy")
            # Memory-map the embedding matrix: per-chunk views keep resident
            # memory bounded at 10M-chunk scale.
            stacked = np.load(seg_dir / "embeddings.npy", mmap_mode="r")
            offset = 0
            for rec, m in zip(records, counts):
                cid = rec["id"]
                order.append(cid)
                embeddings[cid] = stacked[offset : offset + int(m)]
                offset += int(m)
                if cid not in deleted and rec["index"] >= 0:
                    chunks[cid] = Chunk(
                        id=cid,
                        document_id=rec["document_id"],
                        index=rec["index"],
                        headings=rec["headings"],
                        body=rec["body"],
                        metadata_=rec["metadata_"],
                    )
        return order, chunks, embeddings

    def _load_segmented(self, root: Path) -> None:
        head = _msgpack().unpackb((root / "head.msgpack").read_bytes(), raw=False)
        for d in head["documents"]:
            self.documents[d["id"]] = Document(**d)
        self.metadata = head.get("metadata", {})
        for e in head.get("evals", []):
            self.evals[e["id"]] = Eval(**e)
        self.deleted_chunks = set(head.get("deleted_chunks", []))
        self.generation = head.get("generation", 0)
        self._segments = list(head.get("segments", []))
        seg_dirs = [root / "segments" / name for name in self._segments]
        if seg_dirs and all(_Segment.is_v3(d) for d in seg_dirs):
            self._open_lazy(seg_dirs)
        else:  # pre-v3 segments (or none): eager record decode
            self.chunk_order, self.chunks, self.embeddings = self._read_log(root, head)
        self.version = head.get("version", 0)
        self._saved_chunks = len(self.chunk_order)

    def _open_lazy(self, seg_dirs: list[Path]) -> None:
        """Open v3 segments without decoding any chunk record: ids come from
        the id sidecars, metadata postings from the aux sidecars, records
        and embeddings resolve per touch through memory-maps — resident
        memory is O(touched records), not O(corpus) (VERDICT r2 task #7)."""
        start = 0
        order: list[ChunkId] = []
        segments: list[_Segment] = []
        for seg_dir in seg_dirs:
            seg = _Segment(seg_dir, start)
            order.extend(seg.ids())
            start += seg.n
            segments.append(seg)
        self.chunk_order = order
        self._lazy_segments = segments
        self._ordinal_of = {cid: i for i, cid in enumerate(order)}
        self.chunks = _LazyChunks({}, segments, self._ordinal_of, self.deleted_chunks)
        self.embeddings = _LazyEmbeddings({}, segments, self._ordinal_of)
        # Metadata postings from the sidecars (flat int arrays, no records).
        self._meta_postings = {}
        self._meta_overlay = {}
        for seg in segments:
            aux, npz = seg.aux()
            for j, (key, value) in enumerate(aux["meta_table"]):
                ords = np.asarray(npz[f"meta_{j}"], dtype=np.int64) + seg.start
                bucket = self._meta_postings.setdefault(key, {})
                prev = bucket.get(value)
                bucket[value] = ords if prev is None else np.concatenate([prev, ords])
        self._disk_state = (self.version, self.generation, tuple(self._segments))

    def absorb_concurrent(self) -> None:
        """Adopt whatever another process committed to disk since our last
        load/save (no-op for :memory: stores or an unchanged head).

        Call under :meth:`write_lock` before decisions that must see other
        writers' state — save() always does; insert's idempotency dedup
        does too (without it, two processes inserting the same document
        would both pass the has_document check and commit duplicates)."""
        if not self.persistent:
            return
        root = Path(self.path)
        head_path = root / "head.msgpack"
        if not head_path.exists():
            return
        disk_head = _msgpack().unpackb(head_path.read_bytes(), raw=False)
        disk_state = (
            disk_head.get("version", 0),
            disk_head.get("generation", 0),
            tuple(disk_head.get("segments", [])),
        )
        if disk_state != self._disk_state:
            self._absorb_disk_head(root, disk_head)
            # Remember what we just absorbed so a following save() (or a
            # second absorb) does not repeat the merge.
            self._disk_state = disk_state

    def _absorb_disk_head(self, root: Path, head: dict[str, Any]) -> None:
        """Reconcile with a head another process committed since our last
        load/save: adopt its log as the persisted prefix and replay our
        unsaved chunks on top.

        Ordinals of our unsaved chunks shift, so the generation bumps —
        device indexes treat that as a full-rebuild signal.  Limitations
        (documented, not silent): a document another process deleted while
        we held its record stays deleted at the chunk level (tombstone
        union) but its document record may reappear in the head."""
        order, chunks, embeddings = self._read_log(root, head)
        disk_ids = set(order)
        suffix = [
            cid for cid in self.chunk_order[self._saved_chunks :] if cid not in disk_ids
        ]
        # Merge row tables (disk's view, then ours for anything it lacks) —
        # but never re-adopt documents/evals THIS instance deleted (the disk
        # head may predate our delete).
        for d in head.get("documents", []):
            if d["id"] not in self._locally_deleted_documents:
                self.documents.setdefault(d["id"], Document(**d))
        for e in head.get("evals", []):
            if e["document_id"] not in self._locally_deleted_documents:
                self.evals.setdefault(e["id"], Eval(**e))
        for key, vals in head.get("metadata", {}).items():
            existing = self.metadata.setdefault(key, [])
            for v in vals:
                if v not in existing:
                    existing.append(v)
        self.deleted_chunks |= set(head.get("deleted_chunks", []))
        # _read_log filtered chunk records by the DISK head's tombstones
        # only; drop the ones WE tombstoned so our deletes survive the merge.
        for cid in self.deleted_chunks:
            chunks.pop(cid, None)
        for cid in suffix:
            if cid in self.chunks:
                chunks[cid] = self.chunks[cid]
            embeddings[cid] = np.asarray(self.embeddings[cid], dtype=np.float16)
        self.chunk_order = order + suffix
        # The merge materializes eager tables (a lazily-opened store drops
        # its segment handles — the absorbed log supersedes them).
        self.chunks = chunks
        self.embeddings = embeddings
        self._lazy_segments = []
        self._ordinal_of = {}
        self._segments = list(head.get("segments", []))
        self._saved_chunks = len(order)
        # Segments the disk head still references must never be deleted as
        # "stale" — they belong to the other writer's committed state.
        self._stale_segments = [
            s for s in self._stale_segments if s not in set(self._segments)
        ]
        # Ordinals changed: rebuild postings and force device-index rebuilds.
        self._meta_postings = {}
        self._meta_overlay = {}
        for ordinal, cid in enumerate(self.chunk_order):
            chunk = self.chunks.get(cid)
            if chunk is not None:
                self._post_metadata(ordinal, chunk.metadata_)
        self.generation = max(self.generation, head.get("generation", 0)) + 1
        self.version = max(self.version, head.get("version", 0)) + 1

    def _load_legacy_v1(self, root: Path) -> None:
        """Read the round-1 single-blob layout; the next save converts."""
        records = _msgpack().unpackb((root / "records.msgpack").read_bytes(), raw=False)
        for d in records["documents"]:
            self.documents[d["id"]] = Document(**d)
        counts = np.load(root / "embedding_counts.npy")
        stacked = np.load(root / "embeddings.npy", mmap_mode="r")
        offset = 0
        for c, m in zip(records["chunks"], counts):
            chunk = Chunk(
                id=c["id"],
                document_id=c["document_id"],
                index=c["index"],
                headings=c["headings"],
                body=c["body"],
                metadata_=c["metadata_"],
            )
            self.chunks[chunk.id] = chunk
            self.chunk_order.append(chunk.id)
            self.embeddings[chunk.id] = stacked[offset : offset + int(m)]
            offset += int(m)
        self.metadata = records.get("metadata", {})
        for e in records.get("evals", []):
            self.evals[e["id"]] = Eval(**e)
        self.version = records.get("version", 0)
        self._saved_chunks = 0  # force the first segmented save to cover all

    def _save_index_metadata(self, root: Path) -> None:
        """Persist index_metadata without pickle: numpy arrays go into an
        ``.npz`` (loadable with allow_pickle=False), everything else into
        msgpack.  Loading a store must never execute attacker-supplied
        bytecode (the reference pickles its IndexMetadata table,
        _database.py:433-462 — a known weakness we do not inherit)."""
        arrays = {k: v for k, v in self.index_metadata.items() if isinstance(v, np.ndarray)}
        plain = {k: v for k, v in self.index_metadata.items() if not isinstance(v, np.ndarray)}
        np.savez(root / "index_metadata.npz", **arrays)
        (root / "index_metadata.msgpack").write_bytes(_msgpack().packb(plain, use_bin_type=True))
        legacy = root / "index_metadata.pkl"
        if legacy.exists():
            legacy.unlink()

    def _load_index_metadata(self, root: Path) -> None:
        npz_path = root / "index_metadata.npz"
        if npz_path.exists():
            with np.load(npz_path, allow_pickle=False) as data:
                self.index_metadata = {k: data[k] for k in data.files}
        msg_path = root / "index_metadata.msgpack"
        if msg_path.exists():
            self.index_metadata.update(_msgpack().unpackb(msg_path.read_bytes(), raw=False))


@lru_cache(maxsize=8)
def _store_for_path(path: str) -> Store:
    return Store(path)


def store_from_config(config: "RAGLiteConfig") -> Store:
    """Cached store per path (reference: create_database_engine lru_cache,
    _database.py:518)."""
    return _store_for_path(config.store_path)
