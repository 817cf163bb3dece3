"""Inverted keyword index with BM25 scoring on the device (counterpart of
raglite_tpu/index/keyword.py).

Replaces DuckDB's FTS extension index (PRAGMA create_fts_index,
raglite/_database.py:606-619) and Postgres tsvector GIN
(_database.py:564-575).  Postings build incrementally on the host, in the
first-party C++ builder (native/postings.cpp) when it compiles, else in a
pure-Python dict build with the same results; scoring runs on the
configured device (ops/bm25.py).

The postings sharded over several GPUs (the JAX package's
``_ensure_sharded`` / ``sharded_search_batch``) are not ported yet (ROADMAP
queue 1 item 10).
"""

from __future__ import annotations

import logging
import re
import threading
from functools import lru_cache
from typing import TYPE_CHECKING

import numpy as np
import torch

from raglite_tpu_torch.index.dense import fetch_scored
from raglite_tpu_torch.ops.bm25 import K1, bm25_idf, bm25_topk_batch, bm25_topk_resident
from raglite_tpu_torch.utils.padding import round_up as _round_up

if TYPE_CHECKING:
    from raglite_tpu_torch.config import RAGLiteConfig
    from raglite_tpu_torch.store import Store

logger = logging.getLogger(__name__)

_WORD_RE = re.compile(r"\w+", re.UNICODE)

#: Queries per resident BM25 call: the [B, T·lcap] sort of a block at T = 32
#: and lcap = 8,192 holds 67 M entries (about 0.8 GB of keys and weights).
RESIDENT_BLOCK = 256


def tokenize(text: str) -> list[str]:
    """Lowercased word tokens (the reference strips punctuation into an
    OR-query the same way, _search.py:183-189)."""
    return _WORD_RE.findall(text.lower())


class KeywordIndex:
    """Host postings + device-side scoring.

    The postings build runs in the first-party C++ builder
    (native/postings.cpp, the replacement for DuckDB's C++ FTS build) when
    the native library compiles; otherwise a pure-Python dict build with
    identical behavior (logged at WARNING).
    """

    #: Dead-chunk fraction above which the postings fully rebuild.  Below
    #: it, deletes are handled by masking dead ordinals at query time —
    #: O(postings touched) per query instead of the reference's full FTS
    #: rebuild on EVERY mutation (_insert.py:268-272, _delete.py:130-178).
    #: idf/avg_len drift from dead postings is bounded by this fraction and
    #: snaps back exactly at rebuild.
    REBUILD_DEAD_FRACTION = 0.3

    #: Device-resident postings: terms with more postings than this
    #: contribute only their LCAP highest-impact postings (impact-ordered
    #: early termination; only stopword-class terms truncate).  Rounded up
    #: to a multiple of 128 at build.
    RESIDENT_LCAP = 8192
    #: Queries with more unique terms fall back to the host-gather path.
    RESIDENT_MAX_TERMS = 32

    def __init__(self, device: torch.device | str = "cuda") -> None:
        self.device = torch.device(device)
        self._sync_lock = threading.Lock()  # see DenseIndex._sync_lock
        self.chunk_ids: list[str] = []
        #: term -> {chunk ordinal -> tf} (Python fallback path)
        self._postings: dict[str, dict[int, int]] = {}
        self.doc_len: list[int] = []
        self._synced_version = -1
        self._native = None
        self._csr: dict | None = None  # exported CSR cache (native path)
        self._ordinal: dict[str, int] = {}  # chunk id -> postings ordinal
        self._dead: set[int] = set()  # ALL tombstoned ordinals (masked at query)
        #: tombstoned ordinals whose postings still exist (tombstoned since
        #: the last rebuild) — only these drive the rebuild threshold;
        #: ordinals rebuilt-with-empty-bodies carry no postings to drop.
        self._stale_dead: set[int] = set()
        self._alive_mask: np.ndarray | None = None  # cache over self._dead
        #: device-resident postings (None = not built / invalidated by adds)
        self._res: dict | None = None
        self.use_resident = True
        #: Which route served the last search: "resident" (device postings),
        #: "host_gather" (postings gathered on the host) or "hybrid_fused"
        #: (resident BM25 chained into device RRF by search.hybrid_search).
        self.last_route: str | None = None
        from raglite_tpu_torch.native import NativePostingsBuilder, native_available

        if native_available():
            self._native = NativePostingsBuilder()
        else:
            logger.warning("native postings builder unavailable; keyword index uses the Python build")

    @property
    def backend(self) -> str:
        """"native" (the C++ builder) or "python" (the dict fallback)."""
        return "native" if self._native is not None else "python"

    # --- Build ----------------------------------------------------------

    def _add_chunk(self, chunk_id: str, text: str) -> None:
        ordinal = len(self.chunk_ids)
        self.chunk_ids.append(chunk_id)
        self._ordinal[chunk_id] = ordinal
        self._res = None  # postings changed: resident arrays rebuild lazily
        if self._native is not None:
            self._native.add_chunk(text)
            self._csr = None
            self.doc_len.append(0)  # real value lives in the native builder
            return
        tokens = tokenize(text)
        self.doc_len.append(len(tokens))
        for token in tokens:
            bucket = self._postings.setdefault(token, {})
            bucket[ordinal] = bucket.get(ordinal, 0) + 1

    def rebuild(self, store: "Store") -> None:
        self.chunk_ids = []
        self._postings = {}
        self.doc_len = []
        self._ordinal = {}
        self._alive_mask = None
        self._res = None
        if self._native is not None:
            from raglite_tpu_torch.native import NativePostingsBuilder

            self._native = NativePostingsBuilder()
            self._csr = None
        for cid in store.chunk_order:
            self._add_chunk(cid, self._chunk_body(store, cid))
        # Tombstoned ordinals re-add with EMPTY bodies (slot alignment with
        # store.chunk_order), so their postings are gone: nothing is stale.
        self._dead = {
            self._ordinal[cid] for cid in store.deleted_chunks if cid in self._ordinal
        }
        self._stale_dead = set()
        self._synced_version = store.version

    @staticmethod
    def _chunk_body(store: "Store", cid: str) -> str:
        """Tombstoned chunks keep their ordinal slot with an empty body (so
        posting ordinals stay aligned with chunk_order); their record is
        gone from store.chunks after a delete."""
        chunk = store.chunks.get(cid)
        return chunk.body if chunk is not None else ""

    def sync(self, store: "Store") -> None:
        if self._synced_version == store.version:
            return
        with self._sync_lock:
            self._sync_locked(store)

    def _sync_locked(self, store: "Store") -> None:
        if self._synced_version == store.version:
            return  # another thread synced while we waited
        if len(store.chunk_order) >= len(self.chunk_ids) and (
            store.chunk_order[: len(self.chunk_ids)] == self.chunk_ids
        ):
            # Incremental: append new chunks, tombstone deleted ordinals.
            for cid in store.chunk_order[len(self.chunk_ids) :]:
                self._add_chunk(cid, self._chunk_body(store, cid))
            new_dead = {
                self._ordinal[cid]
                for cid in store.deleted_chunks
                if cid in self._ordinal
            } - self._dead
            if new_dead:
                self._dead |= new_dead
                self._stale_dead |= new_dead
                self._alive_mask = None
                # Drop dead doc lengths so avg_len tracks the live corpus
                # (the CSR export re-zeroes them on refresh), THEN refresh
                # the resident weights from the updated lengths.
                for ordinal in new_dead:
                    if ordinal < len(self.doc_len):
                        self.doc_len[ordinal] = 0
                self._refresh_resident_weights()
            # Stale (still-posted) dead chunks are masked per query until
            # they become a large fraction of the LIVE corpus, THEN one
            # amortized rebuild drops them (and corrects the bounded idf
            # drift) — versus the reference's full FTS rebuild on every
            # mutation (_delete.py:130-178).
            alive_count = max(len(self.chunk_ids) - len(self._dead), 1)
            if len(self._stale_dead) > self.REBUILD_DEAD_FRACTION * alive_count:
                self.rebuild(store)
            else:
                self._synced_version = store.version
        else:
            # Prefix changed (compaction reordered ordinals): full rebuild.
            self.rebuild(store)

    def _alive(self) -> np.ndarray | None:
        """Bool mask over ordinals, False where tombstoned (None = all alive)."""
        if not self._dead:
            return None
        if self._alive_mask is None or self._alive_mask.size != len(self.chunk_ids):
            mask = np.ones(len(self.chunk_ids), dtype=bool)
            mask[np.fromiter(self._dead, dtype=np.int64, count=len(self._dead))] = False
            self._alive_mask = mask
        return self._alive_mask

    # --- Device-resident postings ---------------------------------------

    def _native_csr(self) -> dict:
        """The cached C++ CSR export; refreshes ``doc_len`` from it (dead
        chunks keep length 0, so they leave avg_len)."""
        if self._csr is None:
            self._csr = self._native.export()
            self.doc_len = [int(x) for x in self._csr["doc_len"]]
            for ordinal in self._dead:
                if ordinal < len(self.doc_len):
                    self.doc_len[ordinal] = 0
        return self._csr

    def _host_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict[str, int] | None]:
        """(offsets[V+1] i64, chunks[P] i32, tf[P] i32, term->id or None).

        Native path: the cached C++ CSR export (query lookup stays in the
        C++ dictionary).  Python path: a CSR built from the postings dict
        plus an explicit term->id map.
        """
        if self._native is not None:
            csr = self._native_csr()
            return csr["offsets"], csr["chunks"], csr["tf"], None
        terms = list(self._postings)
        term_id = {t: i for i, t in enumerate(terms)}
        counts = np.asarray([len(self._postings[t]) for t in terms], np.int64)
        offsets = np.zeros(len(terms) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        chunks = np.zeros(int(offsets[-1]), np.int32)
        tf = np.zeros(int(offsets[-1]), np.int32)
        for i, t in enumerate(terms):
            bucket = self._postings[t]
            lo = int(offsets[i])
            chunks[lo : lo + len(bucket)] = np.fromiter(bucket.keys(), np.int32, len(bucket))
            tf[lo : lo + len(bucket)] = np.fromiter(bucket.values(), np.int32, len(bucket))
        return offsets, chunks, tf, term_id

    def _resident_n_pad(self) -> int:
        """Corpus-axis pad (the sentinel ordinal of empty slots): ~12.5%
        geometric steps, as the JAX package's compile buckets."""
        n = len(self.chunk_ids)
        step = max(4096, 1 << max(int(n).bit_length() - 4, 0))
        return _round_up(max(n, 1), step)

    def _ensure_resident(self) -> dict | None:
        """Build (lazily) the device-resident postings: CSR offsets plus,
        per posting, the chunk ordinal and its PRECOMPUTED Okapi weight
        ``idf·tf·(K1+1)/(tf+K1·len_norm)``.  Every factor is known at build
        time (on the host, numpy f32, as the JAX package), so query-time
        scoring is pure weight summation.  Over-cap terms keep their
        top-impact postings (truncated at build); idf keeps the full
        pre-truncation df.  Queries then upload term ids only
        (ops/bm25.py:bm25_topk_resident)."""
        if not self.use_resident or not self.chunk_ids:
            return None
        if self._res is not None:
            return self._res
        with self._sync_lock:
            if self._res is not None:
                return self._res
            offsets, chunks, tf, term_id = self._host_csr()
            n = len(self.chunk_ids)
            n_pad = self._resident_n_pad()
            df = np.diff(offsets)
            idf = bm25_idf(df.astype(np.float64), n).astype(np.float32)
            doc_len = np.asarray(self.doc_len, np.float32)
            alive_len = doc_len > 0
            avg_len = max(float(doc_len[alive_len].mean()), 1.0) if alive_len.any() else 1.0
            len_norm = (1.0 - 0.75) + 0.75 * doc_len / avg_len
            if len(chunks):
                # Truncate over-cap terms to their top-impact postings AT
                # BUILD (impact-ordered early termination; only
                # stopword-class terms lose postings).  idf keeps the full
                # pre-truncation df, matching the host path.
                term_of = np.repeat(np.arange(len(df), dtype=np.int64), df)
                impact = (
                    idf[term_of]
                    * tf
                    * (K1 + 1.0)
                    / np.maximum(tf + K1 * len_norm[chunks], 1e-9)
                )
                order = np.lexsort((-impact, term_of))
                chunks, tf, term_of = chunks[order], tf[order], term_of[order]
                rank = np.arange(len(chunks), dtype=np.int64) - offsets[term_of]
                keep = rank < self.RESIDENT_LCAP
                chunks, tf, term_of = chunks[keep], tf[keep], term_of[keep]
                df = np.bincount(term_of, minlength=len(df)).astype(np.int64)
                offsets = np.zeros(len(df) + 1, np.int64)
                np.cumsum(df, out=offsets[1:])
                idf_post = idf[term_of]
            else:
                idf_post = np.zeros((0,), np.float32)
            lcap = _round_up(min(int(df.max()) if len(df) else 1, self.RESIDENT_LCAP), 128)
            # A query reads [lo, lo + lcap_b) with lcap_b <= slice_pad: pad
            # the resident arrays so no slice at the tail runs off the end.
            slice_pad = 1 << max(int(lcap) - 1, 1).bit_length()
            chunk_dev = np.full(len(chunks) + slice_pad, n_pad, np.int32)
            chunk_dev[: len(chunks)] = chunks
            res = {
                "offsets": torch.as_tensor(offsets, dtype=torch.int64, device=self.device),
                "chunk": torch.as_tensor(chunk_dev, device=self.device),
                "term_id": term_id,
                "df_host": df.astype(np.int64),
                # host copies for weight recomputation after deletes
                "host_chunks": chunks.astype(np.int64),
                "host_tf": tf.astype(np.float32),
                "host_idf_post": idf_post.astype(np.float32),
                "slice_pad": int(slice_pad),
                "dummy_mask": torch.zeros((1,), dtype=torch.bool, device=self.device),
                "lcap": int(lcap),
                "n_pad": int(n_pad),
            }
            self._res = res
            self._refresh_resident_weights()
            return self._res

    def _refresh_resident_weights(self) -> None:
        """(Re)compute + upload the per-posting weights — at build, and
        after deletes (which change avg_len and zero dead chunks' weights;
        the postings/offsets themselves stay resident).  avg_len
        re-averages over live chunks, matching the host path exactly."""
        if self._res is None:
            return
        res = self._res
        chunks = res["host_chunks"]
        tf = res["host_tf"]
        len_norm = self._len_norm(res["n_pad"])
        w = (
            res["host_idf_post"]
            * tf
            * (K1 + 1.0)
            / np.maximum(tf + K1 * len_norm[chunks].astype(np.float32), 1e-9)
        )
        alive = self._alive()
        if alive is not None:
            w = np.where(alive[chunks], w, 0.0)
        w_dev = np.zeros(len(chunks) + res["slice_pad"], np.float32)
        w_dev[: len(chunks)] = w
        res["w"] = torch.as_tensor(w_dev, device=self.device)

    def _resident_term_ids(self, queries: list[str]) -> np.ndarray | None:
        """[B, T] int32 unique term ids per query (pad -1), or None when a
        query exceeds RESIDENT_MAX_TERMS unique known terms."""
        res = self._res
        rows = []
        for q in queries:
            if self._native is not None:
                ids = np.unique(self._native.tokenize_lookup(q))
                ids = ids[ids >= 0]
            else:
                term_id = res["term_id"]
                seen = dict.fromkeys(tokenize(q))
                ids = np.asarray([term_id[t] for t in seen if t in term_id], np.int32)
            if len(ids) > self.RESIDENT_MAX_TERMS:
                return None
            rows.append(ids)
        t_max = max((len(r) for r in rows), default=0)
        t_pad = 4
        while t_pad < t_max:
            t_pad *= 2
        out = np.full((len(queries), t_pad), -1, np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    def resident_prepare(self, queries: list[str]) -> np.ndarray | None:
        """Build the resident arrays if needed and return the [B, T] term-id
        matrix for ``queries``, or None when the resident path can't serve
        them (disabled, empty index, or a query over RESIDENT_MAX_TERMS)."""
        if self._ensure_resident() is None:
            return None
        return self._resident_term_ids(queries)

    def resident_device_mask(self, chunk_mask: np.ndarray | None) -> tuple[torch.Tensor, bool]:
        """(device mask, masked flag) for the resident program's metadata
        filter route.  Weights already encode alive/dead; a metadata filter
        adds a per-posting mask gather."""
        res = self._res
        if chunk_mask is None:
            return res["dummy_mask"], False
        n = len(self.chunk_ids)
        m = np.zeros(res["n_pad"], bool)
        m[:n] = chunk_mask[:n]
        return torch.as_tensor(m, device=self.device), True

    def resident_block_device(
        self,
        block: np.ndarray,  # [b, T] int32 term ids (pad -1), b <= RESIDENT_BLOCK
        *,
        num_hits: int,
        mask: torch.Tensor,
        masked: bool,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One block of queries through the resident BM25 program, returning
        (scores [b, k], ordinals [b, k]) on the device (no host fetch): the
        building block the fused hybrid path chains into device RRF.
        Winners are ordered by (score desc, ordinal asc)."""
        res = self._res
        # Adaptive postings width: the max (truncated) df among THIS block's
        # terms, a power of two from 128: tail queries fetch and sort far
        # fewer slots than the global cap.
        valid = block[block >= 0]
        max_df = int(res["df_host"][valid].max()) if valid.size else 1
        lcap_b = 128
        while lcap_b < max_df:
            lcap_b *= 2
        return bm25_topk_resident(
            res["offsets"], res["chunk"], res["w"], mask,
            torch.as_tensor(block, device=self.device),
            num_chunks=res["n_pad"], lcap=lcap_b, num_hits=num_hits, masked=masked,
        )

    def _hits(self, scores: np.ndarray, ordinals: np.ndarray) -> tuple[list[str], list[float]]:
        n = len(self.chunk_ids)
        hits = (scores > 0.0) & (ordinals < n)
        return (
            [self.chunk_ids[int(o)] for o in ordinals[hits]],
            [float(s) for s in scores[hits]],
        )

    def _resident_search(
        self,
        queries: list[str],
        *,
        num_hits: int,
        chunk_mask: np.ndarray | None,
    ) -> list[tuple[list[str], list[float]]] | None:
        """All queries through the resident device program, or None to fall
        back to the host-gather path (resident disabled / too many terms)."""
        res = self._ensure_resident()
        if res is None:
            return None
        term_ids = self._resident_term_ids(queries)
        if term_ids is None:
            return None
        mask, masked = self.resident_device_mask(chunk_mask)
        k = min(num_hits, len(self.chunk_ids))
        results: list[tuple[list[str], list[float]]] = []
        for start in range(0, len(queries), RESIDENT_BLOCK):
            scores_b, ordinals_b = fetch_scored(
                *self.resident_block_device(
                    term_ids[start : start + RESIDENT_BLOCK], num_hits=k, mask=mask, masked=masked
                )
            )
            results.extend(self._hits(s, o) for s, o in zip(scores_b, ordinals_b))
        self.last_route = "resident"
        return results

    # --- Search ---------------------------------------------------------

    def _gather_postings(
        self, query: str, chunk_mask: np.ndarray | None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side postings gather for one query's terms: returns
        (chunk ordinals [P], tf [P], idf [P]), metadata-mask applied."""
        n = len(self.chunk_ids)
        rows_chunk: list[np.ndarray] = []
        rows_tf: list[np.ndarray] = []
        rows_idf: list[np.ndarray] = []
        if self._native is not None:
            csr = self._native_csr()
            term_ids = np.unique(self._native.tokenize_lookup(query))
            for tid in term_ids:
                lo, hi = int(csr["offsets"][tid]), int(csr["offsets"][tid + 1])
                if hi == lo:
                    continue
                rows_chunk.append(csr["chunks"][lo:hi])
                rows_tf.append(csr["tf"][lo:hi].astype(np.float32))
                rows_idf.append(np.full(hi - lo, bm25_idf(np.asarray(hi - lo), n)))
        else:
            for term in dict.fromkeys(tokenize(query)):
                bucket = self._postings.get(term)
                if not bucket:
                    continue
                rows_chunk.append(np.fromiter(bucket.keys(), dtype=np.int32, count=len(bucket)))
                rows_tf.append(np.fromiter(bucket.values(), dtype=np.float32, count=len(bucket)))
                rows_idf.append(np.full(len(bucket), bm25_idf(np.asarray(len(bucket)), n)))
        if not rows_chunk:
            empty = np.zeros((0,), dtype=np.float32)
            return np.zeros((0,), dtype=np.int32), empty, empty
        chunk = np.concatenate(rows_chunk).astype(np.int32)
        tf = np.concatenate(rows_tf).astype(np.float32)
        idf = np.concatenate(rows_idf).astype(np.float32)
        alive = self._alive()
        if alive is not None:  # tombstoned chunks never score
            keep = alive[chunk]
            chunk, tf, idf = chunk[keep], tf[keep], idf[keep]
        if chunk_mask is not None:
            keep = chunk_mask[chunk]
            chunk, tf, idf = chunk[keep], tf[keep], idf[keep]
        return chunk, tf, idf

    def _len_norm(self, n_pad: int) -> np.ndarray:
        doc_len = np.asarray(self.doc_len, dtype=np.float32)
        # Tombstoned chunks keep their ordinal slot with length 0; averaging
        # over them would halve avg_len after mass deletes and then snap back
        # at compaction, shifting BM25's long-vs-short ranking with no corpus
        # change (DuckDB FTS recomputes avgdl over remaining rows only).
        alive = doc_len > 0
        avg_len = max(float(doc_len[alive].mean()), 1.0) if alive.any() else 1.0
        len_norm = (1.0 - 0.75) + 0.75 * doc_len / avg_len
        return np.pad(len_norm, (0, n_pad - len(doc_len)), constant_values=1.0)

    def search(
        self,
        query: str,
        *,
        num_hits: int,
        chunk_mask: np.ndarray | None = None,
    ) -> tuple[list[str], list[float]]:
        """BM25 top hits (reference: keyword_search, _search.py:156-230).
        ``chunk_mask`` applies metadata pre-filtering."""
        return self.search_batch([query], num_hits=num_hits, chunk_mask=chunk_mask)[0]

    def search_batch(
        self,
        queries: list[str],
        *,
        num_hits: int,
        chunk_mask: np.ndarray | None = None,
    ) -> list[tuple[list[str], list[float]]]:
        """[B]-batched BM25: the resident device program when it can serve
        the queries; else every query's postings gather on the host and ONE
        device program scores them all (ops/bm25.py:bm25_topk_batch)."""
        n = len(self.chunk_ids)
        if n == 0 or not queries:
            return [([], []) for _ in queries]
        resident = self._resident_search(queries, num_hits=num_hits, chunk_mask=chunk_mask)
        if resident is not None:
            return resident
        self.last_route = "host_gather"
        gathered = [self._gather_postings(q, chunk_mask) for q in queries]
        if sum(g[0].size for g in gathered) == 0:
            return [([], []) for _ in queries]
        chunk = np.concatenate([g[0] for g in gathered])
        tf = np.concatenate([g[1] for g in gathered])
        idf = np.concatenate([g[2] for g in gathered])
        qid = np.repeat(np.arange(len(queries), dtype=np.int32), [g[0].size for g in gathered])
        scores, ordinals = bm25_topk_batch(
            *(torch.as_tensor(x, device=self.device) for x in (chunk, qid, tf, idf, self._len_norm(n))),
            num_chunks=n,
            batch=len(queries),
            num_hits=min(num_hits, n),
        )
        scores_b, ordinals_b = fetch_scored(scores, ordinals)
        return [self._hits(s, o) for s, o in zip(scores_b, ordinals_b)]


@lru_cache(maxsize=8)
def _keyword_index_for_path(store_path: str, device: str) -> KeywordIndex:
    return KeywordIndex(device=device)


def keyword_index_from_config(config: "RAGLiteConfig") -> KeywordIndex:
    """Cached keyword index per (store, device), synced."""
    from raglite_tpu_torch.store import store_from_config

    index = _keyword_index_for_path(config.store_path, str(config.torch_device()))
    index.sync(store_from_config(config))
    return index
