"""BM25 scoring on the device (counterpart of raglite_tpu/ops/bm25.py).

The reference delegates keyword search to DuckDB's FTS extension
(``fts_main_chunk.match_bm25``, raglite/_search.py:203-225).  Here the
inverted index lives as flat postings tensors and scoring is a short chain
of torch ops: per-posting Okapi BM25 contributions, summed per (query,
chunk), then an exact top-k.

Okapi parameters k1=1.2, b=0.75 (DuckDB FTS defaults).

Every sum here is deterministic: postings are grouped by a **stable** sort
on their (query, chunk) key and each group is summed by ⌈log₂ T⌉
Hillis-Steele shift-adds (``_run_totals``), so a group's terms always add
in the same tree, on any device and in any run.  ``scatter_add_`` is not
used: on CUDA its atomics add in an order that changes from run to run, so
tied chunks would swap places.  Both the resident path and the host-gather
path sum through the same helper, in the same term order, so they give the
same floats.  Every top-k is a stable descending sort and a slice (ties to
the lower position, as ``jax.lax.top_k``); ``torch.topk`` fixes no tie
order on CUDA.  The JAX package's resident path ranks with the TPU's
``approx_max_k``, which is exact on the CPU and whose winners its host
re-sorts by (score desc, ordinal asc): the exact top-k here is its
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from raglite_tpu_torch.ops.fused_scan import _topk_stable

K1 = 1.2
B = 0.75

__all__ = [
    "bm25_idf",
    "bm25_scores",
    "bm25_scores_batch",
    "bm25_topk",
    "bm25_topk_batch",
    "bm25_topk_resident",
]


def bm25_idf(df: np.ndarray, num_chunks: int) -> np.ndarray:
    """Robertson–Sparck Jones idf with the +1 floor (Lucene/DuckDB variant)."""
    return np.log(1.0 + (num_chunks - df + 0.5) / (df + 0.5))


def _contrib(posting_chunk, posting_tf, posting_idf, len_norm, num_chunks: int) -> torch.Tensor:
    """Okapi weight of each posting, in the JAX program's order of f32 ops
    (each op its own kernel, so nothing is contracted into an FMA)."""
    idx = torch.clamp(posting_chunk.to(torch.int64), max=num_chunks - 1)
    denom = posting_tf + K1 * len_norm[idx]
    return posting_idf * posting_tf * (K1 + 1.0) / torch.clamp(denom, min=1e-9)


def _run_totals(keys: torch.Tensor, vals: torch.Tensor, max_run: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Segmented inclusive sum along the last dim of ``vals``, where equal
    ``keys`` (sorted along that dim) form a run of at most ``max_run``.
    Returns (vals with each run's total at its last position, is_end)."""
    step = 1
    while step < max_run:
        same = keys[..., step:] == keys[..., :-step]
        add = torch.where(same, vals[..., :-step], 0.0)
        vals = torch.cat([vals[..., :step], vals[..., step:] + add], dim=-1)
        step *= 2
    is_end = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    is_end[..., :-1] = keys[..., 1:] != keys[..., :-1]
    return vals, is_end


def _query_chunk_totals(
    posting_chunk, posting_query, posting_tf, posting_idf, len_norm, *, num_chunks: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(query, chunk, BM25 score) of every matched pair, ordered by (query,
    chunk).  Pairs are grouped by an int64 (query, chunk) key, so no flat id
    can overflow (the reason the JAX package keeps a 2-D scatter)."""
    contrib = _contrib(posting_chunk, posting_tf, posting_idf, len_norm, num_chunks)
    query = posting_query.to(torch.int64)
    chunk = posting_chunk.to(torch.int64)
    key = query * (num_chunks + 1) + chunk
    key, order = torch.sort(key, stable=True)
    contrib = contrib[order]
    if key.numel() == 0:
        return key, key, contrib
    # A run is one (query, chunk) pair: at most one posting per query term.
    max_run = int(torch.unique_consecutive(key, return_counts=True)[1].max())
    totals, is_end = _run_totals(key, contrib, max_run)
    query, chunk = key // (num_chunks + 1), key % (num_chunks + 1)
    keep = is_end & (chunk < num_chunks)
    return query[keep], chunk[keep], totals[keep]


def bm25_scores_batch(
    posting_chunk: torch.Tensor,  # [P] int chunk ordinal per posting (padding: num_chunks)
    posting_query: torch.Tensor,  # [P] int query index per posting
    posting_tf: torch.Tensor,  # [P] f32 term frequency (0 for padding)
    posting_idf: torch.Tensor,  # [P] f32 idf of the posting's term
    len_norm: torch.Tensor,  # [num_chunks] f32: (1 - b) + b * len/avg_len
    *,
    num_chunks: int,
    batch: int,
) -> torch.Tensor:
    """Dense BM25 scores [batch, num_chunks]: each pair's total written
    once at its 2-D (query, chunk) index (no accumulation, no flat id)."""
    query, chunk, totals = _query_chunk_totals(
        posting_chunk, posting_query, posting_tf, posting_idf, len_norm, num_chunks=num_chunks
    )
    scores = torch.zeros((batch, num_chunks), dtype=torch.float32, device=len_norm.device)
    scores[query, chunk] = totals
    return scores


def bm25_scores(posting_chunk, posting_tf, posting_idf, len_norm, *, num_chunks: int) -> torch.Tensor:
    """Dense BM25 scores [num_chunks] for one query's gathered postings."""
    query = torch.zeros_like(posting_chunk)
    return bm25_scores_batch(
        posting_chunk, query, posting_tf, posting_idf, len_norm, num_chunks=num_chunks, batch=1
    )[0]


def bm25_topk_batch(
    posting_chunk: torch.Tensor,
    posting_query: torch.Tensor,
    posting_tf: torch.Tensor,
    posting_idf: torch.Tensor,
    len_norm: torch.Tensor,
    *,
    num_chunks: int,
    batch: int,
    num_hits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``num_hits`` chunks per query: (scores [batch, k] f32, ordinals
    [batch, k] int64), ordered by (score desc, ordinal asc) as
    ``lax.top_k`` over :func:`bm25_scores_batch` orders them.  Only matched
    pairs are ranked, so no [batch, num_chunks] matrix is made; slots past a
    query's last match hold score 0 and ordinal ``num_chunks`` (the JAX
    program fills them with zero-score chunks; callers drop score <= 0)."""
    query, chunk, totals = _query_chunk_totals(
        posting_chunk, posting_query, posting_tf, posting_idf, len_norm, num_chunks=num_chunks
    )
    device = len_norm.device
    out_scores = torch.zeros((batch, num_hits), dtype=torch.float32, device=device)
    out_ords = torch.full((batch, num_hits), num_chunks, dtype=torch.int64, device=device)
    if totals.numel() == 0:
        return out_scores, out_ords
    # (query asc, score desc, chunk asc): pairs arrive by (query, chunk), so
    # a stable sort on the score and then one on the query keep the rest.
    order = torch.sort(totals, descending=True, stable=True)[1]
    query, chunk, totals = query[order], chunk[order], totals[order]
    order = torch.sort(query, stable=True)[1]
    query, chunk, totals = query[order], chunk[order], totals[order]
    rank = torch.arange(query.numel(), device=device) - torch.searchsorted(query, query)
    keep = rank < num_hits
    out_scores[query[keep], rank[keep]] = totals[keep]
    out_ords[query[keep], rank[keep]] = chunk[keep]
    return out_scores, out_ords


def bm25_topk(
    posting_chunk, posting_tf, posting_idf, len_norm, *, num_chunks: int, num_hits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bm25_topk_batch` for one query: (scores [k], ordinals [k])."""
    query = torch.zeros_like(posting_chunk)
    scores, ordinals = bm25_topk_batch(
        posting_chunk, query, posting_tf, posting_idf, len_norm,
        num_chunks=num_chunks, batch=1, num_hits=num_hits,
    )
    return scores[0], ordinals[0]


def bm25_topk_resident(
    offsets: torch.Tensor,  # [V+1] int64 CSR offsets over (truncated) postings
    post_chunk: torch.Tensor,  # [P+pad] int32 chunk ordinal per posting (device memory)
    post_w: torch.Tensor,  # [P+pad] f32 PRECOMPUTED Okapi weight per posting
    mask: torch.Tensor,  # [num_chunks] bool (metadata filter) or [1] dummy
    term_ids: torch.Tensor,  # [B, T] int query term ids, padded with -1
    *,
    num_chunks: int,
    lcap: int,  # postings width >= max df among the terms
    num_hits: int,
    masked: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-resident BM25: postings stay in device memory; a query uploads
    only its term ids [B, T].  Returns (scores [B, k] f32, ordinals [B, k]
    int64), ordered by (score desc, ordinal asc); slots with no positive
    score hold ordinal ``num_chunks``.

    The per-posting weight ``w = idf * tf * (K1+1) / (tf + K1 *
    len_norm[chunk])`` is fixed at build time, so a query reads no tf, idf
    or length.  As in the JAX program (whose design notes give the TPU's
    reasons): each (query, term) postings slice ``[lo, lo + lcap)`` comes
    with one index gather (the arrays are padded so no slice runs off the
    end), slots past the term's df are masked, ``masked`` adds the metadata
    filter's per-posting gather, a stable sort on the chunk keys groups each
    chunk's terms in term order, ⌈log₂ T⌉ shift-adds sum them, the last
    slot of each chunk carries its score, and an exact top-k ranks them.
    """
    batch, T = term_ids.shape
    tid = term_ids.to(torch.int64)
    t = torch.clamp(tid, min=0)
    lo = offsets[t]  # [B, T]
    df = offsets[t + 1] - lo
    take = torch.where(tid >= 0, torch.clamp(df, max=lcap), 0)
    ar = torch.arange(lcap, device=offsets.device)
    idx = (lo[:, :, None] + ar).reshape(batch, T * lcap)
    valid = (ar < take[:, :, None]).reshape(batch, T * lcap)
    keys = torch.where(valid, post_chunk[idx], num_chunks)
    vals = torch.where(valid, post_w[idx], 0.0)
    if masked:
        ok = mask[torch.clamp(keys, max=num_chunks - 1).to(torch.int64)] & (keys < num_chunks)
        vals = torch.where(ok, vals, 0.0)
    keys, order = torch.sort(keys, dim=-1, stable=True)
    vals = vals.gather(-1, order)
    vals, is_end = _run_totals(keys, vals, T)
    scores = torch.where(is_end & (keys < num_chunks), vals, -1.0)
    top_scores, pos = _topk_stable(scores, min(num_hits, T * lcap))
    top_keys = keys.gather(-1, pos).to(torch.int64)
    ordinals = torch.where(top_scores > 0.0, top_keys, num_chunks)
    return top_scores, ordinals
