"""Closed-form linear query adapter (counterpart of
raglite_tpu/query_adapter.py).

From the stored evals: each eval's question is searched without the
adapter, its top chunks split into positives (the eval's gold chunks) and
negatives, a target per question solved as a nonnegative least-squares dual
on the device (ops/nnls.py), and the adapter fitted to (questions, targets)
by a Procrustes solution in f64 on the host.  Search applies the stored
adapter as one device matmul (search.py).  On the card each NNLS batch
replays from a CUDA graph (:func:`_nnls_targets`), keyed ``("nnls", B,
Pmax, Nmax, d, alpha, iters)`` in the device's shared ProgramGraphs
(utils/graphs.py:shared_programs): the 200 FISTA iterations' ~1,700
launches become one replay; their momentum weights are host f32 scalars,
the same for every batch, so the capture holds them.

The JAX package searches all E questions in one ``index.search`` call; on
the card that call materialises an [E, N] f32 score matrix and the stable
sort's keys and indices beside it (about 28 bytes a score), 143 GB for the
default ``max_evals`` of 4,096 at the per-card design point of 1,249,280
rows.  So the questions are searched in blocks of :data:`SEARCH_BLOCK`, on
the route the one call would take.  Each row's top-k is its own, so the ids
are the one call's, and the scores too up to f32 rounding (a matmul's
summation order follows its shape).
"""

from __future__ import annotations

import functools
from dataclasses import replace

import numpy as np
import torch

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.embed import embed_queries
from raglite_tpu_torch.index.dense import DenseIndex, dense_index_from_config
from raglite_tpu_torch.ops.nnls import NNLS_ITERS, query_targets_from_rows
from raglite_tpu_torch.store import store_from_config
from raglite_tpu_torch.types import FloatMatrix
from raglite_tpu_torch.utils.graphs import shared_programs

__all__ = ["update_query_adapter", "procrustes_adapter", "search_blocked"]

_EVAL_BATCH = 64  # evals per device NNLS batch
#: Questions per index search: a block's [64, N] f32 scores and the sort's
#: keys and int64 indices take about 2.2 GB at N = 1,249,280, beside the
#: scan's transient f32 copy of the rows (3.8 GB).
SEARCH_BLOCK = 64


def procrustes_adapter(Q: np.ndarray, T: np.ndarray, metric: str) -> np.ndarray:
    """Adapter matrix from stacked queries Q and targets T, in FLOAT64 on
    the host.

    This step is numerically treacherous: with targets close to the
    queries (the common case: NNLS moves each query only as far as the
    margin requires), M's data block (1/n)TᵀQ has singular values
    ~1e-3..1e-5 against the rank completion's 1.0, and a float32 SVD
    scrambles the near-degenerate directions' signs, turning the
    "orthogonal rotation" into a reflection soup.  Measured on a real eval
    set with the JAX package: the fp32 solve DESTROYED retrieval (MRR 0.478
    -> 0.228) while this fp64 solve is the gentle near-identity rotation
    the data asks for (MRR 0.478 -> 0.484).  The d x d fp64 SVD costs
    nothing on the host.
    """
    d = Q.shape[1]
    Q64 = (Q / np.linalg.norm(Q, axis=1, keepdims=True)).astype(np.float64)
    T64 = T.astype(np.float64)
    if metric == "cosine":
        T64 = T64 / np.linalg.norm(T64, axis=1, keepdims=True)
    n = Q64.shape[0]
    M = (1.0 / n) * T64.T @ Q64
    if n < d or np.linalg.matrix_rank(Q64) < d:
        M += np.eye(d) - Q64.T @ np.linalg.pinv(Q64 @ Q64.T) @ Q64
    if metric == "dot":
        A_star = M / np.linalg.norm(M) * np.sqrt(d)
    else:
        U, _, VT = np.linalg.svd(M, full_matrices=False)
        A_star = U @ VT
    return np.asarray(A_star, dtype=np.float32)


def search_blocked(
    index: DenseIndex, queries: np.ndarray, *, num_hits: int, block: int = SEARCH_BLOCK
) -> tuple[np.ndarray, np.ndarray]:
    """``index.search(queries, num_hits=...)`` in blocks of ``block``
    queries, each on the route the one call over all queries takes.

    That call takes the single-stage kernel only for a batch of at most 32
    queries on a large index; a larger batch is scanned exactly.  So a
    batch that fits one block is one call, and the blocks of a larger one
    are scanned exactly."""
    if queries.shape[0] <= block:
        return index.search(queries, num_hits=num_hits)
    parts = [
        index.search(queries[start : start + block], num_hits=num_hits, exact=True)
        for start in range(0, queries.shape[0], block)
    ]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def _nnls_targets(device, qs, pos, neg, *, alpha: float) -> torch.Tensor:
    """One batch's NNLS targets [B, d] on ``device``
    (``query_targets_from_rows``: zero rows are padding), from its key's
    CUDA graph on the card, eagerly on the CPU."""
    key = ("nnls", pos.shape[0], pos.shape[1], neg.shape[1], pos.shape[2], alpha, NNLS_ITERS)
    program = functools.partial(query_targets_from_rows, alpha=alpha, iters=NNLS_ITERS)
    return shared_programs(device)(key, program, qs, pos, neg)


def update_query_adapter(
    *,
    max_evals: int = 4096,
    optimize_top_k: int = 40,
    optimize_gap: float = 0.05,
    config: RAGLiteConfig | None = None,
) -> FloatMatrix:
    """Compute the optimal linear query adapter A (applied as ``A @ q``) from
    stored evals and persist it.

    For each eval, the un-adapted top-k retrieval is split into positive and
    negative chunks by the eval's gold chunk ids; the optimal target
    ``t* = q + D^T mu*`` separates them by a margin ``optimize_gap``.  With
    queries Q and targets T, the adapter is ``M = T^T Q / n`` (plus a
    null-space identity completion when Q is rank-deficient), projected to
    ``sqrt(d) * M / ||M||_F`` for the dot metric or the orthogonal Procrustes
    solution ``U V^T`` for cosine.
    """
    config = config or RAGLiteConfig()
    store = store_from_config(config)
    if not store.chunk_order:
        msg = "First run `insert_documents()` to insert documents."
        raise ValueError(msg)
    evals = sorted(store.evals.values(), key=lambda e: e.id)[:max_evals]
    if not evals:
        msg = "First run `insert_evals()` to generate evals."
        raise ValueError(msg)
    if config.vector_search_distance_metric not in ("cosine", "dot"):
        msg = f"Unsupported metric: {config.vector_search_distance_metric}"
        raise ValueError(msg)
    config_plain = replace(config, vector_search_query_adapter=False)
    index = dense_index_from_config(config_plain)
    d = index.dim

    # 1. Embed all eval questions in one pass.
    questions = [e.question for e in evals]
    qs = embed_queries(questions, config=config).astype(np.float32)  # [E, d]

    # 2. The un-adapted top-k sub-vector hits (query time's oversampling).
    from raglite_tpu_torch.search import corrected_num_hits

    num_hits = corrected_num_hits(4, optimize_top_k, config)
    scores, row_ids = search_blocked(index, qs, num_hits=min(num_hits, index.num_rows))

    # 3. Each eval's positive and negative best sub-vectors on the host
    #    (small candidate sets), padded for the device batch solve.
    Q_rows: list[np.ndarray] = []
    pos_batch: list[np.ndarray] = []
    neg_batch: list[np.ndarray] = []
    k = optimize_top_k
    for e_idx, eval_ in enumerate(evals):
        # Group-max sub-vector hits into ranked chunks (multivector L-inf).
        best: dict[int, float] = {}
        for score, row in zip(scores[e_idx], row_ids[e_idx]):
            if not np.isfinite(score):
                continue
            ordinal = int(index.row_chunk[row])
            if score > best.get(ordinal, -np.inf):
                best[ordinal] = float(score)
        ranked = sorted(best.items(), key=lambda kv: kv[1], reverse=True)[:k]
        gold = set(eval_.chunk_ids)
        q = qs[e_idx]
        pos_rows, neg_rows = [], []
        for ordinal, _ in ranked:
            chunk_id = index.chunk_ids[ordinal]
            matrix = store.embeddings[chunk_id].astype(np.float32)
            vec = matrix[int(np.argmax(matrix @ q))]  # the query's best sub-vector
            (pos_rows if chunk_id in gold else neg_rows).append(vec)
        if not pos_rows or not neg_rows:
            continue  # an eval needs both relevant and irrelevant hits
        Q_rows.append(q)
        pos = np.zeros((k, d), dtype=np.float32)
        pos[: len(pos_rows)] = np.stack(pos_rows)
        neg = np.zeros((k, d), dtype=np.float32)
        neg[: len(neg_rows)] = np.stack(neg_rows)
        pos_batch.append(pos)
        neg_batch.append(neg)
    if not Q_rows:
        msg = "No evals produced both positive and negative retrievals."
        raise ValueError(msg)

    # 4. The NNLS dual solves on the index's device, in batches.
    T_rows: list[np.ndarray] = []
    for start in range(0, len(Q_rows), _EVAL_BATCH):
        sl = slice(start, start + _EVAL_BATCH)
        qb, pb, nb = (np.stack(rows[sl]) for rows in (Q_rows, pos_batch, neg_batch))
        T_rows.append(_nnls_targets(index.device, qb, pb, nb, alpha=optimize_gap).cpu().numpy())
    Q = np.stack(Q_rows)
    T = np.concatenate(T_rows, axis=0)

    # 5. The Procrustes solution, then persist.
    A_np = procrustes_adapter(Q, T, config.vector_search_distance_metric)
    with store.write_lock():
        store.set_index_metadata("query_adapter", A_np)
        store.save()
    return A_np
