"""Merge chunklets into semantic chunks with an exact interval DP.

Counterpart of raglite/_split_chunks.py:12-122, which
formulates chunking as a binary integer program (cut-coverage constraints,
solved by HiGHS via scipy.linprog).  That BIP — "minimize the summed
partition-point similarity such that every max_size window contains a cut"
— is exactly a shortest-path problem on partition prefixes, so it is solved
here with an O(N·W) dynamic program instead of an LP solver.  The cost
model (discourse-vector removal, similarity reshaping around headings) is
preserved.
"""

from __future__ import annotations

import re

import numpy as np

from raglite_tpu_torch.types import FloatMatrix

__all__ = ["split_chunks"]


def _partition_similarities(chunklets: list[str], embeddings: FloatMatrix) -> np.ndarray:
    """Cost of cutting between consecutive chunklets: their cosine similarity
    after removing the document's discourse vector, reshaped to favour cuts
    before Markdown headings (reference: _split_chunks.py:53-88)."""
    X = embeddings.astype(np.float32)
    X = X / np.linalg.norm(X, axis=1, keepdims=True)
    # Remove the discourse direction estimated from length-typical chunklets.
    sizes = np.asarray([len(c) for c in chunklets])
    q15, q85 = np.quantile(sizes, [0.15, 0.85])
    typical = (q15 <= sizes) & (sizes <= q85)
    if np.any(typical):
        discourse = X[typical].mean(axis=0)
        discourse /= np.linalg.norm(discourse)
        residual = X - np.outer(X @ discourse, discourse)
        norms = np.linalg.norm(residual, axis=1)
        if np.all(norms > np.finfo(X.dtype).eps):
            X = residual / norms[:, None]
    sim = np.sum(X[:-1] * X[1:], axis=1)
    sim = np.maximum((sim + 1.0) / 2.0, np.sqrt(np.finfo(X.dtype).eps))
    # Heading reshaping: cheap to cut just before a heading, never cut
    # immediately after one (reference: _split_chunks.py:74-83).
    prev_is_heading = True
    for i, chunklet in enumerate(chunklets[:-1]):
        is_heading = bool(re.match(r"^#+\s", chunklet.replace("\n", "").strip()))
        if is_heading:
            if not prev_is_heading and i >= 1:
                sim[i - 1] /= 4.0
            sim[i] = 1.0
        prev_is_heading = is_heading
    return sim


def split_chunks(
    chunklets: list[str],
    chunklet_embeddings: FloatMatrix,
    max_size: int = 2048,
) -> tuple[list[str], list[FloatMatrix]]:
    """Partition chunklets into chunks of at most ``max_size`` characters,
    minimizing the total similarity across the chosen cut points
    (reference: _split_chunks.py:12-122; same optimum, exact DP instead of BIP).

    Returns the chunks and, for each chunk, the corresponding rows of
    ``chunklet_embeddings``.
    """
    sizes = np.asarray([len(c) for c in chunklets])
    if not np.all(sizes <= max_size):
        msg = "Chunklet larger than chunk max_size detected."
        raise ValueError(msg)
    if len(chunklets) > 0 and not np.all(np.linalg.norm(chunklet_embeddings, axis=1) > 0.0):
        msg = "Chunklet embeddings with zero norm detected."
        raise ValueError(msg)
    if len(chunklets) <= 1 or int(np.sum(sizes)) <= max_size:
        return (["".join(chunklets)] if chunklets else []), [chunklet_embeddings]

    cut_cost = _partition_similarities(chunklets, chunklet_embeddings)
    n = len(chunklets)
    pref = np.concatenate(([0], np.cumsum(sizes)))
    # dp[i] = minimal cut cost to partition chunklets[:i] into valid chunks.
    dp = np.full(n + 1, np.inf)
    dp[0] = 0.0
    back = np.full(n + 1, -1, dtype=np.int64)
    for i in range(1, n + 1):
        lo = int(np.searchsorted(pref, pref[i] - max_size, side="left"))
        js = np.arange(lo, i)
        # Cutting before chunklet j costs cut_cost[j-1]; starting at 0 is free.
        costs = dp[js] + np.where(js > 0, cut_cost[np.maximum(js - 1, 0)], 0.0)
        best = int(np.argmin(costs))
        dp[i] = costs[best]
        back[i] = js[best]
    cuts: list[int] = []
    i = int(back[n])
    while i > 0:
        cuts.append(i)
        i = int(back[i])
    cuts.reverse()
    chunks = ["".join(chunklets[i:j]) for i, j in zip([0, *cuts], [*cuts, n])]
    chunk_embeddings = np.split(chunklet_embeddings, cuts)
    return chunks, chunk_embeddings
