"""Group sentences into chunklets with a vectorized dynamic program.

Counterpart of raglite/_split_chunklets.py:11-184.
The cost model is identical — a boundary cost rewarding chunklets that
start on Markdown structure and a statement cost targeting ~3 statements —
but the O(N·W) inner loop is vectorized over the candidate-predecessor
window with numpy instead of iterating in Python.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
from raglite_tpu_torch.utils.mdparse import parse_markdown

from raglite_tpu_torch.types import FloatVector

__all__ = ["split_chunklets", "markdown_chunklet_boundaries", "compute_num_statements"]

#: Boundary probability per Markdown block-opening token type
#: (reference: _split_chunklets.py:29-35).
_TOKEN_BOUNDARY_PROBA = {
    "heading_open": 1.0,
    "blockquote_open": 0.75,
    "paragraph_open": 0.5,
    "bullet_list_open": 0.25,
    "ordered_list_open": 0.25,
}


def markdown_chunklet_boundaries(sentences: list[str]) -> FloatVector:
    """Per-sentence probability of being a good chunklet start
    (reference: _split_chunklets.py:11-55)."""
    doc = "".join(sentences)
    tokens = parse_markdown(doc)
    # Character offset of every line and every sentence (newline_offsets:
    # markdown-it counts only \n lines, unlike str.splitlines).
    from raglite_tpu_torch.utils.mdparse import newline_offsets

    line_start = newline_offsets(doc)
    sent_start = [0]
    for sentence in sentences:
        sent_start.append(sent_start[-1] + len(sentence))
    line_to_sentence = np.searchsorted(sent_start, line_start, side="right") - 1
    probas = np.zeros(len(sentences))
    last = -1
    for token in tokens:
        proba = _TOKEN_BOUNDARY_PROBA.get(token.type)
        if proba is not None and token.map is not None:
            i = int(line_to_sentence[token.map[0]])
            if i != last:
                probas[i] = proba
                last = i
    # Within each run of consecutive nonzero boundaries keep only the largest
    # (ties: first), zeroing the rest (reference: _split_chunklets.py:46-55).
    nz = probas != 0.0
    run_start = None
    for i in range(len(probas) + 1):
        inside = i < len(probas) and nz[i]
        if inside and run_start is None:
            run_start = i
        elif not inside and run_start is not None:
            seg = probas[run_start:i]
            keep = int(np.argmax(seg))
            value = seg[keep]
            probas[run_start:i] = 0.0
            probas[run_start + keep] = value
            run_start = None
    return probas


def compute_num_statements(sentences: list[str]) -> FloatVector:
    """Approximate statements per sentence from word-count quantiles
    (reference: _split_chunklets.py:58-71): the 25th percentile maps to 0.75
    statements and the 75th to 1.25."""
    words = np.asarray([len(s.split()) for s in sentences], dtype=np.float64)
    q25, q75 = np.quantile(words, [0.25, 0.75])
    eps = np.sqrt(np.finfo(np.float64).eps)
    q25 = max(q25, eps)
    q75 = max(q75, q25 + eps)
    return np.where(
        words <= q25,
        0.75 * words / q25,
        0.75 + 0.5 * (words - q25) / (q75 - q25),
    )


def split_chunklets(
    sentences: list[str],
    boundary_cost: Callable[[FloatVector], float] | None = None,
    statement_cost: Callable[[float], float] | None = None,
    max_size: int = 2048,
) -> list[str]:
    """Optimally partition sentences into chunklets
    (reference: _split_chunklets.py:74-184).

    Chunklet cost = boundary cost + statement cost, where the defaults are
    ``(1 - p[first]) + sum(p[rest])`` and ``(s - 3)^2 / sqrt(s) / 2``.
    Solved exactly; the default-cost path evaluates each DP row's entire
    predecessor window as one vectorized expression.
    """
    n = len(sentences)
    if n == 0:
        return []
    probas = markdown_chunklet_boundaries(sentences)
    statements = compute_num_statements(sentences)
    lengths = np.asarray([len(s) for s in sentences], dtype=np.int64)
    pref_len = np.concatenate(([0], np.cumsum(lengths)))
    pref_proba = np.concatenate(([0.0], np.cumsum(probas)))
    pref_stmt = np.concatenate(([0.0], np.cumsum(statements)))

    custom = boundary_cost is not None or statement_cost is not None
    if not custom:
        from raglite_tpu_torch.native import split_chunklet_cuts

        native_cuts = split_chunklet_cuts(
            probas, pref_proba, pref_stmt, pref_len, max_size=max_size
        )
        if native_cuts is not None:  # C++ fast path (native/postings.cpp)
            return [
                "".join(sentences[i:j])
                for i, j in zip([0, *native_cuts], [*native_cuts, n])
            ]
    dp = np.full(n + 1, np.inf)
    dp[0] = 0.0
    back = np.full(n + 1, -1, dtype=np.int64)
    if custom:
        boundary_cost = boundary_cost or (lambda p: (1.0 - p[0]) + float(np.sum(p[1:])))
        statement_cost = statement_cost or (lambda s: (s - 3.0) ** 2 / np.sqrt(max(s, 1e-6)) / 2.0)
    for i in range(1, n + 1):
        # Predecessors j with sentences[j:i] within max_size characters.
        lo = int(np.searchsorted(pref_len, pref_len[i] - max_size, side="left"))
        js = np.arange(lo, i)
        if js.size == 0:
            # A single sentence exceeds max_size: take it alone anyway.
            js = np.array([i - 1])
        if custom:
            costs = np.array(
                [
                    dp[j] + boundary_cost(probas[j:i]) + statement_cost(float(np.sum(statements[j:i])))
                    for j in js
                ]
            )
        else:
            s = pref_stmt[i] - pref_stmt[js]
            costs = (
                dp[js]
                + (1.0 - probas[js])
                + (pref_proba[i] - pref_proba[js + 1])
                + (s - 3.0) ** 2 / np.sqrt(np.maximum(s, 1e-6)) / 2.0
            )
        best = int(np.argmin(costs))
        dp[i] = costs[best]
        back[i] = js[best]
    cuts: list[int] = []
    i = int(back[n])
    while i > 0:
        cuts.append(i)
        i = int(back[i])
    cuts.reverse()
    return ["".join(sentences[i:j]) for i, j in zip([0, *cuts], [*cuts, n])]
