"""Hybrid answers, ``[(chunk ordinal, fused score), ...]`` of
``num_results`` chunks (``hybrid_search_batch``): the dense route and BM25,
each giving its top 2 x num_results, fused by raglite's weighted RRF.

Each answer's fused scores are first decomposed into the two sides' ranks:
the keyword rank from the reference's BM25 (up to float32 near-ties), the
dense rank from what is left.  Then:

- ``order_gap``: the largest inversion of the answer's dense order against
  the reference's dense scores (cosine units).  An order is judged, not
  each position: the int4 route may drop a row whose bucket it shares with
  a better one, which shifts the ranks below it but reorders nothing.
- ``recall_miss``: the share of answer places owed to a chunk the answer
  leaves out although the dense side must have brought it and its
  smallest possible fused score lies above the answer's last: a chunk in
  the reference's dense top that clears the dense list by more than the
  ``order_gap`` limit.  Its limit is the route's stated 0.01 (recall@10 of
  0.99 against exact search): the drops that ``order_gap`` lets pass.
- ``rank_faults``: answers that are malformed, whose fused scores no ranks
  of the two sides can produce, or that leave out a keyword-only chunk
  fusing above their last result (exact: limit 0).
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.judge import inversion
from benchmark.reference.search import BM25, RRF_K, W_DENSE, W_KW

__all__ = ["KW_REL_TIE", "answers", "judge", "judge_answer"]

#: Relative distance within which two BM25 scores may trade places in the
#: program: it sums at most 32 float32 weights, each rounded once (2^-24),
#: so its scores carry a relative error under 32 x 2 x 2^-24 = 3.8e-6.
KW_REL_TIE = 1e-5
#: Distance within which a fused score matches a decomposition: float32
#: rounding of w / (60 + r) sums near 0.016 is about 1e-9.
RRF_ATOL = 1e-6
#: A returned chunk's dense rank must be an integer to within this.
RANK_ATOL = 0.01


def _kw_ranks(kw_scores: dict[int, float], ranking: list[int], depth: int) -> dict[int, tuple[int, int]]:
    """Each keyword candidate's admissible rank interval [lo, hi]: its own
    rank widened over chunks whose BM25 scores lie within KW_REL_TIE of its
    own but differ from it (exact ties keep the ordinal order)."""
    scores = np.array([kw_scores[o] for o in ranking])
    out = {}
    for r, o in enumerate(ranking[: depth + 64]):
        s = scores[r]
        near = np.flatnonzero((np.abs(scores - s) <= KW_REL_TIE * abs(s)) & (scores != s))
        lo, hi = r, r
        if near.size:
            lo, hi = min(r, int(near.min())), max(r, int(near.max()))
        out[o] = (lo, hi)
    return out


def judge_answer(  # noqa: PLR0913
    answer: list[tuple[int, float]],
    dense_top: np.ndarray,
    dense_top_c: np.ndarray,
    dense_score,
    kw_scores: dict[int, float],
    num_results: int,
    tie: float,
) -> tuple[float, int, int]:
    """(order_gap, misses, rank_fault) of one answer.  ``dense_top`` /
    ``dense_top_c``: the reference's best dense scores, sorted, and their
    chunks, 2 x num_results of them; ``dense_score(ordinals)``: its dense
    scores of any chunks; ``kw_scores``: its BM25 scores of every chunk
    holding a query word; ``tie``: the dense score distance within which
    the program may order two chunks either way."""
    depth = 2 * num_results  # each side's list (raglite's oversample of 2)
    ranking = BM25.ranking(kw_scores)
    kw_rank = _kw_ranks(kw_scores, ranking, depth)
    ords = [o for o, _ in answer]
    fused = [s for _, s in answer]
    if len(answer) != num_results or len(set(ords)) != len(ords):
        return math.inf, num_results, 1
    if any(b > a + RRF_ATOL for a, b in zip(fused, fused[1:])):
        return math.inf, num_results, 1

    def kw_options(o: int) -> list[int | None]:
        """Keyword ranks the program may have given ``o`` (None: outside)."""
        if o not in kw_rank:
            return [None]
        lo, hi = kw_rank[o]
        opts: list[int | None] = list(range(lo, min(hi, depth - 1) + 1))
        if hi >= depth:
            opts.append(None)
        return opts

    def kw_least(o: int) -> float:
        """The smallest keyword share of ``o``'s fused score."""
        worst = kw_options(o)[-1]
        return 0.0 if worst is None else W_KW / (RRF_K + worst)

    ranked: list[tuple[int, int]] = []  # (dense rank, ordinal) of chunks in the program's dense list
    for o, s in answer:
        ranks = []
        for rk in kw_options(o):
            part = s - (W_KW / (RRF_K + rk) if rk is not None else 0.0)
            if abs(part) <= RRF_ATOL:
                ranks.append(None)
                continue
            if part < 0:
                continue
            x = W_DENSE / part - RRF_K
            rd = round(x)
            if abs(x - rd) <= RANK_ATOL and 0 <= rd < depth:
                ranks.append(rd)
        if not ranks:
            return math.inf, num_results, 1
        if ranks[0] is not None:
            ranked.append((ranks[0], o))
    ranked.sort()
    scores = dense_score(np.array([o for _, o in ranked], np.int64)).tolist() if ranked else []
    gap = inversion(scores)
    last = fused[-1]
    outside = dense_top[depth - 1] - tie
    # A chunk left out that only the keyword side can bring (its dense score
    # clearly below the dense list) must fuse no higher than the last result.
    for o in set(ranking[:depth]) - set(ords):
        if kw_least(o) > last + RRF_ATOL and dense_score(np.array([o]))[0] < outside:
            return math.inf, num_results, 1
    # A chunk left out that the dense side must bring (it clears the dense
    # list's last by more than ``tie``): at worst every chunk within ``tie``
    # of it ranks above it; if it fuses above the last result even so, the
    # dense route dropped it.
    misses = 0
    for s, o in zip(dense_top[:depth].tolist(), dense_top_c[:depth].tolist()):
        if o in ords or s <= dense_top[depth - 1] + tie:
            continue
        worst_rank = int(np.sum(dense_top[:depth] > s - tie)) - 1
        if W_DENSE / (RRF_K + worst_rank) + kw_least(o) > last + RRF_ATOL:
            misses += 1
    return float(gap), misses, 0


def judge(ref, answers: list[list[tuple[int, float]]], limits: dict) -> dict:
    tie = float(limits["order_gap"])
    k = ref.num_results
    bm25 = BM25(ref.corpus.bodies, ref.queries)
    gaps, misses, faults = [], 0, 0
    for b, answer in enumerate(answers):
        gap, miss, fault = judge_answer(answer, ref.top_s[b], ref.top_c[b],
                                        lambda o, b=b: ref.dense.scores(ref.emb[b], o),
                                        bm25.scores(ref.queries[b]), k, tie)
        gaps.append(gap)
        misses += miss
        faults += fault
    return {
        "order_gap": {"value": max(gaps), "limit": tie},
        "recall_miss": {"value": misses / (len(answers) * k), "limit": float(limits["recall_miss"])},
        "rank_faults": {"value": faults, "limit": int(limits.get("rank_faults", 0))},
    }


def answers(ref) -> list[list[tuple[int, float]]]:
    """raglite's hybrid search over the reference's exact sides."""
    depth = 2 * ref.num_results
    bm25 = BM25(ref.corpus.bodies, ref.queries)
    out = []
    for b, q in enumerate(ref.queries):
        fused: dict[int, float] = {}
        for r, o in enumerate(ref.top_c[b][:depth].tolist()):
            fused[o] = fused.get(o, 0.0) + W_DENSE / (RRF_K + r)
        for r, o in enumerate(BM25.ranking(bm25.scores(q))[:depth]):
            fused[o] = fused.get(o, 0.0) + W_KW / (RRF_K + r)
        ranked = sorted(fused, key=lambda o: -fused[o])[: ref.num_results]
        out.append([(o, float(np.float32(fused[o]))) for o in ranked])
    return out
