"""Dense answers, ``[(chunk ordinal, score), ...]`` of ``num_results``
chunks (``vector_search_batch``):

- ``score_err``: the largest distance between a returned score and the
  reference's score of that chunk: the query encoder's error as the
  scores carry it.
- ``order_gap``: the largest inversion of the answer's order against the
  reference's scores (cosine units): for chunks the program ranks a above
  b, how far b's reference score lies above a's.
- ``recall_miss``: the share of the reference's top chunks absent from the
  answers, an absent chunk that scores within the ``score_err`` limit of
  the reference's last counting as a tie.  Its limit is the one the route
  states: recall@10 against exact search of 0.99.
- ``rank_faults``: answers of the wrong length, with a chunk twice or a
  chunk the corpus lacks (exact: limit 0).
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.judge import inversion

__all__ = ["answers", "judge", "judge_answer"]


def judge_answer(answer: list[tuple[int, float]], top_s: np.ndarray, top_c: np.ndarray, own: dict[int, float],
                 num_results: int, tie: float) -> tuple[float, float, int, int]:
    """(score_err, order_gap, misses, rank_fault) of one answer: ``top_s``
    / ``top_c`` the reference's sorted best scores and their chunks,
    ``own`` its score of each returned chunk, ``tie`` the score distance
    within which an absent chunk counts as present."""
    ords = [o for o, _ in answer]
    if len(answer) != num_results or len(set(ords)) != len(ords) or any(o not in own for o in ords):
        return math.inf, math.inf, num_results, 1
    err = max(abs(s - own[o]) for o, s in answer)
    gap = inversion([own[o] for o in ords])
    kth = top_s[num_results - 1]
    misses = sum(1 for o, s in zip(top_c[:num_results].tolist(), top_s[:num_results]) if o not in own and s > kth + tie)
    return float(err), float(gap), misses, 0


def judge(ref, answers: list[list[tuple[int, float]]], limits: dict) -> dict:
    tie = float(limits["score_err"])
    k = ref.num_results
    errs, gaps, misses, faults = [], [], 0, 0
    n_chunks = ref.corpus.rows.shape[0] // ref.corpus.rows_per_chunk
    for b, answer in enumerate(answers):
        ords = np.array([o for o, _ in answer if 0 <= o < n_chunks], np.int64)
        own = dict(zip(ords.tolist(), ref.dense.scores(ref.emb[b], ords).tolist())) if ords.size else {}
        err, gap, miss, fault = judge_answer(answer, ref.top_s[b], ref.top_c[b], own, k, tie)
        errs.append(err)
        gaps.append(gap)
        misses += miss
        faults += fault
    return {
        "score_err": {"value": max(errs), "limit": tie},
        "order_gap": {"value": max(gaps), "limit": float(limits["order_gap"])},
        "recall_miss": {"value": misses / (len(answers) * k), "limit": float(limits["recall_miss"])},
        "rank_faults": {"value": faults, "limit": int(limits.get("rank_faults", 0))},
    }


def answers(ref) -> list[list[tuple[int, float]]]:
    k = ref.num_results
    return [list(zip(c[:k].tolist(), s[:k].tolist())) for s, c in zip(ref.top_s, ref.top_c)]
