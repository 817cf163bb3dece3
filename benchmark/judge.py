"""The comparison that decides ``correct``.

After the window, a seeded sample of the window's answers is held to the
reference's exact answers for the same queries (:func:`judge_window`).
The work every kind of answer shares is done here once: the reference's
tokenizer and encoder embed the sampled queries, and exact dense search
finds their best chunks (:class:`Reference`).  The answers themselves are
judged by ``judges/<kind>.py``, the kind named by the entry that produced
them (its ``ANSWER``): ``judge(ref, answers, limits)`` returns the numbers
compared, each with its limit, and ``answers(ref)`` gives the reference's
own answers, which the control puts in the program's place.  Every kind
reports ``rank_faults`` (malformed answers; exact, limit 0); the run adds
``failed`` (requests of the window that raised; exact).

The numbers are taken in the score space of the dense side, where the
program and the reference differ by rounding alone.  An answer from
another query, a dropped or altered chunk, or a coarser encoder reads as a
large gap, a recall miss or a rank fault.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark.reference.encoder import ReferenceEncoder
from benchmark.reference.search import HYBRID_OVERSAMPLE, DenseExact
from benchmark.reference.tokenizers import load_tokenizer
from benchmark.run import load_plugin, log

__all__ = ["Reference", "inversion", "judge_window", "reference_answers"]


@dataclass
class Reference:
    """The reference's view of a sample of queries."""

    queries: list[str]
    emb: np.ndarray  # [B, d] the reference encoder's embeddings
    dense: DenseExact  # exact dense search over the corpus's rows
    corpus: object  # corpus.Corpus
    num_results: int
    top_s: np.ndarray  # [B, 2 x num_results] best dense scores, descending
    top_c: np.ndarray  # [B, 2 x num_results] their chunk ordinals

    @classmethod
    def build(cls, cell, queries: list[str], corpus, *, device: str, root: Path, weights: str = "served"):
        config = cell.config
        num_results = int(cell.traffic.get("request", {}).get("num_results", 5))
        tokenizer = load_tokenizer(config["reference"]["tokenizer"], root)
        encoder = ReferenceEncoder(config["reference"]["encoder"], root, device=device, weights=weights)
        emb = encoder.embed([tokenizer.encode(q) for q in queries])
        del encoder
        dense = DenseExact(corpus.rows, corpus.rows_per_chunk, device=device)
        top_s, top_c = dense.top(emb, HYBRID_OVERSAMPLE * num_results)
        return cls(queries, emb, dense, corpus, num_results, top_s, top_c)


def inversion(scores: list[float]) -> float:
    """The largest s[j] - s[i] over i < j (0 for a descending list)."""
    gap, low = 0.0, math.inf
    for s in scores:
        gap = max(gap, s - low)
        low = min(low, s)
    return gap


def judge_window(cell, kind: str, sample: list[tuple[int, list]], pool: list[str], corpus, *, device: str,
                 root: Path) -> dict:
    """The numbers compared: the answers of kind ``kind`` to the sampled
    positions (``sample``: position, answer) against the reference."""
    if not sample:
        return {"answered": {"value": 0, "limit": -1}}
    ref = Reference.build(cell, [pool[p] for p, _ in sample], corpus, device=device, root=root)
    checks = load_plugin("judges", kind).judge(ref, [a for _, a in sample], cell.limits)
    log(f"judged {len(sample)} sampled answers ({kind}) against the reference")
    return checks


def reference_answers(cell, kind: str, queries: list[str], corpus, *, device: str, weights: str, root: Path):
    """The reference's own answers of kind ``kind`` (with ``weights``) to
    ``queries``."""
    ref = Reference.build(cell, queries, corpus, device=device, root=root, weights=weights)
    return load_plugin("judges", kind).answers(ref)
