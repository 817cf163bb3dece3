"""Split a document into sentences with a constrained dynamic program.

Counterpart of the reference's SaT-based splitter
(raglite/_split_sentences.py:56-219).  The ONNX SaT
model that produces per-character boundary probabilities is replaced by a
fast rule-based probability model (`heuristic_sentence_boundaries`); the
optimization itself — maximize the sum of above-threshold boundary
probabilities subject to min/max sentence lengths — is solved exactly with
a sliding-window-maximum DP, in C++ (native/postings.cpp) when the native
library builds, else in Python; the tests hold the two equal.
"""

from __future__ import annotations

import re
from collections import deque
from collections.abc import Callable

import numpy as np
from raglite_tpu_torch.utils.mdparse import parse_markdown

from raglite_tpu_torch.types import FloatVector

__all__ = [
    "split_sentences",
    "markdown_sentence_boundaries",
    "heuristic_sentence_boundaries",
]

#: Probability threshold above which a boundary is worth taking (the SaT
#: "-sm" default in the reference, _split_sentences.py:68).
SENTENCE_THRESHOLD = 0.25

# Common abbreviations that end with a period but rarely end a sentence.
_ABBREVIATIONS = frozenset(
    "mr mrs ms dr prof sr jr st no vol pp fig figs eq eqs sec ch cf vs etc al "
    "e.g i.e viz ca approx dept est min max resp ibid op cit ed eds trans rev "
    "inc ltd co corp univ assn bros".split()
)


def heuristic_sentence_boundaries(doc: str) -> FloatVector:
    """Rule-based per-character sentence-boundary probabilities.

    ``probas[i]`` is the probability that the character at index ``i`` is the
    last character of a sentence.  Replaces SaT's learned probabilities
    (reference: _split_sentences.py:15-20,181-182) with punctuation and
    layout heuristics tuned for prose and Markdown.
    """
    n = len(doc)
    probas = np.zeros(n, dtype=np.float64)
    if n == 0:
        return probas
    for m in re.finditer(r"[.!?;。！？…]+[\"'”’)\]]*", doc):
        end = m.end() - 1
        if end + 1 >= n:
            probas[end] = 0.9
            continue
        nxt = doc[end + 1]
        if not nxt.isspace() and doc[end] not in "。！？":
            continue  # e.g. "3.14", "U.S.A" — no boundary inside a token
        if doc[end] in "。！？":
            probas[end] = max(probas[end], 0.9)
            continue
        # Inspect the token before the punctuation for abbreviations.
        before = doc[max(0, m.start() - 24) : m.start()]
        token = re.split(r"[\s(\[\"']+", before)[-1] if before else ""
        punct = doc[m.start()]
        p = 0.85
        if punct == ".":
            if token.lower().rstrip(".") in _ABBREVIATIONS:
                p = 0.05
            elif len(token) == 1 and token.isupper():
                p = 0.05  # initials: "A. Einstein"
            elif token.isdigit() and len(token) <= 3:
                p = 0.3  # enumerations: "1. "
        elif punct == ";":
            p = 0.4
        # Following context: uppercase/digit start strengthens the boundary.
        after = doc[end + 1 : end + 8].lstrip()
        if after and (after[0].isupper() or after[0].isdigit() or after[0] in "\"'([#*-"):
            p = min(1.0, p + 0.1)
        elif after and after[0].islower():
            p = max(0.0, p - 0.45)
        probas[end] = max(probas[end], p)
    # Blank lines always terminate a sentence.
    for m in re.finditer(r"\n[ \t]*\n", doc):
        if m.start() > 0:
            probas[m.start() - 1] = max(probas[m.start() - 1], 0.95)
    # A lone newline is a weak signal (hard-wrapped prose).
    for m in re.finditer(r"\n", doc):
        i = m.start()
        if i > 0 and probas[i - 1] == 0.0 and probas[i] == 0.0:
            probas[i] = max(probas[i], 0.05)
    return probas


def markdown_sentence_boundaries(doc: str) -> FloatVector:
    """Known boundaries from Markdown headings: a heading is exactly one
    sentence (reference: _split_sentences.py:23-53).  Returns NaN where no
    override applies."""
    tokens = parse_markdown(doc)
    # markdown-it counts only \n lines (str.splitlines also splits on form
    # feeds etc., which would misplace every boundary after one).
    from raglite_tpu_torch.utils.mdparse import newline_offsets

    line_start = [*newline_offsets(doc), len(doc)]
    overrides = np.full(len(doc), np.nan)
    for token in tokens:
        if token.type == "heading_open" and token.map is not None:
            h_start = line_start[token.map[0]]
            # map[1] is the first line AFTER the heading, so the heading's
            # last character (its trailing newline) is at line_start-1 — the
            # boundary goes THERE.  (The reference's indexing puts it one
            # character later, gluing the next line's first character onto
            # the heading whenever no blank line follows; we fix that —
            # "a heading is exactly one sentence" is this module's contract.)
            h_end = line_start[token.map[1]]
            if 0 <= h_start - 1 < len(overrides):
                overrides[h_start - 1] = 1.0  # previous sentence ends before the heading
            overrides[h_start : h_end - 1] = 0.0  # no boundary inside the heading
            if 0 <= h_end - 1 < len(overrides):
                overrides[h_end - 1] = 1.0  # heading ends a sentence
    return overrides


def _solve_boundaries(
    probas: FloatVector, *, min_len: int, max_len: int | None
) -> list[int] | None:
    """Pick boundary positions maximizing ``sum(probas[i] - threshold)``
    subject to every resulting segment having length in [min_len, max_len].

    Returns boundary indices (position i = segment ends at character i), or
    None when no boundary assignment is valid (reference semantics:
    _split_sentences.py:115-131).  Uses a monotone-deque sliding-window
    maximum for O(n) (an infinite window degenerates to a running max).
    """
    from raglite_tpu_torch.native import solve_boundaries as native_solve

    native = native_solve(
        np.asarray(probas), min_len=min_len, window=max_len, threshold=SENTENCE_THRESHOLD
    )
    if native is not False:  # C++ fast path (native/postings.cpp)
        return native
    n = len(probas)
    window = max_len if max_len is not None else n + 1
    lo, hi = min_len - 1, n - min_len - 1
    if hi < lo:
        # Too short for any split: no-split is the answer ONLY when it
        # respects max_len; otherwise the instance is infeasible.
        return [] if max_len is None or n <= max_len else None
    scores = probas - SENTENCE_THRESHOLD
    dp = np.full(n, -np.inf)
    back = np.full(n, -1, dtype=np.int64)
    dq: deque[int] = deque()  # indices with decreasing dp values
    for i in range(lo, hi + 1):
        j = i - min_len
        if j >= lo and np.isfinite(dp[j]):
            while dq and dp[dq[-1]] <= dp[j]:
                dq.pop()
            dq.append(j)
        while dq and dq[0] < i - window:
            dq.popleft()
        if i + 1 <= window:  # first segment [0, i] fits
            dp[i] = scores[i]
        if dq and dp[dq[0]] + scores[i] > dp[i]:
            dp[i] = dp[dq[0]] + scores[i]
            back[i] = dq[0]
    # The final boundary must leave a valid trailing segment.
    tail_lo = max(lo, n - window - 1) if max_len is not None else lo
    no_split_ok = max_len is None or n <= max_len
    best, best_i = (0.0 if no_split_ok else -np.inf), -1
    for i in range(tail_lo, hi + 1):
        if dp[i] > best:
            best, best_i = dp[i], i
    if best_i == -1:
        return [] if no_split_ok else None
    out: list[int] = []
    pos = best_i
    while pos >= 0:
        out.append(pos)
        pos = back[pos]
    out.reverse()
    return out


def split_sentences(
    doc: str,
    min_len: int = 4,
    max_len: int | None = None,
    boundary_probas: FloatVector | Callable[[str], FloatVector] = markdown_sentence_boundaries,
    base_probas: Callable[[str], FloatVector] | str | None = None,
    *,
    device: str = "cuda",
) -> list[str]:
    """Split a document into sentences (reference: _split_sentences.py:146-219).

    Sentences contain at least one non-whitespace character, carry their
    trailing whitespace, never start with whitespace (except possibly the
    first), and respect ``min_len``/``max_len``.

    ``base_probas`` selects the per-character boundary model: "heuristic"
    (default, rule-based), "learned" (models/boundary.py, the SaT
    replacement, run on ``device``: the card unless the caller asks for
    the CPU), or any callable.
    ``boundary_probas`` remains the Markdown-override channel on top.
    """
    if len(doc) <= min_len:
        return [doc]
    if base_probas is None or base_probas == "heuristic":
        probas = heuristic_sentence_boundaries(doc)
    elif base_probas == "learned":
        from raglite_tpu_torch.models.boundary import learned_sentence_boundaries

        probas = np.asarray(learned_sentence_boundaries(doc, device=device), dtype=np.float64)
    else:
        probas = np.asarray(base_probas(doc), dtype=np.float64)
    overrides = boundary_probas(doc) if callable(boundary_probas) else boundary_probas
    known = np.isfinite(overrides)
    probas[known] = overrides[known]
    # Shift boundaries so whitespace trails rather than leads sentences
    # (reference: _split_sentences.py:188-196): within each internal
    # whitespace run, the minimum probability fills the run and the maximum
    # lands on the last whitespace character.
    for m in re.finditer(r"\S\s+(?=\S)", doc):
        a, b = m.start(), m.end()  # doc[a] non-ws, doc[a+1:b] whitespace
        mn, mx = float(np.min(probas[a:b])), float(np.max(probas[a:b]))
        probas[a : b - 1] = mn
        probas[b - 1] = mx
    # Two-pass solve: global without max_len, then re-split oversized
    # sentences with the constraint (reference: _split_sentences.py:197-218).
    boundaries = _solve_boundaries(probas, min_len=min_len, max_len=None)
    assert boundaries is not None
    cuts = [b + 1 for b in boundaries]
    sentences = [doc[i:j] for i, j in zip([0, *cuts], [*cuts, len(doc)])]
    if max_len is not None:
        refined: list[str] = []
        pos = 0
        for sentence in sentences:
            if len(sentence) <= max_len:
                refined.append(sentence)
            else:
                sub = _solve_boundaries(
                    probas[pos : pos + len(sentence)], min_len=min_len, max_len=max_len
                )
                if sub is None:
                    msg = "Sentence partition failed: no valid split satisfies the constraints."
                    raise ValueError(msg)
                sub_cuts = [b + 1 for b in sub]
                refined.extend(
                    sentence[i:j] for i, j in zip([0, *sub_cuts], [*sub_cuts, len(sentence)])
                )
            pos += len(sentence)
        sentences = refined
    return sentences
