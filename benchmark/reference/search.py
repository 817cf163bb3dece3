"""Exact dense search, Okapi BM25 and weighted reciprocal-rank fusion.

- Dense: a chunk's score is the largest dot product of the query with its
  rows (rows as served, bfloat16 values; the query as the reference
  encoder gives it), over every chunk: no candidate stage.
- BM25: ``\\w+`` lowercased words; idf = ln(1 + (N - df + 0.5) / (df +
  0.5)); a chunk's score sums, over the query's distinct words it holds,
  idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * len / avg_len)), with
  k1 1.2 and b 0.75; ties rank the lower ordinal first.
- RRF: a chunk's fused score is w_dense / (60 + dense rank) + w_kw / (60 +
  keyword rank), ranks from 0, over each side's top list; the hybrid
  search of raglite takes each side's top 2 x num_results, weighs the
  dense side 0.75 and the keyword side 0.25.
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np
import torch

from benchmark.reference.encoder import full_f32

__all__ = ["BM25", "DenseExact", "K1", "B", "RRF_K", "W_DENSE", "W_KW", "HYBRID_OVERSAMPLE"]

K1, B = 1.2, 0.75
RRF_K = 60
W_DENSE, W_KW = 0.75, 0.25
HYBRID_OVERSAMPLE = 2
_WORD = re.compile(r"\w+", re.UNICODE)


class DenseExact:
    """Every chunk's score against a block of queries, on ``device``."""

    def __init__(self, rows: np.ndarray, rows_per_chunk: int, *, device: str, block: int = 1 << 18) -> None:
        if rows.shape[0] % rows_per_chunk:
            msg = "every chunk holds rows_per_chunk rows"
            raise ValueError(msg)
        self.rows = rows  # [N, d] float16 as the benchmark made them
        self.per_chunk = rows_per_chunk
        self.device = torch.device(device)
        self.block = block - block % rows_per_chunk

    def _served(self, lo: int, hi: int) -> torch.Tensor:
        return torch.from_numpy(self.rows[lo:hi]).to(self.device).to(torch.bfloat16).to(torch.float32)

    @torch.inference_mode()
    def top(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(scores [B, k] float64 descending, chunk ordinals [B, k]); the
        scores of the selected chunks recomputed in float64."""
        q = torch.from_numpy(queries.astype(np.float32)).to(self.device)
        best_s, best_c = [], []
        with full_f32():
            for lo in range(0, self.rows.shape[0], self.block):
                hi = min(lo + self.block, self.rows.shape[0])
                sims = (q @ self._served(lo, hi).T).view(q.shape[0], -1, self.per_chunk).amax(dim=2)
                s, c = sims.topk(min(k, sims.shape[1]), dim=1)
                best_s.append(s)
                best_c.append(c + lo // self.per_chunk)
        s, pos = torch.cat(best_s, dim=1).topk(k, dim=1)
        chunks = torch.cat(best_c, dim=1).gather(1, pos).cpu().numpy()
        exact = np.stack([self.scores(queries[b], chunks[b]) for b in range(len(queries))])
        order = np.argsort(-exact, axis=1, kind="stable")
        return np.take_along_axis(exact, order, 1), np.take_along_axis(chunks, order, 1)

    def scores(self, query: np.ndarray, chunks: np.ndarray) -> np.ndarray:
        """float64 scores of ``chunks`` for one query."""
        rows = np.asarray(chunks)[:, None] * self.per_chunk + np.arange(self.per_chunk)[None, :]
        served = torch.from_numpy(self.rows[rows.ravel()]).to(torch.bfloat16).to(torch.float64).numpy()
        sims = served @ query.astype(np.float64)
        return sims.reshape(len(chunks), self.per_chunk).max(axis=1)


class BM25:
    """Okapi BM25 over chunk texts (ordinal = position in ``texts``).
    Postings are kept for the words of ``queries`` alone; lengths, the
    average length and df are the whole corpus's."""

    def __init__(self, texts: list[str], queries: list[str]) -> None:
        self.n = len(texts)
        wanted = {w for q in queries for w in _WORD.findall(q.lower())}
        postings: dict[str, list[tuple[int, int]]] = {w: [] for w in wanted}
        lengths = np.zeros(self.n, np.float64)
        for ordinal, text in enumerate(texts):
            words = _WORD.findall(text.lower())
            lengths[ordinal] = len(words)
            for word, tf in Counter(w for w in words if w in wanted).items():
                postings[word].append((ordinal, tf))
        self.avg_len = max(float(lengths.mean()), 1.0) if self.n else 1.0
        self.norm = (1.0 - B) + B * lengths / self.avg_len
        self.postings = {
            w: (np.array([o for o, _ in p], np.int64), np.array([t for _, t in p], np.float64))
            for w, p in postings.items() if p
        }

    def scores(self, query: str) -> dict[int, float]:
        """{ordinal: score} of every chunk holding a word of ``query``."""
        total: dict[int, float] = {}
        for word in dict.fromkeys(_WORD.findall(query.lower())):
            if word not in self.postings:
                continue
            ordinals, tf = self.postings[word]
            df = len(ordinals)
            idf = np.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
            weights = idf * tf * (K1 + 1.0) / (tf + K1 * self.norm[ordinals])
            for o, w in zip(ordinals.tolist(), weights.tolist()):
                total[o] = total.get(o, 0.0) + w
        return total

    @staticmethod
    def ranking(scores: dict[int, float]) -> list[int]:
        """Ordinals by score descending, the lower ordinal first on ties."""
        return sorted(scores, key=lambda o: (-scores[o], o))
