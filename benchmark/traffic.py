"""The one traffic generator: a query pool from a traffic file and a seed.

A traffic file (``traffic/<name>.json``) gives the entry it drives and its
load (``entry``, ``arrivals``, ``clients``, ``batch``, and ``request``, the
keyword arguments of each call) and how queries are made (``queries``):

- ``pool``: how many distinct queries a run cycles through;
- ``terms``: words ``w<t>`` from the background's vocabulary, ``t`` =
  ``rank_from`` + (zipf(``a``) mod (vocab - ``rank_from``)), the informative
  tail that ``tail_queries`` in ``chip_smoke.py`` draws from, so BM25 finds
  postings;
- ``max_unique_terms``: a cap on a query's distinct words.

Lengths are in the configuration's own tokens, between the two bounds of
its ``query_tokens``, log-uniform: the same set of lengths for every seed
(the pool's quantiles), in an order the seed draws.  A query grows word by
word while its token count stays within its length.  Requests are sent in
pool order, cycling.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["query_pool", "token_counts"]


def _lengths(lo: int, hi: int, count: int) -> np.ndarray:
    """``count`` log-uniform lengths in [lo, hi] at the distribution's
    quantiles (the same set for every seed)."""
    q = (np.arange(count) + 0.5) / count
    return np.floor(np.exp(math.log(lo) + q * (math.log(hi + 1) - math.log(lo)))).astype(np.int64)


def query_pool(traffic: dict, config: dict, tokenizer, seed: int) -> list[str]:
    """The pool of queries a run sends, in sending order."""
    spec = traffic["queries"]
    count = int(spec["pool"])
    terms = spec["terms"]
    vocab = int(config["corpus"]["vocab"])
    rank_from = int(terms["rank_from"])
    lo, hi = (int(x) for x in config["query_tokens"])
    rng = np.random.default_rng([seed, 1])
    lengths = rng.permutation(_lengths(lo, hi, count))
    cost: dict[str, int] = {}
    pool = []
    for length in lengths.tolist():
        words: list[str] = []
        used = 0
        while True:
            t = rank_from + int(rng.zipf(float(terms["a"]))) % (vocab - rank_from)
            word = f"w{t}"
            if word not in cost:
                # A word's tokens with its leading space: a query's count
                # is the sum of its words' (each is its own pre-token).
                cost[word] = len(tokenizer.encode(" " + word))
            if used + cost[word] > length or len(set(words) | {word}) > int(spec["max_unique_terms"]):
                if words:
                    break
                continue  # the first word always fits in some draw
            words.append(word)
            used += cost[word]
        pool.append(" ".join(words))
    return pool


def token_counts(queries: list[str], tokenizer) -> list[int]:
    """Each query's tokens as the configuration's tokenizer counts them."""
    return [len(tokenizer.encode(q)) for q in queries]
