"""The traffic generator and the corpus are fixed by the seed."""

import numpy as np

from benchmark.corpus import make_corpus
from benchmark.reference.tokenizers import Bytes
from benchmark.tests.tiny import TINY_CONFIG, TRAFFIC
from benchmark.traffic import query_pool, token_counts


def test_pool_is_deterministic_by_seed():
    tok = Bytes()
    a = query_pool(TRAFFIC["hyb"], TINY_CONFIG, tok, 2**33 + 5)
    b = query_pool(TRAFFIC["hyb"], TINY_CONFIG, tok, 2**33 + 5)
    c = query_pool(TRAFFIC["hyb"], TINY_CONFIG, tok, 2**33 + 6)
    assert a == b and a != c


def test_every_seed_gets_the_same_lengths_within_its_bounds():
    tok = Bytes()
    lo, hi = TINY_CONFIG["query_tokens"]
    counts = [sorted(token_counts(query_pool(TRAFFIC["vec"], TINY_CONFIG, tok, s), tok)) for s in (1, 2)]
    for c in counts:
        assert lo - 8 <= min(c) and max(c) <= hi
    # Lengths are drawn at fixed quantiles; words fill them to within a word.
    assert abs(np.median(counts[0]) - np.median(counts[1])) <= 8


def test_queries_use_the_tail_vocabulary_and_cap_distinct_words():
    pool = query_pool(TRAFFIC["hyb"], TINY_CONFIG, Bytes(), 7)
    for q in pool:
        words = q.split()
        assert words and len(set(words)) <= TRAFFIC["hyb"]["queries"]["max_unique_terms"]
        assert all(200 <= int(w[1:]) < TINY_CONFIG["corpus"]["vocab"] for w in words)


def test_corpus_is_deterministic_by_seed():
    a = make_corpus(TINY_CONFIG["corpus"], 256, 2**32 + 11, "cpu")
    b = make_corpus(TINY_CONFIG["corpus"], 256, 2**32 + 11, "cpu")
    c = make_corpus(TINY_CONFIG["corpus"], 256, 2**32 + 12, "cpu")
    assert np.array_equal(a.rows, b.rows) and a.bodies == b.bodies
    assert not np.array_equal(a.rows, c.rows) and a.bodies != c.bodies
    norms = np.linalg.norm(a.rows.astype(np.float32), axis=1)
    assert a.rows.shape == (6000, 256) and np.allclose(norms, 1.0, atol=2e-3)
    assert all(len(b.split()) == 12 for b in a.bodies)
