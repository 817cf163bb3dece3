"""The port's C++ HNSW baseline (native/hnsw.cpp, ``HnswIndex``) and the
recall comparison built on it, against the JAX package's on the CPU.

The two packages compile the same source with the same seed, so the same
vectors give the same graph: ids, scores (bit for bit), size and memory are
held equal, after one ``add`` and after a second.  The cases of
tests/test_hnsw_baseline.py follow at 2,000 rows (the graph is built in one
thread): recall on clustered data, the exact scan beside HNSW at less
memory (every key of the report equal to the JAX package's), and the
``hnsw`` variant of the IR benchmark.
"""

from __future__ import annotations

import numpy as np
import pytest

from raglite_tpu.native import HnswIndex as JaxHnsw
from raglite_tpu.native import native_available as jax_native_available
from raglite_tpu_torch.native import HnswIndex, native_available

pytestmark = pytest.mark.skipif(not (native_available() and jax_native_available()), reason="no C++ toolchain")


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    rows = rng.normal(size=(n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_ids_and_scores_equal_jax_bit_for_bit(metric: str) -> None:
    rng = np.random.default_rng(3)
    first, second, queries = _unit_rows(rng, 700, 32), _unit_rows(rng, 300, 32), _unit_rows(rng, 40, 32)
    ours, theirs = HnswIndex(32, M=16, metric=metric), JaxHnsw(32, M=16, metric=metric)
    for batch in (first, second):
        ours.add(batch)
        theirs.add(batch)
        assert len(ours) == len(theirs) and ours.memory_bytes == theirs.memory_bytes
        for k, ef in ((10, 160), (25, 40)):
            (ids, scores), (want_ids, want_scores) = ours.search(queries, k, ef_search=ef), theirs.search(queries, k, ef_search=ef)
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_array_equal(scores.view(np.int32), want_scores.view(np.int32))
    assert len(ours) == 1000


def test_empty_index_and_shape_checks() -> None:
    index = HnswIndex(8)
    ids, scores = index.search(np.zeros((2, 8), np.float32), 3)
    assert (ids == -1).all() and (scores == 0).all() and len(index) == 0
    with pytest.raises(ValueError, match="expected"):
        index.add(np.zeros((2, 7), np.float32))
    with pytest.raises(ValueError, match="expected"):
        index.search(np.zeros((1, 9), np.float32), 1)


def test_hnsw_index_recall_on_clustered_data() -> None:
    rng = np.random.default_rng(0)
    n, d = 2000, 48
    centers = rng.normal(size=(20, d)).astype(np.float32)
    rows = centers[rng.integers(0, 20, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index = HnswIndex(d, M=16, ef_construction=150, metric="cosine")
    index.add(rows)
    assert len(index) == n
    queries = rows[:48] + 0.1 * rng.normal(size=(48, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    ids, scores = index.search(queries, 10, ef_search=160)
    exact = np.argsort(-(queries @ rows.T), axis=1)[:, :10]
    recall = np.mean([len(set(ids[i]) & set(exact[i])) / 10 for i in range(48)])
    assert recall >= 0.9, recall  # a broken graph scores ~0.1 here
    assert all(np.all(np.diff(scores[i]) <= 1e-5) for i in range(48))


def test_scan_beats_hnsw_at_less_memory_and_equals_jax() -> None:
    """The claim, measured on the CPU: the exact f16 scan at least as good
    as HNSW at half its memory or less, the int8 scan at less than half;
    every number of the report equal to the JAX package's (the scans' are
    recall over the same 2,000 rows and the same queries)."""
    from raglite_tpu.irbench import hnsw_recall_comparison as jax_comparison
    from raglite_tpu_torch.irbench import hnsw_recall_comparison

    report = hnsw_recall_comparison(num_rows=2_000, dim=64, num_queries=32, device="cpu")
    assert report == jax_comparison(num_rows=2_000, dim=64, num_queries=32)
    assert report["tpu_fp16_recall"] >= report["hnsw_recall"] - 1e-9, report
    assert report["tpu_fp16_memory_bytes"] < report["hnsw_memory_bytes"], report
    assert report["tpu_int8_memory_bytes"] < 0.5 * report["hnsw_memory_bytes"], report
    assert report["tpu_int8_recall"] >= 0.95, report


def test_hnsw_evaluator_in_ir_benchmark(tmp_path, monkeypatch) -> None:
    from raglite_tpu_torch.config import RAGLiteConfig
    from raglite_tpu_torch.irbench import run_ir_benchmark

    monkeypatch.setenv("RAGLITE_TPU_BENCH_CACHE", str(tmp_path / "cache"))
    config = RAGLiteConfig(store_path=str(tmp_path / "store"), embedder="hash:256", llm="echo", device="cpu")
    table = run_ir_benchmark(
        dataset="synthetic", measure="AP@10", num_queries=12, variants=("multivector", "hnsw"), config=config,
    )
    assert set(table.index) == {"multivector", "hnsw"}
    assert table.loc["hnsw", "AP@10"] > 0.5
    assert table.loc["multivector", "AP@10"] >= table.loc["hnsw", "AP@10"] - 0.05
