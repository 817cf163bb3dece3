"""The port's held-out IR evaluation (raglite_tpu_torch/train/
semantic_ir_bench.py) against scripts/semantic_ir_bench.py, beir_run.py and
rerank_blend_sweep.py, on the CPU.

The scripts are imported from scripts/ with ``JAX_COMPILATION_CACHE_DIR``
set to a temporary directory first (they set a persistent compile cache in
the repo otherwise) and ``HELDOUT`` pointed at a seeded ``heldout.jsonl``,
so nothing is written into the repo.  Held here: the protocol's texts,
queries and adapter queries (equal), ``doc_ranking`` and
``evaluate_variant`` (equal, apart from ``seconds``), ``export_beir``'s
files (byte for byte) and its reuse guard, and both ``main``s at 30
documents, 8 queries and 16 adapter queries on ``hash:256`` (each
variant's MRR@10, nDCG@10 and recall@10 equal to 4 decimals, as both
round them; the blend sweep's rows likewise).
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from raglite_tpu_torch.train import semantic_ir_bench as tsib

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--docs", "30", "--queries", "8", "--adapter-queries", "16"]
METRICS = ("variant", "mrr_at_10", "ndcg_at_10", "recall_at_10", "queries")


def write_heldout(path: Path, n: int = 48, seed: int = 0) -> Path:
    """A ``heldout.jsonl`` of ``n`` documents drawn with numpy: each
    document's sentences (6-21 words, ending in . ! or ?) take a quarter of
    their words from its own topic and the rest from a shared pool; every
    fourth document is short (< 500 characters, dropped by the protocol)
    and every third one puts its sentences on lines of their own."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    pool = ["".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(400)]
    with open(path, "w") as f:
        for i in range(n):
            topic = rng.choice(pool, 30, replace=False)
            sentences = []
            for _ in range(int(rng.integers(2, 4) if i % 4 == 0 else rng.integers(6, 14))):
                words = [str(rng.choice(topic if rng.random() < 0.25 else pool)) for _ in range(int(rng.integers(6, 22)))]
                sentences.append(" ".join(words).capitalize() + str(rng.choice([".", "!", "?"])))
            text = ("\n" if i % 3 == 0 else " ").join(sentences)
            f.write(json.dumps({"id": f"{int(rng.integers(1 << 62)):016x}", "title": f"doc {i}", "text": text}) + "\n")
    return path


@pytest.fixture
def heldout(tmp_path) -> Path:
    (tmp_path / "corpus").mkdir()
    return write_heldout(tmp_path / "corpus" / "heldout.jsonl")


@pytest.fixture
def scripts(monkeypatch, tmp_path, heldout):
    """scripts/semantic_ir_bench.py, beir_run.py and rerank_blend_sweep.py
    as modules, reading ``heldout``."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    names = ("semantic_ir_bench", "beir_run", "rerank_blend_sweep")
    for name in names:
        sys.modules.pop(name, None)
    sib = importlib.import_module("semantic_ir_bench")
    monkeypatch.setattr(sib, "HELDOUT", heldout)
    yield sib, importlib.import_module("beir_run"), importlib.import_module("rerank_blend_sweep")
    for name in names:
        sys.modules.pop(name, None)


def _script_main(monkeypatch, module, argv: list[str]) -> None:
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [f"{module.__name__}.py", *argv])
        module.main()


@pytest.mark.parametrize(("n_docs", "n_queries", "n_adapter", "seed"), [(30, 8, 16, 0), (48, 5, 0, 3), (12, 20, 20, 7), (40, 0, 9, 1)])
def test_protocol_equals_the_script(scripts, heldout, n_docs, n_queries, n_adapter, seed) -> None:
    sib, _, _ = scripts
    want = sib.load_protocol(n_docs, n_queries, n_adapter, seed)
    got = tsib.load_protocol(n_docs, n_queries, n_adapter, seed, heldout=heldout)
    assert got == want
    assert list(got[0]) == list(want[0])  # the insertion order too


class _Chunk:
    def __init__(self, document_id: str) -> None:
        self.document_id = document_id


class _Store:
    """``get_chunk`` over chunk ids "c<i>" of documents "d<i % 7>"; ids
    ending in 9 are missing (deleted)."""

    def get_chunk(self, cid: str):
        return None if cid.endswith("9") else _Chunk(f"d{int(cid[1:]) % 7}")


def test_ranking_and_evaluation_equal_the_script(scripts) -> None:
    sib, _, _ = scripts
    rng = np.random.default_rng(0)
    store = _Store()
    runs = []
    for _ in range(20):
        ids = [f"c{i}" for i in rng.permutation(40)[: int(rng.integers(0, 30))]]
        scores = np.round(rng.random(len(ids)), 1)  # ties between documents
        runs.append((ids, scores))
        for k in (3, 10):
            assert tsib.doc_ranking(ids, scores, store, k) == sib.doc_ranking(ids, scores, store, k)
    queries = [(f"q{i}", f"d{i % 9}") for i in range(len(runs))]
    by_query = dict(zip((q for q, _ in queries), runs))

    def search(query: str) -> list[str]:
        return sib.doc_ranking(*by_query[query], store)

    got = tsib.evaluate_variant("v", search, queries, store)
    want = sib.evaluate_variant("v", search, queries, store)
    assert {k: v for k, v in got.items() if k != "seconds"} == {k: v for k, v in want.items() if k != "seconds"}


def test_export_beir_equals_the_script(scripts, heldout, tmp_path) -> None:
    _, beir, _ = scripts
    beir.export_beir(tmp_path / "want", 30, 8)
    tsib.export_beir(tmp_path / "got", 30, 8, heldout=heldout)
    files = ("corpus.jsonl", "queries.jsonl", "qrels.tsv", "export_meta.json")
    for name in files:
        assert (tmp_path / "got" / name).read_bytes() == (tmp_path / "want" / name).read_bytes(), name
    for n_docs, n_queries in ((30, 8), (30, 9), (31, 8)):
        assert tsib._export_matches(tmp_path / "got", n_docs, n_queries) == beir._export_matches(tmp_path / "want", n_docs, n_queries)
    (tmp_path / "got" / "export_meta.json").write_text("{")
    assert not tsib._export_matches(tmp_path / "got", 30, 8)
    assert not tsib._export_matches(tmp_path / "none", 30, 8)


def test_mains_and_blend_sweep_equal_the_scripts(scripts, monkeypatch, heldout, tmp_path) -> None:
    sib, _, blend = scripts
    _script_main(monkeypatch, sib, [*SMALL, "--embedder", "hash:256", "--workdir", str(tmp_path / "jax")])
    want = json.loads((tmp_path / "jax" / "results.json").read_text())
    got = tsib.main([*SMALL, "--embedder", "hash:256", "--workdir", str(tmp_path / "torch"), "--device", "cpu",
                     "--corpus", str(heldout.parent)])
    assert [{k: r[k] for k in METRICS} for r in got["variants"]] == [{k: r[k] for k in METRICS} for r in want["variants"]]
    assert [r["variant"] for r in got["variants"]] == list(tsib.VARIANTS)
    assert json.loads((tmp_path / "torch" / "results.json").read_text())["variants"] == got["variants"]
    assert got["rerank_latency"]["queries"] == want["rerank_latency"]["queries"] == 7
    assert got["adapter_evals"] == 16 and set(got["insert_s"]) == {"hash", "sem_single", "sem_mv"}
    # Each query's ranking is what the variant's metrics were computed from.
    for row in got["variants"]:
        ranked = got["rankings"][row["variant"]]
        assert len(ranked) == row["queries"]
        assert all(scores == sorted(scores, reverse=True) for scores in ([s for _, s in r] for r in ranked))

    sweep = ["--embedder", "hash:256", "--blends", "0.5"]
    _script_main(monkeypatch, blend, [*SMALL, *sweep, "--workdir", str(tmp_path / "jax")])
    want_rows = json.loads((tmp_path / "jax" / "blend_sweep.json").read_text())["rows"]
    got_rows = tsib.blend_main([*SMALL, *sweep, "--workdir", str(tmp_path / "torch"), "--device", "cpu",
                                "--corpus", str(heldout.parent)])
    assert [{k: r[k] for k in METRICS} for r in got_rows] == [{k: r[k] for k in METRICS} for r in want_rows]
    assert [r["variant"] for r in got_rows] == ["rerank-blend-0.5"]


def test_only_the_asked_variants_run(heldout, tmp_path) -> None:
    got = tsib.main(["--docs", "20", "--queries", "6", "--adapter-queries", "0", "--embedder", "hash:256",
                     "--variants", "hash-single,sem-multivector", "--workdir", str(tmp_path / "w"), "--device", "cpu",
                     "--corpus", str(heldout.parent)])
    assert [r["variant"] for r in got["variants"]] == ["hash-single", "sem-multivector"]
    assert set(got["insert_s"]) == {"hash", "sem_mv"} and got["rerank_latency"] is None
    with pytest.raises(SystemExit):
        tsib.main(["--variants", "sem-everything", "--device", "cpu", "--corpus", str(heldout.parent)])


def test_beir_run_through_irbench(heldout, tmp_path, monkeypatch) -> None:
    """beir_main's export read back by the JAX package's loader and run
    through both packages' irbench (the same values)."""
    from raglite_tpu import RAGLiteConfig as JConfig
    from raglite_tpu import irbench as jbench

    out = tmp_path / "beir"
    monkeypatch.setenv("RAGLITE_TPU_BENCH_CACHE", str(tmp_path / "torch-cache"))
    rows = tsib.beir_main(["--docs", "30", "--queries", "8", "--dir", str(out), "--embedder", "hash:256",
                           "--store-dir", str(tmp_path / "torch-stores"), "--variants", "multivector,keyword",
                           "--device", "cpu", "--corpus", str(heldout.parent)])
    assert json.loads((out / "results_AP_at_10.json").read_text()) == {"AP@10": {r["variant"]: r["AP@10"] for r in rows}}
    assert len(jbench.beir_directory_dataset(str(out)).queries) == 8
    monkeypatch.setenv("RAGLITE_TPU_BENCH_CACHE", str(tmp_path / "jax-cache"))
    want = jbench.run_ir_benchmark(dataset=str(out), num_queries=8, variants=("multivector", "keyword"),
                                   config=JConfig(store_path=str(tmp_path / "jax-stores" / "beir"), embedder="hash:256", llm="echo"))
    assert [r["AP@10"] for r in rows] == pytest.approx(list(want["AP@10"]), abs=1e-12)
    # A second call reuses the export.
    before = (out / "corpus.jsonl").stat().st_mtime_ns
    tsib.beir_main(["--docs", "30", "--queries", "8", "--dir", str(out), "--embedder", "hash:256",
                    "--store-dir", str(tmp_path / "torch-stores"), "--variants", "keyword", "--device", "cpu",
                    "--corpus", str(heldout.parent)])
    assert (out / "corpus.jsonl").stat().st_mtime_ns == before
