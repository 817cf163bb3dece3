"""IR benchmarking harness (counterpart of raglite_tpu/irbench.py).

The same first-party harness as the JAX package's, over this package:

- ``IREvaluator``, an ABC with on-disk run caching;
- evaluator variants: single-vector, multi-vector, multi-vector + query
  adapter, keyword (BM25), hybrid and rerank (``RAGLiteTPUEvaluator``), the
  first-party C++ HNSW baseline (``HnswEvaluator``) and a hosted
  OpenAI-compatible vector store (``RemoteVectorStoreEvaluator``);
- IR measures (AP@k, nDCG@k, recall@k, P@k, MRR) in numpy;
- datasets: "synthetic" (query/qrel pairs generated with the corpus), a
  BEIR-style directory (corpus.jsonl / queries.jsonl / qrels.tsv), or an
  ``ir_datasets`` id when that optional package is importable.

Three differences of form from the JAX package's module:

- Runs are cached under ``$RAGLITE_TPU_BENCH_CACHE``, else
  ``~/.raglite_tpu_torch/bench``: a directory of this package's own.  A
  cache file's name holds the dataset, the variant, the depth and a digest
  of the queries and documents, but not the package, so a directory shared
  with the JAX package (whose default is ``~/.raglite_tpu/bench``) would
  replay that package's runs instead of computing this one's.
- pandas is optional.  :func:`ir_benchmark_rows` returns the table as a
  list of ``{"variant": ..., measure: ...}`` dicts; :func:`run_ir_benchmark`
  returns the JAX package's ``DataFrame`` (indexed by variant) where pandas
  can be imported, and those rows where it cannot.
- :func:`hnsw_recall_comparison` takes a ``device`` (default "cuda") for
  the dense index it measures.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import urllib.request
from abc import ABC, abstractmethod
from dataclasses import dataclass, replace
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.documents import Document
from raglite_tpu_torch.insert import insert_documents
from raglite_tpu_torch.search import hybrid_search, keyword_search, search_and_rerank_chunks, vector_search
from raglite_tpu_torch.store import store_from_config

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["IRDataset", "IREvaluator", "RAGLiteTPUEvaluator", "run_ir_benchmark", "compute_measure"]

#: The variants run_ir_benchmark compares by default.
VARIANTS = ("single_vector", "multivector", "query_adapter", "keyword", "hybrid", "rerank", "hnsw")


@dataclass
class IRDataset:
    """Documents, queries, and relevance judgements."""

    name: str
    documents: list[Document]
    queries: dict[str, str]  # query_id -> text
    qrels: dict[str, dict[str, int]]  # query_id -> {doc_id: relevance}


# --- Measures -----------------------------------------------------------------


def compute_measure(measure: str, run: list[str], qrel: dict[str, int]) -> float:
    """One query's measure: AP@k, nDCG@k, recall@k, P@k, or MRR."""
    name, _, k_str = measure.partition("@")
    k = int(k_str) if k_str else 10
    rel = np.asarray([qrel.get(doc_id, 0) for doc_id in run[:k]], dtype=np.float64)
    num_relevant = sum(1 for v in qrel.values() if v > 0)
    if num_relevant == 0:
        return 0.0
    binary = (rel > 0).astype(np.float64)
    if name.upper() == "AP":
        precisions = np.cumsum(binary) / (np.arange(len(binary)) + 1)
        return float(np.sum(precisions * binary) / min(num_relevant, k))
    if name.lower() == "ndcg":
        discounts = 1.0 / np.log2(np.arange(len(rel)) + 2)
        dcg = float(np.sum((2.0**rel - 1.0) * discounts))
        ideal = np.sort([v for v in qrel.values() if v > 0])[::-1][:k].astype(np.float64)
        idcg = float(np.sum((2.0**ideal - 1.0) / np.log2(np.arange(len(ideal)) + 2)))
        return dcg / idcg if idcg > 0 else 0.0
    if name.lower() in ("recall", "r"):
        return float(np.sum(binary) / num_relevant)
    if name.upper() == "P":
        return float(np.mean(binary)) if len(binary) else 0.0
    if name.upper() == "MRR":
        hits = np.flatnonzero(binary)
        return float(1.0 / (hits[0] + 1)) if hits.size else 0.0
    msg = f"unknown measure {measure!r}"
    raise ValueError(msg)


def _bench_store_dir(config: RAGLiteConfig, cache_dir: Path) -> Path:
    """Directory of the benchmark stores: beside the configured store, or in
    the evaluator's cache directory for ":memory:" configs (whose parent
    would be the working directory)."""
    if config.store_path != ":memory:":
        return Path(config.store_path).parent
    return cache_dir


# --- Evaluators ---------------------------------------------------------------


class IREvaluator(ABC):
    """Insert a dataset, score queries, cache runs on disk (the module
    docstring says where)."""

    def __init__(self, dataset: IRDataset, *, variant: str, cache_dir: str | None = None) -> None:
        self.dataset = dataset
        self.variant = variant
        self.cache_dir = Path(
            cache_dir or os.environ.get("RAGLITE_TPU_BENCH_CACHE", str(Path.home() / ".raglite_tpu_torch" / "bench"))
        )

    def _cache_path(self, num_results: int) -> Path:
        """Run-cache file keyed by dataset, variant, result depth and the
        exact query and corpus sets, so that runs of another query set or
        depth are never replayed."""
        digest = hashlib.sha256(
            json.dumps([sorted(self.dataset.queries.items()), sorted(d.id for d in self.dataset.documents)]).encode()
        ).hexdigest()[:10]
        return self.cache_dir / f"{self.dataset.name}__{self.variant}__k{num_results}__{digest}.runs.json"

    @abstractmethod
    def insert_documents(self) -> None: ...

    @abstractmethod
    def search(self, query: str, num_results: int) -> list[str]:
        """Ranked document ids for a query."""

    def runs(self, *, num_results: int = 10, refresh: bool = False) -> dict[str, list[str]]:
        """Per-query ranked doc ids, replayed from cache when available."""
        cache_path = self._cache_path(num_results)
        if not refresh and cache_path.exists():
            return json.loads(cache_path.read_text())
        self.insert_documents()
        out = {qid: self.search(text, num_results) for qid, text in self.dataset.queries.items()}
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        cache_path.write_text(json.dumps(out))
        return out

    def score(self, measure: str = "AP@10", **kwargs) -> float:
        runs = self.runs(num_results=int(measure.partition("@")[2] or 10), **kwargs)
        values = [compute_measure(measure, runs.get(qid, []), qrel) for qid, qrel in self.dataset.qrels.items()]
        return float(np.mean(values)) if values else 0.0


def _doc_ids(store, chunk_ids, num_results: int) -> list[str]:
    """Distinct document ids of ranked chunks, best chunk first."""
    doc_ids: list[str] = []
    for cid in chunk_ids:
        chunk = store.chunks.get(cid)
        if chunk and chunk.document_id not in doc_ids:
            doc_ids.append(chunk.document_id)
    return doc_ids[:num_results]


class RAGLiteTPUEvaluator(IREvaluator):
    """This package's retrieval variants: "single_vector", "multivector",
    "query_adapter", "keyword", "hybrid", "rerank" (multivector candidates
    reranked by token MaxSim).  Scores are at the document level (a
    document's best chunk).  "rerank", "keyword" and "hybrid" share the
    "multivector" store (the same embeddings and postings; only the ranking
    differs); "query_adapter" keeps its own, since training the adapter
    writes to the index metadata."""

    def __init__(
        self,
        dataset: IRDataset,
        *,
        variant: str = "multivector",
        config: RAGLiteConfig | None = None,
        cache_dir: str | None = None,
    ) -> None:
        super().__init__(dataset, variant=variant, cache_dir=cache_dir)
        base = config or RAGLiteConfig()
        store_variant = "multivector" if variant in ("rerank", "keyword", "hybrid") else variant
        store_path = str(
            _bench_store_dir(base, self.cache_dir) / f"bench_{dataset.name}_{store_variant}_{len(dataset.documents)}d"
        )
        self.config = replace(
            base,
            store_path=store_path,
            vector_search_multivector=variant != "single_vector",
            vector_search_query_adapter=variant == "query_adapter",
        )

    def insert_documents(self) -> None:
        insert_documents(self.dataset.documents, config=self.config)
        if self.variant != "query_adapter":
            return
        from raglite_tpu_torch.documents import Eval
        from raglite_tpu_torch.query_adapter import update_query_adapter

        store = store_from_config(self.config)
        if "query_adapter" in store.index_metadata:
            return
        # Train on the dataset's own qrels.  Only positive grades are gold
        # (relevance 0 means judged irrelevant); deleted ids in chunk_order
        # have no record (hence get_chunk).
        for qid, qrel in self.dataset.qrels.items():
            gold_chunks = [
                chunk
                for cid in store.chunk_order
                if (chunk := store.get_chunk(cid)) is not None and qrel.get(chunk.document_id, 0) > 0
            ]
            if gold_chunks:
                store.add_evals([Eval.from_chunks(self.dataset.queries[qid], gold_chunks, "ground truth")])
        update_query_adapter(config=self.config)

    def search(self, query: str, num_results: int) -> list[str]:
        oversample = 2  # chunks per result, for the document-level dedup
        if self.variant == "keyword":
            chunk_ids, _ = keyword_search(query, num_results=oversample * num_results, config=self.config)
        elif self.variant == "hybrid":
            chunk_ids, _ = hybrid_search(query, num_results=oversample * num_results, config=self.config)
        elif self.variant == "rerank":
            chunks = search_and_rerank_chunks(query, num_results=oversample * num_results, config=self.config)
            chunk_ids = [chunk.id for chunk in chunks]
        else:
            chunk_ids, _ = vector_search(query, num_results=oversample * num_results, config=self.config)
        return _doc_ids(store_from_config(self.config), chunk_ids, num_results)


class HnswEvaluator(IREvaluator):
    """Cross-system baseline: the same chunk embeddings served from the
    first-party C++ HNSW graph (native/hnsw.cpp) at ef_search = 160, the
    upstream RAGLite's setting, so that the harness measures recall and AP
    against HNSW instead of citing them."""

    def __init__(
        self,
        dataset: IRDataset,
        *,
        config: RAGLiteConfig | None = None,
        cache_dir: str | None = None,
        ef_search: int = 160,
        M: int = 32,  # noqa: N803
    ) -> None:
        super().__init__(dataset, variant=f"hnsw_ef{ef_search}", cache_dir=cache_dir)
        base = config or RAGLiteConfig()
        store_path = str(_bench_store_dir(base, self.cache_dir) / f"bench_{dataset.name}_hnsw_{len(dataset.documents)}d")
        self.config = replace(base, store_path=store_path)
        self.ef_search = ef_search
        self.M = M
        self._index = None
        self._row_chunk: list[str] = []

    def insert_documents(self) -> None:
        from raglite_tpu_torch.native import HnswIndex

        insert_documents(self.dataset.documents, config=self.config)
        store = store_from_config(self.config)
        rows, row_chunk = [], []
        for cid in store.chunk_order:
            if cid in store.deleted_chunks:
                continue
            matrix = np.asarray(store.embeddings[cid], dtype=np.float32)
            rows.append(matrix)
            row_chunk.extend([cid] * matrix.shape[0])
        stacked = np.concatenate(rows, axis=0)
        self._index = HnswIndex(
            stacked.shape[1], M=self.M, ef_construction=200, metric=self.config.vector_search_distance_metric
        )
        self._index.add(stacked)
        self._row_chunk = row_chunk

    def search(self, query: str, num_results: int) -> list[str]:
        from raglite_tpu_torch.embed import embed_strings

        if self._index is None:
            self.insert_documents()
        q = embed_strings([query], config=self.config).astype(np.float32)
        oversample = 4
        ids, _ = self._index.search(q, oversample * max(num_results, 10), ef_search=self.ef_search)
        return _doc_ids(store_from_config(self.config), (self._row_chunk[int(row)] for row in ids[0] if row >= 0), num_results)


class RemoteVectorStoreEvaluator(IREvaluator):
    """Cross-system baseline: a hosted OpenAI-compatible vector store (the
    upstream RAGLite's hosted-OpenAI comparison).  Speaks the vector-store
    REST surface with stdlib HTTP (``POST /files``, vector-store create and
    attach, ``POST /vector_stores/{id}/search``) against any ``base_url``.
    ``api_key`` defaults to ``$OPENAI_API_KEY``."""

    def __init__(
        self,
        dataset: IRDataset,
        *,
        base_url: str,
        api_key: str | None = None,
        cache_dir: str | None = None,
    ) -> None:
        super().__init__(dataset, variant="openai_vector_store", cache_dir=cache_dir)
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key if api_key is not None else os.environ.get("OPENAI_API_KEY", "")
        self.vector_store_id: str | None = None
        self._filename_to_doc: dict[str, str] = {}

    def _request(
        self,
        path: str,
        payload: dict | None = None,
        *,
        data: bytes | None = None,
        content_type: str | None = None,
        method: str = "POST",
    ) -> dict:
        body = None if method == "GET" else (data if data is not None else json.dumps(payload or {}).encode())
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=body,
            headers={
                "Content-Type": content_type or "application/json",
                **({"Authorization": f"Bearer {self.api_key}"} if self.api_key else {}),
            },
        )
        req.method = method
        with urllib.request.urlopen(req, timeout=300) as resp:  # noqa: S310
            return json.loads(resp.read())

    def _upload_file(self, filename: str, text: str) -> str:
        """``POST /files`` (multipart, purpose=assistants) -> file id."""
        boundary = "raglitetpuboundary"
        parts = (
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="purpose"\r\n\r\nassistants\r\n'
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
            "Content-Type: text/plain\r\n\r\n"
            f"{text}\r\n--{boundary}--\r\n"
        ).encode()
        return self._request("/files", data=parts, content_type=f"multipart/form-data; boundary={boundary}")["id"]

    def insert_documents(self) -> None:
        store = self._request("/vector_stores", {"name": f"raglite_bench_{self.dataset.name}"})
        self.vector_store_id = store["id"]
        for doc in self.dataset.documents:
            text = doc.content or ""
            if not text.strip():
                continue
            filename = f"{doc.id}.txt"
            self._filename_to_doc[filename] = doc.id
            file_id = self._upload_file(filename, text)
            attach = self._request(f"/vector_stores/{self.vector_store_id}/files", {"file_id": file_id})
            # Hosted stores index asynchronously: poll until processing is
            # done, or the searches would run against a half-built index and
            # their runs be cached as the permanent score.
            for _ in range(120):
                if attach.get("status", "completed") not in ("in_progress", "queued"):
                    break
                time.sleep(1.0)
                attach = self._request(f"/vector_stores/{self.vector_store_id}/files/{file_id}", method="GET")
            else:
                msg = (
                    f"vector store file {file_id} still {attach.get('status')!r} after 120 s; refusing to "
                    "benchmark (and permanently cache) a half-built index"
                )
                raise RuntimeError(msg)

    def search(self, query: str, num_results: int) -> list[str]:
        if self.vector_store_id is None:
            self.insert_documents()
        response = self._request(
            f"/vector_stores/{self.vector_store_id}/search", {"query": query, "max_num_results": 2 * num_results}
        )
        doc_ids: list[str] = []
        for result in response.get("data", []):
            doc_id = self._filename_to_doc.get(result.get("filename", "")) or result.get("file_id", "")
            if doc_id and doc_id not in doc_ids:
                doc_ids.append(doc_id)
        return doc_ids[:num_results]


def hnsw_recall_comparison(
    *,
    num_rows: int = 100_000,
    dim: int = 256,
    num_queries: int = 64,
    num_results: int = 10,
    ef_search: int = 160,
    M: int = 32,  # noqa: N803
    seed: int = 0,
    device: str = "cuda",
) -> dict[str, float]:
    """Recall@k of (a) the dense index's exact scan over f16 rows and over
    int8 rows with per-row scales, on ``device``, and (b) the HNSW graph at
    ef_search, both against exact f32 brute force over the same vectors,
    with each index's memory.

    The keys are the JAX package's (the dict is the API): the ``tpu_*``
    keys name the dense scan, wherever it runs, not the chip.
    ``tpu_fp16_*`` is the exact f16 scan (half of HNSW's vector memory,
    recall 1.0 up to f16 rounding), ``tpu_int8_*`` the int8 rows (about a
    quarter, recall reduced only by quantization noise).  The claim holds
    when ``tpu_fp16_recall >= hnsw_recall`` at ``tpu_fp16_memory_bytes <
    hnsw_memory_bytes``."""
    from raglite_tpu_torch.index.dense import DenseIndex
    from raglite_tpu_torch.native import HnswIndex

    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(num_rows, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rows[rng.integers(0, num_rows, num_queries)] + 0.2 * rng.normal(size=(num_queries, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    exact = np.argsort(-(queries @ rows.T), axis=1)[:, :num_results]

    def recall(found: np.ndarray) -> float:
        return float(
            np.mean([len(set(found[i].tolist()) & set(exact[i].tolist())) / num_results for i in range(num_queries)])
        )

    def scan_recall(dtype: str) -> float:
        index = DenseIndex(dim=dim, dtype=dtype, metric="cosine", num_devices=1, use_pallas=False, device=device)
        index.append_chunks([rows[i : i + 1] for i in range(num_rows)], [str(i) for i in range(num_rows)])
        _, ordinals = index.search_chunks(queries, num_hits=4 * num_results, num_results=num_results)
        return recall(ordinals)

    hnsw = HnswIndex(dim, M=M, ef_construction=200, metric="cosine")
    hnsw.add(rows)
    hnsw_ids, _ = hnsw.search(queries, num_results, ef_search=ef_search)
    return {
        "tpu_fp16_recall": scan_recall("float16"),
        "tpu_int8_recall": scan_recall("int8"),
        "hnsw_recall": recall(hnsw_ids),
        "tpu_fp16_memory_bytes": float(num_rows * dim * 2),
        "tpu_int8_memory_bytes": float(num_rows * (dim + 4)),  # rows + scales
        "hnsw_memory_bytes": float(hnsw.memory_bytes),
        "num_rows": float(num_rows),
        "ef_search": float(ef_search),
    }


# --- Datasets -----------------------------------------------------------------


def synthetic_dataset(num_docs: int = 64, queries_per_doc: int = 1, seed: int = 0) -> IRDataset:
    """A deterministic corpus where each document owns distinctive vocabulary
    and each query targets one document: exact retrieval should reach 1.0."""
    rng = np.random.default_rng(seed)
    nouns = [
        "glacier", "volcano", "nebula", "enzyme", "sonnet", "turbine", "antenna", "plateau",
        "lagoon", "magnet", "fresco", "comet", "fjord", "lichen", "quartz", "monsoon",
    ]
    documents, queries, qrels = [], {}, {}
    for i in range(num_docs):
        a, b, c = rng.choice(nouns, size=3, replace=False)
        body = (
            f"# Study {i}\n\n"
            + f"The {a} interacts with the {b} near the {c}. " * 3
            + f"Researchers measured the {a} of specimen {i} repeatedly. " * 2
            + f"Conclusion {i}: the {b} dominates the {c} response.\n"
        )
        doc = Document.from_text(body, filename=f"study{i}.md")
        documents.append(doc)
        for j in range(queries_per_doc):
            qid = f"q{i}_{j}"
            queries[qid] = f"How does the {a} interact with the {b} in specimen {i}?"
            qrels[qid] = {doc.id: 1}
    return IRDataset("synthetic", documents, queries, qrels)


def beir_directory_dataset(path: str) -> IRDataset:
    """Load a BEIR-style directory: corpus.jsonl, queries.jsonl, qrels.tsv."""
    root = Path(path)
    documents = []
    for line in (root / "corpus.jsonl").read_text().splitlines():
        rec = json.loads(line)
        documents.append(
            Document.from_text(
                f"# {rec.get('title', '')}\n\n{rec['text']}",
                id=str(rec["_id"]),
                filename=str(rec.get("title") or rec["_id"]),
            )
        )
    queries = {}
    for line in (root / "queries.jsonl").read_text().splitlines():
        rec = json.loads(line)
        queries[str(rec["_id"])] = rec["text"]
    qrels: dict[str, dict[str, int]] = {}
    for line in (root / "qrels.tsv").read_text().splitlines()[1:]:
        qid, did, rel = line.split("\t")[:3]
        qrels.setdefault(qid, {})[did] = int(rel)
    return IRDataset(root.name, documents, queries, qrels)


def load_dataset(dataset: str, *, num_queries: int = 50) -> IRDataset:
    if dataset == "synthetic":
        return synthetic_dataset(num_docs=max(num_queries, 8))
    if Path(dataset).is_dir():
        return beir_directory_dataset(dataset)
    try:  # an optional ir_datasets id (needs that package and the network)
        import ir_datasets  # type: ignore[import-not-found]
    except ModuleNotFoundError as error:
        msg = f"dataset {dataset!r} is not a directory and ir_datasets is unavailable"
        raise ValueError(msg) from error
    ds = ir_datasets.load(dataset)
    documents = [Document.from_text(d.text, id=d.doc_id, filename=d.doc_id) for d in ds.docs_iter()]
    queries = {q.query_id: q.text for q in ds.queries_iter()}
    qrels: dict[str, dict[str, int]] = {}
    for qrel in ds.qrels_iter():
        qrels.setdefault(qrel.query_id, {})[qrel.doc_id] = qrel.relevance
    return IRDataset(dataset.replace("/", "_"), documents, queries, qrels)


def ir_benchmark_rows(
    *,
    dataset: str = "synthetic",
    measure: str = "AP@10",
    num_queries: int = 50,
    variants: tuple[str, ...] = VARIANTS,
    config: RAGLiteConfig | None = None,
    remote_vector_store: str | None = None,
) -> list[dict[str, Any]]:
    """The rows of :func:`run_ir_benchmark`'s table, without pandas: one
    ``{"variant": name, measure: value}`` per variant, in order."""
    ds = load_dataset(dataset, num_queries=num_queries)
    if num_queries and len(ds.queries) > num_queries:
        keep = sorted(ds.queries)[:num_queries]
        ds = IRDataset(
            ds.name, ds.documents, {k: ds.queries[k] for k in keep}, {k: ds.qrels[k] for k in keep if k in ds.qrels}
        )
    rows: list[dict[str, Any]] = []
    for variant in variants:
        if variant == "hnsw":
            from raglite_tpu_torch.native import native_available

            if not native_available():
                # The HNSW baseline is C++; every other variant has a Python
                # path, so a machine without a toolchain skips this row.
                logging.getLogger(__name__).warning("skipping 'hnsw' baseline: no C++ toolchain available")
                continue
            evaluator: IREvaluator = HnswEvaluator(ds, config=config)
        else:
            evaluator = RAGLiteTPUEvaluator(ds, variant=variant, config=config)
        rows.append({"variant": variant, measure: evaluator.score(measure)})
    if remote_vector_store:
        evaluator = RemoteVectorStoreEvaluator(ds, base_url=remote_vector_store)
        rows.append({"variant": "openai_vector_store", measure: evaluator.score(measure)})
    return rows


def run_ir_benchmark(
    *,
    dataset: str = "synthetic",
    measure: str = "AP@10",
    num_queries: int = 50,
    variants: tuple[str, ...] = VARIANTS,
    config: RAGLiteConfig | None = None,
    remote_vector_store: str | None = None,
) -> "pd.DataFrame | list[dict[str, Any]]":
    """Compare retrieval variants on an IR dataset: a ``DataFrame`` indexed
    by variant with one column, ``measure``, where pandas can be imported;
    else :func:`ir_benchmark_rows`' list.  ``remote_vector_store`` adds an
    OpenAI-compatible hosted vector store's row, evaluated at that base
    URL."""
    rows = ir_benchmark_rows(
        dataset=dataset, measure=measure, num_queries=num_queries, variants=variants, config=config,
        remote_vector_store=remote_vector_store,
    )
    try:
        import pandas as pd
    except ModuleNotFoundError:
        return rows
    return pd.DataFrame(rows).set_index("variant")
