"""Held-out IR quality of an encoder through the production search stack
(counterpart of scripts/semantic_ir_bench.py, scripts/beir_run.py and
scripts/rerank_blend_sweep.py).

Protocol (inverse-cloze, leakage-free), as the scripts draw it:

- Corpus: N documents of ``--corpus/heldout.jsonl`` (train/corpus.py's
  held-out split, which neither the tokenizer nor the encoder trains on),
  shuffled with ``numpy.random.default_rng(seed)``; those of >= 500
  characters are kept.
- Queries: for each sampled document, one mid-document sentence (>= 10
  words, < 400 characters) is removed from the text before insertion and
  becomes the query; the document is the single relevant item.
- Adapter training uses query/document pairs of other documents, as
  ``Eval`` rows whose gold chunks are the document's 2 chunks nearest the
  query, through ``update_query_adapter``.
- Metrics: MRR@10, nDCG@10 and recall@10 at the document level (a
  document's best chunk score).

Variants: ``hash-single`` (hash:1024), ``sem-single`` (one pooled vector a
chunk), ``sem-multivector``, ``sem-mv+adapter``, ``sem-mv+rerank`` (token
MaxSim over ``search_and_rerank_chunks(num_results=40)``'s 160 candidates,
with a latency block of reranks of 32 over ``--latency-queries`` queries, 50
as in the script) and ``sem-hybrid`` (BM25 + RRF).  ``main`` writes ``--workdir/results.json``
and returns its content, with each store's insert seconds, the adapter's
seconds and every variant's per-query document ranking (ids and scores).

``beir_main`` exports the same protocol as a BEIR directory
(``export_beir``) and runs it through ``irbench``; ``blend_main`` sweeps
``reranker_blend`` over an already-built ``sem_mv`` store.

Usage:
  python -m raglite_tpu_torch.train.semantic_ir_bench [--docs 2000] [--queries 200] [--device cpu]
  python -m raglite_tpu_torch.train.semantic_ir_bench beir [--docs 1200] [--queries 200]
  python -m raglite_tpu_torch.train.semantic_ir_bench blend-sweep --workdir DIR --embedder SPEC
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from raglite_tpu_torch.train.corpus import DATA, DEFAULT_CORPUS

__all__ = [
    "VARIANTS", "beir_main", "blend_main", "build_store", "doc_ranking", "evaluate_variant", "export_beir",
    "load_protocol", "main",
]

HELDOUT = DEFAULT_CORPUS / "heldout.jsonl"
VARIANTS = ("hash-single", "sem-single", "sem-multivector", "sem-mv+adapter", "sem-mv+rerank", "sem-hybrid")

_SENT = re.compile(r"[^.!?\n]+[.!?]")


def load_protocol(n_docs: int, n_queries: int, n_adapter: int, seed: int = 0, *, heldout: Path = HELDOUT):
    """Returns (documents to insert, eval queries, adapter-train queries).

    Each query is (query_text, gold_doc_text_id); its sentence is removed
    from the inserted text.
    """
    rng = np.random.default_rng(seed)
    raw = [json.loads(line) for line in open(heldout)]
    rng.shuffle(raw)
    raw = [d for d in raw if len(d["text"]) >= 500][:n_docs]
    queries: list[tuple[str, str]] = []
    adapter_queries: list[tuple[str, str]] = []
    texts: dict[str, str] = {}
    want_q = rng.permutation(len(raw))
    query_docs = set(want_q[: n_queries + n_adapter].tolist())
    for i, doc in enumerate(raw):
        text = doc["text"]
        if i in query_docs:
            sentences = [m.group(0).strip() for m in _SENT.finditer(text)]
            candidates = [s for s in sentences[1:-1] if len(s.split()) >= 10 and len(s) < 400]
            if candidates:
                sentence = candidates[int(rng.integers(len(candidates)))]
                text = text.replace(sentence, " ", 1)
                if len(queries) < n_queries:
                    queries.append((sentence, doc["id"]))
                else:
                    adapter_queries.append((sentence, doc["id"]))
        texts[doc["id"]] = text
    return texts, queries, adapter_queries


def build_store(texts: dict[str, str], config) -> None:
    from raglite_tpu_torch import Document, insert_documents

    docs = [Document.from_text(text, filename=f"{doc_id}.md", id=doc_id) for doc_id, text in texts.items()]
    insert_documents(docs, config=config)


def _doc_scores(chunk_ids, scores, store, k: int = 10) -> tuple[list[str], list[float]]:
    """The top ``k`` documents by their best chunk's score (ties by the
    rank of that chunk) and those scores."""
    best: dict[str, float] = {}
    order: dict[str, int] = {}
    for rank, (cid, score) in enumerate(zip(chunk_ids, scores)):
        chunk = store.get_chunk(cid)
        if chunk is None:
            continue
        did = chunk.document_id
        if did not in best or score > best[did]:
            best[did] = float(score)
            order.setdefault(did, rank)
    ranked = sorted(best, key=lambda d: (-best[d], order[d]))[:k]
    return ranked, [best[d] for d in ranked]


def doc_ranking(chunk_ids, scores, store, k: int = 10) -> list[str]:
    """Doc-level ranking: max chunk score per document."""
    return _doc_scores(chunk_ids, scores, store, k)[0]


def evaluate_variant(name, search_fn, queries, store, k: int = 10) -> dict:
    mrr, ndcg, hits = [], [], 0
    t0 = time.time()
    for query, gold in queries:
        ranked = search_fn(query)
        if gold in ranked:
            rank = ranked.index(gold) + 1
            mrr.append(1.0 / rank)
            ndcg.append(1.0 / np.log2(rank + 1))
            hits += 1
        else:
            mrr.append(0.0)
            ndcg.append(0.0)
    return {
        "variant": name,
        "mrr_at_10": round(float(np.mean(mrr)), 4),
        "ndcg_at_10": round(float(np.mean(ndcg)), 4),
        "recall_at_10": round(hits / len(queries), 4),
        "queries": len(queries),
        "seconds": round(time.time() - t0, 1),
    }


def _parser(description: str, **defaults) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--docs", type=int, default=defaults["docs"])
    parser.add_argument("--queries", type=int, default=defaults["queries"])
    parser.add_argument("--corpus", type=Path, default=DEFAULT_CORPUS, help="train.corpus's output (reads heldout.jsonl)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default; raises without a GPU) or 'cpu'")
    return parser


def main(argv: list[str] | None = None) -> dict:  # noqa: C901, PLR0915
    """The script's command line, with ``--corpus`` and ``--device`` in
    place of ``--cpu`` and ``--variants`` (a subset of VARIANTS, which
    ``--skip-hash`` and ``--skip-rerank`` shrink); returns the results
    (module docstring)."""
    parser = _parser(__doc__.split("\n\n")[0], docs=2000, queries=200)
    parser.add_argument("--adapter-queries", type=int, default=1000)
    parser.add_argument("--margin-sweep", default="",
                        help="comma-separated optimize_gap values to sweep for the adapter variant")
    parser.add_argument("--workdir", type=Path, default=DATA / "irbench")
    parser.add_argument("--embedder", default="flax:sem",
                        help="semantic embedder spec for the sem-* variants; pair a non-default embedder with its own "
                        "--workdir so stores built with another embedder are not reused")
    parser.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated variants to run")
    parser.add_argument("--skip-hash", dest="skip", action="append_const", const="hash-single", default=[],
                        help="drop hash-single from --variants")
    parser.add_argument("--skip-rerank", dest="skip", action="append_const", const="sem-mv+rerank",
                        help="drop sem-mv+rerank (and the rerank-32 latency block) from --variants")
    parser.add_argument("--rerank-queries", type=int, default=0,
                        help="evaluate the rerank variant on only the first N queries, with a matched sem-multivector "
                        "row over the same subset")
    parser.add_argument("--latency-queries", type=int, default=50,
                        help="queries of the rerank-32 latency block (the first is not timed)")
    args = parser.parse_args(argv)

    from raglite_tpu_torch import Eval, RAGLiteConfig, hybrid_search, search_and_rerank_chunks, update_query_adapter, vector_search
    from raglite_tpu_torch.config import checked_device
    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.search import rerank_chunks, retrieve_chunks
    from raglite_tpu_torch.store import store_from_config

    device = str(checked_device(args.device))
    want = set(args.variants.split(","))
    if unknown := want - set(VARIANTS):
        parser.error(f"unknown variants {sorted(unknown)}")
    want -= set(args.skip)
    texts, queries, adapter_queries = load_protocol(
        args.docs, args.queries, args.adapter_queries, heldout=args.corpus / "heldout.jsonl"
    )
    print(f"corpus: {len(texts)} docs, {len(queries)} eval queries, "  # noqa: T201
          f"{len(adapter_queries)} adapter-train queries", flush=True)
    workdir = args.workdir
    workdir.mkdir(parents=True, exist_ok=True)

    configs = {}
    if "hash-single" in want:
        configs["hash"] = RAGLiteConfig(store_path=str(workdir / "hash"), embedder="hash:1024", llm="echo", device=device)
    if "sem-single" in want:
        configs["sem_single"] = RAGLiteConfig(
            store_path=str(workdir / "sem_single"), embedder=args.embedder, llm="echo", device=device,
            # One pooled whole-chunk embedding (late chunking stores
            # per-chunklet sub-vectors regardless of the multivector flag).
            embedding_type="standard", vector_search_multivector=False, vector_search_query_adapter=False,
        )
    if want - {"hash-single", "sem-single"}:
        configs["sem_mv"] = RAGLiteConfig(
            store_path=str(workdir / "sem_mv"), embedder=args.embedder, llm="echo", device=device,
            vector_search_multivector=True, vector_search_query_adapter=False,
        )
    insert_s: dict[str, float] = {}
    for name, config in configs.items():
        store = store_from_config(config)
        if len(store.documents) < len(texts):
            t0 = time.perf_counter()
            build_store(texts, config)
            insert_s[name] = time.perf_counter() - t0
            print(f"built {name} store in {insert_s[name]:.0f}s", flush=True)  # noqa: T201

    results: list[dict] = []
    rankings: dict[str, list[list[tuple[str, float]]]] = {}

    def evaluate(name: str, run, rows, store) -> None:
        """``evaluate_variant`` over ``run(query) -> (doc ids, scores)``,
        keeping each query's ranking."""
        kept = rankings.setdefault(name, [])

        def ranked(query: str) -> list[str]:
            ids, scores = run(query)
            kept.append(list(zip(ids, scores)))
            return ids

        results.append(evaluate_variant(name, ranked, rows, store))
        print(results[-1], flush=True)  # noqa: T201

    def dense_fn(config, **kw):
        store = store_from_config(config)

        def run(query):
            ids, scores = vector_search(query, num_results=40, config=config, **kw)
            return _doc_scores(ids, scores, store)

        return run

    if "hash-single" in want:
        evaluate("hash-single", dense_fn(configs["hash"]), queries, store_from_config(configs["hash"]))
    if "sem-single" in want:
        evaluate("sem-single", dense_fn(configs["sem_single"]), queries, store_from_config(configs["sem_single"]))
    config_mv = configs.get("sem_mv")
    store_mv = store_from_config(config_mv) if config_mv else None
    if "sem-multivector" in want:
        evaluate("sem-multivector", dense_fn(config_mv), queries, store_mv)

    adapter_s = None
    evals: list = []
    if "sem-mv+adapter" in want:
        # Eval rows from the disjoint adapter-train queries; gold = the
        # gold document's 2 chunks most similar to the query (whole-document
        # gold poisons the NNLS targets with unrelated chunks).
        doc_chunks: dict[str, list[str]] = {}
        for cid in store_mv.chunk_order:
            chunk = store_mv.chunks.get(cid)
            if chunk is not None:
                doc_chunks.setdefault(chunk.document_id, []).append(cid)
        adapter_q_emb = embed_queries([q for q, _ in adapter_queries], config=config_mv)
        for i, (query, gold_doc) in enumerate(adapter_queries):
            gold_chunks = doc_chunks.get(gold_doc, [])
            if not gold_chunks:
                continue
            q_emb = np.asarray(adapter_q_emb[i], np.float32)
            scored = sorted(
                ((float(np.max(np.asarray(store_mv.embeddings[cid], np.float32) @ q_emb)), cid) for cid in gold_chunks),
                reverse=True,
            )
            evals.append(Eval(id=f"adapter-{i:04d}", document_id=gold_doc, question=query,
                              chunk_ids=[cid for _, cid in scored[:2]], contexts=[], ground_truth=""))
        with store_mv.write_lock():
            store_mv.add_evals(evals)
            store_mv.save()
        config_adapter = replace(config_mv, vector_search_query_adapter=True)
        t0 = time.perf_counter()
        update_query_adapter(config=config_adapter)
        adapter_s = time.perf_counter() - t0
        print(f"adapter trained on {len(evals)} evals in {adapter_s:.0f}s", flush=True)  # noqa: T201
        evaluate("sem-mv+adapter", dense_fn(config_adapter), queries, store_mv)
        if args.margin_sweep:
            # Does the adapter lever scale or saturate: re-train at each
            # optimize_gap and re-evaluate.
            for gap in (float(x) for x in args.margin_sweep.split(",")):
                update_query_adapter(config=config_adapter, optimize_gap=gap)
                evaluate(f"sem-mv+adapter(gap={gap:g})", dense_fn(config_adapter), queries, store_mv)
            update_query_adapter(config=config_adapter)  # restore the default

    def rerank_fn(query):
        chunks = search_and_rerank_chunks(query, num_results=40, config=config_mv)
        ids = [c.id for c in chunks]
        return _doc_scores(ids, list(range(len(ids), 0, -1)), store_mv)

    rerank_latency = None
    if "sem-mv+rerank" in want:
        rq = queries[: args.rerank_queries] if args.rerank_queries else queries
        evaluate("sem-mv+rerank", rerank_fn, rq, store_mv)
        if args.rerank_queries and len(rq) < len(queries):
            # Matched-subset dense baseline for the rerank head-to-head.
            evaluate(f"sem-multivector@{len(rq)}", dense_fn(config_mv), rq, store_mv)
        # rerank-32 latency: the token MaxSim rerank alone over a fixed
        # 32-candidate set (candidate token re-encode, cached by content
        # after first touch, and the MaxSim), without the dense search that
        # produced them.
        lat_ms: list[float] = []
        for qi, (query, _gold) in enumerate(queries[: args.latency_queries]):
            ids, _scores = vector_search(query, num_results=32, config=config_mv)
            cands = retrieve_chunks(ids, config=config_mv)
            t0 = time.perf_counter()
            rerank_chunks(query, cands, config=config_mv)
            if qi:  # the first call pays the first touch
                lat_ms.append((time.perf_counter() - t0) * 1e3)
        rerank_latency = {
            "variant": "rerank-32-latency",
            "p50_ms": float(np.percentile(lat_ms, 50)) if lat_ms else None,
            "p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms else None,
            "queries": len(lat_ms),
            "note": "token-level MaxSim over 32 candidates, cold token cache except repeats; excludes the producing "
                    "dense search",
        }
        print(rerank_latency, flush=True)  # noqa: T201

    def hybrid_fn(query):
        ids, scores = hybrid_search(query, num_results=40, config=config_mv)
        return _doc_scores(ids, scores, store_mv)

    if "sem-hybrid" in want:
        evaluate("sem-hybrid", hybrid_fn, queries, store_mv)

    out = {"embedder": args.embedder, "docs": len(texts), "variants": results, "rerank_latency": rerank_latency,
           "insert_s": insert_s, "adapter_s": adapter_s, "adapter_evals": len(evals), "device": device}
    out_path = workdir / "results.json"
    out_path.write_text(json.dumps(out, indent=1))
    print("\n| variant | MRR@10 | nDCG@10 | recall@10 |")  # noqa: T201
    print("|---|---|---|---|")  # noqa: T201
    for r in results:
        print(f"| {r['variant']} | {r['mrr_at_10']:.3f} | {r['ndcg_at_10']:.3f} | {r['recall_at_10']:.3f} |")  # noqa: T201
    print(f"\nwritten: {out_path}")  # noqa: T201
    return {**out, "rankings": rankings}


# --- The protocol as a BEIR directory (scripts/beir_run.py) ---------------------


def _export_matches(out: Path, n_docs: int, n_queries: int) -> bool:
    """True when an existing export's corpus/query counts match the
    arguments: a stale export of another size must not be benchmarked while
    the printed parameters claim otherwise."""
    if not (out / "qrels.tsv").exists():
        return False
    try:
        meta = json.loads((out / "export_meta.json").read_text())
    except (OSError, ValueError):
        return False
    return meta.get("docs") == n_docs and meta.get("queries") == n_queries


def export_beir(out: Path, n_docs: int, n_queries: int, *, heldout: Path = HELDOUT) -> None:
    """Write corpus.jsonl / queries.jsonl / qrels.tsv in BEIR layout."""
    texts, queries, _ = load_protocol(n_docs, n_queries, 0, heldout=heldout)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "corpus.jsonl", "w") as f:
        for doc_id, text in texts.items():
            f.write(json.dumps({"_id": doc_id, "title": "", "text": text}) + "\n")
    with open(out / "queries.jsonl", "w") as f:
        for i, (query, _gold) in enumerate(queries):
            f.write(json.dumps({"_id": f"q{i:04d}", "text": query}) + "\n")
    with open(out / "qrels.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for i, (_query, gold) in enumerate(queries):
            f.write(f"q{i:04d}\t{gold}\t1\n")
    (out / "export_meta.json").write_text(json.dumps({"docs": n_docs, "queries": n_queries}))
    print(f"exported BEIR dir: {len(texts)} docs, {len(queries)} queries -> {out}")  # noqa: T201


def beir_main(argv: list[str] | None = None) -> list[dict]:
    """scripts/beir_run.py: export (or reuse) the BEIR directory and run
    ``irbench`` over it; prints the table as the port's ``bench`` does
    without pandas, writes ``results_<measure>.json`` ({measure: {variant:
    value}}) and returns the rows."""
    from raglite_tpu_torch import RAGLiteConfig
    from raglite_tpu_torch.cli import _table_text
    from raglite_tpu_torch.config import checked_device
    from raglite_tpu_torch.irbench import VARIANTS as IR_VARIANTS
    from raglite_tpu_torch.irbench import ir_benchmark_rows

    parser = _parser("Export the held-out protocol as a BEIR directory and run the IR benchmark over it.",
                     docs=1200, queries=200)
    parser.add_argument("--dir", type=Path, default=DATA / "beir_heldout")
    parser.add_argument("--measure", default="AP@10")
    parser.add_argument("--embedder", default="flax:sem")
    parser.add_argument("--store-dir", type=Path, default=DATA / "beir_stores")
    parser.add_argument("--variants", default=",".join(IR_VARIANTS), help="comma-separated irbench variants")
    args = parser.parse_args(argv)
    device = str(checked_device(args.device))
    if _export_matches(args.dir, args.docs, args.queries):
        print(f"reusing existing export: {args.dir}")  # noqa: T201
    else:
        export_beir(args.dir, args.docs, args.queries, heldout=args.corpus / "heldout.jsonl")
    config = RAGLiteConfig(store_path=str(args.store_dir / "beir"), embedder=args.embedder, llm="echo", device=device)
    t0 = time.perf_counter()
    rows = ir_benchmark_rows(dataset=str(args.dir), measure=args.measure, num_queries=args.queries,
                             variants=tuple(args.variants.split(",")), config=config)
    print(_table_text(rows, args.measure))  # noqa: T201
    print(f"\n{time.perf_counter() - t0:.0f}s total")  # noqa: T201
    result_path = args.dir / f"results_{args.measure.replace('@', '_at_')}.json"
    result_path.write_text(json.dumps({args.measure: {row["variant"]: row[args.measure] for row in rows}}))
    print(f"written: {result_path}")  # noqa: T201
    return rows


# --- The rerank blend sweep (scripts/rerank_blend_sweep.py) ---------------------


def blend_main(argv: list[str] | None = None) -> list[dict]:
    """Sweep ``config.reranker_blend`` over the rerank variant on the
    ``sem_mv`` store of an earlier ``main`` run with the same --docs,
    --queries and --adapter-queries (the same protocol, so its rows compare
    with that run's).  0.0 is the reranker's order, 1.0 the retrieval
    order; values between RRF-fuse the two.  Writes ``blend_sweep.json``
    and returns the rows."""
    from raglite_tpu_torch import RAGLiteConfig, search_and_rerank_chunks
    from raglite_tpu_torch.config import checked_device
    from raglite_tpu_torch.store import store_from_config

    parser = _parser("Sweep reranker_blend over an already-built multivector store.", docs=2122, queries=1000)
    parser.add_argument("--adapter-queries", type=int, default=1000)
    parser.add_argument("--workdir", type=Path, required=True, help="the evaluation's workdir holding sem_mv/")
    parser.add_argument("--embedder", required=True)
    parser.add_argument("--blends", default="0.0,0.25,0.5,0.75")
    args = parser.parse_args(argv)
    device = str(checked_device(args.device))
    texts, queries, _ = load_protocol(args.docs, args.queries, args.adapter_queries, heldout=args.corpus / "heldout.jsonl")
    config_mv = RAGLiteConfig(
        store_path=str(args.workdir / "sem_mv"), embedder=args.embedder, llm="echo", device=device,
        vector_search_multivector=True, vector_search_query_adapter=False,
    )
    store = store_from_config(config_mv)
    if len(store.documents) < len(texts):
        msg = f"store at {args.workdir}/sem_mv is not fully built; run the evaluation first"
        raise SystemExit(msg)
    rows = []
    for blend in [float(b) for b in args.blends.split(",")]:
        cfg = replace(config_mv, reranker_blend=blend)

        def rerank_fn(query, cfg=cfg):
            chunks = search_and_rerank_chunks(query, num_results=40, config=cfg)
            return doc_ranking([c.id for c in chunks], list(range(len(chunks), 0, -1)), store)

        rows.append(evaluate_variant(f"rerank-blend-{blend}", rerank_fn, queries, store))
        print(rows[-1], flush=True)  # noqa: T201
    out = args.workdir / "blend_sweep.json"
    out.write_text(json.dumps({"embedder": args.embedder, "rows": rows}, indent=1))
    print(f"written: {out}")  # noqa: T201
    return rows


if __name__ == "__main__":
    commands = {"beir": beir_main, "blend-sweep": blend_main}
    if len(sys.argv) > 1 and sys.argv[1] in commands:
        commands[sys.argv[1]](sys.argv[2:])
    else:
        main()
