#!/usr/bin/env python3
"""Drive the PyTorch port's retrieval path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 1249280] [--profile]

Phases (any failure ends the run with a non-zero exit; nothing is caught):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel (one nvcc per source, in parallel).
2. Each kernel against its plain PyTorch version at d=768, N=64 x L,
   B in {1, 8, 32}, with duplicated rows (ties), invalid rows and a step of
   bucket padding: int4_bucket_scan and int8 bucketed_max_scan bit for
   bit; bf16 bucketed_max_scan to a stated tolerance.
3. Serve with the default config (packaged 8-layer d=768 encoder, bf16
   rows, ":memory:" store): insert the repo's README, SURVEY, MIGRATION and
   PARITY documents, add seeded unit-vector background chunks until the
   index holds ``--rows`` rows, answer 8 queries through vector_search and
   4 through search_and_rerank_chunk_spans.  Asserts the int4 two-stage
   route served them, chunk recall@10 >= 0.99 against the exact route, and
   a real document chunk as every top hit.
4. Serve single-stage (int8 rows, use_pallas, no int4 stage): the same
   queries, asserting the single-stage kernel served them.
5. Timings at the index's own arrays (B = 1 and 32): each kernel, its plain
   version and one PyTorch library computation of the same function (CUDA
   events, median of 20 runs of 10 launches), the kernels' bound,
   vector_search p50 and its split into query encode and index search.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D = 768
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8 ops/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
#: bf16 rows: kernel and plain version sum in different orders (f32).
BF16_RTOL = 1e-5
RECALL_MIN = 0.99


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` runs of the CUDA-event time of ``inner``
    back-to-back calls of ``fn``, divided by ``inner`` (so the host's time
    to enqueue one call hides behind the device's work on the previous)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def check_kernels(seed: int) -> dict[str, float]:
    """Phase 2: kernels vs plain versions on synthetic data with ties,
    invalid rows and padding, at d=768 (the tensor-core path) for B in
    {1, 8, 32}, and at d=200, B=40 (the simple path, and a second query
    tile).  Returns the max abs error per kernel."""
    import torch

    from raglite_tpu_torch.ops import fused_scan as fs

    g = torch.Generator(device="cuda").manual_seed(seed)
    errs = {"int4_bucket_scan": 0.0, "bucketed_max_scan": 0.0}
    for batch, d, steps in ((1, D, 64), (8, D, 64), (32, D, 64), (40, 200, 16)):
        for name, L in (("int4_bucket_scan", fs.INT4_NUM_BUCKETS), ("bucketed_max_scan", 1024)):
            n = steps * L
            rows = torch.randn((n, d), generator=g, device="cuda")
            rows[n // 2 : n // 2 + 64] = rows[:64]  # same bucket, later step: ties
            bias = torch.zeros(n, device="cuda")
            bias[torch.randint(0, n, (n // 50,), generator=g, device="cuda")] = fs.NEG
            bias[-L:] = fs.NEG  # one step of bucket padding
            bias[:64] = bias[n // 2 : n // 2 + 64] = 0.0  # the tied pairs stay valid
            q = torch.randint(-127, 128, (batch, d), generator=g, device="cuda", dtype=torch.int8)
            if name == "int4_bucket_scan":
                packed, scale4 = fs.pack_rows_int4(rows)
                args = (q, packed, scale4 * 0.01, bias)
                got = fs.int4_bucket_scan(*args, num_buckets=L)
                want = fs.int4_bucket_scan_plain(*args, num_buckets=L)
                cases = [("int4", got, want)]
            else:
                rows_i8, scale = fs.quantize_rows_int8(rows)
                got = fs.bucketed_max_scan(q, rows_i8, bias, scale, num_buckets=L)
                want = fs.bucketed_max_scan_plain(q, rows_i8, bias, scale, num_buckets=L)
                cases = [("int8", got, want)]
                qf = torch.randn((batch, d), generator=g, device="cuda")
                rows_bf = rows.to(torch.bfloat16)
                got_bf = fs.bucketed_max_scan(qf, rows_bf, bias, scale, num_buckets=L)
                want_bf = fs.bucketed_max_scan_plain(qf, rows_bf, bias, scale, num_buckets=L)
                cases.append(("bf16", got_bf, want_bf))
            torch.cuda.synchronize()
            for kind, (gs, gi), (ws, wi) in cases:
                err = float((gs - ws).abs().max())
                if kind in ("int4", "int8"):
                    assert torch.equal(gs, ws) and torch.equal(gi, wi), (name, kind, batch, err)
                    # Row n/2 + j duplicates row j (same bucket, later step):
                    # the later copy never wins.
                    dup = n // 2 + torch.arange(64, device="cuda", dtype=gi.dtype)
                    assert (gi[:, :64] != dup).all(), "a tie did not keep the lower row"
                else:
                    # Ids must agree where the bucket's best leads its runner-up
                    # by more than the tolerance.
                    sims = (qf.to(torch.bfloat16).float() @ rows_bf.float().T) * scale + bias
                    top2 = sims.view(batch, n // L, L).topk(2, dim=1).values
                    tol = BF16_RTOL * top2[:, 0].abs().clamp(min=1.0)
                    assert ((gs - ws).abs() <= tol).all(), (name, kind, batch, err)
                    sep = (top2[:, 0] - top2[:, 1]) > 2 * tol
                    assert torch.equal(gi[sep], wi[sep]), (name, kind, batch)
                    del sims
                errs[name] = max(errs[name], err)
                log(f"kernel check {name} [{kind}] B={batch} N={n} d={d} L={L}: max_abs_err={err} ok")
    return errs


def pick_queries(texts: list[str], count: int, seed: int) -> list[str]:
    """``count`` distinct sentences of 40-240 characters from the documents."""
    import numpy as np

    from raglite_tpu_torch.sentences import split_sentences

    pool = []
    for text in texts:
        for sentence in split_sentences(text):
            s = " ".join(sentence.split())
            if 40 <= len(s) <= 240 and not s.startswith(("#", "|", "`", "-")):
                pool.append(s)
    pool = sorted(set(pool))
    rng = np.random.default_rng(seed)
    return [pool[i] for i in rng.choice(len(pool), size=count, replace=False)]


def add_background(
    store, rows_needed: int, seed: int, *, rows_per_chunk: int = 16, device: str = "cuda"
) -> set[str]:
    """Seeded unit-vector background chunks (made on ``device``, in bulk),
    added through Store.add_chunks; returns their ids."""
    import numpy as np
    import torch

    from raglite_tpu_torch.documents import Chunk, Document

    doc = Document.from_text("background\n", id="background", filename="background")
    store.add_document(doc)
    g = torch.Generator(device=device).manual_seed(seed)
    n_chunks = -(-rows_needed // rows_per_chunk)
    vecs = torch.randn((n_chunks * rows_per_chunk, D), generator=g, device=device)
    vecs = (vecs / vecs.norm(dim=1, keepdim=True)).to(torch.float16).cpu().numpy()
    counts = np.full(n_chunks, rows_per_chunk)
    counts[-1] = rows_needed - rows_per_chunk * (n_chunks - 1)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    chunks, mats = [], []
    for i in range(n_chunks):
        chunks.append(Chunk(id=f"bg-{i}", document_id=doc.id, index=i, headings="", body=f"bg {i}\n"))
        mats.append(vecs[bounds[i] : bounds[i + 1]])
    store.add_chunks(chunks, mats)
    return {c.id for c in chunks}


def serve(cfg, queries: list[str], rerank_queries: list[str], background: set[str]):
    """Answer the queries through the user entry points.  Returns the
    routes taken, the kernel launches those queries made, recall@10
    against the exact route, and the vector_search latencies (ms)."""
    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.search import (
        corrected_num_hits,
        search_and_rerank_chunk_spans,
        vector_search,
    )

    routes, latencies = set(), []
    index = dense_index_from_config(cfg)
    for query in queries:
        t0 = time.perf_counter()
        ids, scores = vector_search(query, num_results=10, config=cfg)
        latencies.append((time.perf_counter() - t0) * 1e3)
        routes.add(index.last_route)
        assert len(ids) == 10 and all(map(lambda s: s == s and s > -1e30, scores)), (query, scores)
        assert ids[0] not in background, f"top hit of {query!r} is a background chunk"
    for query in rerank_queries:
        spans = search_and_rerank_chunk_spans(query, num_results=4, search=vector_search, config=cfg)
        routes.add(index.last_route)
        assert spans and all(c.id not in background for c in spans[0].chunks), query
    launches = dict(fs.launch_counts)
    # Recall@10 of the routed search against the exact route, same queries.
    emb = embed_queries(queries, config=cfg)
    hits = min(corrected_num_hits(4, 10, cfg), index.num_rows)
    recalls = []
    for b in range(len(queries)):
        routed = index.search_chunks_device(emb[b : b + 1], num_hits=hits, num_results=10)[1]
        exact = index.search_chunks_device(emb[b : b + 1], num_hits=hits, num_results=10, exact=True)[1]
        routed, exact = set(routed[0].tolist()), set(exact[0].tolist())
        recalls.append(len(routed & exact) / len(exact))
    # The two layers of one vector_search apart: the query encode, and the
    # index search with its one host fetch (both end synchronized).
    embed_ms, search_ms = [], []
    for b, query in enumerate(queries):
        t0 = time.perf_counter()
        embed_queries([query], config=cfg)
        t1 = time.perf_counter()
        index.search_chunks(emb[b : b + 1], num_hits=hits, num_results=10)
        embed_ms.append((t1 - t0) * 1e3)
        search_ms.append((time.perf_counter() - t1) * 1e3)
    layers = {"embed": statistics.median(embed_ms), "index search": statistics.median(search_ms)}
    return routes, launches, statistics.mean(recalls), latencies, layers


def time_kernels(index_bf16, index_i8, q_emb, card: str) -> list[dict]:
    """Phase 5: each kernel at the index's arrays, B = 1 and 32."""
    import torch

    from raglite_tpu_torch.ops import fused_scan as fs

    n = index_bf16.capacity
    out = []
    bias4 = torch.where(index_bf16._dev_valid, 0.0, fs.NEG).contiguous()
    bias8 = torch.where(index_i8._dev_valid, 0.0, fs.NEG).contiguous()
    unpacked = fs.unpack_rows_int4(index_bf16._dev_packed4)
    for batch in (1, 32):
        q = torch.as_tensor(q_emb[:batch], device="cuda")
        q_abs = q.abs().amax(dim=1, keepdim=True)
        q_i8 = torch.clamp(torch.round(q / (q_abs / 127.0)), -127, 127).to(torch.int8)
        specs = {
            "int4_bucket_scan": (
                lambda: fs.int4_bucket_scan(q_i8, index_bf16._dev_packed4, index_bf16._dev_scale4, bias4, num_buckets=fs.INT4_NUM_BUCKETS),
                lambda: fs.int4_bucket_scan_plain(q_i8, index_bf16._dev_packed4, index_bf16._dev_scale4, bias4, num_buckets=fs.INT4_NUM_BUCKETS),
                lambda: _library_scan(q_i8, unpacked, index_bf16._dev_scale4, bias4, fs.INT4_NUM_BUCKETS),
                n * D // 2, fs.INT4_NUM_BUCKETS,
            ),
            "bucketed_max_scan": (
                lambda: fs.bucketed_max_scan(q_i8, index_i8._dev_rows, bias8, index_i8._dev_scale),
                lambda: fs.bucketed_max_scan_plain(q_i8, index_i8._dev_rows, bias8, index_i8._dev_scale),
                lambda: _library_scan(q_i8, index_i8._dev_rows, index_i8._dev_scale, bias8, fs.DEFAULT_NUM_BUCKETS),
                n * D, fs.DEFAULT_NUM_BUCKETS,
            ),
        }
        for name, (kernel, plain, library, row_bytes, L) in specs.items():
            (ks, ki), (ps, pi) = kernel(), plain()
            torch.cuda.synchronize()
            assert torch.equal(ks, ps) and torch.equal(ki, pi), f"{name} disagrees at B={batch}, N={n}"
            ls, _ = library()
            assert torch.equal(ls, ps), f"library {name} disagrees at B={batch}"
            err = float((ks - ps).abs().max())
            ms = median_ms(kernel)
            plain_ms = median_ms(plain, reps=5, inner=1, warmup=1)
            library_ms = median_ms(library)
            moved = row_bytes + n * 8 + batch * D + batch * L * 8  # rows, rscale+bias, q, outputs
            ops = 2 * batch * n * D
            bound = {"bytes": moved / PEAK_BYTES_PER_S * 1e3, "operations": ops / PEAK_INT8_OPS_PER_S * 1e3}
            bound_by = max(bound, key=bound.get)
            log(
                f"timing {name} B={batch} N={n} d={D} on {card}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound[bound_by]:.4f} ms "
                f"({bound_by}); max_abs_err {err}"
            )
            out.append({
                "name": name, "batch": batch, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound[bound_by], "bound_by": bound_by,
                "max_abs_err": err,
            })
    return out


def _library_scan(q_i8, rows_i8, rscale, bias, num_buckets):
    """The same function from PyTorch library calls: ``torch._int_mm``
    (cuBLAS int8, which needs more than 16 rows: queries pad to 32), the
    f32 epilogue, and the bucket max/argmax on a [B, N/L, L] view."""
    import torch

    b = q_i8.shape[0]
    qp = torch.zeros((32, q_i8.shape[1]), dtype=torch.int8, device=q_i8.device)
    qp[:b] = q_i8
    sims = torch._int_mm(qp, rows_i8.T)[:b].to(torch.float32) * rscale + bias
    folded = sims.view(b, -1, num_buckets)
    step = folded.argmax(dim=1)
    return folded.gather(1, step[:, None, :])[:, 0], step


def profile_search(cfg, queries: list[str], card: str) -> None:
    """``--profile``: one torch.profiler window over ``queries`` answered by
    vector_search (warm), printing the device's busy time by kernel and its
    idle share of the window (the profiler's own host overhead is inside the
    window, so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raglite_tpu_torch.search import vector_search

    for query in queries[:2]:
        vector_search(query, num_results=10, config=cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for query in queries:
            vector_search(query, num_results=10, config=cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    log(
        f"profile: {len(queries)} vector_search calls, window {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}, {sum(k[2] for k in kernels)} "
        f"device ops, on {card}"
    )
    for name, us, count in kernels[:12]:
        log(f"  profile: {us / 1e3:9.3f} ms  {count:5d}x  {name[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=1_249_280)
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace 8 warm vector_search calls of each route with torch.profiler",
    )
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "raglite_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.ops import cuda_build
    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.store import store_from_config

    # 1. Environment and build.
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 2. Kernels vs plain versions.
    errs = check_kernels(args.seed)

    # 3. Serve, default config (int4 two-stage route).
    texts = [(ROOT / f).read_text(encoding="utf-8") for f in ("README.md", "SURVEY.md", "MIGRATION.md", "PARITY.md")]
    cfg = RAGLiteConfig(store_path=":memory:", device="cuda")
    assert cfg.embedder == "flax:sem" and cfg.embedding_dtype == "bfloat16" and cfg.use_int4_stage1
    t0 = time.perf_counter()
    insert_documents([Document.from_text(t) for t in texts], config=cfg)
    store = store_from_config(cfg)
    doc_rows = sum(m.shape[0] for m in store.embeddings.values())
    log(f"inserted 4 documents: {len(store.chunk_order)} chunks, {doc_rows} rows in {time.perf_counter() - t0:.1f} s")
    background = add_background(store, args.rows - doc_rows, args.seed)
    queries = pick_queries(texts, 8 + 4 + 32, args.seed)
    vs_q, rr_q, bench_q = queries[:8], queries[8:12], queries[12:]
    fs.reset_launch_counts()
    routes, launches_default, recall, latencies, layers = serve(cfg, vs_q, rr_q, background)
    index_bf16 = dense_index_from_config(cfg)
    log(f"default path: {index_bf16.num_rows} rows, routes {sorted(routes)}, launches {launches_default}, recall@10 vs exact {recall:.4f}")
    assert index_bf16.num_rows == args.rows, index_bf16.num_rows
    assert routes == {"int4_two_stage"}, routes
    assert launches_default["int4_bucket_scan"] > 0 and launches_default["bucketed_max_scan"] == 0
    assert recall >= RECALL_MIN, recall
    p50 = statistics.median(latencies)
    log(f"vector_search p50 {p50:.3f} ms over {len(latencies)} queries (int4 route, embed included) on {card}")
    log(f"vector_search layers p50 (int4 route): {layers} ms on {card}")
    if args.profile:
        profile_search(cfg, vs_q, card)

    # 4. Serve, single-stage (int8 rows, use_pallas, no int4 stage).
    cfg8 = RAGLiteConfig(
        store_path=":memory:", device="cuda", embedding_dtype="int8",
        use_pallas=True, use_int4_stage1=False,
    )
    fs.reset_launch_counts()
    routes8, launches_single, recall8, latencies8, layers8 = serve(cfg8, vs_q, rr_q, background)
    log(f"single-stage path: routes {sorted(routes8)}, launches {launches_single}, recall@10 vs exact {recall8:.4f}")
    assert routes8 == {"fused_scan"}, routes8
    assert launches_single["bucketed_max_scan"] > 0 and launches_single["int4_bucket_scan"] == 0
    assert recall8 >= RECALL_MIN, recall8
    log(f"vector_search p50 {statistics.median(latencies8):.3f} ms (single-stage int8 route) on {card}")
    log(f"vector_search layers p50 (single-stage int8 route): {layers8} ms on {card}")
    if args.profile:
        profile_search(cfg8, vs_q, card)

    # 5. Timings at the served index's arrays.
    from raglite_tpu_torch.embed import embed_queries

    q_emb = embed_queries((vs_q + bench_q)[:32], config=cfg)
    timings = time_kernels(index_bf16, dense_index_from_config(cfg8), q_emb, card)
    n_queries = len(vs_q) + len(rr_q)
    launches = {"int4_bucket_scan": launches_default["int4_bucket_scan"], "bucketed_max_scan": launches_single["bucketed_max_scan"]}
    log(f"launches per query: { {k: v / n_queries for k, v in launches.items()} }")
    replaces = {
        "int4_bucket_scan": ("raglite_tpu_torch/csrc/int4_scan.cu", "raglite_tpu/ops/fused_scan.py:269"),
        "bucketed_max_scan": ("raglite_tpu_torch/csrc/bucket_scan.cu", "raglite_tpu/ops/fused_scan.py:65"),
    }
    kernels = []
    for name, (source, replaced) in replaces.items():
        t = next(t for t in timings if t["name"] == name and t["batch"] == 1)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaced,
            "launches": launches[name], "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(f"kernels: {json.dumps([k['name'] for k in kernels])} (times at B=1, N={index_bf16.capacity}, d={D})")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
