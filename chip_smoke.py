#!/usr/bin/env python3
"""Drive the PyTorch port's retrieval and answer path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 1249280] [--profile] [--only prefill]

Phases (any failure ends the run with a non-zero exit; nothing is caught):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel (one nvcc per source, in parallel).
2. Each kernel against its plain PyTorch version at d=768, N=64 x L,
   B in {1, 8, 32}, with duplicated rows (ties), invalid rows and a step of
   bucket padding: int4_bucket_scan and int8 bucketed_max_scan bit for
   bit; bf16 bucketed_max_scan to a stated tolerance.
2b. The three attention kernels against their plain versions (bf16 caches;
   decode at B in {1, 4}, (KVH, REP, hd) in {(4, 5, 128), (2, 1, 64),
   (2, 4, 32), (1, 2, 256)}, S in {2208, 1003}, per-row positions (position
   0 and S - 1 in one batch among them), soft-cap and window on and off;
   verify at T in {2, 8, 16}, every row bit-equal to a decode call at
   pos0 + t; back-to-back calls with different S on one stream, which share
   the kernel's scratch and counters; a window at the end of a 34,824-key
   cache; prefill at the same (KVH, REP, hd) and at (2, 9, 64) and (1, 130,
   32), T in {24, 64, 333, 2048} with nonzero offsets, S a multiple of 8
   (tiles by TMA, and once more staged by threads) and not (staged), whole
   key tiles skipped below a window, a negative offset beside a positive
   one, back-to-back calls on caches of different S, and the RAG prompt's
   own T = 8192 at S = 8352), each output within attention_tolerance (the
   smaller of a sound and a statistical bound on bf16 probability rounding).
3. Serve with the default config (packaged 8-layer d=768 encoder, bf16
   rows, ":memory:" store): insert the repo's README, SURVEY, MIGRATION and
   PARITY documents, add seeded background chunks of 2 unit-vector rows each
   until the index holds ``--rows`` rows (624,580 chunks at the default),
   each with a body of 12 terms drawn as bench.py's hybrid section draws
   them (zipf(1.3) mod 30,000, "w<t>"), answer 8 queries through
   vector_search and 4 through search_and_rerank_chunk_spans with
   search=vector_search.  Asserts the int4 two-stage route served them,
   chunk recall@10 >= 0.99 against the exact route, and a real document
   chunk as every top hit.
4. Serve single-stage (int8 rows, use_pallas, no int4 stage): the same
   queries, asserting the single-stage kernel served them.
4b. Keyword and hybrid search on the default config: sync the keyword index
   over the whole store (the native C++ postings builder, asserted) and
   build its resident postings on the card (build time, postings, bytes);
   the 8 sentences through hybrid_search and keyword_search and the 4
   rerank sentences through search_and_rerank_chunk_spans with its default
   search (hybrid), asserting the fused device route and the int4 route
   served every hybrid call and a document chunk as every top hit; 256
   tail-term queries (bench.py's recipe) where the resident BM25 must equal
   the host-gather route (ids equal, scores within rtol 1e-4) and, on 32 of
   them, the device RRF must equal reciprocal_rank_fusion over the same
   per-side lists (0 mismatches); p50s of keyword_search and hybrid_search
   at B = 1, hybrid_search's split (encode, dense side, BM25 side, RRF and
   fetch), queries per second of the batch forms at B = 256 (and hybrid at
   B = 32), and each torch-op program's time per call (CUDA events) beside
   its bytes bound; ``--profile`` counts the device operations of one
   hybrid_search call.
5. Timings at the index's own arrays (B = 1 and 32): each kernel, its plain
   version and one PyTorch library computation of the same function (CUDA
   events, median of 20 runs of 10 launches), the kernels' bound,
   vector_search p50 and its split into query encode and index search.
6. RAG: RAGLiteConfig(llm="jax:large") over the phase-3 index (36 layers,
   d 2560, seeded bf16 weights): a rag() answer streamed from
   add_context(question, retrieve_context(question)), asserting one prefill
   kernel launch per layer and one verify launch per layer and speculative
   iteration (no attention on the plain path); a sampled TorchChatLLM.stream
   (temperature 0.7, top_k 20, top_p 0.8) that launches the decode kernel;
   greedy with speculation off against on (common-prefix share, reported).
   Prints the prompt tokens, time to the first token, decode tokens/s.
7. Attention kernels at the `large` shapes (B = 1), each checked against
   its plain version and timed against its bound, its plain version and one
   scaled_dot_product_attention call, on 36 rotating per-layer caches (more
   than L2 holds, as the decoder's layers are): decode at the answer's S and
   at S = 8352, verify at T = 8 and T = 16, prefill at the answer's own
   prompt bucket and S (the launches that served it) and at T = 2048; every
   verify row is again held bit-equal to a decode call.  Every kernel's time
   ("ms") is that of calls enqueued one by one; decode and verify are timed
   once more replayed from a CUDA graph of 36 calls ("graph_ms": the device's
   time without the host's), each beside an empty kernel launched with the
   same grid and shared memory (the launch floor); prefill is timed once more
   with its tiles staged by threads, and its TFLOP/s printed beside the bound.
``--only prefill`` is a partial run for work on that kernel (its checks of
phase 2b and its rows of phase 7; no result line).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
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
PEAK_BF16_FLOPS = 989e12
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


def graph_ms(fn, calls: int = 36, reps: int = 20) -> float:
    """Median over ``reps`` replays of the CUDA-event time of a CUDA graph of
    ``calls`` back-to-back calls of ``fn``, divided by ``calls``: the device's
    time for one call with no host work between launches.  ``fn`` runs
    ``calls`` times on the capture stream first, so whatever it keeps per
    stream exists before the capture."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(calls):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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


def _attention_check(what, got, want, q, k, v, offsets, **kw) -> tuple[float, float]:
    """Assert every output of an attention kernel lies within
    ``attention_tolerance`` of its plain version ``want`` on the same inputs;
    returns (max abs error, largest share of the limit used)."""
    from raglite_tpu_torch.ops.decode_attention import attention_tolerance

    limit = attention_tolerance(q, k, v, offsets, **kw)
    diff = (got.reshape(want.shape) - want).abs()
    share = float((diff / limit).max())
    assert share <= 1.0, (what, float(diff.max()), share)
    return float(diff.max()), share


def _cache(g, b, kvh, hd, s):
    import torch

    k = torch.randn((b, kvh, hd, s), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, kvh, hd, s), generator=g, device="cuda").to(torch.bfloat16)
    return k, v


def check_attention_kernels(seed: int, *, prefill_only: bool = False) -> dict[str, float]:
    """Phase 2b: the three attention kernels against their plain versions
    on the card (bf16 caches, ragged S, per-row positions, soft-cap and
    window on and off), and every verify row against a decode call at
    ``pos0 + t``, bit for bit.  Returns the max abs error per kernel.
    ``prefill_only`` leaves out decode and verify."""
    import torch

    from raglite_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(seed)
    errs = {"gqa_decode_attention": 0.0, "gqa_verify_attention": 0.0, "gqa_prefill_attention": 0.0}
    shares = dict.fromkeys(errs, 0.0)

    def check(name, what, got, want, q, k, v, offsets, **kw):
        err, share = _attention_check(what, got, want, q, k, v, offsets, **kw)
        errs[name], shares[name] = max(errs[name], err), max(shares[name], share)

    def first_positions(kind, batch, s, t):
        """The first window position per row.  "spread": rows far apart;
        "edges": position 0 and a window that ends on the cache's last key
        S - 1 in one batch."""
        rows = [1234, 0, 700, s - 17] if kind == "spread" else [0, s - t, 1, s - t - 1]
        return torch.tensor(rows[:batch], device="cuda", dtype=torch.int32)

    # hd = 256 is the widest head the kernels are built for; REP 5 at T = 16
    # is 80 rows (five row tiles), REP 1 at T = 1 a tile with 15 padded rows.
    for kvh, rep, hd in () if prefill_only else ((4, 5, 128), (2, 1, 64), (2, 4, 32), (1, 2, 256)):
        scale = hd**-0.5
        for batch, s, kind in ((1, 2208, "spread"), (4, 2208, "spread"), (4, 1003, "spread"), (4, 2208, "edges"), (4, 1003, "edges")):
            k, v = _cache(g, batch, kvh, hd, s)
            for softcap, window in KNOBS:
                kw = dict(scale=scale, softcap=softcap, window=window)
                what = (kvh, rep, hd, batch, s, kind, softcap, window)
                # Decode.
                pos = first_positions(kind, batch, s, 1)
                q = torch.randn((batch, kvh, rep, hd), generator=g, device="cuda").to(torch.bfloat16)
                got = da.gqa_decode_attention(q, k, v, pos, **kw)
                q5 = q[:, :, :, None]
                check("gqa_decode_attention", ("decode", *what), got, da.gqa_attention_plain(q5, k, v, pos, **kw), q5, k, v, pos, **kw)
                # Verify windows: each row t bit-equal to decode at pos0 + t.
                for t in (2, 8, 16):
                    pos = first_positions(kind, batch, s, t)
                    qv = torch.randn((batch, kvh, rep, t, hd), generator=g, device="cuda").to(torch.bfloat16)
                    got = da.gqa_verify_attention(qv, k, v, pos, **kw)
                    for i in range(t):
                        one = da.gqa_decode_attention(qv[:, :, :, i], k, v, pos + i, **kw)
                        assert torch.equal(got[:, :, :, i], one), ("verify != decode", *what, t, i)
                    check("gqa_verify_attention", ("verify", *what, t), got, da.gqa_attention_plain(qv, k, v, pos, **kw), qv, k, v, pos, **kw)
            log(f"attention check KVH={kvh} REP={rep} hd={hd} B={batch} S={s} positions {kind}: decode and verify ok "
                f"(verify rows bit-equal to decode), max_abs_err so far {errs}, share of limit {shares}")
        # Back-to-back calls on one stream with different S, growing and
        # shrinking, nothing synchronised between them: they share the
        # kernel's scratch and ticket counters.  Checked after the last.
        kw = dict(scale=scale, softcap=0.0, window=0)
        queued = []
        for s in (1003, 4160, 264, 2208, 4160):
            k, v = _cache(g, 2, kvh, hd, s)
            pos = torch.tensor([s - 9, s // 2], device="cuda", dtype=torch.int32)
            q = torch.randn((2, kvh, rep, hd), generator=g, device="cuda").to(torch.bfloat16)
            qv = torch.randn((2, kvh, rep, 8, hd), generator=g, device="cuda").to(torch.bfloat16)
            queued.append(("gqa_decode_attention", q[:, :, :, None], k, v, pos, da.gqa_decode_attention(q, k, v, pos, **kw)))
            queued.append(("gqa_verify_attention", qv, k, v, pos, da.gqa_verify_attention(qv, k, v, pos, **kw)))
        for name, q5, k, v, pos, got in queued:
            check(name, ("back to back", name, kvh, rep, hd, k.shape[3]), got, da.gqa_attention_plain(q5, k, v, pos, **kw), q5, k, v, pos, **kw)
        log(f"attention check KVH={kvh} REP={rep} hd={hd}: {len(queued)} back-to-back calls at S in (1003, 4160, 264, 2208, 4160) ok")
        # A long cache, read to its end: 273 splits in 35 chunks, so the final
        # merge takes several rounds of loads and, at hd = 32 with 64 rows,
        # its weights no longer fit shared memory at once (rows in batches).
        s = 34_824
        k, v = _cache(g, 1, kvh, hd, s)
        pos = torch.tensor([s - 16], device="cuda", dtype=torch.int32)
        qv = torch.randn((1, kvh, rep, 16, hd), generator=g, device="cuda").to(torch.bfloat16)
        got = da.gqa_verify_attention(qv, k, v, pos, **kw)
        for i in range(16):
            one = da.gqa_decode_attention(qv[:, :, :, i], k, v, pos + i, **kw)
            assert torch.equal(got[:, :, :, i], one), ("verify != decode", kvh, rep, hd, s, i)
        check("gqa_verify_attention", ("long cache", kvh, rep, hd, s), got, da.gqa_attention_plain(qv, k, v, pos, **kw), qv, k, v, pos, **kw)
        log(f"attention check KVH={kvh} REP={rep} hd={hd} B=1 S={s}: verify T=16 at the cache's end ok (rows bit-equal to decode)")
    # Prefill at the same shapes; REP 9 (18 query heads on 2 KV heads: 14
    # positions a tile, two rows unused); REP 130 (one position a tile, the
    # heads in two chunks).
    for kvh, rep, hd in ((4, 5, 128), (2, 1, 64), (2, 4, 32), (1, 2, 256), (2, 9, 64), (1, 130, 32)):
        check_prefill_kernel(g, check, kvh, rep, hd)
        log(f"attention check prefill KVH={kvh} REP={rep} hd={hd}: ok, max_abs_err so far "
            f"{errs['gqa_prefill_attention']}, share of limit {shares['gqa_prefill_attention']:.4f}")
    return errs


#: (softcap, window) pairs every attention check runs.
KNOBS = ((0.0, 0), (50.0, 0), (0.0, 512), (30.0, 300))


def _prefill_staged(q, k, v, off, *, scale: float, softcap: float = 0.0, window: int = 0):
    """The prefill kernel with its tiles staged by the producer's threads
    whatever S is (``rlt_gqa_prefill_staged``; a measurement's entry, which
    the package never calls): the path S % 8 != 0 takes, at any S."""
    import torch

    from raglite_tpu_torch.ops import cuda_build
    from raglite_tpu_torch.ops import prefill_attention as pa

    fn = cuda_build.function("prefill_attention", "rlt_gqa_prefill_staged", pa._PREFILL[2])
    b, kvh, rep, t, hd = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), b, kvh, rep, t, hd, k.shape[3],
        float(scale), float(softcap), int(window), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    assert rc == 0, f"rlt_gqa_prefill_staged: cudaError {rc}"
    return out


def check_prefill_kernel(g, check, kvh: int, rep: int, hd: int) -> None:
    """Phase 2b, prefill: the kernel against its plain version at one (KVH,
    REP, hd).  T in {24, 64, 2048} at nonzero offsets (T = 24 is a verify
    window wider than 16, one tile of rows); S = T + 160 leaves room for the
    offsets and takes the TMA path, S = T + 163 (not a multiple of 8) the
    staged one; T = 333 (no multiple of a tile's positions) at offsets that
    leave whole key tiles skipped below the windows; a negative offset (rows
    with no valid key: the uniform softmax) beside a positive one; two calls
    back to back on caches of different shapes; the staged path at an S that
    TMA takes; at the `large` preset's (4, 5, 128) the RAG prompt's own T
    8,192 at S 8,352."""
    import torch

    from raglite_tpu_torch.ops import decode_attention as da
    from raglite_tpu_torch.ops.prefill_attention import gqa_prefill_attention

    scale = hd**-0.5
    cases = [
        (2, 24, 184, [160, 37]), (2, 64, 227, [160, 37]), (1, 2048, 2208, [160]), (2, 2048, 2211, [160, 37]),
        (2, 333, 2208, [1500, 900]), (2, 333, 2211, [1500, 900]), (2, 64, 184, [-5, 40]), (2, 64, 187, [-70, 123]),
    ]
    if (kvh, rep, hd) == (4, 5, 128):
        cases.append((1, 8192, 8352, [0]))
    for batch, t, s, offsets in cases:
        k, v = _cache(g, batch, kvh, hd, s)
        off = torch.tensor(offsets, device="cuda", dtype=torch.int32)
        q = torch.randn((batch, kvh, rep, t, hd), generator=g, device="cuda").to(torch.bfloat16)
        for softcap, window in KNOBS if t < 8192 else KNOBS[:1]:
            kw = dict(scale=scale, softcap=softcap, window=window)
            what = ("prefill", kvh, rep, hd, batch, t, s, tuple(offsets), softcap, window)
            want = da.gqa_attention_plain(q, k, v, off, **kw)
            check("gqa_prefill_attention", what, gqa_prefill_attention(q, k, v, off, **kw), want, q, k, v, off, **kw)
            if s % 8 == 0 and t <= 2048:
                check("gqa_prefill_attention", ("staged", *what), _prefill_staged(q, k, v, off, **kw), want, q, k, v, off, **kw)
            del want
        log(f"attention check prefill KVH={kvh} REP={rep} hd={hd} B={batch} T={t} S={s} offsets {offsets}: ok "
            f"({'TMA and staged tiles' if s % 8 == 0 else 'staged tiles'})")
    # Back to back on one stream, nothing synchronised between: caches of
    # different S behind each other (each its own tensor map), checked after.
    kw = dict(scale=scale, softcap=0.0, window=0)
    queued = []
    for s in (264, 1008, 264):
        k, v = _cache(g, 1, kvh, hd, s)
        off = torch.tensor([s - 100], device="cuda", dtype=torch.int32)
        q = torch.randn((1, kvh, rep, 100, hd), generator=g, device="cuda").to(torch.bfloat16)
        queued.append((q, k, v, off, gqa_prefill_attention(q, k, v, off, **kw)))
    for q, k, v, off, got in queued:
        check("gqa_prefill_attention", ("back to back", kvh, rep, hd, k.shape[3]), got, da.gqa_attention_plain(q, k, v, off, **kw), q, k, v, off, **kw)


def _sdpa(q, k, v, mask):
    """One library call of the same attention: scaled_dot_product_attention
    with enable_gqa on the cache's transposed view (timed here, never
    called by the port).  q [B, H, T, hd], k/v [B, KVH, hd, S], mask [B, 1,
    T, S]."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q, k.transpose(2, 3), v.transpose(2, 3), attn_mask=mask, enable_gqa=True
    )


@functools.lru_cache(maxsize=None)
def _stamped_decode_library():
    """``csrc/decode_attention.cu`` compiled a second time with -DRLT_STAMPS
    into a directory of this script's own (the package builds and loads the
    plain kernel only).  Returns (launcher, scratch floats, counters, stamp
    reader), bound with ctypes."""
    import ctypes
    import shutil

    from raglite_tpu_torch.ops import cuda_build

    out = cuda_build.BUILD_DIR / "chip_smoke" / "libdecode_attention_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    source = cuda_build.CSRC / "decode_attention.cu"
    subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-DRLT_STAMPS", "-o", str(out), str(source)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    void, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rlt_gqa_decode.argtypes = [*[void] * 4, *[i32] * 6, f32, f32, i32, *[void] * 4]
    lib.rlt_gqa_decode_scratch.argtypes, lib.rlt_gqa_decode_scratch.restype = [i32] * 5, ctypes.c_longlong
    lib.rlt_gqa_decode_counters.argtypes, lib.rlt_gqa_decode_counters.restype = [i32] * 3, ctypes.c_longlong
    lib.rlt_gqa_decode_stamps.argtypes = [void]
    return lib.rlt_gqa_decode, lib.rlt_gqa_decode_scratch, lib.rlt_gqa_decode_counters, lib.rlt_gqa_decode_stamps


def attention_phases(q5, warm, cache, pos, scale: float, what: str, card: str) -> None:
    """``--profile``: where one decode or verify launch spends its time.  In
    the kernel's -DRLT_STAMPS build thread 0 of every block notes the card's
    nanosecond timer at seven points.  Launches on the ``warm`` caches (more
    bytes than L2 holds) load the code and push ``cache`` (K, V) out of L2;
    then one launch on ``cache`` is read back and printed as microseconds
    after the first block's start (median and latest over the blocks that
    passed the point)."""
    import numpy as np
    import torch

    from raglite_tpu_torch.ops import decode_attention as da

    launch, scratch_floats, counter_ints, read = _stamped_decode_library()
    b, kvh, rep, t, hd = q5.shape
    k, v = cache
    s = k.shape[3]
    scratch = torch.empty(scratch_floats(b, kvh, rep * t, hd, s), dtype=torch.float32, device="cuda")
    counters = torch.zeros(counter_ints(b, kvh, s), dtype=torch.int32, device="cuda")
    out = torch.empty(q5.shape, dtype=torch.float32, device="cuda")
    host = np.zeros((7, 4096), np.uint64)
    for cache_k, cache_v in (*warm, cache):
        rc = launch(
            q5.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(), b, kvh, rep * t, t, hd, s,
            float(scale), 0.0, 0, out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        assert rc == 0, f"rlt_gqa_decode (stamped): cudaError {rc}"
        torch.cuda.synchronize()
        assert read(host.ctypes.data) == 0
    assert torch.equal(out, da.gqa_verify_attention(q5, k, v, pos, scale=scale)), "the stamped build disagrees"
    blocks = min(b * kvh * -(-s // 128), host.shape[1])
    stamps = host[:, :blocks].astype(np.float64)
    start = stamps[0].min()
    points = ("start", "K and Q landed", "split done", "ticket 1 known", "chunk merge done", "ticket 2 known", "final merge done")
    parts = []
    for point, row in zip(points[1:], stamps[1:]):
        at = (row[row > 0] - start) / 1e3
        parts.append(f"{point} {np.median(at):.2f} / {at.max():.2f} ({at.size} blocks)")
    log(f"phases of one {what} launch on {card}, microseconds after the first block's start, "
        f"median / latest over the blocks that reached the point: " + "; ".join(parts))


@functools.lru_cache(maxsize=None)
def _stamped_prefill_library():
    """``csrc/prefill_attention.cu`` compiled a second time with -DRLT_STAMPS
    into this script's own directory (the package builds and loads the plain
    kernel only).  Returns (launcher, stamp reader), bound with ctypes."""
    import ctypes
    import shutil

    from raglite_tpu_torch.ops import cuda_build
    from raglite_tpu_torch.ops import prefill_attention as pa

    out = cuda_build.BUILD_DIR / "chip_smoke" / "libprefill_attention_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    source = cuda_build.CSRC / "prefill_attention.cu"
    subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-DRLT_STAMPS", "-o", str(out), str(source)], check=True, capture_output=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    lib.rlt_gqa_prefill.argtypes = pa._PREFILL[2]
    lib.rlt_gqa_prefill_stamps.argtypes = [ctypes.c_void_p]
    return lib.rlt_gqa_prefill, lib.rlt_gqa_prefill_stamps


def prefill_phases(q5, warm, cache, pos, scale: float, what: str, card: str) -> None:
    """``--profile``: where one prefill launch spends its time.  In the
    kernel's -DRLT_STAMPS build every block notes the card's nanosecond timer
    at its start, when its first K tile has landed and at its end, and sums
    the SM clocks one consumer warpgroup spends waiting for tiles, waiting
    for its own products, queueing them and in the softmax, the clocks of the
    whole block, and the clocks the producer waits for an empty stage.
    Launches on the ``warm`` caches load the code and push ``cache`` out of
    L2; then one launch on ``cache`` is read back."""
    import numpy as np
    import torch

    from raglite_tpu_torch.ops import decode_attention as da

    launch, read = _stamped_prefill_library()
    b, kvh, rep, t, hd = q5.shape
    s = cache[0].shape[3]
    out = torch.empty(q5.shape, dtype=torch.float32, device="cuda")
    host = np.zeros((10, 4096), np.uint64)
    for cache_k, cache_v in (*warm, cache):
        rc = launch(
            q5.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(), b, kvh, rep, t, hd, s,
            float(scale), 0.0, 0, out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        assert rc == 0, f"rlt_gqa_prefill (stamped): cudaError {rc}"
        torch.cuda.synchronize()
        assert read(host.ctypes.data) == 0
    want = da.gqa_attention_plain(q5, *cache, pos, scale=scale)
    _attention_check(("stamped prefill", t, s), out, want, q5, *cache, pos, scale=scale)
    del want
    start, first_tile, end, tiles, wait_tile, product, softmax, producer_wait, queueing, block_clocks = host.astype(np.float64)
    ran = end > 0
    blocks = int(ran.sum())
    t0 = start[ran].min()
    ends = np.sort(end[ran] - t0) / 1e3
    total_tiles = tiles[ran].sum()
    clocks = {
        "waiting for a K or V tile": wait_tile[ran].sum(), "queueing its wgmma": queueing[ran].sum(),
        "waiting for its own products": product[ran].sum(), "softmax, scaling and packing": softmax[ran].sum(),
        "all of the block": block_clocks[ran].sum(), "producer waiting for an empty stage": producer_wait[ran].sum(),
    }
    ghz = block_clocks[ran].sum() / (end - start)[ran].sum()
    log(f"phases of one {what} launch on {card}: {blocks} blocks noted (of the first 4096), {int(total_tiles)} key tiles; "
        f"first K tile landed {np.median((first_tile - start)[ran]) / 1e3:.2f} us after a block's start (median; latest "
        f"{((first_tile - start)[ran]).max() / 1e3:.2f}); a block lasts {np.median((end - start)[ran]) / 1e3:.2f} us (median; "
        f"longest {((end - start)[ran]).max() / 1e3:.2f}); blocks end at {ends[0]:.1f} (first), {np.median(ends):.1f} (median), "
        f"{ends[int(0.9 * (blocks - 1))]:.1f} (90 %), {ends[-1]:.1f} us (last) after the first block's start; SM clocks a "
        f"key tile (the SM ran at {ghz:.3f} GHz), one consumer warpgroup: " + ", ".join(f"{k} {v / total_tiles:.0f}" for k, v in clocks.items()))


def time_attention(
    seed: int, rag_s: int, rag_pos: int, rag_t: int, card: str, *, profile: bool = False, only: str | None = None
) -> list[dict]:
    """Phase 7: each attention kernel at the ``large`` preset's shapes (B=1,
    KVH=4, REP=5, hd=128), first at the RAG answer's own (decode and verify
    at its S and position, prefill at its prompt bucket ``rag_t`` and S),
    then decode at S = 8,352 and prefill at T = 2,048 (S = 2,208).  Each is
    checked against its plain version, then timed against its bound, its
    plain version and one scaled_dot_product_attention call, every call on
    the next of 36 per-layer caches: as in a decoder forward, no cache is
    still in L2 when it is read again.  ``ms`` is the time of calls enqueued
    one by one for every kernel; decode and verify are also timed replayed
    from a CUDA graph (``graph_ms``), beside their launch floor; prefill is
    timed once more with its tiles staged by threads (``staged_ms``: what TMA
    buys) and its rate in TFLOP/s is printed beside the bound's.  ``profile``
    adds a torch.profiler window over 36 calls of each (every device
    operation a call makes) and the phases inside one launch
    (:func:`attention_phases`, :func:`prefill_phases`).  ``only`` keeps the
    cases of one kernel."""
    import itertools

    import torch

    from raglite_tpu_torch.ops import cuda_build
    from raglite_tpu_torch.ops import decode_attention as da
    from raglite_tpu_torch.ops.prefill_attention import gqa_prefill_attention

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    floor_fn = cuda_build.function("decode_attention", "rlt_gqa_decode_floor", [*[cuda_build.INT] * 5, cuda_build.VOID])
    kvh, rep, hd, layers = 4, 5, 128, 36
    heads, scale = kvh * rep, hd**-0.5
    cases = [
        ("gqa_decode_attention", 1, rag_s, rag_pos),
        ("gqa_verify_attention", 8, rag_s, rag_pos),
        ("gqa_prefill_attention", rag_t, rag_s, 0),
        ("gqa_decode_attention", 1, 8352, 8192 + 40),
        ("gqa_verify_attention", 16, 8352, 8192),
        ("gqa_prefill_attention", 2048, 2208, 0),
    ]
    kernels = {
        "gqa_decode_attention": lambda q5, k, v, pos: da.gqa_decode_attention(q5[:, :, :, 0], k, v, pos, scale=scale),
        "gqa_verify_attention": lambda q5, k, v, pos: da.gqa_verify_attention(q5, k, v, pos, scale=scale),
        "gqa_prefill_attention": lambda q5, k, v, pos: gqa_prefill_attention(q5, k, v, pos, scale=scale),
    }
    out = []
    for name, t, s, p0 in cases:
        if only not in (None, name):
            continue
        caches = [_cache(g, 1, kvh, hd, s) for _ in range(layers)]
        pos = torch.tensor([p0], device="cuda", dtype=torch.int32)
        q5 = torch.randn((1, kvh, rep, t, hd), generator=g, device="cuda").to(torch.bfloat16)
        qh = q5.reshape(1, heads, t, hd)
        key = torch.arange(s, device="cuda")
        rows = p0 + torch.arange(t, device="cuda")
        mask = (key[None, :] <= rows[:, None])[None, None]

        def rotating(fn):
            """``fn`` on the next layer's cache at every call."""
            nxt = itertools.cycle(caches)
            return lambda: fn(*next(nxt))

        kernel = rotating(lambda k, v: kernels[name](q5, k, v, pos))
        plain = rotating(lambda k, v: da.gqa_attention_plain(q5, k, v, pos, scale=scale))
        library = rotating(lambda k, v: _sdpa(qh, k, v, mask))
        k0, v0 = caches[0]
        want = da.gqa_attention_plain(q5, k0, v0, pos, scale=scale)
        err, share = _attention_check((name, t, s), kernels[name](q5, k0, v0, pos), want, q5, k0, v0, pos, scale=scale)
        lib_err = float((_sdpa(qh, k0, v0, mask).reshape(want.shape).float() - want).abs().max())
        if name == "gqa_verify_attention":
            # At the answer's own shapes too: every window row bit-equal to
            # the decode kernel at pos0 + t.
            got = kernels[name](q5, k0, v0, pos)
            for i in range(t):
                one = da.gqa_decode_attention(q5[:, :, :, i], k0, v0, pos + i, scale=scale)
                assert torch.equal(got[:, :, :, i], one), ("verify != decode", t, s, p0, i)
        del want
        torch.cuda.empty_cache()
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, reps=5, inner=1, warmup=1)
        library_ms = median_ms(library, reps=10, inner=5)
        # What this call must do: every valid key's K and V columns read once,
        # q read and the f32 context written once; 4 * hd flops per (query
        # head, valid key) pair.
        valid = torch.clamp(rows + 1, max=s)
        pairs = int(valid.sum()) * heads
        moved = int(valid.max()) * kvh * hd * 2 * 2 + q5.numel() * 2 + q5.numel() * 4
        bound = {"bytes": moved / PEAK_BYTES_PER_S * 1e3, "operations": 4 * hd * pairs / PEAK_BF16_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        entry = {
            "name": name, "T": t, "S": s, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound[bound_by], "bound_by": bound_by, "max_abs_err": err,
        }
        floor_text = ""
        if name == "gqa_prefill_attention":
            staged = rotating(lambda k, v: _prefill_staged(q5, k, v, pos, scale=scale))
            entry["staged_ms"] = median_ms(staged)
            flops = 4 * hd * pairs
            floor_text = (
                f"= {flops / ms / 1e9:.1f} TFLOP/s of the card's {PEAK_BF16_FLOPS / 1e12:.0f} "
                f"({flops / 1e9:.1f} GFLOP for the valid keys; the bound is {bound['operations']:.4f} ms), "
                f"{entry['staged_ms']:.4f} ms with its tiles staged by threads instead of TMA, "
            )
        else:
            # Decode and verify take microseconds, so the host's time to enqueue
            # a call can exceed the kernel's and "ms" then reads the host: time
            # them again replayed from a CUDA graph, and an empty kernel with
            # the same grid, block and shared memory both ways (the launch floor).
            def floor():
                rc = floor_fn(1, kvh, rep * t, hd, s, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, f"rlt_gqa_decode_floor: cudaError {rc}"

            entry["graph_ms"] = graph_ms(kernel)
            entry["floor_ms"], entry["floor_graph_ms"] = median_ms(floor), graph_ms(floor)
            floor_text = (
                f"enqueued call by call, {entry['graph_ms']:.4f} ms replayed from a CUDA graph of 36 calls; "
                f"launch floor (empty kernel, same grid and shared memory) {entry['floor_ms']:.4f} ms "
                f"enqueued, {entry['floor_graph_ms']:.4f} ms from the graph; "
            )
        log(
            f"timing {name} B=1 T={t} S={s} pos0={p0} (KVH {kvh}, REP {rep}, hd {hd}; {layers} rotating caches) "
            f"on {card}: kernel {ms:.4f} ms, {floor_text}plain {plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms "
            f"(max_abs_err vs plain {lib_err:.3g}), bound {bound[bound_by]:.4f} ms ({bound_by}); "
            f"max_abs_err {err}, share of limit {share:.4f}"
        )
        out.append(entry)
        if profile:
            _profile_window(lambda: [kernel() for _ in range(layers)], f"{layers} {name} calls (T = {t}, S = {s})", card)
        if profile and name == "gqa_prefill_attention":
            prefill_phases(q5, caches[:4], caches[layers // 2], pos, scale, f"{name} (T = {t}, S = {s})", card)
        elif profile:
            attention_phases(q5, caches[:4], caches[layers // 2], pos, scale, f"{name} (T = {t}, S = {s}, pos0 = {p0})", card)
        del caches, kernel, plain, library
        torch.cuda.empty_cache()
    return out


def _attention_launches() -> dict[str, int]:
    from raglite_tpu_torch.ops import decode_attention as da
    from raglite_tpu_torch.ops import prefill_attention as pa

    return {**da.launch_counts, **pa.launch_counts}


def _reset_attention_launches() -> None:
    from raglite_tpu_torch.ops import decode_attention as da
    from raglite_tpu_torch.ops import prefill_attention as pa

    da.reset_launch_counts()
    pa.reset_launch_counts()


def _timed_tokens(tokens) -> tuple[list[int], float, float]:
    """Drain a token iterator: (tokens, ms to the first, ms in all)."""
    import torch

    t0 = time.perf_counter()
    out, first = [], None
    for token in tokens:
        if first is None:
            first = (time.perf_counter() - t0) * 1e3
        out.append(token)
    torch.cuda.synchronize()
    return out, first or 0.0, (time.perf_counter() - t0) * 1e3


def _profile_window(fn, what: str, card: str) -> int:
    """One torch.profiler window over ``fn`` (warm): the device's busy time
    by kernel and its idle share of the window (the profiler's own host
    overhead is inside the window, so the idle share is an upper bound).
    Returns the number of device operations in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        f"profile: {what}, window {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / wall_us:.4f}, {sum(k[2] for k in kernels)} device ops, on {card}"
    )
    for name, us, count in kernels[:12]:
        log(f"  profile: {us / 1e3:9.3f} ms  {count:5d}x  {name[:110]}")
    return sum(k[2] for k in kernels)


def profile_decode(llm, ids, lens, rag_s: int, card: str) -> None:
    """``--profile``: the whole-model prefill of the RAG prompt, then one
    plain decode chunk (DECODE_CHUNK greedy T = 1 forwards) after it."""
    import torch

    from raglite_tpu_torch.models.decoder import DECODE_CHUNK, _decode_chunk_device, _prefill_last

    model, params = llm.model, llm.params
    cache = model.init_cache(1, rag_s, device="cuda")
    state = {}

    def prefill():
        state["last"], _ = _prefill_last(model, params, ids, cache, lens)

    def chunk():
        _decode_chunk_device(
            model, cache, params, lens.clone(), state["last"],
            torch.zeros(llm.cfg["vocab"], device="cuda"), torch.zeros(1, dtype=torch.bool, device="cuda"),
            llm._stop_ids_device(), torch.Generator(device="cuda").manual_seed(0),
            num_steps=DECODE_CHUNK, temperature=0.0, top_p=1.0, top_k=0, min_p=0.0,
        )

    prefill()
    chunk()
    _profile_window(prefill, f"prefill of {int(lens[0])} tokens (T = {ids.shape[1]})", card)
    _profile_window(chunk, f"one plain decode chunk ({DECODE_CHUNK} forwards at S = {rag_s})", card)


def serve_rag(cfg, question: str, card: str, *, profile: bool = False) -> dict:
    """Phase 6: rag() answers from the ``large`` decoder over the phase-3
    index; a sampled stream; greedy with speculation off against on."""
    import dataclasses
    import os

    import torch

    from raglite_tpu_torch import add_context, rag, retrieve_context
    from raglite_tpu_torch.models.decoder import DECODE_CHUNK, _bucket
    from raglite_tpu_torch.models.llm import llm_from_config
    from raglite_tpu_torch.rag import _clip

    rag_cfg = dataclasses.replace(cfg, llm="jax:large")
    t0 = time.perf_counter()
    llm = llm_from_config(rag_cfg)  # seeded init of the 8 GB preset, on the card
    torch.cuda.synchronize()
    layers = llm.cfg["layers"]
    weight_bytes = sum(
        x.numel() * x.element_size()
        for x in [*(v for k, v in llm.params.items() if k != "layers"),
                  *(v for layer in llm.params["layers"] for v in layer.values())]
    )
    log(f"llm jax:large ({layers} layers, d {llm.cfg['d_model']}, vocab {llm.cfg['vocab']}): "
        f"{weight_bytes / 1e9:.3f} GB of bf16 weights, seeded init {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    spans = retrieve_context(question, config=rag_cfg)
    messages = [add_context(question, spans, rag_cfg)]
    retrieve_ms = (time.perf_counter() - t0) * 1e3
    prompt = llm._format_messages(_clip(messages, llm.context_size), None)
    max_new = 128
    prompt_tokens = min(len(llm.tokenizer.encode(prompt)), llm.context_size - max_new - 1) + 1
    rag_s = _bucket(prompt_tokens) + _bucket(max_new) + DECODE_CHUNK
    log(f"rag question {question!r}: {len(spans)} spans retrieved in {retrieve_ms:.1f} ms, "
        f"prompt {prompt_tokens} tokens, KV length S = {rag_s}")

    # The answer stream through the user entry point.
    _reset_attention_launches()
    pieces, first_piece_ms, rag_ms = _timed_tokens(rag(messages, config=rag_cfg))
    launches_rag = _attention_launches()
    stats = dict(llm.spec_stats)
    answer = "".join(pieces)
    assert messages[-1] == {"role": "assistant", "content": answer}
    assert stats["tokens"] > 0 and answer, stats
    # Every attention call of the answer went through a kernel: one prefill
    # forward and one verify forward per speculative iteration, each layer.
    assert launches_rag["gqa_prefill_attention"] == layers, launches_rag
    assert launches_rag["gqa_verify_attention"] == layers * stats["verify_iters"], (launches_rag, stats)
    assert launches_rag["gqa_decode_attention"] == 0, launches_rag
    log(f"rag() answer: {stats['tokens']} tokens in {rag_ms:.1f} ms (first piece after "
        f"{first_piece_ms:.1f} ms), {stats['tokens'] / stats['verify_iters']:.3f} tokens per verify "
        f"forward ({stats['verify_iters']} forwards), launches {launches_rag}, on {card}")

    # Token-level timing of the same greedy generation: time to the first
    # token (the prefill, then the first chunk's one fetch) and decode rate.
    greedy, ttft_ms, greedy_ms = _timed_tokens(llm._generate_tokens(prompt, max_new_tokens=max_new))
    spec_stats = dict(llm.spec_stats)

    # A sampled stream (RECOMMENDED_SAMPLING) through TorchChatLLM.stream:
    # the plain chunk loop, T = 1, a fixed DECODE_CHUNK forwards per chunk.
    _reset_attention_launches()
    sampled_text = "".join(llm.stream(messages[:1], **llm.RECOMMENDED_SAMPLING))
    launches_sampled = _attention_launches()
    assert sampled_text and launches_sampled["gqa_decode_attention"] > 0, launches_sampled
    assert launches_sampled["gqa_decode_attention"] % (layers * DECODE_CHUNK) == 0, launches_sampled
    assert launches_sampled["gqa_verify_attention"] == 0 and launches_sampled["gqa_prefill_attention"] == layers
    forwards = launches_sampled["gqa_decode_attention"] // layers
    sampled, _, sampled_ms = _timed_tokens(
        llm._generate_tokens(prompt, max_new_tokens=max_new, **llm.RECOMMENDED_SAMPLING)
    )
    log(f"sampled stream (temperature 0.7, top_k 20, top_p 0.8): {forwards} decode forwards, "
        f"launches {launches_sampled}; timed again: {len(sampled)} tokens in {sampled_ms:.1f} ms")

    # Greedy with speculation off against on, same prompt.
    os.environ["RAGLITE_TPU_SPECULATE"] = "0"
    try:
        plain, _, plain_ms = _timed_tokens(llm._generate_tokens(prompt, max_new_tokens=max_new))
    finally:
        del os.environ["RAGLITE_TPU_SPECULATE"]
    common = next((i for i, (a, b) in enumerate(zip(plain, greedy)) if a != b), min(len(plain), len(greedy)))
    log(f"greedy speculation on vs off: common prefix {common} of {len(plain)} tokens "
        f"(share {common / max(len(plain), 1):.4f}); speculative {greedy_ms:.1f} ms, plain {plain_ms:.1f} ms")

    # Whole-model prefill and one decode step at the answer's shapes.
    ids = torch.full((1, _bucket(prompt_tokens)), llm.tokenizer.PAD, dtype=torch.int64, device="cuda")
    ids[0, :prompt_tokens] = 3
    lens = torch.tensor([prompt_tokens], device="cuda")
    model, params = llm.model, llm.params

    def prefill():
        cache = model.init_cache(1, rag_s, device="cuda")
        return model.forward(params, ids, cache, 0, last_positions=lens - 1)

    cache = model.init_cache(1, rag_s, device="cuda")
    tok1 = torch.full((1, 1), 3, dtype=torch.int64, device="cuda")
    prefill_ms = median_ms(prefill, reps=3, inner=1, warmup=1)
    step_ms = median_ms(lambda: model.forward(params, tok1, cache, lens), reps=5, inner=3, warmup=1)
    log(f"large preset on {card}: prefill of {prompt_tokens} tokens (T = {ids.shape[1]}) {prefill_ms:.2f} ms; "
        f"one decode forward at S = {rag_s} {step_ms:.3f} ms (weights alone: {weight_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s)")
    if profile:
        profile_decode(llm, ids, lens, rag_s, card)
    decode_tps = len(greedy) / max((greedy_ms - prefill_ms) / 1e3, 1e-9)
    log(f"rag answer metrics on {card}: prompt {prompt_tokens} tokens, time to first token {ttft_ms:.1f} ms "
        f"(prefill, then the first {DECODE_CHUNK}-token chunk), decode {decode_tps:.2f} tokens/s greedy speculative "
        f"({len(greedy)} tokens in {greedy_ms:.1f} ms), {len(plain) / max((plain_ms - prefill_ms) / 1e3, 1e-9):.2f} "
        f"tokens/s plain greedy, {len(sampled) / max((sampled_ms - prefill_ms) / 1e3, 1e-9):.2f} tokens/s sampled; "
        f"spec stats {spec_stats}")
    log(f"launches per decoded token: decode {layers * forwards / len(sampled):.3f} "
        f"(sampled, {DECODE_CHUNK}-step chunks: {forwards} forwards for {len(sampled)} tokens), verify {launches_rag['gqa_verify_attention'] / stats['tokens']:.3f} "
        f"(rag greedy); prefill {launches_rag['gqa_prefill_attention']} per prefill")
    return {
        "rag_s": rag_s, "rag_pos": prompt_tokens, "rag_t": ids.shape[1],
        "launches": {
            "gqa_prefill_attention": launches_rag["gqa_prefill_attention"],
            "gqa_verify_attention": launches_rag["gqa_verify_attention"],
            "gqa_decode_attention": launches_sampled["gqa_decode_attention"],
        },
    }


def pick_queries(texts: list[str], count: int, seed: int) -> list[str]:
    """``count`` distinct sentences (40-240 characters, ending in a full
    stop, question or exclamation mark) from the documents, each of at most
    RESIDENT_MAX_TERMS unique words (a longer query leaves the fused hybrid
    route for host RRF by design; phase 4b sends one)."""
    import numpy as np

    from raglite_tpu_torch.index.keyword import KeywordIndex, tokenize
    from raglite_tpu_torch.sentences import split_sentences

    pool = []
    for text in texts:
        for sentence in split_sentences(text):
            s = " ".join(sentence.split())
            if (
                40 <= len(s) <= 240
                and not s.startswith(("#", "|", "`", "-"))
                and s.endswith((".", "?", "!"))
                and len(set(tokenize(s))) <= KeywordIndex.RESIDENT_MAX_TERMS
            ):
                pool.append(s)
    pool = sorted(set(pool))
    rng = np.random.default_rng(seed)
    return [pool[i] for i in rng.choice(len(pool), size=count, replace=False)]


#: bench.py's hybrid section: a 30,000-term vocabulary, bodies of 12
#: zipf(1.3) terms, queries of 4 terms from the informative tail (rank >= 200).
VOCAB = 30_000


def add_background(
    store, rows_needed: int, seed: int, *, rows_per_chunk: int = 2, device: str = "cuda"
) -> set[str]:
    """Seeded background chunks (unit-vector rows made on ``device`` in bulk,
    ``rows_per_chunk`` to a chunk; bodies of 12 zipf(1.3) terms, as bench.py
    builds its keyword corpus), added through Store.add_chunks; returns
    their ids."""
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
    terms = np.random.default_rng(seed).zipf(1.3, size=(n_chunks, 12)).astype(np.int64) % VOCAB
    chunks, mats = [], []
    for i in range(n_chunks):
        body = " ".join(f"w{t}" for t in terms[i]) + "\n"
        chunks.append(Chunk(id=f"bg-{i}", document_id=doc.id, index=i, headings="", body=body))
        mats.append(vecs[bounds[i] : bounds[i + 1]])
    store.add_chunks(chunks, mats)
    return {c.id for c in chunks}


def tail_queries(count: int, seed: int) -> list[str]:
    """bench.py's keyword queries: 4 terms from the informative tail (rank
    >= 200) of the background's vocabulary."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    return [
        " ".join(f"w{200 + (t % (VOCAB - 200))}" for t in rng.zipf(1.3, size=4).astype(np.int64))
        for _ in range(count)
    ]


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


def _p50_ms(fn, items) -> float:
    """Median host-clock time of ``fn(item)`` over ``items``, each call
    ended by a device synchronize."""
    import torch

    times = []
    for item in items:
        t0 = time.perf_counter()
        fn(item)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def keyword_and_hybrid(cfg, queries: list[str], rerank_queries: list[str], background: set[str], seed: int, card: str, *, profile: bool = False) -> dict:
    """Phase 4b: keyword and hybrid search over the phase-3 store through
    the user entry points, checked at scale, then timed.  Returns the
    numbers of the summary."""
    import numpy as np
    import torch

    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.index.dense import fetch_scored
    from raglite_tpu_torch.index.keyword import keyword_index_from_config
    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.ops.rrf import rrf_fuse_topk
    from raglite_tpu_torch.search import (
        corrected_num_hits,
        hybrid_search,
        hybrid_search_batch,
        keyword_search,
        keyword_search_batch,
        reciprocal_rank_fusion,
        search_and_rerank_chunk_spans,
    )

    # 1. Build: postings over the whole store, then the resident arrays.
    dense = dense_index_from_config(cfg)
    t0 = time.perf_counter()
    kw = keyword_index_from_config(cfg)
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert kw.resident_prepare(["w1"]) is not None
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    assert kw.backend == "native", kw.backend
    n = len(kw.chunk_ids)
    assert n == len(dense.chunk_ids), (n, len(dense.chunk_ids))
    postings = kw._native.num_postings
    resident_postings = int(kw._res["df_host"].sum())
    resident_bytes = sum(kw._res[k].numel() * kw._res[k].element_size() for k in ("offsets", "chunk", "w"))
    log(f"keyword index on {card}: {n} chunks, postings backend {kw.backend}, {postings} postings "
        f"({resident_postings} resident, {len(kw._res['df_host'])} terms, lcap {kw._res['lcap']}); sync {sync_s:.3f} s, "
        f"resident build and upload {resident_s:.3f} s, {resident_bytes} bytes of resident postings on the card")

    # 2. The user path: hybrid (the fused route, the int4 kernel on its dense
    # side), keyword, and spans with the default search.
    fs.reset_launch_counts()
    for query in queries:
        ids, _ = hybrid_search(query, num_results=10, config=cfg)
        assert kw.last_route == "hybrid_fused" and dense.last_route == "int4_two_stage", (kw.last_route, dense.last_route)
        assert len(ids) == 10 and ids[0] not in background, f"top hybrid hit of {query!r} is a background chunk"
        ids, _ = keyword_search(query, num_results=10, config=cfg)
        assert kw.last_route == "resident", kw.last_route
        assert ids and ids[0] not in background, f"top keyword hit of {query!r} is a background chunk"
    for query in rerank_queries:
        spans = search_and_rerank_chunk_spans(query, num_results=4, config=cfg)
        assert kw.last_route == "hybrid_fused" and dense.last_route == "int4_two_stage", (kw.last_route, dense.last_route)
        assert spans and all(c.id not in background for c in spans[0].chunks), query
    launches = dict(fs.launch_counts)
    assert launches["int4_bucket_scan"] == len(queries) + len(rerank_queries), launches
    log(f"hybrid path: {len(queries)} hybrid_search, {len(queries)} keyword_search and {len(rerank_queries)} "
        f"search_and_rerank_chunk_spans calls (default search) through the fused route, int4 route on the dense "
        f"side, document chunks on top; launches {launches}")
    # A query of more unique terms than the resident postings take: host RRF
    # over the two searches, still a document chunk on top.
    wide = " ".join([*queries, *rerank_queries])
    ids, _ = hybrid_search(wide, num_results=10, config=cfg)
    assert kw.last_route == "host_gather" and ids and ids[0] not in background, (kw.last_route, ids[:1])
    log(f"a {len(wide.split())}-word query: host RRF fallback (keyword side {kw.last_route}), document chunk on top")

    # 3. Correctness at scale: 256 tail-term queries.
    tail = tail_queries(256, seed)
    term_ids = kw.resident_prepare(tail)
    assert term_ids is not None
    full_df = np.diff(kw._native_csr()["offsets"])
    max_df = int(full_df[term_ids[term_ids >= 0]].max())
    assert max_df < kw.RESIDENT_LCAP, max_df  # no truncation enters
    k_side, num_results = 20, 10
    resident = kw.search_batch(tail, num_hits=k_side)
    assert kw.last_route == "resident"
    kw.use_resident = False
    try:
        host = kw.search_batch(tail, num_hits=k_side)
        assert kw.last_route == "host_gather"
    finally:
        kw.use_resident = True
    bit_equal = True
    for (r_ids, r_scores), (h_ids, h_scores) in zip(resident, host, strict=True):
        assert r_ids == h_ids
        np.testing.assert_allclose(r_scores, h_scores, rtol=1e-4)
        bit_equal &= r_scores == h_scores
    hits = sum(len(ids) for ids, _ in resident)
    log(f"resident BM25 = host gather on 256 tail-term queries: ids equal ({hits} hits, max df of their terms "
        f"{max_df}), scores within rtol 1e-4 (bit-equal: {bit_equal})")
    # The device RRF on 32 queries: the 12 sentences, whose two sides share
    # document chunks, and 20 tail-term queries.
    mixed = [*queries, *rerank_queries, *tail][:32]
    emb = embed_queries(mixed, config=cfg).astype(np.float32)
    num_hits = min(corrected_num_hits(4, k_side, cfg), dense.num_rows)
    mask, masked = kw.resident_device_mask(None)
    dense_side = dense.search_chunks_device(emb, num_hits=num_hits, num_results=k_side)
    assert dense.last_route == "int4_two_stage"
    kw_side = kw.resident_block_device(kw.resident_prepare(mixed), num_hits=k_side, mask=mask, masked=masked)
    fused_scores, fused_ords = fetch_scored(*rrf_fuse_topk(dense_side, kw_side, num_chunks=n, num_results=num_results))
    d_scores, d_ords = fetch_scored(*dense_side)
    k_scores, k_ords = fetch_scored(*kw_side)
    mismatches, overlap = 0, 0
    for i in range(32):
        v_ids = [kw.chunk_ids[o] for o in d_ords[i] if o >= 0]
        order = np.lexsort((k_ords[i], -k_scores[i]))
        k_ids = [kw.chunk_ids[k_ords[i][j]] for j in order if k_scores[i][j] > 0 and k_ords[i][j] < n]
        want, want_scores = reciprocal_rank_fusion([v_ids, k_ids], weights=[0.75, 0.25])
        got = [kw.chunk_ids[o] for o in fused_ords[i] if o >= 0]
        mismatches += got != want[:num_results]
        overlap += len(set(v_ids) & set(k_ids))
        np.testing.assert_allclose(fused_scores[i][: len(got)], want_scores[: len(got)], rtol=1e-6)
    log(f"device RRF vs reciprocal_rank_fusion over the same per-side lists of 32 queries (12 sentences, 20 "
        f"tail-term): {mismatches} mismatches ({overlap} chunks on both sides)")
    assert mismatches == 0

    # 4. Timing.
    for query in tail[:4]:
        hybrid_search(query, num_results=10, config=cfg)
        keyword_search(query, num_results=10, config=cfg)
    out = {
        "keyword_p50_ms": _p50_ms(lambda q: keyword_search(q, num_results=10, config=cfg), tail[:32]),
        "hybrid_p50_ms": _p50_ms(lambda q: hybrid_search(q, num_results=10, config=cfg), tail[:32]),
        "keyword_p50_ms_sentences": _p50_ms(lambda q: keyword_search(q, num_results=10, config=cfg), queries),
        "hybrid_p50_ms_sentences": _p50_ms(lambda q: hybrid_search(q, num_results=10, config=cfg), queries),
    }
    log(f"keyword_search p50 {out['keyword_p50_ms']:.3f} ms, hybrid_search p50 {out['hybrid_p50_ms']:.3f} ms over 32 "
        f"tail-term queries; {out['keyword_p50_ms_sentences']:.3f} and {out['hybrid_p50_ms_sentences']:.3f} ms over the "
        f"8 sentences (B = 1, host clock, embed included) on {card}")
    # hybrid_search's layers apart, each ended by a synchronize.
    stages = {"encode": [], "dense side": [], "BM25 side": [], "RRF and fetch": []}
    hits1 = min(corrected_num_hits(4, k_side, cfg), dense.num_rows)
    for query in [*queries, *tail[:32]]:
        t0 = time.perf_counter()
        q_emb = embed_queries([query], config=cfg).astype(np.float32)
        t1 = time.perf_counter()
        d_side = dense.search_chunks_device(q_emb, num_hits=hits1, num_results=k_side)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k_side_dev = kw.resident_block_device(kw.resident_prepare([query]), num_hits=k_side, mask=mask, masked=False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fetch_scored(*rrf_fuse_topk(d_side, k_side_dev, num_chunks=n, num_results=num_results))
        t4 = time.perf_counter()
        for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[name].append(dt * 1e3)
    out["split_ms"] = {k: statistics.median(v) for k, v in stages.items()}
    log(f"hybrid_search split p50 over 40 queries (ms, host clock, each stage synchronized) on {card}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["split_ms"].items()))
    # Batch throughput.
    for name, fn, batch in (
        ("keyword_search_batch", keyword_search_batch, 256),
        ("hybrid_search_batch", hybrid_search_batch, 256),
        ("hybrid_search_batch", hybrid_search_batch, 32),
    ):
        fn(tail[:batch], num_results=10, config=cfg)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(tail[:batch], num_results=10, config=cfg)
            times.append(time.perf_counter() - t0)
        out[f"{name}_qps_b{batch}"] = batch / statistics.median(times)
        route = f"; dense side {dense.last_route}" if name.startswith("hybrid") else ""
        log(f"{name} B = {batch} tail-term queries: {batch / statistics.median(times):.1f} queries/s (median of 5, "
            f"{statistics.median(times) * 1e3:.2f} ms a call{route}) on {card}")
    # Each torch-op program's time per call (CUDA events), beside its bytes.
    programs = []
    for batch in (1, 256):
        block = term_ids[:batch]
        valid = block[block >= 0]
        lcap_b = 128
        while lcap_b < int(kw._res["df_host"][valid].max()):
            lcap_b *= 2
        read = int(np.minimum(kw._res["df_host"][valid], lcap_b).sum())
        moved = block.size * 4 + valid.size * 16 + read * 8 + batch * k_side * 12
        ms = median_ms(lambda: kw.resident_block_device(block, num_hits=k_side, mask=mask, masked=False))
        programs.append({"name": "bm25_topk_resident", "batch": batch, "ms": ms, "bytes": moved,
                         "bound_ms": moved / PEAK_BYTES_PER_S * 1e3, "postings": read, "lcap": lcap_b})
    for batch in (1, 32):
        d_b = tuple(x[:batch] for x in dense_side)
        k_b = tuple(x[:batch] for x in kw_side)
        moved = batch * 2 * k_side * 12 + batch * num_results * 12
        ms = median_ms(lambda: rrf_fuse_topk(d_b, k_b, num_chunks=n, num_results=num_results))
        programs.append({"name": "rrf_fuse_topk", "batch": batch, "ms": ms, "bytes": moved,
                         "bound_ms": moved / PEAK_BYTES_PER_S * 1e3})
    for p in programs:
        log(f"timing {p['name']} (torch ops) B={p['batch']} on {card}: {p['ms']:.4f} ms a call (CUDA events, calls "
            f"enqueued back to back), {p['bytes']} bytes, bound {p['bound_ms']:.6f} ms (bytes)"
            + (f", {p['postings']} postings read, lcap {p['lcap']}" if "postings" in p else ""))
    out["programs"] = programs
    if profile:
        ops = _profile_window(
            lambda: [hybrid_search(q, num_results=10, config=cfg) for q in queries], f"{len(queries)} hybrid_search calls", card
        )
        log(f"device operations per hybrid_search call: {ops / len(queries):.1f} on {card}")
    return out


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
    vector_search (warm)."""
    from raglite_tpu_torch.search import vector_search

    for query in queries[:2]:
        vector_search(query, num_results=10, config=cfg)
    _profile_window(
        lambda: [vector_search(query, num_results=10, config=cfg) for query in queries],
        f"{len(queries)} vector_search calls", card,
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=1_249_280)
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace 8 warm vector_search calls of each route, 8 hybrid_search calls, the large preset's "
        "prefill, one decode chunk and 36 decode, verify and prefill attention calls with "
        "torch.profiler, and print the phases inside one decode, one verify and one prefill launch",
    )
    parser.add_argument(
        "--only", choices=["prefill"],
        help="a partial run for work on one kernel: build it, hold it against its plain version "
        "(phase 2b's cases) and time it (phase 7's rows, at T 8,192 / S 8,352 and T 2,048 / S 2,208); "
        "prints no result line",
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

    if args.only == "prefill":
        check_attention_kernels(args.seed, prefill_only=True)
        time_attention(args.seed, 8352, 8064, 8192, card, profile=args.profile, only="gqa_prefill_attention")
        log("partial run (--only prefill): no result line")
        return 0

    # 2. Kernels vs plain versions.
    errs = check_kernels(args.seed)
    # 2b. Attention kernels vs plain versions; verify rows vs decode.
    errs.update(check_attention_kernels(args.seed))

    # 3. Serve, default config (int4 two-stage route).
    texts = [(ROOT / f).read_text(encoding="utf-8") for f in ("README.md", "SURVEY.md", "MIGRATION.md", "PARITY.md")]
    cfg = RAGLiteConfig(store_path=":memory:", device="cuda")
    assert cfg.embedder == "flax:sem" and cfg.embedding_dtype == "bfloat16" and cfg.use_int4_stage1
    t0 = time.perf_counter()
    insert_documents([Document.from_text(t) for t in texts], config=cfg)
    store = store_from_config(cfg)
    doc_rows = sum(m.shape[0] for m in store.embeddings.values())
    log(f"inserted 4 documents: {len(store.chunk_order)} chunks, {doc_rows} rows in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    background = add_background(store, args.rows - doc_rows, args.seed)
    log(f"added {len(background)} background chunks ({args.rows - doc_rows} rows) in {time.perf_counter() - t0:.1f} s")
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

    # 4b. Keyword and hybrid search, default config.
    hybrid = keyword_and_hybrid(cfg, vs_q, rr_q, background, args.seed, card, profile=args.profile)
    log(f"phase 4b summary on {card}: {json.dumps(hybrid)}")

    # 5. Timings at the served index's arrays.
    from raglite_tpu_torch.embed import embed_queries

    q_emb = embed_queries((vs_q + bench_q)[:32], config=cfg)
    timings = time_kernels(index_bf16, dense_index_from_config(cfg8), q_emb, card)
    n_queries = len(vs_q) + len(rr_q)
    launches = {"int4_bucket_scan": launches_default["int4_bucket_scan"], "bucketed_max_scan": launches_single["bucketed_max_scan"]}
    log(f"launches per query: { {k: v / n_queries for k, v in launches.items()} }")

    # 6. RAG answers from the `large` decoder over the phase-3 index.
    answer = serve_rag(cfg, vs_q[0], card, profile=args.profile)
    launches.update(answer["launches"])

    # 7. Attention kernel timings at the `large` shapes.
    timings += time_attention(args.seed, answer["rag_s"], answer["rag_pos"], answer["rag_t"], card, profile=args.profile)
    replaces = {
        "int4_bucket_scan": ("raglite_tpu_torch/csrc/int4_scan.cu", "raglite_tpu/ops/fused_scan.py:269"),
        "bucketed_max_scan": ("raglite_tpu_torch/csrc/bucket_scan.cu", "raglite_tpu/ops/fused_scan.py:65"),
        "gqa_decode_attention": ("raglite_tpu_torch/csrc/decode_attention.cu", "raglite_tpu/ops/decode_attention.py:37"),
        "gqa_verify_attention": ("raglite_tpu_torch/csrc/decode_attention.cu", "raglite_tpu/ops/decode_attention.py:140"),
        "gqa_prefill_attention": ("raglite_tpu_torch/csrc/prefill_attention.cu", "raglite_tpu/ops/prefill_attention.py:71"),
    }
    kernels = []
    for name, (source, replaced) in replaces.items():
        # The scans at B = 1; each attention kernel at its first phase-7
        # shape, the RAG answer's own.
        t = next(t for t in timings if t["name"] == name and t.get("batch", 1) == 1)
        err = max(errs[name], *(x["max_abs_err"] for x in timings if x["name"] == name))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaced,
            "launches": launches[name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            # Beside the contract's keys: decode and verify replayed from a CUDA
            # graph (their "ms" reads the host's enqueue time), else null.
            "graph_ms": t.get("graph_ms"),
        })
    log(f"kernels: {json.dumps([k['name'] for k in kernels])} (scans at B=1, N={index_bf16.capacity}, "
        f"d={D}; decode and verify at S={answer['rag_s']}, prefill at T={answer['rag_t']}, S={answer['rag_s']})")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
