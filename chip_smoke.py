#!/usr/bin/env python3
"""Drive the PyTorch port's retrieval, answer, structured-generation, eval,
query-adapter, checkpoint, ingestion-to-surface, multi-GPU, IR-benchmark,
CUDA-graph decode, CUDA-graph retrieval, training and held-out evaluation
paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--rows 1249280] [--profile]
        [--only prefill|phase10|phase11|phase12|phase13|phase14|phase15|phase16|phase17|phase18]

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
   own T = 8192 at S = 8352); at B = 8 (complete_batch's batch) decode,
   verify at T = 8 and prefill at T = 64, at (4, 5, 128) and (2, 4, 32), the
   8 rows at 8 different first positions (0 and S - T among them); each
   output within attention_tolerance (the smaller of a sound and a
   statistical bound on bf16 probability rounding).
3. Serve with the default config (packaged 8-layer d=768 encoder, bf16
   rows, ":memory:" store): insert the repo's VERDICT, SURVEY, MIGRATION and
   PARITY documents, add seeded background chunks of 2 unit-vector rows each
   until the index holds ``--rows`` rows,
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
   B = 32), and each torch-op program's time per call (CUDA events) from
   its CUDA graph and eagerly, beside its bytes bound; ``--profile`` counts
   the device operations of one hybrid_search call.  BM25 and RRF run
   from their CUDA graphs here (phase 16 holds them to eager).
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
8. Structured generation on the same `large` decoder (phase 6's object): (a)
   a schema-constrained complete (an object with a string, an enum and an
   anyOf [integer, null] field; 96 new tokens at most) that must parse and
   pass a fresh SchemaAutomaton; (b) a forced tool call (two tools,
   tool_choice "required") whose arguments must pass their tool's schema;
   (c) complete_batch of 8 conversations (expand_document_metadata's system
   prompt over 8 of the repo's documents clipped to 256-4,096 bytes, ragged)
   at 64 new tokens, greedy (speculative) and under the metadata schema,
   asserting every constrained row parses, conforms and keeps its budget and
   that one [8, T] prefill, batched verify and [8, 1] decode launches served
   them; the common-prefix share of each greedy row against a B = 1
   complete; each attention kernel timed at the batch's shapes as in phase
   7; (d) ``hash:1024`` on the card over the phase-3 documents: token
   embeddings, pooled from CUDA graphs (asserted), against the f64 plain
   pool over the same bf16 table (asserted within HASH_ATOL), vector_search and hybrid_search p50, and the top-10
   overlap with the CPU port on the phase-3 sentences.  (d) runs after
   phase 9: its fresh ":memory:" stores replace the phase-3 store.
9. Evals, the query adapter and async and remote RAG, on the phase-3 store
   and phase 6's decoder object: (a) insert_evals (PHASE9_EVALS evals, 20
   chunks at most each, 4 threads, the echo LLM), every search on the int4
   route (one int4 launch each, asserted), every failed eval a ValueError,
   and each threaded search equal to the same search made alone; (b)
   update_query_adapter at d = 768 (its time split, peak memory; A
   orthogonal within 1e-3; the first NNLS batch on the card, from its CUDA
   graph, equal to the same op on the CPU within 1e-4; the op timed from
   its graph and eagerly against its bound and D's reads); (c)
   vector_search with the stored adapter (int4 route, p50, recall@10 >=
   RECALL_MIN against the exact route with the same adapter), then the
   adapter removed and the plain ids asserted as before; (d) answer_evals
   and evaluate(judge=True) through their column functions on PHASE9_JUDGED
   evals with the `large` decoder (complete_batch calls with their B and T,
   each judge panel asserted one batched call, peak memory); (e) async_rag
   on the `large` decoder (the worker-thread bridge) equal to rag()'s
   greedy answer, an early exit after PHASE9_EARLY_EXIT pieces after which
   no kernel is launched and rag() answers the same; every kernel of the
   path counted over (a)-(e) and asserted launched; (f), last, openai: on
   loopback stubs (no network): a remote-embedder store with its index on
   the card, and async_rag with ``llm="openai:..."`` and a tool round on
   the native path.
10. Real checkpoints (after phase 9; phase 6's `large` released first): (a)
   a Qwen3-4B-shaped BF16 checkpoint (the published config, seeded
   weights, 3 shards, 8.05 GB) and a hand-made Qwen-style tokenizer.json
   (PHASE10_MERGES merges learned from the repo's Markdown) written with the
   port's own writer to the temporary directory or /dev/shm; (b) loaded
   through ``llm="jax:hf:<dir>"`` (load time, peak), a 2,048-token forward
   with the attention kernels against the same forward with their plain
   versions (PHASE10_TOP1_MIN, PHASE10_LOGIT_ATOL); (c) ``rag()`` with phase
   6's message and serve_rag's timings (the three attention kernels at
   KVH 8, REP 4), the host's encode time, the BPE branches (a response
   format and a forced tool call through the prompt, extract_json), each
   attention kernel timed at these shapes as in phase 7; (d) the same
   checkpoint ``@int8`` (load, peak, top-1 against (b), serve_rag) and
   W8A8 / W8A16 / bf16 at its matmul shapes; (e) a bge-m3-shaped BF16
   XLM-R encoder and a hand-made Unigram tokenizer.json served as
   ``embedder="flax:<dir>"``: the phase-3 documents and seeded background
   rows up to 1,249,280 at d = 1,024 in a fresh store (phase 3's is
   replaced), vector_search on the int4 route against the exact route
   (recall@10 by ids, and counting chunks tied with the exact 10th within
   TIE_ATOL as hits: >= RECALL_MIN asserted on the latter), rerank_chunks
   and search_and_rerank_chunk_spans p50, the int4 scan timed at d = 1,024;
   (f) ``ckpt:`` with no tensorstore, orbax or zstandard (the port's OCDBT,
   zarr and native zstd): (e)'s encoder saved and read back as
   ``flax:ckpt:<dir>`` (query embeddings equal bit for bit, 8 vector_searches
   over (e)'s store through it with the in-memory encoder's ids, int4
   launches counted); phase 6's seeded `large` (8.068 GB) saved with the
   port's writer and read back as ``jax:ckpt:<dir>`` (save and load s,
   GB/s; every leaf and a 2,048-token forward's logits equal bit for bit),
   its rag() answer to phase 6's message equal to phase 6's (prefill and
   verify launches counted), ``@int8`` logits equal to the in-memory model
   quantized alike; the JAX package's orbax fixture (compressed frames)
   read on the card and the CPU (leaves equal, f32 logits within
   FIXTURE_LOGIT_TOL) and the native decoder's MB/s on one host thread;
   (e)'s encoder once more as orbax's zarr v3 layout
   (write_zarr3_checkpoint: sharding_indexed, zstd, a crc32c index, in
   OCDBT) read as ``flax:ckpt:<dir>`` (weights and query embeddings equal
   to the zarr v2 load bit for bit, the same ids, one int4 launch a query;
   read s and GB/s beside zarr v2's); every layout fixture
   (tests/data/orbax_layouts: zarr v3 sharded and Blosc, zarr v2 Blosc,
   gzip, zlib, bz2, big-endian and F order, numbered OCDBT manifests) read
   on the card and the CPU (every leaf equal) and each codec's host decode
   MB/s on one thread.
11. From files to answers through the surfaces (after phase 10 and the
   stores of 8 (d) and 9 (f); a store of its own in a temporary directory):
   (a) a PDF (pages, Flate streams, a Type1 body font, a Type0 heading font
   with a ToUnicode CMap), DOCX, PPTX, ODT, EPUB, RTF, HTML and CSV written
   from consecutive parts of the four documents' text, each converted with
   document_to_markdown (host ms) and shown to hold its headings and a
   sentence of its source; (b) the learned boundary model on the card
   (its blocks from CUDA graphs, asserted) against its CPU version on those documents and a held-out multilingual
   corpus (BOUNDARY_ATOL, sentences equal), its boundary-F1 against the
   heuristic's and its ms per 100,000 characters; (c) a persistent store
   (``sentence_boundary_model="learned"``, the default encoder, bf16 rows):
   the PDF inserted through ``python -m raglite_tpu_torch insert`` in a
   fresh process, the rest through insert_documents, background rows up to
   ``--rows``, store.save() and DenseIndex.save() (times, bytes on disk);
   (d) ``search --method vector`` and ``stats`` in fresh processes (time to
   the first result; ids = this process's vector_search) and
   DenseIndex.load (ids equal); (e) create_web_app on 127.0.0.1: 64
   concurrent POST /api/search after a warm-up, each thread connected
   before all are released (p50, p99, the micro-batches, at most 8
   asserted, every answer = vector_search),
   a PDF upload, a streamed /api/chat answer from ``jax:large`` (first
   token, pieces a second, attention launches asserted), the phases of
   GET /api/stats; (f) ``mcp run`` in a fresh process over pipes
   (initialize, tools/list, tools/call; its top document =
   retrieve_context's); (g) trace_session around four searches (the
   search.* ranges and int4 kernel events in the Chrome trace).
12. Multi-GPU on the one card (after phase 9, before phase 10 releases
   phase 6's decoder and replaces the phase-3 store; one card cannot show
   traffic between cards or a speed-up from more of them): (a) the phase-3
   store served with ``num_devices=4`` (4 row shards of 315,392 rows on
   cuda:0), every vector_search on the sharded int4 route with 4 int4
   launches (asserted), recall@10 against the single-device exact route
   (counting chunks within PHASE12_TIE_ATOL of the exact 10th as hits, >=
   RECALL_MIN), the sharded exact route at B = 64 with ids equal to the
   single-device exact route, one shard's int4 scan bit-exact against its
   plain version and timed at its shape, p50s beside ``num_devices=1``; (b)
   the keyword postings in 4 chunk-range shards: 256 tail-term queries equal
   to resident single-device BM25, ids and scores bit for bit; (c) phase 6's
   `large` split tensor-parallel over 4 shards (in place, so the LLM factory
   serves the TP model; the single-device weights kept beside it): a
   2,048-token forward against the single-device one (top-1 >=
   PHASE12_TOP1_MIN; the largest difference printed beside
   PHASE12_LOGIT_RTOL of the largest |logit|; against an f32 forward of the
   same weights, TP's largest error within PHASE12_ERROR_RATIO of one
   device's), a rag() answer and a
   sampled stream with the prefill, verify and decode launches asserted per
   shard, time to first token and tokens/s beside the single-device model,
   each attention kernel held against its plain version and timed at the
   shard's KVH 1, REP 5 (phase 7's cases); then both copies are released;
   (d) two processes (this script with ``--phase12-rank``), each holding 2 of
   4 seeded shards of 315,392 x 768 on cuda:0, joined by a gloo group (NCCL
   refuses two ranks on one card), whose merged exact and int4 results equal
   this process's 4-shard search (ids equal, scores to f32 rounding); the
   exact route equal to one scan of the whole matrix; each rank has its own
   time limit.
13. The IR benchmark (after phase 11; a temporary directory of its own):
   (a) run_ir_benchmark on the synthetic dataset (16 documents and
   queries), all seven variants one by one, on the default config on the
   card and again on the CPU (fresh run caches; the CPU half in a process
   of its own beside the card half, (b) and (c)): keyword's AP@10 equal,
   every other within PHASE13_AP_ATOL, the hnsw row present; each
   variant's AP@10 and seconds; (b) a BERT-shaped BF16 encoder at
   BAAI/bge-base-en-v1.5's published widths (seeded weights) with a
   hand-made WordPiece tokenizer.json from the frozen Markdown, serving
   RAGLiteTPUEvaluators (multivector, hybrid and, on the first
   PHASE13_RERANK_QUERIES queries, rerank: one store) over a BEIR
   directory of the synthetic dataset, the store seeded with
   background rows up to ``--rows`` before their runs: one int4 launch a
   dense query (asserted), the multivector document runs' recall@10 against
   the exact route >= RECALL_MIN, a search's p50, AP@10, insert and seeding
   seconds, the encoder's tokens/s; then the same weights beside a second,
   truncating tokenizer.json (Nmt, Strip and BERT normalizers; WhitespaceSplit,
   Punctuation and Digits; truncation 512) as ``flax:<dir>`` over the same
   store: 8 vector_search calls (one int4 launch each, asserted), a
   token-level batch of the 8 longest documents (the Markdown ones
   included), each cut to the first 512 ids of the untruncated encode, and
   the 8 query embeddings on the card against the CPU's within
   PHASE13_AP_ATOL, each part timed; (c) hnsw_recall_comparison at 3,000 x
   256 (the scan on the card): recall and memory of the f16 and int8 scans
   and of HNSW, its build seconds and ms a query, the claim asserted; (d)
   ``bench --num-queries 16`` and ``bench --hnsw-recall --num-rows 1000``
   through the CLI in fresh processes, started as (c) starts and run
   beside it.
14. The decode programs as CUDA graphs (after phase 8, on phase 6's `large`
   object and RAG prompt; ``RAGLITE_TPU_SPECULATE`` set per run): (a) the
   decode step (B = 1, greedy), (b) the verify iteration (T = 8, one a
   chunk), (c) the one-token forward and (d) the batch step (B = 8, T =
   4,096), each first called (its eager warm-up and its capture) under
   ``torch.cuda.set_sync_debug_mode("error")``, then held to the module's
   eager function (``_decode_chunk_device``, ``speculate_chunk_device``,
   ``_forward_one``, ``_forward_step_batch``) step by step on a copy of the
   cache: tokens equal, logits bit for bit or within PHASE14_LOGIT_RTOL of
   the largest |logit|; capture ms, device ops a replay, launches counted
   through replays (as many as the eager steps'), the idle share of a decode
   chunk from the graph and eager, the sampled forms captured too, the
   kernels' ticket counters zero after; (e) through ``_generate_tokens``:
   plain greedy, greedy speculative and sampled streams of PHASE14_TOKENS
   from the graphs against the eager reference on the same prompt (greedy
   tokens equal; the sampled stream repeats under one seed and equals the
   eager one unless the step logits differed), tokens/s, time to first
   token, peak and held memory; (f) a schema-constrained answer (ms a
   token); (g) complete_batch of 8 at T = 4,096, greedy and under the
   metadata schema; (h) two threads answering at once, equal to the same
   calls one after the other.
15. The retrieval programs as CUDA graphs (after phase 12, before phase 10
   replaces the phase-3 store; ``utils/graphs.py:ProgramGraphs``): (a)
   every call of a program whose key is held (captured or replayed) is
   followed by one more replay and by the eager program on the same inputs
   (``eager_programs``), ids equal and scores within PHASE15_RTOL (0: bit
   for bit), their launches taken back out of the counts: over the phase-3
   store, 8 vector_searches and reranks of their top 20 and a
   vector_search_batch of 32 (the token, normalised-state, MaxSim and
   pooled programs of ``flax:sem``, the int4 route at B 1 and 32), the
   single-stage route (bf16 rows, the bucket scan kernel) and the dense
   route (the first 131,072 rows) at B 1 and 8 over views of the same
   device rows, the exact route over every row kept eager by the size rule
   (asserted); (b) the checking replays' int4 and bucket scan launches
   equal to the eager programs'; (c) a document inserted (found, a new
   generation and capture), deleted (gone) and an adapter set (a new
   generation), each search held as in (a); (d) PHASE15_THREADS threads of
   vector_search + rerank_chunks at once, equal to the same calls in turn,
   and 8 threads of vector_search racing an insert, each result equal to
   the same search before or after it; (e) from the graphs and eager in turns: the query encode, vector_search
   (B 1) and vector_search_batch (B 32) p50, rerank_chunks of a top 20 cold
   and warm at d 768 and, with phase 10 (e)'s bge-m3-shaped encoder, d
   1,024 (its programs held as in (a), token states at T >= 2,048 from a
   graph, a [8, T] rerank tile kept eager by the size rule, asserted), the
   idle share of one vector_search, device ops a replay beside the eager
   program's, capture ms per key and the bytes each object's pool holds.
16. The search side's remaining programs as CUDA graphs (after phase 15,
   over the phase-3 store and phase 4b's keyword index): (a) every call of
   a held key is followed by a replay and its eager program, bit for bit
   (phase 15's check): hybrid_search and keyword_search over the 8
   sentences and 8 tail-term queries (resident BM25, device RRF, the int4
   route), hybrid_search_batch at B 32 and 256, keyword_search_batch at B
   256, a query over RESIDENT_MAX_TERMS terms (host-gather BM25), a
   ``maxsim_chunklet`` rerank of 4 top 20s, ``hash:1024`` token embeddings
   of 6,000 characters, the boundary model over the 4 documents and the
   adapter's NNLS at B 64, P = N = 40, d 768, every family holding a key
   (asserted); (b) the checking replays' int4 launches equal the eager
   programs'; (c) from the graphs and eager in turns: hybrid_search and
   keyword_search p50 at B 1, hybrid's split, the batch forms at B 256
   (and hybrid at 32); (d) device operations per hybrid_search call; (e)
   capture ms, pool bytes and keys held per object and per family; (f) 8
   hybrid searches racing an insert, each equal to the same search before
   or after it; (g) the hash:1024 encode, the chunklet rerank, the boundary
   model's ms per 100,000 characters and the NNLS from their graphs and
   eager.
17. Training on the card (after phase 13; a temporary directory of its
   own; no kernel of the kernels line lies on this path): (a) the boundary
   trainer's whole recipe (``python -m raglite_tpu_torch.train.boundary``'s
   ``main``: 800 synthetic documents at seed 1000, 40 epochs of Adam at
   batch 1,024), its held-out F1 on the 60 documents at seed 2000 beside
   the packaged model's and the heuristic's (>= 0.99 asserted), steps a
   second, and the saved file reloaded through ``BoundaryModel.load`` to
   the same probabilities; (b) the encoder trainer at the packaged
   encoder's full width (``base``: 8 layers, d 768, vocab 16,384; SEQ 128,
   QSEQ 64) through ``raglite_tpu_torch.train.corpus``'s and
   ``train.encoder``'s ``main``: a corpus of PHASE17_CORPUS_MB MB from this
   machine's site-packages and its token cache, PHASE17_MLM_STEPS MLM steps
   at batch 256 from the seeded init (the mean loss of the last 20 below
   the first 20's, asserted), then PHASE17_STEPS steps each of contrastive
   (batch 512), hard-negative (256, mining over the corpus) and MaxSim
   (64) from the packaged encoder placed as ``mlm.npz``; for each phase
   the loss at start and end, steps and tokens a second, model TFLOP/s
   from the shapes over the card's 989, peak memory and the host's shares
   of the steady steps' time (making batches; enqueueing the steps); the
   export, whose
   ``flax:<dir>`` embeddings of 8 sentences equal the f16-rounded weights
   built in memory within PHASE17_EXPORT_ATOL, and a 2-document store
   embedded with it answering 8 vector_search calls; that export turned
   into an HF-layout directory by ``train.export_hf``'s ``main`` and served
   as ``flax:<dir>``, its embeddings of the 8 sentences equal to the npz
   export's within PHASE17_EXPORT_ATOL (timed); (c) the card against
   the CPU on the same batches at batch 8: 3 MLM steps from the seeded init
   and 3 contrastive steps from the packaged encoder, every loss within
   PHASE17_LOSS_RTOL and the first step's gradients within PHASE17_GRAD_COS
   (flattened and each leaf), and controls that must fail those limits
   (a lost update, another step's gradient); (d) the tokenizer trainer
   (``train.encoder --phase tokenizer``, train/bpe.py) at vocab 16,384 on
   (b)'s train split in a workdir of its own, its token cache and
   PHASE17_TOKENIZER_MLM_STEPS MLM steps at batch 256 over it: the
   training seconds, the vocabulary (exactly 16,384, asserted) and merges
   (every part in the vocabulary, asserted), tokens a character on the
   held-out split beside the packaged tokenizer's, decode(encode(text)) =
   the text for every held-out document (asserted; bytes outside the
   trained alphabet dropped, as ``tokenizers`` drops them), the losses
   (finite, asserted).
18. The held-out IR evaluation on the card (after phase 17; a temporary
   directory of its own) through ``raglite_tpu_torch.train``'s entry
   points: a corpus of PHASE18_CORPUS_MB MB with PHASE18_HELDOUT_PCT % held
   out; (a) ``semantic_ir_bench.main`` with the packaged encoder
   (``flax:sem``) at PHASE18_DOCS documents, PHASE18_QUERIES queries and
   PHASE18_ADAPTER_QUERIES adapter queries, the rerank on
   PHASE18_RERANK_QUERIES and its rerank-32 latency block on the script's
   50, all six variants: MRR@10, nDCG@10 and recall@10 each, the stores'
   insert seconds, the adapter's, rerank-32 p50 and p95 over 49 timed
   reranks (no quality meaning: the packaged encoder's training
   documents may include these); (b) ``export_beir`` and ``irbench``'s
   PHASE18_BEIR_VARIANTS over that directory at PHASE18_BEIR_QUERIES
   queries (``beir_main``); (c) the ``reranker_blend`` sweep at
   PHASE18_BLENDS over (a)'s ``sem_mv`` store (``blend_main``; blend 0.0 =
   (a)'s rerank row, asserted); (d) at PHASE18_CPU_DOCS documents and
   PHASE18_CPU_QUERIES queries, ``hash-single`` and ``sem-multivector`` on
   the card and with ``--device cpu``: every document both rank scored
   alike and documents trading places only at near ties (PHASE18_CPU_RTOL,
   asserted), and controls that must fail: the next query's ranking, and
   for ``flax:sem`` the card's rankings through copies of the encoder with
   a fault (PHASE18_FAULTS: its last layer left out; its weight matrices
   rounded to float8 e4m3, near the limit).
``--only prefill`` is a partial run for work on that kernel (its checks of
phase 2b and its rows of phase 7; no result line); ``--only phase10`` runs
phase 3 at ``--rows`` and phase 10; ``--only phase11`` runs phase 11 alone
at ``--rows``; ``--only phase12`` runs phase 3's store at ``--rows`` and
phase 12 over it; ``--only phase13`` runs phase 13 alone at ``--rows``;
``--only phase14`` runs phase 3's store at ``--rows``, loads `large` and
runs phase 14 on phase 6's RAG prompt; ``--only phase15`` runs phase 3's
store at ``--rows`` and phase 15; ``--only phase16`` runs phase 3's store
at ``--rows``, phase 4b over it and phase 16; ``--only phase17`` runs
phase 17 alone; ``--only phase18`` runs phase 18 alone (none of them
prints a result line).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: The repo's documents the phases' stores, questions, prompts and trained
#: tokenizers are made from: Markdown that the port never edits, so that a
#: documentation change cannot move a phase's shapes (a retrieved prompt's
#: length, its prefill bucket) or the answers a phase checks.
FROZEN_DOCS = ("ADVICE.md", "BASELINE.md", "MIGRATION.md", "PAPER.md", "PAPERS.md", "PARITY.md", "SURVEY.md", "VERDICT.md")
#: The documents of phase 3's store (and of the later phases over it).
STORE_DOCS = ("VERDICT.md", "SURVEY.md", "MIGRATION.md", "PARITY.md")
D = 768
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8 ops/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BF16_FLOPS = 989e12
#: bf16 rows: kernel and plain version sum in different orders (f32).
BF16_RTOL = 1e-5
RECALL_MIN = 0.99
#: hash:1024 token embeddings on the card against the f64 plain pool over
#: the same bf16 table: f32 sums of at most ~100 rows of N(0, 1) entries,
#: then a normalisation (unit rows; f32 rounding ~1e-7 a term).
HASH_ATOL = 1e-5
#: What expand_document_metadata sends for the fields {"topic": str,
#: "audience": str}: its system prompt and pydantic's schema of its model
#: (tests/test_torch_extract.py holds both to extract.py; pydantic is not
#: on the card's machine, so phase 8 sends them to the LLM layer itself).
METADATA_SYSTEM_PROMPT = (
    "Extract the requested metadata fields from the document below. "
    "Only use information stated in the document."
)
METADATA_SCHEMA = {
    "additionalProperties": False,
    "properties": {
        "topic": {"title": "Topic", "type": "string"},
        "audience": {"title": "Audience", "type": "string"},
    },
    "required": ["topic", "audience"],
    "title": "DocumentMetadata",
    "type": "object",
}


def log(*parts) -> None:
    print(*parts, flush=True)


_STARTED = time.perf_counter()


def mark(label: str) -> None:
    """Log the seconds since the script started, after ``label``."""
    log(f"{label}: {time.perf_counter() - _STARTED:.1f} s since the start")


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
    if not prefill_only:
        check_attention_batch8(g, check)
        log(f"attention check B=8: ok, max_abs_err so far {errs}, share of limit {shares}")
    return errs


def check_attention_batch8(g, check) -> None:
    """Phase 2b at B = 8, the batch of complete_batch: decode, verify at T = 8
    (every row bit-equal to decode) and prefill at T = 64, at the `large`
    shape (KVH 4, REP 5, hd 128) and a small one (2, 4, 32), the 8 rows at
    8 different first positions, 0 and S - T among them; S = 2,208 (prefill
    tiles by TMA) and 1,003 (staged)."""
    import torch

    from raglite_tpu_torch.ops import decode_attention as da
    from raglite_tpu_torch.ops.prefill_attention import gqa_prefill_attention

    for kvh, rep, hd in ((4, 5, 128), (2, 4, 32)):
        scale = hd**-0.5
        for s in (2208, 1003):
            k, v = _cache(g, 8, kvh, hd, s)
            for softcap, window in (KNOBS[0], KNOBS[3]):
                kw = dict(scale=scale, softcap=softcap, window=window)
                for name, t in (("gqa_decode_attention", 1), ("gqa_verify_attention", 8), ("gqa_prefill_attention", 64)):
                    first = [0, s - t, 1, 700, s // 2, 97, s - t - 1, 1234]
                    pos = torch.tensor(first, device="cuda", dtype=torch.int32)
                    assert len(set(first)) == 8
                    q = torch.randn((8, kvh, rep, t, hd), generator=g, device="cuda").to(torch.bfloat16)
                    if name == "gqa_decode_attention":
                        got = da.gqa_decode_attention(q[:, :, :, 0], k, v, pos, **kw)
                    elif name == "gqa_verify_attention":
                        got = da.gqa_verify_attention(q, k, v, pos, **kw)
                        for i in range(t):
                            one = da.gqa_decode_attention(q[:, :, :, i], k, v, pos + i, **kw)
                            assert torch.equal(got[:, :, :, i], one), ("verify != decode at B=8", kvh, rep, hd, s, i)
                    else:
                        got = gqa_prefill_attention(q, k, v, pos, **kw)
                    want = da.gqa_attention_plain(q, k, v, pos, **kw)
                    check(name, ("B=8", name, kvh, rep, hd, s, t, softcap, window), got, want, q, k, v, pos, **kw)
        log(f"attention check B=8 KVH={kvh} REP={rep} hd={hd} S in (2208, 1003): decode, verify T=8 (rows bit-equal "
            "to decode) and prefill T=64 at 8 first positions (0 and S - T among them) ok")


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
    seed: int, rag_s: int, rag_pos: int, rag_t: int, card: str, *, profile: bool = False, only: str | None = None,
    cases: list | None = None, kvh: int = 4, rep: int = 5,
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
    cases of one kernel.  ``cases`` replaces the cases: (name, T, S, first
    position per row), B the number of rows (phase 8 times complete_batch's
    B = 8 shapes so).  ``kvh`` and ``rep`` give another model's groups
    (phase 10: Qwen3-4B's KVH 8, REP 4)."""
    import itertools

    import torch

    from raglite_tpu_torch.ops import cuda_build
    from raglite_tpu_torch.ops import decode_attention as da
    from raglite_tpu_torch.ops.prefill_attention import gqa_prefill_attention

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    floor_fn = cuda_build.function("decode_attention", "rlt_gqa_decode_floor", [*[cuda_build.INT] * 5, cuda_build.VOID])
    hd, layers = 128, 36
    heads, scale = kvh * rep, hd**-0.5
    cases = cases or [
        ("gqa_decode_attention", 1, rag_s, [rag_pos]),
        ("gqa_verify_attention", 8, rag_s, [rag_pos]),
        ("gqa_prefill_attention", rag_t, rag_s, [0]),
        ("gqa_decode_attention", 1, 8352, [8192 + 40]),
        ("gqa_verify_attention", 16, 8352, [8192]),
        ("gqa_prefill_attention", 2048, 2208, [0]),
    ]
    kernels = {
        "gqa_decode_attention": lambda q5, k, v, pos: da.gqa_decode_attention(q5[:, :, :, 0], k, v, pos, scale=scale),
        "gqa_verify_attention": lambda q5, k, v, pos: da.gqa_verify_attention(q5, k, v, pos, scale=scale),
        "gqa_prefill_attention": lambda q5, k, v, pos: gqa_prefill_attention(q5, k, v, pos, scale=scale),
    }
    out = []
    for name, t, s, p0s in cases:
        if only not in (None, name):
            continue
        b = len(p0s)
        caches = [_cache(g, b, kvh, hd, s) for _ in range(layers)]
        pos = torch.tensor(p0s, device="cuda", dtype=torch.int32)
        q5 = torch.randn((b, kvh, rep, t, hd), generator=g, device="cuda").to(torch.bfloat16)
        qh = q5.reshape(b, heads, t, hd)
        key = torch.arange(s, device="cuda")
        rows = pos[:, None].long() + torch.arange(t, device="cuda")  # [B, T]
        mask = (key[None, None, :] <= rows[:, :, None])[:, None]  # [B, 1, T, S]

        def rotating(fn):
            """``fn`` on the next layer's cache at every call."""
            nxt = itertools.cycle(caches)
            return lambda: fn(*next(nxt))

        def plain_fn(q5, k, v, pos):
            """The plain version row by row: the rows are independent, and
            the [B, KVH, REP, T, S] scores of a whole B = 8 prefill batch
            would not fit the card."""
            return torch.cat([da.gqa_attention_plain(q5[i : i + 1], k[i : i + 1], v[i : i + 1], pos[i : i + 1], scale=scale) for i in range(b)])

        kernel = rotating(lambda k, v: kernels[name](q5, k, v, pos))
        plain = rotating(lambda k, v: plain_fn(q5, k, v, pos))
        library = rotating(lambda k, v: _sdpa(qh, k, v, mask))
        k0, v0 = caches[0]
        want = plain_fn(q5, k0, v0, pos)
        got0 = kernels[name](q5, k0, v0, pos)
        err, share = 0.0, 0.0
        for i in range(b):
            sl = slice(i, i + 1)
            e, sh = _attention_check((name, t, s, i), got0[sl], want[sl], q5[sl], k0[sl], v0[sl], pos[sl], scale=scale)
            err, share = max(err, e), max(share, sh)
        lib_err = float((_sdpa(qh, k0, v0, mask).reshape(want.shape).float() - want).abs().max())
        if name == "gqa_verify_attention":
            # At the answer's own shapes too: every window row bit-equal to
            # the decode kernel at pos0 + t.
            got = kernels[name](q5, k0, v0, pos)
            for i in range(t):
                one = da.gqa_decode_attention(q5[:, :, :, i], k0, v0, pos + i, scale=scale)
                assert torch.equal(got[:, :, :, i], one), ("verify != decode", t, s, p0s, i)
        del want
        torch.cuda.empty_cache()
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, reps=5, inner=1, warmup=1)
        library_ms = median_ms(library, reps=10, inner=5)
        # What this call must do: every valid key's K and V columns read once
        # (each row its own cache), q read and the f32 context written once;
        # 4 * hd flops per (query head, valid key) pair.
        valid = torch.clamp(rows + 1, max=s)
        pairs = int(valid.sum()) * heads
        moved = int(valid.max(dim=1).values.sum()) * kvh * hd * 2 * 2 + q5.numel() * 2 + q5.numel() * 4
        bound = {"bytes": moved / PEAK_BYTES_PER_S * 1e3, "operations": 4 * hd * pairs / PEAK_BF16_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        entry = {
            "name": name, "batch": b, "T": t, "S": s, "KVH": kvh, "REP": rep, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound[bound_by], "bound_by": bound_by, "max_abs_err": err,
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
                rc = floor_fn(b, kvh, rep * t, hd, s, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, f"rlt_gqa_decode_floor: cudaError {rc}"

            entry["graph_ms"] = graph_ms(kernel)
            entry["floor_ms"], entry["floor_graph_ms"] = median_ms(floor), graph_ms(floor)
            floor_text = (
                f"enqueued call by call, {entry['graph_ms']:.4f} ms replayed from a CUDA graph of 36 calls; "
                f"launch floor (empty kernel, same grid and shared memory) {entry['floor_ms']:.4f} ms "
                f"enqueued, {entry['floor_graph_ms']:.4f} ms from the graph; "
            )
        log(
            f"timing {name} B={b} T={t} S={s} pos0={p0s} (KVH {kvh}, REP {rep}, hd {hd}; {layers} rotating caches) "
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
            attention_phases(q5, caches[:4], caches[layers // 2], pos, scale, f"{name} (T = {t}, S = {s}, pos0 = {p0s})", card)
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


def _profile_window(fn, what: str, card: str, top: int = 12) -> tuple[int, float]:
    """One torch.profiler window over ``fn`` (warm): the device's busy time
    by kernel and its idle share of the window (the profiler's own host
    overhead is inside the window, so the idle share is an upper bound).
    Returns (device operations in the window, idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [  # the device's own work: kernels and copies, not the ranges user code annotates
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    log(
        f"profile: {what}, window {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle share {1 - busy_us / wall_us:.4f}, {sum(k[2] for k in kernels)} device ops, on {card}"
    )
    for name, us, count in kernels[:top]:
        log(f"  profile: {us / 1e3:9.3f} ms  {count:5d}x  {name[:110]}")
    return sum(k[2] for k in kernels), 1 - busy_us / wall_us


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


def _weight_bytes(params) -> int:
    """Bytes of a decoder's parameters (int8 blocks and scales included)."""
    leaves = [*(v for k, v in params.items() if k != "layers"), *(v for layer in params["layers"] for v in layer.values())]
    tensors = [t for x in leaves for t in ((x.q8, x.s8) if hasattr(x, "q8") else (x,))]
    return sum(t.numel() * t.element_size() for t in tensors)


def rag_spans(question: str, rag_cfg) -> list:
    """``question``'s retrieved spans, as many as rag() keeps: its clip
    estimates a message's tokens as its JSON's characters / 3 and drops a
    message over the window whole, so an add_context message that
    _limit_chunkspans let through (it counts the spans' XML, not the JSON
    escapes) may leave an empty prompt; the last spans go until it fits."""
    from raglite_tpu_torch import add_context, retrieve_context
    from raglite_tpu_torch.models.llm import get_context_size
    from raglite_tpu_torch.rag import _clip

    spans = retrieve_context(question, config=rag_cfg)
    while len(spans) > 1 and not _clip([add_context(question, spans, rag_cfg)], get_context_size(rag_cfg)):
        spans = spans[:-1]
    return spans


def serve_rag(cfg, question: str, card: str, *, spec: str = "jax:large", messages=None, profile: bool = False) -> dict:
    """Phase 6: rag() answers from the ``large`` decoder over the phase-3
    index; a sampled stream; greedy with speculation off against on.  Phase
    10 (c) runs it again with ``spec`` a ``jax:hf:`` checkpoint and
    ``messages`` phase 6's (the same prompt text, in the checkpoint's
    tokens)."""
    import dataclasses
    import os

    import torch

    from raglite_tpu_torch import add_context, rag
    from raglite_tpu_torch.models.decoder import DECODE_CHUNK, _bucket
    from raglite_tpu_torch.models.llm import llm_from_config
    from raglite_tpu_torch.rag import _clip

    rag_cfg = dataclasses.replace(cfg, llm=spec)
    t0 = time.perf_counter()
    llm = llm_from_config(rag_cfg)  # jax:large: the seeded init of the 8 GB preset, on the card
    torch.cuda.synchronize()
    layers = llm.cfg["layers"]
    weight_bytes = _weight_bytes(llm.params)
    log(f"llm {spec} ({layers} layers, d {llm.cfg['d_model']}, vocab {llm.cfg['vocab']}): "
        f"{weight_bytes / 1e9:.3f} GB of weights, built (or taken from the factory's cache) in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    if messages is None:
        spans = rag_spans(question, rag_cfg)
        messages = [add_context(question, spans, rag_cfg)]
        found = f"{len(spans)} spans retrieved and kept"
    else:
        messages = [dict(m) for m in messages]
        found = "phase 6's message"
    retrieve_ms = (time.perf_counter() - t0) * 1e3
    first_message = dict(messages[0])
    prompt = llm._format_messages(_clip(messages, llm.context_size), None)
    max_new = 128
    t0 = time.perf_counter()
    encoded = llm.tokenizer.encode(prompt)
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    llm.tokenizer.encode(prompt)
    encode_again_ms = (time.perf_counter() - t0) * 1e3
    prompt_tokens = min(len(encoded), llm.context_size - max_new - 1) + int(llm._byte_level)  # + BOS
    assert prompt_tokens > 1000, prompt_tokens  # a RAG prompt, not an empty one
    rag_s = _bucket(prompt_tokens) + _bucket(max_new) + DECODE_CHUNK
    log(f"rag question {question!r}: {found} in {retrieve_ms:.1f} ms, {len(prompt)} characters, "
        f"prompt {prompt_tokens} tokens (encoded on the host in {encode_ms:.1f} ms, {encode_again_ms:.1f} ms again "
        f"with the word cache warm), KV length S = {rag_s}")

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
    log(f"{spec} on {card}: prefill of {prompt_tokens} tokens (T = {ids.shape[1]}) {prefill_ms:.2f} ms; "
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
        "rag_s": rag_s, "rag_pos": prompt_tokens, "rag_t": ids.shape[1], "first_piece_ms": first_piece_ms,
        "messages": [first_message], "answer": answer, "prompt": prompt, "encode_ms": encode_ms, "ttft_ms": ttft_ms,
        "prefill_ms": prefill_ms, "step_ms": step_ms,
        "tokens_per_s": {
            "greedy_speculative": decode_tps,
            "plain": len(plain) / max((plain_ms - prefill_ms) / 1e3, 1e-9),
            "sampled": len(sampled) / max((sampled_ms - prefill_ms) / 1e3, 1e-9),
        },
        "common_prefix": common / max(len(plain), 1),
        "launches": {
            "gqa_prefill_attention": launches_rag["gqa_prefill_attention"],
            "gqa_verify_attention": launches_rag["gqa_verify_attention"],
            "gqa_decode_attention": launches_sampled["gqa_decode_attention"],
        },
    }


#: Phase 8's schema: an object with a string, an enum and an anyOf [integer,
#: null] field.
PHASE8_SCHEMA = {
    "type": "object",
    "properties": {
        "subject": {"type": "string"},
        "kind": {"enum": ["definition", "claim", "question", "instruction"]},
        "year": {"anyOf": [{"type": "integer"}, {"type": "null"}]},
    },
    "required": ["subject", "kind", "year"],
}
#: The batch of phase 8 (c): 8 of the repo's documents, clipped to these
#: lengths in bytes (ragged prompts; the longest, with the system prompt and
#: the chat template, stays inside one 4,096-token prefill bucket).
BATCH_DOCS = ("ADVICE.md", "BASELINE.md", "PAPER.md", "MIGRATION.md", "PAPERS.md", "PARITY.md", "VERDICT.md", "SURVEY.md")
BATCH_CLIPS = (256, 512, 768, 1024, 1536, 2048, 3072, 3584)


def _conforms(schema, text: str) -> bool:
    """A fresh SchemaAutomaton takes every byte of ``text`` and ends done."""
    from raglite_tpu_torch.models.schema_automaton import SchemaAutomaton

    automaton = SchemaAutomaton(schema)
    for byte in text.encode("utf-8"):
        if byte not in automaton.allowed_bytes():
            return False
        automaton.feed(byte)
    return automaton.done()


def _within_budget(schema, tokens: list[int], budget: int) -> bool:
    """A constrained row's tokens are at most ``budget`` generated bytes,
    then (where the budget ran out mid-document) exactly the automaton's
    closing bytes."""
    from raglite_tpu_torch.models.schema_automaton import SchemaAutomaton
    from raglite_tpu_torch.models.tokenizer import ByteTokenizer

    automaton = SchemaAutomaton(schema)
    data = [t - ByteTokenizer._OFFSET for t in tokens]
    fed = 0
    while fed < len(data) and fed < budget and not automaton.done():
        automaton.feed(data[fed])
        fed += 1
    if automaton.done():
        return fed == len(data)
    return fed == budget and bytes(data[fed:]) == automaton.completion_bytes()


#: The response format expand_document_metadata sends for METADATA_SCHEMA.
METADATA_FORMAT = {"type": "json_schema", "json_schema": {
    "name": "DocumentMetadata", "description": "", "schema": METADATA_SCHEMA, "strict": False,
}}


def _batch_convs() -> list[list[dict]]:
    """Phase 8 (c)'s batch: expand_document_metadata's system prompt over
    BATCH_DOCS clipped to BATCH_CLIPS bytes (ragged, T = 4,096)."""
    docs = [(ROOT / f).read_text(encoding="utf-8") for f in BATCH_DOCS]
    return [
        [{"role": "system", "content": METADATA_SYSTEM_PROMPT}, {"role": "user", "content": d.encode("utf-8")[:n].decode("utf-8", "ignore")}]
        for d, n in zip(docs, BATCH_CLIPS)
    ]


def structured_generation(cfg, sentences: list[str], seed: int, card: str) -> dict:
    """Phase 8 (a)-(c): schema-constrained, forced-tool and batched
    generation on the `large` preset that phase 6 loaded (the same object).
    Returns the B = 8 launches and kernel timings."""
    import dataclasses

    import torch

    from raglite_tpu_torch.models.decoder import DECODE_CHUNK, _bucket, _prefill_last
    from raglite_tpu_torch.models.llm import ToolCall, llm_from_config

    llm = llm_from_config(dataclasses.replace(cfg, llm="jax:large"))  # phase 6's, cached
    layers = llm.cfg["layers"]

    # (a) One schema-constrained answer.
    messages = [{"role": "user", "content": f"Describe this sentence as JSON: {sentences[0]}"}]
    response_format = {"type": "json_schema", "json_schema": {"name": "Sentence", "schema": PHASE8_SCHEMA}}
    generated: list[int] = []
    generate_tokens = llm._generate_tokens

    def recording_tokens(*args, **kwargs):
        for token in generate_tokens(*args, **kwargs):
            generated.append(token)
            yield token

    llm._generate_tokens = recording_tokens
    try:
        _reset_attention_launches()
        t0 = time.perf_counter()
        content = llm.complete(messages, response_format=response_format, max_tokens=96).content
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _attention_launches()
    finally:
        del llm._generate_tokens
    value = json.loads(content)
    # Every generated byte (the content decodes stray bytes to U+FFFD) and
    # the content both pass a fresh automaton.
    assert _within_budget(PHASE8_SCHEMA, generated, 96) and _conforms(PHASE8_SCHEMA, content), content
    n_tokens = len(generated)
    assert launches["gqa_prefill_attention"] == layers and launches["gqa_decode_attention"] > 0, launches
    log(f"phase 8 (a) schema-constrained complete: {n_tokens} tokens in {ms:.1f} ms ({n_tokens / ms * 1e3:.2f} tokens/s, "
        f"prefill included; a host loop, one forward and one logits fetch a token), launches {launches}, "
        f"output {json.dumps(value)[:160]!r}, on {card}")

    # (b) One forced tool call.
    tools = [
        {"type": "function", "function": {
            "name": "search_knowledge_base", "description": "Search the knowledge base.",
            "parameters": {"type": "object", "properties": {"query": {"type": "string"}}, "required": ["query"]},
        }},
        {"type": "function", "function": {
            "name": "open_page", "description": "Open one page of a document.",
            "parameters": {"type": "object", "properties": {"page": {"type": "integer"}}, "required": ["page"]},
        }},
    ]
    t0 = time.perf_counter()
    items = list(llm.stream([{"role": "user", "content": sentences[1]}], tools=tools, tool_choice="required", max_tokens=64))
    ms = (time.perf_counter() - t0) * 1e3
    assert len(items) == 1 and isinstance(items[0], ToolCall), items
    call = items[0]
    schema = {t["function"]["name"]: t["function"]["parameters"] for t in tools}.get(call.name)
    assert schema is not None and _conforms(schema, call.arguments), (call.name, call.arguments)
    log(f"phase 8 (b) forced tool call: {call.name}({call.arguments[:120]}) in {ms:.1f} ms, conforms, on {card}")

    # (c) complete_batch of 8 ragged conversations, unconstrained then under
    # expand_document_metadata's schema.
    convs = _batch_convs()
    budget = 64
    recorded: list = []
    generate = llm._generate_batch

    def recording(*args, **kwargs):
        recorded.append(generate(*args, **kwargs))
        return recorded[-1]

    llm._generate_batch = recording
    runs = {}
    try:
        for kind, rf in (("greedy", None), ("schema", METADATA_FORMAT)):
            _reset_attention_launches()
            t0 = time.perf_counter()
            responses = llm.complete_batch(convs, response_format=rf, max_tokens=budget)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            runs[kind] = {"ms": wall, "launches": _attention_launches(), "tokens": recorded[-1], "contents": [r.content or "" for r in responses]}
    finally:
        del llm._generate_batch
    greedy, schema_run = runs["greedy"], runs["schema"]
    for tokens in greedy["tokens"]:
        assert len(tokens) <= budget, len(tokens)
    for tokens, content in zip(schema_run["tokens"], schema_run["contents"]):
        assert _within_budget(METADATA_SCHEMA, tokens, budget), tokens
        assert set(json.loads(content)) == {"topic", "audience"} and _conforms(METADATA_SCHEMA, content), content
    lg, ls = greedy["launches"], schema_run["launches"]
    # One [8, T] prefill a run; batched verify (speculation) on the greedy
    # run; [8, 1] decode forwards on the constrained one.
    assert lg["gqa_prefill_attention"] == layers and lg["gqa_verify_attention"] > 0 and lg["gqa_verify_attention"] % layers == 0, lg
    assert ls["gqa_prefill_attention"] == layers and ls["gqa_decode_attention"] > 0 and ls["gqa_verify_attention"] == 0, ls

    # The [8, T] prefill alone, at the batch's own shape.
    prompts = [llm._format_messages(c, None) for c in convs]
    lens = [1 + len(llm.tokenizer.encode(p)) for p in prompts]
    pad = _bucket(max(lens))
    max_total = pad + _bucket(budget) + DECODE_CHUNK
    ids = torch.full((8, pad), llm.tokenizer.PAD, dtype=torch.int64, device="cuda")
    for i, n in enumerate(lens):
        ids[i, :n] = 3
    lens_t = torch.tensor(lens, device="cuda")
    prefill_ms = median_ms(
        lambda: _prefill_last(llm.model, llm.params, ids, llm.model.init_cache(8, max_total, device="cuda"), lens_t),
        reps=3, inner=1, warmup=1,
    )
    for kind, run in runs.items():
        total = sum(len(t) for t in run["tokens"])
        log(f"phase 8 (c) complete_batch B=8 {kind}: prompts {lens} tokens (T = {pad}, S = {max_total}), {total} tokens "
            f"in {run['ms']:.1f} ms = {total / run['ms'] * 1e3:.2f} tokens/s summed, prefill of the batch {prefill_ms:.2f} ms, "
            f"launches {run['launches']}, on {card}")
    shares = []
    for conv, content in zip(convs, greedy["contents"]):
        alone = llm.complete(conv, max_tokens=budget).content or ""
        common = next((i for i, (a, b) in enumerate(zip(alone, content)) if a != b), min(len(alone), len(content)))
        shares.append(common / max(len(alone), 1))
    log(f"phase 8 (c) unconstrained rows against the port's own B=1 complete: common-prefix shares {[round(x, 4) for x in shares]} "
        "(cuBLAS may sum [8, .] and [1, .] products in other orders)")

    # The three kernels at complete_batch's shapes (B = 8): decode and verify
    # at the rows' first positions after their prompts, prefill over the
    # batch's prompt bucket.
    batch_timings = time_attention(
        seed, 0, 0, 0, card,
        cases=[
            ("gqa_decode_attention", 1, max_total, [n + DECODE_CHUNK for n in lens]),
            ("gqa_verify_attention", 8, max_total, lens),
            ("gqa_prefill_attention", pad, max_total, [0] * 8),
        ],
    )

    return {
        "launches": {
            "gqa_prefill_attention": lg["gqa_prefill_attention"],
            "gqa_verify_attention": lg["gqa_verify_attention"],
            "gqa_decode_attention": ls["gqa_decode_attention"],
        },
        "timings": batch_timings,
    }


def _fresh_memory_store() -> None:
    """Forget every cached store and index, so the next ":memory:" config
    gets a new store (they are cached by path).  The phase-3 store is gone
    after this: phases 8 (d) and 9 (f) call it, and run last."""
    from raglite_tpu_torch.index.dense import _index_for_store
    from raglite_tpu_torch.index.keyword import _keyword_index_for_path
    from raglite_tpu_torch.store import _store_for_path

    for cache in (_store_for_path, _index_for_store, _keyword_index_for_path):
        cache.cache_clear()


def hash_on_card(texts: list[str], sentences: list[str], card: str) -> None:
    """Phase 8 (d): ``hash:1024`` on the card over the repo's documents,
    against the CPU.  It runs after phase 9, which needs the phase-3 store
    that this step's fresh stores replace."""
    from raglite_tpu_torch import Document, RAGLiteConfig, hybrid_search, insert_documents, vector_search
    from raglite_tpu_torch.models.encoder import encoder_from_config, hash_pool_plain

    found = {}
    for device in ("cuda", "cpu"):
        _fresh_memory_store()
        hcfg = RAGLiteConfig(embedder="hash:1024", device=device, store_path=":memory:")
        t0 = time.perf_counter()
        encoder = encoder_from_config(hcfg)  # the card's: table drawn on the host (C++), then uploaded in bf16
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        insert_documents([Document.from_text(t) for t in texts], config=hcfg)
        insert_s = time.perf_counter() - t0
        found[device] = [vector_search(q, num_results=10, config=hcfg)[0] for q in sentences]
        if device == "cuda":
            text = texts[0][:6000]
            got = encoder.embed_token_level(text)
            ids_, signs, bounds, n = encoder._featurize(text)
            want = hash_pool_plain(encoder._table.float().cpu().numpy(), ids_, signs, bounds)
            err = float(abs(got - want).max())
            assert got.shape == (n, 1024) and err <= HASH_ATOL, err
            held = [k for k in encoder.programs._entries if k[0] == "hash"]
            assert held and encoder.programs.counts["replayed"] > 0, encoder.programs.counts  # the pool ran from graphs
            vs_p50 = _p50_ms(lambda q: vector_search(q, config=hcfg), sentences * 3)
            hs_p50 = _p50_ms(lambda q: hybrid_search(q, config=hcfg), sentences * 3)
            log(f"phase 8 (d) hash:1024 on the card: encoder built in {build_s:.3f} s (65,536 x 1,024 table drawn in C++ on "
                f"the host, uploaded in bf16), inserted {len(texts)} documents in {insert_s:.1f} s; {n} token embeddings "
                f"= the plain f64 gather and segment sum over the same bf16 table, max_abs_err {err:.3g} (limit {HASH_ATOL}), "
                f"the pool from CUDA graphs ({len(held)} keys, {encoder.programs.counts}); "
                f"vector_search p50 {vs_p50:.3f} ms, hybrid_search p50 {hs_p50:.3f} ms over {len(sentences) * 3} queries, on {card}")
    overlap = [len(set(a) & set(b)) / 10 for a, b in zip(found["cuda"], found["cpu"])]
    log(f"phase 8 (d) top-10 overlap, card (bf16 table) against the CPU port (f32 table), over the phase-3 sentences: "
        f"{overlap} (mean {statistics.mean(overlap):.3f})")


# --- Phase 9: evals, the query adapter and async/remote RAG ------------------

#: Phase 9 (a): evals generated with the echo LLM over the phase-3 store.
PHASE9_EVALS = 64
#: Phase 9 (d): stored evals answered and judged by the `large` decoder.
PHASE9_JUDGED = 2
#: Phase 9 (e): pieces taken from async_rag before the consumer walks away.
PHASE9_EARLY_EXIT = 8
#: The card's peak f32 rate outside the tensor cores (NVIDIA data sheet,
#: SXM): the NNLS's products are f32 matrix-vector products, TF32 off.
PEAK_F32_FLOPS = 67e12


def _all_launches() -> dict[str, int]:
    from raglite_tpu_torch.ops import fused_scan as fs

    return {**fs.launch_counts, **_attention_launches()}


def _counted(total: dict[str, int], fn):
    """Run ``fn`` with every kernel count set to 0 first; add what it
    launched to ``total``."""
    from raglite_tpu_torch.ops import fused_scan as fs

    fs.reset_launch_counts()
    _reset_attention_launches()
    out = fn()
    for name, count in _all_launches().items():
        total[name] = total.get(name, 0) + count
    return out


def phase9_evals(cfg, seed: int, total: dict[str, int], card: str) -> dict:
    """Phase 9 (a): insert_evals with the echo LLM over the phase-3 store, 4
    threads searching one index at once.  Every search must take the int4
    route (one int4 launch each, no other scan), every failed eval must be
    a ValueError of the eval logic (a device fault would be another type),
    and each threaded search must equal the same search made alone."""
    import random
    import threading

    import numpy as np

    import raglite_tpu_torch.evals as evals_mod
    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.store import store_from_config

    store = store_from_config(cfg)
    assert not store.evals, len(store.evals)
    lock = threading.Lock()
    searches, failures, made = [], [], []
    search, generate = evals_mod.vector_search, evals_mod.generate_eval

    def recording_search(query, **kwargs):
        out = search(query, **kwargs)
        with lock:
            searches.append((np.array(query, copy=True) if not isinstance(query, str) else query, kwargs, out))
        return out

    def recording_generate(**kwargs):
        try:
            out = generate(**kwargs)
        except Exception as e:
            with lock:
                failures.append(e)
            raise
        with lock:
            made.append(out.id)
        return out

    evals_mod.vector_search, evals_mod.generate_eval = recording_search, recording_generate
    random.seed(seed)
    try:
        t0 = time.perf_counter()
        launches = {}
        _counted(launches, lambda: evals_mod.insert_evals(num_evals=PHASE9_EVALS, max_chunks_per_eval=20, config=cfg))
        wall = time.perf_counter() - t0
    finally:
        evals_mod.vector_search, evals_mod.generate_eval = search, generate
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count
    stored = len(store.evals)
    kinds = sorted({f"{type(e).__name__}: {str(e)[:60]}" for e in failures})
    log(f"phase 9 (a) insert_evals: {len(made)} of {PHASE9_EVALS} evals made ({stored} distinct, stored) in {wall:.3f} s "
        f"({len(made) / wall:.2f} evals/s, {PHASE9_EVALS / wall:.2f} attempts/s), {len(searches)} vector_search calls on 4 "
        f"threads, launches {launches}, {len(failures)} failed: {kinds}, on {card}")
    assert stored >= 1 and len(made) + len(failures) == PHASE9_EVALS and stored == len(set(made)), (stored, len(made))
    assert all(type(e) is ValueError for e in failures), kinds
    assert launches["int4_bucket_scan"] == len(searches) and launches["bucketed_max_scan"] == 0, (launches, len(searches))
    # The 4-thread check: each search again, alone, gives the same chunks.
    t0 = time.perf_counter()
    for query, kwargs, found in searches:
        assert search(query, **kwargs) == found, (query, found)
    log(f"phase 9 (a) the {len(searches)} threaded searches equal the same searches made one by one "
        f"({(time.perf_counter() - t0) * 1e3 / max(len(searches), 1):.3f} ms a search alone), on {card}")
    return {"evals_made": len(made), "evals_stored": stored, "insert_evals_s": wall, "searches": len(searches)}


def phase9_adapter(cfg, queries: list[str], total: dict[str, int], card: str) -> dict:
    """Phase 9 (b) and (c): update_query_adapter over the stored evals at
    d = 768 with its time split and peak memory, the device NNLS against the
    same op on the CPU, then vector_search with the stored adapter (int4
    route, recall@10 against the exact route with the same adapter), and
    the adapter removed again."""
    import numpy as np
    import torch

    import raglite_tpu_torch.query_adapter as qa
    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.search import corrected_num_hits, vector_search
    from raglite_tpu_torch.store import store_from_config

    store = store_from_config(cfg)
    index = dense_index_from_config(cfg)
    plain_ids = [vector_search(q, num_results=10, config=cfg)[0] for q in queries]
    split = {"embed": 0.0, "blocked search": 0.0, "device NNLS": 0.0, "f64 Procrustes": 0.0}
    nnls_calls = []
    originals = {}

    def timed(attr, what):
        fn = originals[attr] = getattr(qa, attr)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[what] += time.perf_counter() - t0
            if attr == "_nnls_targets":
                nnls_calls.append((args, kwargs, out))
            return out

        setattr(qa, attr, wrapper)

    for attr, what in (("embed_queries", "embed"), ("search_blocked", "blocked search"),
                       ("_nnls_targets", "device NNLS"), ("procrustes_adapter", "f64 Procrustes")):
        timed(attr, what)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        A = _counted(total, lambda: qa.update_query_adapter(config=cfg))
        wall = time.perf_counter() - t0
    finally:
        for attr, fn in originals.items():
            setattr(qa, attr, fn)
    peak = torch.cuda.max_memory_allocated()
    split["host candidates and the rest"] = wall - sum(split.values())
    n_evals = len(store.evals)
    log(f"phase 9 (b) update_query_adapter over {n_evals} evals at d = {A.shape[0]}: {wall * 1e3:.1f} ms, split (ms) "
        f"{ {k: round(v * 1e3, 3) for k, v in split.items()} }, {len(nnls_calls)} NNLS batch(es), peak "
        f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB ({(peak - before) / 1e9:.3f} GB above the "
        f"{before / 1e9:.3f} GB held before the call), on {card}")
    assert A.shape == (D, D) and np.isfinite(A).all(), A.shape
    orth = float(np.abs(A @ A.T - np.eye(D)).max())
    assert orth <= 1e-3, orth
    assert store.index_metadata["query_adapter"] is A
    # The device NNLS of the first batch (from its CUDA graph) against the
    # same op on the CPU.
    from raglite_tpu_torch.ops.nnls import query_targets_from_rows
    from raglite_tpu_torch.utils import graphs

    args, kwargs, out = nnls_calls[0]
    assert out.device.type == "cuda", "the NNLS left the card"
    host = args[1:]
    want = query_targets_from_rows(*(torch.from_numpy(a) for a in host), alpha=kwargs["alpha"])
    err = float((out.cpu() - want).abs().max())
    assert err <= 1e-4, err
    b, p, d = host[1].shape
    m = p * host[2].shape[1]
    on_card = [torch.from_numpy(a).cuda() for a in host]
    nnls_ms = median_ms(lambda: qa._nnls_targets("cuda", *on_card, **kwargs), reps=3, inner=1, warmup=1)
    with graphs.eager_programs():
        nnls_eager_ms = median_ms(lambda: qa._nnls_targets("cuda", *on_card, **kwargs), reps=3, inner=1, warmup=1)
    moved = sum(a.nbytes for a in host) + out.numel() * out.element_size()
    flops = 2.0 * b * m * d * (2 * 16 + 2 * 200 + 1)  # matrix-vector products over the [B, m, d] pair rows
    bound = {"bytes": moved / PEAK_BYTES_PER_S * 1e3, "operations": flops / PEAK_F32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    # The port's formulation materialises the pair rows D [B, m, d] f32 and
    # reads them about twice an iteration: its own bytes bound.
    d_reads = b * m * d * 4 * (2 * 16 + 2 * 200 + 2)
    log(f"phase 9 (b) NNLS batch B={b}, P*N={m}, d={d}: device = CPU op within {err:.3g} (limit 1e-4); {nnls_ms:.3f} ms "
        f"a call from its CUDA graph, {nnls_eager_ms:.3f} eager (CUDA events), inputs and output {moved / 1e6:.3f} MB, pair rows "
        f"{b * m * d * 4 / 1e6:.1f} MB f32, {flops / 1e9:.2f} GFLOP f32, bound {bound[bound_by]:.4f} ms ({bound_by}; bytes "
        f"{bound['bytes']:.4f}, operations {bound['operations']:.4f} at 67 TFLOP/s f32); reading D {d_reads / 1e9:.1f} GB: "
        f"{d_reads / PEAK_BYTES_PER_S * 1e3:.2f} ms at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; ||AA^T - I||_inf {orth:.3g}, on {card}")
    # (c) vector_search with the stored adapter.
    latencies, routes = [], set()
    for q in queries:
        t0 = time.perf_counter()
        ids, scores = _counted(total, lambda q=q: vector_search(q, num_results=10, config=cfg))
        latencies.append((time.perf_counter() - t0) * 1e3)
        routes.add(index.last_route)
        assert len(ids) == 10 and np.isfinite(scores).all(), (q, scores)
    assert routes == {"int4_two_stage"}, routes
    emb = embed_queries(queries, config=cfg)
    hits = min(corrected_num_hits(4, 10, cfg), index.num_rows)
    recalls = []
    for i in range(len(queries)):
        routed = index.search_chunks_device(emb[i : i + 1], num_hits=hits, num_results=10, adapter=A)[1]
        exact = index.search_chunks_device(emb[i : i + 1], num_hits=hits, num_results=10, adapter=A, exact=True)[1]
        routed, exact = set(routed[0].tolist()), set(exact[0].tolist())
        recalls.append(len(routed & exact) / len(exact))
    recall = statistics.mean(recalls)
    assert recall >= RECALL_MIN, recall
    del store.index_metadata["query_adapter"]
    again = [vector_search(q, num_results=10, config=cfg)[0] for q in queries]
    assert again == plain_ids, "the store does not search as before once the adapter is removed"
    log(f"phase 9 (c) vector_search with the adapter (int4 route): p50 {statistics.median(latencies):.3f} ms over "
        f"{len(queries)} queries, recall@10 against the exact route with the same adapter {recall:.4f}; adapter "
        f"removed, the plain searches' ids as before, on {card}")
    return {"adapter_ms": wall * 1e3, "peak_gb": peak / 1e9, "nnls_ms": nnls_ms, "nnls_eager_ms": nnls_eager_ms,
            "adapted_p50_ms": statistics.median(latencies)}


def phase9_judge(cfg, total: dict[str, int], card: str) -> dict:
    """Phase 9 (d): the first PHASE9_JUDGED stored evals answered by rag()
    over retrieve_context with the `large` decoder, then scored by
    evaluate_columns(judge=True) (the column functions: no pandas needed).
    Each judge panel must be one batched complete_batch, never the per-item
    fallback."""
    import dataclasses

    import numpy as np
    import torch

    from raglite_tpu_torch.evals import answer_evals_columns, evaluate_columns
    from raglite_tpu_torch.models.decoder import _bucket
    from raglite_tpu_torch.models.llm import llm_from_config

    large_cfg = dataclasses.replace(cfg, llm="jax:large")
    llm = llm_from_config(large_cfg)  # phase 6's object, cached
    batches, singles = [], []
    complete_batch, complete = llm.complete_batch, llm.complete

    def recording_batch(messages_batch, *, response_format=None, **kwargs):
        prompts = [llm._format_messages(m, None) for m in messages_batch]
        t = _bucket(max(1 + len(llm.tokenizer.encode(p)) for p in prompts))
        t0 = time.perf_counter()
        out = complete_batch(messages_batch, response_format=response_format, **kwargs)
        batches.append({"name": (response_format or {}).get("json_schema", {}).get("name"), "B": len(messages_batch),
                        "T": t, "ms": round((time.perf_counter() - t0) * 1e3, 1)})
        return out

    def recording_complete(messages, *, response_format=None, **kwargs):
        singles.append((response_format or {}).get("json_schema", {}).get("name"))
        return complete(messages, response_format=response_format, **kwargs)

    llm.complete_batch, llm.complete = recording_batch, recording_complete
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        columns = _counted(total, lambda: answer_evals_columns(PHASE9_JUDGED, config=large_cfg))
        torch.cuda.synchronize()
        answer_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = _counted(total, lambda: evaluate_columns(columns, large_cfg, judge=True))
        torch.cuda.synchronize()
        judge_s = time.perf_counter() - t0
    finally:
        del llm.complete_batch, llm.complete
    peak = torch.cuda.max_memory_allocated()
    assert len(columns["question"]) == PHASE9_JUDGED and all(columns["answer"]), columns["answer"]
    panels = [b for b in batches if b["name"] == "Verdict"]
    log(f"phase 9 (d) answer_evals ({PHASE9_JUDGED} evals, rag() on jax:large): {answer_s:.3f} s; evaluate(judge=True): "
        f"{judge_s:.3f} s; complete_batch calls (B, T, ms) {batches}; single constrained completes {singles}; peak "
        f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB, on {card}")
    # faithfulness, context_precision and context_recall: one panel each.
    assert len(panels) == 3 and "Verdict" not in singles, (batches, singles)
    for column in ("faithfulness", "context_precision", "context_recall"):
        values = np.asarray(metrics[column], dtype=np.float64)
        judged = values[~np.isnan(values)]
        assert values.shape == (PHASE9_JUDGED,) and ((judged >= 0.0) & (judged <= 1.0)).all(), (column, values)
    for column in ("answer_similarity", "context_relevancy", "faithfulness_proxy", "answer_relevancy"):
        values = np.asarray(metrics[column], dtype=np.float64)
        assert values.shape == (PHASE9_JUDGED,) and np.isfinite(values).all() and (np.abs(values) <= 1.01).all(), (column, values)
    log(f"phase 9 (d) metrics: { {k: [round(float(x), 4) for x in v] for k, v in metrics.items() if k != 'question'} }")
    return {"answer_s": answer_s, "judge_s": judge_s, "peak_gb": peak / 1e9, "panels": panels}


def phase9_async(cfg, question: str, rag_first_ms: float, total: dict[str, int], card: str) -> dict:
    """Phase 9 (e): async_rag on the `large` decoder (the worker-thread
    bridge) against rag()'s greedy answer to the same messages; then an
    early exit after 8 tokens, after which no kernel is launched and
    rag() still gives the same answer."""
    import asyncio
    import dataclasses
    import importlib

    import torch

    from raglite_tpu_torch import add_context, async_rag, rag

    rag_mod = importlib.import_module("raglite_tpu_torch.rag")
    large_cfg = dataclasses.replace(cfg, llm="jax:large")
    spans = rag_spans(question, large_cfg)

    def fresh():
        return [add_context(question, spans, large_cfg)]

    native = rag_mod._async_rag_native

    def no_native(*args, **kwargs):
        msg = "the jax: decoder has no async stream: async_rag must take the bridge"
        raise AssertionError(msg)

    async def stream(messages):
        t0 = time.perf_counter()
        first, out = None, []
        async for token in async_rag(messages, config=large_cfg):
            if first is None:
                first = (time.perf_counter() - t0) * 1e3
            out.append(token)
        return out, first, (time.perf_counter() - t0) * 1e3

    async def early(messages):
        agen = async_rag(messages, config=large_cfg)
        n = 0
        async for _ in agen:
            n += 1
            if n >= PHASE9_EARLY_EXIT:
                break
        await agen.aclose()
        torch.cuda.synchronize()
        at_close = _all_launches()
        await asyncio.sleep(0.5)
        torch.cuda.synchronize()
        return n, at_close, _all_launches()

    rag_mod._async_rag_native = no_native
    try:
        bridge_msgs = fresh()
        tokens, first_ms, bridge_ms = _counted(total, lambda: asyncio.run(stream(bridge_msgs)))
        rag_msgs = fresh()
        want = _counted(total, lambda: list(rag(rag_msgs, config=large_cfg)))
        assert "".join(tokens) == "".join(want) and len(tokens) > PHASE9_EARLY_EXIT, (tokens[:8], want[:8])
        assert bridge_msgs == rag_msgs, "the bridge left other messages than rag()"
        early_msgs = fresh()
        n, at_close, later = _counted(total, lambda: asyncio.run(early(early_msgs)))
        assert n == PHASE9_EARLY_EXIT and at_close == later, (n, at_close, later)
        assert len(early_msgs) == 1, "the abandoned worker wrote to the messages"
        again = _counted(total, lambda: list(rag(fresh(), config=large_cfg)))
        assert again == want, "rag() after the early exit gives another answer"
    finally:
        rag_mod._async_rag_native = native
    log(f"phase 9 (e) async_rag on jax:large (the bridge): {len(tokens)} pieces = rag()'s greedy answer, first piece "
        f"after {first_ms:.1f} ms (phase 6's rag(): {rag_first_ms:.1f} ms), all in {bridge_ms:.1f} ms; an early exit "
        f"after {PHASE9_EARLY_EXIT} pieces: no kernel launched in the 0.5 s after aclose() (counts {at_close}), the messages untouched, "
        f"and rag() again the same answer, on {card}")
    return {"first_ms": first_ms, "bridge_ms": bridge_ms}


def _embed_stub():
    """A stdlib /embeddings stub on 127.0.0.1: a seeded 32-wide normal
    vector per text (the stub of tests/test_openai_embedder.py)."""
    import hashlib
    from http.server import BaseHTTPRequestHandler

    import numpy as np

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def do_POST(self) -> None:  # noqa: N802
            payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length", "0"))))
            data = []
            for i, text in enumerate(payload["input"]):
                seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "big")
                data.append({"index": i, "embedding": np.random.default_rng(seed).normal(size=32).tolist()})
            body = json.dumps({"data": data}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def _chat_stub():
    """A stdlib /chat/completions SSE stub on 127.0.0.1 (that of
    tests/test_openai_provider.py): a search_knowledge_base call for the
    last message while the request offers that tool, else the answer "stub
    streamed answer" in three deltas."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def do_POST(self) -> None:  # noqa: N802
            payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length", "0"))))
            tools = payload.get("tools") or []
            if tools and tools[0]["function"]["name"] == "search_knowledge_base":
                args = json.dumps({"query": payload["messages"][-1]["content"]})
                deltas = [
                    {"tool_calls": [{"index": 0, "id": "call_1", "function": {"name": "search_knowledge_base", "arguments": ""}}]},
                    {"tool_calls": [{"index": 0, "function": {"arguments": args[: len(args) // 2]}}]},
                    {"tool_calls": [{"index": 0, "function": {"arguments": args[len(args) // 2 :]}}]},
                ]
            else:
                deltas = [{"content": "stub "}, {"content": "streamed "}, {"content": "answer"}]
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            for delta in deltas:
                self.wfile.write(f"data: {json.dumps({'choices': [{'index': 0, 'delta': delta}]})}\n\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

    return Handler


def phase9_openai(texts: list[str], question: str, card: str) -> None:
    """Phase 9 (f): ``openai:`` on loopback stubs (no network): a store of
    the repo's documents embedded by the remote embedder, its index on the
    card, vector_search over it; then async_rag with ``llm="openai:..."``
    and a tool round, whose search runs on the card in the executor, on the
    native path (the bridge is made to fail).  Runs last: it replaces the
    cached ":memory:" store."""
    import asyncio
    import importlib
    import threading
    from http.server import ThreadingHTTPServer

    from raglite_tpu_torch import Document, RAGLiteConfig, async_rag, insert_documents, vector_search
    from raglite_tpu_torch.index.dense import dense_index_from_config

    rag_mod = importlib.import_module("raglite_tpu_torch.rag")
    servers = [ThreadingHTTPServer(("127.0.0.1", 0), handler()) for handler in (_embed_stub, _chat_stub)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for thread in threads:
        thread.start()
    bridge = rag_mod._async_rag_bridge

    def no_bridge(*args, **kwargs):
        msg = "async_rag took the thread bridge for an openai: LLM"
        raise AssertionError(msg)

    try:
        _fresh_memory_store()
        ports = [s.server_address[1] for s in servers]
        ocfg = RAGLiteConfig(
            store_path=":memory:", device="cuda",
            embedder=f"openai:http://127.0.0.1:{ports[0]}/v1#stub-embed",
            llm=f"openai:http://127.0.0.1:{ports[1]}/v1#stub-chat",
        )
        t0 = time.perf_counter()
        insert_documents([Document.from_text(t) for t in texts], config=ocfg)
        insert_s = time.perf_counter() - t0
        index = dense_index_from_config(ocfg)
        ids, scores = vector_search(question, num_results=5, config=ocfg)
        assert index.device.type == index._rows[0].device.type == "cuda" and len(ids) == 5, (index.device, ids)
        rag_mod._async_rag_bridge = no_bridge
        messages = [{"role": "user", "content": question}]
        retrieved = []

        async def collect():
            return [t async for t in async_rag(messages, on_retrieval=retrieved.extend, config=ocfg)]

        t0 = time.perf_counter()
        answer = "".join(asyncio.run(collect()))
        rag_ms = (time.perf_counter() - t0) * 1e3
        assert answer == "stub streamed answer", answer
        assert [m["role"] for m in messages] == ["user", "assistant", "tool", "assistant"], messages
        assert retrieved and all(c.id in index.chunk_ids for span in retrieved for c in span.chunks)
    finally:
        rag_mod._async_rag_bridge = bridge
        for server in servers:
            server.shutdown()
            server.server_close()
        for thread in threads:
            thread.join(timeout=10)
    log(f"phase 9 (f) openai: on 127.0.0.1 stubs: {index.num_rows} rows of d = {index.dim} from the remote embedder "
        f"inserted in {insert_s:.2f} s, index on {index.device}, vector_search top-5 found; async_rag (native path, "
        f"a tool round searching on the card, {len(retrieved)} spans) in {rag_ms:.1f} ms, on {card}")


# --- Phase 10: real checkpoints on the card ----------------------------------

#: Qwen/Qwen3-4B's published config.json (every field the loader reads).
QWEN3_4B_CONFIG = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "num_hidden_layers": 36, "hidden_size": 2560,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128, "intermediate_size": 9728,
    "vocab_size": 151936, "tie_word_embeddings": True, "rope_theta": 1000000, "rms_norm_eps": 1e-06,
    "max_position_embeddings": 40960, "hidden_act": "silu", "attention_bias": False, "rope_scaling": None,
    "sliding_window": None, "use_sliding_window": False, "max_window_layers": 36, "bos_token_id": 151643,
    "eos_token_id": 151645, "torch_dtype": "bfloat16",
}
#: BAAI/bge-m3's published config.json (XLM-RoBERTa large, 8,194 positions).
BGE_M3_CONFIG = {
    "architectures": ["XLMRobertaModel"], "model_type": "xlm-roberta", "num_hidden_layers": 24, "hidden_size": 1024,
    "num_attention_heads": 16, "intermediate_size": 4096, "vocab_size": 250002, "max_position_embeddings": 8194,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "type_vocab_size": 1, "layer_norm_eps": 1e-05,
    "hidden_act": "gelu", "position_embedding_type": "absolute",
}
#: Qwen2/Qwen3's pre-tokenizer Split pattern (their tokenizer.json).
QWEN_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
#: Qwen's ChatML special tokens and their ids.
QWEN_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645}
#: BPE merges phase 10 learns from the repo's Markdown for its tokenizer.json.
PHASE10_MERGES = 4000
#: Background rows of phase 10 (e)'s d = 1,024 store (phase 3's count).
PHASE10_ROWS = 1_249_280
#: Phase 10 (b): the 2,048-token forward's logits with the attention kernels
#: against the same forward with each attention op's plain version (f32
#: softmax, the probabilities rounded to bf16): the residual stream is bf16,
#: so the two differ by bf16 roundings that 36 layers carry to the logits
#: (unit-RMS hidden state, logits of std ~1).  Bounds: top-1 equal on at
#: least this share of positions, and no logit further apart than this.
PHASE10_TOP1_MIN = 0.9
PHASE10_LOGIT_ATOL = 0.5
#: Phase 10 (e): the two routes score a chunk from the same bf16 row and
#: bf16-rounded query in f32, in other summation orders (a GEMM over all rows
#: against a gathered bmm), so a unit query and unit row's scores may differ
#: by 2 * d * 2^-24 (1.22e-4 at d = 1,024): a chunk scored within this of
#: the exact route's 10th is one of its top 10 under another summation order
#: or tie order, and counts as a hit beside the recall by ids.
TIE_ATOL = 2 * 1024 * 2.0**-24


def _markdown_texts() -> list[str]:
    return [(ROOT / f).read_text(encoding="utf-8") for f in FROZEN_DOCS]


def scratch_dir(need: int, prefix: str) -> Path:
    """A temporary directory on a file system with ``need`` bytes free:
    the temporary directory's, else /dev/shm; neither is an error."""
    import shutil
    import tempfile

    for base in (tempfile.gettempdir(), "/dev/shm"):
        if Path(base).is_dir() and shutil.disk_usage(base).free >= need * 1.1:
            return Path(tempfile.mkdtemp(prefix=prefix, dir=base))
    free = {b: shutil.disk_usage(b).free for b in (tempfile.gettempdir(), "/dev/shm") if Path(b).is_dir()}
    msg = f"no file system holds {need / 1e9:.2f} GB for phase 10's checkpoint (free bytes: {free})"
    raise RuntimeError(msg)


#: Torch threads of a CPU half that runs beside the card's work (the card's
#: machine has 8 cores; the rest stay with the process driving the card,
#: whose work beside it is mostly one host thread).
BESIDE_THREADS = 6


@contextlib.contextmanager
def beside(function: str, *args):
    """Run this script's ``function(*args)`` (JSON arguments and result) on
    the CPU in a process of its own, with no card visible and BESIDE_THREADS
    torch threads, while the caller goes on with the card's work.  Yields
    ``join(timeout)``, which waits for the process, prints its output and
    returns (its result, its seconds from start to exit); the process is
    killed if the caller leaves first."""
    import os
    import shutil
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="beside_"))
    code = ("import json, sys, torch; torch.set_num_threads(int(sys.argv[3])); import chip_smoke; "
            "json.dump(getattr(chip_smoke, sys.argv[1])(*json.loads(sys.argv[2])), open(sys.argv[4], 'w'))")
    t0 = time.perf_counter()
    with open(out / "log", "w") as sink:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, function, json.dumps(args), str(BESIDE_THREADS), str(out / "result.json")],
            cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, stdout=sink, stderr=subprocess.STDOUT,
        )

    def join(timeout: float):
        rc = proc.wait(timeout=timeout)
        seconds = time.perf_counter() - t0
        text = (out / "log").read_text()
        log(f"{function}(...) on the CPU beside the card's work, exit {rc} after {seconds:.1f} s; its output:\n{text.rstrip()}")
        if rc:
            msg = f"{function} on the CPU exited {rc}"
            raise RuntimeError(msg)
        return json.loads((out / "result.json").read_text()), seconds

    try:
        yield join
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        shutil.rmtree(out, ignore_errors=True)


def learn_bpe_merges(texts: list[str], count: int) -> list[tuple[str, str]]:
    """``count`` byte-level BPE merges learned from ``texts`` as Qwen's
    tokenizer splits them (NFC, the Split pattern, GPT-2's byte map): the
    most frequent adjacent pair first, ties by the pair's order; pair counts
    kept up to date word by word (a heap of counts, stale entries skipped)."""
    import heapq
    import re
    import unicodedata
    from collections import Counter, defaultdict

    from raglite_tpu_torch.models.tokenizer import _bytes_to_unicode, _translate_regex

    split, byte_map = re.compile(_translate_regex(QWEN_SPLIT)), _bytes_to_unicode()
    freq = Counter(
        "".join(byte_map[b] for b in w.encode("utf-8"))
        for text in texts for w in split.findall(unicodedata.normalize("NFC", text))
    )
    words = [list(w) for w in freq]
    counts = list(freq.values())
    pairs: Counter = Counter()
    where: dict = defaultdict(set)
    for i, w in enumerate(words):
        for pair in zip(w, w[1:]):
            pairs[pair] += counts[i]
            where[pair].add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges: list[tuple[str, str]] = []
    while heap and len(merges) < count:
        c, pair = heapq.heappop(heap)
        if -c != pairs.get(pair, 0):
            continue  # stale
        if -c < 2:
            break
        merges.append(pair)
        joined = pair[0] + pair[1]
        touched = set()
        for i in sorted(where.pop(pair)):
            w, f = words[i], counts[i]
            for p in zip(w, w[1:]):
                pairs[p] -= f
                touched.add(p)
            out, j = [], 0
            while j < len(w):
                if j + 1 < len(w) and (w[j], w[j + 1]) == pair:
                    out.append(joined)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            words[i] = out
            for p in zip(out, out[1:]):
                pairs[p] += f
                where[p].add(i)
                touched.add(p)
        del pairs[pair]
        for p in touched:
            if pairs.get(p, 0) > 0:
                heapq.heappush(heap, (-pairs[p], p))
    return merges


def qwen_tokenizer_json(texts: list[str], merges: int = PHASE10_MERGES) -> dict:
    """A Qwen2-style tokenizer.json made by hand (the card has no
    ``tokenizers``): NFC, Qwen's Split (Isolated) then ByteLevel without its
    regex, the 256 byte tokens (ids 0-255) and merges learned from
    ``texts``, unused tokens up to 151,642, the ChatML specials at Qwen's
    ids, the ByteLevel decoder."""
    from raglite_tpu_torch.models.tokenizer import _bytes_to_unicode

    byte_map = _bytes_to_unicode()
    vocab = {byte_map[b]: b for b in range(256)}
    learned = learn_bpe_merges(texts, merges)
    for a, b in learned:
        vocab.setdefault(a + b, len(vocab))
    # Unused tokens up to Qwen's first special id: ``tokenizers`` numbers
    # added tokens after the model's vocabulary, so this keeps them at
    # Qwen's ids (and config.json's bos/eos).
    first_special = min(QWEN_SPECIALS.values())
    vocab.update({f"<|unused_{i}|>": i for i in range(len(vocab), first_special)})
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False, "special": True}
            for t, i in QWEN_SPECIALS.items()
        ],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN_SPLIT}, "behavior": "Isolated", "invert": False}, byte_level,
        ]},
        "post_processor": None,
        "decoder": byte_level,
        "model": {
            "type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "", "end_of_word_suffix": "",
            "fuse_unk": False, "byte_fallback": False, "ignore_merges": False, "vocab": vocab,
            "merges": [[a, b] for a, b in learned],
        },
    }


def precompiled_charsmap(mapping: dict[str, str]) -> bytes:
    """A SentencePiece ``precompiled_charsmap`` made by hand (what the
    ``Precompiled`` normalizer of an XLM-R tokenizer.json holds, base64):
    the byte size of the trie as a little-endian u32, the trie as a
    darts-clone double array of u32 units over the keys' UTF-8 bytes, then
    the replacements, each ending in a NUL.  A unit holds its label in bits
    0-7 (bit 31 set on a leaf, whose low 31 bits are the replacement's
    offset), a has-leaf flag in bit 8 and its offset to its children in bits
    10-30; a child of the node at ``p`` with label ``c`` sits at ``p ^
    offset ^ c``, its leaf at ``p ^ offset``."""
    import struct

    blob, value_of = bytearray(), {}
    for value in sorted(set(mapping.values())):
        value_of[value] = len(blob)
        blob += value.encode("utf-8") + b"\0"
    trie: dict = {}
    for key, value in mapping.items():
        if not key:
            msg = "an empty key"
            raise ValueError(msg)
        node = trie
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[-1] = value_of[value]
    units, used, bases = [0] * 256, bytearray(256), set()
    used[0] = 1
    free = 1  # no slot below this is free
    stack = [(trie, 0)]
    while stack:
        node, pos = stack.pop()
        labels = sorted(k for k in node if k != -1)
        slots = ([0] if -1 in node else []) + labels
        while used[free]:
            free += 1
        q = free
        while True:  # the first base whose slots are all free
            base = q ^ slots[0]
            if base not in bases and base > 0 and all(base ^ c >= len(used) or not used[base ^ c] for c in slots):
                break
            q += 1
            while q < len(used) and used[q]:
                q += 1
        bases.add(base)
        end = (base | 0xFF) + 1
        if end > len(units):
            units.extend([0] * (end - len(units)))
            used.extend(bytes(end - len(used)))
        offset = pos ^ base
        if offset >= 1 << 21:
            msg = "charsmap too large for offsets without the extension bit"
            raise ValueError(msg)
        units[pos] |= offset << 10
        if -1 in node:
            units[pos] |= 1 << 8
            units[base] = node[-1] | (1 << 31)
            used[base] = 1
        for c in labels:
            units[base ^ c] = c
            used[base ^ c] = 1
            stack.append((node[c], base ^ c))
    return struct.pack(f"<I{len(units)}I", 4 * len(units), *units) + bytes(blob)


def nfkc_charsmap(texts: list[str]) -> bytes:
    """An NFKC-style charsmap over the characters of ``texts``: each
    character NFKC changes to its NFKC form, each whitespace character other
    than the space to a space, and each base letter + combining mark pair
    of the texts to its NFC composition (multi-character keys)."""
    import unicodedata

    chars = {c for text in texts for c in text}
    mapping = {c: unicodedata.normalize("NFKC", c) for c in chars if unicodedata.normalize("NFKC", c) != c}
    mapping.update({c: " " for c in chars if c.isspace() and c not in " \n"})
    for text in texts:
        decomposed = unicodedata.normalize("NFD", text)
        for a, b in zip(decomposed, decomposed[1:]):
            if unicodedata.combining(b) and not unicodedata.combining(a):
                mapping[a + b] = unicodedata.normalize("NFKC", a + b)
    return precompiled_charsmap(mapping)


def unigram_tokenizer_json(texts: list[str], pieces: int = 30_000) -> dict:
    """An XLM-R-style Unigram tokenizer.json made by hand: XLM-R's special
    pieces (<s>, <pad>, </s>, <unk> at 0-3, <mask> last), the ``pieces`` most
    frequent Metaspace words of ``texts`` and every character, scored by
    their log-frequency; XLM-R's normalizer (a ``Precompiled`` charsmap,
    here :func:`nfkc_charsmap` over the characters of ``texts``, then runs
    of spaces replaced by one); the Metaspace pre-tokenizer and decoder."""
    import base64
    import math
    from collections import Counter

    words: Counter = Counter()
    chars: Counter = Counter()
    for text in texts:
        for word in text.replace(" ", "▁").split("▁"):
            if word:
                words["▁" + word] += 1
                chars.update(word)
    total = sum(words.values()) + sum(chars.values())
    vocab = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    vocab += [[w, math.log(c / total)] for w, c in words.most_common(pieces) if len(w) > 2]
    vocab += [[c, math.log(n / total) - 2.0] for c, n in sorted(chars.items())]
    vocab += [["▁", math.log(0.5 / total)], ["<mask>", 0.0]]
    metaspace = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}
    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False, "special": True}
            for i, t in [*enumerate(specials), (len(vocab) - 1, "<mask>")]
        ],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(nfkc_charsmap(texts)).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "},
        ]},
        "pre_tokenizer": metaspace, "post_processor": None, "decoder": metaspace,
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False},
    }


def _seeded(g, shape, std: float, dtype=None):
    import torch

    return (torch.randn(shape, generator=g, device=g.device, dtype=torch.float32) * std).to(dtype or torch.bfloat16)


def write_qwen3_checkpoint(path: Path, seed: int, *, shards: int = 3, config: dict = QWEN3_4B_CONFIG, device: str = "cuda") -> int:
    """A Qwen3-4B-shaped BF16 checkpoint in seeded random weights (HF names
    and [out, in] layout; matrices N(0, 1/fan_in), the tied embedding N(0,
    0.02^2), unit norms) in ``shards`` files with their index, written with
    the port's own safetensors writer, shard by shard from the card.
    Returns the bytes of weights."""
    import torch

    from raglite_tpu_torch.models.safetensors_io import save_file

    c = config
    d, hd, ff = c["hidden_size"], c["head_dim"], c["intermediate_size"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (c["vocab_size"], d), "model.norm.weight": (d,)}
    for i in range(c["num_hidden_layers"]):
        b = f"model.layers.{i}."
        shapes.update({
            b + "input_layernorm.weight": (d,), b + "post_attention_layernorm.weight": (d,),
            b + "self_attn.q_proj.weight": (q, d), b + "self_attn.k_proj.weight": (kv, d),
            b + "self_attn.v_proj.weight": (kv, d), b + "self_attn.o_proj.weight": (d, q),
            b + "self_attn.q_norm.weight": (hd,), b + "self_attn.k_norm.weight": (hd,),
            b + "mlp.gate_proj.weight": (ff, d), b + "mlp.up_proj.weight": (ff, d), b + "mlp.down_proj.weight": (d, ff),
        })
    total = sum(2 * math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    path.mkdir(parents=True, exist_ok=True)
    names, weight_map, written = list(shapes), {}, 0
    per_shard = -(-total // shards)
    for k in range(shards):
        part: dict[str, torch.Tensor] = {}
        size = 0
        while names and (size < per_shard or k == shards - 1):
            name = names.pop(0)
            shape = shapes[name]
            if len(shape) == 1:
                part[name] = torch.ones(shape, dtype=torch.bfloat16, device=device)
            else:
                part[name] = _seeded(g, shape, 0.02 if "embed" in name else shape[1] ** -0.5)
            size += 2 * math.prod(shape)
        file = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        save_file(part, path / file, {"format": "pt"})
        weight_map.update({n: file for n in part})
        written += size
        del part
    (path / "model.safetensors.index.json").write_text(json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps(c))
    return written


def write_bge_m3_checkpoint(path: Path, seed: int, *, config: dict = BGE_M3_CONFIG, device: str = "cuda", dtype=None) -> int:
    """A bge-m3-shaped BF16 XLM-R encoder (or, with another config, any
    BERT-family one: phase 13's bge-base) in seeded random weights (HF
    names, 0.02-scaled embeddings, N(0, 1/fan_in) matrices, small biases,
    unit LayerNorms, a pooler the loader skips) as one model.safetensors;
    ``dtype`` (default bfloat16) float32 writes a file the JAX package's
    loader reads too (it reads no bfloat16)."""
    import torch

    from raglite_tpu_torch.models.safetensors_io import save_file

    c = config
    d, ff = c["hidden_size"], c["intermediate_size"]
    g = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype or torch.bfloat16
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)  # noqa: E731
    seeded = functools.partial(_seeded, dtype=dtype)
    t = {
        "embeddings.word_embeddings.weight": seeded(g, (c["vocab_size"], d), 0.02),
        "embeddings.position_embeddings.weight": seeded(g, (c["max_position_embeddings"], d), 0.02),
        "embeddings.token_type_embeddings.weight": seeded(g, (c["type_vocab_size"], d), 0.02),
        "embeddings.LayerNorm.weight": ones(d), "embeddings.LayerNorm.bias": seeded(g, (d,), 0.02),
    }
    for i in range(c["num_hidden_layers"]):
        b = f"encoder.layer.{i}."
        for name, (out, inp) in {
            "attention.self.query": (d, d), "attention.self.key": (d, d), "attention.self.value": (d, d),
            "attention.output.dense": (d, d), "intermediate.dense": (ff, d), "output.dense": (d, ff),
        }.items():
            t[b + name + ".weight"] = seeded(g, (out, inp), inp**-0.5)
            t[b + name + ".bias"] = seeded(g, (out,), 0.02)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[b + name + ".weight"], t[b + name + ".bias"] = ones(d), seeded(g, (d,), 0.02)
    t["pooler.dense.weight"], t["pooler.dense.bias"] = seeded(g, (d, d), d**-0.5), seeded(g, (d,), 0.02)
    path.mkdir(parents=True, exist_ok=True)
    save_file(t, path / "model.safetensors", {"format": "pt"})
    (path / "config.json").write_text(json.dumps(c))
    return sum(x.numel() * x.element_size() for x in t.values())


def _release_llms() -> None:
    """Drop every cached LLM (phase 6's `large` among them) and return its
    memory to the card."""
    import gc

    import torch

    from raglite_tpu_torch.models.llm import _make_llm

    _make_llm.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def _plain_attention():
    """A context in which the decoder's three attention ops are their plain
    versions, on the card too (phase 10 (b)'s reference forward)."""
    import contextlib

    from raglite_tpu_torch.models import decoder as dec
    from raglite_tpu_torch.ops.decode_attention import gqa_attention_plain

    @contextlib.contextmanager
    def swapped():
        saved = dec.gqa_decode_attention, dec.gqa_verify_attention, dec.gqa_prefill_attention
        dec.gqa_decode_attention = lambda q, k, v, pos, **kw: gqa_attention_plain(q[:, :, :, None], k, v, pos, **kw)[:, :, :, 0]
        dec.gqa_verify_attention = dec.gqa_prefill_attention = gqa_attention_plain
        try:
            yield
        finally:
            dec.gqa_decode_attention, dec.gqa_verify_attention, dec.gqa_prefill_attention = saved

    return swapped()


def _forward_logits(llm, ids):
    """The whole model's logits [T, V] f32 of one prompt (a prefill forward,
    every position unembedded)."""
    import torch

    cache = llm.model.init_cache(1, ids.shape[1], device="cuda")
    with torch.inference_mode():
        logits, _ = llm.model.forward(llm.params, ids, cache, 0)
    return logits[0]


def _f32_logits(llm, ids):
    """The logits [T, V] of ``llm``'s single-device forward of one prompt in
    f32: an f32 copy of its weights (dropped on return), f32 caches, f32
    matmuls (TF32 off) and each attention op's plain version."""
    import torch

    from raglite_tpu_torch.utils.precision import full_f32_matmul

    def f32(x):
        return x.to(torch.float32) if isinstance(x, torch.Tensor) else x

    params = {k: f32(v) for k, v in llm.params.items() if k != "layers"}
    params["layers"] = [{k: f32(v) for k, v in layer.items()} for layer in llm.params["layers"]]
    cache = llm.model.init_cache(1, ids.shape[1], dtype=torch.float32, device="cuda")
    with torch.inference_mode(), full_f32_matmul(), _plain_attention():
        logits, _ = llm.model.forward(params, ids, cache, 0)
    return logits[0]


def time_int8_matmuls(card: str, seed: int) -> list[dict]:
    """W8A8 and W8A16 at Qwen3-4B's decode shapes (1 and 8 rows) beside the
    bf16 matmul of the same shape and the bytes bound of each (the int8 or
    bf16 weight read once, scales, activations and the f32 output); every
    call reads the next of enough weight copies to leave the 50 MB L2."""
    import itertools

    import torch

    from raglite_tpu_torch.ops.quant_matmul import QuantLinear, int8_matmul_w8a8, int8_matmul_xla

    g = torch.Generator(device="cuda").manual_seed(seed + 10)
    shapes = {"lm_head": (2560, 151936), "wqkv": (2560, 6144), "w_gate_up": (2560, 19456), "w_down": (9728, 2560), "wo": (4096, 2560)}
    out = []
    for name, (k, n) in shapes.items():
        copies = max(1, -(-200_000_000 // (k * n)))
        # [K, N] views of [N, K] storage: the layout of a loaded checkpoint's
        # matrices (HF's [out, in], transposed as a view).
        dense = [_seeded(g, (n, k), k**-0.5).T for _ in range(copies)]
        quant = [QuantLinear.from_dense(w) for w in dense]
        for rows in (1, 8):
            x = _seeded(g, (rows, k), 1.0)
            ref = x.float() @ quant[0].dense(torch.float32)[:k]
            err = {
                "w8a8": float((int8_matmul_w8a8(x, quant[0].q8, quant[0].s8)[:, :n] - ref).abs().max() / ref.abs().max()),
                "w8a16": float((int8_matmul_xla(x, quant[0].q8, quant[0].s8)[:, :n] - ref).abs().max() / ref.abs().max()),
            }
            nq, nd = itertools.cycle(quant), itertools.cycle(dense)
            w8a8_ms = median_ms(lambda: (lambda w: int8_matmul_w8a8(x, w.q8, w.s8))(next(nq)))
            w8a16_ms = median_ms(lambda: (lambda w: int8_matmul_xla(x, w.q8, w.s8))(next(nq)))
            bf16_ms = median_ms(lambda: x @ next(nd))
            io = rows * k * 2 + rows * n * 4
            int8_bound = (k * n + 4 * n + io) / PEAK_BYTES_PER_S * 1e3
            bf16_bound = (2 * k * n + io) / PEAK_BYTES_PER_S * 1e3
            entry = {"name": name, "K": k, "N": n, "rows": rows, "w8a8_ms": w8a8_ms, "w8a16_ms": w8a16_ms,
                     "bf16_ms": bf16_ms, "int8_bound_ms": int8_bound, "bf16_bound_ms": bf16_bound, "rel_err": err}
            out.append(entry)
            log(f"phase 10 (d) {name} [{rows} x {k}] @ [{k} x {n}] on {card}: W8A8 {w8a8_ms:.4f} ms, W8A16 {w8a16_ms:.4f} ms, "
                f"bf16 torch.matmul {bf16_ms:.4f} ms; bytes bound int8 {int8_bound:.4f} ms, bf16 {bf16_bound:.4f} ms "
                f"(3.35 TB/s); largest error against the f32 product of the dequantized weight, relative to its largest "
                f"entry: {err} ({copies} weight copies rotated)")
        del dense, quant
        torch.cuda.empty_cache()
    return out


def phase10_decoder(cfg, question: str, rag_messages, seed: int, card: str, total: dict[str, int]) -> dict:
    """Phase 10 (a)-(d): a Qwen3-4B-shaped BF16 checkpoint written, loaded
    through ``jax:hf:<dir>``, held against plain attention, answering
    rag() and the BPE branches, timed at its attention shapes, then loaded
    again ``@int8``.  ``total`` gathers the kernel launches of the path."""
    import dataclasses
    import shutil

    import torch

    from raglite_tpu_torch.extract import extract_json
    from raglite_tpu_torch.models.llm import ToolCall, llm_from_config

    out: dict = {}
    # (a) The checkpoint and its tokenizer.json.
    need = 2 * (151936 * 2560 + 36 * (2 * 2560 * 4096 + 2 * 2560 * 1024 + 3 * 2560 * 9728)) + 100_000_000
    root = scratch_dir(need, "qwen3_4b_")
    try:
        t0 = time.perf_counter()
        texts = _markdown_texts()
        tok = qwen_tokenizer_json(texts)
        (root / "tokenizer.json").write_text(json.dumps(tok))
        tok_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        written = write_qwen3_checkpoint(root, seed)
        write_s = time.perf_counter() - t0
        out["write_s"], out["write_gb"] = write_s, written / 1e9
        log(f"phase 10 (a) Qwen3-4B-shaped BF16 checkpoint ({QWEN3_4B_CONFIG['num_hidden_layers']} layers, d "
            f"{QWEN3_4B_CONFIG['hidden_size']}, GQA {QWEN3_4B_CONFIG['num_attention_heads']}/"
            f"{QWEN3_4B_CONFIG['num_key_value_heads']}, tied 151,936 vocabulary) in {root.parent}: {written / 1e9:.3f} GB "
            f"in 3 shards written in {write_s:.1f} s; tokenizer.json ({len(tok['model']['merges'])} merges learned from "
            f"{len(texts)} Markdown files, vocabulary {len(tok['model']['vocab'])} + 3 specials) in {tok_s:.1f} s")

        # (b) Load through the factory; kernels against plain attention.
        spec = f"jax:hf:{root}"
        hf_cfg = dataclasses.replace(cfg, llm=spec)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        llm = llm_from_config(hf_cfg)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        assert llm.cfg["kv_heads"] == 8 and llm.cfg["heads"] // llm.cfg["kv_heads"] == 4 and not llm._byte_level
        assert llm.params["lm_head"].data_ptr() == llm.params["tok_emb"].data_ptr()  # tied: a view, no copy
        out["load_s"], out["load_peak_gb"] = load_s, peak / 1e9
        log(f"phase 10 (b) TorchChatLLM('hf:...') through the factory: loaded in {load_s:.2f} s, peak "
            f"{peak / 1e9:.3f} GB above what was held ({_weight_bytes(llm.params) / 1e9:.3f} GB of weights; the tied "
            f"lm_head a view of the embedding), stop ids {sorted(llm._stop_ids)}, on {card}")
        ids = torch.tensor([llm.tokenizer.encode("\n\n".join(texts)[:60_000])[:2048]], device="cuda")
        assert ids.shape[1] == 2048, ids.shape
        launches: dict[str, int] = {}
        kernel_logits = _counted(launches, lambda: _forward_logits(llm, ids))
        assert launches["gqa_prefill_attention"] == 36, launches
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        with _plain_attention():
            plain_logits = _forward_logits(llm, ids)
        diff = float((kernel_logits - plain_logits).abs().max())
        top1 = kernel_logits.argmax(dim=-1)
        agree = float((top1 == plain_logits.argmax(dim=-1)).float().mean())
        scale = float(plain_logits.float().std())
        del plain_logits
        out["logits_max_abs_diff"], out["top1_share"] = diff, agree
        log(f"phase 10 (b) a 2,048-token prompt's forward (REP 4, KVH 8, hd 128; prefill kernel {launches}) against "
            f"the same forward with plain attention, both on {card}: max |logit difference| {diff:.4f} (logit std "
            f"{scale:.3f}; bound {PHASE10_LOGIT_ATOL}), top-1 equal at {agree:.4f} of 2,048 positions (bound "
            f"{PHASE10_TOP1_MIN})")
        assert torch.isfinite(kernel_logits).all() and agree >= PHASE10_TOP1_MIN and diff <= PHASE10_LOGIT_ATOL, (diff, agree)
        del kernel_logits

        # (c) rag() with phase 6's prompt, then the BPE branches.
        answer = serve_rag(cfg, question, card, spec=spec, messages=rag_messages)  # counts its own launches
        for name, count in answer["launches"].items():
            total[name] = total.get(name, 0) + count
        out["rag"] = {k: answer[k] for k in ("rag_t", "rag_s", "encode_ms", "ttft_ms", "prefill_ms", "step_ms", "tokens_per_s", "common_prefix")}
        user = [{"role": "user", "content": f"Describe this sentence as JSON: {question}"}]
        t0 = time.perf_counter()
        content = _counted(total, lambda: llm.complete(
            user, response_format={"type": "json_schema", "json_schema": {"name": "Sentence", "schema": PHASE8_SCHEMA}},
            max_tokens=64,
        ).content)
        rf_ms = (time.perf_counter() - t0) * 1e3
        assert isinstance(content, str), content
        tools = [{"type": "function", "function": {
            "name": "search_knowledge_base", "description": "Search the knowledge base.",
            "parameters": {"type": "object", "properties": {"query": {"type": "string"}}, "required": ["query"]},
        }}]
        t0 = time.perf_counter()
        items = _counted(total, lambda: list(llm.stream(user, tools=tools, tool_choice="required", max_tokens=48)))
        tool_ms = (time.perf_counter() - t0) * 1e3
        assert len(items) == 1 and isinstance(items[0], ToolCall) and items[0].name == "search_knowledge_base", items
        t0 = time.perf_counter()
        extracted = _counted(total, lambda: extract_json(
            METADATA_SCHEMA, "DocumentMetadata", METADATA_SYSTEM_PROMPT, lambda text: text, texts[0][:3000],
            config=hf_cfg, max_tokens=64,
        ))
        extract_ms = (time.perf_counter() - t0) * 1e3
        assert isinstance(extracted, str), extracted
        log(f"phase 10 (c) BPE branches on {card}: complete(response_format=...) with the schema in the prompt "
            f"{rf_ms:.1f} ms ({content[:60]!r}); a forced tool call through the prompt {tool_ms:.1f} ms "
            f"({items[0].name}({items[0].arguments[:60]})); extract_json (extract_with_llm's core, the schema in the "
            f"prompt, the answer kept as text) {extract_ms:.1f} ms")

        # The attention kernels at this model's shapes (REP 4, KVH 8): the
        # answer's own, then at the 8,192-token bucket (S = 8,352) whatever
        # length the retrieved prompt has (it follows the docs the store
        # holds).
        cases = [
            ("gqa_decode_attention", 1, answer["rag_s"], [answer["rag_pos"]]),
            ("gqa_verify_attention", 8, answer["rag_s"], [answer["rag_pos"]]),
            ("gqa_prefill_attention", answer["rag_t"], answer["rag_s"], [0]),
        ]
        if answer["rag_s"] != 8352:
            cases += [
                ("gqa_decode_attention", 1, 8352, [8192 + 40]),
                ("gqa_verify_attention", 8, 8352, [8192]),
                ("gqa_prefill_attention", 8192, 8352, [0]),
            ]
        out["timings"] = time_attention(
            seed + 10, answer["rag_s"], answer["rag_pos"], answer["rag_t"], card, kvh=8, rep=4, cases=cases,
        )

        # (d) The same checkpoint @int8.
        del llm
        _release_llms()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        llm8 = llm_from_config(dataclasses.replace(cfg, llm=spec + "@int8"))
        torch.cuda.synchronize()
        load8_s = time.perf_counter() - t0
        peak8 = torch.cuda.max_memory_allocated() - before
        held8 = torch.cuda.memory_allocated() - before
        int8_logits = _counted(total, lambda: _forward_logits(llm8, ids))
        agree8 = float((int8_logits.argmax(dim=-1) == top1).float().mean())
        del int8_logits
        out["int8"] = {"load_s": load8_s, "peak_gb": peak8 / 1e9, "held_gb": held8 / 1e9, "top1_share": agree8}
        log(f"phase 10 (d) hf:...@int8 on {card}: loaded and quantized layer by layer in {load8_s:.2f} s, "
            f"{_weight_bytes(llm8.params) / 1e9:.3f} GB of weights held ({held8 / 1e9:.3f} GB allocated), peak "
            f"{peak8 / 1e9:.3f} GB above what was held before; top-1 of the 2,048-token forward equal to the bf16 "
            f"kernels' at {agree8:.4f} of positions")
        answer8 = serve_rag(cfg, question, card, spec=spec + "@int8", messages=rag_messages)
        for name, count in answer8["launches"].items():
            total[name] = total.get(name, 0) + count
        out["int8"]["rag"] = {k: answer8[k] for k in ("ttft_ms", "prefill_ms", "step_ms", "tokens_per_s", "common_prefix")}
        del llm8
        _release_llms()
        out["int8"]["matmuls"] = time_int8_matmuls(card, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase10_encoder(texts: list[str], queries: list[str], rows: int, seed: int, card: str, total: dict[str, int]) -> dict:
    """Phase 10 (e): a bge-m3-shaped BF16 encoder written and served as
    ``flax:<dir>``: the phase-3 documents into a fresh store, background rows
    at d = 1,024 up to ``rows``, vector_search (int4 route) against the
    exact route, rerank_chunks and search_and_rerank_chunk_spans.  Replaces
    the phase-3 store."""
    import gc
    import shutil

    import torch

    from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents
    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.search import corrected_num_hits, rerank_chunks, search_and_rerank_chunk_spans, vector_search
    from raglite_tpu_torch.store import store_from_config

    _fresh_memory_store()
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {}
    root = scratch_dir(1_300_000_000, "bge_m3_")
    try:
        t0 = time.perf_counter()
        (root / "tokenizer.json").write_text(json.dumps(unigram_tokenizer_json(_markdown_texts())))
        written = write_bge_m3_checkpoint(root, seed + 20)
        write_s = time.perf_counter() - t0
        ecfg = RAGLiteConfig(store_path=":memory:", device="cuda", embedder=f"flax:{root}")
        t0 = time.perf_counter()
        insert_documents([Document.from_text(t) for t in texts], config=ecfg)
        insert_s = time.perf_counter() - t0
        store = store_from_config(ecfg)
        doc_rows = sum(m.shape[0] for m in store.embeddings.values())
        t0 = time.perf_counter()
        add_background(store, rows - doc_rows, seed + 20, dim=1024)
        background_s = time.perf_counter() - t0
        index = dense_index_from_config(ecfg)
        assert index.dim == 1024 and index.num_rows == rows, (index.dim, index.num_rows)
        log(f"phase 10 (e) bge-m3-shaped BF16 encoder (24 layers, d 1,024, 250,002 x 1,024 embedding, 8,192 positions): "
            f"{written / 1e9:.3f} GB and a Unigram tokenizer.json written in {write_s:.1f} s; {len(texts)} documents "
            f"({doc_rows} rows) inserted through flax:<dir> in {insert_s:.1f} s, {rows - doc_rows} background rows in "
            f"{background_s:.1f} s, on {card}")
        latencies, routes = [], set()

        def searches():
            for query in queries:
                t0 = time.perf_counter()
                vector_search(query, num_results=10, config=ecfg)
                latencies.append((time.perf_counter() - t0) * 1e3)
                routes.add(index.last_route)

        launches: dict[str, int] = {}
        _counted(launches, searches)
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        assert routes == {"int4_two_stage"} and launches["int4_bucket_scan"] == len(queries), (routes, launches)
        emb = embed_queries(queries, config=ecfg)
        hits = min(corrected_num_hits(4, 10, ecfg), index.num_rows)
        recalls, tie_recalls = [], []
        for b in range(len(queries)):
            routed = index.search_chunks_device(emb[b : b + 1], num_hits=hits, num_results=10)[1][0].tolist()
            scores, ordinals = index.search_chunks_device(emb[b : b + 1], num_hits=hits, num_results=hits, exact=True)
            exact_score = dict(zip(ordinals[0].tolist(), scores[0].tolist()))
            exact = set(ordinals[0, :10].tolist())
            tenth = float(scores[0, 9])
            recalls.append(len(set(routed) & exact) / len(exact))
            tie_recalls.append(sum(c in exact or exact_score.get(c, -math.inf) >= tenth - TIE_ATOL for c in routed) / 10)
            if set(routed) != exact:
                _recall_diagnosis(index, emb[b : b + 1], hits, queries[b], card)
        recall, tie_recall = statistics.mean(recalls), statistics.mean(tie_recalls)
        assert tie_recall >= RECALL_MIN, (recall, tie_recall)
        top20 = {q: vector_search(q, num_results=20, config=ecfg)[0] for q in queries}
        rerank_ms = []

        def reranks():
            for q in queries:
                t0 = time.perf_counter()
                reranked = rerank_chunks(q, top20[q], config=ecfg)
                torch.cuda.synchronize()
                rerank_ms.append((time.perf_counter() - t0) * 1e3)
                assert len(reranked) == len(top20[q]), (len(reranked), len(top20[q]))

        _counted(total, reranks)
        search_and_rerank_chunk_spans(queries[0], config=ecfg)  # the keyword index's first sync
        spans_p50 = _counted(total, lambda: _p50_ms(lambda q: search_and_rerank_chunk_spans(q, config=ecfg), queries))
        out.update({
            "vector_search_p50_ms": statistics.median(latencies), "recall_at_10": recall, "recall_at_10_ties": tie_recall,
            "rerank_p50_ms": statistics.median(rerank_ms), "search_and_rerank_p50_ms": spans_p50,
        })
        log(f"phase 10 (e) at d = 1,024 over {index.num_rows} rows on {card}: vector_search p50 "
            f"{out['vector_search_p50_ms']:.3f} ms over {len(queries)} queries (int4 route, launches {launches}), "
            f"recall@10 against the exact route {recall:.4f} by ids, {tie_recall:.4f} counting chunks tied with the "
            f"exact 10th (within {TIE_ATOL:.3g}) as hits; rerank_chunks of each query's top 20 p50 "
            f"{out['rerank_p50_ms']:.3f} ms (first calls, candidate states cached as they come); "
            f"search_and_rerank_chunk_spans (hybrid search) p50 {spans_p50:.3f} ms")
        out["timings"] = time_kernels(index, None, emb, card, dim=1024, batches=(1,))
        # Phase 10 (f)'s encoder half, while this store and encoder live.
        out.update(phase10_orbax_encoder(ecfg, queries, total, card))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _recall_diagnosis(index, query_emb, hits: int, query: str, card: str) -> None:
    """Where a query's int4-route chunks differ from the exact route's: the
    two routes' top rows, the rows one has and the other lacks with their
    exact scores, and whether those rows were among the stage-1 candidates."""
    from raglite_tpu_torch.index.dense import _dense_search
    from raglite_tpu_torch.ops import fused_scan as fs

    index._refresh_device()
    index._ensure_packed4()
    q, valid, rows, sqnorm = index._queries(query_emb), index._valid[0], index._rows[0], index._sqnorm[0]
    scale = None if index._scale is None else index._scale[0]
    es, eid = _dense_search(rows, sqnorm, valid, q, scale, num_hits=hits, metric=index.metric)
    pool = max(fs.INT4_STAGE1_CANDIDATES, 2 * hits)
    cs_, cid = fs.int4_two_stage_block(
        index._packed4[0], index._scale4[0], rows, scale, sqnorm, valid, q,
        num_hits=pool, candidates=pool, metric=index.metric, num_buckets=fs.INT4_NUM_BUCKETS,
    )
    exact_rows, scores = eid[0].tolist(), es[0].tolist()
    routed_rows, routed_scores, pool_rows = cid[0, :hits].tolist(), cs_[0, :hits].tolist(), set(cid[0].tolist())
    chunk = index._dev_row_chunk
    missing = [(r, round(sc, 6), int(chunk[r]), r in pool_rows) for r, sc in zip(exact_rows, scores) if r not in routed_rows]
    extra = [(r, round(sc, 6), int(chunk[r])) for r, sc in zip(routed_rows, routed_scores) if r not in exact_rows]
    log(f"phase 10 (e) recall diagnosis for {query[:60]!r} on {card}: exact top-{hits} row scores "
        f"{scores[0]:.6f}..{scores[-1]:.6f}, int4 route's {routed_scores[0]:.6f}..{routed_scores[-1]:.6f}; rows only "
        f"exact (row, exact score, chunk, among the {pool} stage-1 candidates) {missing}; rows only int4 (row, "
        f"rescored score, chunk) {extra}")


#: The orbax checkpoint the JAX package wrote (scripts/orbax_fixture.py):
#: compressed zstd frames in OCDBT, read on the card's machine without
#: tensorstore or orbax.
ORBAX_FIXTURE = ROOT / "tests" / "data" / "orbax_tiny"
#: f32 logits of the fixture on the card (plain attention, TF32 off)
#: against the CPU's: the decoder tests' summation-order tolerance.
FIXTURE_LOGIT_TOL = 1e-4


def _same_bits(a, b) -> bool:
    """Equal dtypes, shapes and stored bits (bf16 and f32 as integers)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}.get(a.dtype)
    return bool(torch.equal(a.view(as_int), b.view(as_int)) if as_int else torch.equal(a, b))


def _tree_leaves(params) -> dict:
    """{name: tensor} of a decoder parameter dict (int8 layers as their
    blocks and scales)."""
    out = {}
    for k, v in params.items():
        if k == "layers":
            for i, layer in enumerate(v):
                out.update({f"layers.{i}.{n}": x for n, x in _tree_leaves(layer).items()})
        elif hasattr(v, "q8"):
            out[f"{k}.q8"], out[f"{k}.s8"] = v.q8, v.s8
        else:
            out[k] = v
    return out


def _logits_of(model, params, ids, cache_dtype=None):
    """The whole model's logits [T, V] of one prompt (a prefill forward;
    bf16 caches unless ``cache_dtype``)."""
    import torch

    cache = model.init_cache(1, ids.shape[1], dtype=cache_dtype or torch.bfloat16, device=ids.device)
    with torch.inference_mode():
        logits, _ = model.forward(params, ids, cache, 0)
    return logits[0]


def write_zarr3_checkpoint(path: Path, params, config: dict) -> int:
    """Write ``params`` (a tree of dicts and lists of torch tensors) and
    ``config`` as orbax's ``use_zarr3=True`` OCDBT checkpoint: each leaf one
    shard (``sharding_indexed``: one inner chunk, ``bytes`` little-endian
    and ``zstd`` as raw-block frames; a ``bytes`` + ``crc32c`` index at the
    end) in the port's OcdbtWriter database.  The package writes orbax's
    default zarr v2 only, as the JAX package's save does; this writer makes
    the zarr v3 layout that phase 10 (f) reads on the card, where orbax is
    absent.  Returns the bytes on disk."""
    import numpy as np
    import torch

    from raglite_tpu_torch import native
    from raglite_tpu_torch.models.checkpoint import _host, _leaves
    from raglite_tpu_torch.models.ocdbt import OcdbtWriter

    little = {"name": "bytes", "configuration": {"endian": "little"}}
    tree_metadata = {}
    with OcdbtWriter(path / "params") as writer:
        for keys, leaf in _leaves(params):
            t = _host(leaf)
            name, shape = ".".join(k for k, _ in keys), list(t.shape)
            dtype = "bfloat16" if t.dtype == torch.bfloat16 else t.reshape(-1)[:0].numpy().dtype.name
            frame = native.zstd_raw_frame(t.reshape(-1).view(torch.uint8).numpy())
            index = np.asarray([0, frame.size], "<u8").view(np.uint8)
            crc = np.frombuffer(native.crc32c(index).to_bytes(4, "little"), np.uint8)
            meta = {
                "zarr_format": 3, "node_type": "array", "shape": shape, "data_type": dtype,
                "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": shape}},
                "chunk_key_encoding": {"name": "default"},
                "fill_value": False if dtype == "bool" else 0.0 if t.is_floating_point() else 0,
                "codecs": [{"name": "sharding_indexed", "configuration": {
                    "chunk_shape": shape, "codecs": [little, {"name": "zstd", "configuration": {"level": 0, "checksum": False}}],
                    "index_codecs": [little, {"name": "crc32c"}], "index_location": "end"}}],
            }
            writer.put(f"{name}/zarr.json", json.dumps(meta).encode())
            writer.put(f"{name}/" + "/".join(["c", *("0" for _ in shape)]), np.concatenate([frame, index, crc]))
            tree_metadata[str(tuple(k for k, _ in keys))] = {
                "key_metadata": [{"key": k, "key_type": kt} for k, kt in keys],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
            }
        writer.commit()
    (path / "params" / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": True,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None,
    }))
    (path / "params" / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler",
        "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": 0, "commit_timestamp_nsecs": 0,
        "custom_metadata": {},
    }))
    (path / "config.json").write_text(json.dumps(config))
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase10_orbax_encoder(ecfg, queries: list[str], total: dict[str, int], card: str) -> dict:
    """Phase 10 (f), the encoder: phase 10 (e)'s bge-m3-shaped encoder
    through save_checkpoint and ``flax:ckpt:<dir>``.  The format holds the
    weights only and such a checkpoint reads with the byte tokenizer (as in
    the JAX package), so the in-memory model is held to it with that
    tokenizer: every weight and the query embeddings equal bit for bit, and
    vector_search over phase 10 (e)'s store through each returns the same
    ids (int4 route, launches counted).  Then the same encoder written as
    orbax's zarr v3 layout (write_zarr3_checkpoint) and served as
    ``flax:ckpt:<dir>``: weights and query embeddings bit-equal to the zarr
    v2 load, the same ids, one int4 scan launch a query; the read seconds
    beside the zarr v2 ones (both files just written: warm reads)."""
    import dataclasses
    import shutil

    import torch

    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.models import encoder as enc
    from raglite_tpu_torch.models.tokenizer import ByteTokenizer
    from raglite_tpu_torch.models.transformer import params_to_jax
    from raglite_tpu_torch.search import vector_search

    encoder = enc.encoder_from_config(ecfg)
    root = scratch_dir(2_600_000_000, "ckpt_enc_")
    make = enc._make_encoder
    try:
        t0 = time.perf_counter()
        encoder.save_checkpoint(str(root / "enc"))
        save_s = time.perf_counter() - t0
        ccfg = dataclasses.replace(ecfg, embedder=f"flax:ckpt:{root / 'enc'}")
        t0 = time.perf_counter()
        back = enc.encoder_from_config(ccfg)
        load_s = time.perf_counter() - t0
        want_state, got_state = encoder._model.state_dict(), back._model.state_dict()
        assert sorted(want_state) == sorted(got_state)
        assert all(_same_bits(want_state[k], got_state[k]) for k in want_state)
        # The in-memory model with the byte tokenizer, served under a name of
        # its own for the comparison.
        reference = enc.TransformerEncoder.from_model(encoder._model, ByteTokenizer(vocab_size=encoder._cfg["vocab"]))
        enc._make_encoder = lambda embedder, device: reference if embedder == "flax:in-memory" else make(embedder, device)
        rcfg = dataclasses.replace(ecfg, embedder="flax:in-memory")
        want, got = reference.embed(queries), back.embed(queries)
        assert want.dtype == got.dtype and want.shape == got.shape and (want.view("u1") == got.view("u1")).all()
        assert (embed_queries(queries, config=rcfg).view("u1") == embed_queries(queries, config=ccfg).view("u1")).all()
        ids_want = [vector_search(q, num_results=10, config=rcfg)[0] for q in queries]
        launches: dict[str, int] = {}
        ids_got = _counted(launches, lambda: [vector_search(q, num_results=10, config=ccfg)[0] for q in queries])
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        assert ids_got == ids_want, (ids_got, ids_want)
        assert launches["int4_bucket_scan"] == len(queries), launches
        nbytes = sum(f.stat().st_size for f in (root / "enc").rglob("*") if f.is_file())
        log(f"phase 10 (f) flax:ckpt: the bge-m3-shaped encoder saved in {save_s:.2f} s and read back in {load_s:.2f} s "
            f"({nbytes / 1e9:.3f} GB on disk) on {card}: {len(want_state)} weights and {len(queries)} query embeddings "
            f"equal bit for bit to the in-memory model's (byte tokenizer, as the format reads), {len(queries)} "
            f"vector_searches over phase 10 (e)'s {dense_index_from_config(ecfg).num_rows} rows through it with the same ids (launches {launches})")

        t0 = time.perf_counter()
        nbytes3 = write_zarr3_checkpoint(root / "enc3", params_to_jax(encoder._model), encoder._cfg)
        save3_s = time.perf_counter() - t0
        c3cfg = dataclasses.replace(ecfg, embedder=f"flax:ckpt:{root / 'enc3'}")
        t0 = time.perf_counter()
        back3 = enc.encoder_from_config(c3cfg)
        load3_s = time.perf_counter() - t0
        state3 = back3._model.state_dict()
        assert sorted(state3) == sorted(got_state) and all(_same_bits(got_state[k], state3[k]) for k in got_state)
        got3 = back3.embed(queries)
        assert got3.dtype == got.dtype and got3.shape == got.shape and (got3.view("u1") == got.view("u1")).all()
        assert (embed_queries(queries, config=c3cfg).view("u1") == embed_queries(queries, config=ccfg).view("u1")).all()
        launches3: dict[str, int] = {}
        ids3 = _counted(launches3, lambda: [vector_search(q, num_results=10, config=c3cfg)[0] for q in queries])
        for name, count in launches3.items():
            total[name] = total.get(name, 0) + count
        assert ids3 == ids_got, (ids3, ids_got)
        assert launches3["int4_bucket_scan"] == len(queries), launches3
        # Both read once more, in the other order (zarr v2 was read first above).
        again = {}
        for name, path in (("zarr3", root / "enc3"), ("zarr2", root / "enc")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = enc.TransformerEncoder(f"ckpt:{path}", device="cuda")
            torch.cuda.synchronize()
            again[name] = time.perf_counter() - t0
            del model
        log(f"phase 10 (f) flax:ckpt: zarr v3 (orbax's use_zarr3 layout: sharding_indexed, zstd frames, crc32c "
            f"index, in OCDBT) of the same encoder written in {save3_s:.2f} s ({nbytes3 / 1e9:.3f} GB) and read onto "
            f"the card in {load3_s:.2f} s, {nbytes3 / load3_s / 1e9:.2f} GB/s (zarr v2: {load_s:.2f} s, "
            f"{nbytes / load_s / 1e9:.2f} GB/s), then in turn zarr v3 {again['zarr3']:.2f} s, zarr v2 "
            f"{again['zarr2']:.2f} s (all warm) on {card}: {len(state3)} weights and {len(queries)} query "
            f"embeddings equal bit for bit to the zarr v2 load's, {len(queries)} vector_searches with the same ids "
            f"(launches {launches3})")
        return {"encoder_save_s": save_s, "encoder_load_s": load_s, "encoder_bytes": nbytes,
                "encoder_zarr3_save_s": save3_s, "encoder_zarr3_load_s": load3_s, "encoder_zarr3_bytes": nbytes3,
                "encoder_reload_s": again}
    finally:
        enc._make_encoder = make
        shutil.rmtree(root, ignore_errors=True)


def phase10_fixture(card: str) -> dict:
    """Phase 10 (f), the fixture: the JAX package's orbax checkpoint
    (compressed zstd frames) read on the card and on the CPU, leaves equal
    bit for bit and f32 logits within FIXTURE_LOGIT_TOL; then the decoder's
    MB/s over the fixture's chunks on one host thread."""
    import numpy as np
    import torch

    from raglite_tpu_torch import native
    from raglite_tpu_torch.models.checkpoint import load_checkpoint
    from raglite_tpu_torch.models.decoder import DecoderModel, params_from_jax
    from raglite_tpu_torch.models.ocdbt import OcdbtReader
    from raglite_tpu_torch.utils.precision import full_f32_matmul

    on_card, cfg = load_checkpoint(ORBAX_FIXTURE, device="cuda")
    on_cpu, _ = load_checkpoint(ORBAX_FIXTURE, device="cpu")
    leaves_card, leaves_cpu = _tree_leaves(on_card), _tree_leaves(on_cpu)
    assert sorted(leaves_card) == sorted(leaves_cpu)
    assert all(_same_bits(leaves_card[k].cpu(), leaves_cpu[k]) for k in leaves_cpu)
    model = DecoderModel(cfg)
    ids = torch.randint(3, 259, (1, 96), generator=torch.Generator().manual_seed(5))
    with full_f32_matmul(), _plain_attention():
        card_params = params_from_jax(on_card, dtype=torch.float32, device="cuda")
        card_logits = _logits_of(model, card_params, ids.cuda(), torch.float32)
    cpu_logits = _logits_of(model, params_from_jax(on_cpu, dtype=torch.float32), ids, torch.float32)
    err = float((card_logits.cpu() - cpu_logits).abs().max())
    assert err <= FIXTURE_LOGIT_TOL, err
    with OcdbtReader(ORBAX_FIXTURE / "params") as store:
        frames = []
        for key in store.keys():
            if key.endswith("/.zarray"):
                meta = json.loads(store.get(key))
                size = int(np.prod(meta["chunks"])) * (2 if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"]).itemsize)
                frames.append((store.get(key.replace(".zarray", ".".join("0" for _ in meta["shape"]) or "0")), size))
    out = np.empty(max(size for _, size in frames), np.uint8)
    compressed = sum(len(f) for f, _ in frames)
    decoded, passes, t0 = 0, 0, time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        for frame, size in frames:
            native.zstd_decompress(frame, out[:size])
            decoded += size
        passes += 1
    seconds = time.perf_counter() - t0
    mb_s = decoded / seconds / 1e6
    log(f"phase 10 (f) the JAX package's orbax fixture ({len(frames)} leaves, {compressed} compressed bytes, "
        f"{decoded // passes} decoded) read on the card and the CPU: leaves equal bit for bit, f32 logits within "
        f"{err:.3g} (<= {FIXTURE_LOGIT_TOL}); the native zstd decoder {mb_s:.1f} MB/s decoded on one host thread "
        f"({passes} passes in {seconds:.3f} s), on {card}")
    return {"fixture_logit_err": err, "zstd_decode_mb_s": mb_s, **phase10_layout_fixtures(card)}


#: One orbax checkpoint per layout the JAX package restores
#: (scripts/orbax_layout_fixtures.py): zarr v3 sharded and Blosc, zarr v2
#: Blosc, gzip, zlib and bz2, big-endian and F-order arrays, numbered OCDBT
#: manifests.
ORBAX_LAYOUTS = ROOT / "tests" / "data" / "orbax_layouts"


def phase10_layout_fixtures(card: str) -> dict:
    """Phase 10 (f), the layouts: each committed layout fixture read on the
    card and on the CPU, every leaf equal bit for bit; then each codec's
    host decode MB/s (_codec_rates)."""
    from raglite_tpu_torch.models.checkpoint import load_checkpoint

    layouts = sorted(p for p in ORBAX_LAYOUTS.iterdir() if p.is_dir())
    assert len(layouts) == 7, layouts
    leaves = 0
    for root in layouts:
        on_card, _ = load_checkpoint(root, device="cuda")
        on_cpu, _ = load_checkpoint(root, device="cpu")
        card_leaves, cpu_leaves = _tree_leaves(on_card), _tree_leaves(on_cpu)
        assert sorted(card_leaves) == sorted(cpu_leaves), root.name
        assert all(card_leaves[k].is_cuda and _same_bits(card_leaves[k].cpu(), cpu_leaves[k]) for k in cpu_leaves), root.name
        leaves += len(cpu_leaves)
    log(f"phase 10 (f) the {len(layouts)} layout fixtures ({', '.join(p.name for p in layouts)}; {leaves} leaves) "
        f"read on the card and the CPU: every leaf equal bit for bit, on {card}")
    rates = _codec_rates()
    for codec, (mb_s, decoded, source) in rates.items():
        log(f"phase 10 (f) host decode {codec}: {mb_s:.1f} MB/s decoded on one host thread ({decoded / 1e6:.1f} MB "
            f"a pass; {source}), on {card}")
    return {"decode_mb_s": {codec: rate[0] for codec, rate in rates.items()}}


def _tiled_blosc(container: bytes, size: int) -> bytes:
    """A Blosc container of ``size`` or more bytes whose blocks are all
    ``container``'s first block (blocks decode independently)."""
    header = container[:16]
    blocksize, cbytes = int.from_bytes(header[8:12], "little"), int.from_bytes(header[12:16], "little")
    nblocks = -(-int.from_bytes(header[4:8], "little") // blocksize)
    start = int.from_bytes(container[16:20], "little")
    end = int.from_bytes(container[20:24], "little") if nblocks > 1 else cbytes
    block = container[start:end]
    copies = -(-size // blocksize)
    first = 16 + 4 * copies
    total = first + copies * len(block)
    head = header[:4] + (copies * blocksize).to_bytes(4, "little") + header[8:12] + total.to_bytes(4, "little")
    starts = b"".join((first + i * len(block)).to_bytes(4, "little") for i in range(copies))
    return head + starts + block * copies


def _codec_rates(size: int = 4_000_000, seconds: float = 0.25) -> dict[str, tuple[float, int, str]]:
    """{codec: (MB/s, bytes decoded a pass, what was decoded)}: the port's
    decoders on one host thread.  Blosc: a container of about ``size``
    bytes tiled from the zarr2_blosc fixture's largest compressed block of
    each inner codec; zstd: the ocdbt_numbered fixture's largest chunk (a
    tensorstore frame) repeated; gzip, zlib and bz2 (Python's): ``size``
    bytes of bf16 values on 16 levels (as the fixtures draw them), made by
    Python's compressors here."""
    import bz2
    import gzip
    import zlib

    import numpy as np
    import torch

    from raglite_tpu_torch import native
    from raglite_tpu_torch.models.checkpoint import _bytes_decode
    from raglite_tpu_torch.models.ocdbt import OcdbtReader

    samples: dict[str, tuple[bytes, int, str]] = {}  # codec: (input, decoded bytes, source)
    blosc = ORBAX_LAYOUTS / "zarr2_blosc" / "params"
    best: dict[str, tuple[int, bytes, str]] = {}
    for zarray in blosc.glob("*/.zarray"):
        codec = "blosc-" + json.loads(zarray.read_text())["compressor"]["cname"]
        for chunk in zarray.parent.iterdir():
            raw = chunk.read_bytes()
            if chunk.name == ".zarray" or raw[2] & 0x2:  # stored, not compressed
                continue
            blocksize = int.from_bytes(raw[8:12], "little")
            if blocksize > best.get(codec, (0,))[0]:
                best[codec] = (blocksize, raw, f"{zarray.parent.name}/{chunk.name}")
    for codec, (blocksize, raw, where) in best.items():
        tiled = _tiled_blosc(raw, size)
        shuffle = "bit" if raw[2] & 0x4 else "byte" if raw[2] & 0x1 else "no"
        samples[codec] = (tiled, int.from_bytes(tiled[4:8], "little"),
                          f"{where}'s {blocksize}-byte block ({shuffle} shuffle, type size {raw[3]}) tiled")
    with OcdbtReader(ORBAX_LAYOUTS / "ocdbt_numbered" / "params") as store:
        frame = max((store.get(k) for k in store.keys() if not k.endswith(".zarray")), key=len)
    one = native.zstd_decompress(frame, np.empty(1 << 20, np.uint8), exact=False)
    copies = -(-size // one)
    samples["zstd"] = (frame * copies, one * copies, f"ocdbt_numbered's largest frame x {copies}")
    values = torch.from_numpy(np.random.default_rng(0).integers(-8, 8, size // 2) / 32).to(torch.bfloat16)
    plain = values.view(torch.uint8).numpy().tobytes()
    for codec, packed in (("gzip", gzip.compress(plain, 6)), ("zlib", zlib.compress(plain, 6)), ("bz2", bz2.compress(plain, 9))):
        samples[codec] = (packed, len(plain), f"{len(plain)} bytes of bf16 on 16 levels, Python's compressor")
    out = np.empty(max(n for _, n, _ in samples.values()), np.uint8)
    rates = {}
    for codec, (data, n, source) in samples.items():
        dst = out[:n]
        passes, t0 = 0, time.perf_counter()
        while passes == 0 or time.perf_counter() - t0 < seconds:
            if codec.startswith("blosc"):
                native.blosc_decompress(data, dst)
            elif codec == "zstd":
                native.zstd_decompress(data, dst)
            else:
                _bytes_decode(codec, data, n, dst, codec)
            passes += 1
        rates[codec] = (n * passes / (time.perf_counter() - t0) / 1e6, n, source)
    return rates


def phase10_orbax(cfg, messages, answer: str | None, card: str, total: dict[str, int]) -> dict:
    """Phase 10 (f): ``ckpt:`` on the card with no tensorstore, orbax or
    zstandard.  Phase 6's seeded ``large`` (8.068 GB bf16) written by the
    port's save_checkpoint and read back as ``jax:ckpt:<dir>``: every leaf
    and a 2,048-token forward's logits equal bit for bit; the read-back
    model's rag() answer to phase 6's message equal to phase 6's (``answer``;
    computed here from the in-memory model when phase 6 did not run),
    through the prefill and verify kernels; ``ckpt:<dir>@int8``'s logits
    equal to the in-memory model's quantized alike; then the JAX package's
    fixture (phase10_fixture)."""
    import dataclasses
    import shutil

    import torch

    from raglite_tpu_torch import rag
    from raglite_tpu_torch.models.decoder import TorchChatLLM, quantize_decoder_params
    from raglite_tpu_torch.models.llm import llm_from_config

    _release_llms()
    out: dict = {}
    root = scratch_dir(8_200_000_000, "ckpt_large_")
    try:
        llm = llm_from_config(dataclasses.replace(cfg, llm="jax:large"))  # phase 6's seeded weights
        layers = llm.cfg["layers"]
        if answer is None:
            answer = "".join(rag([dict(m) for m in messages], config=dataclasses.replace(cfg, llm="jax:large")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm.save_checkpoint(str(root / "large"))
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in (root / "large").rglob("*") if f.is_file())
        ccfg = dataclasses.replace(cfg, llm=f"jax:ckpt:{root / 'large'}")
        t0 = time.perf_counter()
        back = llm_from_config(ccfg)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want, got = _tree_leaves(llm.params), _tree_leaves(back.params)
        assert sorted(want) == sorted(got) and all(_same_bits(want[k], got[k]) for k in want)
        weight_bytes = _weight_bytes(back.params)
        ids = torch.randint(3, 259, (1, 2048), generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
        assert torch.equal(_logits_of(llm.model, llm.params, ids), _logits_of(back.model, back.params, ids))
        log(f"phase 10 (f) ckpt: the large preset ({weight_bytes / 1e9:.3f} GB of bf16 weights, {len(want)} leaves) "
            f"saved with the port's writer in {save_s:.2f} s ({nbytes / 1e9:.3f} GB on disk, "
            f"{nbytes / save_s / 1e9:.2f} GB/s) and read back as jax:ckpt:<dir> onto the card in {load_s:.2f} s "
            f"({nbytes / load_s / 1e9:.2f} GB/s), no tensorstore, orbax or zstandard: every leaf and a 2,048-token "
            f"forward's logits equal bit for bit, on {card}")

        def answered():
            return "".join(rag([dict(m) for m in messages], config=ccfg))

        launches: dict[str, int] = {}
        t0 = time.perf_counter()
        text = _counted(launches, answered)
        rag_ms = (time.perf_counter() - t0) * 1e3
        stats = dict(back.spec_stats)
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        assert text == answer, (text[:200], answer[:200])
        assert launches["gqa_prefill_attention"] == layers, launches
        assert launches["gqa_verify_attention"] == layers * stats["verify_iters"], (launches, stats)
        log(f"phase 10 (f) rag() through jax:ckpt:<dir>: {stats['tokens']} tokens in {rag_ms:.1f} ms, the greedy text "
            f"equal to phase 6's answer from the same seed ({len(text)} characters), launches {launches}")

        t0 = time.perf_counter()
        q_back = TorchChatLLM(f"ckpt:{root / 'large'}@int8", device="cuda")
        load8_s = time.perf_counter() - t0
        q_want = quantize_decoder_params(llm.params)
        want8, got8 = _tree_leaves(q_want), _tree_leaves(q_back.params)
        assert sorted(want8) == sorted(got8) and all(_same_bits(want8[k], got8[k]) for k in want8)
        assert torch.equal(_logits_of(llm.model, q_want, ids), _logits_of(q_back.model, q_back.params, ids))
        log(f"phase 10 (f) ckpt:<dir>@int8 loaded and quantized in {load8_s:.2f} s: int8 blocks, scales and the "
            f"2,048-token logits equal to the in-memory model quantized alike, on {card}")
        out.update({
            "ckpt_save_s": save_s, "ckpt_load_s": load_s, "ckpt_bytes": nbytes, "ckpt_save_gb_s": nbytes / save_s / 1e9,
            "ckpt_load_gb_s": nbytes / load_s / 1e9, "ckpt_int8_load_s": load8_s, "ckpt_rag_ms": rag_ms,
        })
        del llm, back, q_back, q_want, want, got, want8, got8
    finally:
        _release_llms()
        shutil.rmtree(root, ignore_errors=True)
    out.update(phase10_fixture(card))
    return out


def pick_queries(texts: list[str], count: int, seed: int) -> list[str]:
    """``count`` distinct ASCII sentences (40-240 characters, ending in a
    full stop, question or exclamation mark) from the documents, each of at
    most RESIDENT_MAX_TERMS unique words (a longer query leaves the fused
    hybrid route for host RRF by design; phase 4b sends one).  ASCII,
    because there the native tokenizer the resident route counts with and
    Python's ``\\w`` agree; on other characters (box drawing, arrows) the
    native one may find more words."""
    import numpy as np

    from raglite_tpu_torch.index.keyword import KeywordIndex, tokenize
    from raglite_tpu_torch.sentences import split_sentences

    pool = []
    for text in texts:
        for sentence in split_sentences(text):
            s = " ".join(sentence.split())
            if (
                40 <= len(s) <= 240
                and s.isascii()
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
    store, rows_needed: int, seed: int, *, rows_per_chunk: int = 2, device: str = "cuda", dim: int = D
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
    vecs = torch.randn((n_chunks * rows_per_chunk, dim), generator=g, device=device)
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


def _hybrid_stages(cfg, queries: list[str], k_side: int, num_results: int) -> dict[str, list[float]]:
    """hybrid_search's stages apart, for each query at B = 1, each ended by
    a synchronize (host clock, ms): the query encode, the dense side, the
    resident BM25 side, RRF and the fetch."""
    import numpy as np
    import torch

    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.index.dense import dense_index_from_config, fetch_scored
    from raglite_tpu_torch.index.keyword import keyword_index_from_config
    from raglite_tpu_torch.search import corrected_num_hits, fuse_device

    dense, kw = dense_index_from_config(cfg), keyword_index_from_config(cfg)
    n = len(kw.chunk_ids)
    mask, _ = kw.resident_device_mask(None)
    hits1 = min(corrected_num_hits(4, k_side, cfg), dense.num_rows)
    stages: dict[str, list[float]] = {"encode": [], "dense side": [], "BM25 side": [], "RRF and fetch": []}
    for query in queries:
        t0 = time.perf_counter()
        q_emb = embed_queries([query], config=cfg).astype(np.float32)
        t1 = time.perf_counter()
        d_side = dense.search_chunks_device(q_emb, num_hits=hits1, num_results=k_side)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k_side_dev = kw.resident_block_device(kw.resident_prepare([query]), num_hits=k_side, mask=mask, masked=False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fetch_scored(*fuse_device(d_side, k_side_dev, num_chunks=n, num_results=num_results))
        t4 = time.perf_counter()
        for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[name].append(dt * 1e3)
    return stages


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
    from raglite_tpu_torch.search import (
        corrected_num_hits,
        fuse_device,
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
    fused_scores, fused_ords = fetch_scored(*fuse_device(dense_side, kw_side, num_chunks=n, num_results=num_results))
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
    stages = _hybrid_stages(cfg, [*queries, *tail[:32]], k_side, num_results)
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
    # Each torch-op program's time per call (CUDA events) from its graph and
    # eagerly (``eager_programs``), beside its bytes.
    from raglite_tpu_torch.utils import graphs

    def timed_both(fn) -> tuple[float, float]:
        fn()  # its key held
        graph = median_ms(fn)
        with graphs.eager_programs():
            return graph, median_ms(fn)

    programs = []
    for batch in (1, 256):
        block = term_ids[:batch]
        valid = block[block >= 0]
        lcap_b = 128
        while lcap_b < int(kw._res["df_host"][valid].max()):
            lcap_b *= 2
        read = int(np.minimum(kw._res["df_host"][valid], lcap_b).sum())
        moved = block.size * 4 + valid.size * 16 + read * 8 + batch * k_side * 12
        ms, eager_ms = timed_both(lambda: kw.resident_block_device(block, num_hits=k_side, mask=mask, masked=False))
        programs.append({"name": "bm25_topk_resident", "batch": batch, "ms": ms, "eager_ms": eager_ms, "bytes": moved,
                         "bound_ms": moved / PEAK_BYTES_PER_S * 1e3, "postings": read, "lcap": lcap_b})
    for batch in (1, 32):
        d_b = tuple(x[:batch] for x in dense_side)
        k_b = tuple(x[:batch] for x in kw_side)
        moved = batch * 2 * k_side * 12 + batch * num_results * 12
        ms, eager_ms = timed_both(lambda: fuse_device(d_b, k_b, num_chunks=n, num_results=num_results))
        programs.append({"name": "rrf_fuse_topk", "batch": batch, "ms": ms, "eager_ms": eager_ms, "bytes": moved,
                         "bound_ms": moved / PEAK_BYTES_PER_S * 1e3})
    for p in programs:
        log(f"timing {p['name']} B={p['batch']} on {card}: {p['ms']:.4f} ms a call from its CUDA graph, "
            f"{p['eager_ms']:.4f} eager (torch ops; CUDA events, calls enqueued back to back), {p['bytes']} bytes, "
            f"bound {p['bound_ms']:.6f} ms (bytes)" + (f", {p['postings']} postings read, lcap {p['lcap']}" if "postings" in p else ""))
    out["programs"] = programs
    if profile:
        ops, _ = _profile_window(
            lambda: [hybrid_search(q, num_results=10, config=cfg) for q in queries], f"{len(queries)} hybrid_search calls", card
        )
        log(f"device operations per hybrid_search call: {ops / len(queries):.1f} on {card}")
    return out


def time_kernels(index_bf16, index_i8, q_emb, card: str, *, dim: int = D, batches=(1, 32)) -> list[dict]:
    """Phase 5: each kernel at the index's arrays, B = 1 and 32 (phase 10
    (e): the int4 scan alone, ``index_i8`` None, at d = 1024)."""
    import torch

    from raglite_tpu_torch.ops import fused_scan as fs

    n = index_bf16.capacity
    out = []
    packed4, scale4 = index_bf16._packed4[0], index_bf16._scale4[0]
    bias4 = torch.where(index_bf16._valid[0], 0.0, fs.NEG).contiguous()
    unpacked = fs.unpack_rows_int4(packed4)
    for batch in batches:
        q = torch.as_tensor(q_emb[:batch], device="cuda")
        q_abs = q.abs().amax(dim=1, keepdim=True)
        q_i8 = torch.clamp(torch.round(q / (q_abs / 127.0)), -127, 127).to(torch.int8)
        specs = {
            "int4_bucket_scan": (
                lambda: fs.int4_bucket_scan(q_i8, packed4, scale4, bias4, num_buckets=fs.INT4_NUM_BUCKETS),
                lambda: fs.int4_bucket_scan_plain(q_i8, packed4, scale4, bias4, num_buckets=fs.INT4_NUM_BUCKETS),
                lambda: _library_scan(q_i8, unpacked, scale4, bias4, fs.INT4_NUM_BUCKETS),
                n * dim // 2, fs.INT4_NUM_BUCKETS,
            ),
        }
        if index_i8 is not None:
            rows8, scale8 = index_i8._rows[0], index_i8._scale[0]
            bias8 = torch.where(index_i8._valid[0], 0.0, fs.NEG).contiguous()
            specs["bucketed_max_scan"] = (
                lambda: fs.bucketed_max_scan(q_i8, rows8, bias8, scale8),
                lambda: fs.bucketed_max_scan_plain(q_i8, rows8, bias8, scale8),
                lambda: _library_scan(q_i8, rows8, scale8, bias8, fs.DEFAULT_NUM_BUCKETS),
                n * dim, fs.DEFAULT_NUM_BUCKETS,
            )
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
            moved = row_bytes + n * 8 + batch * dim + batch * L * 8  # rows, rscale+bias, q, outputs
            ops = 2 * batch * n * dim
            bound = {"bytes": moved / PEAK_BYTES_PER_S * 1e3, "operations": ops / PEAK_INT8_OPS_PER_S * 1e3}
            bound_by = max(bound, key=bound.get)
            log(
                f"timing {name} B={batch} N={n} d={dim} on {card}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound[bound_by]:.4f} ms "
                f"({bound_by}); max_abs_err {err}"
            )
            out.append({
                "name": name, "batch": batch, "d": dim, "N": n, "ms": ms, "plain_ms": plain_ms,
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


# --- Phase 11: from files to answers through the surfaces --------------------

#: Kinds of document phase 11 writes, one each, in this order.
DOC_KINDS = ("pdf", "docx", "pptx", "odt", "epub", "rtf", "html", "csv")


def _plain_inline(text: str) -> str:
    """Markdown inline marks removed: links to their text, no backticks,
    no strong marks."""
    import re

    text = re.sub(r"!?\[([^\]]*)\]\([^)]*\)", r"\1", text)
    return text.replace("`", "").replace("**", "").strip()


def markdown_blocks(text: str) -> list[tuple[int, str]]:
    """(level, text) blocks of a Markdown text: 1-6 for ATX headings, 0 for
    a paragraph (its lines joined by a space; a table row or list item is a
    paragraph of its own); fenced code is left out."""
    import re

    blocks: list[tuple[int, str]] = []
    para: list[str] = []
    fenced = False

    def flush() -> None:
        if para:
            blocks.append((0, " ".join(para)))
            para.clear()

    for line in text.splitlines():
        if line.lstrip().startswith(("```", "~~~")):
            flush()
            fenced = not fenced
            continue
        if fenced:
            continue
        m = re.match(r"^(#{1,6})\s+(.*?)\s*#*\s*$", line)
        if m:
            flush()
            if _plain_inline(m.group(2)):
                blocks.append((len(m.group(1)), _plain_inline(m.group(2))))
        elif not line.strip():
            flush()
        elif _plain_inline(line):
            if re.match(r"^\s*(\||[-*+] |\d+\. )", line):
                flush()
            para.append(_plain_inline(line))
    flush()
    return blocks


def split_blocks(texts: list[str], parts: int) -> list[list[tuple[int, str]]]:
    """The blocks of ``texts`` in order, cut into ``parts`` consecutive
    groups of about equal characters, so that no two documents share
    text."""
    blocks = [b for text in texts for b in markdown_blocks(text)]
    total = sum(len(t) for _, t in blocks)
    groups: list[list[tuple[int, str]]] = [[]]
    size = 0
    for level, text in blocks:
        if size >= total / parts * len(groups) and len(groups) < parts:
            groups.append([])
        groups[-1].append((level, text))
        size += len(text)
    return groups


def _xml(text: str) -> str:
    from xml.sax.saxutils import escape

    return escape(text)


def write_pdf(path: Path, blocks: list[tuple[int, str]]) -> None:
    """A multi-page PDF in the layout PDF writers emit: body lines in a
    Type1 font (Helvetica, 10 pt; characters outside Latin-1 written as
    "?"), headings in a Type0 font (Identity-H, a ToUnicode CMap mapping
    2-byte codes to every heading character; 18 / 14 / 12 / 11 pt by
    level), one Flate-compressed content stream a page, pages through a
    /Pages tree, an xref table.  As tests/test_markdown.py's _mini_pdf and
    _cid_pdf build theirs, at document scale."""
    import textwrap
    import zlib

    heading_chars = sorted({c for level, t in blocks if level for c in t})
    code = {c: i + 1 for i, c in enumerate(heading_chars)}
    sizes = {1: 18, 2: 14, 3: 12}

    def literal(s: str) -> bytes:
        s = "".join(c if 32 <= ord(c) < 127 or 160 <= ord(c) < 256 else "?" for c in s)
        return "(" + s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)") + ")"

    pages: list[list[str]] = [[]]
    y = 720.0
    for level, text in blocks:
        if level:
            size = sizes.get(level, 11)
            lines = [(f"/F2 {size} Tf", "<" + "".join(f"{code[c]:04X}" for c in text) + ">", size + 8)]
            y -= 10
        else:
            lines = [("/F1 10 Tf", literal(line), 13) for line in textwrap.wrap(text, 90)]
        for font, shown, leading in lines:
            if y < 72:
                pages.append([])
                y = 720.0
            pages[-1].append(f"BT {font} 72 {y:.1f} Td {shown} Tj ET")
            y -= leading
        y -= 7  # paragraph gap
    cmap = ["/CIDInit /ProcSet findresource begin", "12 dict begin", "begincmap",
            "1 begincodespacerange", "<0000> <FFFF>", "endcodespacerange"]
    for i in range(0, len(heading_chars), 100):
        chunk = heading_chars[i : i + 100]
        cmap.append(f"{len(chunk)} beginbfchar")
        cmap += [f"<{code[c]:04X}> <{c.encode('utf-16-be').hex().upper()}>" for c in chunk]
        cmap.append("endbfchar")
    cmap += ["endcmap", "end", "end"]
    tounicode = "\n".join(cmap).encode()

    def stream(data: bytes, compress: bool) -> bytes:
        if compress:
            data = zlib.compress(data)
            head = b"<< /Length %d /Filter /FlateDecode >>" % len(data)
        else:
            head = b"<< /Length %d >>" % len(data)
        return head + b"\nstream\n" + data + b"\nendstream"

    first_page = 10
    objs: dict[int, bytes] = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        3: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        4: b"<< /Type /Font /Subtype /Type0 /BaseFont /ABCDEF+NotoSans /Encoding /Identity-H"
           b" /DescendantFonts [5 0 R] /ToUnicode 6 0 R >>",
        5: b"<< /Type /Font /Subtype /CIDFontType2 /BaseFont /ABCDEF+NotoSans"
           b" /CIDSystemInfo << /Registry (Adobe) /Ordering (Identity) /Supplement 0 >> >>",
        6: stream(tounicode, compress=False),
    }
    kids = []
    for i, ops in enumerate(pages):
        page, content = first_page + 2 * i, first_page + 2 * i + 1
        kids.append(f"{page} 0 R".encode())
        objs[page] = (
            b"<< /Type /Page /Parent 2 0 R /Contents %d 0 R /MediaBox [0 0 612 792]"
            b" /Resources << /Font << /F1 3 0 R /F2 4 0 R >> >> >>" % content
        )
        objs[content] = stream("\n".join(ops).encode("latin-1"), compress=True)
    objs[2] = b"<< /Type /Pages /Kids [" + b" ".join(kids) + b"] /Count %d >>" % len(pages)
    out = bytearray(b"%PDF-1.5\n")
    offsets = {}
    for num in sorted(objs):
        offsets[num] = len(out)
        out += b"%d 0 obj\n" % num + objs[num] + b"\nendobj\n"
    xref, size = len(out), max(objs) + 1
    out += b"xref\n0 %d\n0000000000 65535 f \n" % size
    for num in range(1, size):
        out += b"%010d 00000 n \n" % offsets[num] if num in offsets else b"0000000000 65535 f \n"
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (size, xref)
    path.write_bytes(bytes(out))


def write_docx(path: Path, blocks: list[tuple[int, str]]) -> None:
    """WordprocessingML: Heading<n> paragraph styles and body paragraphs."""
    import zipfile

    ns = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    body = "".join(
        (f'<w:p><w:pPr><w:pStyle w:val="Heading{level}"/></w:pPr>' if level else "<w:p>")
        + f'<w:r><w:t xml:space="preserve">{_xml(text)}</w:t></w:r></w:p>'
        for level, text in blocks
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", '<?xml version="1.0"?><Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types"/>')
        zf.writestr("word/document.xml", f'<?xml version="1.0"?><w:document xmlns:w="{ns}"><w:body>{body}</w:body></w:document>')


def write_pptx(path: Path, blocks: list[tuple[int, str]]) -> None:
    """PresentationML: a slide per heading (its title placeholder), the
    paragraphs after it as the body's text."""
    import zipfile

    slides: list[tuple[str, list[str]]] = []
    for level, text in blocks:
        if level or not slides:
            slides.append((text if level else "", []))
        if not level:
            slides[-1][1].append(text)
    a, p = "http://schemas.openxmlformats.org/drawingml/2006/main", "http://schemas.openxmlformats.org/presentationml/2006/main"
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for i, (title, paras) in enumerate(slides, start=1):
            body = "".join(f"<a:p><a:r><a:t>{_xml(t)}</a:t></a:r></a:p>" for t in paras)
            zf.writestr(
                f"ppt/slides/slide{i}.xml",
                f'<?xml version="1.0"?><p:sld xmlns:a="{a}" xmlns:p="{p}"><p:cSld><p:spTree>'
                f'<p:sp><p:nvSpPr><p:nvPr><p:ph type="title"/></p:nvPr></p:nvSpPr><p:txBody><a:p><a:r><a:t>{_xml(title)}</a:t></a:r></a:p></p:txBody></p:sp>'
                f'<p:sp><p:nvSpPr><p:nvPr><p:ph type="body"/></p:nvPr></p:nvSpPr><p:txBody>{body}</p:txBody></p:sp>'
                "</p:spTree></p:cSld></p:sld>",
            )


def write_odt(path: Path, blocks: list[tuple[int, str]]) -> None:
    """OpenDocument Text: outline-level headings and paragraphs."""
    import zipfile

    body = "".join(
        f'<text:h text:outline-level="{level}">{_xml(text)}</text:h>' if level else f"<text:p>{_xml(text)}</text:p>"
        for level, text in blocks
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("mimetype", "application/vnd.oasis.opendocument.text")
        zf.writestr(
            "content.xml",
            '<?xml version="1.0"?><office:document-content xmlns:office="urn:oasis:names:tc:opendocument:xmlns:office:1.0" '
            f'xmlns:text="urn:oasis:names:tc:opendocument:xmlns:text:1.0"><office:body><office:text>{body}'
            "</office:text></office:body></office:document-content>",
        )


def _html_body(blocks: list[tuple[int, str]]) -> str:
    import html

    return "".join(f"<h{level}>{html.escape(t)}</h{level}>" if level else f"<p>{html.escape(t)}</p>" for level, t in blocks)


def write_epub(path: Path, blocks: list[tuple[int, str]]) -> None:
    """EPUB: a chapter (XHTML) per level-1 or level-2 heading, read in the
    OPF spine's order."""
    import zipfile

    chapters: list[list[tuple[int, str]]] = []
    for level, text in blocks:
        if not chapters or level in (1, 2):
            chapters.append([])
        chapters[-1].append((level, text))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("mimetype", "application/epub+zip")
        zf.writestr(
            "META-INF/container.xml",
            '<?xml version="1.0"?><container xmlns="urn:oasis:names:tc:opendocument:xmlns:container" version="1.0">'
            '<rootfiles><rootfile full-path="OEBPS/content.opf" media-type="application/oebps-package+xml"/></rootfiles></container>',
        )
        items = "".join(f'<item id="c{i}" href="ch{i}.xhtml" media-type="application/xhtml+xml"/>' for i in range(len(chapters)))
        spine = "".join(f'<itemref idref="c{i}"/>' for i in range(len(chapters)))
        zf.writestr(
            "OEBPS/content.opf",
            f'<?xml version="1.0"?><package xmlns="http://www.idpf.org/2007/opf" version="3.0"><manifest>{items}</manifest>'
            f"<spine>{spine}</spine></package>",
        )
        for i, chapter in enumerate(chapters):
            zf.writestr(f"OEBPS/ch{i}.xhtml", f"<html><body>{_html_body(chapter)}</body></html>")


def write_rtf(path: Path, blocks: list[tuple[int, str]]) -> None:
    """RTF: a font table, then one \\par-ended paragraph a block (headings
    as Markdown heading lines: RTF has no outline of its own), non-ASCII
    characters as \\uN? escapes."""

    def esc(s: str) -> str:
        out = []
        for c in s:
            if c in "\\{}":
                out.append("\\" + c)
            elif ord(c) < 128:
                out.append(c)
            elif ord(c) < 0x10000:
                out.append(f"\\u{ord(c) if ord(c) < 32768 else ord(c) - 65536}?")
            else:
                out.append("?")
        return "".join(out)

    paras = "".join(esc(("#" * level + " " if level else "") + text) + "\\par\n" for level, text in blocks)
    path.write_text("{\\rtf1\\ansi\\deff0{\\fonttbl{\\f0 Helvetica;}}\\f0\\fs20\n" + paras + "}", encoding="ascii")


def write_html(path: Path, blocks: list[tuple[int, str]]) -> None:
    path.write_text(
        f"<!doctype html><html><head><title>{len(blocks)} blocks</title><style>p {{ margin: 0 }}</style></head>"
        f"<body>{_html_body(blocks)}</body></html>",
        encoding="utf-8",
    )


def write_csv(path: Path, blocks: list[tuple[int, str]]) -> None:
    """A table of (section, text): each paragraph beside its heading."""
    import csv

    with open(path, "w", newline="", encoding="utf-8") as fh:
        out = csv.writer(fh)
        out.writerow(["section", "text"])
        section = ""
        for level, text in blocks:
            if level:
                section = text
            else:
                out.writerow([section, text])


def write_documents(directory: Path, texts: list[str]) -> dict[str, tuple[Path, list[str], str]]:
    """One document of each of DOC_KINDS from consecutive parts of
    ``texts``: {kind: (path, headings it must show, a sentence it holds)}.
    The headings are the part's first three (for CSV its header row); the
    sentence is an ASCII one of 40-200 characters from its paragraphs
    (table rows count as paragraphs)."""
    import re

    writers = {
        "pdf": write_pdf, "docx": write_docx, "pptx": write_pptx, "odt": write_odt,
        "epub": write_epub, "rtf": write_rtf, "html": write_html, "csv": write_csv,
    }
    out = {}
    for kind, blocks in zip(DOC_KINDS, split_blocks(texts, len(DOC_KINDS))):
        path = directory / f"part.{kind}"
        writers[kind](path, blocks)
        headings = ["section", "text"] if kind == "csv" else [t for level, t in blocks if level][:3]
        banned = set("#*[]<>\\") | ({"|"} if kind == "csv" else set())
        sentence = next(
            s for level, t in blocks if not level for s in re.split(r"(?<=\.)\s+", t)
            if 40 <= len(s) <= 200 and s.isascii() and not banned & set(s)
        )
        out[kind] = (path, headings, sentence)
    return out


def check_conversion(kind: str, markdown: str, headings: list[str], sentence: str) -> None:
    """The converted Markdown shows each heading on a heading line (the
    CSV's as its table's header row) and holds the sentence (white space
    normalised)."""
    flat = " ".join(markdown.split())
    assert " ".join(sentence.split()) in flat, (kind, sentence)
    if kind == "csv":
        assert markdown.startswith("| section | text |"), markdown[:80]
        return
    heading_lines = [" ".join(line.split()) for line in markdown.splitlines() if line.lstrip().startswith("#")]
    for heading in headings:
        assert any(" ".join(heading.split()) in line for line in heading_lines), (kind, heading)


#: Phase 11 (b): the learned boundary model on the card against its CPU
#: version: the same f32 weights and windows, TF32 off on the card, so the
#: two differ only by f32 summation order over 156 + 64 terms (a few ulps
#: of a logit of order 10; a sigmoid's slope is at most 1/4).
BOUNDARY_ATOL = 1e-5
#: Phase 11 (e): concurrent /api/search requests, one thread each.
PHASE11_SEARCHES = 64
#: Phase 11's store holds --rows // PHASE11_ROWS_DIVISOR rows (312,320 at
#: the default --rows), above the exact route's 131,072, so every search
#: still takes the int4 route.  At the full 1,249,280 the background rows,
#: the save and each fresh process's index build took about 55 s of a run
#: that has to end within its time limit on a slow host.
PHASE11_ROWS_DIVISOR = 4


def _connection(port: int):
    """A connection to the web chat on 127.0.0.1, connected (http.client:
    no proxy is ever consulted)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.connect()
    return conn


def _http(port: int, method: str, path: str, body: bytes = b"", headers: dict | None = None, *, conn=None):
    """One request to the web chat on ``conn`` (a new connection when
    None); returns the open response."""
    conn = conn or _connection(port)
    conn.request(method, path, body=body or None, headers={"Content-Type": "application/json", **(headers or {})})
    return conn.getresponse()


def _disk_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _cli(
    store: Path, *args: str, stdin: str | None = None, timeout: float = 600, env: dict[str, str] | None = None
) -> tuple[str, float, float]:
    """``python -m raglite_tpu_torch --store-path <store> <args>`` in a fresh
    process (with ``env`` added to this one's environment): (its output,
    seconds to its first line, seconds to its end)."""
    import os
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "raglite_tpu_torch", "--store-path", str(store), *args],
            cwd=ROOT, stdin=subprocess.PIPE if stdin is not None else subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=err, text=True, env={**os.environ, **(env or {}), "PYTHONUNBUFFERED": "1"},
        )
        try:
            if stdin is not None:
                proc.stdin.write(stdin)
                proc.stdin.close()
            first = proc.stdout.readline()
            first_s = time.perf_counter() - t0
            text = first + proc.stdout.read()
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        assert proc.returncode == 0, (args, err.read()[-4000:])
    return text, first_s, time.perf_counter() - t0


def phase11(texts: list[str], rows: int, seed: int, card: str, total: dict[str, int]) -> dict:
    """Phase 11: from files to answers through the surfaces, in a temporary
    directory.  (a) one document of each kind converted to Markdown; (b)
    the learned boundary model on the card against the CPU; (c) a
    persistent store of ``rows`` rows (the PDF inserted through the CLI,
    the rest through insert_documents with learned boundaries, background
    rows), saved with its dense index; (d) a cold CLI search and stats in
    fresh processes, and DenseIndex.load, against the parent's
    vector_search; (e) the web chat: 64 concurrent micro-batched searches,
    a PDF upload, a streamed chat answer from `jax:large`, the phase
    timings; (f) the MCP server over pipes; (g) a trace of four searches.
    Every kernel launched in this process is counted into ``total``."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents, retrieve_context
    from raglite_tpu_torch.embed import embed_strings
    from raglite_tpu_torch.index.dense import DenseIndex, _index_for_store, dense_index_from_config
    from raglite_tpu_torch.markdown import document_to_markdown
    from raglite_tpu_torch.models.boundary import (
        BoundaryModel,
        boundary_f1,
        char_class_ids,
        default_model,
        windows_for,
    )
    from raglite_tpu_torch.models.boundary_data import make_corpus
    from raglite_tpu_torch.models.encoder import encoder_from_config
    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.search import corrected_num_hits, vector_search
    from raglite_tpu_torch.sentences import heuristic_sentence_boundaries, split_sentences
    from raglite_tpu_torch.store import _store_for_path, store_from_config
    from raglite_tpu_torch.utils import trace
    from raglite_tpu_torch.webchat import create_web_app

    _release_llms()
    fs.reset_launch_counts()
    _reset_attention_launches()
    trace.reset()
    out: dict = {}
    tmp = scratch_dir(int(5e9), "chip_smoke_p11_")
    try:
        # (a) Documents of every kind, converted on the host.
        docs = write_documents(tmp, texts)
        markdown, convert_ms = {}, {}
        for kind, (path, headings, sentence) in docs.items():
            t0 = time.perf_counter()
            markdown[kind] = document_to_markdown(path)
            convert_ms[kind] = (time.perf_counter() - t0) * 1e3
            check_conversion(kind, markdown[kind], headings, sentence)
        sizes = {kind: docs[kind][0].stat().st_size for kind in docs}
        log(f"phase 11 (a) converted {len(docs)} documents (bytes {sizes}) to Markdown: host ms {convert_ms}; "
            f"each shows its headings and a sentence of its source")
        out["convert_ms"], out["document_bytes"] = convert_ms, sizes
        mark("phase 11 (a)")

        # (b) Learned boundaries on the card against the CPU.
        cpu_model, gpu_model = BoundaryModel.load(device="cpu"), default_model("cuda")
        assert gpu_model.device.type == "cuda"
        heldout = make_corpus(num_documents=40, seed=2000)
        worst = 0.0
        for doc in [*markdown.values(), *(d for d, _ in heldout)]:
            worst = max(worst, float(np.abs(gpu_model(doc) - cpu_model(doc)).max()))
            assert worst <= BOUNDARY_ATOL, worst
            assert split_sentences(doc, max_len=2048, base_probas="learned", device="cuda") == split_sentences(
                doc, max_len=2048, base_probas="learned", device="cpu"
            )
        held = sorted(k for k in gpu_model.programs._entries if k[0] == "boundary")
        assert held and gpu_model.programs.counts["replayed"] > 0, gpu_model.programs.counts  # blocks from graphs
        f1_learned = float(np.mean([boundary_f1(gpu_model(d), gold)[0] for d, gold in heldout]))
        f1_heuristic = float(np.mean([boundary_f1(heuristic_sentence_boundaries(d), gold)[0] for d, gold in heldout]))
        big = "\n\n".join(markdown.values())
        windows = torch.from_numpy(windows_for(char_class_ids(big))).cuda()
        with torch.inference_mode():
            device_ms = median_ms(lambda: gpu_model(windows), reps=10, inner=5)
        t0 = time.perf_counter()
        for _ in range(3):
            gpu_model(big)
        card_ms = (time.perf_counter() - t0) / 3 * 1e3
        t0 = time.perf_counter()
        cpu_model(big)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        per = 1e5 / len(big)
        out["boundary"] = {
            "max_abs_err": worst, "f1_learned": f1_learned, "f1_heuristic": f1_heuristic,
            "ms_per_100k_chars": card_ms * per, "device_ms_per_100k_chars": device_ms * per,
            "cpu_ms_per_100k_chars": cpu_ms * per,
        }
        log(f"phase 11 (b) learned boundaries on the card = CPU within {worst:.3g} (atol {BOUNDARY_ATOL}) over "
            f"{len(markdown) + len(heldout)} documents, sentences equal, the blocks from CUDA graphs (keys {held}); held-out F1 learned {f1_learned:.4f} vs "
            f"heuristic {f1_heuristic:.4f} (PARITY.md quotes 0.999 vs 0.87, the JAX package on the CPU); {card_ms * per:.2f} ms per 100k characters on the card (the forward "
            f"alone {device_ms * per:.3f} ms, CUDA events; the CPU model {cpu_ms * per:.2f} ms), on {card}")
        mark("phase 11 (b)")

        # (c) A persistent store: the PDF through the CLI, the rest through
        # insert_documents with learned boundaries, then background rows.
        store_path = tmp / "store"
        cfg = RAGLiteConfig(store_path=str(store_path), sentence_boundary_model="learned", device="cuda")
        assert cfg.embedder == "flax:sem" and cfg.embedding_dtype == "bfloat16" and cfg.use_int4_stage1
        text, _, cli_insert_s = _cli(store_path, "insert", str(docs["pdf"][0]))
        assert text.strip() == f"Inserted 1 document(s) into {store_path}.", text
        t0 = time.perf_counter()
        insert_documents([Document.from_path(docs[k][0]) for k in DOC_KINDS if k != "pdf"], config=cfg)
        insert_s = time.perf_counter() - t0
        store = store_from_config(cfg)
        assert len(store.documents) == len(DOC_KINDS), sorted(store.documents)
        doc_rows, doc_chunks = store.num_embedding_vectors, len(store.chunk_order)
        t0 = time.perf_counter()
        background = add_background(store, rows - doc_rows, seed)
        background_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with store.write_lock():
            store.save()
        save_s = time.perf_counter() - t0
        index = dense_index_from_config(cfg)
        assert index.num_rows == rows, index.num_rows
        t0 = time.perf_counter()
        index.save(str(tmp / "index"))
        index_save_s = time.perf_counter() - t0
        store_bytes, index_bytes = _disk_bytes(store_path), _disk_bytes(tmp / "index")
        out["store"] = {
            "cli_insert_pdf_s": cli_insert_s, "insert_7_s": insert_s, "doc_chunks": doc_chunks, "doc_rows": doc_rows,
            "background_s": background_s, "save_s": save_s, "store_bytes": store_bytes,
            "index_save_s": index_save_s, "index_bytes": index_bytes,
        }
        log(f"phase 11 (c) store at {rows} rows: the PDF through the CLI in {cli_insert_s:.2f} s (a fresh process), "
            f"7 documents through insert_documents (learned boundaries on the card) in {insert_s:.2f} s: "
            f"{doc_chunks} chunks, {doc_rows} rows; {len(background)} background chunks in {background_s:.2f} s; "
            f"store.save {save_s:.2f} s, {store_bytes / 1e9:.3f} GB on disk; DenseIndex.save {index_save_s:.2f} s, "
            f"{index_bytes / 1e9:.3f} GB, on {card}")
        mark("phase 11 (c)")

        # (d) Cold start in fresh processes, and DenseIndex.load here.
        queries = pick_queries(list(markdown.values()), PHASE11_SEARCHES + 4, seed)
        query = queries[0]
        text, first_s, cli_s = _cli(store_path, "search", query, "--method", "vector")
        cli_ids = [line.split()[1] for line in text.splitlines()]
        ids, scores = vector_search(query, num_results=5, config=cfg)
        assert index.last_route == "int4_two_stage", index.last_route
        assert cli_ids == ids, (cli_ids, ids)
        assert ids[0] not in background, ids
        text, _, stats_s = _cli(store_path, "stats")
        stats = json.loads(text)
        assert (stats["documents"], stats["chunks"], stats["sub_vectors"]) == (len(store.documents), len(store.chunk_order), rows), stats
        t0 = time.perf_counter()
        loaded = DenseIndex.load(str(tmp / "index"), device="cuda")
        load_s = time.perf_counter() - t0
        q = embed_strings([query], config=cfg)[0:1].astype(np.float32)
        hits = min(corrected_num_hits(4, 5, cfg), loaded.num_rows)
        t0 = time.perf_counter()
        _, loaded_ord = loaded.search_chunks(q, num_hits=hits, num_results=5)
        loaded_first_ms = (time.perf_counter() - t0) * 1e3
        assert loaded.last_route == "int4_two_stage", loaded.last_route
        assert [loaded.chunk_ids[o] for o in loaded_ord[0]] == ids
        del loaded
        # The same cold open in this process (imports, CUDA context and the
        # encoder already here): the store from disk, the index built from
        # it, the first search (upload, int4 packing).
        index = None
        for cache in (_store_for_path, _index_for_store):
            cache.cache_clear()
        t0 = time.perf_counter()
        store = store_from_config(cfg)
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = dense_index_from_config(cfg)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert vector_search(query, num_results=5, config=cfg)[0] == ids
        reopened_first_ms = (time.perf_counter() - t0) * 1e3
        out["cold"] = {"cli_first_result_s": first_s, "cli_search_s": cli_s, "cli_stats_s": stats_s,
                       "index_load_s": load_s, "loaded_first_search_ms": loaded_first_ms,
                       "store_open_s": open_s, "index_build_s": build_s, "reopened_first_search_ms": reopened_first_ms}
        log(f"phase 11 (d) cold start: `search --method vector` printed its first result {first_s:.2f} s after "
            f"process start ({cli_s:.2f} s to exit), ids = the parent's vector_search {ids}; `stats` in "
            f"{stats_s:.2f} s; DenseIndex.load {load_s:.2f} s, its first search (upload, int4 packing) "
            f"{loaded_first_ms:.1f} ms, ids equal; in this process the store opens in {open_s:.2f} s, the index "
            f"builds from it in {build_s:.2f} s and the first search takes {reopened_first_ms:.1f} ms, on {card}")
        mark("phase 11 (d)")

        # (e) The web chat on 127.0.0.1, answering through `jax:large`.
        programs = {"encoder": encoder_from_config(cfg).programs, "index": index.programs}
        mix_before = _graph_mix(programs)
        chat_cfg = dataclasses.replace(cfg, llm="jax:large")
        app = create_web_app(chat_cfg)
        server, port = app.serve_background("127.0.0.1", 0)
        try:
            got, times, batches = _web_searches(app, port, queries[1 : 1 + PHASE11_SEARCHES])
            direct = {qq: vector_search(qq, num_results=5, config=cfg)[0] for qq in got}
            for qq, result_ids in got.items():
                assert result_ids == direct[qq], (qq, result_ids, direct[qq])
            # One batch in flight: 64 requests gather into a few batches.
            assert sum(batches) == PHASE11_SEARCHES and len(batches) <= PHASE11_SEARCHES // 8, batches
            # A binary upload: a PDF of other text, parsed by from_path.
            upload = tmp / "upload.pdf"
            write_pdf(upload, [(1, "Upload"), *((0, d) for d, _ in make_corpus(num_documents=30, seed=seed + 11))])
            t0 = time.perf_counter()
            resp = _http(port, "POST", "/api/upload", upload.read_bytes(), {"X-Filename": "upload.pdf"})
            uploaded = json.loads(resp.read())
            upload_s = time.perf_counter() - t0
            assert resp.status == 200 and uploaded["status"] == "inserted", uploaded
            assert store_from_config(cfg).documents[uploaded["id"]].filename == "upload.pdf"
            # A streamed answer.
            before = sum(_attention_launches().values())
            t0 = time.perf_counter()
            resp = _http(port, "POST", "/api/chat", json.dumps({"messages": [{"role": "user", "content": query}]}).encode())
            assert resp.status == 200
            events, first_token_s, buf = [], None, b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n\n" in buf:
                    raw, buf = buf.split(b"\n\n", 1)
                    lines = dict(line.split(": ", 1) for line in raw.decode().split("\n") if ": " in line)
                    events.append((lines.get("event"), lines.get("data"), time.perf_counter() - t0))
                    if lines.get("event") == "token" and first_token_s is None:
                        first_token_s = events[-1][2]
            tokens = [e for e in events if e[0] == "token"]
            assert tokens and events[-1][0] == "done", events[-3:]
            chat_s = events[-1][2]
            rate = (len(tokens) - 1) / max(tokens[-1][2] - first_token_s, 1e-9)
            chat_launches = sum(_attention_launches().values()) - before
            assert chat_launches > 0, _attention_launches()
            stats = json.loads(_http(port, "GET", "/api/stats").read())
            phases = stats["phases"]
            for name in ("insert.split_sentences", "insert.embed", "search.embed_query", "search.dense_scan"):
                assert name in phases, sorted(phases)
        finally:
            server.shutdown()
            server.server_close()
        out["graph_mix"] = _graph_mix_since(programs, mix_before)
        log(f"phase 11 (e) retrieval graphs over the web chat's searches, upload and chat: {json.dumps(out['graph_mix'])}, on {card}")
        times = sorted(times)
        out["web"] = {
            "search_p50_ms": statistics.median(times), "search_p99_ms": times[int(0.99 * (len(times) - 1))],
            "batch_sizes": batches, "upload_s": upload_s, "chat_ttft_s": first_token_s,
            "chat_tokens_per_s": rate, "chat_pieces": len(tokens), "chat_s": chat_s, "chat_attention_launches": chat_launches,
            "phases_mean_ms": {k: v["mean_s"] * 1e3 for k, v in phases.items()},
        }
        log(f"phase 11 (e) web chat: {len(times)} concurrent /api/search (vector) p50 {out['web']['search_p50_ms']:.1f} "
            f"ms, p99 {out['web']['search_p99_ms']:.1f} ms, micro-batches {batches}, every answer = vector_search; "
            f"PDF upload {upload_s:.2f} s; /api/chat (jax:large, seeded weights) first token {first_token_s:.3f} s, "
            f"{len(tokens)} pieces at {rate:.1f}/s, {chat_launches} attention launches; stats phases (mean ms) "
            f"{ {k: round(v, 3) for k, v in out['web']['phases_mean_ms'].items()} }, on {card}")
        _release_llms()
        mark("phase 11 (e)")

        # (f) The MCP server over pipes.
        requests = [
            {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
            {"jsonrpc": "2.0", "method": "notifications/initialized"},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
            {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
             "params": {"name": "search_knowledge_base", "arguments": {"query": query}}},
        ]
        text, _, mcp_s = _cli(store_path, "mcp", "run", stdin="".join(json.dumps(r) + "\n" for r in requests))
        responses = {r["id"]: r for r in map(json.loads, text.splitlines())}
        assert responses[2]["result"]["tools"][0]["name"] == "search_knowledge_base"
        payload = json.loads(responses[3]["result"]["content"][0]["text"])
        spans = retrieve_context(query, config=cfg)
        assert payload["documents"][0] == json.loads(spans[0].to_json(index=1)), (payload["documents"][0], spans[0].to_json(1))
        out["mcp_s"] = mcp_s
        log(f"phase 11 (f) MCP over pipes: initialize, tools/list, tools/call in {mcp_s:.2f} s (a fresh process); "
            f"the top document = retrieve_context's ({len(payload['documents'])} documents), on {card}")
        mark("phase 11 (f)")

        # (g) A trace of four searches.
        int4_before = fs.launch_counts["int4_bucket_scan"]
        with trace.trace_session(str(tmp / "trace")) as trace_path:
            for qq in queries[:4]:
                vector_search(qq, num_results=5, config=cfg)
        events = json.loads(trace_path.read_text())["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        int4_events = [k for k in kernels if "mma_scan_kernel<true" in k or "bucket_scan_kernel<1>" in k]
        assert {"search.embed_query", "search.dense_scan"} <= names, sorted(n for n in names if n.startswith("search"))
        assert int4_events and fs.launch_counts["int4_bucket_scan"] - int4_before == 4
        out["trace"] = {"events": len(events), "kernel_events": len(kernels), "int4_events": len(int4_events),
                        "bytes": trace_path.stat().st_size}
        log(f"phase 11 (g) trace of 4 searches: {len(events)} events, {len(kernels)} kernels, {len(int4_events)} of "
            f"them the int4 scan, the search.* ranges present ({trace_path.stat().st_size / 1e6:.1f} MB), on {card}")
    finally:
        for cache in (_store_for_path, _index_for_store):
            cache.cache_clear()
        shutil.rmtree(tmp, ignore_errors=True)
        for name, count in _all_launches().items():
            total[name] = total.get(name, 0) + count
    return out


def _web_searches(app, port: int, queries: list[str]) -> tuple[dict[str, list[str]], list[float], list[int]]:
    """Warm the web chat's search path (one request, then one concurrent
    burst), then send one POST /api/search a thread, all released at once:
    ({query: ids}, per-request ms from the release, this run's micro-batch
    sizes).  Each thread opens and connects its connection before the
    release, so the burst reaches the server as one however slowly the host
    starts threads and connections."""
    import threading

    def one(q: str, conn=None) -> tuple[list[str], float]:
        t0 = time.perf_counter()
        resp = _http(port, "POST", "/api/search", json.dumps({"query": q, "method": "vector"}).encode(), conn=conn)
        body = json.loads(resp.read())
        assert resp.status == 200, body
        return [r["chunk_id"] for r in body["results"]], (time.perf_counter() - t0) * 1e3

    def burst(batch: list[str]) -> list[tuple[list[str], float]]:
        results: list = [None] * len(batch)
        gate = threading.Barrier(len(batch))

        def worker(i: int) -> None:
            try:
                conn = _connection(port)
                gate.wait()
                results[i] = one(batch[i], conn)
            except Exception as error:  # re-raised below, in this thread
                results[i] = error
                gate.abort()  # the other threads stop waiting

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(batch))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive(), "a web search did not answer in 600 s"
        errors = [r for r in results if isinstance(r, Exception)]
        for error in sorted(errors, key=lambda e: isinstance(e, threading.BrokenBarrierError)):
            raise error  # the cause first, not a thread the abort released
        return results

    one(queries[0])
    burst(queries[:32])
    (batcher,) = app._search_batcher._batchers.values()  # one key: (vector, 5, no filter)
    done = len(batcher.batch_sizes)
    results = burst(queries)
    sizes = list(batcher.batch_sizes)[done:]
    return {q: r[0] for q, r in zip(queries, results)}, [r[1] for r in results], sizes


#: Phase 12: row shards of the sharded index (all on the one card) and the
#: tensor-parallel degree of the `large` decoder.
PHASE12_SHARDS = 4
PHASE12_TP = 4
#: Phase 12 (a): the sharded int4 route's chunks against the single-device
#: exact route's, counting a chunk scored within the two routes' f32
#: rounding of the exact 10th (2 * d * 2^-24, as TIE_ATOL at d = 768) as a
#: hit, as phase 10 (e) does.
PHASE12_TIE_ATOL = 2 * D * 2.0**-24
#: Phase 12 (c): the TP forward's logits against the single-device
#: forward's: top-1 equal on at least this share of positions, and their
#: largest difference printed beside this share of the largest |logit| (the
#: bound of the JAX package's own test, tests/test_tp_decoder.py, on a
#: 2-layer model and 8 tokens).  At 36 layers and 2,048 tokens in bf16 the
#: two forwards differ by bf16 re-association alone (GEMMs of other shapes
#: sum in other orders) by about that much: 0.0216 and 0.0203 of the
#: largest |logit| in the first two runs on an H100.  So the accuracy
#: asserted is against an f32 forward of the same weights (f32 matmuls,
#: plain attention, f32 caches): the TP forward's largest error no more than
#: PHASE12_ERROR_RATIO times the single-device forward's.
PHASE12_LOGIT_RTOL = 0.02
PHASE12_TOP1_MIN = 0.95
PHASE12_ERROR_RATIO = 1.5
#: Phase 12 (d): each rank's time limit (seconds), the rows of each of the
#: 4 shards (77 buckets of 4,096: the 4-shard capacity of phase 3's store)
#: and the queries.
PHASE12_RANK_TIMEOUT = 300
PHASE12_SHARD_ROWS = 77 * 4096
PHASE12_RANK_QUERIES = 8


def phase12_index(cfg, queries: list[str], bench_queries: list[str], card: str, total: dict[str, int]) -> dict:
    """Phase 12 (a): phase 3's store served with ``num_devices=4`` (4 row
    shards on the one card): every vector_search on the sharded int4 route
    with 4 int4 launches, recall@10 against the single-device exact route,
    the sharded exact route at B = 64 equal to the single-device one, one
    shard's int4 scan bit-exact against its plain version and timed at its
    shape; p50s beside ``num_devices=1``."""
    import dataclasses
    import types

    import torch

    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.search import corrected_num_hits, vector_search

    cfg4 = dataclasses.replace(cfg, num_devices=PHASE12_SHARDS)
    index1 = dense_index_from_config(cfg)
    t0 = time.perf_counter()
    index4 = dense_index_from_config(cfg4)
    index4._refresh_device()
    index4._ensure_packed4()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    c = index4.shard_rows
    assert index4.num_devices == PHASE12_SHARDS and len(index4._rows) == PHASE12_SHARDS
    assert index4.num_rows == index1.num_rows and c % fs.INT4_NUM_BUCKETS == 0, (c, index4.capacity)
    assert all(r.shape[0] == c and r.device.type == "cuda" for r in index4._rows)
    log(f"phase 12 (a) the phase-3 store ({index4.num_rows} rows x {index4.dim}) as {PHASE12_SHARDS} row shards of {c} "
        f"rows (capacity {index4.capacity}) on {index4.devices}: synced, uploaded and packed in {build_s:.1f} s, on {card}")

    latencies: dict[int, list[float]] = {1: [], PHASE12_SHARDS: []}
    per_search: list[int] = []
    for query in queries:
        for n, conf, index in ((1, cfg, index1), (PHASE12_SHARDS, cfg4, index4)):
            launches: dict[str, int] = {}
            t0 = time.perf_counter()
            ids, scores = _counted(launches, lambda: vector_search(query, num_results=10, config=conf))
            latencies[n].append((time.perf_counter() - t0) * 1e3)
            assert index.last_route == "int4_two_stage" and len(ids) == 10, (n, index.last_route, ids)
            if n == PHASE12_SHARDS:
                per_search.append(launches.get("int4_bucket_scan", 0))
                for name, count in launches.items():
                    total[name] = total.get(name, 0) + count
    assert per_search == [PHASE12_SHARDS] * len(queries), per_search
    p50 = {n: statistics.median(v) for n, v in latencies.items()}

    # Recall@10 against the single-device exact route.
    emb = embed_queries(queries, config=cfg)
    hits = min(corrected_num_hits(4, 10, cfg), index1.num_rows)
    recalls, tie_recalls = [], []
    for b in range(len(queries)):
        routed = index4.search_chunks_device(emb[b : b + 1], num_hits=hits, num_results=10)[1][0].tolist()
        scores, ordinals = index1.search_chunks_device(emb[b : b + 1], num_hits=hits, num_results=hits, exact=True)
        exact_score = dict(zip(ordinals[0].tolist(), scores[0].tolist()))
        exact = set(ordinals[0, :10].tolist())
        tenth = float(scores[0, 9])
        recalls.append(len(set(routed) & exact) / len(exact))
        tie_recalls.append(sum(ch in exact or exact_score.get(ch, -math.inf) >= tenth - PHASE12_TIE_ATOL for ch in routed) / 10)
    recall, tie_recall = statistics.mean(recalls), statistics.mean(tie_recalls)
    assert tie_recall >= RECALL_MIN, (recall, tie_recall)

    # The sharded exact route at B = 64 against the single-device one.
    emb64 = embed_queries(bench_queries[:64], config=cfg)
    assert emb64.shape[0] == 64, emb64.shape
    launches64: dict[str, int] = {}
    s4, o4 = _counted(launches64, lambda: index4.search_chunks_device(emb64, num_hits=hits, num_results=10, exact=True))
    assert index4.last_route == "dense" and launches64.get("int4_bucket_scan", 0) == 0, launches64
    s1, o1 = index1.search_chunks_device(emb64, num_hits=hits, num_results=10, exact=True)
    torch.cuda.synchronize()
    assert torch.equal(o4, o1), int((o4 != o1).sum())
    exact_equal_scores = bool(torch.equal(s4, s1))
    exact_ms = {
        PHASE12_SHARDS: _p50_ms(lambda _: index4.search_chunks_device(emb64, num_hits=hits, num_results=10, exact=True), range(5)),
        1: _p50_ms(lambda _: index1.search_chunks_device(emb64, num_hits=hits, num_results=10, exact=True), range(5)),
    }
    log(f"phase 12 (a) on {card}: vector_search p50 {p50[PHASE12_SHARDS]:.3f} ms with {PHASE12_SHARDS} shards "
        f"(int4 launches per search {per_search[0]}, asserted), {p50[1]:.3f} ms with num_devices=1, over "
        f"{len(queries)} queries (embed included); recall@10 against the single-device exact route {recall:.4f} by ids, "
        f"{tie_recall:.4f} counting chunks within {PHASE12_TIE_ATOL:.3g} of the exact 10th as hits; the sharded exact "
        f"route at B = 64: ids equal to the single-device exact route (scores bit-equal: {exact_equal_scores}), "
        f"{exact_ms[PHASE12_SHARDS]:.3f} ms against {exact_ms[1]:.3f} ms a batch")

    # Shard 0's int4 scan: bit-exact against its plain version, timed at the
    # shard's shape (phase 5's timing on a view of the shard's arrays).
    shard = types.SimpleNamespace(
        capacity=c, _valid=index4._valid[:1], _packed4=index4._packed4[:1], _scale4=index4._scale4[:1],
    )
    timings = time_kernels(shard, None, emb, card, batches=(1,))
    return {
        "shards": PHASE12_SHARDS, "shard_rows": c, "build_s": build_s,
        "vector_search_p50_ms": p50[PHASE12_SHARDS], "vector_search_p50_ms_one_device": p50[1],
        "recall_at_10": recall, "recall_at_10_ties": tie_recall,
        "exact_b64_ms": exact_ms[PHASE12_SHARDS], "exact_b64_ms_one_device": exact_ms[1],
        "timings": timings,
    }


def phase12_bm25(cfg, seed: int, card: str) -> dict:
    """Phase 12 (b): the keyword index's postings in 4 chunk-range shards on
    the card; 256 tail-term queries equal to resident single-device BM25,
    ids and scores bit for bit."""
    import torch

    from raglite_tpu_torch.index.keyword import keyword_index_from_config
    from raglite_tpu_torch.parallel.mesh import index_devices

    kw = keyword_index_from_config(cfg)
    devices = index_devices(PHASE12_SHARDS, "cuda")
    tail = tail_queries(256, seed)
    single = kw.search_batch(tail, num_hits=20)
    assert kw.last_route == "resident", kw.last_route
    t0 = time.perf_counter()
    sharded = kw.sharded_search_batch(tail, num_hits=20, devices=devices)
    first_s = time.perf_counter() - t0
    assert sharded is not None
    mismatches = sum(s != one for s, one in zip(sharded, single, strict=True))
    assert mismatches == 0, mismatches
    per_shard = kw._res["sharded"]["postings_per_shard"]
    single_ms = _p50_ms(lambda _: kw.search_batch(tail, num_hits=20), range(5))
    sharded_ms = _p50_ms(lambda _: kw.sharded_search_batch(tail, num_hits=20, devices=devices), range(5))
    hits = sum(len(ids) for ids, _ in single)
    log(f"phase 12 (b) BM25 over {PHASE12_SHARDS} chunk-range shards on {card} (C = {kw._res['sharded']['C']} chunks "
        f"each, postings per shard {per_shard}; built and first batch in {first_s:.3f} s): 256 tail-term queries equal "
        f"to resident single-device BM25, ids and scores bit for bit ({hits} hits); a batch of 256 {sharded_ms:.3f} ms "
        f"against {single_ms:.3f} ms on one device")
    torch.cuda.synchronize()
    return {"bm25_batch256_ms": sharded_ms, "bm25_batch256_ms_one_device": single_ms, "bm25_postings_per_shard": per_shard}


def phase12_tp(cfg, question: str, seed: int, card: str, total: dict[str, int], messages=None) -> dict:
    """Phase 12 (c): the `large` decoder (phase 6's object from the LLM
    factory, or one seeded draw) split tensor-parallel over 4 shards on the
    one card, in place: the factory then serves the TP model.  A copy of the
    single-device object keeps the weights it had (the TP shards are fresh
    copies or views of them).  A 2,048-token forward against the
    single-device one, each attention kernel against its plain version at
    the shard's KVH 1, REP 5 (phase 7's cases), a rag() answer and a sampled
    stream through the TP model with every attention launch counted, and
    time to first token and tokens/s beside the single-device model."""
    import copy
    import dataclasses

    import torch

    from raglite_tpu_torch import add_context, rag
    from raglite_tpu_torch.models.decoder import DECODE_CHUNK, _bucket
    from raglite_tpu_torch.models.llm import llm_from_config
    from raglite_tpu_torch.parallel.tp_decoder import TPDecoderModel, shard_chat_llm, tp_devices
    from raglite_tpu_torch.rag import _clip

    rag_cfg = dataclasses.replace(cfg, llm="jax:large")
    llm = llm_from_config(rag_cfg)
    layers = llm.cfg["layers"]
    single = copy.copy(llm)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    shard_chat_llm(llm, tp_devices(PHASE12_TP, "cuda"))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    added = torch.cuda.memory_allocated() - before
    assert isinstance(llm_from_config(rag_cfg).model, TPDecoderModel) and llm.model.tp == PHASE12_TP
    shard0 = llm.params["layers"][0]["shards"][0]
    kvh, rep = llm.cfg["kv_heads"] // PHASE12_TP, llm.cfg["heads"] // llm.cfg["kv_heads"]
    log(f"phase 12 (c) `large` split over {PHASE12_TP} tensor-parallel shards on {llm.model.devices} in {shard_s:.2f} s "
        f"(+{added / 1e9:.3f} GB: column shards copied, row shards views): per shard wq {tuple(shard0['wq'].shape)}, "
        f"w_gate {tuple(shard0['w_gate'].shape)}, w_down {tuple(shard0['w_down'].shape)}, lm_head "
        f"{tuple(llm.params['lm_head'][0].shape)}, KV groups {kvh} (REP {rep}), on {card}")

    # A 2,048-token forward, TP against single-device.
    texts = _markdown_texts()
    ids = torch.tensor([llm.tokenizer.encode("\n\n".join(texts))[:2048]], device="cuda")
    assert ids.shape[1] == 2048, ids.shape
    launches: dict[str, int] = {}
    tp_logits = _counted(launches, lambda: _forward_logits(llm, ids))
    assert launches["gqa_prefill_attention"] == layers * PHASE12_TP, launches
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count
    one_logits = _forward_logits(single, ids)
    diff = float((tp_logits - one_logits).abs().max())
    rel = diff / float(one_logits.abs().max())
    agree = float((tp_logits.argmax(dim=-1) == one_logits.argmax(dim=-1)).float().mean())
    ref = _f32_logits(single, ids)
    scale = float(ref.abs().max())
    err_tp = float((tp_logits - ref).abs().max()) / scale
    err_one = float((one_logits - ref).abs().max()) / scale
    del tp_logits, one_logits, ref
    torch.cuda.empty_cache()
    log(f"phase 12 (c) a 2,048-token forward through {PHASE12_TP} TP shards (prefill kernel launches {launches}) "
        f"against the single-device forward on {card}: max |logit difference| {diff:.4f} = {rel:.4f} of the largest "
        f"|logit| (the JAX test's bound {PHASE12_LOGIT_RTOL}: {'met' if rel <= PHASE12_LOGIT_RTOL else 'missed'}), top-1 "
        f"equal at {agree:.4f} of 2,048 positions (bound {PHASE12_TOP1_MIN}); against an f32 forward of the same weights "
        f"the largest error is {err_tp:.4f} of its largest |logit| with TP, {err_one:.4f} on one device (TP's bounded by "
        f"{PHASE12_ERROR_RATIO} x one device's)")
    assert agree >= PHASE12_TOP1_MIN and err_tp <= PHASE12_ERROR_RATIO * err_one, (rel, agree, err_tp, err_one)

    # A rag() answer through the TP model (the factory's object), to phase
    # 6's message (alone, --only phase12: the same message made again).
    if messages is None:
        messages = [add_context(question, rag_spans(question, rag_cfg), rag_cfg)]
    messages = [dict(m) for m in messages]
    prompt = llm._format_messages(_clip(messages, llm.context_size), None)
    prompt_tokens = min(len(llm.tokenizer.encode(prompt)), llm.context_size - 129) + 1
    assert prompt_tokens > 1000, prompt_tokens  # a RAG prompt, not an empty one
    rag_s = _bucket(prompt_tokens) + _bucket(128) + DECODE_CHUNK
    launches_rag: dict[str, int] = {}
    pieces, first_ms, rag_ms = _counted(launches_rag, lambda: _timed_tokens(rag(messages, config=rag_cfg)))
    stats = dict(llm.spec_stats)
    assert pieces and stats["tokens"] > 0, stats
    assert launches_rag["gqa_prefill_attention"] == layers * PHASE12_TP, launches_rag
    assert launches_rag["gqa_verify_attention"] == layers * PHASE12_TP * stats["verify_iters"], (launches_rag, stats)
    launches_sampled: dict[str, int] = {}
    sampled = _counted(launches_sampled, lambda: "".join(llm.stream(messages[:1], max_tokens=DECODE_CHUNK, **llm.RECOMMENDED_SAMPLING)))
    assert sampled and launches_sampled["gqa_decode_attention"] == layers * PHASE12_TP * DECODE_CHUNK, launches_sampled
    for counts in (launches_rag, launches_sampled):
        for name, count in counts.items():
            total[name] = total.get(name, 0) + count
    per_shard = {
        "gqa_prefill_attention": launches_rag["gqa_prefill_attention"] // PHASE12_TP,
        "gqa_verify_attention": launches_rag["gqa_verify_attention"] // PHASE12_TP,
        "gqa_decode_attention": launches_sampled["gqa_decode_attention"] // PHASE12_TP,
    }
    assert all(v > 0 for v in per_shard.values()), per_shard
    log(f"phase 12 (c) rag() through the TP model: {stats['tokens']} tokens in {rag_ms:.1f} ms (first piece after "
        f"{first_ms:.1f} ms, {stats['verify_iters']} verify forwards), then a sampled stream of {DECODE_CHUNK} decode "
        f"forwards; attention launches per shard {per_shard}, on {card}")

    # Time to first token and tokens/s: TP against single-device, greedy
    # speculative, the same prompt.
    metrics = {}
    for name, model in (("tp", llm), ("one_device", single)):
        tokens, ttft, ms = _timed_tokens(model._generate_tokens(prompt, max_new_tokens=128))
        metrics[name] = {"ttft_ms": ttft, "tokens_per_s": len(tokens) / max((ms - ttft) / 1e3, 1e-9), "tokens": tokens}
    common = next(
        (i for i, (a, b) in enumerate(zip(metrics["tp"]["tokens"], metrics["one_device"]["tokens"])) if a != b),
        min(len(metrics["tp"]["tokens"]), len(metrics["one_device"]["tokens"])),
    )
    log(f"phase 12 (c) on {card}, prompt {prompt_tokens} tokens, greedy speculative, 128 new tokens at most: "
        f"time to first token {metrics['tp']['ttft_ms']:.1f} ms with TP {PHASE12_TP} on one card, "
        f"{metrics['one_device']['ttft_ms']:.1f} ms on one device; decode after it "
        f"{metrics['tp']['tokens_per_s']:.2f} tokens/s with TP, {metrics['one_device']['tokens_per_s']:.2f} on one "
        f"device; the two greedy answers share their first {common} tokens")

    # Each attention kernel at the shard's KV groups, checked and timed at
    # the shapes this phase launched: the answer's decode, verify and
    # prefill, and the 2,048-token forward's prefill.
    cases = [
        ("gqa_decode_attention", 1, rag_s, [prompt_tokens]),
        ("gqa_verify_attention", 8, rag_s, [prompt_tokens]),
        ("gqa_prefill_attention", _bucket(prompt_tokens), rag_s, [0]),
        ("gqa_prefill_attention", 2048, 2048, [0]),
    ]
    timings = time_attention(seed + 12, rag_s, prompt_tokens, _bucket(prompt_tokens), card, cases=cases, kvh=kvh, rep=rep)
    del single, llm
    _release_llms()
    return {
        "tp": PHASE12_TP, "shard_s": shard_s, "tp_added_gb": added / 1e9, "logits_rel_diff": rel, "top1_share": agree,
        "f32_error_tp": err_tp, "f32_error_one_device": err_one,
        "launches_per_shard": per_shard, "common_prefix": common,
        **{f"{k}_{name}": v[k] for name, v in metrics.items() for k in ("ttft_ms", "tokens_per_s")},
        "timings": timings,
    }


def phase12_shard_data(seed: int, shards: range):
    """The rows of ``shards`` of phase 12 (d)'s global index (unit bf16 rows
    drawn on the card, one generator per shard, so a rank draws only its
    own) and its queries (unit f32 rows of their own generator): (rows per
    shard, queries [Q, d])."""
    import torch

    def unit(n: int, stream: int):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + stream)
        x = torch.randn((n, D), generator=g, device="cuda")
        return x / x.norm(dim=1, keepdim=True)

    return [unit(PHASE12_SHARD_ROWS, s).to(torch.bfloat16) for s in shards], unit(PHASE12_RANK_QUERIES, 999)


def phase12_search(rows, queries, devices, group=None):
    """Phase 12 (d)'s two searches over row shards ``rows``: the sharded
    exact scan and the sharded int4 two-stage route, top 10."""
    import torch

    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.parallel.sharded import sharded_int4_two_stage, sharded_topk_search

    zeros = [torch.zeros(r.shape[0], device=r.device) for r in rows]
    valid = [torch.ones(r.shape[0], dtype=torch.bool, device=r.device) for r in rows]
    exact = sharded_topk_search(rows, zeros, valid, queries, None, num_hits=10, metric="cosine", devices=devices, group=group)
    packed = [fs.pack_rows_int4(r) for r in rows]
    int4 = sharded_int4_two_stage(
        [p for p, _ in packed], [s for _, s in packed], rows, None, zeros, valid, queries,
        num_hits=10, candidates=fs.INT4_STAGE1_CANDIDATES, metric="cosine", devices=devices,
        num_buckets=fs.INT4_NUM_BUCKETS, group=group,
    )
    return exact, int4


def phase12_rank(rank: int, coordinator: str, out: str, seed: int) -> int:
    """One rank of phase 12 (d) (run as ``chip_smoke.py --phase12-rank``):
    its 2 of the 4 shards on cuda:0, both searches merged across the gloo
    group, rank 0 saving the merged winners."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from raglite_tpu_torch.ops import fused_scan as fs
    from raglite_tpu_torch.parallel.mesh import distributed_init, index_devices

    distributed_init(coordinator, 2, rank, backend="gloo")
    local = PHASE12_SHARDS // 2
    rows, queries = phase12_shard_data(seed, range(rank * local, (rank + 1) * local))
    devices = index_devices(local, "cuda")
    fs.reset_launch_counts()
    (es, ei), (s4, i4) = phase12_search(rows, queries, devices, group=dist.group.WORLD)
    torch.cuda.synchronize()
    log(f"phase 12 (d) rank {rank}: backend {dist.get_backend()}, world {dist.get_world_size()}, shards "
        f"{list(range(rank * local, (rank + 1) * local))} on {devices}, int4 launches {fs.launch_counts['int4_bucket_scan']}")
    if rank == 0:
        np.savez(out, es=es.cpu().numpy(), ei=ei.cpu().numpy(), s4=s4.cpu().numpy(), i4=i4.cpu().numpy())
    dist.destroy_process_group()
    return 0


def phase12_ranks(seed: int, card: str) -> dict:
    """Phase 12 (d): two processes, each holding 2 of the 4 shards on
    cuda:0, joined by a gloo group (NCCL refuses two ranks on one card, so
    the winners cross through host memory), against the same 4 shards in
    this process: ids equal, scores equal to f32 rounding.  Each rank has
    its own time limit; a rank that fails fails the run."""
    import socket
    import tempfile

    import numpy as np
    import torch

    from raglite_tpu_torch.parallel.mesh import index_devices

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    with tempfile.TemporaryDirectory(prefix="phase12_") as tmp:
        out = str(Path(tmp) / "ranks.npz")
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--phase12-rank", str(rank), "--coordinator", coordinator,
                 "--out", out, "--seed", str(seed)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
            )
            for rank in (0, 1)
        ]
        try:
            for rank, proc in enumerate(procs):
                text, _ = proc.communicate(timeout=PHASE12_RANK_TIMEOUT)
                for line in text.splitlines():
                    log(f"  [rank {rank}] {line}")
                assert proc.returncode == 0, f"phase 12 (d) rank {rank} exited {proc.returncode}"
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        ranks_s = time.perf_counter() - t0
        got = np.load(out)
        rows, queries = phase12_shard_data(seed, range(PHASE12_SHARDS))
        (es, ei), (s4, i4) = phase12_search(rows, queries, index_devices(PHASE12_SHARDS, "cuda"))
        torch.cuda.synchronize()
        for ids_key, scores_key, ids, scores in (("ei", "es", ei, es), ("i4", "s4", i4, s4)):
            np.testing.assert_array_equal(got[ids_key], ids.cpu().numpy())
            np.testing.assert_allclose(got[scores_key], scores.cpu().numpy(), rtol=2.0**-23, atol=0)
        bit_equal = all(np.array_equal(got[k], v.cpu().numpy()) for k, v in (("es", es), ("s4", s4)))
    # The exact route against one scan of the whole matrix.
    from raglite_tpu_torch.index.dense import _dense_search

    whole = torch.cat(rows)
    n = whole.shape[0]
    _, oracle = _dense_search(
        whole, torch.zeros(n, device="cuda"), torch.ones(n, dtype=torch.bool, device="cuda"), queries,
        num_hits=10, metric="cosine",
    )
    assert torch.equal(ei, oracle), int((ei != oracle).sum())
    del whole
    overlap = float(sum(len(set(a) & set(b)) for a, b in zip(i4.tolist(), ei.tolist())) / ei.numel())
    log(f"phase 12 (d) two ranks (gloo, 2 of {PHASE12_SHARDS} shards of {PHASE12_SHARD_ROWS} x {D} each, on cuda:0) "
        f"= this process's {PHASE12_SHARDS}-shard search on {card}: exact and int4 routes, ids equal, scores equal to "
        f"f32 rounding (bit-equal: {bit_equal}), the exact route = one scan of the whole matrix, int4 top-10 overlap with it "
        f"{overlap:.4f}; both ranks done in {ranks_s:.1f} s")
    del rows
    return {"ranks_s": ranks_s, "ranks_bit_equal": bit_equal, "ranks_int4_overlap": overlap}


def _without_timings(summary: dict) -> dict:
    """A phase summary without its per-kernel timing lists (printed apart)."""
    return {k: _without_timings(v) if isinstance(v, dict) else v for k, v in summary.items() if k != "timings"}


def phase12(cfg, texts: list[str], queries: list[str], seed: int, card: str, total: dict[str, int], messages=None) -> dict:
    """Phase 12 (a)-(d) on the one card over the phase-3 store and phase
    6's decoder (and its RAG message, where given); ``total`` gathers the
    launches of (a)-(c) in this process."""
    out = {"index": phase12_index(cfg, queries, pick_queries(texts, 64, seed + 12), card, total)}
    out["bm25"] = phase12_bm25(cfg, seed, card)
    out["tp"] = phase12_tp(cfg, queries[0], seed, card, total, messages)
    out["ranks"] = phase12_ranks(seed, card)
    return out


# --- Phase 13: the IR benchmark, its HNSW baseline and the CLI's bench -----

#: BAAI/bge-base-en-v1.5's config.json: its published widths.
BGE_BASE_CONFIG = {
    "architectures": ["BertModel"], "model_type": "bert", "num_hidden_layers": 12, "hidden_size": 768,
    "num_attention_heads": 12, "intermediate_size": 3072, "vocab_size": 30522, "max_position_embeddings": 512,
    "type_vocab_size": 2, "pad_token_id": 0, "layer_norm_eps": 1e-12, "hidden_act": "gelu",
    "position_embedding_type": "absolute",
}
#: BERT's special tokens at their ids in bert-base-uncased's (and bge-base's) vocabulary.
BERT_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
#: Phase 13: the IR benchmark's queries (and the synthetic corpus's documents).
PHASE13_QUERIES = 64
#: Phase 13 (b): the rerank evaluator's queries (the first of the
#: PHASE13_QUERIES): its time is the host's language detection of each
#: candidate (PERF.md §5), 16.7-25.9 s at 64.
PHASE13_RERANK_QUERIES = 16
#: Phase 13 (a): the synthetic benchmark's queries (and documents) on each
#: device; 16, since its CPU half took 191-246 s at 64 and 105-164 s at 32,
#: the run's longest host-bound part.
PHASE13_SYNTHETIC_QUERIES = 16
#: Phase 13 (a): the dense variants' AP@10 on the card against the CPU's.
#: The two encoders round differently (bf16 on the card, f32 on the CPU), so
#: near-tied chunks may trade ranks (ROADMAP queue 3): 0.05 lets one query
#: in 16 drop its document one rank (0.031), not out of the top 10 (0.0625).
#: Keyword (BM25, no encoder) must be equal.
PHASE13_AP_ATOL = 0.05
#: Phase 13 (c): the HNSW comparison's rows and width (the graph is built in
#: one thread on the host; M 32, ef_construction 200, ef_search 160).  At
#: 1,500 rows the f16 scan's recall@10 read 0.9984 against HNSW's 1.0000
#: (one neighbour of 640 lost to f16 rounding), failing (c)'s assertion.
PHASE13_HNSW_ROWS = 3000
PHASE13_HNSW_DIM = 256
#: Phase 13 (d): the queries of the CLI's ``bench`` in a fresh process.
PHASE13_CLI_QUERIES = 8


def wordpiece_tokenizer_json(texts: list[str], vocab_size: int = 30_522) -> dict:
    """A bge-base-style WordPiece tokenizer.json made by hand (the card has
    no ``tokenizers``): BERT's layout (``[PAD]`` 0, ``[unused0-98]``,
    ``[UNK]`` 100, ``[CLS]`` 101, ``[SEP]`` 102, ``[MASK]`` 103), then the
    characters of ``texts`` as BERT normalizes them (lowercased, accents
    stripped) and each as a ``##`` piece, the frequent words, frequent word
    endings as ``##`` pieces, and ``[unused]`` fillers up to ``vocab_size``;
    BertNormalizer, BertPreTokenizer, the [CLS]/[SEP] template and the
    WordPiece decoder."""
    import re
    import unicodedata
    from collections import Counter

    words, chars, endings = Counter(), Counter(), Counter()
    for text in texts:
        folded = "".join(c for c in unicodedata.normalize("NFD", text.lower()) if unicodedata.category(c) != "Mn")
        for word in re.findall(r"\w+|[^\w\s]", folded):
            words[word] += 1
            chars.update(word)
            for k in (2, 3, 4):
                if len(word) > k + 1:
                    endings["##" + word[-k:]] += 1
    vocab = {f"[unused{i}]": i + 1 for i in range(99)}
    vocab.update(BERT_SPECIALS)
    for piece in [*(c for c, _ in chars.most_common()), *("##" + c for c, _ in chars.most_common())]:
        vocab.setdefault(piece, len(vocab))
    for piece in [*(w for w, _ in words.most_common(20_000) if len(w) > 1), *(e for e, _ in endings.most_common(3_000))]:
        if len(vocab) < vocab_size:
            vocab.setdefault(piece, len(vocab))
    filler = 99
    while len(vocab) < vocab_size:
        vocab.setdefault(f"[unused{filler}]", len(vocab))
        filler += 1
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False, "special": True}
            for t, i in BERT_SPECIALS.items()
        ],
        "normalizer": {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True, "strip_accents": None, "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}, {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}, {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}, {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [BERT_SPECIALS[t]], "tokens": [t]} for t in ("[CLS]", "[SEP]")},
        },
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##", "max_input_chars_per_word": 100, "vocab": vocab},
    }


def truncating_tokenizer_json(spec: dict, max_length: int | None = 512) -> dict:
    """Phase 13 (b)'s second tokenizer.json: ``wordpiece_tokenizer_json``'s
    vocabulary (``spec``) behind a ``Sequence`` of the Nmt, Strip and BERT
    normalizers and one of the WhitespaceSplit, Punctuation and Digits
    pre-tokenizers, truncated to ``max_length`` from the right (None: not
    truncated), not padded."""
    truncation = None if max_length is None else {
        "direction": "Right", "max_length": max_length, "strategy": "LongestFirst", "stride": 0}
    return {
        **spec, "truncation": truncation, "padding": None,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Nmt"}, {"type": "Strip", "strip_left": True, "strip_right": True}, spec["normalizer"]]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"}, {"type": "Punctuation", "behavior": "Isolated"},
            {"type": "Digits", "individual_digits": False}]},
    }


def write_beir(directory: Path, dataset) -> Path:
    """``dataset`` as a BEIR directory (corpus.jsonl, queries.jsonl,
    qrels.tsv): each document's first line as its title, the rest as its
    text, so that beir_directory_dataset gives the same contents back."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "corpus.jsonl", "w", encoding="utf-8") as fh:
        for doc in dataset.documents:
            title, _, text = doc.content.partition("\n\n")
            fh.write(json.dumps({"_id": doc.id, "title": title.lstrip("# "), "text": text}) + "\n")
    with open(directory / "queries.jsonl", "w", encoding="utf-8") as fh:
        for qid, text in dataset.queries.items():
            fh.write(json.dumps({"_id": qid, "text": text}) + "\n")
    with open(directory / "qrels.tsv", "w", encoding="utf-8") as fh:
        fh.write("query-id\tcorpus-id\tscore\n")
        for qid, qrel in dataset.qrels.items():
            fh.writelines(f"{qid}\t{did}\t{rel}\n" for did, rel in qrel.items())
    return directory


@contextlib.contextmanager
def _bench_cache(path: Path):
    """Point ``RAGLITE_TPU_BENCH_CACHE`` (the IR benchmark's run cache) at a
    fresh directory for the block."""
    import os

    old = os.environ.get("RAGLITE_TPU_BENCH_CACHE")
    os.environ["RAGLITE_TPU_BENCH_CACHE"] = str(path)
    try:
        yield path
    finally:
        if old is None:
            os.environ.pop("RAGLITE_TPU_BENCH_CACHE", None)
        else:
            os.environ["RAGLITE_TPU_BENCH_CACHE"] = old


def _ap(table, variant: str, measure: str = "AP@10") -> float:
    """A variant's value in run_ir_benchmark's table (a DataFrame, or its
    rows where pandas is missing)."""
    if hasattr(table, "loc"):
        return float(table.loc[variant, measure])
    return float(next(row[measure] for row in table if row["variant"] == variant))


def phase13_synthetic(root: str, device: str) -> dict:
    """Phase 13 (a): run_ir_benchmark on the synthetic dataset, every
    variant one by one, on the default config on ``device`` (fresh run
    caches): {variant: {"AP@10", "s"}}."""
    from raglite_tpu_torch import RAGLiteConfig
    from raglite_tpu_torch.irbench import VARIANTS, run_ir_benchmark

    cfg = RAGLiteConfig(store_path=str(Path(root) / f"a-{device}" / "store"), device=device)
    rows = {}
    with _bench_cache(Path(root) / f"a-{device}-cache"):
        for variant in VARIANTS:
            t0 = time.perf_counter()
            table = run_ir_benchmark(
                dataset="synthetic", num_queries=PHASE13_SYNTHETIC_QUERIES, variants=(variant,), config=cfg
            )
            assert len(table) == 1, (variant, table)  # the hnsw row too: the card's machine has g++
            rows[variant] = {"AP@10": _ap(table, variant), "s": time.perf_counter() - t0}
    return rows


def phase13_synthetic_check(out: dict, card: str) -> None:
    """Phase 13 (a)'s check: the card's rows against the CPU's."""
    from raglite_tpu_torch.irbench import VARIANTS

    for device, rows in out.items():
        log(f"phase 13 (a) run_ir_benchmark(synthetic, {PHASE13_SYNTHETIC_QUERIES} queries) on {device}: "
            + ", ".join(f"{v} AP@10 {r['AP@10']:.4f} in {r['s']:.2f} s" for v, r in rows.items()) + f" ({card})")
    cuda, cpu = out["cuda"], out["cpu"]
    assert cuda["keyword"]["AP@10"] == cpu["keyword"]["AP@10"], (cuda["keyword"], cpu["keyword"])
    for variant in VARIANTS:
        assert abs(cuda[variant]["AP@10"] - cpu[variant]["AP@10"]) <= PHASE13_AP_ATOL, (variant, cuda[variant], cpu[variant])


def phase13_bert(rows: int, seed: int, root: Path, card: str, total: dict[str, int]) -> dict:
    """Phase 13 (b): a BERT-shaped encoder at bge-base-en-v1.5's widths with
    a hand-made WordPiece tokenizer.json, serving the multivector, rerank
    and hybrid evaluators over a BEIR directory of the synthetic dataset in
    one store seeded with background rows up to ``rows``."""
    import dataclasses

    import torch

    from raglite_tpu_torch import RAGLiteConfig
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.irbench import IRDataset, RAGLiteTPUEvaluator, beir_directory_dataset, synthetic_dataset
    from raglite_tpu_torch.models.encoder import encoder_from_config
    from raglite_tpu_torch.store import store_from_config

    ckpt = root / "bge-base"
    t0 = time.perf_counter()
    ckpt.mkdir(parents=True)
    tokenizer_spec = wordpiece_tokenizer_json(_markdown_texts())
    (ckpt / "tokenizer.json").write_text(json.dumps(tokenizer_spec))
    written = write_bge_m3_checkpoint(ckpt, seed + 13, config=BGE_BASE_CONFIG)
    write_s = time.perf_counter() - t0
    dataset = beir_directory_dataset(str(write_beir(root / "synthetic-beir", synthetic_dataset(num_docs=PHASE13_QUERIES))))
    cfg = RAGLiteConfig(store_path=str(root / "b" / "store"), embedder=f"flax:{ckpt}", device="cuda")
    # The rerank on the first PHASE13_RERANK_QUERIES queries (the same
    # documents and store): its host work is most of its time.
    kept = list(dataset.queries)[:PHASE13_RERANK_QUERIES]
    rerank_set = IRDataset(dataset.name, dataset.documents, {q: dataset.queries[q] for q in kept},
                           {q: dataset.qrels[q] for q in kept if q in dataset.qrels})
    evaluators = {
        v: RAGLiteTPUEvaluator(rerank_set if v == "rerank" else dataset, variant=v, config=cfg, cache_dir=str(root / "b-cache"))
        for v in ("multivector", "rerank", "hybrid")
    }
    first = evaluators["multivector"]
    t0 = time.perf_counter()
    first.insert_documents()
    insert_s = time.perf_counter() - t0
    store = store_from_config(first.config)
    doc_rows = sum(m.shape[0] for m in store.embeddings.values())
    t0 = time.perf_counter()
    add_background(store, rows - doc_rows, seed + 13)
    seed_s = time.perf_counter() - t0
    index = dense_index_from_config(first.config)
    assert index.num_rows == rows, index.num_rows
    log(f"phase 13 (b) bge-base-shaped BF16 BERT (12 layers, d 768, 30,522 x 768 embedding, 512 positions): "
        f"{written / 1e9:.3f} GB and a WordPiece tokenizer.json written in {write_s:.2f} s; {len(dataset.documents)} "
        f"documents of the BEIR directory ({doc_rows} rows) inserted in {insert_s:.2f} s, {rows - doc_rows} background "
        f"rows in {seed_s:.2f} s, on {card}")
    runs, out = {}, {"insert_s": insert_s, "seed_s": seed_s, "write_s": write_s}
    programs = {"encoder": encoder_from_config(first.config).programs, "index": index.programs}
    mix_before = _graph_mix(programs)
    for variant, evaluator in evaluators.items():
        launches: dict[str, int] = {}
        t0 = time.perf_counter()
        runs[variant] = _counted(launches, lambda e=evaluator: e.runs(num_results=10, refresh=True))
        seconds = time.perf_counter() - t0
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
        assert index.last_route == "int4_two_stage", (variant, index.last_route)
        assert launches.get("int4_bucket_scan", 0) == len(evaluator.dataset.queries), (variant, launches)
        out[variant] = {"AP@10": evaluator.score("AP@10"), "runs_s": seconds}
    out["graph_mix"] = _graph_mix_since(programs, mix_before)
    log(f"phase 13 (b) retrieval graphs over the three evaluators' runs: {json.dumps(out['graph_mix'])}, on {card}")
    exact = RAGLiteTPUEvaluator(
        dataset, variant="multivector", config=dataclasses.replace(cfg, use_int4_stage1=False), cache_dir=str(root / "b-exact-cache")
    )
    exact_runs = exact.runs(num_results=10, refresh=True)
    assert dense_index_from_config(exact.config).last_route == "dense"
    recall = statistics.mean(
        len(set(runs["multivector"][q]) & set(want)) / max(len(want), 1) for q, want in exact_runs.items()
    )
    assert recall >= RECALL_MIN, recall
    queries = list(dataset.queries.values())
    search_p50 = _counted(total, lambda: _p50_ms(lambda q: first.search(q, 10), queries[:32]))
    encoder = encoder_from_config(first.config)
    texts = [d.content for d in dataset.documents]
    encoder.embed_token_level_batch(texts[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoder.embed_token_level_batch(texts)
    torch.cuda.synchronize()
    tokens_per_s = sum(encoder.count_tokens(texts)) / (time.perf_counter() - t0)
    out.update({"recall_at_10_docs": recall, "search_p50_ms": search_p50, "encoder_tokens_per_s": tokens_per_s})
    log(f"phase 13 (b) over {index.num_rows} rows on {card}: AP@10 (seeded weights: not a quality number) "
        + ", ".join(f"{v} {out[v]['AP@10']:.4f} (runs of {len(e.dataset.queries)} queries {out[v]['runs_s']:.2f} s)"
                    for v, e in evaluators.items())
        + f"; int4 launches one a dense query (asserted); multivector document runs' recall@10 against the exact route "
        f"{recall:.4f}; one evaluator search p50 {search_p50:.3f} ms; the encoder {tokens_per_s:.0f} tokens/s "
        f"(token-level batches of the {len(texts)} documents)")
    out["truncation"] = phase13_truncation(first.config, ckpt, tokenizer_spec, index, texts, queries[:8], card, total)
    return out


def phase13_truncation(cfg, ckpt: Path, spec: dict, index, texts: list[str], queries: list[str], card: str,
                       total: dict[str, int]) -> dict:
    """Phase 13 (b)'s truncating tokenizer: the same weights (linked) beside
    ``truncating_tokenizer_json(spec)`` served as ``flax:<dir>`` over the
    phase's store: ``queries`` through vector_search (one int4 launch each),
    a token-level batch of the 8 longest of the phase's documents and the
    Markdown documents (each cut to its first 512 ids, asserted against the
    same components untruncated), and the queries' embeddings on the card
    against the CPU's."""
    import dataclasses
    import os
    import shutil

    import numpy as np

    from raglite_tpu_torch.embed import embed_queries
    from raglite_tpu_torch.models.encoder import encoder_from_config
    from raglite_tpu_torch.models.tokenizer import HFTokenizer
    from raglite_tpu_torch.search import vector_search

    t0 = time.perf_counter()
    trunc = ckpt.parent / "bge-base-truncating"
    trunc.mkdir()
    for name in ("model.safetensors", "config.json"):
        try:
            os.link(ckpt / name, trunc / name)
        except OSError:
            shutil.copyfile(ckpt / name, trunc / name)
    (trunc / "tokenizer.json").write_text(json.dumps(truncating_tokenizer_json(spec)))
    (trunc / "untruncated.json").write_text(json.dumps(truncating_tokenizer_json(spec, None)))
    tcfg = dataclasses.replace(cfg, embedder=f"flax:{trunc}")
    launches: dict[str, int] = {}
    _counted(launches, lambda: [vector_search(q, num_results=10, config=tcfg) for q in queries])
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count
    assert index.last_route == "int4_two_stage" and launches.get("int4_bucket_scan", 0) == len(queries), launches
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoder = encoder_from_config(tcfg)
    longest = sorted([*texts, *_markdown_texts()], key=len, reverse=True)[:8]
    states = encoder.embed_token_level_batch(longest)
    full = HFTokenizer(str(trunc / "untruncated.json"))
    lengths = []
    for text, state in zip(longest, states):
        ids, untruncated = encoder._tokenizer.encode(text), full.encode(text)
        assert len(ids) <= 512 and ids == untruncated[:512] and state.shape == (len(ids), 768), (len(ids), state.shape)
        assert np.isfinite(state).all()
        lengths.append(len(untruncated))
    assert max(lengths) > 512, lengths  # the cut was exercised
    tokens_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_emb = embed_queries(queries, config=tcfg)
    cpu_emb = embed_queries(queries, config=dataclasses.replace(tcfg, device="cpu"))
    err = float(np.abs(card_emb - cpu_emb).max())
    cos = float(min(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) for a, b in zip(card_emb, cpu_emb)))
    cpu_s = time.perf_counter() - t0
    log(f"phase 13 (b) truncating tokenizer.json (Nmt, Strip, BertNormalizer; WhitespaceSplit, Punctuation, Digits; "
        f"truncation 512): {len(queries)} vector_search calls in {search_s:.2f} s (launches {launches}); a token-level "
        f"batch of the 8 longest documents (untruncated {sorted(lengths)} ids, each longer one cut to its first 512) in "
        f"{tokens_s:.2f} s; the {len(queries)} query embeddings on the card against the CPU's: max |diff| {err:.3g} "
        f"(limit {PHASE13_AP_ATOL}), least cosine {cos:.6f}, in {cpu_s:.2f} s; on {card}")
    assert card_emb.shape == (len(queries), 768) and np.isfinite(card_emb).all()
    assert err <= PHASE13_AP_ATOL, err
    return {"search_s": search_s, "tokens_s": tokens_s, "cpu_s": cpu_s, "max_abs_diff": err, "min_cos": cos,
            "untruncated_lengths": lengths}


def phase13_hnsw(card: str) -> dict:
    """Phase 13 (c): hnsw_recall_comparison with the dense scan on the card;
    the graph's build and query times read through a timing subclass."""
    from raglite_tpu_torch import native
    from raglite_tpu_torch.irbench import hnsw_recall_comparison

    times: dict[str, float] = {}

    class TimedHnsw(native.HnswIndex):
        def add(self, vectors):
            t0 = time.perf_counter()
            super().add(vectors)
            times["build_s"] = time.perf_counter() - t0

        def search(self, queries, k, *, ef_search=160):
            t0 = time.perf_counter()
            found = super().search(queries, k, ef_search=ef_search)
            times["query_ms"] = (time.perf_counter() - t0) * 1e3 / len(queries)
            return found

    plain = native.HnswIndex
    native.HnswIndex = TimedHnsw
    try:
        t0 = time.perf_counter()
        report = hnsw_recall_comparison(num_rows=PHASE13_HNSW_ROWS, dim=PHASE13_HNSW_DIM, M=32, device="cuda")
        total_s = time.perf_counter() - t0
    finally:
        native.HnswIndex = plain
    assert report["tpu_fp16_recall"] >= report["hnsw_recall"] - 1e-9, report
    assert report["tpu_fp16_memory_bytes"] < report["hnsw_memory_bytes"], report
    assert report["tpu_int8_memory_bytes"] < 0.5 * report["hnsw_memory_bytes"], report
    assert report["tpu_int8_recall"] >= 0.95, report
    log(f"phase 13 (c) hnsw_recall_comparison({PHASE13_HNSW_ROWS} x {PHASE13_HNSW_DIM}, M 32, ef_search 160; the scan on "
        f"the card) in {total_s:.1f} s: recall@10 f16 scan {report['tpu_fp16_recall']:.4f} ({report['tpu_fp16_memory_bytes']:.0f} B), "
        f"int8 scan {report['tpu_int8_recall']:.4f} ({report['tpu_int8_memory_bytes']:.0f} B), HNSW {report['hnsw_recall']:.4f} "
        f"({report['hnsw_memory_bytes']:.0f} B); HNSW build {times['build_s']:.2f} s (one host thread), "
        f"{times['query_ms']:.3f} ms a query ({card})")
    return {**report, **times, "total_s": total_s}


def phase13_cli_start(root: Path):
    """Phase 13 (d), started: ``bench`` and ``bench --hnsw-recall`` through
    the CLI, each in a fresh process on the card, from two threads (they
    run beside (c), whose HNSW build holds one host core)."""
    from concurrent.futures import ThreadPoolExecutor

    env = {"RAGLITE_TPU_BENCH_CACHE": str(root / "d-cache")}
    pool = ThreadPoolExecutor(2)
    table = pool.submit(
        _cli, root / "d" / "store", "--device", "cuda", "bench", "--num-queries", str(PHASE13_CLI_QUERIES), env=env,
    )
    report = pool.submit(_cli, root / "d2" / "store", "--device", "cuda", "bench", "--hnsw-recall", "--num-rows", "1000", env=env)
    pool.shutdown(wait=False)
    return table, report


def phase13_cli(started, card: str) -> dict:
    """Phase 13 (d), finished: both commands exited 0 and printed the seven
    variants' table and the report."""
    from raglite_tpu_torch.irbench import VARIANTS

    (table, _, table_s), (report_text, _, report_s) = (future.result() for future in started)
    lines = table.strip().splitlines()
    values = {line.split()[0]: float(line.split()[1]) for line in lines[2:]}
    assert list(values) == list(VARIANTS) and "AP@10" in lines[0], table
    report = json.loads(report_text.strip().splitlines()[-1])
    assert report["num_rows"] == 1000.0 and report["tpu_fp16_recall"] >= report["hnsw_recall"] - 1e-9, report
    log(f"phase 13 (d) `bench --num-queries {PHASE13_CLI_QUERIES}` in a fresh process: {table_s:.1f} s, AP@10 {values}; "
        f"`bench --hnsw-recall --num-rows 1000`: {report_s:.1f} s, {report} (both beside (c); {card})")
    return {"bench_s": table_s, "bench": values, "hnsw_recall_s": report_s}


def phase13_join(out: dict, cpu_half, card: str) -> None:
    """Phase 13 (a), finished: wait for the CPU half (a ``beside`` join of
    ``phase13_synthetic``) and hold the card's rows in ``out`` to it."""
    out["synthetic"]["cpu"], out["synthetic_cpu_s"] = cpu_half(timeout=900)
    phase13_synthetic_check(out["synthetic"], card)
    mark("phase 13 (a) on the CPU")


def phase13(rows: int, seed: int, card: str, total: dict[str, int], *, cpu_half=None) -> dict:
    """Phase 13: (a)-(d) in a temporary directory (deleted at the end).
    (a)'s CPU half runs in a process of its own beside the card's work:
    started and joined here, or, given ``cpu_half`` (the caller's ``beside``
    join of ``phase13_synthetic``), joined later by the caller
    (``phase13_join``), so that it also runs beside the next phase."""
    import shutil

    root = scratch_dir(1_000_000_000, "phase13_")
    try:
        with contextlib.ExitStack() as stack:
            if own := cpu_half is None:
                cpu_half = stack.enter_context(beside("phase13_synthetic", str(root), "cpu"))
            out = {"synthetic": {"cuda": phase13_synthetic(str(root), "cuda")}}
            mark("phase 13 (a) on the card")
            _fresh_memory_store()
            out["bert"] = phase13_bert(rows, seed, root, card, total)
            mark("phase 13 (b)")
            _fresh_memory_store()
            started = phase13_cli_start(root)
            out["hnsw"] = phase13_hnsw(card)
            mark("phase 13 (c)")
            if own:
                phase13_join(out, cpu_half, card)
        out["cli"] = phase13_cli(started, card)
        mark("phase 13 (d)")
    finally:
        _fresh_memory_store()
        shutil.rmtree(root, ignore_errors=True)
    return out


#: Phase 14: new tokens each path generates for the graph-against-eager
#: comparison: 2 decode chunks of 32, so every step form replays across a
#: chunk boundary (more only cost the run's time limit).
PHASE14_TOKENS = 64
#: Phase 14 (a): steps of the eager decode chunk in its profile window (each
#: eager step is the same ~2,200 device ops; the window's events, which the
#: profiler sorts out on the host, grow with the steps).
PHASE14_EAGER_STEPS = 4
#: Phase 14: how far a graph step's logits may lie from the eager step's on
#: the same inputs, as a share of the largest |logit|.  Expected: 0, bit for
#: bit (the same kernels and cuBLAS calls in the same order).  The bound is
#: room for cuBLAS choosing another algorithm, another bf16 summation order,
#: under capture: phase 12 measured two summation orders of `large`'s forward
#: 0.0203 of the largest |logit| apart.
PHASE14_LOGIT_RTOL = 0.02
#: Phase 14 (e): the question answered beside phase 6's RAG prompt.
PHASE14_QUESTION = "Name three things a retrieval-augmented answer depends on."


def _prefilled(llm, prompts: list[str], max_new: int):
    """``TorchChatLLM``'s prefill of ``prompts`` on the current stream (B = 1
    as ``_generate_tokens`` pads it; more as ``_generate_batch``: rows to a
    multiple of 8): (prompt ids per row, cache, lens [B], last logits [B, V],
    max_total)."""
    import torch

    from raglite_tpu_torch.models.decoder import DECODE_CHUNK, _bucket, _prefill_last
    from raglite_tpu_torch.utils.padding import round_up

    tok = llm.tokenizer
    budget = max(llm.context_size - max_new - 1, 16)
    encoded = [([tok.BOS] if llm._byte_level else []) + tok.encode(p)[-budget:] for p in prompts]
    rows = 1 if len(prompts) == 1 else round_up(len(prompts), 8)
    pad = _bucket(max(len(ids) for ids in encoded))
    ids = torch.full((rows, pad), tok.PAD, dtype=torch.int64)
    lens = torch.ones((rows,), dtype=torch.int64)
    for i, row in enumerate(encoded):
        ids[i, : len(row)] = torch.tensor(row)
        lens[i] = len(row)
    max_total = pad + _bucket(max_new) + DECODE_CHUNK
    cache = llm.model.init_cache(rows, max_total, device=llm.device)
    lens = lens.to(llm.device)
    last, cache = _prefill_last(llm.model, llm.params, ids.to(llm.device), cache, lens)
    return encoded, cache, lens, last, max_total


def _eager_tokens(llm, prompt: str, *, max_new: int, speculate: bool, seed: int = 0, **sampling):
    """The eager reference of ``TorchChatLLM._generate_tokens`` (no
    automaton), as a token iterator: the same prefill, then the module's
    eager chunk functions (``_decode_chunk_device`` or
    ``speculate_chunk_device``), one fetch a chunk, on the current stream,
    with no CUDA graph."""
    import torch

    from raglite_tpu_torch.models.decoder import DECODE_CHUNK, SPEC_DRAFT_LEN, _decode_chunk_device
    from raglite_tpu_torch.models.speculative import _NO_TOKEN, speculate_chunk_device

    sampling = {"temperature": 0.0, "top_p": 1.0, "top_k": 0, "min_p": 0.0, **sampling}
    (ids,), cache, lens, last, max_total = _prefilled(llm, [prompt], max_new)
    mask = torch.from_numpy(llm._base_mask()).to(llm.device)
    stops = llm._stop_ids_device()
    gen = torch.Generator(device=llm.device).manual_seed(seed)
    done = torch.zeros((1,), dtype=torch.bool, device=llm.device)
    emitted = 0
    if speculate:
        hist = torch.full((1, max_total), llm.tokenizer.PAD, dtype=torch.int64, device=llm.device)
        hist[0, : len(ids)] = torch.tensor(ids)
        hl = torch.tensor([len(ids)], device=llm.device)
        reject = torch.full((1,), -1, dtype=torch.int64, device=llm.device)
        while emitted < max_new:
            out, cache, lens, last, reject, done, hist, hl, _ = speculate_chunk_device(
                llm.model, cache, llm.params, lens, last, reject, mask, done, stops, gen, hist, hl,
                num_tokens=DECODE_CHUNK, draft_len=SPEC_DRAFT_LEN, pad_id=int(llm.tokenizer.PAD), **sampling,
            )
            chunk = [t for t in out[0].tolist() if t != _NO_TOKEN][: max_new - emitted]
            yield from chunk
            emitted += len(chunk)
            if bool(done[0]) or not chunk:
                return
        return
    while emitted < max_new:
        out, cache, lens, last, done = _decode_chunk_device(
            llm.model, cache, llm.params, lens, last, mask, done, stops, gen, num_steps=DECODE_CHUNK, **sampling,
        )
        for t in out[0].tolist():
            if t == _NO_TOKEN or emitted >= max_new:
                return
            yield t
            emitted += 1


@contextlib.contextmanager
def _sync_errors():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: any
    synchronizing call (a host read) raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _first_call_checked(step) -> None:
    """A StepGraph's first call (the eager warm-up, then the capture) with
    every synchronizing call an error."""
    assert step.graph is None and step.capture
    with _sync_errors():
        step()
    assert step.graph is not None


def _launches_since(before: dict[str, int]) -> dict[str, int]:
    """The attention kernels' launches since ``before`` (an
    ``_attention_launches()``), the counts themselves left running."""
    return {name: n - before[name] for name, n in _attention_launches().items()}


def _counters_zero() -> bool:
    """Every ticket counter the decode/verify kernel keeps, on every
    stream, is zero (as the kernel leaves them after each launch)."""
    import torch

    from raglite_tpu_torch.ops import decode_attention as da

    torch.cuda.synchronize()
    return all(int(torch.count_nonzero(counters)) == 0 for pairs in da._scratch.values() for _, counters in pairs)


def _held_to_eager(name: str, pairs, tokens_graph: list[int], tokens_eager: list[int], card: str) -> dict:
    """Step by step: the graph's logits against the eager function's (pairs
    of [.., V] tensors), bit-equal steps and the largest difference (held to
    PHASE14_LOGIT_RTOL of the largest |logit|), and the tokens (equal)."""
    import torch

    bit_equal = sum(torch.equal(a, b) for a, b in pairs)
    diff = float(torch.stack([(a - b).abs().max() for a, b in pairs]).max())
    scale = float(torch.stack([b.abs().max() for _, b in pairs]).max())
    log(f"phase 14 {name}: {len(pairs)} steps, logits bit-equal in {bit_equal}, largest |difference| {diff:.6g} "
        f"({diff / scale:.3g} of the largest |logit| {scale:.4g}; bound {PHASE14_LOGIT_RTOL}), tokens equal "
        f"{tokens_graph == tokens_eager} ({len(tokens_graph)}), on {card}")
    assert tokens_graph == tokens_eager, (name, tokens_graph, tokens_eager)
    assert diff <= PHASE14_LOGIT_RTOL * scale, (name, diff, scale)
    mark(f"phase 14 {name}")
    return {"steps": len(pairs), "bit_equal": bit_equal, "max_abs_diff": diff, "max_abs_logit": scale}


def phase14_steps(llm, prompt: str, batch_prompts: list[str], card: str) -> dict:
    """Phase 14 (a)-(d): each step form at the prompts' shapes, its first
    call (warm-up and capture) with every synchronizing call an error, then
    held to the module's eager function step by step on a copy of the cache:
    (a) the decode step (B = 1, PHASE14_TOKENS steps), (b) the verify
    iteration (one a chunk of K + 1 tokens), (c) the one-token forward, (d)
    the batch step (B = 8, T = 4,096).  Capture ms, device ops of one
    replay, launches counted through replays, the idle share of a decode
    chunk from the graph and eager, and the ticket counters after."""
    import torch

    from raglite_tpu_torch.models import decoder as dec
    from raglite_tpu_torch.models import speculative as spec
    from raglite_tpu_torch.utils import graphs

    layers, device, model, params = llm.cfg["layers"], llm.device, llm.model, llm.params
    greedy = {"temperature": 0.0, "top_p": 1.0, "top_k": 0, "min_p": 0.0}
    mask = torch.from_numpy(llm._base_mask()).to(device)
    stops = llm._stop_ids_device()
    out: dict = {}

    def copied(cache):
        return {k: [t.clone() for t in v] for k, v in cache.items()}

    # (a) The decode step against _decode_chunk_device(num_steps=1).
    with graphs.generation_stream(llm._graph_device()) as stream, graphs.on_stream(stream):
        _, cache, lens, last, _ = _prefilled(llm, [prompt], PHASE14_TOKENS)
        cache_e = copied(cache)
        done = torch.zeros((1,), dtype=torch.bool, device=device)
        gen_g, gen_e = (torch.Generator(device=device).manual_seed(0) for _ in range(2))
        loop = dec._DecodeLoop(model, cache, params, lens, last, mask, done, stops, gen_g, num_steps=dec.DECODE_CHUNK, **greedy)
        carry = (lens, last, done)
        pairs, tok_g, tok_e = [], [], []
        before = _attention_launches()
        for i in range(PHASE14_TOKENS):
            if i == 0:
                _first_call_checked(loop.graph)
            else:
                loop.graph()
            e_out, cache_e, *carry = dec._decode_chunk_device(
                model, cache_e, params, *carry[:2], mask, carry[2], stops, gen_e, num_steps=1, **greedy,
            )
            pairs.append((loop.last.clone(), carry[1]))
            tok_g.append(loop.out[0, i % dec.DECODE_CHUNK].clone())
            tok_e.append(e_out[0, 0])
        launches = _launches_since(before)
        decode = _held_to_eager("decode step (B = 1, greedy)", pairs, torch.stack(tok_g).tolist(), torch.stack(tok_e).tolist(), card)
        # The warm-up's launches, one replay's a step after it, and the eager
        # reference's: as many from the graph as from eager calls.
        assert launches["gqa_decode_attention"] == 2 * layers * PHASE14_TOKENS, launches
        decode.update(capture_ms=loop.graph.capture_ms, recorded={name: n for _, name, n in loop.graph.recorded})
        decode["device_ops_replay"], _ = _profile_window(loop.graph, "one decode step replayed from its graph", card)

        def eager_chunk():
            dec._decode_chunk_device(
                model, cache_e, params, carry[0].clone(), carry[1], mask, carry[2], stops, gen_e,
                num_steps=PHASE14_EAGER_STEPS, **greedy,
            )

        _, decode["idle_share_graph"] = _profile_window(loop.chunk, f"one decode chunk ({dec.DECODE_CHUNK} steps) from the graph", card)
        decode["device_ops_eager"], decode["idle_share_eager"] = _profile_window(
            eager_chunk, f"an eager decode chunk of {PHASE14_EAGER_STEPS} steps", card,
        )
        decode["device_ops_eager"] //= PHASE14_EAGER_STEPS
        out["decode"] = decode
        del loop, cache, cache_e
    assert _counters_zero()

    # (b) The verify iteration: SpeculativeLoop and speculate_chunk_device
    # with num_tokens = K + 1, one iteration a call.
    k = dec.SPEC_DRAFT_LEN
    with graphs.generation_stream(llm._graph_device()) as stream, graphs.on_stream(stream):
        (ids,), cache, lens, last, max_total = _prefilled(llm, [prompt], PHASE14_TOKENS)
        cache_e = copied(cache)
        hist = torch.full((1, max_total), llm.tokenizer.PAD, dtype=torch.int64, device=device)
        hist[0, : len(ids)] = torch.tensor(ids)
        state = (lens, last, torch.full((1,), -1, dtype=torch.int64, device=device),
                 torch.zeros((1,), dtype=torch.bool, device=device), hist, torch.tensor([len(ids)], device=device))
        gen = torch.Generator(device=device).manual_seed(0)
        kw = dict(num_tokens=k + 1, draft_len=k, pad_id=int(llm.tokenizer.PAD), **greedy)
        loop = spec.SpeculativeLoop(model, cache, params, *state[:3], mask, state[3], stops, gen, *state[4:], **kw)
        pairs, tok_g, tok_e = [], [], []
        before = _attention_launches()
        while len(tok_g) < PHASE14_TOKENS and not bool(loop.done[0]):
            if loop.graph.graph is None:  # the chunk's first iteration, by hand
                loop.out.fill_(spec._NO_TOKEN)
                loop.out_len.zero_()
                loop._set_active()
                _first_call_checked(loop.graph)
                got = loop.out[:, : k + 1]
            else:
                got, iters = loop.chunk()
                assert iters == 1, iters
            e_out, cache_e, *carry, _ = spec.speculate_chunk_device(
                model, cache_e, params, state[0], state[1], state[2], mask, state[3], stops, gen, state[4], state[5], **kw,
            )
            state = tuple(carry)
            pairs.append((loop.logits.clone(), state[1]))
            tok_g += [t for t in got[0].tolist() if t != spec._NO_TOKEN]
            tok_e += [t for t in e_out[0].tolist() if t != spec._NO_TOKEN]
        launches = _launches_since(before)
        verify = _held_to_eager(f"verify iteration (B = 1, T = {k + 1}, greedy)", pairs, tok_g, tok_e, card)
        assert launches["gqa_verify_attention"] == 2 * layers * len(pairs), launches
        verify.update(capture_ms=loop.graph.capture_ms, recorded={name: n for _, name, n in loop.graph.recorded},
                      tokens_per_iteration=len(tok_g) / len(pairs))
        verify["device_ops_replay"], _ = _profile_window(loop.graph, f"one verify iteration (T = {k + 1}) from its graph", card)
        # The sampled forms (the generator registered with the graph) are
        # captured with every synchronizing call an error too, then replayed
        # for a chunk, on the reference's cache.
        sampled = {**greedy, **llm.RECOMMENDED_SAMPLING}
        verify["sampled_capture_ms"] = []
        for sampled_loop in (
            dec._DecodeLoop(model, cache_e, params, state[0], state[1], mask, state[3], stops, gen,
                            num_steps=dec.DECODE_CHUNK, **sampled),
            spec.SpeculativeLoop(model, cache_e, params, *state[:3], mask, state[3], stops, gen, *state[4:],
                                 **{**kw, "num_tokens": dec.DECODE_CHUNK, **sampled}),
        ):
            if isinstance(sampled_loop, spec.SpeculativeLoop):
                sampled_loop._set_active()
            _first_call_checked(sampled_loop.graph)
            sampled_loop.chunk()
            verify["sampled_capture_ms"].append(sampled_loop.graph.capture_ms)
        out["verify"] = verify
        del loop, sampled_loop, cache, cache_e
    assert _counters_zero()

    # (c) The one-token forward against _forward_one; (d) the batch step
    # against _forward_step_batch, on seeded tokens.
    rng = torch.Generator().manual_seed(14)
    with graphs.generation_stream(llm._graph_device()) as stream, graphs.on_stream(stream):
        (ids,), cache, _, _, _ = _prefilled(llm, [prompt], PHASE14_TOKENS)
        cache_e = copied(cache)
        one = dec._ForwardOne(model, params, cache, len(ids), device)
        tokens = torch.randint(3, 259, (32,), generator=rng).tolist()
        pairs = []
        for i, token in enumerate(tokens):
            if i == 0:
                one.tok.fill_(token)
                _first_call_checked(one.graph)
                got = one.logits
            else:
                got = one(token)
            pairs.append((got.clone(), dec._forward_one(model, params, token, cache_e, len(ids) + i)))
        forward_one = _held_to_eager("one-token forward (B = 1)", pairs, [], [], card)
        forward_one["capture_ms"] = one.graph.capture_ms
        forward_one["ms_graph"] = median_ms(lambda: one(tokens[0]).cpu(), reps=5, inner=4, warmup=1)
        forward_one["ms_eager"] = median_ms(
            lambda: dec._forward_one(model, params, tokens[0], cache_e, len(ids)).cpu(), reps=5, inner=4, warmup=1,
        )
        out["forward_one"] = forward_one
        del one, cache, cache_e

        encoded, cache, lens, _, _ = _prefilled(llm, batch_prompts, 64)
        cache_e = copied(cache)
        batch = dec._ForwardBatch(model, params, cache, lens)
        pairs, e_lens = [], lens
        for i in range(16):
            step_tokens = torch.randint(3, 259, (lens.shape[0],), generator=rng)
            if i == 0:
                batch.tokens.copy_(step_tokens.to(device))
                _first_call_checked(batch.graph)
                got = batch.logits
            else:
                got = batch(step_tokens)
            pairs.append((got.clone(), dec._forward_step_batch(model, params, step_tokens.to(device), cache_e, e_lens)))
            e_lens = e_lens + 1
        forward_batch = _held_to_eager(f"batch step (B = {lens.shape[0]}, T = 1)", pairs, [], [], card)
        forward_batch["capture_ms"] = batch.graph.capture_ms
        forward_batch["ms_graph"] = median_ms(lambda: batch(step_tokens).cpu(), reps=5, inner=4, warmup=1)
        forward_batch["ms_eager"] = median_ms(
            lambda: dec._forward_step_batch(model, params, step_tokens.to(device), cache_e, e_lens).cpu(), reps=5, inner=4, warmup=1,
        )
        out["forward_batch"] = forward_batch
        del batch, cache, cache_e
    assert _counters_zero()
    for name in ("decode", "verify", "forward_one", "forward_batch"):
        x = out[name]
        log(f"phase 14 {name}: capture {x['capture_ms']:.1f} ms"
            + (f", {x['device_ops_replay']} device ops a replay" if "device_ops_replay" in x else "")
            + (f", one call {x['ms_graph']:.3f} ms from the graph against {x['ms_eager']:.3f} ms eager (logits fetched)" if "ms_graph" in x else "")
            + f", on {card}")
    return out


def _measured(tokens) -> dict:
    """Drain a token iterator (``_timed_tokens``) with the card's memory
    measured: peak allocated above the start, and what stays allocated
    once the generation is over."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, first_ms, ms = _timed_tokens(tokens)
    peak = torch.cuda.max_memory_allocated() - base
    gc.collect()
    return {"tokens": out, "first_ms": first_ms, "ms": ms, "peak_bytes": peak, "held_bytes": torch.cuda.memory_allocated() - base}


def phase14_paths(llm, prompt: str, convs: list, decode_bit_equal: bool, card: str) -> dict:
    """Phase 14 (e)-(h), through TorchChatLLM's entry points: (e) plain
    greedy, greedy speculative and sampled streams of PHASE14_TOKENS from
    the graphs against the eager reference (``_eager_tokens``) on the same
    prompt, each with its tokens/s, time to first token, peak and held
    memory and launches, the sampled one twice with one seed; (f) a
    schema-constrained answer (ms a token); (g) complete_batch of 8 at
    T = 4,096, greedy and under the metadata schema; (h) two threads
    answering at once, against the same calls one after the other."""
    import os
    import threading

    import torch

    from raglite_tpu_torch.models.decoder import DECODE_CHUNK
    from raglite_tpu_torch.models.schema_automaton import SchemaAutomaton
    from raglite_tpu_torch.utils import graphs

    layers = llm.cfg["layers"]
    out: dict = {}
    prefill_ms = median_ms(lambda: _prefilled(llm, [prompt], PHASE14_TOKENS), reps=3, inner=1, warmup=1)
    sampled = dict(llm.RECOMMENDED_SAMPLING)
    for kind, speculate, sampling in (("plain", False, {}), ("speculative", True, {}), ("sampled", False, sampled)):
        os.environ["RAGLITE_TPU_SPECULATE"] = "always" if speculate else "0"
        try:
            before = _attention_launches()
            llm.spec_stats = None
            graph = _measured(llm._generate_tokens(prompt, max_new_tokens=PHASE14_TOKENS, seed=7, **sampling))
            launches = _launches_since(before)
            stats = llm.spec_stats
            eager = _measured(_eager_tokens(llm, prompt, max_new=PHASE14_TOKENS, speculate=speculate, seed=7, **sampling))
            again = list(llm._generate_tokens(prompt, max_new_tokens=PHASE14_TOKENS, seed=7, **sampling)) if sampling else None
        finally:
            del os.environ["RAGLITE_TPU_SPECULATE"]
        assert launches["gqa_prefill_attention"] == layers, launches
        if speculate:
            assert launches["gqa_verify_attention"] == layers * stats["verify_iters"] and launches["gqa_decode_attention"] == 0, (launches, stats)
        else:
            forwards = launches["gqa_decode_attention"] // layers
            assert launches["gqa_decode_attention"] % (layers * DECODE_CHUNK) == 0 and forwards > 0, launches
        same = graph["tokens"] == eager["tokens"]
        row = {"tokens": len(graph["tokens"]), "equal_to_eager": same, "launches": launches}
        for path, m in (("graph", graph), ("eager", eager)):
            row[path] = {
                "tokens_per_s": len(m["tokens"]) / max((m["ms"] - prefill_ms) / 1e3, 1e-9), "ms": m["ms"],
                "first_token_ms": m["first_ms"], "peak_gb": m["peak_bytes"] / 1e9, "held_gb": m["held_bytes"] / 1e9,
            }
        log(f"phase 14 (e) {kind}: {len(graph['tokens'])} tokens, graph {row['graph']['tokens_per_s']:.2f} tokens/s "
            f"(first token {graph['first_ms']:.1f} ms, {graph['ms']:.1f} ms in all, peak {row['graph']['peak_gb']:.3f} GB, "
            f"held after {row['graph']['held_gb']:.4f} GB) against eager {row['eager']['tokens_per_s']:.2f} tokens/s "
            f"(first token {eager['first_ms']:.1f} ms, {eager['ms']:.1f} ms, peak {row['eager']['peak_gb']:.3f} GB); "
            f"prefill {prefill_ms:.1f} ms; tokens equal to eager: {same}; launches {launches}"
            + (f"; {stats['tokens'] / stats['verify_iters']:.3f} tokens a verify forward" if speculate else "") + f", on {card}")
        if sampling:
            assert again == graph["tokens"], "a seeded sampled stream from the graphs did not repeat itself"
            row["repeats"] = True
            if not same:
                # The graphs' and the eager draws come from one Philox stream
                # at the same offsets; only different logits could part them.
                first = next(i for i, (a, b) in enumerate(zip(graph["tokens"], eager["tokens"])) if a != b)
                log(f"phase 14 (e) sampled: the graph's stream leaves the eager one at token {first}; the decode "
                    f"step's logits were {'bit-equal' if decode_bit_equal else 'not bit-equal'} to the eager step's")
                assert not decode_bit_equal, "bit-equal logits and one Philox stream, yet other sampled tokens"
        else:
            assert same, (kind, graph["tokens"], eager["tokens"])
        out[kind] = row

    # (f) A schema-constrained answer: the host loop, one replayed
    # one-token forward and one logits fetch a token.
    cprompt = llm._format_messages([{"role": "user", "content": f"Describe this sentence as JSON: {PHASE14_QUESTION}"}], None)
    cprompt += "Respond with a JSON object.\n"
    before = _attention_launches()
    constrained = _measured(llm._generate_tokens(
        cprompt, max_new_tokens=96, json_constrained=True, automaton=SchemaAutomaton(PHASE8_SCHEMA),
    ))
    launches = _launches_since(before)
    n = len(constrained["tokens"])
    assert _within_budget(PHASE8_SCHEMA, constrained["tokens"], 96), constrained["tokens"]
    assert launches["gqa_decode_attention"] > 0 and launches["gqa_decode_attention"] % layers == 0, launches
    ms_token = (constrained["ms"] - constrained["first_ms"]) / max(n - 1, 1)
    out["constrained"] = {"tokens": n, "ms": constrained["ms"], "ms_a_token": ms_token, "launches": launches}
    log(f"phase 14 (f) schema-constrained answer from the one-token graph: {n} tokens in {constrained['ms']:.1f} ms, "
        f"{ms_token:.2f} ms a token after the first, launches {launches}, on {card}")

    # (g) complete_batch of 8 at T = 4,096: the batched verify graph
    # (greedy) and the batch step's graph (under the metadata schema).
    out["batch"] = {}
    for kind, rf in (("greedy", None), ("schema", METADATA_FORMAT)):
        before = _attention_launches()
        t0 = time.perf_counter()
        responses = llm.complete_batch(convs, response_format=rf, max_tokens=64)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launches_since(before)
        contents = [r.content or "" for r in responses]
        if rf is not None:
            for content in contents:
                assert set(json.loads(content)) == {"topic", "audience"} and _conforms(METADATA_SCHEMA, content), content
            assert launches["gqa_decode_attention"] > 0 and launches["gqa_verify_attention"] == 0, launches
        else:
            assert launches["gqa_verify_attention"] > 0 and launches["gqa_verify_attention"] % layers == 0, launches
        out["batch"][kind] = {"ms": ms, "bytes": sum(len(c.encode()) for c in contents), "launches": launches}
        log(f"phase 14 (g) complete_batch B=8 {kind} from the graphs: {ms:.1f} ms, {out['batch'][kind]['bytes']} "
            f"bytes of content, launches {launches}, on {card}")

    # (h) Two threads answering at once (each generation its own stream,
    # cache and graphs) against the same calls one after the other.
    short = llm._format_messages([{"role": "user", "content": PHASE14_QUESTION}], None)
    calls = [
        lambda: list(llm._generate_tokens(prompt, max_new_tokens=PHASE14_TOKENS)),
        lambda: list(llm._generate_tokens(short, max_new_tokens=PHASE14_TOKENS, seed=3, **sampled)),
    ]
    t0 = time.perf_counter()
    want = [call() for call in calls]
    sequential_ms = (time.perf_counter() - t0) * 1e3
    got: list = [None, None]
    errors: list = []

    def answer(i: int) -> None:
        try:
            got[i] = calls[i]()
        except BaseException as exc:  # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=answer, args=(i,)) for i in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    concurrent_ms = (time.perf_counter() - t0) * 1e3
    if errors:
        raise errors[0]
    assert got == want, "two concurrent answers differ from the same answers one after the other"
    streams = len(graphs._streams[llm.device.index or 0])
    out["threads"] = {"sequential_ms": sequential_ms, "concurrent_ms": concurrent_ms, "streams": streams}
    log(f"phase 14 (h) two answers at once (greedy speculative over the RAG prompt, sampled over a short one) equal "
        f"to the same answers one after the other: {concurrent_ms:.1f} ms at once, {sequential_ms:.1f} ms in turn; "
        f"the stream pool holds {streams} streams, on {card}")
    return out


def phase14(llm, prompt: str, card: str, total: dict[str, int]) -> dict:
    """Phase 14: the decode programs as CUDA graphs on `large` (phase 6's
    object) over phase 6's RAG prompt: the step forms held to the eager
    functions (:func:`phase14_steps`), then the entry points
    (:func:`phase14_paths`); every kernel launch counted into ``total``."""
    convs = _batch_convs()
    steps = _counted(total, lambda: phase14_steps(llm, prompt, [llm._format_messages(c, None) for c in convs], card))
    mark("phase 14 (a)-(d)")
    before = dict(total)
    paths = _counted(total, lambda: phase14_paths(
        llm, prompt, convs, steps["decode"]["bit_equal"] == steps["decode"]["steps"], card,
    ))
    assert _counters_zero()
    log(f"phase 14 launches: {total} (the entry points alone: "
        f"{ {k: total[k] - before.get(k, 0) for k in total} }), on {card}")
    return {"steps": steps, "paths": paths}


# --- Phase 15: the retrieval programs as CUDA graphs -------------------------

#: Largest relative deviation allowed between a replay and its eager program
#: (0: bit for bit).
PHASE15_RTOL = 0.0
#: Phase 15 (c)'s document, inserted into the phase-3 store and deleted again.
PHASE15_DOC_ID = "phase15-lighthouse"
PHASE15_DOC = (
    "The keepers of the Zanzibar lighthouse log the tide at dawn. The brass ledger of the Zanzibar "
    "lighthouse records every ship that passed the coral reef since the great storm."
)
PHASE15_QUERY = "What does the brass ledger of the Zanzibar lighthouse record?"
#: Threads of phase 15 (d), each a vector_search and a rerank_chunks.
PHASE15_THREADS = 8


def _deviation(got, want) -> float:
    """Largest |got - want| over the largest |want| (finite entries; the
    infinite ones must be equal); 0 for equal tensors of any dtype."""
    import torch

    if torch.equal(got, want):
        return 0.0
    assert got.shape == want.shape and got.dtype == want.dtype and got.dtype.is_floating_point, (got, want)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite) and torch.equal(got[~finite], want[~finite])
    scale = float(want[finite].abs().max().clamp(min=1e-30))
    return float((got[finite] - want[finite]).abs().max()) / scale


class _ProgramCheck:
    """Phase 15 (a) and (b): while ``on``, each ProgramGraphs call that
    leaves its key held is followed by one more call (a replay) and the
    eager program on the same inputs (``eager_programs``): integer outputs
    equal, float outputs within PHASE15_RTOL of the eager ones, and the
    replay's scan launches equal to the eager program's.  The launches of
    those two calls are taken back out of the counts.  ``held`` keeps per
    (owner, key) the checks, the largest deviation and the last call, for
    profiling; ``launches`` the replays' and the eager programs' scan
    launches in all."""

    def __init__(self, names: dict[int, str]) -> None:
        self.names = names
        self.on = False
        self.held: dict[tuple, dict] = {}
        self.launches = {"replay": {}, "eager": {}}

    def __enter__(self):
        from raglite_tpu_torch.utils import graphs

        self.original = original = graphs.ProgramGraphs.__call__
        check = self

        def call(programs, key, program, *inputs):
            out = original(programs, key, program, *inputs)
            if check.on and key in programs:
                check.verify(programs, key, program, inputs, out)
            return out

        graphs.ProgramGraphs.__call__ = call
        return self

    def __exit__(self, *exc) -> None:
        from raglite_tpu_torch.utils import graphs

        graphs.ProgramGraphs.__call__ = self.original

    def verify(self, programs, key, program, inputs, out) -> None:
        from raglite_tpu_torch.ops import fused_scan as fs
        from raglite_tpu_torch.utils import graphs

        snap = dict(fs.launch_counts)
        replay = self.original(programs, key, program, *inputs)
        mid = dict(fs.launch_counts)
        with graphs.eager_programs():
            eager = programs.eager(program, *inputs)
        end = dict(fs.launch_counts)
        fs.launch_counts.update(snap)
        by_replay = {k: mid[k] - snap[k] for k in snap}
        by_eager = {k: end[k] - mid[k] for k in snap}
        assert by_replay == by_eager, (key, by_replay, by_eager)
        for what, n in (("replay", by_replay), ("eager", by_eager)):
            for k, v in n.items():
                self.launches[what][k] = self.launches[what].get(k, 0) + v
        dev = 0.0
        for got in (out, replay):
            for a, b in zip(graphs._as_tuple(got), graphs._as_tuple(eager), strict=True):
                dev = max(dev, _deviation(a, b))
        assert dev <= PHASE15_RTOL, (self.names.get(id(programs)), key, dev)
        entry = self.held.setdefault((self.names.get(id(programs), "?"), key), {"checks": 0, "deviation": 0.0})
        entry["checks"] += 1
        entry["deviation"] = max(entry["deviation"], dev)
        entry["call"] = (programs, key, program, inputs)


def _paired_p50(fn, items, reps: int = 1) -> tuple[float, float]:
    """p50 host-clock ms of ``fn(item)`` from the graphs and eagerly
    (``eager_programs``), in turns, each call ended by a synchronize."""
    import torch

    from raglite_tpu_torch.utils import graphs

    graph, eager = [], []
    for _ in range(reps):
        for item in items:
            for times, ctx in ((graph, contextlib.nullcontext()), (eager, graphs.eager_programs())):
                with ctx:
                    t0 = time.perf_counter()
                    fn(item)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(graph), statistics.median(eager)


def _replay_ops(check: _ProgramCheck, names: list[str], card: str) -> dict[str, dict]:
    """Device ops and idle share of one call from its graph and of the
    eager program, for the last held key of each kind of each owner."""
    from raglite_tpu_torch.utils import graphs

    last: dict[tuple, tuple] = {}
    for (owner, key), entry in check.held.items():
        if owner in names and "call" in entry:
            last[(owner, key[0])] = entry["call"]
    out = {}
    for (owner, _), (programs, key, program, inputs) in sorted(last.items(), key=str):
        programs(key, program, *inputs)  # held (again, if a later generation dropped it)
        ops, idle = _profile_window(lambda: programs(key, program, *inputs), f"one replay, {owner} {key}", card, top=3)
        with graphs.eager_programs():
            e_ops, e_idle = _profile_window(lambda: programs(key, program, *inputs), f"eager, {owner} {key}", card, top=3)
        out[f"{owner} {key[:-1] if owner == 'index' else key}"] = {
            "ops": ops, "idle": idle, "eager_ops": e_ops, "eager_idle": e_idle,
        }
    return out


def _pool_report(programs) -> dict:
    stats = programs.stats()
    return {
        "keys": len(stats), "pool_bytes": sum(v["pool_bytes"] for v in stats.values()),
        "capture_ms": {str(k): round(v["capture_ms"], 3) for k, v in stats.items()}, "counts": dict(programs.counts),
    }


def _graph_mix(programs: dict) -> dict:
    """Each named ProgramGraphs object's counts and capture ms now (the
    baseline of :func:`_graph_mix_since`)."""
    return {name: {**p.counts, "capture_ms": p.capture_ms} for name, p in programs.items()}


def _graph_mix_since(programs: dict, before: dict) -> dict:
    """Per named ProgramGraphs object, since ``before``: its calls by
    outcome, the keys it holds, the share of calls that replayed, and the
    capture ms in all and per call."""
    out = {}
    for name, p in programs.items():
        delta = {k: p.counts[k] - before[name][k] for k in p.counts}
        calls = delta["captured"] + delta["replayed"] + delta["kept_eager"]
        capture_ms = p.capture_ms - before[name]["capture_ms"]
        out[name] = {
            **delta, "calls": calls, "keys_held": len(p), "replayed_share": delta["replayed"] / max(calls, 1),
            "capture_ms": capture_ms, "capture_ms_per_call": capture_ms / max(calls, 1),
        }
    return out


def _long_text(encoder, texts: list[str], lo: int, hi: int) -> str:
    """A prefix of the documents' text of more than ``lo`` and at most
    ``hi`` tokens of ``encoder`` (a few tokenizations, each prefix scaled
    by the characters a token the last one took)."""
    text = "\n\n".join(texts)
    size = 8 * hi
    for _ in range(8):
        n = encoder.count_tokens([text[:size]])[0]
        if lo < n <= hi:
            return text[:size]
        size = int(size * (lo + hi) / 2 / max(n, 1))
    msg = f"no prefix of {lo}-{hi} tokens found"
    raise AssertionError(msg)


def phase15_rerank(ecfg, queries: list[str], chunk_lists: list, card: str, label: str) -> dict:
    """``rerank_chunks`` of each query's top 20 from the graphs and eagerly:
    cold (the encoder's rerank cache emptied first) and warm, in turns."""
    from raglite_tpu_torch.models.encoder import encoder_from_config
    from raglite_tpu_torch.search import rerank_chunks

    from raglite_tpu_torch.utils.lang import detect_language

    encoder = encoder_from_config(ecfg)
    pairs = list(zip(queries, chunk_lists))

    def cold(pair):
        encoder._rerank_cache.clear()
        rerank_chunks(pair[0], pair[1], config=ecfg)

    for pair in pairs:  # every tile's key captured: "cold" is the rerank cache's state
        cold(pair)
    cold_g, cold_e = _paired_p50(cold, pairs)
    for pair in pairs:
        rerank_chunks(pair[0], pair[1], config=ecfg)
    warm_g, warm_e = _paired_p50(lambda pair: rerank_chunks(pair[0], pair[1], config=ecfg), pairs)
    # The host's share: the per-language reranker's language detection and
    # the candidates' tokenization, made on every call.
    lang_ms = _p50_ms(lambda pair: [detect_language(str(c)) for c in pair[1]] + [detect_language(pair[0])], pairs)
    tok_ms = _p50_ms(lambda pair: [encoder._encode_ids(str(c)) for c in pair[1]], pairs)
    log(f"phase 15 (e) rerank_chunks of a top 20 at {label}, p50 over {len(pairs)} queries on {card}: cold "
        f"{cold_g:.3f} ms from the graphs, {cold_e:.3f} eager; warm {warm_g:.3f} ms from the graphs, {warm_e:.3f} eager; "
        f"of it on the host: language detection {lang_ms:.3f} ms, the candidates' tokenization {tok_ms:.3f} ms")
    return {"cold_ms": cold_g, "cold_eager_ms": cold_e, "warm_ms": warm_g, "warm_eager_ms": warm_e,
            "detect_language_ms": lang_ms, "tokenize_ms": tok_ms}


def phase15(cfg, texts: list[str], queries: list[str], seed: int, card: str, total: dict[str, int]) -> dict:
    """Phase 15: the retrieval path's one-dispatch programs from CUDA graphs
    (utils/graphs.py:ProgramGraphs) over the phase-3 store, held to their
    eager programs (module docstring, phase 15)."""
    import shutil
    import threading

    import numpy as np
    import torch

    from raglite_tpu_torch import Document, RAGLiteConfig, delete_documents, insert_documents
    from raglite_tpu_torch.documents import Chunk
    from raglite_tpu_torch.embed import embed_strings
    from raglite_tpu_torch.index.dense import GRAPH_SCAN_BYTES, DenseIndex, dense_index_from_config
    from raglite_tpu_torch.models.encoder import encoder_from_config
    from raglite_tpu_torch.search import corrected_num_hits, rerank_chunks, retrieve_chunks, vector_search, vector_search_batch
    from raglite_tpu_torch.store import store_from_config
    from raglite_tpu_torch.utils import graphs

    t_start = time.perf_counter()
    store = store_from_config(cfg)
    encoder = encoder_from_config(cfg)
    index = dense_index_from_config(cfg)
    index._refresh_device()
    rows = index.num_rows
    # The single-stage and dense routes over the same device rows (views):
    # the bucket scan at every row, the exact scan over the first 131,072.
    fused = DenseIndex.from_device_arrays(index._rows[0][:rows], index._dev_row_chunk[:rows])
    fused.use_int4_stage1 = False
    small = DenseIndex.from_device_arrays(index._rows[0][:131_072], index._dev_row_chunk[:131_072])
    names = {id(encoder.programs): "sem", id(index.programs): "index", id(fused.programs): "fused", id(small.programs): "small"}
    q32 = (queries * 4)[:32]
    out: dict = {}
    with _ProgramCheck(names) as check:
        check.on = True
        # (a) Every program of the default path at its serving keys.
        def default_path():
            tops = []
            for q in queries:
                ids, _ = vector_search(q, num_results=20, config=cfg)
                tops.append(retrieve_chunks(ids, config=cfg))
                assert index.last_route == "int4_two_stage", index.last_route
            for q, chunks in zip(queries, tops):
                rerank_chunks(q, chunks, config=cfg)
            batch = vector_search_batch(q32, num_results=10, config=cfg)
            assert len(batch) == 32 and index.last_route == "int4_two_stage"
            return tops

        tops = _counted(total, default_path)
        emb = np.stack([embed_strings([q], config=cfg)[0] for q in queries]).astype(np.float32)
        hits = min(corrected_num_hits(4, 10, cfg), rows)

        def other_routes():
            for b in (1, 8):
                fused.search_chunks_device(emb[:b], num_hits=hits, num_results=10)
                assert fused.last_route == "fused_scan", fused.last_route
                small.search_chunks_device(emb[:b], num_hits=hits, num_results=10)
                assert small.last_route == "dense", small.last_route
            # The size rule: the exact route over every row stays eager.
            kept = index.programs.counts["kept_eager"]
            index.search_chunks_device(emb[:1], num_hits=hits, num_results=10, exact=True)
            assert index.last_route == "dense" and index.programs.counts["kept_eager"] == kept + 1
            assert not any(k[0] == "dense" for k in index.programs._entries)
            assert rows * 4 * (index.dim + 1) > GRAPH_SCAN_BYTES

        _counted(total, other_routes)
        # (c) Invalidation: an insert, a delete, an adapter.
        gen, captured = index.generation, index.programs.counts["captured"]
        insert_documents([Document.from_text(PHASE15_DOC, id=PHASE15_DOC_ID)], config=cfg)
        new = {cid for cid in store.chunk_order[-16:] if store.get_chunk(cid).document_id == PHASE15_DOC_ID}
        ids, _ = _counted(total, lambda: vector_search(PHASE15_QUERY, num_results=10, config=cfg))
        assert new and new & set(ids), (new, ids)
        assert index.generation > gen and index.programs.counts["captured"] > captured
        gen = index.generation
        delete_documents([PHASE15_DOC_ID], config=cfg)
        ids2, _ = _counted(total, lambda: vector_search(PHASE15_QUERY, num_results=10, config=cfg))
        assert not new & set(ids2) and index.generation > gen, (ids2, index.generation)
        gen = index.generation
        rng = np.random.default_rng(seed + 15)
        a = (np.eye(index.dim) + 0.02 * rng.normal(size=(index.dim, index.dim))).astype(np.float32)
        store.index_metadata["query_adapter"] = a
        adapted = [_counted(total, lambda q=q: vector_search(q, num_results=10, config=cfg))[0] for q in queries[:4]]
        assert index.generation == gen + 1, (index.generation, gen)
        del store.index_metadata["query_adapter"]
        plain = [vector_search(q, num_results=10, config=cfg)[0] for q in queries[:4]]
        log(f"phase 15 (c) on {card}: the inserted chunk found ({sorted(new & set(ids))}), gone after the delete; "
            f"generation {gen + 1} after the adapter (ids differ from the plain search on "
            f"{sum(x != y for x, y in zip(adapted, plain))} of 4 queries); every call equal to its eager program")
        check.on = False
        # (d) Threads: vector_search and rerank_chunks at once, against the
        # same calls in turn (the turns run second, on the states the
        # threads cached).
        calls = (queries * 2)[:PHASE15_THREADS]
        encoder._rerank_cache.clear()
        got: dict[int, tuple] = {}

        def one(i: int) -> tuple:
            ids, scores = vector_search(calls[i], num_results=20, config=cfg)
            reranked = rerank_chunks(calls[i], retrieve_chunks(ids, config=cfg), config=cfg)
            return ids, scores, [c.id for c in reranked]

        def run(i: int) -> None:
            got[i] = one(i)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
        t0 = time.perf_counter()
        _counted(total, lambda: ([t.start() for t in threads], [t.join(timeout=300) for t in threads]))
        threads_s = time.perf_counter() - t0
        assert not any(t.is_alive() for t in threads) and len(got) == len(calls)
        want = [one(i) for i in range(len(calls))]
        assert [got[i] for i in range(len(calls))] == want, "threads differ from the same calls in turn"
        log(f"phase 15 (d) {len(calls)} threads of vector_search + rerank_chunks at once in {threads_s:.3f} s: equal "
            f"to the same calls in turn, on {card}")
        # Searches racing an insert: every result equals the same search
        # before or after it (no search reads arrays a sync replaced).
        racers = [PHASE15_QUERY, *queries[:3]] * 2
        race_id = PHASE15_DOC_ID + "-race"
        before = {q: vector_search(q, num_results=10, config=cfg) for q in set(racers)}
        raced: dict[int, list] = {}

        def search_during(i: int) -> None:
            raced[i] = [vector_search(racers[i], num_results=10, config=cfg) for _ in range(4)]

        threads = [threading.Thread(target=search_during, args=(i,)) for i in range(len(racers))]
        threads.append(threading.Thread(target=lambda: insert_documents([Document.from_text(PHASE15_DOC, id=race_id)], config=cfg)))
        gen = index.generation
        _counted(total, lambda: ([t.start() for t in threads], [t.join(timeout=300) for t in threads]))
        assert not any(t.is_alive() for t in threads) and len(raced) == len(racers)
        after = {q: vector_search(q, num_results=10, config=cfg) for q in set(racers)}
        assert index.generation > gen and before[PHASE15_QUERY] != after[PHASE15_QUERY]
        mixed = [r for i, rs in raced.items() for r in rs if r not in (before[racers[i]], after[racers[i]])]
        assert not mixed, mixed
        delete_documents([race_id], config=cfg)
        log(f"phase 15 (d) {len(racers)} threads of vector_search racing an insert: each of "
            f"{sum(map(len, raced.values()))} results equal to the same search before or after it "
            f"({sum(r == after[racers[i]] for i, rs in raced.items() for r in rs)} after), on {card}")
        # (e) Times from the graphs and eager, in turns.
        enc_g, enc_e = _paired_p50(lambda q: embed_strings([q], config=cfg), queries, reps=2)
        vs_g, vs_e = _paired_p50(lambda q: vector_search(q, num_results=10, config=cfg), queries, reps=2)
        vb_g, vb_e = _paired_p50(lambda qs: vector_search_batch(qs, num_results=10, config=cfg), [q32] * 4)
        log(f"phase 15 (e) on {card}: query encode ([8, 128] token states) p50 {enc_g:.3f} ms from the graph, "
            f"{enc_e:.3f} eager; vector_search (B 1, int4 route) p50 {vs_g:.3f} ms, {vs_e:.3f} eager; "
            f"vector_search_batch (B 32) {vb_g:.3f} ms, {vb_e:.3f} eager")
        out.update({"encode_ms": enc_g, "encode_eager_ms": enc_e, "vector_search_ms": vs_g, "vector_search_eager_ms": vs_e,
                    "batch32_ms": vb_g, "batch32_eager_ms": vb_e})
        out["rerank_768"] = phase15_rerank(cfg, queries[:4], tops[:4], card, "d 768 (flax:sem)")
        _, idle = _profile_window(lambda: vector_search(queries[0], num_results=10, config=cfg), "one vector_search from the graphs", card, top=5)
        with graphs.eager_programs():
            _, idle_e = _profile_window(lambda: vector_search(queries[0], num_results=10, config=cfg), "one vector_search, eager", card, top=5)
        out.update({"idle_share": idle, "idle_share_eager": idle_e})
        # The bge-m3-shaped encoder of phase 10 (e): its programs held and
        # timed, one key at T >= 2,048, and the size rule at a rerank tile.
        root = scratch_dir(1_300_000_000, "bge_m3_p15_")
        try:
            (root / "tokenizer.json").write_text(json.dumps(unigram_tokenizer_json(_markdown_texts())))
            write_bge_m3_checkpoint(root, seed + 20)
            ecfg = RAGLiteConfig(store_path=":memory:", device="cuda", embedder=f"flax:{root}")
            big = encoder_from_config(ecfg)
            names[id(big.programs)] = "bge-m3"
            check.on = True

            def bge_calls():
                rerank_chunks(queries[0], tops[0], config=ecfg)
                rerank_chunks(queries[1], tops[1], config=ecfg)
                embed_strings([queries[0]], config=ecfg)
                long = _long_text(big, texts, 1920, 2816)
                states = big.embed_token_level(long)
                t = -(-states.shape[0] // 128) * 128
                assert t >= 2048 and ("tokens", 1, t) in big.programs, states.shape
                kept = big.programs.counts["kept_eager"]
                chunk = Chunk(id="phase15-long", document_id="phase15-long", index=0, headings="", body=long)
                rerank_chunks(queries[0], [*tops[0][:3], chunk], config=ecfg)
                assert big.programs.counts["kept_eager"] == kept + 1 and ("norm", 8, t) not in big.programs
                log(f"phase 15 bge-m3 shape: token states at T {t} ({states.shape[0]} tokens) from a graph; a rerank "
                    f"tile [8, {t}] kept eager by the size rule ({8 * 16 * t * t * 4 / 2**20:.0f} MiB of logits), on {card}")

            _counted(total, bge_calls)
            check.on = False
            out["rerank_1024"] = phase15_rerank(ecfg, queries[:4], tops[:4], card, "d 1,024 (bge-m3 shape)")
            out["ops"] = _replay_ops(check, ["sem", "index", "fused", "small", "bge-m3"], card)
            out["pools"] = {n: _pool_report(p) for n, p in (("sem", encoder.programs), ("index", index.programs),
                                                           ("fused", fused.programs), ("small", small.programs),
                                                           ("bge-m3", big.programs))}
        finally:
            shutil.rmtree(root, ignore_errors=True)
    dev = max(e["deviation"] for e in check.held.values())
    scans = {k: check.launches["replay"].get(k, 0) for k in ("int4_bucket_scan", "bucketed_max_scan")}
    assert scans["int4_bucket_scan"] > 0 and scans["bucketed_max_scan"] > 0, check.launches
    assert check.launches["replay"] == check.launches["eager"], check.launches
    log(f"phase 15 (a) on {card}: {len(check.held)} keys held to their eager programs "
        f"({sum(e['checks'] for e in check.held.values())} checks), largest deviation {dev:.3g} (bound {PHASE15_RTOL}); "
        f"(b) scan launches of the checking replays {scans} = the eager programs' {check.launches['eager']}")
    for (owner, key), entry in sorted(check.held.items(), key=str):
        log(f"  phase 15 key {owner} {key}: {entry['checks']} checks, deviation {entry['deviation']:.3g}")
    for name, report in out["pools"].items():
        log(f"phase 15 pool {name} on {card}: {json.dumps(report)}")
    out.update({"keys": len(check.held), "deviation": dev, "replay_launches": scans, "seconds": time.perf_counter() - t_start})
    log(f"phase 15 done in {out['seconds']:.1f} s on {card}")
    return out


#: Phase 16 (f)'s document, raced against 8 hybrid searches, then deleted.
PHASE16_RACE_ID = "phase16-race"
#: Phase 16: the program families that must each hold a key.
PHASE16_FAMILIES = ("bm25", "bm25_gather", "rrf", "chunklet", "hash", "boundary", "nnls")


def _family_report(programs: dict) -> dict:
    """Per program family (a key's first element), over the named
    ProgramGraphs objects: the keys held, their capture ms and the pool
    bytes their captures added."""
    out: dict = {}
    for p in programs.values():
        for key, st in p.stats().items():
            fam = out.setdefault(key[0], {"keys": 0, "capture_ms": 0.0, "pool_bytes": 0})
            fam["keys"] += 1
            fam["capture_ms"] += st["capture_ms"]
            fam["pool_bytes"] += st["pool_bytes"]
    return out


def phase16(cfg, texts: list[str], queries: list[str], seed: int, card: str, total: dict[str, int]) -> dict:
    """Phase 16: the search side's remaining one-dispatch programs from CUDA
    graphs over the phase-3 store and its keyword index (module docstring,
    phase 16), each held key against its eager program."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    import raglite_tpu_torch.query_adapter as qa
    from raglite_tpu_torch import Document, delete_documents, insert_documents
    from raglite_tpu_torch.index.dense import dense_index_from_config
    from raglite_tpu_torch.index.keyword import keyword_index_from_config
    from raglite_tpu_torch.models.boundary import default_model
    from raglite_tpu_torch.models.encoder import HashEncoder, _hash_table, encoder_from_config
    from raglite_tpu_torch.search import (
        hybrid_search,
        hybrid_search_batch,
        keyword_search,
        keyword_search_batch,
        rerank_chunks,
        retrieve_chunks,
    )
    from raglite_tpu_torch.utils import graphs

    t_start = time.perf_counter()
    dense, kw = dense_index_from_config(cfg), keyword_index_from_config(cfg)
    encoder = encoder_from_config(cfg)
    shared = graphs.shared_programs("cuda")
    hashed = HashEncoder(dim=1024, device="cuda")  # phase 8 (d)'s embedder, apart from the factory's cache
    boundary = default_model("cuda")
    owners = {"keyword": kw.programs, "index": dense.programs, "shared": shared, "hash": hashed.programs,
              "boundary": boundary.programs, "sem": encoder.programs}
    names = {id(p): name for name, p in owners.items()}
    tail = tail_queries(256, seed)
    ccfg = dataclasses.replace(cfg, reranker="maxsim_chunklet")
    wide = " ".join(queries)  # more unique terms than the resident postings take
    rng = np.random.default_rng(seed + 16)
    qb = rng.normal(size=(64, D)).astype(np.float32)
    qb /= np.linalg.norm(qb, axis=1, keepdims=True)
    pb = (rng.normal(size=(64, 40, D)) / np.sqrt(D)).astype(np.float32)
    nb = (rng.normal(size=(64, 40, D)) / np.sqrt(D)).astype(np.float32)
    pb[::3, 30:], nb[1::3, 25:] = 0.0, 0.0  # evals with fewer positives or negatives
    out: dict = {}
    with _ProgramCheck(names) as check:
        check.on = True

        def held_programs():
            for q in [*queries, *tail[:8]]:
                hybrid_search(q, num_results=10, config=cfg)
                assert kw.last_route == "hybrid_fused" and dense.last_route == "int4_two_stage", (kw.last_route, dense.last_route)
                keyword_search(q, num_results=10, config=cfg)
                assert kw.last_route == "resident", kw.last_route
            hybrid_search_batch(tail[:32], num_results=10, config=cfg)
            assert dense.last_route == "int4_two_stage"
            hybrid_search_batch(tail, num_results=10, config=cfg)
            keyword_search_batch(tail, num_results=10, config=cfg)
            for _ in range(2):
                keyword_search(wide, num_results=10, config=cfg)
                assert kw.last_route == "host_gather", kw.last_route
            for q in queries[:4]:
                ids, _ = hybrid_search(q, num_results=20, config=cfg)
                rerank_chunks(q, retrieve_chunks(ids, config=cfg), config=ccfg)
            for text in (texts[0][:6000], texts[1][:6000], texts[0][:6000]):
                hashed.embed_token_level(text)
            for text in (*texts, texts[0]):
                boundary(text)
            for _ in range(2):
                qa._nnls_targets("cuda", qb, pb, nb, alpha=0.05)

        _counted(total, held_programs)
        check.on = False
    families = {key[0] for _, key in check.held}
    assert set(PHASE16_FAMILIES) <= families, families
    dev = max(e["deviation"] for e in check.held.values())
    scans = check.launches["replay"].get("int4_bucket_scan", 0)
    assert scans > 0 and check.launches["replay"] == check.launches["eager"], check.launches
    log(f"phase 16 (a) on {card}: {len(check.held)} keys held to their eager programs "
        f"({sum(e['checks'] for e in check.held.values())} checks) over the families {sorted(families)}, largest "
        f"deviation {dev:.3g} (bound {PHASE15_RTOL}); (b) int4 launches of the checking replays {scans} = the eager "
        f"programs' {check.launches['eager'].get('int4_bucket_scan', 0)}")
    for (owner, key), entry in sorted(check.held.items(), key=str):
        if owner != "sem":
            log(f"  phase 16 key {owner} {key}: {entry['checks']} checks, deviation {entry['deviation']:.3g}")
    out.update({"keys": len(check.held), "deviation": dev, "replay_int4": scans})
    # (c) Times from the graphs and eager, in turns.
    items = [*queries, *tail[:8]]
    hs_g, hs_e = _paired_p50(lambda q: hybrid_search(q, num_results=10, config=cfg), items)
    ks_g, ks_e = _paired_p50(lambda q: keyword_search(q, num_results=10, config=cfg), items)
    split = {"graphs": _hybrid_stages(cfg, items, 20, 10)}
    with graphs.eager_programs():
        split["eager"] = _hybrid_stages(cfg, items, 20, 10)
    split = {mode: {k: statistics.median(v) for k, v in st.items()} for mode, st in split.items()}
    batches = {}
    for name, fn, b in (("keyword_search_batch", keyword_search_batch, 256), ("hybrid_search_batch", hybrid_search_batch, 256),
                        ("hybrid_search_batch", hybrid_search_batch, 32)):
        g, e = _paired_p50(lambda _, fn=fn, b=b: fn(tail[:b], num_results=10, config=cfg), range(3))
        batches[f"{name}_b{b}"] = {"ms": g, "eager_ms": e, "qps": b / g * 1e3, "eager_qps": b / e * 1e3}
    log(f"phase 16 (c) on {card}: hybrid_search p50 {hs_g:.3f} ms from the graphs, {hs_e:.3f} eager; keyword_search "
        f"p50 {ks_g:.3f} ms, {ks_e:.3f} eager (B 1, {len(items)} queries, host clock); hybrid split p50 (ms) from the "
        f"graphs {json.dumps({k: round(v, 3) for k, v in split['graphs'].items()})}, eager "
        f"{json.dumps({k: round(v, 3) for k, v in split['eager'].items()})}; batches "
        + "; ".join(f"{k} {v['ms']:.2f} ms ({v['qps']:.1f} queries/s) from the graphs, {v['eager_ms']:.2f} ms "
                    f"({v['eager_qps']:.1f}) eager" for k, v in batches.items()))
    out.update({"hybrid_ms": hs_g, "hybrid_eager_ms": hs_e, "keyword_ms": ks_g, "keyword_eager_ms": ks_e,
                "split_ms": split, "batches": batches})
    # (d) Device operations per hybrid call.
    for q in queries:
        hybrid_search(q, num_results=10, config=cfg)
    ops, idle = _profile_window(lambda: [hybrid_search(q, num_results=10, config=cfg) for q in queries],
                                f"{len(queries)} hybrid_search calls from the graphs", card, top=8)
    with graphs.eager_programs():
        e_ops, e_idle = _profile_window(lambda: [hybrid_search(q, num_results=10, config=cfg) for q in queries],
                                        f"{len(queries)} hybrid_search calls, eager", card, top=8)
    log(f"phase 16 (d) device operations per hybrid_search call: {ops / len(queries):.1f} from the graphs (idle share "
        f"{idle:.3f}), {e_ops / len(queries):.1f} eager (idle share {e_idle:.3f}), on {card}")
    out.update({"ops_per_hybrid": ops / len(queries), "ops_per_hybrid_eager": e_ops / len(queries),
                "idle_share": idle, "idle_share_eager": e_idle})
    # (e) Capture ms, pool bytes and keys held, per object and per family.
    out["pools"] = {name: _pool_report(p) for name, p in owners.items() if name != "sem"}
    out["families"] = _family_report({k: v for k, v in owners.items() if k != "sem"})
    for name, report in out["pools"].items():
        log(f"phase 16 (e) pool {name} on {card}: keys {report['keys']}, pool bytes {report['pool_bytes']}, "
            f"counts {report['counts']}")
    log(f"phase 16 (e) per family on {card}: {json.dumps(out['families'])}")
    # (f) 8 hybrid searches racing an insert: each result equals the same
    # search before or after it.
    racers = [PHASE15_QUERY, *queries[:3]] * 2
    before = {q: hybrid_search(q, num_results=10, config=cfg) for q in set(racers)}
    raced: dict[int, list] = {}

    def search_during(i: int) -> None:
        raced[i] = [hybrid_search(racers[i], num_results=10, config=cfg) for _ in range(4)]

    threads = [threading.Thread(target=search_during, args=(i,)) for i in range(len(racers))]
    threads.append(threading.Thread(
        target=lambda: insert_documents([Document.from_text(PHASE15_DOC, id=PHASE16_RACE_ID)], config=cfg)))
    gen = kw.generation
    _counted(total, lambda: ([t.start() for t in threads], [t.join(timeout=300) for t in threads]))
    assert not any(t.is_alive() for t in threads) and len(raced) == len(racers)
    after = {q: hybrid_search(q, num_results=10, config=cfg) for q in set(racers)}
    assert kw.generation > gen and before[PHASE15_QUERY] != after[PHASE15_QUERY]
    mixed = [r for i, rs in raced.items() for r in rs if r not in (before[racers[i]], after[racers[i]])]
    assert not mixed, mixed
    delete_documents([PHASE16_RACE_ID], config=cfg)
    log(f"phase 16 (f) {len(racers)} threads of hybrid_search racing an insert: each of "
        f"{sum(map(len, raced.values()))} results equal to the same search before or after it "
        f"({sum(r == after[racers[i]] for i, rs in raced.items() for r in rs)} after), on {card}")
    # (g) The other programs from their graphs and eager.
    text = texts[0][:6000]
    hash_g, hash_e = _paired_p50(lambda _: hashed.embed_token_level(text), range(8))
    tops = [retrieve_chunks(hybrid_search(q, num_results=20, config=cfg)[0], config=cfg) for q in queries[:4]]
    rr_g, rr_e = _paired_p50(lambda i: rerank_chunks(queries[i], tops[i], config=ccfg), range(4), reps=2)
    big = "\n\n".join(texts)
    bd_g, bd_e = _paired_p50(lambda _: boundary(big), range(3))
    on_card = [torch.from_numpy(a).cuda() for a in (qb, pb, nb)]
    nnls_g = median_ms(lambda: qa._nnls_targets("cuda", *on_card, alpha=0.05), reps=3, inner=1, warmup=1)
    with graphs.eager_programs():
        nnls_e = median_ms(lambda: qa._nnls_targets("cuda", *on_card, alpha=0.05), reps=3, inner=1, warmup=1)
    per = 1e5 / len(big)
    log(f"phase 16 (g) on {card}: hash:1024 encode of {len(text)} characters {hash_g:.3f} ms from its graph, {hash_e:.3f} "
        f"eager; maxsim_chunklet rerank of a top 20 p50 {rr_g:.3f} ms, {rr_e:.3f} eager; the boundary model "
        f"{bd_g * per:.3f} ms per 100k characters, {bd_e * per:.3f} eager ({len(big)} characters); NNLS B 64, "
        f"P*N 1,600, d {D}: {nnls_g:.3f} ms from its graph, {nnls_e:.3f} eager (CUDA events)")
    out.update({"hash_ms": hash_g, "hash_eager_ms": hash_e, "chunklet_ms": rr_g, "chunklet_eager_ms": rr_e,
                "boundary_ms_per_100k": bd_g * per, "boundary_eager_ms_per_100k": bd_e * per,
                "nnls_ms": nnls_g, "nnls_eager_ms": nnls_e, "seconds": time.perf_counter() - t_start})
    _hash_table.cache_clear()  # phase 8 (d) times the hash: table's draw
    log(f"phase 16 done in {out['seconds']:.1f} s on {card}")
    return out


#: Phase 17 (b): MB of text harvested from this machine's site-packages.
PHASE17_CORPUS_MB = 3.0
#: Phase 17 (b): steps of MLM from the seeded init, and of each later phase
#: (200 and 50 took 58 s of steps in a run that has to end within its time
#: limit on a slow host; the MLM loss still falls within 100).
PHASE17_MLM_STEPS = 100
PHASE17_STEPS = 25
#: Phase 17 (b): the exported encoder's embeddings against the same
#: f16-rounded weights built in memory: the same bf16 values through the same
#: programs, so equal but for a summation order cuBLAS might change between
#: two objects' graphs.
PHASE17_EXPORT_ATOL = 1e-6
#: Phase 17 (c): the card against the CPU from the same start on the same
#: batches.  The card's GEMMs are bf16 x bf16 -> f32 on tensor cores, the
#: CPU's f32 GEMMs of the same bf16 values: each sum differs in order only,
#: but the residual stream is rounded to bf16 after every sublayer, where a
#: value on a rounding boundary lands on either side (a relative 2^-8), and
#: the backward's f32 cotangent enters the tensor cores in bf16 (2^-9 an
#: element, in no common direction).  The losses, per phase: MLM within
#: 1e-3 relative, 6.6x the largest difference read (1.52e-4).  Contrastive
#: within 3e-2: its loss is small (0.06-0.54 at batch 8 from the packaged
#: encoder) and its logits are cosines over temperature 0.05, so a cosine
#: 1e-4 apart moves the loss by up to 4e-3; and Adam's first update moves
#: every parameter by about the learning rate in its gradient's sign, so a
#: gradient element that is rounding noise moves one way on the card and
#: the other on the CPU.  The reading was 1.07e-3 at the first step (the
#: same weights) and 1.17e-2 after an update; a lost update moved the loss
#: 0.127 (the control), four times the limit.  The first step's gradients:
#: the flattened cosine at least 0.999 (the CPU tests' bf16 bound against
#: the JAX script), and each leaf's cosine too, for every leaf whose norm is
#: at least 1e-3 of the largest leaf's (the key biases' gradients, which
#: the softmax cancels, are rounding noise with no direction).  Controls,
#: which must fail these limits: each later batch's loss at the starting
#: weights (a step whose update was lost) against the CPU's loss after the
#: update, and the card's second gradient against the CPU's first.
PHASE17_LOSS_RTOL = {"mlm": 1e-3, "contrastive": 3e-2}
PHASE17_GRAD_COS = 0.999
PHASE17_LEAF_FLOOR = 1e-3
#: Phase 17 (c): the batch and the steps a side.
PHASE17_PARITY_BATCH, PHASE17_PARITY_STEPS = 8, 3
#: Phase 17 (d): MLM steps at batch 256 over the trained tokenizer's cache.
PHASE17_TOKENIZER_MLM_STEPS = 20


def _phase17_report(stats: dict, card: str) -> dict:
    keys = ("steps", "first_step_s", "steps_per_s", "tokens_per_s", "tflops", "peak_gb", "host_share",
            "enqueue_share", "loss_first", "loss_last", "loss_first20", "loss_last20", "mine_s", "mined_docs", "dense_mean", "tok_mean")
    out = {k: stats[k] for k in keys if k in stats}
    out["mfu"] = stats["tflops"] * 1e12 / PEAK_BF16_FLOPS
    log(f"phase 17 (b) {stats['phase']}: {stats['steps']} steps, loss {stats['loss_first']:.4f} -> "
        f"{stats['loss_last']:.4f}, {stats['steps_per_s']:.3f} steps/s, {stats['tokens_per_s']:.0f} tokens/s, "
        f"{stats['tflops']:.1f} model TFLOP/s ({100 * out['mfu']:.1f} % of 989), peak {stats['peak_gb']:.2f} GB, "
        f"host share {stats['host_share']:.4f} making batches, {stats['enqueue_share']:.4f} enqueueing the steps "
        f"({1e3 * stats['enqueue_share'] / stats['steps_per_s']:.1f} ms a step; first step {stats['first_step_s']:.2f} s) "
        f"on {card}")
    assert all(math.isfinite(x) for x in stats["losses"]), stats["phase"]
    return out


def phase17_boundary(root: Path, card: str) -> dict:
    """Phase 17 (a): the boundary trainer's whole recipe on the card."""
    import numpy as np

    from raglite_tpu_torch.models.boundary import BoundaryModel
    from raglite_tpu_torch.models.boundary_data import make_corpus
    from raglite_tpu_torch.sentences import heuristic_sentence_boundaries
    from raglite_tpu_torch.train import boundary as tb

    path = root / "boundary.npz"
    model, stats = tb.main(["--out", str(path)])
    assert stats["device"] == "cuda", stats["device"]
    packaged = tb.held_out_f1(BoundaryModel.load(device="cuda"))
    heuristic = tb.held_out_f1(heuristic_sentence_boundaries)
    back = BoundaryModel.load(path, device="cuda")
    docs = [doc for doc, _ in make_corpus(num_documents=tb.NUM_EVAL_DOCS, seed=tb.EVAL_SEED)]
    same = all(np.array_equal(back(doc), model(doc)) for doc in docs)
    log(f"phase 17 (a) boundary trainer: {stats['examples']} examples ({stats['positives']} positives) from "
        f"{stats['docs']} documents in {stats['data_s']:.2f} s; {stats['steps']} steps in {stats['s']:.2f} s "
        f"({stats['steps_per_s']:.1f} steps/s); held-out F1 {stats['f1_learned']:.4f} (packaged {packaged:.4f}, "
        f"heuristic {heuristic:.4f}); reloaded probabilities equal: {same}; losses by epoch "
        f"{ {k: round(v, 5) for k, v in stats['loss_by_epoch'].items()} } on {card}")
    assert stats["f1_learned"] >= 0.99, stats["f1_learned"]
    assert same
    return {k: stats[k] for k in ("examples", "steps", "s", "steps_per_s", "f1_learned")} | {
        "f1_packaged": packaged, "f1_heuristic": heuristic}


def phase17_encoder(root: Path, card: str, total: dict[str, int]) -> dict:
    """Phase 17 (b): the encoder trainer at the packaged encoder's full
    width through its command line's entry point (``main(argv)``): a corpus
    from this machine's site-packages, MLM from the seeded init, then
    contrastive, hard-negative and MaxSim from the packaged weights, the
    export, and the export served."""
    import shutil

    import numpy as np
    import torch

    from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents, vector_search
    from raglite_tpu_torch.models.encoder import PACKAGED_ENCODER_DIR, TransformerEncoder, encoder_from_config
    from raglite_tpu_torch.models.tokenizer import load_tokenizer
    from raglite_tpu_torch.models.transformer import EncoderModel, load_npz_encoder
    from raglite_tpu_torch.train import corpus, export_hf
    from raglite_tpu_torch.train import encoder as te

    work, out = root / "work", root / "export"
    t0 = time.perf_counter()
    summary = corpus.main(["--out", str(root / "corpus"), "--max-mb", str(PHASE17_CORPUS_MB)])
    harvest_s = time.perf_counter() - t0
    tokens = te.main(["--phase", "tokens", "--workdir", str(work), "--corpus", str(root / "corpus")])["tokens"]
    log(f"phase 17 (b) corpus: {summary['train_docs']} train documents ({summary['train_mb']} MB), "
        f"{summary['heldout_docs']} held out, harvested in {harvest_s:.1f} s; {tokens['tokens']} tokens in "
        f"{tokens['docs']} documents, tokenized in {tokens['s']:.1f} s, on {card}")
    args = ["--workdir", str(work), "--device", "cuda"]
    phases = {"mlm": te.main(["--phase", "mlm", "--steps", str(PHASE17_MLM_STEPS), *args])["mlm"]}
    # The later phases start from real weights: the packaged encoder as mlm.npz.
    shutil.copyfile(PACKAGED_ENCODER_DIR / "encoder.npz", work / "mlm.npz")
    for name in ("contrastive", "hardneg", "maxsim"):
        phases[name] = te.main(["--phase", name, "--steps", str(PHASE17_STEPS), *args])[name]
    t0 = time.perf_counter()
    te.main(["--phase", "export", "--out", str(out), *args])
    export_s = time.perf_counter() - t0
    report = {name: _phase17_report(stats, card) for name, stats in phases.items()}
    mlm = phases["mlm"]
    assert mlm["loss_last20"] < mlm["loss_first20"], (mlm["loss_first20"], mlm["loss_last20"])

    # The export served: flax:<dir> against the same f16-rounded weights in
    # memory, then a store embedded with it.
    texts = pick_queries([(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS[:2]], 8, 17)
    served = encoder_from_config(RAGLiteConfig(embedder=f"flax:{out}", device="cuda"))
    cfg, params, _ = load_npz_encoder(str(work / "maxsim.npz"))

    def f16(a):  # the export's rounding: matrices to f16, vectors kept
        return a.astype(np.float16) if a.ndim >= 2 else a

    params = {k: [{n: f16(a) for n, a in layer.items()} for layer in v] if k == "layers" else f16(v) for k, v in params.items()}
    memory = TransformerEncoder.from_model(
        EncoderModel.from_params(cfg, params, dtype=torch.bfloat16, device="cuda"), load_tokenizer(str(out / "tokenizer.json"))
    )
    got, want = served.embed(texts), memory.embed(texts)
    export_err = float(np.abs(got - want).max())
    store_cfg = RAGLiteConfig(store_path=str(root / "store"), embedder=f"flax:{out}", device="cuda")

    def serve_export():
        insert_documents([Document.from_text((ROOT / f).read_text(encoding="utf-8")) for f in STORE_DOCS[:2]], config=store_cfg)
        return [vector_search(q, num_results=5, config=store_cfg) for q in texts]

    t0 = time.perf_counter()
    results = _counted(total, serve_export)
    serve_s = time.perf_counter() - t0
    log(f"phase 17 (b) export: {(out / 'encoder.npz').stat().st_size / 1e6:.1f} MB in {export_s:.1f} s; flax:<dir> "
        f"embeddings of {len(texts)} texts against the f16-rounded weights in memory: max |diff| {export_err:.3g} "
        f"(limit {PHASE17_EXPORT_ATOL}); a 2-document store embedded with it and {len(texts)} vector_search calls in "
        f"{serve_s:.1f} s, {sum(len(ids) for ids, _ in results)} hits, on {card}")
    assert got.shape == (len(texts), 768) and np.isfinite(got).all()
    assert export_err <= PHASE17_EXPORT_ATOL, export_err
    assert all(len(ids) == 5 and np.isfinite(scores).all() for ids, scores in results), results

    # The npz export through the HF export module (export_hf's command
    # line), served as flax:<dir>: the same f16 matrices and f32 vectors.
    t0 = time.perf_counter()
    export_hf.main(["--src", str(out), "--out", str(root / "export-hf")])
    hf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hf = encoder_from_config(RAGLiteConfig(embedder=f"flax:{root / 'export-hf'}", device="cuda")).embed(texts)
    hf_err = float(np.abs(hf - got).max())
    log(f"phase 17 (b) HF export (python -m raglite_tpu_torch.train.export_hf): model.safetensors "
        f"{(root / 'export-hf' / 'model.safetensors').stat().st_size / 1e6:.1f} MB in {hf_s:.2f} s; its flax:<dir> "
        f"embeddings of the {len(texts)} texts against the npz export's: max |diff| {hf_err:.3g} (limit "
        f"{PHASE17_EXPORT_ATOL}), in {time.perf_counter() - t0:.2f} s, on {card}")
    assert hf.shape == got.shape and hf_err <= PHASE17_EXPORT_ATOL, hf_err
    return {"corpus": {**summary, "tokens": tokens["tokens"]}, "phases": report, "export_max_abs_diff": export_err,
            "hf_export_max_abs_diff": hf_err, "hf_export_s": hf_s}


def phase17_profile(work: Path, card: str) -> None:
    """``--profile``: two warm steps of each encoder phase at phase 17 (b)'s
    batch sizes from its workdir's files, in a torch.profiler window each
    (the device's busy time by kernel and its idle share)."""
    import numpy as np
    import torch

    from raglite_tpu_torch.train import encoder as te
    from raglite_tpu_torch.train import optim

    cfg, device = te.SIZES["base"], torch.device("cuda")
    flat, offsets = te.load_tokens(work / "tokens.npz")
    ok = np.flatnonzero(np.diff(offsets) >= 48)
    neighbors = ok[np.random.default_rng(17).integers(0, ok.size, (ok.size, 8))]
    cases = {
        "mlm": ("mlm.npz", te.mlm_loss, te.MLMBatches(flat, offsets, 256, te.SEQ, cfg["vocab"])),
        "contrastive": ("mlm.npz", te.contrastive_loss, te.CropBatches(flat, offsets, 512, te.SEQ, te.QSEQ)),
        "hardneg": ("contrastive.npz", te.hardneg_loss,
                    te.NegativeBatches(flat, offsets, ok, neighbors, 256, te.SEQ, te.QSEQ, seed=2)),
        "maxsim": ("hardneg.npz", te.maxsim_loss,
                   te.NegativeBatches(flat, offsets, ok, neighbors, 64, te.SEQ, te.QSEQ, seed=3)),
    }
    for name, (start, loss_fn, make_batch) in cases.items():
        net = te.Trainable(cfg, te.load_params(work / start)[1], device, torch.bfloat16)
        opt = optim.adamw(net.leaves, lambda count: 1e-5, b1=0.9, b2=0.98, eps=1e-6, weight_decay=0.01, clip=1.0)
        batches = [[te._to_device(a, device) for a in make_batch()] for _ in range(3)]
        te.train_step(net, opt, loss_fn, batches[0])
        _profile_window(lambda: [te.train_step(net, opt, loss_fn, b) for b in batches[1:]],
                        f"phase 17 {name}, 2 steps", card, top=16)
        del net, opt, batches
        torch.cuda.empty_cache()


class _KeepGrads:
    """An optimizer that keeps a host copy of its first two steps' gradients
    (as the loss gave them, before the clip), then updates."""

    def __init__(self, opt) -> None:
        self.opt, self.grads = opt, []

    def step(self, grads) -> None:
        if len(self.grads) < 2:
            self.grads.append([g.detach().to("cpu", copy=True) for g in grads])
        self.opt.step(grads)


def _phase17_steps(device: str, state: dict, loss_fn, batches: list, lr: float) -> dict:
    """``train_step`` over ``batches`` at the base size from ``state`` (Adam
    as the trainer sets it, at a constant ``lr``): each step's loss and the
    first two steps' gradients; on the card also each batch's loss at the
    starting weights (the control)."""
    import torch

    from raglite_tpu_torch.train import encoder as te
    from raglite_tpu_torch.train import optim
    from raglite_tpu_torch.utils.precision import full_f32_matmul

    dev = torch.device(device)
    net = te.Trainable(te.SIZES["base"], state, dev, torch.bfloat16)
    on = [[te._to_device(a, dev) for a in batch] for batch in batches]
    frozen = None
    if device == "cuda":
        with torch.no_grad(), full_f32_matmul():
            p = net.cast()
            frozen = [float(loss_fn(net, p, *batch)) for batch in on]
    opt = _KeepGrads(optim.adamw(net.leaves, lambda count: lr, b1=0.9, b2=0.98, eps=1e-6, weight_decay=0.01, clip=1.0))
    losses = [float(te.train_step(net, opt, loss_fn, batch).detach()) for batch in on]
    return {"losses": losses, "frozen": frozen, "grads": opt.grads, "names": list(net.masters)}


def _grad_agreement(got: list, want: list, names: list[str]) -> tuple[float, float, str]:
    """The flattened cosine of two gradients, and the smallest leaf cosine
    (with its leaf) over the leaves of norm at least PHASE17_LEAF_FLOOR of
    ``want``'s largest."""
    dot = sum(float((a.double() * b.double()).sum()) for a, b in zip(got, want, strict=True))
    norms = [(float(a.double().norm()), float(b.double().norm())) for a, b in zip(got, want, strict=True)]
    flat = dot / math.sqrt(sum(x * x for x, _ in norms) * sum(y * y for _, y in norms))
    top = max(y for _, y in norms)
    worst, leaf = 1.0, ""
    for name, a, b, (na, nb) in zip(names, got, want, norms, strict=True):
        if nb >= PHASE17_LEAF_FLOOR * top:
            cos = float((a.double() * b.double()).sum()) / (na * nb) if na else 0.0
            worst, leaf = min((worst, leaf), (cos, name))
    return flat, worst, leaf


def phase17_parity(root: Path, card: str) -> dict:
    """Phase 17 (c): the card against the CPU at full width, batch 8, on
    the same batches: 3 MLM steps from the seeded init and 3 contrastive
    steps from the packaged encoder (real weights: embeddings that differ),
    each phase's losses, its first step's gradients, and the controls."""
    from raglite_tpu_torch.models.encoder import PACKAGED_ENCODER_DIR
    from raglite_tpu_torch.train import encoder as te

    cfg = te.SIZES["base"]
    flat, offsets = te.load_tokens(root / "work" / "tokens.npz")
    mlm_batches = te.MLMBatches(flat, offsets, PHASE17_PARITY_BATCH, te.SEQ, cfg["vocab"])
    crop_batches = te.CropBatches(flat, offsets, PHASE17_PARITY_BATCH, te.SEQ, te.QSEQ)
    cases = {  # the start, the loss, the batches, the trainer's peak learning rate
        "mlm": (te.init_params(cfg), te.mlm_loss, [mlm_batches() for _ in range(PHASE17_PARITY_STEPS)], 4e-4),
        "contrastive": (te.load_params(PACKAGED_ENCODER_DIR / "encoder.npz")[1], te.contrastive_loss,
                        [crop_batches() for _ in range(PHASE17_PARITY_STEPS)], 1e-4),
    }
    out, failed = {}, []
    for name, (state, loss_fn, batches, lr) in cases.items():
        seconds = {}
        sides = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            sides[device] = _phase17_steps(device, state, loss_fn, batches, lr)
            seconds[device] = time.perf_counter() - t0
        card_side, cpu = sides["cuda"], sides["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_side["losses"], cpu["losses"], strict=True))
        control_rel = min(abs(a - b) / abs(b) for a, b in zip(card_side["frozen"][1:], cpu["losses"][1:], strict=True))
        flat_cos, leaf_cos, leaf = _grad_agreement(card_side["grads"][0], cpu["grads"][0], cpu["names"])
        control_cos = _grad_agreement(card_side["grads"][1], cpu["grads"][0], cpu["names"])[0]
        log(f"phase 17 (c) {name} card against CPU (batch {PHASE17_PARITY_BATCH}, {PHASE17_PARITY_STEPS} steps, "
            f"lr {lr}): losses {card_side['losses']} vs {cpu['losses']}, largest relative difference {rel:.3g} "
            f"(limit {PHASE17_LOSS_RTOL[name]}; control, the later batches at the starting weights: {control_rel:.3g}, "
            f"must exceed it); first step's gradients: flattened cosine {flat_cos:.6f}, smallest leaf cosine "
            f"{leaf_cos:.6f} ({leaf}; limit {PHASE17_GRAD_COS}; control, the card's second step against the CPU's "
            f"first: {control_cos:.6f}, must fall below it); card {seconds['cuda']:.1f} s, CPU {seconds['cpu']:.1f} s, "
            f"on {card}")
        checks = {"loss": rel <= PHASE17_LOSS_RTOL[name], "loss control": control_rel > PHASE17_LOSS_RTOL[name],
                  "gradient": min(flat_cos, leaf_cos) >= PHASE17_GRAD_COS, "gradient control": control_cos < PHASE17_GRAD_COS}
        failed += [f"{name} {check}" for check, ok in checks.items() if not ok]
        out[name] = {"losses_cuda": card_side["losses"], "losses_cpu": cpu["losses"], "worst_rel": rel,
                     "control_rel": control_rel, "grad_cos": flat_cos, "leaf_cos": leaf_cos, "leaf": leaf,
                     "control_cos": control_cos, "s_cuda": seconds["cuda"], "s_cpu": seconds["cpu"]}
    assert not failed, failed
    return out


def _byte_level_round_trip(text: str, specials, known: set[int]) -> str:
    """What a ByteLevel tokenizer (add_prefix_space, no unk token) decodes
    from the ids it encoded ``text`` to: each piece between special tokens
    with a space put before it unless it starts with one, the specials
    dropped (decode skips them), and the bytes outside its alphabet dropped
    (the model has no token for them)."""
    raw = "".join(p if p.startswith(" ") else " " + p for p in specials.split(text) if p).encode("utf-8")
    return bytes(b for b in raw if b in known).decode("utf-8", errors="replace")


def phase17_tokenizer(root: Path, card: str) -> dict:
    """Phase 17 (d): ``train.encoder``'s tokenizer phase (train/bpe.py) at the
    ``base`` vocabulary on (b)'s train split, in a workdir of its own; its
    token cache, and PHASE17_TOKENIZER_MLM_STEPS MLM steps at batch 256 from
    the seeded init over it on the card."""
    import re

    from raglite_tpu_torch.models.tokenizer import HFTokenizer, _bytes_to_unicode, load_tokenizer
    from raglite_tpu_torch.train import bpe
    from raglite_tpu_torch.train import encoder as te

    work = root / "tokenizer"
    args = ["--workdir", str(work), "--corpus", str(root / "corpus"), "--device", "cuda"]
    trained = te.main(["--phase", "tokenizer", *args])["tokenizer"]
    mark("phase 17 (d) tokenizer trained")
    tokens = te.main(["--phase", "tokens", *args])["tokens"]
    mlm = te.main(["--phase", "mlm", "--steps", str(PHASE17_TOKENIZER_MLM_STEPS), "--batch", "256", *args])["mlm"]
    spec = json.loads((work / "tokenizer.json").read_text(encoding="utf-8"))
    vocab, merges = spec["model"]["vocab"], spec["model"]["merges"]
    held = [json.loads(line)["text"] for line in open(root / "corpus" / "heldout.jsonl", encoding="utf-8")]
    ours, packaged = HFTokenizer(str(work / "tokenizer.json")), load_tokenizer(str(te.PACKAGED_TOKENIZER))
    chars = sum(len(t) for t in held)
    per_char = sum(len(ours.encode(t)) for t in held) / chars
    per_char_packaged = sum(len(packaged.encode(t)) for t in held) / chars
    byte_of = {c: b for b, c in _bytes_to_unicode().items()}
    known = {byte_of[t] for t in vocab if t in byte_of}
    specials = re.compile("|".join(re.escape(t) for t in bpe.SPECIAL_TOKENS))
    lossy = sum(1 for t in held if set(t.encode("utf-8")) - known)
    wrong = [i for i, t in enumerate(held) if ours.decode(ours.encode(t)) != _byte_level_round_trip(t, specials, known)]
    log(f"phase 17 (d) tokenizer trainer: vocab {trained['vocab']} ({len(merges)} merges) from {(root / 'corpus' / 'train.jsonl').stat().st_size / 1e6:.2f} MB "
        f"in {trained['s']:.2f} s; token cache {tokens['tokens']} tokens of {tokens['docs']} documents in {tokens['s']:.1f} s; "
        f"held-out split ({len(held)} documents, {chars} characters): {per_char:.4f} tokens a character (the packaged "
        f"tokenizer's {per_char_packaged:.4f}); decode(encode(text)) = the text for all {len(held)} ({lossy} with bytes "
        f"outside the trained alphabet, dropped as tokenizers drops them); {mlm['steps']} MLM steps at batch 256 "
        f"over it from the seeded init: loss {mlm['loss_first']:.4f} -> {mlm['loss_last']:.4f}, {mlm['steps_per_s']:.2f} "
        f"steps/s, on {card}")
    assert len(vocab) == te.SIZES["base"]["vocab"] == 16_384, len(vocab)
    assert all(a in vocab and b in vocab and a + b in vocab for a, b in merges)
    assert not wrong, [held[i][:80] for i in wrong[:3]]
    assert all(math.isfinite(x) for x in mlm["losses"]), mlm["losses"]
    return {"s": trained["s"], "vocab": len(vocab), "merges": len(merges), "tokens": tokens["tokens"],
            "tokens_per_char": per_char, "tokens_per_char_packaged": per_char_packaged, "heldout_docs": len(held),
            "lossy_docs": lossy, "mlm_loss_first": mlm["loss_first"], "mlm_loss_last": mlm["loss_last"],
            "mlm_steps_per_s": mlm["steps_per_s"]}


def phase17(card: str, total: dict[str, int], *, profile: bool = False, before_parity=None) -> dict:
    """Phase 17: (a)-(d) in a temporary directory (deleted at the end);
    ``before_parity()``, if given, is called after (b), before (c)'s CPU
    steps."""
    import shutil

    root = scratch_dir(4_000_000_000, "phase17_")
    try:
        out = {"boundary": phase17_boundary(root, card)}
        mark("phase 17 (a)")
        out["encoder"] = phase17_encoder(root, card, total)
        mark("phase 17 (b)")
        if profile:
            phase17_profile(root / "work", card)
        if before_parity is not None:
            before_parity()
        out["parity"] = phase17_parity(root, card)
        mark("phase 17 (c)")
        out["tokenizer"] = phase17_tokenizer(root, card)
        mark("phase 17 (d)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


#: Phase 18: the held-out evaluation's own corpus (phase 17's 5 % split
#: holds about 97 documents, too few for the protocol), its sizes, and the
#: BEIR run's queries and variants.  The rerank reranks 160 candidates a
#: query (search_and_rerank_chunks(num_results=40)), 2.1-2.5 s of host time
#: each (language detection of every candidate, PERF.md §5): so it and the
#: blend sweep run on PHASE18_RERANK_QUERIES queries (32 took 69 s and 155 s
#: in a first run, 8 took 20 s and 36 s in a second) and say that their rows
#: are a check of the path, not a measure; the rerank-32 latency block runs
#: PHASE18_LATENCY_QUERIES (the script's 50 took 27 s, 0.56 s each; the
#: first is not timed), and the BEIR run takes the variants of one store without
#: the HNSW graph (its other variants insert two more stores and rerank 64
#: queries: 109 s in the first run; hnsw builds a graph in one host thread).
PHASE18_CORPUS_MB, PHASE18_HELDOUT_PCT = 3, 20
PHASE18_DOCS, PHASE18_QUERIES, PHASE18_ADAPTER_QUERIES, PHASE18_RERANK_QUERIES = 400, 100, 200, 4
PHASE18_BEIR_QUERIES = 64
PHASE18_BEIR_VARIANTS = "multivector,keyword,hybrid"
PHASE18_BLENDS = "0.0,0.5"
PHASE18_LATENCY_QUERIES = 20
#: Phase 18 (d): the card's per-query rankings against the CPU's at a
#: smaller size, on the two variants whose stores the CPU builds fastest
#: (60 documents took 84 s and 30 took 41 s, most of it the CPU's f32
#: encoder).  The CPU half runs in a process of its own beside (a)-(c), as
#: phase 13 (a)'s does: beside (b) and (c) it took 64.9 s against 40.7 s in
#: turn, and in turn it added 41-52 s to a run that has to end within its
#: time limit on a slow host.
#: A document both devices rank must score alike within the variant's
#: relative limit, and a document only one of them ranks must lie within it
#: of the other's last: documents trade places only where their scores tie
#: within the limit.  The limits are the bf16 rounding the card adds:
#: hash:1024's table is bf16 on the card (2^-8 an entry; the largest
#: difference at a rank 9.4e-4 and 5.7e-4 in two runs); flax:sem's residual
#: stream is rounded to bf16 after each sublayer in another summation order
#: than the CPU's (eight layers; 1.18e-2 and 1.03e-2), 2^-5.  Controls must
#: fail them: each query's ranking against the CPU's ranking of the next
#: query, and for flax:sem the card's rankings through copies of the
#: encoder with a fault (PHASE18_FAULTS).
PHASE18_CPU_DOCS, PHASE18_CPU_QUERIES = 20, 20


def _phase18_small(corpus: str) -> list[str]:
    """Phase 18 (d)'s arguments to ``semantic_ir_bench.main`` on either
    device, but for ``--device`` and ``--workdir``."""
    return ["--docs", str(PHASE18_CPU_DOCS), "--queries", str(PHASE18_CPU_QUERIES), "--adapter-queries", "0",
            "--corpus", corpus, "--embedder", "flax:sem", "--variants", ",".join(PHASE18_CPU_RTOL)]


def phase18_cpu(corpus: str, workdir: str) -> dict:
    """Phase 18 (d)'s CPU half (run by ``beside``): the small protocol on the
    CPU; its per-query rankings, its rows and its seconds."""
    from raglite_tpu_torch.train import semantic_ir_bench as sib

    t0 = time.perf_counter()
    res = sib.main([*_phase18_small(corpus), "--device", "cpu", "--workdir", workdir])
    return {"rankings": res["rankings"], "variants": res["variants"], "s": time.perf_counter() - t0}

PHASE18_CPU_RTOL = {"hash-single": 2.0**-8, "sem-multivector": 2.0**-5}
PHASE18_CPU_BUDGET_S = 60.0
#: Phase 18 (d)'s faulty copies of the packaged encoder (``faulty_encoder``),
#: which must fail the limit: its last layer left out, and every weight
#: matrix of its layers rounded to float8 e4m3, a fault near the limit (on
#: the card over these documents its largest difference at a rank was
#: 6.08e-2, 6 mismatches, where the last layer's absence gave 0.787; on the
#: CPU over 12 seeded documents of random words e4m3 gave only 1.07e-2).
PHASE18_FAULTS = ("drop", "e4m3")


def faulty_encoder(out: Path, fault: str) -> Path:
    """A copy of the packaged encoder (``flax:<out>``) with a fault:
    ``drop`` leaves out its last layer, ``e4m3`` rounds every weight matrix
    of its layers to float8 e4m3 (stored back in its own dtype)."""
    import shutil

    import numpy as np
    import torch

    from raglite_tpu_torch.models.encoder import PACKAGED_ENCODER_DIR

    out.mkdir(parents=True)
    shutil.copy(Path(PACKAGED_ENCODER_DIR) / "tokenizer.json", out)
    with np.load(Path(PACKAGED_ENCODER_DIR) / "encoder.npz") as z:
        arrays = {k: z[k] for k in z.files}
    cfg = json.loads(bytes(arrays["__config__"]).decode())
    if fault == "drop":
        cfg["layers"] -= 1
        arrays = {k: v for k, v in arrays.items() if not k.startswith(f"layers.{cfg['layers']}.")}
    else:
        for k, v in arrays.items():
            if k.startswith("layers.") and k.rsplit(".", 1)[1].startswith("w") and v.ndim == 2:
                rounded = torch.from_numpy(v.astype(np.float32)).to(torch.float8_e4m3fn).to(torch.float32)
                arrays[k] = rounded.numpy().astype(v.dtype)
    arrays["__config__"] = np.frombuffer(json.dumps(cfg).encode(), np.uint8)
    np.savez(out / "encoder.npz", **arrays)
    return out


def _worst_difference(got: list, want: list) -> float:
    """The largest relative difference of a document's score between two
    devices' per-query rankings of (document, score), over the documents
    both rank."""
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        sb = dict(b)
        for doc, score in a:
            if doc in sb:
                worst = max(worst, abs(score - sb[doc]) / max(abs(score), abs(sb[doc])))
    return worst


def _ranking_mismatches(got: list, want: list, rtol: float) -> list[str]:
    """Where two devices' per-query rankings of (document, score) disagree:
    a document both rank scored apart by more than ``rtol`` (relative), or
    a document one ranks and the other does not that scores above the
    other's last by more than ``rtol``."""
    def off(x: float, y: float) -> bool:
        return abs(x - y) > rtol * max(abs(x), abs(y))

    bad = []
    for q, (a, b) in enumerate(zip(got, want, strict=True)):
        sa, sb = dict(a), dict(b)
        for doc in sa.keys() & sb.keys():
            if off(sa[doc], sb[doc]):
                bad.append(f"query {q}: {doc} scores {sa[doc]} and {sb[doc]}")
        for only, other in ((sa, sb), (sb, sa)):
            last = min(other.values(), default=float("inf"))
            for doc in only.keys() - other.keys():
                if only[doc] > last and off(only[doc], last):
                    bad.append(f"query {q}: {doc} ({only[doc]}) ranked on one side only, above the other's last ({last})")
    return bad


def phase18(card: str, total: dict[str, int]) -> dict:
    """Phase 18: the held-out IR evaluation (train/semantic_ir_bench.py) on
    the card through its entry points, in a temporary directory (deleted at
    the end): (a) ``main`` with the packaged encoder, all six variants, (b)
    the protocol exported as a BEIR directory and run through ``irbench``,
    (c) the ``reranker_blend`` sweep over (a)'s ``sem_mv`` store, (d) the
    card's rankings against the CPU's at a smaller size (the CPU half in a
    process of its own, beside (a)-(c))."""
    import shutil

    from raglite_tpu_torch.train import corpus
    from raglite_tpu_torch.train import semantic_ir_bench as sib

    t_start = time.perf_counter()
    root = scratch_dir(2_000_000_000, "phase18_")
    stack = contextlib.ExitStack()  # (d)'s CPU half, killed if this phase fails first
    try:
        t0 = time.perf_counter()
        summary = corpus.main(["--out", str(root / "corpus"), "--max-mb", str(PHASE18_CORPUS_MB),
                               "--heldout-pct", str(PHASE18_HELDOUT_PCT)])
        log(f"phase 18 corpus: {summary['heldout_docs']} held-out documents ({summary['heldout_mb']} MB), "
            f"{summary['train_docs']} train, harvested in {time.perf_counter() - t0:.1f} s")
        mark("phase 18 corpus")
        cpu_half = stack.enter_context(beside("phase18_cpu", str(root / "corpus"), str(root / "small-cpu")))
        common = ["--corpus", str(root / "corpus"), "--device", "cuda"]
        sizes = ["--docs", str(PHASE18_DOCS), "--queries", str(PHASE18_QUERIES),
                 "--adapter-queries", str(PHASE18_ADAPTER_QUERIES)]
        t0 = time.perf_counter()
        res = _counted(total, lambda: sib.main([*sizes, *common, "--embedder", "flax:sem", "--workdir", str(root / "ir"),
                                                "--rerank-queries", str(PHASE18_RERANK_QUERIES),
                                                "--latency-queries", str(PHASE18_LATENCY_QUERIES)]))
        eval_s = time.perf_counter() - t0
        lat = res["rerank_latency"]
        log(f"phase 18 (a) held-out evaluation, the packaged encoder (flax:sem), {res['docs']} documents, "
            f"{res['variants'][0]['queries']} queries, {res['adapter_evals']} adapter evals, in {eval_s:.1f} s on {card}; "
            "the packaged encoder was trained on documents harvested on another machine, which these held-out "
            "documents may be among, so the figures check the path and are no measure of retrieval quality; (d)'s "
            "CPU half ran beside it, which the seconds below include:")
        for row in res["variants"]:
            log(f"  {row['variant']}: MRR@10 {row['mrr_at_10']:.4f}, nDCG@10 {row['ndcg_at_10']:.4f}, recall@10 "
                f"{row['recall_at_10']:.4f} over {row['queries']} queries in {row['seconds']:.1f} s")
        log(f"  inserts {', '.join(f'{k} {v:.2f} s' for k, v in res['insert_s'].items())}; adapter {res['adapter_s']:.2f} s; "
            f"rerank-32 p50 {lat['p50_ms']:.2f} ms, p95 {lat['p95_ms']:.2f} ms over {lat['queries']} queries; on {card}")
        assert [r["variant"] for r in res["variants"]][:4] == list(sib.VARIANTS[:4]), res["variants"]
        assert {r["variant"] for r in res["variants"]} == {*sib.VARIANTS, f"sem-multivector@{PHASE18_RERANK_QUERIES}"}
        assert set(res["insert_s"]) == {"hash", "sem_single", "sem_mv"} and res["adapter_evals"] > 0
        assert all(0.0 <= r[m] <= 1.0 for r in res["variants"] for m in ("mrr_at_10", "ndcg_at_10", "recall_at_10"))
        mark("phase 18 (a)")

        t0 = time.perf_counter()
        with _bench_cache(root / "bench-cache"):
            beir = _counted(total, lambda: sib.beir_main([
                "--docs", str(PHASE18_DOCS), "--queries", str(PHASE18_BEIR_QUERIES), *common, "--dir", str(root / "beir"),
                "--store-dir", str(root / "beir-stores"), "--variants", PHASE18_BEIR_VARIANTS]))
        beir_s = time.perf_counter() - t0
        log(f"phase 18 (b) the protocol as a BEIR directory ({PHASE18_DOCS} documents, {PHASE18_BEIR_QUERIES} queries) "
            f"through irbench in {beir_s:.1f} s: " + ", ".join(f"{r['variant']} AP@10 {r['AP@10']:.4f}" for r in beir)
            + f" on {card}")
        assert [r["variant"] for r in beir] == PHASE18_BEIR_VARIANTS.split(",") and all(0.0 <= r["AP@10"] <= 1.0 for r in beir), beir
        mark("phase 18 (b)")

        # The sweep over (a)'s store: the same documents (the same query and
        # adapter documents: PHASE18_RERANK_QUERIES + the rest = 100 + 200),
        # the first PHASE18_RERANK_QUERIES queries, so its rows compare with
        # (a)'s sem-mv+rerank and sem-multivector@PHASE18_RERANK_QUERIES.
        t0 = time.perf_counter()
        rest = PHASE18_QUERIES + PHASE18_ADAPTER_QUERIES - PHASE18_RERANK_QUERIES
        blend = _counted(total, lambda: sib.blend_main([
            "--docs", str(PHASE18_DOCS), "--queries", str(PHASE18_RERANK_QUERIES), "--adapter-queries", str(rest),
            *common, "--workdir", str(root / "ir"), "--embedder", "flax:sem", "--blends", PHASE18_BLENDS]))
        blend_s = time.perf_counter() - t0
        rerank = next(r for r in res["variants"] if r["variant"] == "sem-mv+rerank")
        log(f"phase 18 (c) reranker_blend sweep over (a)'s sem_mv store in {blend_s:.1f} s: "
            + ", ".join(f"{r['variant']} MRR@10 {r['mrr_at_10']:.4f} nDCG@10 {r['ndcg_at_10']:.4f} recall@10 "
                        f"{r['recall_at_10']:.4f}" for r in blend)
            + f" over {PHASE18_RERANK_QUERIES} queries (a check of the path, not a measure) on {card}")
        # Blend 0.0 is the reranker's order: (a)'s rerank row.
        keys = ("mrr_at_10", "ndcg_at_10", "recall_at_10", "queries")
        assert {k: blend[0][k] for k in keys} == {k: rerank[k] for k in keys}, (blend[0], rerank)
        mark("phase 18 (c)")

        small = _phase18_small(str(root / "corpus"))
        card_side = _counted(total, lambda: sib.main([*small, "--device", "cuda", "--workdir", str(root / "small-cuda")]))
        faulty = {
            fault: _counted(total, lambda fault=fault: sib.main([
                *small, "--device", "cuda", "--variants", "sem-multivector", "--workdir", str(root / f"small-{fault}"),
                "--embedder", f"flax:{faulty_encoder(root / f'encoder-{fault}', fault)}"]))
            for fault in PHASE18_FAULTS
        }
        cpu, _ = cpu_half(timeout=900)
        cpu_s = cpu["s"]
        report = {}
        for name, rtol in PHASE18_CPU_RTOL.items():
            got, want = card_side["rankings"][name], cpu["rankings"][name]
            report[name] = {"rtol": rtol, "worst": _worst_difference(got, want),
                            "mismatches": _ranking_mismatches(got, want, rtol),
                            "control": len(_ranking_mismatches(got, want[1:] + want[:1], rtol)),
                            "swaps": sum(x != y for ra, rb in zip(got, want) for (x, _), (y, _) in zip(ra, rb))}
        want, rtol = cpu["rankings"]["sem-multivector"], PHASE18_CPU_RTOL["sem-multivector"]
        report["sem-multivector"]["faults"] = {
            fault: {"worst": _worst_difference(res_f["rankings"]["sem-multivector"], want),
                    "mismatches": len(_ranking_mismatches(res_f["rankings"]["sem-multivector"], want, rtol))}
            for fault, res_f in faulty.items()
        }
        log(f"phase 18 (d) card against CPU, {card_side['docs']} documents, {card_side['variants'][0]['queries']} queries: "
            + ", ".join(f"{r['variant']} MRR@10 {r['mrr_at_10']:.4f} / {c['mrr_at_10']:.4f} (largest relative difference "
                        f"of a document's score {report[r['variant']]['worst']:.3g}, limit {report[r['variant']]['rtol']:.3g}; "
                        f"ranks where the ids differ {report[r['variant']]['swaps']}; control, the next query's ranking: "
                        f"{report[r['variant']]['control']} mismatches, must be > 0)"
                        for r, c in zip(card_side["variants"], cpu["variants"]))
            + "; the card's sem-multivector through a faulty encoder, must fail the limit: "
            + ", ".join(f"{fault} largest relative difference {f['worst']:.3g}, {f['mismatches']} mismatches"
                        for fault, f in report["sem-multivector"]["faults"].items())
            + f"; CPU half {cpu_s:.1f} s beside (a)-(c) (budget {PHASE18_CPU_BUDGET_S:.0f} s), on {card}")
        assert not any(r["mismatches"] for r in report.values()), {k: r["mismatches"][:5] for k, r in report.items()}
        assert all(r["control"] > 0 for r in report.values()), report
        assert all(f["mismatches"] > 0 for f in report["sem-multivector"]["faults"].values()), report
        assert cpu_s <= 3 * PHASE18_CPU_BUDGET_S, cpu_s
        mark("phase 18 (d)")
        out = {"corpus": summary, "variants": res["variants"], "insert_s": res["insert_s"], "adapter_s": res["adapter_s"],
               "rerank_latency": lat, "beir": beir, "blend": blend, "cpu_s": cpu_s,
               "cpu_parity": {k: {x: y for x, y in r.items() if x != "mismatches"} for k, r in report.items()},
               "seconds": time.perf_counter() - t_start}
    finally:
        stack.close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 18 done in {out['seconds']:.1f} s on {card}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=1_249_280)
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace 8 warm vector_search calls of each route, 8 hybrid_search calls, the large preset's "
        "prefill, one decode chunk and 36 decode, verify and prefill attention calls and two steps of each of "
        "phase 17's encoder phases with torch.profiler, and print the phases inside one decode, one verify and "
        "one prefill launch",
    )
    parser.add_argument(
        "--only",
        choices=["prefill", "phase10", "phase11", "phase12", "phase13", "phase14", "phase15", "phase16", "phase17", "phase18"],
        help="a partial run, printing no result line: 'prefill' builds the prefill kernel, holds it against "
        "its plain version (phase 2b's cases) and times it (phase 7's rows, at T 8,192 / S 8,352 and T 2,048 / "
        "S 2,208); 'phase10' builds every kernel, serves phase 3's store at --rows rows and runs phase 10 over it "
        "with phase 6's message; 'phase11' builds every kernel and runs phase 11 alone at --rows rows; 'phase12' builds "
        "every kernel, serves phase 3's store at --rows rows and runs phase 12 over it; 'phase13' builds every kernel and "
        "runs phase 13 alone at --rows rows; 'phase14' builds every kernel, serves phase 3's store at --rows rows, "
        "loads the large preset and runs phase 14 on phase 6's RAG prompt; 'phase15' builds every kernel, serves phase 3's "
        "store at --rows rows and runs phase 15 over it; 'phase16' builds every kernel, serves phase 3's store at --rows "
        "rows, runs phase 4b's keyword and hybrid checks over it and then phase 16; 'phase17' builds every kernel and "
        "runs phase 17 alone (the trainers); 'phase18' builds every kernel and runs phase 18 alone (the held-out IR "
        "evaluation)",
    )
    # One rank of phase 12 (d), started by phase 12 itself.
    parser.add_argument("--phase12-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--coordinator", help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "raglite_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.phase12_rank is not None:
        return phase12_rank(args.phase12_rank, args.coordinator, args.out, args.seed)

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

    if args.only == "phase10":
        import dataclasses

        from raglite_tpu_torch import add_context

        texts = [(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS]
        cfg = RAGLiteConfig(store_path=":memory:", device="cuda")
        insert_documents([Document.from_text(t) for t in texts], config=cfg)
        store = store_from_config(cfg)
        add_background(store, args.rows - sum(m.shape[0] for m in store.embeddings.values()), args.seed)
        vs_q = pick_queries(texts, 8 + 4 + 32, args.seed)[:8]  # phase 3's 8 sentences
        rag_cfg = dataclasses.replace(cfg, llm="jax:large")
        messages = [add_context(vs_q[0], rag_spans(vs_q[0], rag_cfg), rag_cfg)]
        _release_llms()
        launches10: dict[str, int] = {}
        phase10_decoder(cfg, vs_q[0], messages, args.seed, card, launches10)
        phase10_encoder(texts, vs_q, args.rows, args.seed, card, launches10)
        orbax10 = phase10_orbax(cfg, messages, None, card, launches10)
        log(f"phase 10 (f) summary on {card}: {json.dumps(orbax10)}")
        log(f"phase 10 launches {launches10}; partial run (--only phase10): no result line")
        return 0

    if args.only == "phase12":
        texts = [(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS]
        cfg = RAGLiteConfig(store_path=":memory:", device="cuda")
        insert_documents([Document.from_text(t) for t in texts], config=cfg)
        store = store_from_config(cfg)
        add_background(store, args.rows - sum(m.shape[0] for m in store.embeddings.values()), args.seed)
        vs_q = pick_queries(texts, 8 + 4 + 32, args.seed)[:8]  # phase 3's 8 sentences
        launches12: dict[str, int] = {}
        summary12 = phase12(cfg, texts, vs_q, args.seed, card, launches12)
        log(f"phase 12 summary on {card}: {json.dumps(_without_timings(summary12))}; launches {launches12}")
        log("partial run (--only phase12): no result line")
        return 0

    if args.only == "phase13":
        launches13: dict[str, int] = {}
        summary13 = phase13(args.rows, args.seed, card, launches13)
        log(f"phase 13 summary on {card}: {json.dumps({**summary13, 'launches': launches13})}")
        log("partial run (--only phase13): no result line")
        return 0

    if args.only == "phase14":
        import dataclasses

        from raglite_tpu_torch import add_context
        from raglite_tpu_torch.models.llm import llm_from_config
        from raglite_tpu_torch.rag import _clip

        texts = [(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS]
        cfg = RAGLiteConfig(store_path=":memory:", device="cuda")
        insert_documents([Document.from_text(t) for t in texts], config=cfg)
        store = store_from_config(cfg)
        add_background(store, args.rows - sum(m.shape[0] for m in store.embeddings.values()), args.seed)
        vs_q = pick_queries(texts, 8 + 4 + 32, args.seed)[:8]  # phase 3's 8 sentences
        rag_cfg = dataclasses.replace(cfg, llm="jax:large")
        llm = llm_from_config(rag_cfg)
        messages = [add_context(vs_q[0], rag_spans(vs_q[0], rag_cfg), rag_cfg)]
        launches14: dict[str, int] = {}
        summary14 = phase14(llm, llm._format_messages(_clip(messages, llm.context_size), None), card, launches14)
        log(f"phase 14 summary on {card}: {json.dumps(summary14)}")
        log("partial run (--only phase14): no result line")
        return 0

    if args.only == "phase15":
        texts = [(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS]
        cfg = RAGLiteConfig(store_path=":memory:", device="cuda")
        t0 = time.perf_counter()
        insert_documents([Document.from_text(t) for t in texts], config=cfg)
        store = store_from_config(cfg)
        add_background(store, args.rows - sum(m.shape[0] for m in store.embeddings.values()), args.seed)
        log(f"phase 3's store at {args.rows} rows in {time.perf_counter() - t0:.1f} s")
        vs_q = pick_queries(texts, 8 + 4 + 32, args.seed)[:8]  # phase 3's 8 sentences
        launches15: dict[str, int] = {}
        summary15 = phase15(cfg, texts, vs_q, args.seed, card, launches15)
        log(f"phase 15 summary on {card}: {json.dumps({**summary15, 'launches': launches15})}")
        log("partial run (--only phase15): no result line")
        return 0

    if args.only == "phase16":
        texts = [(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS]
        cfg = RAGLiteConfig(store_path=":memory:", device="cuda")
        t0 = time.perf_counter()
        insert_documents([Document.from_text(t) for t in texts], config=cfg)
        store = store_from_config(cfg)
        background = add_background(store, args.rows - sum(m.shape[0] for m in store.embeddings.values()), args.seed)
        log(f"phase 3's store at {args.rows} rows in {time.perf_counter() - t0:.1f} s")
        queries = pick_queries(texts, 8 + 4 + 32, args.seed)
        hybrid = keyword_and_hybrid(cfg, queries[:8], queries[8:12], background, args.seed, card, profile=args.profile)
        log(f"phase 4b summary on {card}: {json.dumps(hybrid)}")
        launches16: dict[str, int] = {}
        summary16 = phase16(cfg, texts, queries[:8], args.seed, card, launches16)
        log(f"phase 16 summary on {card}: {json.dumps({**summary16, 'launches': launches16})}")
        log("partial run (--only phase16): no result line")
        return 0

    if args.only == "phase17":
        launches17: dict[str, int] = {}
        summary17 = phase17(card, launches17, profile=args.profile)
        log(f"phase 17 summary on {card}: {json.dumps({**summary17, 'launches': launches17})}")
        log("partial run (--only phase17): no result line")
        return 0

    if args.only == "phase18":
        launches18: dict[str, int] = {}
        summary18 = phase18(card, launches18)
        log(f"phase 18 summary on {card}: {json.dumps({**summary18, 'launches': launches18})}")
        log("partial run (--only phase18): no result line")
        return 0

    if args.only == "phase11":
        texts = [(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS]
        launches11: dict[str, int] = {}
        summary11 = phase11(texts, args.rows // PHASE11_ROWS_DIVISOR, args.seed, card, launches11)
        log(f"phase 11 summary on {card}: {json.dumps({**summary11, 'launches': launches11})}")
        log("partial run (--only phase11): no result line")
        return 0

    mark("build")

    # 2. Kernels vs plain versions.
    errs = check_kernels(args.seed)
    # 2b. Attention kernels vs plain versions; verify rows vs decode.
    errs.update(check_attention_kernels(args.seed))

    mark("phases 2 and 2b")

    # 3. Serve, default config (int4 two-stage route).
    texts = [(ROOT / f).read_text(encoding="utf-8") for f in STORE_DOCS]
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

    mark("phase 3")

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

    mark("phase 4")

    # 4b. Keyword and hybrid search, default config.
    hybrid = keyword_and_hybrid(cfg, vs_q, rr_q, background, args.seed, card, profile=args.profile)
    log(f"phase 4b summary on {card}: {json.dumps(hybrid)}")

    mark("phase 4b")

    # 5. Timings at the served index's arrays.
    from raglite_tpu_torch.embed import embed_queries

    q_emb = embed_queries((vs_q + bench_q)[:32], config=cfg)
    timings = time_kernels(index_bf16, dense_index_from_config(cfg8), q_emb, card)
    n_queries = len(vs_q) + len(rr_q)
    launches = {"int4_bucket_scan": launches_default["int4_bucket_scan"], "bucketed_max_scan": launches_single["bucketed_max_scan"]}
    log(f"launches per query: { {k: v / n_queries for k, v in launches.items()} }")

    mark("phase 5")

    # 6. RAG answers from the `large` decoder over the phase-3 index.
    answer = serve_rag(cfg, vs_q[0], card, profile=args.profile)
    launches.update(answer["launches"])

    mark("phase 6")

    # 7. Attention kernel timings at the `large` shapes.
    timings += time_attention(args.seed, answer["rag_s"], answer["rag_pos"], answer["rag_t"], card, profile=args.profile)

    mark("phase 7")

    # 8. Structured and batched generation on the same decoder.
    structured = structured_generation(cfg, vs_q, args.seed, card)

    mark("phase 8")

    # 14. The decode programs as CUDA graphs, on phase 6's decoder and RAG
    # prompt: each step form against the module's eager function, the
    # entry points from the graphs against the eager reference.
    import dataclasses

    from raglite_tpu_torch.models.llm import llm_from_config

    phase14_launches: dict[str, int] = {}
    summary14 = phase14(llm_from_config(dataclasses.replace(cfg, llm="jax:large")), answer["prompt"], card, phase14_launches)
    log(f"phase 14 summary on {card}: {json.dumps(summary14)}")
    for name in ("gqa_decode_attention", "gqa_verify_attention", "gqa_prefill_attention"):
        assert phase14_launches.get(name, 0) > 0, (name, phase14_launches)

    mark("phase 14")

    # 9. Evals, the query adapter and async RAG over the phase-3 store and
    # the same decoder; each kernel's launches on this path counted apart.
    phase9_launches: dict[str, int] = {}
    evals = phase9_evals(cfg, args.seed, phase9_launches, card)
    adapter = phase9_adapter(cfg, vs_q, phase9_launches, card)
    judged = phase9_judge(cfg, phase9_launches, card)
    bridge = phase9_async(cfg, vs_q[0], answer["first_piece_ms"], phase9_launches, card)
    log(f"phase 9 summary on {card}: {json.dumps({**evals, **adapter, **judged, **bridge, 'launches': phase9_launches})}")
    for name in ("int4_bucket_scan", "gqa_decode_attention", "gqa_verify_attention", "gqa_prefill_attention"):
        assert phase9_launches.get(name, 0) > 0, (name, phase9_launches)

    mark("phase 9")

    # 12. Multi-GPU on the one card, over the phase-3 store and phase 6's
    # decoder (before phase 10 releases it and replaces the store): the
    # sharded index, sharded BM25, tensor-parallel `large`, two ranks.
    phase12_launches: dict[str, int] = {}
    summary12 = phase12(cfg, texts, vs_q, args.seed, card, phase12_launches, answer["messages"])
    log(f"phase 12 summary on {card}: {json.dumps(_without_timings(summary12))}; launches {phase12_launches}")
    for name in ("int4_bucket_scan", "gqa_decode_attention", "gqa_verify_attention", "gqa_prefill_attention"):
        assert phase12_launches.get(name, 0) > 0, (name, phase12_launches)

    mark("phase 12")

    # 15. The retrieval programs as CUDA graphs, over the phase-3 store
    # (before phase 10 replaces it): each held key against its eager
    # program, invalidation, threads, graph and eager side by side.
    phase15_launches: dict[str, int] = {}
    summary15 = phase15(cfg, texts, vs_q, args.seed, card, phase15_launches)
    log(f"phase 15 summary on {card}: {json.dumps({**summary15, 'launches': phase15_launches})}")
    for name in ("int4_bucket_scan", "bucketed_max_scan"):
        assert phase15_launches.get(name, 0) > 0, (name, phase15_launches)

    mark("phase 15")

    # 16. The search side's remaining programs as CUDA graphs, over the
    # phase-3 store and phase 4b's keyword index (before phase 10 replaces
    # the store): BM25, RRF, the hash: pool, the chunklet MaxSim, the
    # boundary model, the NNLS, each held key against its eager program.
    phase16_launches: dict[str, int] = {}
    summary16 = phase16(cfg, texts, vs_q, args.seed, card, phase16_launches)
    log(f"phase 16 summary on {card}: {json.dumps({**summary16, 'launches': phase16_launches})}")
    assert phase16_launches.get("int4_bucket_scan", 0) > 0, phase16_launches

    mark("phase 16")

    # 10. Real checkpoints: a Qwen3-4B-shaped hf: checkpoint (bf16 and
    # @int8) answering over the phase-3 store, a bge-m3-shaped encoder at
    # d = 1,024 in a fresh store (phase-3's replaced), ckpt: (orbax) of
    # that encoder and of phase 6's `large`.  Phase 6's `large` goes first.
    peak_before = torch.cuda.max_memory_allocated()
    _release_llms()
    log(f"phase 10: phase 6's large preset released ({torch.cuda.memory_allocated() / 1e9:.3f} GB still allocated; "
        f"peak so far {peak_before / 1e9:.3f} GB), on {card}")
    phase10_launches: dict[str, int] = {}
    decoder10 = phase10_decoder(cfg, vs_q[0], answer["messages"], args.seed, card, phase10_launches)
    mark("phase 10 (a)-(d)")
    encoder10 = phase10_encoder(texts, vs_q, PHASE10_ROWS, args.seed, card, phase10_launches)
    mark("phase 10 (e)")
    orbax10 = phase10_orbax(cfg, answer["messages"], answer["answer"], card, phase10_launches)
    summary10 = {k: v for k, v in decoder10.items() if k != "timings"}
    summary10["int8"] = {k: v for k, v in decoder10["int8"].items() if k != "matmuls"}
    summary10.update({k: v for k, v in encoder10.items() if k != "timings"})
    summary10["orbax"] = orbax10
    log(f"phase 10 summary on {card}: {json.dumps({**summary10, 'launches': phase10_launches})}")
    for name in ("int4_bucket_scan", "gqa_decode_attention", "gqa_verify_attention", "gqa_prefill_attention"):
        assert phase10_launches.get(name, 0) > 0, (name, phase10_launches)

    mark("phase 10")

    # 8 (d) and 9 (f) replace the cached ":memory:" store: they come last.
    hash_on_card(texts, vs_q, card)
    phase9_openai(texts[:2], vs_q[0], card)

    mark("phases 8 (d) and 9 (f)")

    # 11. From files to answers through the surfaces: documents of every
    # kind, learned boundaries, a persistent store on disk, a cold CLI, the
    # web chat and MCP (its own store, in a temporary directory).
    phase11_launches: dict[str, int] = {}
    summary11 = phase11(texts, args.rows // PHASE11_ROWS_DIVISOR, args.seed, card, phase11_launches)
    log(f"phase 11 summary on {card}: {json.dumps({**summary11, 'launches': phase11_launches})}")
    for name in ("int4_bucket_scan", "gqa_prefill_attention"):
        assert phase11_launches.get(name, 0) > 0, (name, phase11_launches)
    assert phase11_launches.get("gqa_decode_attention", 0) + phase11_launches.get("gqa_verify_attention", 0) > 0

    mark("phase 11")

    # 13. The IR benchmark: every variant on the card and the CPU, a
    # bge-base-shaped BERT over a store at --rows (the int4 route), the
    # HNSW baseline, and the CLI's bench (its own temporary directory).
    # (a)'s CPU half, in a process of its own, runs beside phase 13's card
    # work and phase 17's first steps, and is joined before 17 (c), whose
    # CPU steps want the host's cores.
    import shutil

    phase13_launches: dict[str, int] = {}
    cpu13_root = scratch_dir(200_000_000, "phase13_cpu_")
    try:
        with beside("phase13_synthetic", str(cpu13_root), "cpu") as cpu13:
            summary13 = phase13(args.rows, args.seed, card, phase13_launches, cpu_half=cpu13)
            assert phase13_launches.get("int4_bucket_scan", 0) > 0, phase13_launches
            mark("phase 13")

            # 17. Training on the card: the boundary trainer's recipe, the
            # encoder trainer's four phases at full width and the export
            # served, the card's losses against the CPU's (its own temporary
            # directory).
            _release_llms()
            _fresh_memory_store()
            torch.cuda.empty_cache()
            phase17_launches: dict[str, int] = {}
            summary17 = phase17(card, phase17_launches, profile=args.profile,
                                before_parity=lambda: phase13_join(summary13, cpu13, card))
    finally:
        shutil.rmtree(cpu13_root, ignore_errors=True)
    log(f"phase 13 summary on {card}: {json.dumps({**summary13, 'launches': phase13_launches})}")
    log(f"phase 17 summary on {card}: {json.dumps({**summary17, 'launches': phase17_launches})}")
    mark("phase 17")

    # 18. The held-out IR evaluation on the card: the packaged encoder's six
    # variants, the BEIR export through irbench, the blend sweep, the card's
    # rankings against the CPU's (its own temporary directory).
    _fresh_memory_store()
    phase18_launches: dict[str, int] = {}
    summary18 = phase18(card, phase18_launches)
    log(f"phase 18 summary on {card}: {json.dumps({**summary18, 'launches': phase18_launches})}")
    mark("phase 18")
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
            # graph (their "ms" reads the host's enqueue time), else null; and
            # each attention kernel at complete_batch's B = 8 shape (phase 8).
            "graph_ms": t.get("graph_ms"),
            # Launches on phase 9's path (evals, adapter, judge panels, async_rag).
            "launches_phase9": phase9_launches.get(name, 0),
            # And on phase 10's (the Qwen3-4B-shaped checkpoint's answers,
            # the bge-m3-shaped encoder's searches).
            "launches_phase10": phase10_launches.get(name, 0),
            # And on phase 11's, in this process (the store's searches, the
            # web chat's, its chat answer, the trace).
            "launches_phase11": phase11_launches.get(name, 0),
            # And on phase 12's, in this process (the sharded index's
            # searches, the TP decoder's forward, answer and stream).
            "launches_phase12": phase12_launches.get(name, 0),
            # And on phase 13's (the IR benchmark's evaluators over the
            # bge-base-shaped encoder's store).
            "launches_phase13": phase13_launches.get(name, 0),
            # And on phase 14's (the step graphs against the eager steps,
            # the entry points from the graphs and the eager reference).
            "launches_phase14": phase14_launches.get(name, 0),
            # And on phase 15's (the retrieval programs' entry points, the
            # graphs' warm-ups and replays; checking calls not counted).
            "launches_phase15": phase15_launches.get(name, 0),
            # And on phase 16's (the hybrid and keyword paths from the graphs,
            # the timed calls and the racing searches; checking calls not
            # counted).
            "launches_phase16": phase16_launches.get(name, 0),
            # And on phase 17's: 0, training runs none of these kernels,
            # and the searches over the 2-document store the export
            # embedded take the exact route (under 131,072 rows).
            "launches_phase17": phase17_launches.get(name, 0),
            # And on phase 18's: its stores hold a few thousand rows, under
            # the int4 route's 131,072, and it runs no decoder.
            "launches_phase18": phase18_launches.get(name, 0),
        })
        p12 = next((x for x in summary12["index"]["timings"] + summary12["tp"]["timings"] if x["name"] == name), None)
        if p12 is not None:
            # Phase 12's shapes: the int4 scan at one shard's rows, attention
            # at one TP shard's KV groups (KVH 1, REP 5).
            kernels[-1]["phase12"] = {k: p12[k] for k in (
                "batch", "T", "S", "KVH", "REP", "d", "N", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err",
            ) if k in p12}
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], p12["max_abs_err"])
        p10 = next((x for x in decoder10["timings"] + encoder10["timings"] if x["name"] == name), None)
        if p10 is not None:
            # Phase 10's shapes: attention at Qwen3-4B's KVH 8, REP 4 (the
            # answer's T and S), the int4 scan at d = 1,024.
            kernels[-1]["phase10"] = {k: p10[k] for k in (
                "batch", "T", "S", "KVH", "REP", "d", "N", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err",
            ) if k in p10}
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], *(
                x["max_abs_err"] for x in decoder10["timings"] + encoder10["timings"] if x["name"] == name
            ))
        b8 = next((x for x in structured["timings"] if x["name"] == name), None)
        if b8 is not None:
            kernels[-1]["batch8"] = {
                "launches": structured["launches"][name], "T": b8["T"], "S": b8["S"], "ms": b8["ms"],
                "graph_ms": b8.get("graph_ms"), "plain_ms": b8["plain_ms"], "bound_ms": b8["bound_ms"],
                "bound_by": b8["bound_by"], "library_ms": b8["library_ms"], "max_abs_err": b8["max_abs_err"],
            }
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], b8["max_abs_err"])
    log(f"kernels: {json.dumps([k['name'] for k in kernels])} (scans at B=1, N={index_bf16.capacity}, "
        f"d={D}; decode and verify at S={answer['rag_s']}, prefill at T={answer['rag_t']}, S={answer['rag_s']})")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
