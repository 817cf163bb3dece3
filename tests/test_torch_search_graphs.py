"""The search side's remaining one-dispatch programs, which the port replays
from CUDA graphs on the card (utils/graphs.py: ``ProgramGraphs``), run
eagerly on the CPU as the card's first call runs them: resident BM25 and
host-gather BM25 (index/keyword.py), device RRF (search.py), the ``hash:``
pool (models/encoder.py), the chunklet MaxSim (ops/maxsim.py), the boundary
model's block forward (models/boundary.py) and the adapter's NNLS
(query_adapter.py).

Each program is held to its JAX counterpart on the same numpy inputs, made
from a seed: BM25 ids equal and scores within rtol 1e-5
(tests/test_torch_keyword.py's tolerance); RRF ordinals equal and scores
within 1e-7 (tests/test_torch_hybrid.py's); the ``hash:`` pool within 1e-6
(tests/test_torch_hash.py's); MaxSim scores within rtol 1e-5
(tests/test_torch_retrieval_graphs.py's); boundary probabilities within
1e-6 (tests/test_torch_boundary.py's); NNLS targets within 1e-4
(tests/test_torch_query_adapter.py's).  The slice end to end (a ``hash:128``
store's keyword, hybrid and chunklet-reranked searches) gives the JAX
package's ids.

The graph path's bookkeeping runs through a test double for the capture (a
"graph" that re-runs the program on its static buffers, as a replay re-runs
the captured kernels): the keyword index's generation, a sync that waits for
a search in flight, the BM25 size rule, and threads through
``hybrid_search``.  No program makes a host read or an upload from the
host: each runs under a dispatch mode that raises on the ops that do.
"""

import contextlib
import functools
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raglite_tpu.models.boundary as jb
import raglite_tpu.models.encoder as jenc
import raglite_tpu.ops.bm25 as jbm25
import raglite_tpu_torch.models.boundary as tb
import raglite_tpu_torch.models.encoder as tenc
import raglite_tpu_torch.ops.bm25 as tbm25
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import search as jsearch
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.index.keyword import KeywordIndex as JKeywordIndex
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu.ops.maxsim import maxsim_rank as j_maxsim_rank
from raglite_tpu.ops.nnls import batched_query_targets as j_targets
from raglite_tpu.ops.rrf import rrf_fuse_topk as j_rrf
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import search as tsearch
from raglite_tpu_torch.documents import Chunk as TChunk
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.index.dense import dense_index_from_config
from raglite_tpu_torch.index.keyword import GRAPH_SORT_ENTRIES, keyword_index_from_config
from raglite_tpu_torch.index.keyword import KeywordIndex as TKeywordIndex
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.ops.maxsim import maxsim_rank as t_maxsim_rank
from raglite_tpu_torch.ops.maxsim import maxsim_scores
from raglite_tpu_torch.ops.nnls import query_targets_from_rows
from raglite_tpu_torch.query_adapter import _nnls_targets
from raglite_tpu_torch.store import Store as TStore
from raglite_tpu_torch.utils import graphs
from raglite_tpu_torch.utils.padding import bucket
from tests.test_torch_keyword import _corpus
from tests.test_torch_retrieval_graphs import _NoHostOps, fake_capture  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
@contextlib.contextmanager
def _capturing(*programs):
    """The given ProgramGraphs objects on the graph path (with the double),
    cleared on the way out."""
    for p in programs:
        p.captures = True
    try:
        yield
    finally:
        for p in programs:
            p.captures = False
            p.clear()


def _equal(a, b) -> None:
    for x, y in zip(graphs._as_tuple(a), graphs._as_tuple(b), strict=True):
        assert torch.equal(x, y)


# --- Each program against its JAX counterpart ---------------------------------


@pytest.fixture(scope="module")
def jax_resident():
    """The JAX index's resident arrays over corpus 2, as the port's program
    reads them."""
    bodies, _ = _corpus(seed=2)
    jindex = JKeywordIndex()
    for i, body in enumerate(bodies):
        jindex._add_chunk(f"c{i}", body)
    res = jindex._ensure_resident()
    port = {
        "offsets": torch.as_tensor(np.array(res["offsets"]), dtype=torch.int64),
        "chunk": torch.as_tensor(np.array(res["chunk"])), "w": torch.as_tensor(np.array(res["w"])),
        "dummy_mask": torch.zeros((1,), dtype=torch.bool), "n_pad": res["n_pad"],
    }
    return res, port


@pytest.mark.parametrize("t,lcap", [(4, 128), (16, 256)])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_resident_bm25_program_matches_jax(jax_resident, fake_capture, masked: bool, t: int, lcap: int) -> None:
    """``KeywordIndex._resident_program`` through a key's capture and its
    replay = ``bm25_topk_resident`` (winners re-sorted by (score desc,
    ordinal asc) as the JAX host does): ids equal, scores rtol 1e-5."""
    res, port = jax_resident
    n_pad = res["n_pad"]
    assert lcap <= res["slice_pad"]  # the arrays' padding covers the slices
    rng = np.random.default_rng(t + lcap + masked)
    mask = rng.random(n_pad) < 0.5
    term_ids = rng.integers(0, len(res["df_host"]), size=(9, t)).astype(np.int32)
    term_ids[::2, t // 2 :] = -1
    packed = np.asarray(jbm25.bm25_topk_resident(
        res["offsets"], res["chunk"], res["w"], jnp.asarray(mask), jnp.asarray(term_ids),
        num_chunks=n_pad, lcap=lcap, num_hits=25, masked=masked,
    ))
    j_scores, j_ords = packed[0], np.ascontiguousarray(packed[1]).view(np.int32)
    programs = graphs.ProgramGraphs("cpu")
    program = TKeywordIndex._resident_program(port, lcap=lcap, num_hits=25, masked=masked)
    inputs = (term_ids, torch.from_numpy(mask)) if masked else (term_ids,)
    key = ("bm25", 9, t, lcap, 25, masked, n_pad, 0)
    with _capturing(programs):
        got = [programs(key, program, *inputs) for _ in range(2)]
        assert programs.counts["captured"] == 1 and programs.counts["replayed"] == 1
    _equal(got[0], got[1])
    t_scores, t_ords = (x.numpy() for x in got[1])
    for b in range(9):
        order = np.lexsort((j_ords[b], -j_scores[b]))
        keep = j_scores[b][order] > 0
        pos = t_scores[b] > 0
        np.testing.assert_array_equal(t_ords[b][pos], j_ords[b][order][keep])
        np.testing.assert_allclose(t_scores[b][pos], j_scores[b][order][keep], rtol=RTOL)
        assert (t_ords[b][~pos] == n_pad).all()


def _gathered(rng, *, batch: int, num_chunks: int, terms: list[int]):
    """Host-gathered postings of ``batch`` queries, query q with ``terms[q]``
    unique terms of random df (one posting a term and chunk), padded to a
    power of two from 512 with chunk ``num_chunks`` (the index's padding)."""
    chunk, query, tf, idf = [], [], [], []
    for q in range(batch):
        for _ in range(terms[q]):
            df = int(rng.integers(1, 90))
            chunk.append(rng.choice(num_chunks, size=df, replace=False))
            query.append(np.full(df, q))
            tf.append(rng.integers(1, 6, size=df))
            idf.append(np.full(df, rng.uniform(0.1, 6.0)))
    chunk, query, tf, idf = (np.concatenate(x) for x in (chunk, query, tf, idf))
    pad = bucket(chunk.size, 512) - chunk.size
    return (
        np.pad(chunk, (0, pad), constant_values=num_chunks).astype(np.int32),
        np.pad(query, (0, pad)).astype(np.int32),
        np.pad(tf, (0, pad)).astype(np.float32),
        np.pad(idf, (0, pad)).astype(np.float32),
    )


@pytest.mark.parametrize("p_bucket", [1024, 8192])
def test_host_gather_bm25_program_matches_jax(fake_capture, p_bucket: int) -> None:
    """The fixed-shape ``bm25_topk_batch`` at two P buckets, with ``max_run``
    the bucket of the most terms a query has (query 0: 40 terms, more than
    any chunk matches) through a key's capture and replay = the JAX program:
    ids equal, scores rtol 1e-5; and bit-equal to ``max_run=None`` (P
    steps: the extra shift-adds add exact zeros)."""
    rng = np.random.default_rng(p_bucket)
    num_chunks, batch = 300 if p_bucket == 1024 else 2000, 6
    terms = [40 if p_bucket == 8192 else 14, 1, 3, 4, 2, 5]
    while True:
        arrays = _gathered(rng, batch=batch, num_chunks=num_chunks, terms=terms)
        if arrays[0].size == p_bucket:
            break
        terms = [max(1, t + (1 if arrays[0].size < p_bucket else -1)) for t in terms]
    len_norm = rng.uniform(0.3, 2.5, size=num_chunks).astype(np.float32)
    max_run = bucket(max(terms), 1)
    j_s, j_o = (np.asarray(x) for x in jbm25.bm25_topk_batch(
        *(jnp.asarray(x) for x in (*arrays, len_norm)), num_chunks=num_chunks, batch=batch, num_hits=30,
    ))
    programs = graphs.ProgramGraphs("cpu")
    program = functools.partial(tbm25.bm25_topk_batch, num_chunks=num_chunks, batch=batch, num_hits=30, max_run=max_run)
    key = ("bm25_gather", p_bucket, batch, 30, max_run, num_chunks, 0)
    with _capturing(programs):
        got = [programs(key, program, *arrays, len_norm) for _ in range(2)]
    _equal(got[0], got[1])
    _equal(got[1], tbm25.bm25_topk_batch(
        *(torch.from_numpy(x) for x in (*arrays, len_norm)), num_chunks=num_chunks, batch=batch, num_hits=30,
    ))
    t_s, t_o = (x.numpy() for x in got[1])
    assert (j_s > 0).sum() > 100
    for b in range(batch):
        pos = j_s[b] > 0
        np.testing.assert_array_equal(t_o[b][pos], j_o[b][pos])
        np.testing.assert_allclose(t_s[b][pos], j_s[b][pos], rtol=RTOL)
        assert (t_o[b][~pos] == num_chunks).all() and (t_s[b][~pos] == 0).all()


def test_rrf_program_matches_jax(fake_capture) -> None:
    """``search._rrf_program`` from the device's shared ProgramGraphs
    (capture, then a replay on other inputs of the key's shape) = the JAX
    ``rrf_fuse_topk``: ordinals equal, scores within 1e-7."""
    rng = np.random.default_rng(3)
    n, b, k1, k2 = 500, 5, 12, 10
    programs = graphs.ProgramGraphs("cpu")
    key = ("rrf", b, k1, k2, 8, 0.75, 0.25, n)
    program = functools.partial(tsearch._rrf_program, num_chunks=n, num_results=8, w_dense=0.75, w_kw=0.25)
    with _capturing(programs):
        for _ in range(2):
            d_scores = np.sort(rng.normal(size=(b, k1)).astype(np.float32), axis=1)[:, ::-1].copy()
            d_ords = np.stack([rng.choice(n, size=k1, replace=False) for _ in range(b)]).astype(np.int64)
            d_scores[0, 7:], d_ords[0, 7:] = -np.inf, -1
            k_scores = rng.uniform(0.1, 5.0, size=(b, k2)).astype(np.float32)
            k_ords = np.stack([rng.choice(n, size=k2, replace=False) for _ in range(b)]).astype(np.int64)
            k_ords[:, :3] = d_ords[:, :3]
            k_scores[1, 4:], k_ords[1, 4:] = 0.0, n
            t_scores, t_ords = (x.numpy() for x in programs(key, program, d_scores, d_ords, k_scores, k_ords))
            packed = np.asarray(j_rrf(
                jnp.stack([jnp.asarray(d_scores), jnp.asarray(d_ords, jnp.float32)]),
                jnp.stack([jnp.asarray(k_scores), jax.lax.bitcast_convert_type(jnp.asarray(k_ords, jnp.int32), jnp.float32)]),
                num_chunks=n, num_results=8,
            ))
            np.testing.assert_array_equal(t_ords, np.ascontiguousarray(packed[1]).view(np.int32))
            np.testing.assert_allclose(t_scores, packed[0], rtol=0, atol=1e-7)
        assert programs.counts == {"captured": 1, "replayed": 1, "kept_eager": 0, "evicted": 0}


HASH_TEXT = (
    "A token, tokens; a verylongtokenwithmanytrigramsandmoreofthemstill and x y z. "
    "Ünïcode wörds 漢字 and punctuation! "
) * 9


@pytest.mark.parametrize("vocab_bits", [10, 12])
def test_hash_pool_program_matches_jax(fake_capture, vocab_bits: int) -> None:
    """The ``hash:`` pool's fixed-shape program (its key's capture and
    replay) = the JAX package's ``_hash_pool`` on the same table, features
    and buckets, within 1e-6; with the bf16 table the card keeps, its f64
    plain version within 1e-6."""
    t_enc = tenc.HashEncoder(dim=64, vocab_bits=vocab_bits, device="cpu")
    ids, signs, bounds, n = t_enc._featurize(HASH_TEXT)
    inputs, width = tenc._hash_pool_inputs(ids, signs, bounds)
    assert width == 64 and inputs[0].size == bucket(ids.size) and inputs[3].size == bucket(n)
    f_pad, t_pad = inputs[0].size, inputs[3].size
    segments = np.pad(np.repeat(np.arange(n, dtype=np.int32), np.diff(bounds)), (0, f_pad - ids.size), constant_values=t_pad)
    want = np.asarray(jenc._hash_pool(
        jnp.asarray(t_enc._table_np), jnp.asarray(np.pad(ids, (0, f_pad - ids.size))),
        jnp.asarray(np.pad(signs, (0, f_pad - ids.size))), jnp.asarray(segments), num_segments=t_pad + 1,
    ))[:n]
    key = ("hash", f_pad, t_pad, width)
    with _capturing(t_enc.programs):
        got = [t_enc.programs(key, functools.partial(tenc._hash_pool_program, t_enc._table, width=width), *inputs) for _ in range(2)]
    _equal(got[0], got[1])
    np.testing.assert_allclose(got[1][:n].numpy(), want, atol=1e-6, rtol=0)
    assert (got[1][n:] == 0).all()
    table16 = t_enc._table.to(torch.bfloat16)
    np.testing.assert_allclose(
        tenc._hash_pool(table16, ids, signs, bounds).numpy(),
        tenc.hash_pool_plain(table16.float().numpy(), ids, signs, bounds), atol=1e-6, rtol=0,
    )


def test_chunklet_maxsim_matches_jax(fake_capture) -> None:
    """``maxsim_rank`` from its key ("chunklet", qm, C, m, d) in the shared
    ProgramGraphs (captured, then replayed) = the JAX ``maxsim_rank``:
    order equal, scores rtol 1e-5."""
    rng = np.random.default_rng(12)
    programs = graphs.shared_programs("cpu")
    before = programs.counts["replayed"]
    with _capturing(programs):
        for _ in range(2):
            query = rng.normal(size=(5, 48)).astype(np.float32)
            cands = [rng.normal(size=(int(rng.integers(1, 14)), 48)).astype(np.float32) for _ in range(11)]
            order, scores = t_maxsim_rank(query, cands, device="cpu")
            j_order, j_scores = j_maxsim_rank(query, cands)
            np.testing.assert_array_equal(order, j_order)
            np.testing.assert_allclose(scores, j_scores, rtol=RTOL, atol=1e-6)
        assert programs.counts["replayed"] > before and any(k[0] == "chunklet" for k in programs._entries)


def test_boundary_forward_matches_jax(fake_capture) -> None:
    """A document of 513 characters (just over the 512 bucket): one block
    padded to 1,024 rows, from the key's capture and its replay, equal to
    ``_apply`` within 1e-6 and to the JAX model's bucketed call."""
    model = tb.BoundaryModel.load(device="cpu")
    rng = np.random.default_rng(4)
    words = ["The", "cat", "sat.", "Dr.", "Smith", "arrived", "early!", "Why?", "yes", "—", "数据", "显示。"]
    doc = ""
    while len(doc) < 513:
        doc += str(rng.choice(words)) + " "
    doc = doc[:513]
    want = np.asarray(jb._apply(jb.default_model().params, jb.windows_for(jb.char_class_ids(doc))), np.float64)
    with _capturing(model.programs):
        got = [model(doc) for _ in range(2)]
        assert list(model.programs._entries) == [("boundary", 1024)] and model.programs.counts["replayed"] == 1
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[1], want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1], jb.default_model()(doc), atol=1e-6, rtol=0)


def test_nnls_program_matches_jax(fake_capture) -> None:
    """``_nnls_targets`` (its key's capture, then a replay on new inputs) =
    the JAX ``batched_query_targets`` within 1e-4, masks from zero rows."""
    programs = graphs.shared_programs("cpu")
    before = dict(programs.counts)
    with _capturing(programs):
        for seed in (0, 1):
            rng = np.random.default_rng(seed)
            qs = rng.normal(size=(3, 32)).astype(np.float32)
            qs /= np.linalg.norm(qs, axis=1, keepdims=True)
            pos = (rng.normal(size=(3, 5, 32)) / np.sqrt(32)).astype(np.float32)
            neg = (rng.normal(size=(3, 6, 32)) / np.sqrt(32)).astype(np.float32)
            pos[1, 3:], neg[2, 4:] = 0.0, 0.0
            got = _nnls_targets("cpu", qs, pos, neg, alpha=0.05).numpy()
            want = np.asarray(j_targets(*(jnp.asarray(x) for x in (
                qs, pos, neg, np.any(pos != 0, axis=-1), np.any(neg != 0, axis=-1)
            )), alpha=0.05))
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
            assert float(np.abs(got - qs).max()) > 1e-3
        assert programs.counts["captured"] == before["captured"] + 1
        assert programs.counts["replayed"] == before["replayed"] + 1


# --- No host read inside a program ---------------------------------------------


def _programs(jax_resident) -> dict:
    """Each program with inputs of its shape, as device tensors."""
    _, port = jax_resident
    rng = np.random.default_rng(5)
    term_ids = torch.from_numpy(rng.integers(-1, 200, size=(3, 8)).astype(np.int32))
    mask = torch.from_numpy(rng.random(port["n_pad"]) < 0.5)
    arrays = _gathered(rng, batch=3, num_chunks=400, terms=[5, 2, 3])
    gather = [torch.from_numpy(x) for x in (*arrays, rng.uniform(0.3, 2.5, size=400).astype(np.float32))]
    d = (torch.randn(2, 12).sort(dim=1, descending=True)[0], torch.randint(0, 300, (2, 12)))
    k = (torch.rand(2, 10), torch.randint(0, 300, (2, 10)))
    t_enc = tenc.HashEncoder(dim=64, vocab_bits=10, device="cpu")
    inputs, width = tenc._hash_pool_inputs(*t_enc._featurize(HASH_TEXT)[:3])
    model = tb.BoundaryModel.load(device="cpu")
    windows = torch.from_numpy(tb.windows_for(tb.char_class_ids("Dr. Smith arrived. " * 30)))
    return {
        "bm25": (TKeywordIndex._resident_program(port, lcap=256, num_hits=20, masked=False), term_ids),
        "bm25_masked": (TKeywordIndex._resident_program(port, lcap=256, num_hits=20, masked=True), term_ids, mask),
        "bm25_gather": (functools.partial(tbm25.bm25_topk_batch, num_chunks=400, batch=3, num_hits=20, max_run=8), *gather),
        "rrf": (functools.partial(tsearch._rrf_program, num_chunks=300, num_results=8, w_dense=0.75, w_kw=0.25), *d, *k),
        "hash": (functools.partial(tenc._hash_pool_program, t_enc._table, width=width), *(torch.from_numpy(x) for x in inputs)),
        "chunklet": (maxsim_scores, torch.randn(8, 32), torch.randn(16, 8, 32)),
        "boundary": (model.forward, windows),
        "nnls": (functools.partial(query_targets_from_rows, alpha=0.05, iters=20), torch.randn(2, 16), torch.randn(2, 3, 16), torch.randn(2, 4, 16)),
    }


@pytest.mark.parametrize("name", ["bm25", "bm25_masked", "bm25_gather", "rrf", "hash", "chunklet", "boundary", "nnls"])
def test_programs_make_no_host_read(jax_resident, name: str) -> None:
    """Each program, the region a graph captures, runs under a dispatch
    mode that raises on host reads and uploads."""
    program, *inputs = _programs(jax_resident)[name]
    with _NoHostOps(), torch.inference_mode():
        out = program(*inputs)
    assert all(torch.isfinite(t).any() for t in graphs._as_tuple(out))


# --- The keyword index's keys, generations, lock and size rule ------------------


def _store(bodies: list[str]) -> TStore:
    store = TStore(":memory:")
    _add(store, bodies, 0)
    return store


def _add(store: TStore, bodies: list[str], first: int) -> None:
    doc = TDocument.from_text(f"doc {first}", id=f"d{first}")
    store.add_document(doc)
    chunks = [
        TChunk(id=f"c{first + i}", document_id=doc.id, index=i, headings="", body=body) for i, body in enumerate(bodies)
    ]
    store.add_chunks(chunks, [np.zeros((1, 4), np.float32)] * len(chunks))


def test_keyword_generation_keys(fake_capture) -> None:
    """The generation bumps (and the graphs go) on an insert, a delete
    that refreshes the weights, and a rebuild; keys carry it; every graph
    result equals the eager one."""
    bodies, queries = _corpus(seed=0, n_chunks=300)
    store = _store(bodies[:200])
    index = TKeywordIndex(device="cpu")
    index.programs.captures = True

    def search():
        index.sync(store)
        got = index.search_batch(queries[:5], num_hits=10)
        with graphs.eager_programs():
            assert index.search_batch(queries[:5], num_hits=10) == got
        assert index.last_route == "resident"
        return got

    first = search()
    gen = index.generation
    assert [k[-1] for k in index.programs._entries] == [gen] and index.programs.counts["captured"] == 1
    assert search() == first and index.programs.counts["replayed"] >= 1 and index.generation == gen
    _add(store, bodies[200:], 200)  # an insert
    search()
    assert index.generation > gen and all(k[-1] == index.generation for k in index.programs._entries)
    gen = index.generation
    store.delete_documents(["d200"])  # a delete: the weights refresh
    results = search()
    assert index.generation > gen and not {f"c{i}" for i in range(200, 300)} & {c for ids, _ in results for c in ids}
    gen = index.generation
    index.rebuild(store)  # a rebuild
    assert index.generation > gen and len(index.programs) == 0
    search()


def test_keyword_sync_waits_for_a_search_in_flight(fake_capture, monkeypatch) -> None:
    """A sync that arrives while a search builds its resident program (here:
    between the program's build and its capture) waits for the search: the
    key holds the generation the program read, the sync's bump then drops
    that graph, and the next search sees the new chunks."""
    bodies, queries = _corpus(seed=1, n_chunks=300)
    store = _store(bodies[:150])
    index = TKeywordIndex(device="cpu")
    index.programs.captures = True
    index.sync(store)
    with graphs.eager_programs():
        before = index.search_batch(queries, num_hits=10)
    build = TKeywordIndex._resident_program
    syncer = threading.Thread(target=index.sync, args=(store,))
    seen: dict = {}

    def resident_program(res, **kw):
        program = build(res, **kw)
        seen["generation"] = index.generation
        _add(store, bodies[150:], 150)
        syncer.start()
        syncer.join(timeout=0.5)
        seen["waited"] = syncer.is_alive()
        return program

    monkeypatch.setattr(index, "_resident_program", resident_program)
    got = index.search_batch(queries, num_hits=10)
    syncer.join(timeout=60)
    assert seen["waited"] and not syncer.is_alive()
    assert got == before and index.generation > seen["generation"] and len(index.programs) == 0
    monkeypatch.setattr(index, "_resident_program", build)
    after = index.search_batch(queries, num_hits=10)
    with graphs.eager_programs():
        assert index.search_batch(queries, num_hits=10) == after
    assert after != before and len(index.chunk_ids) == 300


def test_bm25_size_rule() -> None:
    """Resident keys stay eager past GRAPH_SORT_ENTRIES sort entries; the
    other families are always captured."""
    captured = TKeywordIndex._captured
    assert captured(("bm25", 256, 4, 8192, 20, False, 4096, 0))  # 8.4 M entries: the limit
    assert 256 * 4 * 8192 == GRAPH_SORT_ENTRIES
    assert not captured(("bm25", 256, 32, 8192, 20, False, 4096, 0))  # 67 M
    assert not captured(("bm25", 256, 8, 8192, 20, True, 4096, 0))
    assert captured(("bm25", 1, 32, 8192, 20, True, 4096, 0))
    assert captured(("bm25_gather", 1 << 22, 256, 20, 32, 10**6, 0))


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_host_gather_equals_resident(fake_capture, seed: int, masked: bool) -> None:
    """On tests/test_torch_keyword.py's corpora, the fixed-shape host-gather
    route from its graphs gives the resident route's ids and scores bit for
    bit (both sum each chunk's weights in the same tree)."""
    bodies, queries = _corpus(seed=seed)
    index = TKeywordIndex(device="cpu")
    for i, body in enumerate(bodies):
        index._add_chunk(f"c{i}", body)
    mask = (np.arange(len(bodies)) % 3 != 0) if masked else None
    with _capturing(index.programs):
        resident = index.search_batch(queries, num_hits=20, chunk_mask=mask)
        index.use_resident = False
        for _ in range(2):
            assert index.search_batch(queries, num_hits=20, chunk_mask=mask) == resident
            assert index.last_route == "host_gather"
        assert {k[0] for k in index.programs._entries} == {"bm25", "bm25_gather"}
    assert sum(len(ids) for ids, _ in resident) > 10 * len(queries)


# --- The slice end to end ---------------------------------------------------------

DOCS = {"MIGRATION.md": "migration", "BASELINE.md": "baseline"}
QUERIES = (
    "Which public symbols of the reference have equivalents?",
    "What does the baseline measure?",
    "How is the query adapter applied?",
    "keyword search with BM25 and reciprocal rank fusion",
)


@pytest.fixture(scope="module")
def configs(tmp_path_factory: pytest.TempPathFactory):
    """A JAX and a port store of DOCS with ``hash:128`` and the chunklet
    reranker."""
    root = tmp_path_factory.mktemp("search_graphs")
    jcfg = JConfig(store_path=str(root / "jax"), embedder="hash:128", reranker="maxsim_chunklet")
    tcfg = TConfig(store_path=str(root / "torch"), embedder="hash:128", reranker="maxsim_chunklet", device="cpu")
    texts = {f: (ROOT / f).read_text(encoding="utf-8") for f in DOCS}
    jinsert([JDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=jcfg)
    tinsert([TDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=tcfg)
    return jcfg, tcfg


def _owners(tcfg) -> list:
    return [keyword_index_from_config(tcfg).programs, dense_index_from_config(tcfg).programs, graphs.shared_programs("cpu")]


def test_slice_from_graphs_matches_eager_and_jax(configs, fake_capture) -> None:
    """hybrid_search (resident BM25, device RRF), keyword_search (resident
    and, for a 40-term query, host gather) and the chunklet rerank through
    the graph path equal the eager programs exactly and the JAX package's
    ids (BM25 scores rtol 1e-5, fused scores 1e-6)."""
    jcfg, tcfg = configs
    words = (ROOT / "BASELINE.md").read_text(encoding="utf-8").lower().split()
    wide = " ".join(list(dict.fromkeys(w for w in words if w.isalpha()))[:40])  # over RESIDENT_MAX_TERMS
    with _capturing(*_owners(tcfg)):
        for query in (*QUERIES, wide):
            for t_fn, j_fn, rtol in ((tsearch.hybrid_search, jsearch.hybrid_search, 1e-6),
                                     (tsearch.keyword_search, jsearch.keyword_search, RTOL)):
                got = t_fn(query, num_results=6, config=tcfg)
                with graphs.eager_programs():
                    assert t_fn(query, num_results=6, config=tcfg) == got
                want = j_fn(query, num_results=6, config=jcfg)
                assert got[0] == want[0], (t_fn.__name__, query)
                np.testing.assert_allclose(got[1], want[1], rtol=rtol)
        assert keyword_index_from_config(tcfg).last_route == "host_gather"
        chunks = tsearch.retrieve_chunks(tsearch.hybrid_search(QUERIES[0], num_results=8, config=tcfg)[0], config=tcfg)
        reranked = [c.id for c in tsearch.rerank_chunks(QUERIES[0], chunks, config=tcfg)]
        with graphs.eager_programs():
            assert [c.id for c in tsearch.rerank_chunks(QUERIES[0], chunks, config=tcfg)] == reranked
        j_chunks = jsearch.retrieve_chunks([c.id for c in chunks], config=jcfg)
        assert reranked == [c.id for c in jsearch.rerank_chunks(QUERIES[0], j_chunks, config=jcfg)]
        kinds = {k[0] for p in _owners(tcfg) for k in p._entries}
        assert {"bm25", "bm25_gather", "rrf", "chunklet"} <= kinds
        assert all(p.counts["replayed"] > 0 for p in _owners(tcfg))


def test_hybrid_threads_equal_sequential(configs, fake_capture) -> None:
    """Eight threads through hybrid_search at once (one program lock, the
    indexes' sync locks) give the calls made one after the other."""
    _, tcfg = configs
    calls = list(QUERIES) * 2
    with _capturing(*_owners(tcfg)):
        want = [tsearch.hybrid_search(q, num_results=6, config=tcfg) for q in calls]
        got: dict[int, tuple] = {}

        def run(i: int) -> None:
            got[i] = tsearch.hybrid_search(calls[i], num_results=6, config=tcfg)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert [got[i] for i in range(len(calls))] == want
