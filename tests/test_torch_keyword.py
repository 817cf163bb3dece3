"""The port's keyword side against the JAX package's, on the CPU: the native
postings builder, the C++ sentence and chunklet DPs, the BM25 ops and
``KeywordIndex``.

Inputs are the repo's own Markdown files and seeded numpy corpora.  The
port's ops run their torch code on CPU tensors; the JAX package runs its
XLA programs on the CPU (where its ``approx_max_k`` is exact).  Tolerances:
ids equal, BM25 scores within rtol 1e-5 (f32 sums of the same weights, in
another association on the JAX side).
"""

import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raglite_tpu.native as jnative
import raglite_tpu.ops.bm25 as jbm25
import raglite_tpu_torch.native as tnative
import raglite_tpu_torch.ops.bm25 as tbm25
from raglite_tpu.documents import Chunk as JChunk
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.index.keyword import KeywordIndex as JKeywordIndex
from raglite_tpu.store import Store as JStore
from raglite_tpu_torch import chunklets as tchunklets
from raglite_tpu_torch import sentences as tsentences
from raglite_tpu_torch.documents import Chunk as TChunk
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.index import keyword as tkeyword
from raglite_tpu_torch.index.keyword import KeywordIndex as TKeywordIndex
from raglite_tpu_torch.store import Store as TStore

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5


def _md_paragraphs() -> list[str]:
    out = []
    for path in sorted(ROOT.glob("*.md")):
        out.extend(p for p in path.read_text(encoding="utf-8").split("\n\n") if p.strip())
    return out


# --- Native postings builder and DPs ----------------------------------------


def test_native_postings_export_matches_jax() -> None:
    """The port's C++ builder (its own copy of postings.cpp, its own ctypes
    loader and build) exports the same CSR postings, lengths and dictionary
    as the JAX package's, and tokenizes queries to the same term ids."""
    assert tnative.native_available() and jnative.native_available()
    paragraphs = _md_paragraphs()
    assert len(paragraphs) > 200
    tb, jb = tnative.NativePostingsBuilder(), jnative.NativePostingsBuilder()
    for text in paragraphs:
        assert tb.add_chunk(text) == jb.add_chunk(text)
    te, je = tb.export(), jb.export()
    assert te["terms"] == je["terms"] and len(te["terms"]) > 3000
    for key in ("offsets", "chunks", "tf", "doc_len"):
        np.testing.assert_array_equal(te[key], je[key], err_msg=key)
    for query in ["How does the int4 scan work?", "Ünïcödé ΑΒΓ query", "BM25 and RRF fusion", ""]:
        np.testing.assert_array_equal(tb.tokenize_lookup(query), jb.tokenize_lookup(query))
        assert tb.lookup(query.split()[0] if query else "x") == jb.lookup(query.split()[0] if query else "x")
    # The binary blob round-trips and equals the JAX package's.
    blob = tb.save()
    assert blob == jb.save()
    again = tnative.NativePostingsBuilder.loads(blob).export()
    np.testing.assert_array_equal(again["offsets"], te["offsets"])
    assert [tnative.count_tokens(p) for p in paragraphs[:50]] == [jnative.count_tokens(p) for p in paragraphs[:50]]


def test_native_boundary_dp_matches_python_fuzz(monkeypatch: pytest.MonkeyPatch) -> None:
    """The port's C++ sentence-boundary DP equals its Python DP over
    randomized inputs (300 cases; sentences.py:_solve_boundaries)."""
    assert tnative.native_available()
    rng = np.random.default_rng(3)
    cases = []
    for _ in range(300):
        n = int(rng.integers(1, 200))
        probas = rng.uniform(0, 1, n).astype(np.float32)
        min_len = int(rng.integers(1, 8))
        max_len = None if rng.random() < 0.4 else int(rng.integers(min_len, 4 * min_len + 20))
        cases.append((probas, min_len, max_len))
    native = [tsentences._solve_boundaries(p, min_len=a, max_len=b) for p, a, b in cases]
    monkeypatch.setattr(tnative, "solve_boundaries", lambda *a, **k: False)
    python = [tsentences._solve_boundaries(p, min_len=a, max_len=b) for p, a, b in cases]
    assert native == python
    assert sum(x is None for x in python) > 0 and sum(bool(x) for x in python) > 100


def test_native_chunklet_dp_matches_python_fuzz(monkeypatch: pytest.MonkeyPatch) -> None:
    """The port's C++ chunklet DP equals its Python DP over randomized
    inputs (chunklets.py:split_chunklets default-cost path)."""
    assert tnative.native_available()
    rng = np.random.default_rng(5)
    words = ["alpha", "beta", "gamma", "delta", "waves", "light", "clock", "frame"]
    cases = []
    for _ in range(120):
        sentences = []
        for _ in range(int(rng.integers(1, 60))):
            k = int(rng.integers(1, 14))
            prefix = "# " if rng.random() < 0.15 else ("- " if rng.random() < 0.1 else "")
            sentences.append(prefix + " ".join(rng.choice(words, k)) + (".\n" if rng.random() < 0.5 else ". "))
        cases.append((sentences, int(rng.integers(30, 400))))
    native = [tchunklets.split_chunklets(s, max_size=m) for s, m in cases]
    monkeypatch.setattr(tnative, "split_chunklet_cuts", lambda *a, **k: None)
    python = [tchunklets.split_chunklets(s, max_size=m) for s, m in cases]
    assert native == python


def test_python_postings_fallback_is_logged(monkeypatch: pytest.MonkeyPatch, caplog: pytest.LogCaptureFixture) -> None:
    """Without the native library the index builds its postings in Python,
    says so at WARNING, and reports the backend."""
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    with caplog.at_level(logging.WARNING, logger=tkeyword.__name__):
        index = TKeywordIndex(device="cpu")
    assert index.backend == "python"
    assert any("Python build" in r.getMessage() for r in caplog.records)
    assert TKeywordIndex(device="cpu").backend == "python"
    monkeypatch.undo()
    assert TKeywordIndex(device="cpu").backend == "native"


# --- KeywordIndex on a seeded corpus ----------------------------------------


def _corpus(seed: int = 0, n_chunks: int = 1200, vocab: int = 300):
    """tests/test_search.py's recipe: bodies of 5-49 terms drawn from
    ``vocab``, and 17 four-term queries."""
    rng = np.random.default_rng(seed)
    bodies = [" ".join(f"w{t}" for t in rng.integers(0, vocab, size=rng.integers(5, 50))) for _ in range(n_chunks)]
    queries = [" ".join(f"w{t}" for t in rng.integers(0, vocab, size=4)) for _ in range(17)]
    return bodies, queries


def _stores(bodies: list[str], per_doc: int = 60):
    """A JAX and a port ``Store`` holding the same chunks, ``per_doc`` to a
    document (documents d0, d1, ...)."""
    out = []
    for store_cls, doc_cls, chunk_cls in ((JStore, JDocument, JChunk), (TStore, TDocument, TChunk)):
        store = store_cls(":memory:")
        for start in range(0, len(bodies), per_doc):
            doc = doc_cls.from_text(f"doc {start}", id=f"d{start // per_doc}")
            store.add_document(doc)
            chunks = [
                chunk_cls(id=f"c{i}", document_id=doc.id, index=i - start, headings="", body=bodies[i])
                for i in range(start, min(start + per_doc, len(bodies)))
            ]
            store.add_chunks(chunks, [np.zeros((1, 4), np.float32)] * len(chunks))
        out.append(store)
    return out


def _assert_same(t_results, j_results) -> None:
    assert len(t_results) == len(j_results)
    for (t_ids, t_scores), (j_ids, j_scores) in zip(t_results, j_results):
        assert t_ids == j_ids
        np.testing.assert_allclose(t_scores, j_scores, rtol=RTOL)


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("case", ["resident", "host_gather", "metadata_mask", "tombstones", "wide_query", "lcap_truncation"])
def test_keyword_index_matches_jax(case: str, backend: str) -> None:
    """``search`` and ``search_batch`` give the JAX index's ids and scores,
    on the resident and the host-gather routes, with a metadata mask, after
    tombstones (through ``Store.delete_documents`` and ``sync``), for a
    query over RESIDENT_MAX_TERMS terms (both fall back to the host
    gather), and with RESIDENT_LCAP = 128 (over-cap terms truncated to
    their top-impact postings at build)."""
    # A 200-term vocabulary puts most dfs above 128 for the truncation case.
    bodies, queries = _corpus(vocab=200 if case == "lcap_truncation" else 300)
    jstore, tstore = _stores(bodies)
    jindex, tindex = JKeywordIndex(), TKeywordIndex(device="cpu")
    if backend == "python":
        jindex._native = tindex._native = None
    if case == "lcap_truncation":
        jindex.RESIDENT_LCAP = tindex.RESIDENT_LCAP = 128
    jindex.sync(jstore)
    tindex.sync(tstore)
    assert tindex.backend == backend and tindex.chunk_ids == jindex.chunk_ids
    mask = None
    route = "resident"
    if case == "host_gather":
        jindex.use_resident = tindex.use_resident = False
        route = "host_gather"
    elif case == "metadata_mask":
        mask = np.zeros(len(bodies), bool)
        mask[::3] = True
    elif case == "tombstones":
        for store, index in ((jstore, jindex), (tstore, tindex)):
            store.delete_documents(["d1", "d4"])
            index.sync(store)
        assert len(tindex._dead) == len(jindex._dead) == 120
    elif case == "wide_query":
        queries = [" ".join(f"w{t}" for t in range(40)), *queries[:3]]
        route = "host_gather"
    for q in queries[:5]:
        _assert_same([tindex.search(q, num_hits=10, chunk_mask=mask)], [jindex.search(q, num_hits=10, chunk_mask=mask)])
    t_batch = tindex.search_batch(queries, num_hits=10, chunk_mask=mask)
    assert tindex.last_route == route
    _assert_same(t_batch, jindex.search_batch(queries, num_hits=10, chunk_mask=mask))
    assert sum(len(ids) for ids, _ in t_batch) > 5 * len(queries)
    if case == "tombstones":
        dead = {f"c{i}" for i in (*range(60, 120), *range(240, 300))}
        assert not dead & {cid for ids, _ in t_batch for cid in ids}
    if case == "lcap_truncation":
        assert tindex._res["lcap"] == 128 and int(np.diff(tindex._host_csr()[0]).max()) > 128


def test_resident_equals_host_gather_exactly() -> None:
    """The port's two routes sum each chunk's weights in the same tree, in
    the same term order, so they agree bit for bit (not only to rtol)."""
    bodies, queries = _corpus(seed=1)
    index = TKeywordIndex(device="cpu")
    for i, body in enumerate(bodies):
        index._add_chunk(f"c{i}", body)
    resident = index.search_batch(queries, num_hits=20)
    index.use_resident = False
    assert index.search_batch(queries, num_hits=20) == resident


# --- BM25 ops on the same arrays --------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_bm25_topk_resident_matches_jax(masked: bool) -> None:
    """``bm25_topk_resident`` on the JAX index's own resident arrays equals
    the JAX program (its winners sorted by (score desc, ordinal asc), as the
    JAX host does), for 4- and 32-term queries and padded term slots."""
    bodies, _ = _corpus(seed=2)
    jindex = JKeywordIndex()
    for i, body in enumerate(bodies):
        jindex._add_chunk(f"c{i}", body)
    res = jindex._ensure_resident()
    n_pad, lcap = res["n_pad"], res["lcap"]
    offsets, chunk, w = (np.array(res[k]) for k in ("offsets", "chunk", "w"))
    rng = np.random.default_rng(7)
    mask = rng.random(n_pad) < 0.5
    vocab = len(res["df_host"])
    for t in (4, 32):
        term_ids = rng.integers(0, vocab, size=(9, t)).astype(np.int32)
        term_ids[::2, t // 2 :] = -1  # padded slots
        packed = np.asarray(
            jbm25.bm25_topk_resident(
                jnp.asarray(offsets), jnp.asarray(chunk), jnp.asarray(w), jnp.asarray(mask),
                jnp.asarray(term_ids), num_chunks=n_pad, lcap=lcap, num_hits=25, masked=masked,
            )
        )
        j_scores, j_ords = packed[0], np.ascontiguousarray(packed[1]).view(np.int32)
        t_scores, t_ords = tbm25.bm25_topk_resident(
            torch.as_tensor(offsets, dtype=torch.int64), torch.as_tensor(chunk), torch.as_tensor(w),
            torch.as_tensor(mask), torch.as_tensor(term_ids),
            num_chunks=n_pad, lcap=lcap, num_hits=25, masked=masked,
        )
        for b in range(term_ids.shape[0]):
            order = np.lexsort((j_ords[b], -j_scores[b]))
            keep = j_scores[b][order] > 0
            got = t_scores[b].numpy() > 0
            np.testing.assert_array_equal(t_ords[b].numpy()[got], j_ords[b][order][keep])
            np.testing.assert_allclose(t_scores[b].numpy()[got], j_scores[b][order][keep], rtol=RTOL)
            assert (t_ords[b].numpy()[~got] == n_pad).all()


def _random_postings(rng, *, p: int, batch: int, num_chunks: int):
    chunk = rng.integers(0, num_chunks, size=p).astype(np.int32)
    chunk[rng.random(p) < 0.05] = num_chunks  # padding postings drop
    query = rng.integers(0, batch, size=p).astype(np.int32)
    tf = rng.integers(1, 6, size=p).astype(np.float32)
    tf[chunk == num_chunks] = 0.0
    idf = rng.uniform(0.1, 6.0, size=p).astype(np.float32)
    len_norm = rng.uniform(0.3, 2.5, size=num_chunks).astype(np.float32)
    return chunk, query, tf, idf, len_norm


def test_bm25_batch_ops_match_jax() -> None:
    """``bm25_scores_batch``, ``bm25_topk_batch``, ``bm25_scores`` and
    ``bm25_topk`` on the same postings as the JAX programs (duplicate
    (query, chunk) pairs, padding postings): dense scores within rtol 1e-5,
    top-k ids equal wherever the score is positive."""
    rng = np.random.default_rng(11)
    num_chunks, batch, k = 700, 7, 40
    chunk, query, tf, idf, len_norm = _random_postings(rng, p=6000, batch=batch, num_chunks=num_chunks)
    j_args = [jnp.asarray(x) for x in (chunk, query, tf, idf, len_norm)]
    t_args = [torch.as_tensor(x) for x in (chunk, query, tf, idf, len_norm)]
    j_dense = np.asarray(jbm25.bm25_scores_batch(*j_args, num_chunks=num_chunks, batch=batch))
    t_dense = tbm25.bm25_scores_batch(*t_args, num_chunks=num_chunks, batch=batch).numpy()
    np.testing.assert_allclose(t_dense, j_dense, rtol=RTOL)
    j_s, j_o = (np.asarray(x) for x in jbm25.bm25_topk_batch(*j_args, num_chunks=num_chunks, batch=batch, num_hits=k))
    t_s, t_o = (x.numpy() for x in tbm25.bm25_topk_batch(*t_args, num_chunks=num_chunks, batch=batch, num_hits=k))
    for b in range(batch):
        pos = j_s[b] > 0
        np.testing.assert_array_equal(t_o[b][pos], j_o[b][pos])
        np.testing.assert_allclose(t_s[b][pos], j_s[b][pos], rtol=RTOL)
    # One query: the first query's postings alone.
    one = query == 0
    j1 = [jnp.asarray(x[one]) for x in (chunk, tf, idf)] + [jnp.asarray(len_norm)]
    t1 = [torch.as_tensor(x[one]) for x in (chunk, tf, idf)] + [torch.as_tensor(len_norm)]
    np.testing.assert_allclose(
        tbm25.bm25_scores(*t1, num_chunks=num_chunks).numpy(),
        np.asarray(jbm25.bm25_scores(*j1, num_chunks=num_chunks)), rtol=RTOL,
    )
    js, jo = (np.asarray(x) for x in jbm25.bm25_topk(*j1, num_chunks=num_chunks, num_hits=k))
    ts, to = (x.numpy() for x in tbm25.bm25_topk(*t1, num_chunks=num_chunks, num_hits=k))
    np.testing.assert_array_equal(to[js > 0], jo[js > 0])
    np.testing.assert_allclose(ts[js > 0], js[js > 0], rtol=RTOL)


def test_bm25_batch_no_flat_id_overflow() -> None:
    """batch x num_chunks past 2^31 (the flat-id overflow shape of
    tests/test_search.py): the last query's two postings on chunk 7 still
    score.  The JAX program at this shape holds a 12 GB [300, 10M] matrix,
    so it is run on that query alone (query 0 of a batch of one), where its
    matrix is 40 MB; the port ranks the pairs without any such matrix."""
    num_chunks, batch = 10_000_128, 300
    chunk = np.asarray([7, 7], np.int32)
    tf = np.asarray([2.0, 1.0], np.float32)
    idf = np.asarray([1.5, 1.5], np.float32)
    len_norm = np.ones(num_chunks, np.float32)
    t_s, t_o = tbm25.bm25_topk_batch(
        torch.as_tensor(chunk), torch.full((2,), batch - 1, dtype=torch.int32), torch.as_tensor(tf),
        torch.as_tensor(idf), torch.as_tensor(len_norm), num_chunks=num_chunks, batch=batch, num_hits=3,
    )
    j_s, j_o = (
        np.asarray(x)
        for x in jbm25.bm25_topk_batch(
            jnp.asarray(chunk), jnp.zeros((2,), jnp.int32), jnp.asarray(tf), jnp.asarray(idf),
            jnp.asarray(len_norm), num_chunks=num_chunks, batch=1, num_hits=3,
        )
    )
    assert t_s[batch - 1, 0] > 0 and int(t_o[batch - 1, 0]) == int(j_o[0, 0]) == 7
    np.testing.assert_allclose(float(t_s[batch - 1, 0]), float(j_s[0, 0]), rtol=RTOL)
    assert (t_s[: batch - 1] == 0).all() and (t_o[: batch - 1] == num_chunks).all()
