"""The port's hybrid side against the JAX package's, on the CPU: device RRF
(``rrf_fuse_topk``) on the cases of tests/test_hybrid_fused.py, and the
slice end to end (keyword, hybrid and span search, metadata filters,
deletes) on the documents of tests/test_torch_pipeline.py with the same
tiny f32 encoder carried across.

Tolerances: ids and ordinals equal; fused RRF scores within 1e-7 (the same
f32 operations on both sides); BM25 scores within rtol 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import raglite_tpu.models.encoder as jenc
import raglite_tpu_torch.models.encoder as tenc
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import search as jsearch
from raglite_tpu.delete import delete_documents as jdelete
from raglite_tpu.delete import delete_documents_by_metadata as jdelete_by_metadata
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu.ops.rrf import rrf_fuse_topk as j_rrf
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import delete_documents as tdelete
from raglite_tpu_torch import delete_documents_by_metadata as tdelete_by_metadata
from raglite_tpu_torch import search as tsearch
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.index.dense import dense_index_from_config
from raglite_tpu_torch.index.keyword import keyword_index_from_config
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.models import transformer as tt
from raglite_tpu_torch.models.tokenizer import ByteTokenizer
from raglite_tpu_torch.ops.rrf import rrf_fuse_topk as t_rrf
from raglite_tpu_torch.store import store_from_config as tstore

ROOT = Path(__file__).resolve().parent.parent
DOCS = {"MIGRATION.md": "migration", "BASELINE.md": "baseline", "PAPER.md": "paper"}
QUERIES = (
    "Which public symbols of the reference have equivalents?",
    "What does the baseline measure?",
    "How is the query adapter applied?",
    "recall of the int4 scan on the TPU",
)
FILTER = {"topic": "migration"}


# --- Device RRF against the JAX program and the host oracle ------------------


def _host_oracle(d_ords, k_scores, k_ords, n, num_results, w_d=0.75, w_k=0.25):
    """The host path's result from raw candidate sets (dense positions are
    ranks; keyword sorted by (score desc, ordinal asc), invalid dropped)."""
    d_ids = [str(int(o)) for o in d_ords if o >= 0]
    order = np.lexsort((k_ords, -k_scores))
    k_ids = [str(int(k_ords[i])) for i in order if k_scores[i] > 0.0 and k_ords[i] < n]
    ids, scores = jsearch.reciprocal_rank_fusion([d_ids, k_ids], weights=[w_d, w_k])
    return [int(i) for i in ids[:num_results]], scores[:num_results]


def _rrf_case(case: str):
    """(d_scores, d_ords, k_scores, k_ords, n, num_results) of each case of
    tests/test_hybrid_fused.py."""
    if case == "random":
        rng = np.random.default_rng(0)
        n, b, k1, k2 = 500, 7, 12, 10
        d_scores = np.sort(rng.normal(size=(b, k1)).astype(np.float32), axis=1)[:, ::-1].copy()
        d_ords = np.stack([rng.choice(n, size=k1, replace=False) for _ in range(b)])
        for i in range(b):
            cut = rng.integers(3, k1 + 1)
            d_scores[i, cut:], d_ords[i, cut:] = -np.inf, -1
        k_scores = rng.uniform(0.1, 5.0, size=(b, k2)).astype(np.float32)
        k_ords = np.stack([rng.choice(n, size=k2, replace=False) for _ in range(b)])
        for i in range(b):
            take = [o for o in d_ords[i] if o >= 0][: k2 // 2]
            k_ords[i, : len(take)] = take
            perm = rng.permutation(k2)  # keyword winners may arrive unordered
            k_ords[i], k_scores[i] = k_ords[i][perm], k_scores[i][perm]
            k_scores[i, rng.integers(0, k2)] = 0.0
        return d_scores, d_ords, k_scores, k_ords, n, 8
    if case == "empty_dense":
        n = 100
        return (
            np.full((1, 6), -np.inf, np.float32), np.full((1, 6), -1, np.int64),
            np.asarray([[3.0, 2.0, 1.0, 0.0, 0.0, 0.0]], np.float32), np.asarray([[5, 9, 2, n, n, n]]), n, 4,
        )
    if case == "both_empty":
        n = 100
        return (
            np.full((1, 6), -np.inf, np.float32), np.full((1, 6), -1, np.int64),
            np.zeros((1, 6), np.float32), np.full((1, 6), n), n, 4,
        )
    if case == "keyword_tie_order":
        n = 50
        return (
            np.asarray([[2.0, 1.0]], np.float32), np.asarray([[7, 3]]),
            np.asarray([[1.5, 1.5, 1.5, 0.0]], np.float32), np.asarray([[9, 3, 1, n]]), n, 5,
        )
    assert case == "out_of_range_dense"
    n = 10
    return (
        np.asarray([[3.0, 2.5, 2.0, 1.5]], np.float32), np.asarray([[4, n, 7, n + 5]]),
        np.asarray([[1.0, 0.8, 0.0]], np.float32), np.asarray([[4, n + 3, n]]), n, 6,
    )


@pytest.mark.parametrize("case", ["random", "empty_dense", "both_empty", "keyword_tie_order", "out_of_range_dense"])
def test_rrf_fuse_topk_matches_jax(case: str) -> None:
    """Ordinals equal to the JAX program's (and to the host oracle's), fused
    scores within 1e-7; empty slots are -1."""
    import jax.lax
    import jax.numpy as jnp

    d_scores, d_ords, k_scores, k_ords, n, num_results = _rrf_case(case)
    packed = np.asarray(
        j_rrf(
            jnp.stack([jnp.asarray(d_scores), jnp.asarray(d_ords, jnp.float32)]),
            jnp.stack([jnp.asarray(k_scores), jax.lax.bitcast_convert_type(jnp.asarray(k_ords, jnp.int32), jnp.float32)]),
            num_chunks=n, num_results=num_results,
        )
    )
    j_scores, j_ords = packed[0], np.ascontiguousarray(packed[1]).view(np.int32)
    t_scores, t_ords = t_rrf(
        (torch.as_tensor(d_scores), torch.as_tensor(d_ords)),
        (torch.as_tensor(k_scores), torch.as_tensor(k_ords)),
        num_chunks=n, num_results=num_results,
    )
    t_scores, t_ords = t_scores.numpy(), t_ords.numpy()
    assert t_ords.dtype == np.int64
    np.testing.assert_array_equal(t_ords, j_ords)
    keep = t_ords >= 0
    np.testing.assert_allclose(t_scores[keep], j_scores[keep], rtol=0, atol=1e-7)
    assert np.isneginf(t_scores[~keep]).all()
    if case == "out_of_range_dense":
        # Leaked ordinals drop; ranks stay positions as delivered, so 4 keeps
        # dense rank 0 (plus keyword rank 0) and 7 dense rank 2.
        assert list(t_ords[0][keep[0]]) == [4, 7]
        return
    for i in range(len(d_ords)):
        want_ids, want_scores = _host_oracle(d_ords[i], k_scores[i], k_ords[i], n, num_results)
        assert list(t_ords[i][t_ords[i] >= 0]) == want_ids
        np.testing.assert_allclose(t_scores[i][t_ords[i] >= 0], want_scores, rtol=1e-6)


def test_reciprocal_rank_fusion_matches_jax() -> None:
    rankings = [["a", "b", "c"], ["c", "d"], []]
    for weights in (None, [0.5, 0.3, 0.2]):
        assert tsearch.reciprocal_rank_fusion(rankings, weights=weights) == jsearch.reciprocal_rank_fusion(
            rankings, weights=weights
        )
    assert tsearch.reciprocal_rank_fusion([]) == ([], [])
    with pytest.raises(ValueError, match="number of weights"):
        tsearch.reciprocal_rank_fusion(rankings, weights=[1.0])


# --- The slice end to end ----------------------------------------------------


def _insert(root, name: str):
    """A JAX and a port store (under ``root/name``) holding DOCS, each
    document tagged with its topic."""
    jcfg = JConfig(store_path=str(root / f"{name}-jax"), embedder="flax:tiny", chunk_max_size=1024)
    tcfg = TConfig(store_path=str(root / f"{name}-torch"), embedder="flax:tiny", chunk_max_size=1024, device="cpu")
    texts = {f: (ROOT / f).read_text(encoding="utf-8") for f in DOCS}
    jinsert([JDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=jcfg)
    tinsert([TDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def encoders(tmp_path_factory: pytest.TempPathFactory):
    j_encoder = jenc.TransformerEncoder("tiny", dtype=np.float32)
    model = tt.EncoderModel.from_params(j_encoder._cfg, j_encoder._params, dtype=torch.float32, device="cpu")
    t_encoder = tenc.TransformerEncoder.from_model(model, ByteTokenizer(vocab_size=j_encoder._cfg["vocab"]))
    patch = pytest.MonkeyPatch()
    patch.setattr(jenc, "_make_encoder", lambda embedder: j_encoder)
    patch.setattr(tenc, "_make_encoder", lambda embedder, device: t_encoder)
    yield tmp_path_factory.mktemp("hybrid")
    patch.undo()


@pytest.fixture(scope="module")
def configs(encoders):
    return _insert(encoders, "read")


def _assert_same(t_result, j_result, *, rtol: float) -> None:
    (t_ids, t_scores), (j_ids, j_scores) = t_result, j_result
    assert t_ids == j_ids
    np.testing.assert_allclose(t_scores, j_scores, rtol=rtol)


def _span_ids(spans) -> list[list[str]]:
    return [[c.id for c in span.chunks] for span in spans]


def _check_slice(jcfg, tcfg, metadata_filter) -> None:
    """keyword, hybrid and span search give the JAX package's ids."""
    kw = dict(metadata_filter=metadata_filter)
    for query in QUERIES:
        _assert_same(
            tsearch.keyword_search(query, num_results=5, config=tcfg, **kw),
            jsearch.keyword_search(query, num_results=5, config=jcfg, **kw), rtol=1e-5,
        )
        _assert_same(
            tsearch.hybrid_search(query, num_results=5, config=tcfg, **kw),
            jsearch.hybrid_search(query, num_results=5, config=jcfg, **kw), rtol=1e-6,
        )
        assert keyword_index_from_config(tcfg).last_route == "hybrid_fused"
        assert _span_ids(tsearch.search_and_rerank_chunk_spans(query, num_results=3, config=tcfg, **kw)) == _span_ids(
            jsearch.search_and_rerank_chunk_spans(query, num_results=3, config=jcfg, **kw)
        )
    t_batch = tsearch.hybrid_search_batch(list(QUERIES), num_results=5, config=tcfg, **kw)
    j_batch = jsearch.hybrid_search_batch(list(QUERIES), num_results=5, config=jcfg, **kw)
    for t_result, j_result in zip(t_batch, j_batch, strict=True):
        _assert_same(t_result, j_result, rtol=1e-6)
    t_kw = tsearch.keyword_search_batch(list(QUERIES), num_results=5, config=tcfg, **kw)
    j_kw = jsearch.keyword_search_batch(list(QUERIES), num_results=5, config=jcfg, **kw)
    for t_result, j_result in zip(t_kw, j_kw, strict=True):
        _assert_same(t_result, j_result, rtol=1e-5)


@pytest.mark.parametrize("metadata_filter", [None, FILTER], ids=["unfiltered", "filtered"])
def test_keyword_hybrid_and_spans_match_jax(configs, metadata_filter) -> None:
    jcfg, tcfg = configs
    _check_slice(jcfg, tcfg, metadata_filter)
    if metadata_filter:
        store = tstore(tcfg)
        ids, _ = tsearch.hybrid_search(QUERIES[0], num_results=8, metadata_filter=metadata_filter, config=tcfg)
        assert ids and all(store.get_chunk(cid).document_id == "MIGRATION.md" for cid in ids)
        assert tsearch.hybrid_search(QUERIES[0], metadata_filter={"topic": "none"}, config=tcfg) == ([], [])


def test_hybrid_routes(configs) -> None:
    """One query: the fused route, with the plain exact scan on the dense
    side (the index is small and on the CPU).  A query of more than
    RESIDENT_MAX_TERMS known terms falls back to host RRF over the host
    gather and still gives the JAX package's ids."""
    jcfg, tcfg = configs
    tsearch.hybrid_search(QUERIES[0], config=tcfg)
    assert keyword_index_from_config(tcfg).last_route == "hybrid_fused"
    assert dense_index_from_config(tcfg).last_route == "dense"
    kw = keyword_index_from_config(tcfg)
    wide = " ".join(sorted({t for cid in tstore(tcfg).chunk_order for t in tstore(tcfg).get_chunk(cid).body.lower().split() if t.isalpha()})[: kw.RESIDENT_MAX_TERMS + 8])
    assert tsearch._hybrid_fused_batch(
        [wide], num_results=3, oversample=2, vector_search_weight=0.75, keyword_search_weight=0.25,
        metadata_filter=None, config=tcfg,
    ) is None
    _assert_same(tsearch.hybrid_search(wide, num_results=4, config=tcfg), jsearch.hybrid_search(wide, num_results=4, config=jcfg), rtol=1e-6)
    assert kw.last_route == "host_gather"


def test_deletes_match_jax(encoders) -> None:
    """After ``delete_documents`` (a third of the chunks: the keyword index
    rebuilds, the dense index flips valid bits) and then
    ``delete_documents_by_metadata`` (past half: the store compacts), the
    port still gives the JAX package's ids, and no deleted chunk is found."""
    jcfg, tcfg = _insert(encoders, "delete")
    assert tdelete(["PAPER.md", "missing"], config=tcfg) == jdelete(["PAPER.md", "missing"], config=jcfg) == 1
    _check_slice(jcfg, tcfg, None)
    assert tdelete_by_metadata({"topic": "baseline"}, config=tcfg) == jdelete_by_metadata({"topic": "baseline"}, config=jcfg) == 1
    _check_slice(jcfg, tcfg, None)
    store = tstore(tcfg)
    for query in QUERIES:
        ids, _ = tsearch.hybrid_search(query, num_results=10, config=tcfg)
        assert ids and all(store.get_chunk(cid).document_id == "MIGRATION.md" for cid in ids)
