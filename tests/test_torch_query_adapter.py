"""The port's query adapter (query_adapter.py, ops/nnls.py) against the JAX
package's, on the CPU.

Tolerances, stated per test: the batched NNLS targets within atol 1e-4 (the
same 200 f32 FISTA iterations, summed in other orders); the f64 Procrustes
solution within 1e-6; the adapter trained over the same ``hash:128`` store
in both packages within 1e-3 (query embeddings are f16 in both, and one f16
ulp may flip between XLA's and torch's pooling sums), with the adapted
searches' ids equal; the blocked index search's ids equal to the one-shot
search's, and its scores within rtol 1e-6 (a matmul sums each product in an
order that follows its shape: a [1, d] or [2, d] block of queries rounds
some scores an f32 ulp away from the [7, d] call).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import search as jsearch
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.documents import Eval as JEval
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu.ops.nnls import batched_query_targets as j_targets
from raglite_tpu.query_adapter import procrustes_adapter as j_procrustes
from raglite_tpu.query_adapter import update_query_adapter as j_update
from raglite_tpu.store import store_from_config as jstore
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import search as tsearch
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.documents import Eval as TEval
from raglite_tpu_torch.index.dense import dense_index_from_config
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.ops.nnls import batched_query_targets as t_targets
from raglite_tpu_torch.query_adapter import procrustes_adapter as t_procrustes
from raglite_tpu_torch.query_adapter import search_blocked
from raglite_tpu_torch.query_adapter import update_query_adapter as t_update
from raglite_tpu_torch.store import store_from_config as tstore

QUERIES = [f"What are the facts about subject {i}?" for i in range(6)] + ["details of subject 2 and 4"]


def _docs(cls):
    return [
        cls.from_text(
            f"# Topic {i}\n\n" + " ".join(f"Fact {i}-{j} about subject {i} and its details." for j in range(12)),
            filename=f"doc{i}.md",
        )
        for i in range(6)
    ]


def _add_evals(store, docs, eval_cls) -> None:
    """Each eval's question targets one document's chunks (the fixture of
    tests/test_query_adapter.py)."""
    for i, doc in enumerate(docs):
        chunk_ids = [cid for cid in store.chunk_order if store.chunks[cid].document_id == doc.id]
        ev = eval_cls.from_chunks(
            question=f"What are the facts about subject {i}?",
            contexts=[store.get_chunk(cid) for cid in chunk_ids],
            ground_truth=f"Facts about subject {i}.",
        )
        store.add_evals([ev])


@pytest.fixture(scope="module")
def adapter_configs(tmp_path_factory: pytest.TempPathFactory):
    root = tmp_path_factory.mktemp("qa")
    jcfg = JConfig(store_path=str(root / "jax"), embedder="hash:128", llm="echo")
    tcfg = TConfig(store_path=str(root / "torch"), embedder="hash:128", llm="echo", device="cpu")
    jdocs, tdocs = _docs(JDocument), _docs(TDocument)
    jinsert(jdocs, config=jcfg)
    tinsert(tdocs, config=tcfg)
    _add_evals(jstore(jcfg), jdocs, JEval)
    _add_evals(tstore(tcfg), tdocs, TEval)
    return jcfg, tcfg


def _nnls_inputs(seed: int, b: int = 4, p: int = 8, n: int = 8, d: int = 64):
    """Seeded queries and unit-ish rows, with padded (zero) rows at the
    end of every positive and negative block but the first."""
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    pos = (rng.normal(size=(b, p, d)) / np.sqrt(d)).astype(np.float32)
    neg = (rng.normal(size=(b, n, d)) / np.sqrt(d)).astype(np.float32)
    for i in range(1, b):
        pos[i, p - i :] = 0.0
        neg[i, n - 2 * i :] = 0.0
    return qs, pos, neg, np.any(pos != 0, axis=-1), np.any(neg != 0, axis=-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alpha", [0.05, 0.5])
def test_batched_query_targets_match_jax(seed: int, alpha: float) -> None:
    """atol 1e-4: both run 16 power iterations and 200 FISTA iterations in
    f32 on the same padded [B, P*N, d] pair rows."""
    qs, pos, neg, pm, nm = _nnls_inputs(seed)
    want = np.asarray(j_targets(*(jnp.asarray(x) for x in (qs, pos, neg, pm, nm)), alpha=alpha))
    got = t_targets(*(torch.from_numpy(x) for x in (qs, pos, neg, pm, nm)), alpha=alpha).numpy()
    assert got.shape == (4, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # The targets move the queries: the margins are not all met at q.
    assert float(np.abs(got - qs).max()) > 1e-3


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("n", [40, 300])
def test_procrustes_matches_jax(metric: str, n: int) -> None:
    """Within 1e-6: the same f64 host solve (rank-deficient at n = 40 < d,
    full rank at n = 300)."""
    rng = np.random.default_rng(n)
    d = 128
    Q = rng.normal(size=(n, d)).astype(np.float32)
    T = Q + 0.05 * rng.normal(size=(n, d)).astype(np.float32)
    np.testing.assert_allclose(t_procrustes(Q, T, metric), j_procrustes(Q, T, metric), atol=1e-6, rtol=0)


def test_update_query_adapter_matches_jax(adapter_configs) -> None:
    """The adapter within 1e-3 of the JAX package's over the same store, and
    the adapted searches' ids equal."""
    jcfg, tcfg = adapter_configs
    want = j_update(config=jcfg)
    got = t_update(config=tcfg)
    assert got.shape == (128, 128) and np.isfinite(got).all()
    np.testing.assert_allclose(got @ got.T, np.eye(128), atol=1e-3)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert "query_adapter" in tstore(tcfg).index_metadata
    for query in QUERIES:
        jids, _ = jsearch.vector_search(query, num_results=5, config=jcfg)
        tids, _ = tsearch.vector_search(query, num_results=5, config=tcfg)
        assert tids == jids, query
    # Batched adapted search, and plain search, too.
    want_batch = [ids for ids, _ in jsearch.vector_search_batch(QUERIES, num_results=5, config=jcfg)]
    assert [ids for ids, _ in tsearch.vector_search_batch(QUERIES, num_results=5, config=tcfg)] == want_batch
    jplain = dataclasses.replace(jcfg, vector_search_query_adapter=False)
    tplain = dataclasses.replace(tcfg, vector_search_query_adapter=False)
    for query in QUERIES:
        assert tsearch.vector_search(query, num_results=5, config=tplain)[0] == jsearch.vector_search(
            query, num_results=5, config=jplain
        )[0]


@pytest.mark.parametrize("block", [1, 2, 4, 64])
def test_search_blocked_equals_one_shot(adapter_configs, block: int) -> None:
    """Blocks of questions give the one-shot search's ids exactly and its
    scores within rtol 1e-6 (each row's top-k is its own)."""
    _, tcfg = adapter_configs
    from raglite_tpu_torch.embed import embed_queries

    index = dense_index_from_config(dataclasses.replace(tcfg, vector_search_query_adapter=False))
    qs = embed_queries(QUERIES, config=tcfg).astype(np.float32)
    want_scores, want_ids = index.search(qs, num_hits=24)
    got_scores, got_ids = search_blocked(index, qs, num_hits=24, block=block)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-6, atol=0)


@pytest.mark.parametrize("missing", ["insert_evals", "insert_documents"])
def test_update_query_adapter_errors_match_jax(tmp_path, missing: str) -> None:
    """Both packages raise the same ValueError on a store without evals and
    on an empty store."""
    errors = []
    for name, cfg_cls, doc_cls, insert, update in (
        ("jax", JConfig, JDocument, jinsert, j_update),
        ("torch", TConfig, TDocument, tinsert, t_update),
    ):
        kwargs = {"device": "cpu"} if name == "torch" else {}
        config = cfg_cls(store_path=str(tmp_path / name), embedder="hash:128", **kwargs)
        if missing == "insert_evals":
            insert([doc_cls.from_text("Just one document here. ", filename="d.md")], config=config)
        with pytest.raises(ValueError, match=missing) as info:
            update(config=config)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_update_query_adapter_rejects_l2(adapter_configs) -> None:
    _, tcfg = adapter_configs
    with pytest.raises(ValueError, match="Unsupported metric: l2"):
        t_update(config=dataclasses.replace(tcfg, vector_search_distance_metric="l2"))
