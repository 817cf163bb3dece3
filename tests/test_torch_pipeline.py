"""The port's whole retrieval slice against the JAX package's, on the CPU:
insert in-repo documents, vector search, rerank, spans.

Both packages get the same documents and the same f32 2-layer encoder (the
JAX package's tiny preset; the port's encoder carries its weights over), so
the host pipeline (sentences, chunklets, chunks, late chunking) must give
identical chunk ids and bodies, embeddings within 1e-4, and the same
search and rerank orders.  The JAX package may run its C++ sentence and
chunklet DPs; the port runs the Python DPs they are held to.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import raglite_tpu.models.encoder as jenc
import raglite_tpu_torch.models.encoder as tenc
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import search as jsearch
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu.store import store_from_config as jstore
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import search as tsearch
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.models import transformer as tt
from raglite_tpu_torch.models.tokenizer import ByteTokenizer
from raglite_tpu_torch.store import store_from_config as tstore

ROOT = Path(__file__).resolve().parent.parent
DOCS = ("MIGRATION.md", "BASELINE.md")
QUERIES = (
    "Which public symbols of the reference have equivalents?",
    "What does the baseline measure?",
    "How is the query adapter applied?",
)


@pytest.fixture(scope="module")
def configs(tmp_path_factory: pytest.TempPathFactory):
    j_encoder = jenc.TransformerEncoder("tiny", dtype=np.float32)
    model = tt.EncoderModel.from_params(j_encoder._cfg, j_encoder._params, dtype=torch.float32, device="cpu")
    t_encoder = tenc.TransformerEncoder.from_model(model, ByteTokenizer(vocab_size=j_encoder._cfg["vocab"]))
    patch = pytest.MonkeyPatch()
    patch.setattr(jenc, "_make_encoder", lambda embedder: j_encoder)
    patch.setattr(tenc, "_make_encoder", lambda embedder, device: t_encoder)
    root = tmp_path_factory.mktemp("stores")
    jcfg = JConfig(store_path=str(root / "jax"), embedder="flax:tiny", chunk_max_size=1024)
    tcfg = TConfig(store_path=str(root / "torch"), embedder="flax:tiny", chunk_max_size=1024, device="cpu")
    texts = [(ROOT / name).read_text(encoding="utf-8") for name in DOCS]
    jinsert([JDocument.from_text(t) for t in texts], config=jcfg)
    tinsert([TDocument.from_text(t) for t in texts], config=tcfg)
    yield jcfg, tcfg
    patch.undo()


def test_chunks_and_embeddings_match(configs) -> None:
    jcfg, tcfg = configs
    js, ts = jstore(jcfg), tstore(tcfg)
    assert ts.chunk_order == js.chunk_order and len(ts.chunk_order) > 10
    for cid in js.chunk_order:
        jc, tc = js.get_chunk(cid), ts.get_chunk(cid)
        assert (tc.body, tc.headings, tc.index, tc.document_id) == (jc.body, jc.headings, jc.index, jc.document_id)
        np.testing.assert_allclose(
            ts.embeddings[cid].astype(np.float32), js.embeddings[cid].astype(np.float32), atol=1e-4, rtol=0
        )


def test_vector_search_and_rerank_match(configs) -> None:
    jcfg, tcfg = configs
    for query in QUERIES:
        jids, jscores = jsearch.vector_search(query, num_results=3, config=jcfg)
        tids, tscores = tsearch.vector_search(query, num_results=3, config=tcfg)
        assert tids == jids
        np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=0)
        cands, _ = tsearch.vector_search(query, num_results=8, config=tcfg)
        assert [c.id for c in tsearch.rerank_chunks(query, cands, config=tcfg)] == [
            c.id for c in jsearch.rerank_chunks(query, cands, config=jcfg)
        ]


class _WithoutFusedRerank:
    """An encoder seen without its fused ``rerank_maxsim``, so that
    ``_rank_with_token_maxsim`` takes its host token-matrix path."""

    def __init__(self, encoder) -> None:
        self._encoder = encoder

    def __getattr__(self, name: str):
        if name == "rerank_maxsim":
            raise AttributeError(name)
        return getattr(self._encoder, name)


@pytest.mark.parametrize("mode", ["maxsim_chunklet", "token_matrices", "blend"])
def test_rerank_variants_match(configs, mode: str, monkeypatch: pytest.MonkeyPatch) -> None:
    """The chunklet MaxSim ranker, the token-matrix path and the blend with
    the retrieval order give the JAX package's orders."""
    jcfg, tcfg = configs
    if mode == "maxsim_chunklet":
        jcfg = dataclasses.replace(jcfg, reranker="maxsim_chunklet")
        tcfg = dataclasses.replace(tcfg, reranker="maxsim_chunklet")
    elif mode == "blend":
        jcfg = dataclasses.replace(jcfg, reranker_blend=0.5)
        tcfg = dataclasses.replace(tcfg, reranker_blend=0.5)
    else:
        j_encoder, t_encoder = jenc._make_encoder("flax:tiny"), tenc._make_encoder("flax:tiny", "cpu")
        monkeypatch.setattr(jenc, "_make_encoder", lambda embedder: _WithoutFusedRerank(j_encoder))
        monkeypatch.setattr(tenc, "_make_encoder", lambda embedder, device: _WithoutFusedRerank(t_encoder))
        # Fresh token-matrix caches, dropped again after the test.
        monkeypatch.setattr(jsearch, "_TOKEN_MATRIX_CACHE", {})
        monkeypatch.setattr(tsearch, "_TOKEN_MATRIX_CACHE", {})
    for query in QUERIES:
        cands, _ = tsearch.vector_search(query, num_results=8, config=tcfg)
        assert [c.id for c in tsearch.rerank_chunks(query, cands, config=tcfg)] == [
            c.id for c in jsearch.rerank_chunks(query, cands, config=jcfg)
        ]


def test_batch_search_and_spans_match(configs) -> None:
    jcfg, tcfg = configs
    assert tsearch.vector_search_batch(list(QUERIES), num_results=3, config=tcfg)[0][0] == (
        jsearch.vector_search_batch(list(QUERIES), num_results=3, config=jcfg)[0][0]
    )
    tspans = tsearch.search_and_rerank_chunk_spans(
        QUERIES[0], num_results=3, search=tsearch.vector_search, config=tcfg
    )
    jspans = jsearch.search_and_rerank_chunk_spans(
        QUERIES[0], num_results=3, search=jsearch.vector_search, config=jcfg
    )
    assert [[c.id for c in s.chunks] for s in tspans] == [[c.id for c in s.chunks] for s in jspans]
    assert tspans[0].to_xml() == jspans[0].to_xml()


def test_hybrid_search_is_not_ported_yet(configs) -> None:
    _, tcfg = configs
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tsearch.search_and_rerank_chunks(QUERIES[0], config=tcfg)
