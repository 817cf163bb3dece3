"""The port's ``hash:<dim>`` embedder against the JAX package's, on the CPU:
the Gaussian table drawn without JAX (C++ and numpy), the C++ featurizer,
the token and text embeddings, and a ``hash:256`` store's searches.

Tolerances: the table is compared bit for bit (``np.array_equal``) with
``jax.random.normal``; feature ids, signs and bounds exactly; CPU
embeddings exactly (both packages sum the same f32 table rows in the same
C++ loop); the device pool's arithmetic (run here on CPU tensors with the
bf16 table the card keeps) within 1e-6 of an f64 sum; search ids equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import raglite_tpu.models.encoder as jenc
import raglite_tpu_torch.models.encoder as tenc
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import hybrid_search as j_hybrid
from raglite_tpu import keyword_search as j_keyword
from raglite_tpu import vector_search as j_vector
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import hybrid_search as t_hybrid
from raglite_tpu_torch import keyword_search as t_keyword
from raglite_tpu_torch import vector_search as t_vector
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.models import hash_table
from raglite_tpu_torch.native import hash_featurize, normal_table

ROOT = Path(__file__).resolve().parent.parent
DOCS = {"MIGRATION.md": "migration", "BASELINE.md": "baseline", "PAPER.md": "paper"}
QUERIES = (
    "Which public symbols of the reference have equivalents?",
    "What does the baseline measure?",
    "How is the query adapter applied?",
    "recall of the int4 scan on the TPU",
)
#: Characters on which the C++ tokenizer and Python's ``\w`` agree (ASCII,
#: Latin-1 and CJK letters, punctuation, white space).
ALPHABET = list("abcdefghijklmnopqrstuvwxyzABCXYZ0123456789_ .,;:!?-'\"()#\n\téßüÆ漢字")


@pytest.mark.parametrize("dim", [64, 256])
def test_native_table_equals_jax(dim: int) -> None:
    """The ``hash:<dim>`` table (65,536 rows) drawn in C++, bit for bit."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1 << 16, dim), jnp.float32))
    assert np.array_equal(normal_table(0, 1 << 16, dim), want)


@pytest.mark.parametrize(("seed", "rows", "dim"), [(0, 4096, 64), (5, 1000, 37), (123, 7, 3)])
def test_numpy_table_equals_jax(seed: int, rows: int, dim: int) -> None:
    """The numpy draw (the fallback and the C++ code's oracle), bit for bit,
    at seeds and shapes whose flat indices end off a vector width."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (rows, dim), jnp.float32))
    assert np.array_equal(hash_table.normal_table_np(seed, rows, dim), want)
    assert np.array_equal(normal_table(seed, rows, dim), want)


def test_threefry_bits_equal_jax() -> None:
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(9), (3, 1000), jnp.uint32)).ravel()
    assert np.array_equal(hash_table.threefry_bits(9, 0, 3000), want)
    assert np.array_equal(hash_table.threefry_bits(9, 1500, 700), want[1500:2200])


@settings(max_examples=60, deadline=None)
@given(st.text(alphabet=st.sampled_from(ALPHABET), max_size=200))
def test_hash_featurize_equals_python_oracle(text: str) -> None:
    """The port's C++ featurizer against the JAX package's Python
    featurizer (``HashEncoder._features`` over ``_TOKEN_RE`` tokens)."""
    oracle = jenc.HashEncoder.__new__(jenc.HashEncoder)
    oracle._mask = (1 << 16) - 1
    tokens = jenc._TOKEN_RE.findall(text.lower())
    ids, signs, bounds = [], [], [0]
    for token in tokens:
        f_ids, f_signs = oracle._features(token)
        ids.extend(f_ids)
        signs.extend(f_signs)
        bounds.append(len(ids))
    got_ids, got_signs, got_bounds, n = hash_featurize(text, max_tokens=8192, mask=oracle._mask)
    assert n == len(tokens)
    np.testing.assert_array_equal(got_ids, np.asarray(ids, np.int32))
    np.testing.assert_array_equal(got_signs, np.asarray(signs, np.float32))
    np.testing.assert_array_equal(got_bounds, np.asarray(bounds, np.int64))


@pytest.fixture(scope="module")
def encoders():
    return jenc.HashEncoder(dim=256), tenc.HashEncoder(dim=256, device="cpu")


def test_embeddings_equal_jax(encoders) -> None:
    j_enc, t_enc = encoders
    text = (ROOT / "MIGRATION.md").read_text(encoding="utf-8")[:6000]
    np.testing.assert_array_equal(t_enc.embed_token_level(text), j_enc.embed_token_level(text))
    texts = [text[:300], "", "one", "Ünïcode wörds, and punctuation!"]
    np.testing.assert_array_equal(t_enc.embed(texts), j_enc.embed(texts))
    assert t_enc.count_tokens(texts) == j_enc.count_tokens(texts)


def test_device_pool_arithmetic(encoders) -> None:
    """The pool the card runs (gather, signed sum grouped by feature count,
    norm) on CPU tensors: with the f32 table it equals the C++ embedding,
    with the bf16 table its f64 plain version, each within 1e-6."""
    _, t_enc = encoders
    text = "A token, tokens; a verylongtokenwithmanytrigrams and x y z. " * 20
    ids, signs, bounds, _ = t_enc._featurize(text)
    args = (torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(signs), bounds)
    got = tenc._hash_pool(t_enc._table, *args).numpy()
    np.testing.assert_allclose(got, t_enc.embed_token_level(text), atol=1e-6)
    table16 = t_enc._table.to(torch.bfloat16)
    got16 = tenc._hash_pool(table16, *args).numpy()
    want16 = tenc.hash_pool_plain(table16.float().numpy(), ids, signs, bounds)
    np.testing.assert_allclose(got16, want16, atol=1e-6)


def test_make_encoder_builds_hash() -> None:
    encoder = tenc._make_encoder("hash:64", "cpu")
    assert isinstance(encoder, tenc.HashEncoder) and encoder.dim == 64
    # openai: is ported (no request is made until the width is asked for).
    remote = tenc._make_encoder("openai:http://localhost:1#m", "cpu")
    assert isinstance(remote, tenc.OpenAICompatEncoder) and remote.model == "m"


@pytest.fixture(scope="module")
def stores(tmp_path_factory: pytest.TempPathFactory):
    root = tmp_path_factory.mktemp("hash")
    jcfg = JConfig(store_path=str(root / "jax"), embedder="hash:256", chunk_max_size=1024)
    tcfg = TConfig(store_path=str(root / "torch"), embedder="hash:256", chunk_max_size=1024, device="cpu")
    texts = {f: (ROOT / f).read_text(encoding="utf-8") for f in DOCS}
    jinsert([JDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=jcfg)
    tinsert([TDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=tcfg)
    return jcfg, tcfg


@pytest.mark.parametrize("search", ["vector", "keyword", "hybrid"])
def test_hash_store_searches_equal_jax(stores, search: str) -> None:
    jcfg, tcfg = stores
    j_fn, t_fn = {"vector": (j_vector, t_vector), "keyword": (j_keyword, t_keyword), "hybrid": (j_hybrid, t_hybrid)}[search]
    for query in QUERIES:
        j_ids, _ = j_fn(query, num_results=8, config=jcfg)
        t_ids, _ = t_fn(query, num_results=8, config=tcfg)
        assert t_ids == j_ids, (search, query)
        assert t_ids
