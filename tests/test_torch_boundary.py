"""The port's learned sentence-boundary model (models/boundary.py) against
the JAX package's on the CPU: the same packaged weights, the same character
classes and windows, probabilities within 1e-6 of ``_apply`` (f32 sums in
other orders; the tanh GELU of ``jax.nn.gelu``), equal sentences from
``split_sentences(base_probas="learned")`` and equal chunk ids from
``insert_documents`` with ``sentence_boundary_model="learned"``."""

import numpy as np
import pytest
import torch

import raglite_tpu.models.boundary as jb
import raglite_tpu.models.boundary_data as jdata
import raglite_tpu_torch.models.boundary as tb
import raglite_tpu_torch.models.boundary_data as tdata
from raglite_tpu.sentences import heuristic_sentence_boundaries as jheuristic
from raglite_tpu.sentences import split_sentences as jsplit
from raglite_tpu_torch.sentences import split_sentences as tsplit

ATOL = 1e-6
EVAL_SEED = 2000  # the held-out seed of scripts/train_boundary.py
CJK_AND_ABBREVIATIONS = [
    "実験は成功した。結果は明確だった。次の段階に進む！",
    "Dr. Smith arrived early. The meeting began at 9 a.m. sharp.",
    "Prof. A. Einstein published in 1905. See Fig. 4, i.e. the plot.",
    "„Wie bitte?“, fragte sie. Der Zug fährt um 14.30 Uhr ab.",
    "数据显示增长了3.5%。我们需要更多样本吗？是的。",
    "",
    "x",
]


@pytest.fixture(scope="module")
def model() -> tb.BoundaryModel:
    return tb.default_model("cpu")


def _jax_probas(doc: str) -> np.ndarray:
    """``_apply`` on the N windows (no bucket padding: rows are independent)."""
    windows = jb.windows_for(jb.char_class_ids(doc))
    return np.asarray(jb._apply(jb.default_model().params, windows), dtype=np.float64)


def test_weights_are_the_packaged_npz(model) -> None:
    with np.load(tb._DEFAULT_WEIGHTS) as data:
        packaged = {k: data[k] for k in data.files}
    ours = model.params()
    assert set(ours) == set(packaged)
    for k in packaged:
        np.testing.assert_array_equal(ours[k], packaged[k])
    assert model.emb.weight.shape == (tb.VOCAB_SIZE, 12) == (187, 12)
    assert model.fc1.in_features == 156 and model.fc1.out_features == 64 and model.fc2.out_features == 1


def test_classes_windows_and_corpus_equal_jax() -> None:
    corpus = tdata.make_corpus(num_documents=10, seed=EVAL_SEED)
    assert corpus == jdata.make_corpus(num_documents=10, seed=EVAL_SEED)
    for doc in [d for d, _ in corpus] + CJK_AND_ABBREVIATIONS:
        np.testing.assert_array_equal(tb.char_class_ids(doc), jb.char_class_ids(doc))
        np.testing.assert_array_equal(tb.windows_for(tb.char_class_ids(doc)), jb.windows_for(jb.char_class_ids(doc)))


def test_heldout_probabilities_within_atol(model) -> None:
    for doc, _ in jdata.make_corpus(num_documents=40, seed=EVAL_SEED):
        np.testing.assert_allclose(model(doc), _jax_probas(doc), atol=ATOL, rtol=0)


@pytest.mark.parametrize("doc", CJK_AND_ABBREVIATIONS)
def test_cjk_and_abbreviation_probabilities(model, doc: str) -> None:
    ours = model(doc)
    assert ours.dtype == np.float64 and ours.shape == (len(doc),)
    np.testing.assert_allclose(ours, jb.default_model()(doc), atol=ATOL, rtol=0)


def test_long_document_blocks_match(model) -> None:
    """A document longer than one forward block (and than JAX's 131,072
    bucket's half) gives the JAX probabilities on every position."""
    corpus = jdata.make_corpus(num_documents=400, seed=EVAL_SEED + 7)
    doc = " ".join(d for d, _ in corpus)
    assert len(doc) > tb._BLOCK
    np.testing.assert_allclose(model(doc), jb.default_model()(doc), atol=ATOL, rtol=0)


def test_gelu_is_the_tanh_approximation(model) -> None:
    """The forward equals a hand-written tanh-GELU MLP bit for bit, and the
    exact GELU would be measurably off (the trap jax.nn.gelu sets)."""
    doc = "One sentence. Another one! And a third?"
    windows = torch.from_numpy(tb.windows_for(tb.char_class_ids(doc)))
    p = {k: torch.from_numpy(v) for k, v in model.params().items()}
    x = p["emb"][windows.long()].reshape(len(doc), -1)
    pre = x @ p["w1"] + p["b1"]
    tanh_gelu = 0.5 * pre * (1 + torch.tanh((2 / np.pi) ** 0.5 * (pre + 0.044715 * pre**3)))
    want = torch.sigmoid((tanh_gelu @ p["w2"] + p["b2"])[:, 0])
    exact = torch.sigmoid((torch.nn.functional.gelu(pre) @ p["w2"] + p["b2"])[:, 0])
    got = model(windows)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert float((exact - want).abs().max()) > 1e-6


def test_f1_learned_beats_heuristic_as_jax(model) -> None:
    corpus = jdata.make_corpus(num_documents=40, seed=EVAL_SEED)
    ours = [tb.boundary_f1(model(doc), gold) for doc, gold in corpus]
    theirs = [jb.boundary_f1(jb.learned_sentence_boundaries(doc), gold) for doc, gold in corpus]
    np.testing.assert_allclose(ours, theirs, atol=1e-12)
    learned = float(np.mean([f for f, _, _ in ours]))
    heuristic = float(np.mean([jb.boundary_f1(jheuristic(doc), gold)[0] for doc, gold in corpus]))
    assert learned > 0.98 and learned > heuristic


def test_split_sentences_learned_equal(model) -> None:
    docs = [d for d, _ in jdata.make_corpus(num_documents=12, seed=EVAL_SEED + 1)] + CJK_AND_ABBREVIATIONS[:5]
    for doc in docs:
        for max_len in (None, 64):
            ours = tsplit(doc, max_len=max_len, base_probas="learned", device="cpu")
            assert ours == jsplit(doc, max_len=max_len, base_probas="learned")
            assert "".join(ours) == doc


def test_save_load_round_trip(tmp_path, model) -> None:
    model.save(tmp_path / "b.npz")
    again = tb.BoundaryModel.load(tmp_path / "b.npz", device="cpu")
    doc = "Save it. Load it."
    np.testing.assert_array_equal(again(doc), model(doc))
    same = tb.BoundaryModel.from_params(jb.BoundaryModel.load(tmp_path / "b.npz").params, device="cpu")
    np.testing.assert_array_equal(same(doc), model(doc))


def test_missing_weights_raise(tmp_path) -> None:
    """Absent weights raise instead of swapping in the heuristic."""
    with pytest.raises(FileNotFoundError, match="boundary model weights not found"):
        tb.BoundaryModel.load(tmp_path / "absent.npz", device="cpu")


def test_insert_learned_chunk_ids_equal(tmp_path) -> None:
    from raglite_tpu import RAGLiteConfig as JConfig
    from raglite_tpu.documents import Document as JDocument
    from raglite_tpu.insert import insert_documents as jinsert
    from raglite_tpu.store import store_from_config as jstore
    from raglite_tpu_torch import RAGLiteConfig as TConfig
    from raglite_tpu_torch.documents import Document as TDocument
    from raglite_tpu_torch.insert import insert_documents as tinsert
    from raglite_tpu_torch.store import store_from_config as tstore

    text = "# Mixed\n\n" + " ".join(d for d, _ in jdata.make_corpus(num_documents=30, seed=EVAL_SEED + 2))
    common = {"embedder": "hash:128", "llm": "echo", "sentence_boundary_model": "learned", "chunk_max_size": 512}
    jcfg = JConfig(store_path=str(tmp_path / "j"), **common)
    tcfg = TConfig(store_path=str(tmp_path / "t"), device="cpu", **common)
    jinsert([JDocument.from_text(text)], config=jcfg)
    tinsert([TDocument.from_text(text)], config=tcfg)
    assert tstore(tcfg).chunk_order == jstore(jcfg).chunk_order
    assert len(tstore(tcfg).chunk_order) > 3
