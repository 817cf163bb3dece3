"""The plain reference against the program, at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.reference.encoder import ReferenceEncoder, _preset_state, fp8_rows
from benchmark.reference.search import BM25
from benchmark.reference.tokenizers import ByteLevelBPE, Bytes
from benchmark.run import ROOT

PACKAGED = ROOT / "raglite_tpu" / "models" / "data" / "encoder"
TEXTS = ["w1234 w567 w29999 w201", "hello world, this is a test!", "It's the reader's job; don't   panic.",
         "w200", " leading space", "tabs\tand\nnewlines  end  "]


def test_bpe_matches_the_programs_tokenizer():
    from raglite_tpu_torch.models.tokenizer import load_tokenizer

    ours = ByteLevelBPE(PACKAGED / "tokenizer.json")
    theirs = load_tokenizer(str(PACKAGED / "tokenizer.json"))
    texts = TEXTS + [(ROOT / "SURVEY.md").read_text()[:4000]]
    for text in texts:
        assert ours.encode(text) == list(theirs.encode(text)), text


def test_bpe_matches_tokenizers_where_installed():
    tokenizers = pytest.importorskip("tokenizers")
    ours = ByteLevelBPE(PACKAGED / "tokenizer.json")
    theirs = tokenizers.Tokenizer.from_file(str(PACKAGED / "tokenizer.json"))
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text).ids


def test_preset_draw_is_the_programs():
    from raglite_tpu_torch.models.encoder import TransformerEncoder

    program = TransformerEncoder("tiny", device="cpu")._model.state_dict()
    cfg = {"layers": 2, "d_model": 256, "heads": 4, "d_ff": 512, "vocab": 8192, "max_len": 512}
    ours = _preset_state(cfg, 0, final_ln=True)
    assert set(ours) == set(program)
    for name, value in ours.items():
        assert torch.equal(value.to(program[name].dtype), program[name]), name


@pytest.mark.parametrize("spec", ["tiny", "sem"])
def test_reference_embeddings_match_the_programs(spec):
    from raglite_tpu_torch.models.encoder import TransformerEncoder

    queries = ["w1234 w567 w29999 w201", "w300 w301 w302 w303 w304 w305 w306", "w9000"]
    program = TransformerEncoder(spec, device="cpu")
    got = program.embed(queries).astype(np.float64)
    got /= np.linalg.norm(got, axis=1, keepdims=True)
    if spec == "tiny":
        ref_spec = {"source": "preset", "seed": 0, "layers": 2, "d_model": 256, "heads": 4, "d_ff": 512,
                    "vocab": 8192, "max_len": 512, "final_ln": True}
        tok = Bytes()
    else:
        ref_spec = {"source": "npz", "file": "raglite_tpu/models/data/encoder/encoder.npz",
                    "config": "raglite_tpu/models/data/encoder/config.json"}
        tok = ByteLevelBPE(PACKAGED / "tokenizer.json")
    ref = ReferenceEncoder(ref_spec, ROOT, device="cpu")
    want = ref.embed([tok.encode(q) for q in queries])
    control = ReferenceEncoder(ref_spec, ROOT, device="cpu", weights="fp8").embed([tok.encode(q) for q in queries])
    err = np.linalg.norm(got - want, axis=1).max()
    control_err = np.linalg.norm(control - want, axis=1).max()
    # The program's bf16 residual stream against f32: under 1e-2 of a unit
    # vector (8.1e-3 for the packaged encoder); float8 weights move it three
    # times as far or more (6.5 times for the packaged encoder).
    assert err < 1e-2 and control_err > 3 * err, (err, control_err)


def test_fp8_rows_round_each_row_to_e4m3():
    w = torch.randn(16, 64)
    q = fp8_rows(w)
    scale = w.abs().amax(dim=1, keepdim=True) / 448.0
    assert torch.equal((q / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale, q)
    assert 0 < (q - w).abs().max() < 0.1 * w.abs().max()


def test_bm25_scores_and_ties():
    texts = ["w1 w2 w3", "w1 w1 w4", "w2 w5 w6", "w7 w8 w9", "w1 w2 w3"]
    bm = BM25(texts, ["w1 w2"])
    scores = bm.scores("w1 w2 w2")
    n, avg = 5, 3.0
    idf1 = np.log(1 + (n - 3 + 0.5) / (3 + 0.5))
    idf2 = np.log(1 + (n - 3 + 0.5) / (3 + 0.5))
    one = lambda tf: tf * 2.2 / (tf + 1.2 * (0.25 + 0.75 * 3 / avg))  # noqa: E731
    assert np.isclose(scores[0], idf1 * one(1) + idf2 * one(1))
    assert np.isclose(scores[1], idf1 * one(2))
    assert BM25.ranking(scores)[:2] == [0, 4]  # an exact tie: the lower ordinal first
    assert 3 not in scores
