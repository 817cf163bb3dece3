"""The port's byte-level BPE trainer (raglite_tpu_torch/train/bpe.py)
against ``tokenizers``' ``BpeTrainer`` configured as
scripts/train_encoder.py:train_tokenizer configures it, on the CPU.

Corpora are drawn with numpy from a seed: ASCII prose, multi-byte Unicode,
runs of whitespace and digits, empty lines, a corpus of equal-count ties
whose id order and string order differ, one that tries for two pairs of one
merged string, and a vocabulary smaller than the specials plus the
alphabet.  Held, with no tolerance: the written ``tokenizer.json`` (bytes,
hence every vocabulary entry and merge in order), the ids of held-out text
through the port's ``HFTokenizer`` and through ``tokenizers``, and
``train.encoder``'s ``--phase tokenizer`` against the script's
``train_tokenizer`` (its ``WORKDIR``, ``CORPUS`` and ``CFG`` pointed at a
temporary directory; importing the script sets ``JAX_COMPILATION_CACHE_DIR``
only where it is unset, so it is set to the temporary directory first).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers  # noqa: E402

from raglite_tpu_torch.models.tokenizer import HFTokenizer  # noqa: E402
from raglite_tpu_torch.train import bpe  # noqa: E402
from raglite_tpu_torch.train import encoder as te  # noqa: E402
from raglite_tpu_torch.train.corpus import load_tokens  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPECIALS = ["<pad>", "<s>", "</s>", "<mask>"]


def reference(texts: list[str], vocab_size: int, path: Path) -> str:
    """``train_tokenizer``'s configuration, trained on ``texts`` and saved."""
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=SPECIALS, show_progress=False)
    tok.train_from_iterator(texts, trainer)
    tok.save(str(path))
    return path.read_text(encoding="utf-8")


def _words(rng, alphabet, n: int, lo: int = 1, hi: int = 9) -> list[str]:
    return ["".join(rng.choice(alphabet, int(rng.integers(lo, hi)))) for _ in range(n)]


def _prose(rng, n: int = 300) -> list[str]:
    """Sentences over a zipf-distributed vocabulary of ASCII words."""
    vocab = _words(rng, list("etaoinshrdlucmfwypvbgkqjxz"), 500, 2, 10)
    punct = [".", ",", ";", "?", "!", " -", "'s", "(x)", ":"]
    out = []
    for _ in range(n):
        words = [vocab[min(int(rng.zipf(1.3)), 500) - 1] for _ in range(int(rng.integers(3, 25)))]
        out.append(" ".join(w + (str(rng.choice(punct)) if rng.random() < 0.15 else "") for w in words).capitalize())
    return out


def _unicode(rng, n: int = 250) -> list[str]:
    """Words of Latin with accents, Greek, Cyrillic, CJK, Devanagari and emoji
    (2- to 4-byte UTF-8), some joined without spaces."""
    alphabet = list("aeiouéèüßøåñçΩλπжшщыї日本語中文字漢अआइक🙂🚀👍🏽€")
    vocab = _words(rng, alphabet, 200, 1, 6)
    return [("" if rng.random() < 0.2 else " ").join(rng.choice(vocab, int(rng.integers(1, 15)))) for _ in range(n)]


def _spaces_and_digits(rng, n: int = 250) -> list[str]:
    """Numbers and words between runs of spaces, tabs and newlines."""
    gaps = [" ", "  ", "   ", "\t", " \t ", "\n", "\n\n", " \n  ", "\r\n", "        "]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 12))):
            parts.append(str(int(rng.integers(0, 10 ** int(rng.integers(1, 7))))) if rng.random() < 0.5 else str(rng.choice(["ab", "abc", "x1", "v2.0"])))
            parts.append(str(rng.choice(gaps)))
        out.append("".join(parts[: -1 if rng.random() < 0.5 else None]))
    return out


def _empty_lines(rng, n: int = 200) -> list[str]:
    """Prose lines among empty strings, lone newlines and lone spaces."""
    prose = _prose(rng, n)
    return [str(rng.choice(["", "\n", " ", "  ", prose[i]], p=[0.2, 0.1, 0.1, 0.05, 0.55])) for i in range(n)]


def _ties(rng) -> list[str]:
    """Equal counts between pairs whose id order and string order differ:
    ``zz`` (ids of z, z) ties with ``ab`` and wins though ``ab`` sorts
    first; more such ties between merged tokens come from words drawn so
    that every word occurs equally often."""
    words = ["zz"] * 5 + ["ab"] * 3 + ["zzc", "abc"]
    base = ["zy", "ba", "yx", "ac", "zyx", "bac", "yz", "ca"]
    return words + [" ".join(base[i] for i in rng.permutation(len(base))) for _ in range(6)]


def _duplicates(rng, n: int = 300) -> list[str]:
    """Runs and repeats over a two- and three-letter alphabet (``aaaa``,
    ``abab``, ``aab`` / ``abb``), where two different pairs can spell one
    merged string."""
    return [" ".join(_words(rng, list("ab") if i % 2 else list("abc"), int(rng.integers(1, 6)), 1, 9)) for i in range(n)]


CORPORA = {
    "prose": (_prose, (500, 2000)),
    "unicode": (_unicode, (600,)),
    "spaces_digits": (_spaces_and_digits, (400,)),
    "empty_lines": (_empty_lines, (300,)),
    "ties": (_ties, (30, 200)),
    "duplicates": (_duplicates, (300,)),
    "vocab_below_alphabet": (_unicode, (20,)),
}
CASES = [(name, seed, vocab) for name, (_, sizes) in CORPORA.items() for vocab in sizes for seed in (0, 1)]


@pytest.mark.parametrize(("name", "seed", "vocab_size"), CASES)
def test_tokenizer_json_equals_bpe_trainer(tmp_path, name: str, seed: int, vocab_size: int) -> None:
    make, _ = CORPORA[name]
    texts = make(np.random.default_rng(seed))
    want = reference(texts, vocab_size, tmp_path / "want.json")
    spec = bpe.train_tokenizer(texts, vocab_size)
    bpe.write_tokenizer(spec, tmp_path / "got.json")
    assert json.loads(want) == spec
    assert (tmp_path / "got.json").read_text(encoding="utf-8") == want
    # Ids: specials, then the alphabet by code point, then the merges' tokens.
    vocab = spec["model"]["vocab"]
    assert [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])][:4] == SPECIALS
    merges = spec["model"]["merges"]
    alphabet = [t for t, i in sorted(vocab.items(), key=lambda kv: kv[1])[4 : len(vocab) - len(merges)]]
    assert alphabet == sorted(alphabet) and all(len(c) == 1 for c in alphabet)
    assert all(a in vocab and b in vocab and a + b in vocab for a, b in merges)
    if name == "vocab_below_alphabet":
        assert vocab_size < len(vocab) == 4 + len(alphabet) and merges == []
    elif len(vocab) < vocab_size:  # merged down to counts of 1, until no pair was left
        assert all(word in vocab for word in bpe.word_counts(texts))

    # The same ids through HFTokenizer and tokenizers on held-out text.
    rng = np.random.default_rng(seed + 100)
    held = make(rng)[:60] + _prose(rng, 20) + _unicode(rng, 20) + ["", " ", "<s> text </s> <mask>", "<pad><pad>x"]
    ours, theirs = HFTokenizer(str(tmp_path / "got.json")), Tokenizer.from_file(str(tmp_path / "want.json"))
    for text in held:
        assert ours.encode(text) == theirs.encode(text, add_special_tokens=False).ids, text


def test_ties_go_to_the_smaller_ids(tmp_path) -> None:
    spec = bpe.train_tokenizer(["zz"] * 5 + ["ab"] * 3 + ["zzc", "abc"], 30)
    vocab = spec["model"]["vocab"]
    assert [vocab[c] for c in "abczĠ"] == [4, 5, 6, 7, 8]  # Ġ (U+0120) after ASCII
    merges = [tuple(m) for m in spec["model"]["merges"]]
    assert merges == [("z", "z"), ("Ġ", "zz"), ("a", "b"), ("Ġ", "ab"), ("Ġzz", "c"), ("Ġab", "c")]
    # Merging goes on down to a count of 1 ("Ġzz c" and "Ġab c" occur once).
    assert json.loads(reference(["zz"] * 5 + ["ab"] * 3 + ["zzc", "abc"], 30, tmp_path / "t.json")) == spec


def test_word_counts_follow_byte_level() -> None:
    counts = bpe.word_counts(["", "a b", " a", "héllo  world\n", "12 345"])
    assert counts == {"Ġa": 2, "Ġb": 1, "ĠhÃ©llo": 1, "Ġ": 1, "Ġworld": 1, "Ċ": 1, "Ġ12": 1, "Ġ345": 1}


@pytest.fixture
def script(monkeypatch, tmp_path):
    """scripts/train_encoder.py as a module (a name of its own)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    spec = importlib.util.spec_from_file_location("train_encoder_script", ROOT / "scripts" / "train_encoder.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_corpus(directory: Path, texts: list[str]) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "train.jsonl", "w") as f:
        for i, text in enumerate(texts):
            f.write(json.dumps({"id": f"{i:016x}", "title": "", "text": text}) + "\n")
    return directory


def test_phase_tokenizer_equals_the_script(script, monkeypatch, tmp_path) -> None:
    rng = np.random.default_rng(7)
    texts = _prose(rng, 400) + _unicode(rng, 100) + _spaces_and_digits(rng, 50)
    corpus = _write_corpus(tmp_path / "corpus", texts)
    monkeypatch.setattr(script, "WORKDIR", tmp_path / "script")
    monkeypatch.setattr(script, "CORPUS", corpus)
    monkeypatch.setattr(script, "CFG", {**te.SIZES["small"], "vocab": 700})
    script.train_tokenizer()
    monkeypatch.setitem(te.SIZES, "small", {**te.SIZES["small"], "vocab": 700})
    work = tmp_path / "port"
    out = te.main(["--phase", "tokenizer", "--size", "small", "--device", "cpu", "--workdir", str(work), "--corpus", str(corpus)])
    assert out["tokenizer"]["vocab"] == 700
    assert (work / "tokenizer.json").read_bytes() == (tmp_path / "script" / "tokenizer.json").read_bytes()
    # A second call keeps the trained file.
    assert "tokenizer" not in te.main(["--phase", "tokenizer", "--size", "small", "--device", "cpu", "--workdir", str(work),
                                       "--corpus", str(corpus)])


def test_tokenizer_precedence(monkeypatch, tmp_path) -> None:
    """The token cache takes --tokenizer, else the workdir's trained file,
    else the packaged one; the export copies the one it took."""
    corpus = _write_corpus(tmp_path / "corpus", _prose(np.random.default_rng(3), 60))
    monkeypatch.setitem(te.SIZES, "small", {**te.SIZES["small"], "vocab": 400})
    texts = [json.loads(line)["text"] for line in open(corpus / "train.jsonl")]

    def cached_ids(work: Path, *extra: str) -> list[int]:
        te.main(["--phase", "tokens", "--size", "small", "--device", "cpu", "--workdir", str(work), "--corpus", str(corpus), *extra])
        return load_tokens(work / "tokens.npz")[0].tolist()

    def encoded(path: Path) -> list[int]:
        tok = HFTokenizer(str(path))
        return [i for text in texts for i in tok.encode(text)]

    assert cached_ids(tmp_path / "packaged") == encoded(te.PACKAGED_TOKENIZER)
    work = tmp_path / "trained"
    te.main(["--phase", "tokenizer", "--size", "small", "--device", "cpu", "--workdir", str(work), "--corpus", str(corpus)])
    assert cached_ids(work) == encoded(work / "tokenizer.json") != encoded(te.PACKAGED_TOKENIZER)
    (work / "tokens.npz").unlink()
    assert cached_ids(work, "--tokenizer", str(te.PACKAGED_TOKENIZER)) == encoded(te.PACKAGED_TOKENIZER)
    # The export takes the trained file.
    state = te.init_params(te.SIZES["small"])
    te.save_params(work / "mlm.npz", state, te.SIZES["small"])
    te.main(["--phase", "export", "--size", "small", "--device", "cpu", "--workdir", str(work), "--out", str(tmp_path / "e")])
    assert (tmp_path / "e" / "tokenizer.json").read_bytes() == (work / "tokenizer.json").read_bytes()
