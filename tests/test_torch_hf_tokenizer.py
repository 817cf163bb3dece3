"""The port's ``tokenizer.json`` reader (models/tokenizer.py:HFTokenizer)
against the ``tokenizers`` package, on files built here: a Qwen2-style
byte-level BPE (NFC, Qwen's Split pattern, ByteLevel without its regex), a
Llama-3-style one (``ignore_merges``, ``\\p{N}{1,3}``), SentencePiece-style
BPEs with ``byte_fallback`` (Prepend/Replace normalizers with the
Replace/ByteFallback/Fuse/Strip decoders, and Metaspace), a Unigram
(Metaspace, ``byte_fallback``), a pipeline of every Split behaviour, the
JAX tests' own tokenizers (no pre-tokenizer or decoder), a BERT WordPiece
(BertNormalizer, BertPreTokenizer, the WordPiece decoder) and an XLM-R-style
Unigram behind a ``Precompiled`` charsmap built here.  Ids and decoded text
must be equal (exactly), on hypothesis text with added and special tokens
mixed in and on random ids; the special ids equal the JAX package's
``HFTokenizer``'s.  The Unicode properties the components read are held to
``tokenizers``' on whole planes of code points, and the grapheme clusters
``Precompiled`` looks up on hypothesis text of combining marks, Hangul jamo,
regional indicators and ZWJ emoji."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors, trainers  # noqa: E402

from raglite_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer  # noqa: E402
from raglite_tpu_torch.models.tokenizer import HFTokenizer, _normalizer, _pre_tokenizer, load_tokenizer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
QWEN_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
LLAMA3_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
CHATML = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
#: Text pieces the hypothesis strings are built from, beside random text.
PIECES = [
    *CHATML, "<tool_call>", "</tool_call>", " <mark> ", "word", "Hello", " don't", "I'LL", "123456", "١٢٣",
    "日本語", "ümlaut", "ﬁ", "Å", "\r\n", "\n\n", "\t", "   ", "🙂", "x²", "▁", "<0x41>", "<unk>",
]


#: The Markdown the tokenizers train on: files the port never edits, so that
#: a documentation change cannot retrain them (and change what a random
#: model built on them answers).
CORPUS = ("ADVICE.md", "BASELINE.md", "MIGRATION.md", "PAPER.md", "PARITY.md", "SURVEY.md", "VERDICT.md")


def _corpus() -> list[str]:
    return [line for f in CORPUS for line in (ROOT / f).read_text(encoding="utf-8").splitlines() if line]


def _bpe(pre, *, normalizer=None, vocab: int = 1200, special=CHATML, alphabet=None) -> dict:
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre
    trainer = trainers.BpeTrainer(
        vocab_size=vocab, special_tokens=list(special), show_progress=False,
        initial_alphabet=alphabet or [],
    )
    tok.train_from_iterator(_corpus(), trainer)
    return json.loads(tok.to_str())


def _byte_level(split: str, *, ignore_merges: bool = False) -> dict:
    spec = _bpe(
        pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(split), behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
        ]),
        normalizer=normalizers.NFC(), alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}
    spec["model"]["ignore_merges"] = ignore_merges
    return spec


def _with_bytes(spec: dict) -> dict:
    """Append the 256 ``<0xXX>`` tokens to a BPE or Unigram vocabulary and
    turn on byte_fallback."""
    model = spec["model"]
    if model["type"] == "BPE":
        n = len(model["vocab"])
        for b in range(256):
            model["vocab"].setdefault(f"<0x{b:02X}>", n + b)
    else:
        low = min(s for _, s in model["vocab"])
        model["vocab"].extend([f"<0x{b:02X}>", low] for b in range(256))
    model["byte_fallback"] = True
    return spec


def _sentencepiece_bpe() -> dict:
    """Llama-2 / Gemma layout: Prepend + Replace normalizers, no
    pre-tokenizer, byte fallback, and Replace/ByteFallback/Fuse/Strip."""
    spec = _with_bytes(_bpe(pre_tokenizers.Metaspace(), special=["<unk>", "<s>", "</s>"]))
    spec["model"].update(unk_token="<unk>", fuse_unk=True)
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"},
        {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
    ]}
    spec["pre_tokenizer"] = None
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0},
    ]}
    return spec


def _metaspace_bpe() -> dict:
    spec = _with_bytes(_bpe(pre_tokenizers.Metaspace(prepend_scheme="first"), special=["<unk>", "<s>", "</s>"]))
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "ByteFallback"},
        {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True},
    ]}
    return spec


def _unigram() -> dict:
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.NFKC()
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always")
    trainer = trainers.UnigramTrainer(
        vocab_size=600, special_tokens=["<pad>", "<s>", "</s>", "<unk>"], unk_token="<unk>", show_progress=False,
    )
    tok.train_from_iterator(_corpus(), trainer)
    spec = _with_bytes(json.loads(tok.to_str()))
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "ByteFallback"}, {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
    ]}
    return spec


def _splits() -> dict:
    """Every Split behaviour, an inverted pattern and a string pattern,
    before a ByteLevel that keeps its regex and prefix space."""
    spec = _bpe(pre_tokenizers.ByteLevel(add_prefix_space=True), alphabet=pre_tokenizers.ByteLevel.alphabet())
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": "[,.;]"}, "behavior": "MergedWithPrevious", "invert": False},
        {"type": "Split", "pattern": {"String": "--"}, "behavior": "Removed", "invert": False},
        {"type": "Split", "pattern": {"Regex": r"\p{N}"}, "behavior": "Contiguous", "invert": False},
        {"type": "Split", "pattern": {"Regex": r"[^\s\p{L}]+"}, "behavior": "MergedWithNext", "invert": True},
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
    ]}
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True}
    return spec


def _jax_tests_bpe() -> dict:
    """tests/test_pretrained_loaders.py's encoder stand-in: a-z, no merges."""
    return json.loads(Tokenizer(models.BPE(vocab={chr(97 + i): i for i in range(26)}, merges=[])).to_str())


def _jax_tests_chat() -> dict:
    """tests/test_pretrained_loaders.py's chat tokenizer: byte-named ids,
    ChatML words and a Split on spaces, no decoder."""
    vocab = {f"<0x{i:02X}>": i for i in range(250)}
    vocab.update({"<|im_start|>": 250, "<|im_end|>": 251, "<|endoftext|>": 252, "hello": 253, "world": 254, " ": 255})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.Split(" ", behavior="merged_with_next")
    return json.loads(tok.to_str())


def _bert_wordpiece() -> dict:
    """bge-base / MiniLM layout: BertNormalizer (lowercase, accents stripped
    by default), BertPreTokenizer, a WordPiece vocabulary trained on CORPUS
    with BERT's specials, the [CLS]/[SEP] template and the WordPiece
    decoder."""
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    trainer = trainers.WordPieceTrainer(
        vocab_size=1500, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"], show_progress=False,
    )
    tok.train_from_iterator(_corpus(), trainer)
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1", special_tokens=[("[CLS]", 2), ("[SEP]", 3)],
    )
    tok.decoder = decoders.WordPiece(prefix="##", cleanup=True)
    return json.loads(tok.to_str())


#: Characters of the grapheme tests: combining marks (one, two, enclosing),
#: Hangul jamo and syllables, regional indicators, emoji with skin tones and
#: ZWJ, Prepend and spacing marks, CR LF and other controls, and NFKC folds.
GRAPHEME_ALPHABET = (
    "aeiAE\u0301\u0308\u0327\u20dd\u1100\u1161\u11a8\uac00\uac01\U0001f1e9\U0001f1ea\U0001f1eb"
    "\U0001f44d\U0001f3fd\u200d\U0001f469\U0001f4bb\u00a9\u2764\ufe0f\u0600\u0903\u0915\u094d"
    "\r\n\t \u3000\ufb01\u212b\u00b2\uff21\u2026\u00e9\u00c5\u0130\u01c4"
)


def _charsmap(mapping: dict[str, str]) -> str:
    import base64
    import importlib

    return base64.b64encode(importlib.import_module("chip_smoke").precompiled_charsmap(mapping)).decode()


def _xlmr_precompiled() -> dict:
    """XLM-R's normalizer layout (Precompiled, then Replace of space runs)
    before the Unigram of ``_unigram``: an NFKC-style charsmap over the
    characters of CORPUS, PIECES and GRAPHEME_ALPHABET, with multi-character
    keys (base + mark, a jamo pair, an emoji with a skin tone)."""
    import unicodedata

    spec = _unigram()
    chars = {c for text in [*_corpus(), *PIECES, GRAPHEME_ALPHABET] for c in text}
    mapping = {c: unicodedata.normalize("NFKC", c) for c in chars if unicodedata.normalize("NFKC", c) != c}
    mapping.update({"e\u0301": "\u00e9", "A\u030a": "\u00c5", "\u1100\u1161": "\uac00", "\u0915\u094d": "k",
                    "\U0001f44d\U0001f3fd": "+1", "\u3000": " ", "\u00a9": "(c)", "i": "i"})
    spec["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": _charsmap(mapping)},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "},
    ]}
    return spec


KINDS = {
    "qwen2": lambda: _byte_level(QWEN_SPLIT),
    "llama3": lambda: _byte_level(LLAMA3_SPLIT, ignore_merges=True),
    "sentencepiece_bpe": _sentencepiece_bpe,
    "metaspace_bpe": _metaspace_bpe,
    "unigram": _unigram,
    "splits": _splits,
    "jax_tests_bpe": _jax_tests_bpe,
    "jax_tests_chat": _jax_tests_chat,
    "bert_wordpiece": _bert_wordpiece,
    "xlmr_precompiled": _xlmr_precompiled,
}


def write_tokenizer(kind: str, out_dir: Path, *, config: dict | None = None) -> Path:
    """``out_dir/tokenizer.json`` of one KINDS entry, with added tokens: the
    ChatML specials, a non-special ``<tool_call>`` pair, a normalized token
    with lstrip/rstrip and a single-word one."""
    spec = KINDS[kind]()
    tok = Tokenizer.from_str(json.dumps(spec))
    if not kind.startswith("jax_tests"):
        tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in CHATML])
        tok.add_tokens([
            AddedToken("<tool_call>", special=False, normalized=False),
            AddedToken("</tool_call>", special=False, normalized=False),
            AddedToken("<mark>", special=False, normalized=True, lstrip=True, rstrip=True),
            AddedToken("word", special=False, normalized=False, single_word=True),
        ])
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "tokenizer.json"
    tok.save(str(path))
    if config is not None:
        (out_dir / "config.json").write_text(json.dumps(config))
    return path


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request, tmp_path_factory):
    path = write_tokenizer(request.param, tmp_path_factory.mktemp(request.param))
    return request.param, Tokenizer.from_file(str(path)), HFTokenizer(str(path))


_TEXT = st.lists(
    st.one_of(
        st.sampled_from(PIECES), st.text(max_size=12), st.text(alphabet="ab cé1.,-\n", max_size=12),
        st.text(alphabet=GRAPHEME_ALPHABET, max_size=8),
    ),
    max_size=8,
).map("".join)


@settings(max_examples=60, deadline=None, derandomize=True, suppress_health_check=list(HealthCheck))
@given(text=_TEXT)
def test_ids_and_text_match_tokenizers(pair, text: str) -> None:
    kind, ref, tok = pair
    want = ref.encode(text, add_special_tokens=False).ids
    assert tok.encode(text) == want, (kind, text)
    assert tok.decode(want) == ref.decode(want), (kind, text)


def test_repo_markdown_and_random_ids_match_tokenizers(pair) -> None:
    """Whole Markdown files of the repo, then random id sequences (which
    decode incomplete UTF-8 and specials)."""
    kind, ref, tok = pair
    for p in sorted(ROOT.glob("*.md"))[:4]:
        text = p.read_text(encoding="utf-8")[:20_000]
        assert tok.encode(text) == ref.encode(text, add_special_tokens=False).ids, (kind, p.name)
    rng = np.random.default_rng(0)
    n = ref.get_vocab_size()
    assert tok.vocab_size == n
    for _ in range(50):
        ids = rng.integers(0, n, rng.integers(0, 12)).tolist()
        assert tok.decode(ids) == ref.decode(ids), (kind, ids)


@pytest.mark.parametrize("eos", [7, [7, 8], None])
def test_special_ids_equal_jax(tmp_path, eos) -> None:
    """PAD/BOS/EOS, every eos id, the vocabulary size and ``token_id`` equal
    the JAX package's HFTokenizer's, from config.json or by name."""
    config = {"pad_token_id": 3} | ({} if eos is None else {"eos_token_id": eos})
    path = write_tokenizer("qwen2", tmp_path, config=config)
    ours, theirs = load_tokenizer(str(path)), jax_load_tokenizer(str(path))
    for name in ("PAD", "BOS", "EOS", "EOS_IDS", "vocab_size"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for token in [*CHATML, "<tool_call>", "<|eot_id|>", "Hello", "Ġthe"]:
        assert ours.token_id(token) == theirs.token_id(token), token


def test_missing_file_and_unknown_components(tmp_path) -> None:
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "nope" / "tokenizer.json"))
    with pytest.warns(UserWarning, match="byte tokenizer"):
        assert load_tokenizer(str(tmp_path / "nope" / "tokenizer.json"), required=False).encode("a") == [100]
    spec = _jax_tests_bpe()
    for key, value, name in [
        ("normalizer", {"type": "Nmt"}, "Nmt"),
        ("pre_tokenizer", {"type": "CharDelimiterSplit", "delimiter": "-"}, "CharDelimiterSplit"),
        ("decoder", {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|", "cleanup": True}, "CTC"),
    ]:
        (tmp_path / "t.json").write_text(json.dumps({**spec, key: value}))
        with pytest.raises(NotImplementedError, match=name):
            HFTokenizer(str(tmp_path / "t.json"))


#: Code points of the whole-plane sweeps: planes 0-3 and 14 (the others are
#: unassigned or private use).
_SWEEP = [cp for cp in [*range(0x40000), *range(0xE0000, 0xF0000)] if not 0xD800 <= cp <= 0xDFFF]


@pytest.mark.parametrize("spec", [
    {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True, "strip_accents": None, "lowercase": True},
    {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": False, "strip_accents": True, "lowercase": False},
    {"type": "Lowercase"}, {"type": "StripAccents"},
    {"type": "NFD"}, {"type": "NFKD"}, {"type": "NFC"}, {"type": "NFKC"},
], ids=["bert", "bert_strip", "lowercase", "strip_accents", "nfd", "nfkd", "nfc", "nfkc"])
def test_normalizers_match_tokenizers_on_every_code_point(spec: dict) -> None:
    """Each code point, between two letters and cut off by newlines: the
    port's Unicode properties (models/unicode_props.py and its tables) give
    ``tokenizers``' result on all of them."""
    ref = Tokenizer.from_str(json.dumps({**json.loads(Tokenizer(models.BPE()).to_str()), "normalizer": spec})).normalizer
    ours = _normalizer(spec)
    for start in range(0, len(_SWEEP), 65536):
        text = "".join(f"a{chr(cp)}b\n" for cp in _SWEEP[start : start + 65536])
        want = ref.normalize_str(text)
        got = ours(text)
        if got != want:
            bad = next(cp for cp in _SWEEP[start : start + 65536] if ours(f"a{chr(cp)}b") != ref.normalize_str(f"a{chr(cp)}b"))
            raise AssertionError((spec["type"], hex(bad), ours(f"a{chr(bad)}b"), ref.normalize_str(f"a{chr(bad)}b")))


@pytest.mark.parametrize("kind", ["BertPreTokenizer", "Whitespace"])
def test_pre_tokenizers_match_tokenizers_on_every_code_point(kind: str) -> None:
    ref = getattr(pre_tokenizers, kind)()
    ours = _pre_tokenizer({"type": kind})
    for start in range(0, len(_SWEEP), 65536):
        text = "".join(f"a{chr(cp)}b " for cp in _SWEEP[start : start + 65536])
        want = [piece for piece, _ in ref.pre_tokenize_str(text)]
        assert [piece for piece, _ in ours([(text, True)])] == want, kind


def test_grapheme_clusters_match_tokenizers_on_every_code_point() -> None:
    """What follows a letter joins its cluster (Extend, ZWJ, SpacingMark),
    and what follows (c) ZWJ joins by GB11 (Extended_Pictographic): the
    cluster, looked up whole, loses what follows its first character."""
    spec = {"type": "Precompiled", "precompiled_charsmap": _charsmap({"a": "X", "\u00a9": "Y"})}
    ref = Tokenizer.from_str(json.dumps({**json.loads(Tokenizer(models.BPE()).to_str()), "normalizer": spec})).normalizer
    ours = _normalizer(spec)
    for start in range(0, len(_SWEEP), 65536):
        text = "".join(f"a{chr(cp)}\n\u00a9\u200d{chr(cp)}\n" for cp in _SWEEP[start : start + 65536])
        assert ours(text) == ref.normalize_str(text)


@pytest.fixture(scope="module")
def grapheme_normalizers():
    """A charsmap with a key for every character of the alphabet (so that
    every cluster's first character is a key: a cluster of fewer than 6
    bytes shows as one replacement) and multi-character keys."""
    mapping = {c: f"<{ord(c):x}>" for c in GRAPHEME_ALPHABET}
    mapping.update({"e\u0301": "E1", "\u1100\u1161": "GA", "\U0001f1e9\U0001f1ea": "DE", "\r\n": "CRLF"})
    spec = {"type": "Precompiled", "precompiled_charsmap": _charsmap(mapping)}
    ref = Tokenizer.from_str(json.dumps({**json.loads(Tokenizer(models.BPE()).to_str()), "normalizer": spec})).normalizer
    return ref, _normalizer(spec)


@settings(max_examples=300, deadline=None, derandomize=True, suppress_health_check=list(HealthCheck))
@given(text=st.text(alphabet=GRAPHEME_ALPHABET, max_size=24))
def test_precompiled_graphemes_match_tokenizers(grapheme_normalizers, text: str) -> None:
    ref, ours = grapheme_normalizers
    assert ours(text) == ref.normalize_str(text), text


def test_chip_smokes_hand_made_tokenizers_match_tokenizers(tmp_path) -> None:
    """The tokenizer.json files chip_smoke.py writes by hand for its
    Qwen3-4B-shaped, bge-m3-shaped (Unigram behind XLM-R's normalizer: a
    Precompiled charsmap and a Replace) and bge-base-shaped (WordPiece)
    checkpoints (the card has no ``tokenizers``) read the same in both
    readers, specials at Qwen's and BERT's ids."""
    import importlib

    chip_smoke = importlib.import_module("chip_smoke")
    texts = chip_smoke._markdown_texts()
    sample = "\n\n".join(texts)[:20_000] + "<|im_start|>user\nhi 🙂<|im_end|> Ｆｕｌｌ　ｗｉｄｔｈ … ﬁne café [CLS] x"
    specs = {
        "qwen": chip_smoke.qwen_tokenizer_json(texts, merges=500),
        "unigram": chip_smoke.unigram_tokenizer_json(texts),
        "wordpiece": chip_smoke.wordpiece_tokenizer_json(texts),
    }
    assert specs["unigram"]["normalizer"]["normalizers"][0]["type"] == "Precompiled"
    for name, spec in specs.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(spec))
        ref, ours = Tokenizer.from_file(str(path)), HFTokenizer(str(path))
        want = ref.encode(sample, add_special_tokens=False).ids
        assert ours.encode(sample) == want, name
        assert ours.decode(want) == ref.decode(want), name
        if name == "qwen":
            assert [ours.token_id(t) for t in CHATML] == [151643, 151644, 151645] == [ref.token_to_id(t) for t in CHATML]
        if name == "wordpiece":
            bert = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
            assert {t: ours.token_id(t) for t in bert} == bert == {t: ref.token_to_id(t) for t in bert}
            assert ours.vocab_size == ref.get_vocab_size() == 30_522
            assert ref.normalizer.normalize_str(sample) != sample and 100 not in want[:2000]
