"""The port's ``tokenizer.json`` reader (models/tokenizer.py:HFTokenizer)
against the ``tokenizers`` package, on files built here: a Qwen2-style
byte-level BPE (NFC, Qwen's Split pattern, ByteLevel without its regex), a
Llama-3-style one (``ignore_merges``, ``\\p{N}{1,3}``), SentencePiece-style
BPEs with ``byte_fallback`` (Prepend/Replace normalizers with the
Replace/ByteFallback/Fuse/Strip decoders, and Metaspace), a Unigram
(Metaspace, ``byte_fallback``), a pipeline of every Split behaviour, and the
JAX tests' own tokenizers (no pre-tokenizer or decoder).  Ids and decoded
text must be equal (exactly), on hypothesis text with added and special
tokens mixed in and on random ids; the special ids equal the JAX package's
``HFTokenizer``'s."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers  # noqa: E402

from raglite_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer  # noqa: E402
from raglite_tpu_torch.models.tokenizer import HFTokenizer, load_tokenizer  # noqa: E402

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


def _corpus() -> list[str]:
    return [line for p in sorted(ROOT.glob("*.md")) for line in p.read_text(encoding="utf-8").splitlines() if line]


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


KINDS = {
    "qwen2": lambda: _byte_level(QWEN_SPLIT),
    "llama3": lambda: _byte_level(LLAMA3_SPLIT, ignore_merges=True),
    "sentencepiece_bpe": _sentencepiece_bpe,
    "metaspace_bpe": _metaspace_bpe,
    "unigram": _unigram,
    "splits": _splits,
    "jax_tests_bpe": _jax_tests_bpe,
    "jax_tests_chat": _jax_tests_chat,
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
    st.one_of(st.sampled_from(PIECES), st.text(max_size=12), st.text(alphabet="ab cé1.,-\n", max_size=12)),
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
        ("normalizer", {"type": "Precompiled", "precompiled_charsmap": ""}, "Precompiled"),
        ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
        ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}, "WordPiece"),
    ]:
        (tmp_path / "t.json").write_text(json.dumps({**spec, key: value}))
        with pytest.raises(NotImplementedError, match=name):
            HFTokenizer(str(tmp_path / "t.json"))


def test_chip_smokes_hand_made_tokenizers_match_tokenizers(tmp_path) -> None:
    """The tokenizer.json files chip_smoke.py writes by hand for its
    Qwen3-4B-shaped and bge-m3-shaped checkpoints (the card has no
    ``tokenizers``) read the same in both readers, specials at Qwen's ids."""
    import importlib

    chip_smoke = importlib.import_module("chip_smoke")
    texts = chip_smoke._markdown_texts()
    sample = "\n\n".join(texts)[:20_000] + "<|im_start|>user\nhi 🙂<|im_end|>"
    for name, spec in (("qwen", chip_smoke.qwen_tokenizer_json(texts, merges=500)), ("unigram", chip_smoke.unigram_tokenizer_json(texts))):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(spec))
        ref, ours = Tokenizer.from_file(str(path)), HFTokenizer(str(path))
        want = ref.encode(sample, add_special_tokens=False).ids
        assert ours.encode(sample) == want, name
        assert ours.decode(want) == ref.decode(want), name
        if name == "qwen":
            assert [ours.token_id(t) for t in CHATML] == [151643, 151644, 151645] == [ref.token_to_id(t) for t in CHATML]
