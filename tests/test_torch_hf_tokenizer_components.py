"""The port's ``tokenizer.json`` reader (models/tokenizer.py:HFTokenizer) on
the components tests/test_torch_hf_tokenizer.py does not cover, against the
``tokenizers`` package (0.22.2): the ``truncation`` and ``padding`` of a
file, the Nmt, Strip and ByteLevel normalizers, the WhitespaceSplit,
Punctuation, Digits, CharDelimiterSplit, UnicodeScripts and FixedLength
pre-tokenizers, the WordLevel model, BPE's continuing-subword prefix and
end-of-word suffix (and dropout 1, which skips every merge), the BPEDecoder
and CTC decoders, and Split and Replace patterns with Oniguruma's property
names (``\\p{Han}``, ``\\p{Letter}``, ``\\P{..}`` and ``\\S`` inside a
class).

Ids and decoded text must be equal (exactly) on hypothesis text with added
and special tokens mixed in, and on random ids; every Unicode property the
new components read equals ``tokenizers``' on whole planes of code points;
and a ``flax:<dir>`` encoder whose tokenizer truncates and pads counts and
embeds as the JAX package's does (counts and ids equal, token states within
1e-4, tests/test_torch_pretrained.py's tolerance against the JAX package).
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers  # noqa: E402

from raglite_tpu_torch.models import unicode_props as U  # noqa: E402
from raglite_tpu_torch.models import unicode_tables as T  # noqa: E402
from raglite_tpu_torch.models.tokenizer import HFTokenizer, _normalizer, _pattern, _pre_tokenizer  # noqa: E402

from tests.test_torch_hf_tokenizer import _SWEEP, CHATML, GRAPHEME_ALPHABET, PIECES, _corpus, _with_bytes  # noqa: E402

#: Text beyond the other file's PIECES: scripts side by side, digits of
#: several systems, controls Nmt maps, delimiters and CTC's words.
MORE_PIECES = [
    "あいう漢字カタカナ ", "ー", "Hello 世界 мир!", "Ελληνικά", "٣٤", "१२", "Ⅻ", "½", "x​y", "﻿", "▁",
    "\x01\x7f\x9f", "a-b--c", "|", "<pad>", "[PAD]", "  lead", "trail  ", "　wide　", "don't", "1,000.5",
]


def _trained(model, trainer, *, normalizer=None, pre=None, decoder=None, corpus=None) -> dict:
    tok = Tokenizer(model)
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre
    tok.train_from_iterator(corpus or _corpus(), trainer)
    tok.decoder = decoder
    return json.loads(tok.to_str())


def _wordlevel_splits() -> dict:
    """WordLevel behind WhitespaceSplit, Punctuation and Digits."""
    return _trained(
        models.WordLevel(unk_token="<unk>"),
        trainers.WordLevelTrainer(vocab_size=2000, special_tokens=["<pad>", "<unk>"], show_progress=False),
        pre=pre_tokenizers.Sequence([
            pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Punctuation(behavior="isolated"),
            pre_tokenizers.Digits(individual_digits=True),
        ]),
    )


def _punctuation_behaviours() -> dict:
    """Punctuation merged with the previous piece, Digits contiguous, a
    CharDelimiterSplit: WordLevel over what they leave."""
    return _trained(
        models.WordLevel(unk_token="<unk>"),
        trainers.WordLevelTrainer(vocab_size=2000, special_tokens=["<pad>", "<unk>"], show_progress=False),
        pre=pre_tokenizers.Sequence([
            pre_tokenizers.CharDelimiterSplit(" "), pre_tokenizers.Punctuation(behavior="merged_with_previous"),
            pre_tokenizers.Digits(individual_digits=False), pre_tokenizers.CharDelimiterSplit("-"),
        ]),
    )


def _bpe_affixes(*, byte_fallback: bool = False, dropout: float | None = None) -> dict:
    """BPE trained with a continuing-subword prefix and an end-of-word
    suffix, with the BPEDecoder."""
    spec = _trained(
        models.BPE(unk_token="<unk>", continuing_subword_prefix="##", end_of_word_suffix="</w>"),
        trainers.BpeTrainer(
            vocab_size=1500, special_tokens=["<unk>"], continuing_subword_prefix="##", end_of_word_suffix="</w>",
            show_progress=False,
        ),
        pre=pre_tokenizers.Whitespace(), decoder=decoders.BPEDecoder(suffix="</w>"),
    )
    if byte_fallback:
        spec = _with_bytes(spec)
    spec["model"]["dropout"] = dropout
    return spec


def _ctc() -> dict:
    """A CTC character vocabulary (wav2vec2's layout): spaces as ``|``, one
    character a piece (FixedLength 1), the CTC decoder."""
    chars = sorted({c for line in _corpus() for c in line.lower()} - {" "})
    vocab = {"<pad>": 0, "<unk>": 1, "|": 2, **{c: i + 3 for i, c in enumerate(chars)}}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.normalizer = normalizers.Sequence([normalizers.Lowercase(), normalizers.Replace(" ", "|")])
    tok.pre_tokenizer = pre_tokenizers.FixedLength(length=1)
    tok.decoder = decoders.CTC(pad_token="<pad>", word_delimiter_token="|", cleanup=True)
    return json.loads(tok.to_str())


def _scripts() -> dict:
    """UnicodeScripts, then FixedLength 4, before a WordPiece trained on the
    corpus and the scripts of MORE_PIECES."""
    return _trained(
        models.WordPiece(unk_token="[UNK]"),
        trainers.WordPieceTrainer(vocab_size=1500, special_tokens=["[PAD]", "[UNK]"], show_progress=False),
        pre=pre_tokenizers.Sequence([pre_tokenizers.UnicodeScripts(), pre_tokenizers.FixedLength(length=4)]),
        decoder=decoders.WordPiece(), corpus=[*_corpus(), *MORE_PIECES * 20],
    )


def _nmt_strip_byte_level() -> dict:
    """Nmt, Strip and ByteLevel normalizers before a byte-level BPE cut at
    byte-level spaces."""
    return _trained(
        models.BPE(),
        trainers.BpeTrainer(vocab_size=1200, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False),
        normalizer=normalizers.Sequence([normalizers.Nmt(), normalizers.Strip(left=True, right=False), normalizers.ByteLevel()]),
        pre=pre_tokenizers.Split("Ġ", behavior="merged_with_next"), decoder=decoders.ByteLevel(),
    )


def _split_properties() -> dict:
    """Split and Replace patterns with script names, long category names,
    negations and \\S inside classes."""
    return _trained(
        models.BPE(unk_token="<unk>"),
        trainers.BpeTrainer(vocab_size=1200, special_tokens=["<unk>"], show_progress=False),
        normalizer=normalizers.Sequence([
            normalizers.Replace(Regex(r"\p{Mark}+"), ""), normalizers.Replace(Regex(r"[\P{Any}\p{Cc}]"), " "),
        ]),
        pre=pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(r"\p{Han}+|\p{Hiragana}+|\p{Katakana}+"), behavior="isolated"),
            pre_tokenizers.Split(Regex(r"\p{Latin}+|\p{Cyrillic}+|\p{Greek}+"), behavior="isolated"),
            pre_tokenizers.Split(Regex(r"[^\S\n]+"), behavior="removed"),
            pre_tokenizers.Split(Regex(r"[^\P{Letter}\p{Lu}]+|[\p{Decimal Number}\p{Uppercase_Letter}]"), behavior="isolated"),
            pre_tokenizers.Split(Regex(r"\p{^Alphabetic}+"), behavior="merged_with_previous"),
            pre_tokenizers.Split(Regex(r"\w{1,3}|[[:punct:]&&[^.]]|\d"), behavior="isolated"),
        ]),
        corpus=[*_corpus(), *MORE_PIECES * 20],
    )


def _truncated(truncation: dict | None, padding: dict | None) -> dict:
    """The WordLevel of _wordlevel_splits with a truncation and a padding."""
    spec = _wordlevel_splits()
    spec["truncation"], spec["padding"] = truncation, padding
    return spec


def _trunc(max_length: int, direction: str = "Right", strategy: str = "LongestFirst", stride: int = 0) -> dict:
    return {"direction": direction, "max_length": max_length, "strategy": strategy, "stride": stride}


def _pad(strategy, direction: str = "Right", multiple: int | None = None, pad_id: int = 0) -> dict:
    return {"strategy": strategy, "direction": direction, "pad_to_multiple_of": multiple, "pad_id": pad_id,
            "pad_type_id": 0, "pad_token": "<pad>"}


KINDS = {
    "wordlevel_splits": _wordlevel_splits,
    "punctuation_behaviours": _punctuation_behaviours,
    "bpe_affixes": _bpe_affixes,
    "bpe_affixes_bytes": lambda: _bpe_affixes(byte_fallback=True),
    "bpe_dropout_one": lambda: _bpe_affixes(dropout=1.0),
    "ctc": _ctc,
    "scripts": _scripts,
    "nmt_strip_byte_level": _nmt_strip_byte_level,
    "split_properties": _split_properties,
    "trunc_right": lambda: _truncated(_trunc(5), None),
    "trunc_left_pad_fixed": lambda: _truncated(_trunc(6, "Left", "OnlyFirst", stride=2), _pad({"Fixed": 9}, pad_id=7)),
    "pad_left_multiple": lambda: _truncated(None, _pad("BatchLongest", "Left", multiple=4)),
    "trunc_pad_fixed_multiple": lambda: _truncated(_trunc(7, "Right"), _pad({"Fixed": 6}, "Right", multiple=4, pad_id=1)),
    "trunc_zero": lambda: _truncated(_trunc(0), None),
}


def write(kind: str, out_dir: Path) -> Path:
    """``out_dir/tokenizer.json`` of one KINDS entry, with the ChatML
    specials and non-special added tokens (one normalized, with lstrip and
    rstrip), as tests/test_torch_hf_tokenizer.py adds them."""
    tok = Tokenizer.from_str(json.dumps(KINDS[kind]()))
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in CHATML])
    tok.add_tokens([
        AddedToken("<tool_call>", special=False, normalized=False),
        AddedToken("<mark>", special=False, normalized=True, lstrip=True, rstrip=True),
    ])
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "tokenizer.json"
    tok.save(str(path))
    return path


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request, tmp_path_factory):
    path = write(request.param, tmp_path_factory.mktemp(request.param))
    return request.param, Tokenizer.from_file(str(path)), HFTokenizer(str(path))


_TEXT = st.lists(
    st.one_of(
        st.sampled_from(PIECES + MORE_PIECES), st.text(max_size=12), st.text(alphabet="ab cé1٣.,-|\n", max_size=12),
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


def test_markdown_and_random_ids_match_tokenizers(pair) -> None:
    """A Markdown file of the repo, then random id sequences (specials,
    pads and incomplete UTF-8 among them)."""
    kind, ref, tok = pair
    text = "\n\n".join(_corpus())[:8_000] + "".join(MORE_PIECES)
    assert tok.encode(text) == ref.encode(text, add_special_tokens=False).ids, kind
    rng = np.random.default_rng(0)
    n = ref.get_vocab_size()
    assert tok.vocab_size == n
    for _ in range(50):
        ids = rng.integers(0, n, rng.integers(0, 12)).tolist()
        assert tok.decode(ids) == ref.decode(ids), (kind, ids)


@pytest.mark.parametrize(("truncation", "padding", "want"), [
    # The cases a WordLevel with a = 2, b = 3 gives (tokenizers 0.22.2).
    (_trunc(3, "Left"), None, [2, 3, 3]),
    (_trunc(3, "Left"), _pad("BatchLongest", "Left", multiple=4), [0, 2, 3, 3]),
    (_trunc(3, "Right", "OnlyFirst"), _pad({"Fixed": 4}, pad_id=9), [2, 3, 2, 9]),
    (_trunc(0, "Left", stride=3), None, []),
    (None, _pad({"Fixed": 3}), [2, 3, 2, 3, 3]),
    (_trunc(9, strategy="OnlySecond", stride=9), None, [2, 3, 2, 3, 3]),
])
def test_truncation_and_padding_cases(tmp_path, truncation, padding, want) -> None:
    tok = Tokenizer(models.WordLevel(vocab={"<pad>": 0, "<unk>": 1, "a": 2, "b": 3}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    spec = json.loads(tok.to_str()) | {"truncation": truncation, "padding": padding}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    ref = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    assert ref.encode("a b a b b", add_special_tokens=False).ids == want
    assert HFTokenizer(str(tmp_path / "tokenizer.json")).encode("a b a b b") == want


@pytest.mark.parametrize("truncation", [_trunc(3, strategy="OnlySecond"), _trunc(3, stride=3)])
def test_truncation_that_fails_in_tokenizers_fails(tmp_path, truncation) -> None:
    """OnlySecond of one sequence, and a stride not below max_length, fail
    in ``tokenizers`` where a cut is due, and so in the port."""
    path = write("trunc_right", tmp_path)
    spec = json.loads(path.read_text()) | {"truncation": truncation}
    path.write_text(json.dumps(spec))
    ref, tok = Tokenizer.from_file(str(path)), HFTokenizer(str(path))
    with pytest.raises(BaseException):  # noqa: B017, PT011 (a Rust panic is a BaseException)
        ref.encode("one two three four", add_special_tokens=False)
    with pytest.raises(ValueError):
        tok.encode("one two three four")
    assert tok.encode("one") == ref.encode("one", add_special_tokens=False).ids


@pytest.mark.parametrize(("pattern", "text"), [
    ("[]a]", "a]b"), ("[^]a]", "a]b"), ("[a-]", "a-b"), (r"[\x41-\x43]", "ABCD"), (r"\x{41}\u0042", "ABC"),
    (r"\z", "ab\n"), (r"b\Z", "ab\n"), ("[a-c&&b-d]", "abcd"), ("[^a-c&&b]", "abcd"), ("[a&&]", "ab"),
    ("[&&a]", "ab"), ("[^&&]", "a&b"), (r"[\w-z]", "a-z"), (r"[a-\w]", "a-z"), (r"[\]]", "a]"), (r"[a\-z]", "a-bz"),
    ("[a[bc]d]", "abcde"), ("[[:alpha:]&&[^a]]", "abc"), ("[:alpha:]", "a:p"), (r"(?i:[a-c])+", "ABCabcd"),
    (r"[\t\n.]", "a\tb\n."), (r"\h+", "0fFg"), (r"\b\w+\b", "h\u00e9llo \u00b2x w\u00f6rld"), (r"\B.", "ab c\u00b2d"),
    (r"(?<n>a)\k<n>|(?<=b)c", "aabc"), (r"\R", "a\r\nb\u2028"), (r"\X", "e\u0301"), (r"\Ga", "aab"),
])
def test_regex_constructs_match_oniguruma(pattern: str, text: str) -> None:
    """Oniguruma's class syntax (a leading ``]``, nested classes, ``&&``,
    with an empty operand too, POSIX brackets, escapes in ranges), anchors,
    word boundaries, line breaks and named groups; what Oniguruma rejects
    raises here too, and what Python's ``re`` lacks (``\\X``, ``\\G``)
    raises rather than reading otherwise."""
    try:
        want = [p for p, _ in pre_tokenizers.Split(Regex(pattern), "isolated").pre_tokenize_str(text)]
    except Exception:
        with pytest.raises(ValueError):
            _pattern({"Regex": pattern})
        return
    if pattern.startswith((r"\X", r"\G")):
        with pytest.raises(re.error):
            _pattern({"Regex": pattern})
        return
    ours = _pre_tokenizer({"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated", "invert": False})
    assert [p for p, _ in ours([(text, True)])] == want


def test_refused_and_rejected(tmp_path) -> None:
    """BPE dropout strictly between 0 and 1 is refused, saying why; a
    dropout outside [0, 1] and property names Oniguruma rejects raise, as
    in ``tokenizers``."""
    spec = _bpe_affixes()
    for dropout, error in ((0.1, NotImplementedError), (1.5, ValueError)):
        (tmp_path / "t.json").write_text(json.dumps({**spec, "model": {**spec["model"], "dropout": dropout}}))
        with pytest.raises(error, match="dropout"):
            HFTokenizer(str(tmp_path / "t.json"))
    for name in ("Foo", "Hrkt", "L&", "Age=1.1", "Is_Latin", "^"):
        with pytest.raises(Exception, match="Oniguruma"):
            pre_tokenizers.Split(Regex(rf"\p{{{name}}}"), "isolated")
        with pytest.raises(ValueError, match="Oniguruma"):
            _pattern({"Regex": rf"\p{{{name}}}"})


# --- whole-plane sweeps ------------------------------------------------------

_EMPTY = json.loads(Tokenizer(models.BPE()).to_str())


@pytest.mark.parametrize("spec", [
    {"type": "Nmt"}, {"type": "Strip", "strip_left": True, "strip_right": True},
    {"type": "Strip", "strip_left": False, "strip_right": True}, {"type": "ByteLevel"},
], ids=["nmt", "strip", "strip_right", "byte_level"])
def test_normalizers_match_tokenizers_on_every_code_point(spec: dict) -> None:
    """Each code point between letters (Nmt, ByteLevel) or at both ends of
    a line (Strip, one line a call)."""
    ref = Tokenizer.from_str(json.dumps({**_EMPTY, "normalizer": spec})).normalizer
    ours = _normalizer(spec)
    if spec["type"] == "Strip":
        got = [ours(f"{chr(cp)}a{chr(cp)}") for cp in _SWEEP]
        want = [ref.normalize_str(f"{chr(cp)}a{chr(cp)}") for cp in _SWEEP]
        bad = [hex(cp) for cp, g, w in zip(_SWEEP, got, want) if g != w]
        assert not bad, bad[:10]
        return
    for start in range(0, len(_SWEEP), 65536):
        text = "".join(f"a{chr(cp)}b" for cp in _SWEEP[start : start + 65536])
        assert ours(text) == ref.normalize_str(text), spec


@pytest.mark.parametrize("spec", [
    {"type": "WhitespaceSplit"}, {"type": "Punctuation", "behavior": "Isolated"},
    {"type": "Digits", "individual_digits": True}, {"type": "UnicodeScripts"},
], ids=["whitespace_split", "punctuation", "digits", "unicode_scripts"])
def test_pre_tokenizers_match_tokenizers_on_every_code_point(spec: dict) -> None:
    """Each code point between letters (Rust's is_whitespace, BERT's
    punctuation, Rust's is_numeric); for UnicodeScripts between Latin and
    Han, and every pair of neighbouring code points (its script classes,
    Any among them, join or cut there)."""
    ref = Tokenizer.from_str(json.dumps({**_EMPTY, "pre_tokenizer": spec})).pre_tokenizer
    ours = _pre_tokenizer(spec)
    scripts = spec["type"] == "UnicodeScripts"
    for start in range(0, len(_SWEEP), 65536):
        cps = _SWEEP[start : start + 65536]
        if scripts:
            text = "".join(f"a{chr(cp)}あ" for cp in cps) + "".join(map(chr, cps))
        else:
            text = "".join(f"a{chr(cp)}b" for cp in cps)
        want = [piece for piece, _ in ref.pre_tokenize_str(text)]
        assert [piece for piece, _ in ours([(text, True)])] == want, (spec, hex(cps[0]))


#: Sets of the sweeps: scripts (Hiragana and Katakana apart, as Oniguruma
#: keeps them), long category names and aliases, a negation, a block, a
#: binary property, and the shorthands Oniguruma reads otherwise than
#: Python's ``re`` (``\\w``, ``\\d``, ``\\s``).
SWEEP_SETS = [
    *(rf"\p{{{name}}}" for name in (
        "Han", "Hiragana", "Katakana", "Latin", "Cyrillic", "Common", "Letter", "Cn", "^L", "Alphabetic",
        "In_CJK_Unified_Ideographs",
    )),
    r"\w", r"\d", r"\s",
]


@pytest.mark.parametrize("one", SWEEP_SETS)
def test_regex_properties_match_oniguruma_on_every_code_point(one: str) -> None:
    """Runs of the set and of its complement less ``x`` (``[^..x]``) in a
    Split, over planes 0-3 and 14."""
    text = "".join(map(chr, _SWEEP))
    for pattern in (f"{one}+", f"[^{one}x]+"):
        ref = pre_tokenizers.Split(Regex(pattern), "isolated")
        ours = _pre_tokenizer({"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated", "invert": False})
        assert [p for p, _ in ours([(text, True)])] == [p for p, _ in ref.pre_tokenize_str(text)], pattern


def test_every_oniguruma_property_matches_on_a_sample() -> None:
    """Every set the tables hold (each script, block, binary property and
    general category Oniguruma accepts, aliases resolved to it), on every
    97th code point of the sweep and the ends of its ranges, and
    ``[^\\S]`` and ``[\\S]``."""
    sample = set(_SWEEP[::97])
    keys = {v: k for k, v in sorted(T.ONIG_ALIASES.items(), reverse=True)}  # one name a set
    for name in keys.values():
        ranges = U.onig_property(name)
        cps = sorted(sample | {cp for a, b in ranges[:200] for cp in (a, b) if not 0xD800 <= cp <= 0xDFFF})
        text = "".join(map(chr, cps))
        ref = pre_tokenizers.Split(Regex(rf"\p{{{name}}}"), "removed")
        kept = {cps[i] for _, (a, b) in ref.pre_tokenize_str(text) for i in range(a, b)}
        got = {cp for cp in cps if U._in(ranges, cp)}
        assert got == set(cps) - kept, name
    text = "".join(map(chr, _SWEEP[::7]))
    for pattern in (
        r"[^\S]", r"[\S]", r"[a\P{Lu}]", r"\P{^Lu}", r"[\p{^Lu}x]", r"[\w&&\p{^Latin}]+", r"[[:punct:]\d]",
        r"[^[:^alpha:]&&\p{L}]", r"[\p{Han}[a-f]&&[^\p{Lo}]]", r"\W+", r"[\D\H]", r"\b\w+\b", r"\B.",
    ):
        ref = pre_tokenizers.Split(Regex(pattern), "isolated")
        ours = _pre_tokenizer({"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated", "invert": False})
        assert [p for p, _ in ours([(text, True)])] == [p for p, _ in ref.pre_tokenize_str(text)], pattern


# --- the encoder -------------------------------------------------------------


def test_flax_encoder_truncates_and_pads_as_the_jax_package(tmp_path) -> None:
    """A tiny bge-base-shaped BERT (chip_smoke's writer, 2 layers, d 32, f32)
    whose tokenizer.json truncates to 12 and pads to a fixed 8: the port's
    ``count_tokens``, ids and token states equal the JAX package's."""
    import jax.numpy as jnp
    import torch

    from raglite_tpu.models.encoder import TransformerEncoder as JaxEncoder
    from raglite_tpu_torch.models.encoder import TransformerEncoder

    chip_smoke = importlib.import_module("chip_smoke")
    config = {**chip_smoke.BGE_BASE_CONFIG, "num_hidden_layers": 2, "hidden_size": 32, "num_attention_heads": 4,
              "intermediate_size": 64}
    spec = chip_smoke.wordpiece_tokenizer_json(chip_smoke._markdown_texts())
    spec["truncation"] = _trunc(12)
    spec["padding"] = {**_pad({"Fixed": 8}), "pad_token": "[PAD]"}
    root = tmp_path / "bert"
    root.mkdir()
    (root / "tokenizer.json").write_text(json.dumps(spec))
    chip_smoke.write_bge_m3_checkpoint(root, 13, config=config, device="cpu", dtype=torch.float32)
    texts = [
        "How does the glacier interact with the volcano in specimen 12? Café, naïve — 日本語 and more words.",
        "short one",
        "",
    ]
    jax_enc = JaxEncoder(str(root), dtype=jnp.float32)
    ours = TransformerEncoder(str(root), device="cpu", dtype=torch.float32)
    assert ours.count_tokens(texts) == jax_enc.count_tokens(texts) == [12, 8, 8]
    for text in texts:
        assert ours._tokenizer.encode(text) == jax_enc._tokenizer.encode(text)
        np.testing.assert_allclose(ours.embed_token_level(text), jax_enc.embed_token_level(text), rtol=1e-4, atol=1e-4)
