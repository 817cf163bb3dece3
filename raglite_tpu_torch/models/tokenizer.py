"""Tokenizers (counterpart of raglite_tpu/models/tokenizer.py).

- ``ByteTokenizer``: dependency-free UTF-8 byte tokenizer (ids 0-255 plus
  specials) for hermetic runs, presets and orbax checkpoints.
- ``HFTokenizer``: a pure-Python reader of a HuggingFace ``tokenizer.json``
  that gives the ``tokenizers`` package's ids and decoded text without that
  package (the card's machine has none).  It runs the file's pipeline:
  added tokens (``special``, ``normalized``, ``lstrip``, ``rstrip``,
  ``single_word``), then the normalizer (``NFC``, ``NFD``, ``NFKC``,
  ``NFKD``, ``Lowercase``, ``StripAccents``, ``BertNormalizer``,
  ``Precompiled``, ``Prepend``, ``Replace``, ``Sequence``), the
  pre-tokenizer (``ByteLevel``, ``Split``, ``Metaspace``,
  ``BertPreTokenizer``, ``Whitespace``, ``Sequence``) and the model (``BPE``
  with ``byte_fallback``, ``ignore_merges``, ``fuse_unk``; ``Unigram`` by
  Viterbi over the piece scores, with ``byte_fallback``; ``WordPiece``,
  greedy longest match first); ``decode`` runs the decoder (``ByteLevel``,
  ``Metaspace``, ``WordPiece``, ``ByteFallback``, ``Fuse``, ``Strip``,
  ``Replace``, ``Sequence``; with none, tokens joined by spaces, as
  ``tokenizers`` does) and skips special added tokens.  Any other component
  raises ``NotImplementedError`` naming it.  The Unicode properties the
  components read are those of ``tokenizers``' own tables
  (models/unicode_props.py), and ``Precompiled`` (XLM-R's SentencePiece
  charsmap) looks extended grapheme clusters up whole, as ``tokenizers``
  does.
  Split patterns in the Oniguruma syntax of ``tokenizers`` (``\\p{L}``,
  ``\\p{N}``, ``\\s``, ``(?i:...)``) are translated to Python ``re`` with
  the Unicode classes spelled out.  The special ids come from the sibling
  ``config.json``, as in the JAX package.
- ``load_tokenizer``: the ``HFTokenizer`` of a checkpoint's
  ``tokenizer.json`` (``required=False``: the byte tokenizer, with a
  warning, where there is none).
"""

from __future__ import annotations

import base64
import heapq
import json
import os
import re
import struct
import sys
import unicodedata
import warnings
from functools import lru_cache
from typing import Callable

from raglite_tpu_torch.models import unicode_props as U

__all__ = ["ByteTokenizer", "HFTokenizer", "load_tokenizer"]


class ByteTokenizer:
    """UTF-8 bytes shifted past the 3 special ids (pad, bos, eos) of the JAX
    package's byte tokenizer; deterministic and lossless."""

    PAD, BOS, EOS = 0, 1, 2
    EOS_IDS = (2,)
    _OFFSET = 3

    def __init__(self, vocab_size: int = 8192) -> None:
        self.vocab_size = max(vocab_size, 256 + self._OFFSET)

    def encode(self, text: str) -> list[int]:
        return [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        # Ids in [259, vocab_size) are unused vocabulary: skipped, since
        # unconstrained sampling can emit any id of the vocabulary.
        data = bytes(i - self._OFFSET for i in ids if self._OFFSET <= i < self._OFFSET + 256)
        return data.decode("utf-8", errors="replace")


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable character map (ByteLevel)."""
    keep = [*range(ord("!"), ord("~") + 1), *range(0xA1, 0xAC + 1), *range(0xAE, 0xFF + 1)]
    chars = list(keep)
    extra = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + extra)
            extra += 1
    return {b: chr(c) for b, c in zip(keep, chars)}


#: Unicode White_Space (what ``\s`` means in the patterns of ``tokenizers``;
#: Python's ``\s`` also takes \x1c-\x1f).
_WHITESPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


@lru_cache(maxsize=8)
def _category_class(prefix: str) -> str:
    """Regex class body of every code point whose general category starts
    with ``prefix`` ("L" for \\p{L}, "N" for \\p{N}, "Lu" ...); Python's
    ``re`` has no \\p{...}."""
    ranges: list[list[int]] = []
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if ranges and ranges[-1][1] == cp - 1:
                ranges[-1][1] = cp
            else:
                ranges.append([cp, cp])
    return "".join(
        re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
        for a, b in ranges
    )


def _translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of ``tokenizers`` as Python ``re``: ``\\p{X}``
    and ``\\s`` spelled out (inside a class too), ``\\P{X}`` and ``\\S``
    outside one; every other construct is passed through."""
    out: list[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP" and pattern[i + 2 : i + 3] == "{":
                end = pattern.index("}", i)
                name = pattern[i + 3 : end]
                if not (1 <= len(name) <= 2 and name[0].isupper()):
                    msg = f"regex property \\{nxt}{{{name}}} is not supported"
                    raise NotImplementedError(msg)
                body = _category_class(name)
                if nxt == "P":
                    if in_class:
                        msg = f"negated property \\P{{{name}}} inside a class is not supported"
                        raise NotImplementedError(msg)
                    out.append(f"[^{body}]")
                else:
                    out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt == "s":
                out.append(_WHITESPACE if in_class else f"[{_WHITESPACE}]")
            elif nxt == "S":
                if in_class:
                    msg = "\\S inside a class is not supported"
                    raise NotImplementedError(msg)
                out.append(f"[^{_WHITESPACE}]")
            else:
                out.append(pattern[i : i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


def _pattern(spec: dict) -> re.Pattern:
    """A ``{"String": s}`` (literal) or ``{"Regex": r}`` pattern."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    return re.compile(_translate_regex(spec["Regex"]))


#: GPT-2's pre-tokenizer pattern (ByteLevel with ``use_regex``).
_GPT2_SPLIT = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


@lru_cache(maxsize=1)
def _gpt2_split() -> re.Pattern:
    return re.compile(_translate_regex(_GPT2_SPLIT))


# --- normalizers --------------------------------------------------------------


class _Precompiled:
    """SentencePiece's precompiled charsmap as ``tokenizers`` applies it:
    each extended grapheme cluster of fewer than 6 UTF-8 bytes is looked up
    whole, else (or where that finds nothing) each of its characters; a
    lookup takes the shortest key that is a prefix of the chunk, and its
    replacement stands for the whole chunk (so a cluster whose first
    character is a key loses the marks after it, as in ``tokenizers``).

    The charsmap (base64) holds the trie's byte size (u32, little-endian),
    the trie as darts-clone double-array units over the keys' UTF-8 bytes,
    and the NUL-terminated replacements."""

    def __init__(self, charsmap: str) -> None:
        blob = base64.b64decode(charsmap)
        if len(blob) < 4:
            msg = "Precompiled: the charsmap is shorter than its header"
            raise ValueError(msg)
        (size,) = struct.unpack_from("<I", blob)
        count = size // 4
        self._units = struct.unpack_from(f"<{count}I", blob, 4)
        self._replacements = blob[4 + size :]
        self._lookups: dict[str, str | None] = {}

    def _lookup(self, chunk: str) -> str | None:
        """The replacement of the shortest key that prefixes ``chunk``."""
        hit = self._lookups.get(chunk, self)
        if hit is not self:
            return hit
        units, out = self._units, None
        unit = units[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for byte in chunk.encode("utf-8"):
            if byte == 0:
                break
            pos ^= byte
            if pos >= len(units) or (units[pos] & ((1 << 31) | 0xFF)) != byte:
                break
            unit = units[pos]
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                start = units[pos] & ((1 << 31) - 1)
                end = self._replacements.find(b"\0", start)
                out = self._replacements[start : end if end >= 0 else None].decode("utf-8")
                break
        if len(self._lookups) < 100_000:
            self._lookups[chunk] = out
        return out

    def __call__(self, s: str) -> str:
        out: list[str] = []
        for cluster in U.graphemes(s):
            if len(cluster.encode("utf-8")) < 6:
                norm = self._lookup(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in cluster:
                norm = self._lookup(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def _bert_normalizer(spec: dict) -> Callable[[str], str]:
    """``BertNormalizer``: drop NUL, U+FFFD and control characters (other
    than tab, newline and carriage return) and turn white space into spaces,
    pad CJK ideographs with spaces, strip accents (NFD, then Mn removed;
    ``strip_accents`` null follows ``lowercase``), lowercase."""
    clean, chinese = spec.get("clean_text", True), spec.get("handle_chinese_chars", True)
    lowercase = spec.get("lowercase", True)
    strip = lowercase if spec.get("strip_accents") is None else spec["strip_accents"]

    def bert(s: str) -> str:
        if clean:
            s = "".join(
                " " if c in U.WHITESPACE else c
                for c in s
                if not (c in "\0\ufffd" or (c not in "\t\n\r" and U.is_other(c)))
            )
        if chinese:
            s = "".join(f" {c} " if U.is_chinese_char(c) else c for c in s)
        if strip:
            s = "".join(c for c in U.normalize("NFD", s) if not U.is_nonspacing_mark(c))
        if lowercase:
            s = "".join(map(U.lower, s))
        return s

    return bert


def _normalizer(spec: dict | None) -> Callable[[str], str] | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: U.normalize(kind, s)
    if kind == "Lowercase":
        return lambda s: "".join(map(U.lower, s))
    if kind == "StripAccents":
        return lambda s: "".join(c for c in s if not U.is_combining_mark(c))
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind == "Precompiled":
        return _Precompiled(spec["precompiled_charsmap"])
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda s: prefix + s if s else s
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: rx.sub(lambda _: content, s)
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def sequence(s: str) -> str:
            for step in steps:
                s = step(s)
            return s

        return sequence
    msg = f"tokenizer.json normalizer {kind!r} is not supported"
    raise NotImplementedError(msg)


# --- pre-tokenizers -----------------------------------------------------------

#: A piece of text and whether it starts at offset 0 of the encoded string.
Piece = tuple[str, bool]


def _split(text: str, first: bool, rx: re.Pattern, behavior: str, invert: bool = False) -> list[Piece]:
    """``NormalizedString::split`` of ``tokenizers``: the text cut into the
    pattern's matches and the gaps between them, then joined per
    ``behavior``; empty pieces are dropped."""
    spans: list[list] = []  # [start, end, is_match]
    prev = 0
    for m in rx.finditer(text):
        if m.start() != prev:
            spans.append([prev, m.start(), invert])
        spans.append([m.start(), m.end(), not invert])
        prev = m.end()
    if prev != len(text):
        spans.append([prev, len(text), invert])
    if behavior == "Removed":
        kept = [(a, b) for a, b, is_match in spans if not is_match]
    elif behavior == "Isolated":
        kept = [(a, b) for a, b, _ in spans]
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        kept, previous = [], False
        for a, b, is_match in spans:
            join = is_match == previous if behavior == "Contiguous" else is_match and not previous
            if join and kept:
                kept[-1] = (kept[-1][0], b)
            else:
                kept.append((a, b))
            previous = is_match
    elif behavior == "MergedWithNext":
        kept, previous = [], False
        for a, b, is_match in reversed(spans):
            if is_match and not previous and kept:
                kept[-1] = (a, kept[-1][1])
            else:
                kept.append((a, b))
            previous = is_match
        kept.reverse()
    else:
        msg = f"Split behavior {behavior!r} is not supported"
        raise NotImplementedError(msg)
    return [(text[a:b], first and a == 0) for a, b in kept if b > a]


def _split_classes(text: str, first: bool, classify: Callable[[str], int]) -> list[Piece]:
    """Runs of characters of one class, class 1 (white space) dropped and
    class 3 (BERT's punctuation) one character a piece."""
    out: list[Piece] = []
    start, run = 0, None
    for i, c in enumerate(text):
        cls = classify(c)
        if cls == run and cls != 3:
            continue
        if run is not None and run != 1:
            out.append((text[start:i], first and start == 0))
        start, run = i, cls
    if run is not None and run != 1:
        out.append((text[start:], first and start == 0))
    return out


def _bert_class(c: str) -> int:
    """BertPreTokenizer's split: white space removed, each punctuation
    character isolated."""
    if c in U.WHITESPACE:
        return 1
    return 3 if U.is_punctuation(c) else 0


def _pre_tokenizer(spec: dict | None) -> Callable[[list[Piece]], list[Piece]]:
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def sequence(pieces: list[Piece]) -> list[Piece]:
            for step in steps:
                pieces = step(pieces)
            return pieces

        return sequence
    if kind == "Split":
        rx, behavior, invert = _pattern(spec["pattern"]), spec["behavior"], bool(spec.get("invert", False))
        return lambda pieces: [p for text, first in pieces for p in _split(text, first, rx, behavior, invert)]
    if kind == "ByteLevel":
        prefix, use_regex, byte_map = bool(spec.get("add_prefix_space", True)), spec.get("use_regex", True), _bytes_to_unicode()

        def byte_level(pieces: list[Piece]) -> list[Piece]:
            out = []
            for text, first in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                words = _split(text, first, _gpt2_split(), "Isolated") if use_regex else [(text, first)]
                out.extend(("".join(byte_map[b] for b in w.encode("utf-8")), f) for w, f in words)
            return out

        return byte_level
    if kind == "Metaspace":
        repl = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or ("always" if spec.get("add_prefix_space", True) else "never")
        split, rx = spec.get("split", True), re.compile(re.escape(repl))

        def metaspace(pieces: list[Piece]) -> list[Piece]:
            out = []
            for text, first in pieces:
                text = text.replace(" ", repl)
                if not text.startswith(repl) and (scheme == "always" or (scheme == "first" and first)):
                    text = repl + text
                out.extend(_split(text, first, rx, "MergedWithNext") if split else [(text, first)])
            return out

        return metaspace
    if kind in ("BertPreTokenizer", "Whitespace"):
        classify = _bert_class if kind == "BertPreTokenizer" else U.word_class
        return lambda pieces: [p for text, first in pieces for p in _split_classes(text, first, classify)]
    msg = f"tokenizer.json pre_tokenizer {kind!r} is not supported"
    raise NotImplementedError(msg)


# --- models -------------------------------------------------------------------


def _byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


class _BPE:
    """``tokenizers``' BPE: characters (or their byte tokens, or the unk
    token, fused) merged by rank, lowest rank then leftmost first."""

    def __init__(self, spec: dict) -> None:
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout"):
            if spec.get(key):
                msg = f"BPE {key}={spec[key]!r} is not supported"
                raise NotImplementedError(msg)
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.id_to_token = {i: t for t, i in self.vocab.items()}

    def tokenize(self, word: str) -> list[int]:
        vocab = self.vocab
        if self.ignore_merges and word in vocab:
            return [vocab[word]]
        ids: list[int] = []
        unk: tuple[int, int] | None = None  # a pending (fused) unk: (id, chars)
        for ch in word:
            tid = vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    ids.append(unk[0])
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                byte_ids = [vocab.get(_byte_token(b)) for b in ch.encode("utf-8")]
                if None not in byte_ids:
                    ids.extend(byte_ids)
                    continue
            if self.unk is not None:
                unk_id = vocab[self.unk]
                if unk is not None and not self.fuse_unk:
                    ids.append(unk[0])
                unk = (unk_id, 0)
        if unk is not None:
            ids.append(unk[0])
        return self._merge(ids)

    def _merge(self, ids: list[int]) -> list[int]:
        merges = self.merges
        n = len(ids)
        if n < 2:
            return ids
        sym = list(ids)
        prev = list(range(-1, n - 1))
        nxt = [*range(1, n), -1]
        alive = [True] * n
        heap = [(*merges[(sym[i], sym[i + 1])], i) for i in range(n - 1) if (sym[i], sym[i + 1]) in merges]
        heap = [(rank, pos, new) for rank, new, pos in heap]
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new:
                continue  # an expired entry
            sym[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] != -1:
                m = merges.get((sym[prev[pos]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, keep in zip(sym, alive) if keep]


class _Unigram:
    """``tokenizers``' Unigram: the best-scoring segmentation by Viterbi over
    the pieces' log-probabilities, a character no piece starts with scored
    as unk (the lowest score less 10), consecutive unks fused, then unk
    pieces as byte tokens where ``byte_fallback`` has them."""

    _UNK_PENALTY = 10.0

    def __init__(self, spec: dict) -> None:
        pieces = spec["vocab"]
        self.ids = {p: i for i, (p, _) in enumerate(pieces)}
        self.scores = [float(s) for _, s in pieces]
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.min_score = min(self.scores)
        self.max_len = max(len(p) for p, _ in pieces)
        self.id_to_token = {i: p for i, (p, _) in enumerate(pieces)}
        self.vocab = self.ids

    def _segments(self, s: str) -> list[str]:
        n = len(s)
        best: list[tuple[float, int, int] | None] = [None] * (n + 1)  # (score, start, id)
        best[0] = (0.0, -1, -1)
        unk_score = self.min_score - self._UNK_PENALTY
        for start in range(n):
            here = best[start][0]
            single = False
            for length in range(1, min(self.max_len, n - start) + 1):
                tid = self.ids.get(s[start : start + length])
                if tid is None:
                    continue
                cand = here + self.scores[tid]
                node = best[start + length]
                if node is None or cand > node[0]:
                    best[start + length] = (cand, start, tid)
                single = single or length == 1
            if not single:
                if self.unk_id is None:
                    msg = "Unigram model without unk_id met a character no piece covers"
                    raise ValueError(msg)
                node = best[start + 1]
                cand = here + unk_score
                if node is None or cand > node[0]:
                    best[start + 1] = (cand, start, self.unk_id)
        out: list[str] = []
        unk_run: list[str] = []
        end = n
        while end > 0:
            _, start, tid = best[end]
            if self.unk_id is not None and tid == self.unk_id:
                unk_run.append(s[start:end])
            else:
                if unk_run:
                    out.append("".join(reversed(unk_run)))
                    unk_run = []
                out.append(s[start:end])
            end = start
        if unk_run:
            out.append("".join(reversed(unk_run)))
        out.reverse()
        return out

    def tokenize(self, word: str) -> list[int]:
        ids: list[int] = []
        for seg in self._segments(word):
            tid = self.ids.get(seg)
            if tid is None:
                if self.byte_fallback:
                    byte_ids = [self.ids.get(_byte_token(b)) for b in seg.encode("utf-8")]
                    if None not in byte_ids:
                        ids.extend(byte_ids)
                        continue
                tid = self.unk_id
            ids.append(tid)
        return ids


class _WordPiece:
    """``tokenizers``' WordPiece: the longest vocabulary piece from the
    start of the word, then from where it ended (with the continuing-subword
    prefix), and so on; a word with no such split, or of more than
    ``max_input_chars_per_word`` characters, is the unk token."""

    def __init__(self, spec: dict) -> None:
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))
        self.id_to_token = {i: t for t, i in self.vocab.items()}

    def _unk(self) -> list[int]:
        tid = self.vocab.get(self.unk)
        if tid is None:
            msg = f"WordPiece: the unk token {self.unk!r} is not in the vocabulary"
            raise ValueError(msg)
        return [tid]

    def tokenize(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return self._unk()
        ids: list[int] = []
        start = 0
        while start < len(word):
            for end in range(len(word), start, -1):
                tid = self.vocab.get(word[start:end] if start == 0 else self.prefix + word[start:end])
                if tid is not None:
                    break
            else:
                return self._unk()
            ids.append(tid)
            start = end
        return ids


def _model(spec: dict):
    kind = spec.get("type") or ("BPE" if "merges" in spec else "Unigram" if isinstance(spec.get("vocab"), list) else None)
    if kind == "BPE":
        return _BPE(spec)
    if kind == "Unigram":
        return _Unigram(spec)
    if kind == "WordPiece":
        return _WordPiece(spec)
    msg = f"tokenizer.json model {kind!r} is not supported"
    raise NotImplementedError(msg)


# --- decoders -----------------------------------------------------------------


#: The WordPiece decoder's ``cleanup`` replacements, in order.
_CLEANUP = (
    (" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
    (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"),
)


def _cleanup(text: str) -> str:
    for old, new in _CLEANUP:
        text = text.replace(old, new)
    return text


def _decoder(spec: dict | None) -> Callable[[list[str]], list[str]] | None:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "ByteLevel":
        inverse = {c: b for b, c in _bytes_to_unicode().items()}

        def byte_level(tokens: list[str]) -> list[str]:
            data = bytearray()
            for tok in tokens:
                raw = [inverse.get(c) for c in tok]
                data.extend(tok.encode("utf-8") if None in raw else raw)
            return [data.decode("utf-8", errors="replace")]

        return byte_level
    if kind == "Metaspace":
        repl = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or ("always" if spec.get("add_prefix_space", True) else "never")

        def metaspace(tokens: list[str]) -> list[str]:
            # Every replacement of the first token is dropped, the others
            # become spaces (``tokenizers`` 0.22).
            return [
                "".join(("" if i == 0 and scheme != "never" else " ") if c == repl else c for c in tok)
                for i, tok in enumerate(tokens)
            ]

        return metaspace
    if kind == "WordPiece":
        prefix, cleanup = spec.get("prefix", "##"), spec.get("cleanup", True)

        def wordpiece(tokens: list[str]) -> list[str]:
            out = []
            for i, tok in enumerate(tokens):
                if i:
                    tok = tok[len(prefix) :] if tok.startswith(prefix) else " " + tok
                out.append(_cleanup(tok) if cleanup else tok)
            return out

        return wordpiece
    if kind == "ByteFallback":

        def byte_fallback(tokens: list[str]) -> list[str]:
            out: list[str] = []
            pending = bytearray()

            def flush() -> None:
                if pending:
                    try:
                        out.append(pending.decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("�" * len(pending))
                    pending.clear()

            for tok in tokens:
                if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                    try:
                        pending.append(int(tok[3:5], 16))
                        continue
                    except ValueError:
                        pass
                flush()
                out.append(tok)
            flush()
            return out

        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0))

        def strip(tokens: list[str]) -> list[str]:
            out = []
            for tok in tokens:
                a = 0
                while a < min(start, len(tok)) and tok[a] == content:
                    a += 1
                b = len(tok)
                while len(tok) - b < stop and b > a and tok[b - 1] == content:
                    b -= 1
                out.append(tok[a:b])
            return out

        return strip
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"]), spec["content"]
        return lambda tokens: [rx.sub(lambda _: content, tok) for tok in tokens]
    if kind == "Sequence":
        steps = [_decoder(d) for d in spec["decoders"]]

        def sequence(tokens: list[str]) -> list[str]:
            for step in steps:
                tokens = step(tokens)
            return tokens

        return sequence
    msg = f"tokenizer.json decoder {kind!r} is not supported"
    raise NotImplementedError(msg)


# --- the tokenizer ------------------------------------------------------------


class _AddedTokens:
    """Added tokens matched leftmost-longest (``tokenizers``' Aho-Corasick
    with ``LeftmostLongest``), with ``single_word``, ``lstrip`` and
    ``rstrip``."""

    _WORD_END = re.compile(r"\w$")
    _WORD_START = re.compile(r"^\w")
    _SPACE_END = re.compile(f"[{_WHITESPACE}]*$")
    _SPACE_START = re.compile(f"^[{_WHITESPACE}]*")

    def __init__(self, tokens: list[dict], patterns: list[str]) -> None:
        by_pattern: dict[str, dict] = {}
        for tok, pat in zip(tokens, patterns):
            if pat:
                by_pattern.setdefault(pat, tok)
        self.tokens = by_pattern
        order = sorted(by_pattern, key=len, reverse=True)
        self.rx = re.compile("|".join(re.escape(p) for p in order)) if order else None

    def split(self, text: str) -> list[tuple[int, int, dict | None]]:
        """(start, end, added token or None) covering ``text``; no empty
        pieces."""
        if not text:
            return []
        if self.rx is None:
            return [(0, len(text), None)]
        out: list[tuple[int, int, dict | None]] = []
        pos = 0
        for m in self.rx.finditer(text):
            start, stop = m.start(), m.end()
            tok = self.tokens[m.group()]
            if tok.get("single_word") and (
                (start > 0 and self._WORD_END.search(text[:start])) or (stop < len(text) and self._WORD_START.search(text[stop:]))
            ):
                continue
            if tok.get("lstrip"):
                start = max(self._SPACE_END.search(text[:start]).start(), pos)
            if tok.get("rstrip"):
                stop += self._SPACE_START.match(text[stop:]).end()
            if start > pos:
                out.append((pos, start, None))
            out.append((start, stop, tok))
            pos = stop
        if pos != len(text):
            out.append((pos, len(text), None))
        return out


class HFTokenizer:
    """A ``tokenizer.json``'s pipeline in pure Python (module docstring).

    Special ids come from the checkpoint's ``config.json``
    (``pad/bos/eos_token_id``; several eos ids all stop generation) and,
    where it has none, from a probe over the common special-token names, as
    in the JAX package."""

    def __init__(self, path: str, *, special_ids: dict | None = None) -> None:
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        self._model = _model(spec["model"])
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode = _decoder(spec.get("decoder"))
        added = spec.get("added_tokens") or []
        self._added_ids = {t["content"]: t["id"] for t in added}
        self._special = {t["id"] for t in added if t.get("special")}
        plain = [t for t in added if not t.get("normalized", not t.get("special"))]
        normed = [t for t in added if t.get("normalized", not t.get("special"))]
        norm = self._normalize or (lambda s: s)
        self._raw_added = _AddedTokens(plain, [t["content"] for t in plain])
        self._norm_added = _AddedTokens(normed, [norm(t["content"]) for t in normed])
        self._vocab = {**self._model.vocab, **self._added_ids}
        self._id_to_token = {**self._model.id_to_token, **{i: t for t, i in self._added_ids.items()}}
        self.vocab_size = len(self._vocab)
        self._cache: dict[str, tuple[int, ...]] = {}

        special_ids = special_ids or {}

        def resolved(key: str, *names: str, default: int) -> int:
            value = special_ids.get(key)
            if isinstance(value, int):
                return value
            if isinstance(value, list) and value and isinstance(value[0], int):
                return value[0]
            for name in names:
                tid = self.token_id(name)
                if tid is not None:
                    return tid
            return default

        self.PAD = resolved("pad_token_id", "<pad>", "<|endoftext|>", default=0)
        self.BOS = resolved("bos_token_id", "<s>", "<bos>", "<|begin_of_text|>", "<|im_start|>", default=1)
        self.EOS = resolved(
            "eos_token_id", "</s>", "<eos>", "<|end_of_text|>", "<|im_end|>", "<|endoftext|>", default=2
        )
        eos_value = special_ids.get("eos_token_id")
        if isinstance(eos_value, list):
            self.EOS_IDS = tuple(i for i in eos_value if isinstance(i, int)) or (self.EOS,)
        else:
            self.EOS_IDS = (self.EOS,)

    def token_id(self, token: str) -> int | None:
        return self._vocab.get(token)

    def _word_ids(self, word: str) -> tuple[int, ...]:
        hit = self._cache.get(word)
        if hit is None:
            hit = tuple(self._model.tokenize(word))
            if len(self._cache) < 100_000:
                self._cache[word] = hit
        return hit

    def encode(self, text: str) -> list[int]:
        """Ids of ``text`` without a post-processor's specials
        (``add_special_tokens=False``, as the JAX package encodes)."""
        out: list[int] = []
        for a, b, tok in self._raw_added.split(text):
            if tok is not None:
                out.append(tok["id"])
                continue
            piece = text[a:b]
            if self._normalize is not None:
                piece = self._normalize(piece)
            first = a == 0
            for c, d, ntok in self._norm_added.split(piece):
                if ntok is not None:
                    out.append(ntok["id"])
                    continue
                for word, _ in self._pre([(piece[c:d], first and c == 0)]):
                    out.extend(self._word_ids(word))
        return out

    def decode(self, ids: list[int]) -> str:
        """Text of ``ids``, special added tokens skipped (the default of
        ``tokenizers``' decode, which the JAX package calls)."""
        tokens = [self._id_to_token[i] for i in ids if i in self._id_to_token and i not in self._special]
        if self._decode is None:
            return " ".join(tokens)
        return "".join(self._decode(tokens))


def load_tokenizer(path: str, *, required: bool = True):
    """The checkpoint's ``tokenizer.json`` with special ids from the sibling
    ``config.json``.  A missing file raises (byte ids fed into a BPE
    embedding table give meaningless output with no error anywhere);
    ``required=False`` returns the byte tokenizer with a warning instead
    (numerics-only use)."""
    if not os.path.exists(path):
        msg = (
            f"tokenizer.json not found at {path}; a pretrained checkpoint must ship its tokenizer "
            "(the byte tokenizer is only valid for presets and orbax checkpoints trained with it)"
        )
        if required:
            raise FileNotFoundError(msg)
        warnings.warn(msg + " — falling back to the byte tokenizer", stacklevel=2)
        return ByteTokenizer()
    special_ids: dict = {}
    config_path = os.path.join(os.path.dirname(path), "config.json")
    if os.path.exists(config_path):
        with open(config_path) as f:
            hf = json.load(f)
        special_ids = {k: hf[k] for k in ("pad_token_id", "bos_token_id", "eos_token_id") if hf.get(k) is not None}
    return HFTokenizer(path, special_ids=special_ids)
