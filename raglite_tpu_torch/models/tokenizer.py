"""Tokenizers for the encoder (counterpart of raglite_tpu/models/tokenizer.py).

- ``ByteTokenizer``: dependency-free UTF-8 byte tokenizer (ids 0-255 plus
  specials) for hermetic runs and tests.
- ``BPETokenizer``: a pure-Python reader of a HuggingFace ``tokenizer.json``
  holding a byte-level BPE (the packaged encoder's: ``ByteLevel``
  pre-tokenizer with ``add_prefix_space`` and the GPT-2 split pattern, no
  normalizer, added special tokens).  It gives the ids of the
  ``tokenizers`` package without needing it.
- ``load_tokenizer``: the ``BPETokenizer`` of a checkpoint's
  ``tokenizer.json``.

``ByteTokenizer`` also decodes and carries the special ids the decoder LLM
stops on; the HF tokenizers of pretrained decoders wait with ``hf:``
checkpoints (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache

__all__ = ["BPETokenizer", "ByteTokenizer", "load_tokenizer"]


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


#: Unicode White_Space (what the split pattern's \s means in ``tokenizers``).
_WHITESPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


def _category_class(prefix: str) -> str:
    """Regex class body of every code point whose general category starts
    with ``prefix`` ("L" for \\p{L}, "N" for \\p{N}); Python's ``re`` has
    neither."""
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


@lru_cache(maxsize=1)
def _split_pattern() -> re.Pattern:
    """GPT-2's pre-tokenizer pattern,
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
    with the Unicode classes spelled out."""
    letters, numbers, space = _category_class("L"), _category_class("N"), _WHITESPACE
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"
        rf"| ?[^{space}{letters}{numbers}]+|[{space}]+(?![^{space}])|[{space}]+"
    )


class BPETokenizer:
    """Byte-level BPE from a ``tokenizer.json`` (model ``BPE``, pre-tokenizer
    ``ByteLevel``).  Added tokens are cut out of the raw text first (longest
    match at the leftmost position); every other piece gets a leading space
    unless it starts with one (``add_prefix_space``), is split by the GPT-2
    pattern, mapped byte by byte to printable characters, and merged by
    rank."""

    def __init__(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model, pre = spec["model"], spec.get("pre_tokenizer") or {}
        if model.get("type") != "BPE" or pre.get("type") != "ByteLevel" or spec.get("normalizer"):
            msg = f"{path}: only byte-level BPE tokenizers without a normalizer are supported"
            raise NotImplementedError(msg)
        self._vocab: dict[str, int] = model["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in model["merges"]]
        self._ranks = {pair: rank for rank, pair in enumerate(merges)}
        self._prefix_space = bool(pre.get("add_prefix_space", False))
        self._byte_map = _bytes_to_unicode()
        self._added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self._added_re = (
            re.compile("|".join(re.escape(t) for t in sorted(self._added, key=len, reverse=True)))
            if self._added
            else None
        )
        self._cache: dict[str, tuple[int, ...]] = {}

    def _word_ids(self, word: str) -> tuple[int, ...]:
        """BPE of one pre-tokenized word (already byte-mapped), cached."""
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        # Characters outside the vocabulary are dropped (no unk token), so
        # their neighbours become adjacent, as in ``tokenizers``.
        parts = [c for c in word if c in self._vocab]
        ranks = self._ranks
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                rank = ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best, best_rank = i, rank
            if best is None:
                break
            pair = (parts[best], parts[best + 1])
            merged: list[str] = []
            i = 0
            while i < len(parts):  # every occurrence, left to right
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == pair:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = tuple(self._vocab[p] for p in parts)
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return ids

    def _encode_piece(self, text: str, out: list[int]) -> None:
        if not text:
            return
        if self._prefix_space and not text.startswith(" "):
            text = " " + text
        byte_map = self._byte_map
        for word in _split_pattern().findall(text):
            out.extend(self._word_ids("".join(byte_map[b] for b in word.encode("utf-8"))))

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        pos = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                self._encode_piece(text[pos : m.start()], out)
                out.append(self._added[m.group()])
                pos = m.end()
        self._encode_piece(text[pos:], out)
        return out


def load_tokenizer(path: str) -> BPETokenizer:
    """Load a checkpoint's ``tokenizer.json``.  A missing file raises: byte
    ids fed into a BPE embedding table give meaningless embeddings."""
    if not os.path.exists(path):
        msg = f"tokenizer.json not found at {path}; a checkpoint must ship its tokenizer"
        raise FileNotFoundError(msg)
    return BPETokenizer(path)
