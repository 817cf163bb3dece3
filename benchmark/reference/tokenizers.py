"""Plain tokenizers for the reference and the traffic generator.

- :class:`ByteLevelBPE` reads a ``tokenizer.json`` whose model is BPE behind
  a ByteLevel pre-tokenizer (GPT-2's scheme: an optional prefix space, the
  GPT-2 split pattern, bytes mapped to printable characters, merges applied
  lowest rank first) with no normalizer and no post-processor, and encodes
  as the ``tokenizers`` library does for such a file.  The split pattern
  needs Unicode classes (the ``regex`` module); without that module only
  ASCII text is accepted, where ``[A-Za-z]`` and ``[0-9]`` are the classes.
- :class:`Bytes` is a UTF-8 byte tokenizer: each byte plus an id offset.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

__all__ = ["ByteLevelBPE", "Bytes", "load_tokenizer"]

#: GPT-2's pre-tokenizer pattern (Unicode classes, and an ASCII stand-in).
_GPT2_SPLIT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
_ASCII_SPLIT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"""


@lru_cache(maxsize=1)
def _byte_chars() -> dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    keep = [*range(ord("!"), ord("~") + 1), *range(0xA1, 0xAC + 1), *range(0xAE, 0xFF + 1)]
    chars = list(keep)
    extra = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + extra)
            extra += 1
    return {b: chr(c) for b, c in zip(keep, chars)}


class ByteLevelBPE:
    """Byte-level BPE over a ``tokenizer.json`` (see the module docstring)."""

    def __init__(self, path: str | Path) -> None:
        spec = json.loads(Path(path).read_text(encoding="utf-8"))
        model, pre = spec["model"], spec.get("pre_tokenizer") or {}
        if model.get("type") != "BPE" or pre.get("type") != "ByteLevel":
            msg = f"{path}: not a ByteLevel BPE tokenizer"
            raise ValueError(msg)
        if spec.get("normalizer") or spec.get("post_processor"):
            msg = f"{path}: normalizers and post-processors are not part of this reference"
            raise ValueError(msg)
        self.add_prefix_space = bool(pre.get("add_prefix_space", True))
        self.vocab: dict[str, int] = model["vocab"]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        try:
            import regex

            self._split = regex.compile(_GPT2_SPLIT).findall
            self.ascii_only = False
        except ImportError:
            import re

            self._split = re.compile(_ASCII_SPLIT).findall
            self.ascii_only = True
        self._cache: dict[str, list[int]] = {}

    def _word(self, word: str) -> list[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        chars = _byte_chars()
        parts = [chars[b] for b in word.encode("utf-8")]
        while len(parts) > 1:
            ranked = [(self.ranks.get(pair, -1), i) for i, pair in enumerate(zip(parts, parts[1:]))]
            ranked = [(r, i) for r, i in ranked if r >= 0]
            if not ranked:
                break
            first, second = parts[min(ranked)[1]], parts[min(ranked)[1] + 1]
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = [self.vocab[p] for p in parts]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        if self.ascii_only and not text.isascii():
            msg = "without the regex module this reference tokenizes ASCII text only"
            raise ValueError(msg)
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        return [i for word in self._split(text) for i in self._word(word)]


class Bytes:
    """UTF-8 bytes shifted past ``offset`` special ids."""

    def __init__(self, offset: int = 3) -> None:
        self.offset = offset

    def encode(self, text: str) -> list[int]:
        return [b + self.offset for b in text.encode("utf-8")]


def load_tokenizer(spec: dict, root: Path):
    """The tokenizer a configuration file's ``reference.tokenizer`` names:
    ``{"kind": "bpe", "file": <path from the checkout's root>}`` or
    ``{"kind": "bytes", "offset": 3}``."""
    if spec["kind"] == "bpe":
        return ByteLevelBPE(root / spec["file"])
    if spec["kind"] == "bytes":
        return Bytes(int(spec.get("offset", 3)))
    msg = f"unknown tokenizer kind {spec['kind']!r}"
    raise ValueError(msg)
