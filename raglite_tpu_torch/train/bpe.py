"""A byte-level BPE tokenizer trainer (counterpart of the ``tokenizers``
package's ``BpeTrainer`` as scripts/train_encoder.py:train_tokenizer
configures it: ``models.BPE(unk_token=None)``, ``pre_tokenizers.ByteLevel(
add_prefix_space=True)``, ``decoders.ByteLevel()``, the four specials and
every other option at its default).

``train_tokenizer(texts, vocab_size)`` returns the ``tokenizer.json`` object
that ``tokenizers`` 0.22 writes for the same texts, and ``write_tokenizer``
writes it as that package formats it.  The algorithm is the trainer's
(``tokenizers/src/models/bpe/trainer.rs``), step for step:

- Words: each text through the ByteLevel pre-tokenizer (a space prefixed
  unless the text starts with one, GPT-2's split, GPT-2's byte map), counted.
  An empty text gives no word.
- Ids: the specials first, then every character of the words sorted by code
  point (so ``Ġ``, U+0120, comes after ASCII), then the merges' tokens.
- Merges: a max-heap of (count, pair) entries, each with the set of words
  it was counted in.  The largest count wins; equal counts go to the pair
  of smaller ``(left id, right id)``.  An entry whose count is stale is
  pushed back with the current count, not dropped.  A merge is applied only
  to its entry's words; the words' new and lost pairs update the counts,
  and the pairs that gained occurrences get new entries (the merged pair's
  own count is left as it is, as the trainer leaves it).  Merging goes on
  down to a count of 1 and stops when the vocabulary reaches
  ``vocab_size`` (or no pair is left).
- A merge whose string is already a token keeps that token's id: the merge
  is recorded and the vocabulary does not grow.  A pair merged twice is
  written once, at its later rank (the model keeps merges in a map).
- With fewer ids allowed than specials plus characters, all of them are
  kept and no merge is made.
"""

from __future__ import annotations

import heapq
import json
from collections import Counter, defaultdict
from collections.abc import Iterable
from pathlib import Path

from raglite_tpu_torch.models.tokenizer import _pre_tokenizer

__all__ = [
    "SPECIAL_TOKENS", "VOCAB_SIZE", "corpus_texts", "learn_merges", "train_tokenizer", "word_counts", "write_tokenizer",
]

#: scripts/train_encoder.py's specials (ids 0-3: PAD, BOS, EOS, MASK) and
#: its ``base`` vocabulary.
SPECIAL_TOKENS = ("<pad>", "<s>", "</s>", "<mask>")
VOCAB_SIZE = 16_384
#: ``pre_tokenizers.ByteLevel(add_prefix_space=True)`` and
#: ``decoders.ByteLevel()`` as ``tokenizers`` writes them.
BYTE_LEVEL = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True}


def word_counts(texts: Iterable[str]) -> Counter:
    """The byte-level words of ``texts`` (the port's ByteLevel
    pre-tokenizer) and how often each occurs."""
    pre = _pre_tokenizer(BYTE_LEVEL)
    counts: Counter = Counter()
    for text in texts:
        if text:  # tokenizers prepends no space to an empty text: no word
            counts.update(word for word, _ in pre([(text, True)]))
    return counts


def _merge_word(symbols: list[int], a: int, b: int, new: int) -> list[tuple[tuple[int, int], int]]:
    """``Word::merge``: every (a, b) in ``symbols`` (left to right) replaced
    by ``new`` in place; returns the pair changes (pair, +1 or -1)."""
    changes = []
    i = 0
    while i < len(symbols):
        if symbols[i] == a and i + 1 < len(symbols) and symbols[i + 1] == b:
            if i > 0:
                changes.append(((symbols[i - 1], a), -1))
                changes.append(((symbols[i - 1], new), 1))
            symbols[i : i + 2] = [new]
            if i < len(symbols) - 1:
                changes.append(((b, symbols[i + 1]), -1))
                changes.append(((new, symbols[i + 1]), 1))
        i += 1
    return changes


def learn_merges(counts: dict[str, int], vocab_size: int, special_tokens=SPECIAL_TOKENS):
    """``BpeTrainer::do_train`` over word counts: (vocab {token: id},
    merges [(left, right)] in rank order)."""
    vocab: dict[str, int] = {}
    tokens: list[str] = []

    def add(token: str) -> None:
        if token not in vocab:
            vocab[token] = len(tokens)
            tokens.append(token)

    for token in special_tokens:
        add(token)
    for char in sorted({c for word in counts for c in word}):
        add(char)
    words = [[vocab[c] for c in word] for word in counts]
    freq = list(counts.values())
    pair_counts: dict[tuple[int, int], int] = defaultdict(int)
    where: dict[tuple[int, int], set[int]] = defaultdict(set)
    for i, word in enumerate(words):
        for pair in zip(word, word[1:]):
            pair_counts[pair] += freq[i]
            where[pair].add(i)
    # Entries (-count, left id, right id, order, words): heapq's least is
    # the trainer's greatest Merge; ``order`` only keeps sets uncompared.
    heap: list = []
    order = 0

    def push(pair: tuple[int, int], pos: set[int]) -> None:
        nonlocal order
        heapq.heappush(heap, (-pair_counts[pair], *pair, order, pos))
        order += 1

    def push_counted() -> None:  # the pairs counted since the last push
        for pair, pos in where.items():
            if pair_counts[pair] > 0:
                push(pair, pos)
        where.clear()

    push_counted()
    merges: list[tuple[int, int]] = []
    while len(vocab) < vocab_size and heap:
        neg, a, b, _, pos = heapq.heappop(heap)
        if -neg != pair_counts[(a, b)]:
            push((a, b), pos)
            continue
        if -neg < 1:
            break
        token = tokens[a] + tokens[b]
        add(token)
        new = vocab[token]
        merges.append((a, b))
        for i in pos:
            f = freq[i]
            for pair, change in _merge_word(words[i], a, b, new):
                pair_counts[pair] += change * f
                if change > 0:
                    where[pair].add(i)
        push_counted()
    rank = {pair: r for r, pair in enumerate(merges)}  # a repeated pair keeps its last rank
    return vocab, [(tokens[a], tokens[b]) for (a, b), _ in sorted(rank.items(), key=lambda item: item[1])]


def train_tokenizer(texts: Iterable[str], vocab_size: int = VOCAB_SIZE, special_tokens=SPECIAL_TOKENS) -> dict:
    """The ``tokenizer.json`` object ``tokenizers`` writes after
    ``train_from_iterator(texts, BpeTrainer(vocab_size, special_tokens))``."""
    vocab, merges = learn_merges(word_counts(texts), vocab_size, special_tokens)
    added = [
        {"id": vocab[t], "content": t, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
         "special": True}
        for t in dict.fromkeys(special_tokens)
    ]
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added, "normalizer": None,
        "pre_tokenizer": dict(BYTE_LEVEL), "post_processor": None, "decoder": dict(BYTE_LEVEL),
        "model": {
            "type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
            "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
            "vocab": vocab, "merges": [list(m) for m in merges],
        },
    }


def write_tokenizer(spec: dict, path: Path) -> None:
    """``spec`` as ``Tokenizer.save`` formats it (two-space indents,
    characters unescaped, no final newline)."""
    Path(path).write_text(json.dumps(spec, indent=2, ensure_ascii=False), encoding="utf-8")


def corpus_texts(path: Path):
    """The ``text`` of each line of a train.corpus ``*.jsonl``."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            yield json.loads(line)["text"]
