"""The encoder's training corpus from text already on the machine, and its
token cache (counterpart of scripts/build_corpus.py and of
scripts/train_encoder.py:build_token_cache).

``harvest`` walks documentation files (``*.md``, ``*.rst``, ``*.txt``)
and Python docstrings under ``roots`` (by default the running
interpreter's ``sysconfig`` purelib and platlib, since a machine may keep
its packages elsewhere than the script's fixed ``DOC_ROOTS``), splits them
into sections, drops short (< 280 characters) and mostly-code sections,
and dedupes by normalized content hash.  ``main`` writes ``train.jsonl``
and ``heldout.jsonl`` ({"id", "title", "text"} a line) with the script's
stable id-hash split.  ``build_token_cache`` tokenizes ``train.jsonl``
with the port's ``HFTokenizer`` (the ids ``tokenizers`` gives) into
``tokens.npz``: ``flat`` uint16 ids and ``offsets`` int64 document bounds.

Usage:  python -m raglite_tpu_torch.train.corpus [--out DIR] [--max-mb 80]
        [--roots DIR ...] [--heldout-pct 5]
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import re
import sysconfig
import time
from pathlib import Path

import numpy as np

__all__ = ["DEFAULT_CORPUS", "build_token_cache", "default_roots", "harvest", "load_tokens", "write_corpus"]

#: The repository's git-ignored data directory (the script's layout).
DATA = Path(__file__).resolve().parents[2] / "data"
DEFAULT_CORPUS = DATA / "corpus"
TEXT_SUFFIXES = (".md", ".rst", ".txt")
SKIP_FILE_PAT = re.compile(r"license|copying|notice|authors|record|metadata", re.I)
SKIP_DIRS = {"__pycache__", "node_modules", ".git"}

# Heading detection for the section splitter: markdown ATX, rst over/underline.
_MD_HEADING = re.compile(r"^(#{1,6})\s+(.+?)\s*#*\s*$")
_RST_UNDERLINE = re.compile(r"^([=\-~^\"'`#*+.])\1{3,}\s*$")
_CODE_FENCE = re.compile(r"^(```|~~~)")
# Lines that are mostly markup/code, used for the prose-ratio filter.
_WORD = re.compile(r"[A-Za-z]{2,}")


def default_roots() -> list[str]:
    """The running interpreter's site-packages (purelib, then platlib if it
    differs)."""
    paths = sysconfig.get_paths()
    return list(dict.fromkeys([paths["purelib"], paths["platlib"]]))


def _prose_ratio(text: str) -> float:
    """Fraction of characters inside plain English words — filters out
    parameter tables, code blocks, and symbol soup."""
    words = _WORD.findall(text)
    return sum(len(w) for w in words) / max(len(text), 1)


def _clean(text: str) -> str:
    # Strip common rst roles/directives inline markup, keep the prose.
    text = re.sub(r"\.\. [a-z-]+::.*$", "", text, flags=re.M)
    text = re.sub(r":[a-z]+:`~?([^`]+)`", r"\1", text)
    text = re.sub(r"``([^`]*)``", r"\1", text)
    text = re.sub(r"`([^`]*)`_?", r"\1", text)
    text = re.sub(r"\*\*?([^*]*)\*\*?", r"\1", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()


def _sections_from_doc(path: str, raw: str):
    """Split a documentation file into (title, body) sections at headings."""
    lines = raw.splitlines()
    sections: list[tuple[str, list[str]]] = [(os.path.basename(path), [])]
    in_fence = False
    for line in lines:
        if _CODE_FENCE.match(line):
            in_fence = not in_fence
            continue
        if in_fence:
            continue
        m = _MD_HEADING.match(line)
        if m:
            sections.append((m.group(2), []))
            continue
        if (
            _RST_UNDERLINE.match(line)
            and sections[-1][1]
            and sections[-1][1][-1].strip()
            and len(line) >= len(sections[-1][1][-1].strip()) * 0.8
        ):
            title = sections[-1][1].pop().strip()
            sections.append((title, []))
            continue
        sections[-1][1].append(line)
    for title, body_lines in sections:
        body = _clean("\n".join(body_lines))
        if body:
            yield title.strip("# ").strip(), body


def _docstrings_from_py(path: str, src: str):
    """(qualified name, docstring) for module/class/function docstrings."""
    try:
        tree = ast.parse(src)
    except (SyntaxError, ValueError):
        return
    mod = os.path.basename(path).removesuffix(".py")
    doc = ast.get_docstring(tree)
    if doc:
        yield mod, doc
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            doc = ast.get_docstring(node)
            if doc:
                yield f"{mod}.{node.name}", doc


def harvest(max_bytes: int, roots: list[str] | None = None):
    """Yield (id, title, text) documents up to ~max_bytes of total text."""
    seen: set[str] = set()
    emitted = 0
    ordered_files: list[tuple[str, bool]] = []  # (path, is_python)
    for root in roots or default_roots():
        for dirpath, dirs, files in os.walk(root):
            dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS)
            for f in sorted(files):
                if f.endswith(TEXT_SUFFIXES) and not SKIP_FILE_PAT.search(f):
                    ordered_files.append((os.path.join(dirpath, f), False))
                elif f.endswith(".py"):
                    ordered_files.append((os.path.join(dirpath, f), True))
    # Documentation files first (highest prose density), then docstrings.
    ordered_files.sort(key=lambda x: x[1])
    for path, is_py in ordered_files:
        if emitted >= max_bytes:
            return
        try:
            with open(path, encoding="utf-8", errors="ignore") as fh:
                raw = fh.read(2_000_000)
        except OSError:
            continue
        producer = _docstrings_from_py(path, raw) if is_py else _sections_from_doc(path, raw)
        for title, body in producer:
            body = _clean(body)
            if len(body) < 280 or _prose_ratio(body) < 0.55:
                continue
            # Normalized-content dedup: vendored copies repeat wholesale.
            norm = re.sub(r"\s+", " ", body.lower())[:2000]
            digest = hashlib.sha1(norm.encode()).hexdigest()  # noqa: S324
            if digest in seen:
                continue
            seen.add(digest)
            emitted += len(body)
            yield digest[:16], title[:200], body
            if emitted >= max_bytes:
                return


def write_corpus(out: Path, max_mb: float, roots: list[str] | None = None, heldout_pct: float = 5.0) -> dict:
    """Harvest into ``out/train.jsonl`` and ``out/heldout.jsonl``; returns
    the script's summary (documents and MB on each side)."""
    out.mkdir(parents=True, exist_ok=True)
    n_train = n_held = b_train = b_held = 0
    with open(out / "train.jsonl", "w") as train, open(out / "heldout.jsonl", "w") as held:
        for doc_id, title, text in harvest(int(max_mb * 1e6), roots):
            line = json.dumps({"id": doc_id, "title": title, "text": text}) + "\n"
            # Stable id-hash split: held-out docs are never trained on.
            bucket = int(doc_id[:4], 16) % 1000
            if bucket < heldout_pct * 10:
                held.write(line)
                n_held += 1
                b_held += len(text)
            else:
                train.write(line)
                n_train += 1
                b_train += len(text)
    return {
        "train_docs": n_train, "train_mb": round(b_train / 1e6, 1),
        "heldout_docs": n_held, "heldout_mb": round(b_held / 1e6, 1), "out": str(out),
    }


def build_token_cache(corpus: Path, out: Path, tokenizer: str) -> dict:
    """Tokenize ``corpus/train.jsonl`` once into ``out`` (``tokens.npz``: a
    flat uint16 array and the document offsets); returns the counts."""
    from raglite_tpu_torch.models.tokenizer import load_tokenizer

    tok = load_tokenizer(tokenizer)
    ids_all: list[np.ndarray] = []
    offsets = [0]
    t0 = time.time()
    with open(corpus / "train.jsonl") as f:
        for line in f:
            arr = np.asarray(tok.encode(json.loads(line)["text"]), dtype=np.uint16)
            ids_all.append(arr)
            offsets.append(offsets[-1] + arr.size)
    flat = np.concatenate(ids_all) if ids_all else np.zeros(0, np.uint16)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, flat=flat, offsets=np.asarray(offsets, np.int64))
    return {"tokens": int(flat.size), "docs": len(offsets) - 1, "s": time.time() - t0}


def load_tokens(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(flat ids, document offsets) of a ``tokens.npz``."""
    with np.load(path) as z:
        return z["flat"], z["offsets"]


def main(argv: list[str] | None = None) -> dict:
    """Write the corpus; returns (and prints) its summary."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_CORPUS)
    parser.add_argument("--max-mb", type=float, default=80.0)
    parser.add_argument("--heldout-pct", type=float, default=5.0)
    parser.add_argument("--roots", nargs="+", help="directories to harvest (default: this interpreter's site-packages)")
    args = parser.parse_args(argv)
    summary = write_corpus(args.out, args.max_mb, args.roots, args.heldout_pct)
    print(json.dumps(summary))  # noqa: T201
    return summary


if __name__ == "__main__":
    main()
