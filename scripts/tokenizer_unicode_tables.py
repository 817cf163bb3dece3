"""Write raglite_tpu_torch/models/unicode_tables.py: the code points where
the ``tokenizers`` package's Unicode properties differ from what
raglite_tpu_torch/models/unicode_props.py derives from Python's
``unicodedata``.

Each property is probed on every code point through the ``tokenizers``
component that reads it (BertNormalizer, BertPreTokenizer, StripAccents,
Lowercase, NFC/NFD/NFKC/NFKD, Whitespace, and Precompiled charsmaps for
grapheme clusters), and the port's own derivation is compared with it.  Run
it with the ``tokenizers`` version the port is held to (0.22.2) and the
Python the port runs on, then check the tests:

    python scripts/tokenizer_unicode_tables.py
    python -m pytest tests/test_torch_hf_tokenizer.py -q
"""

from __future__ import annotations

import base64
import importlib
import json
import sys
import time
import unicodedata
from pathlib import Path

import tokenizers
from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "raglite_tpu_torch" / "models" / "unicode_tables.py"

CODE_POINTS = [cp for cp in range(sys.maxunicode + 1) if not 0xD800 <= cp <= 0xDFFF]


def ranges(cps) -> tuple[tuple[int, int], ...]:
    out: list[list[int]] = []
    for cp in sorted(cps):
        if out and out[-1][1] == cp - 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return tuple((a, b) for a, b in out)


def precompiled(mapping: dict[str, str]):
    """A ``tokenizers`` normalizer over a charsmap built by chip_smoke.py's
    writer (the one the tests hold the port's reader to)."""
    import chip_smoke

    spec = json.loads(Tokenizer(models.BPE(vocab={"a": 0}, merges=[])).to_str())
    charsmap = base64.b64encode(chip_smoke.precompiled_charsmap(mapping)).decode()
    spec["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": charsmap}
    return Tokenizer.from_str(json.dumps(spec)).normalizer


def main() -> None:
    # The port's derivations, without corrections.
    import raglite_tpu_torch.models.unicode_tables as tables

    for name in ("OTHER_FIX", "PUNCT_FIX", "MN_FIX", "MARK_FIX", "WORD_FIX", "SPACE_FIX", "JOIN_FIX", "PREPEND_FIX", "PICT_FIX"):
        setattr(tables, name, ())
    tables.NF_FIXED = {"NFC": (), "NFD": (), "NFKC": (), "NFKD": ()}
    tables.LOWER_FIX = {}
    props = importlib.reload(importlib.import_module("raglite_tpu_torch.models.unicode_props"))

    t0 = time.time()
    fixes: dict[str, set[int]] = {k: set() for k in ("OTHER", "PUNCT", "MN", "MARK", "WORD", "SPACE", "JOIN", "PREPEND", "PICT")}
    nf_fixed: dict[str, set[int]] = {f: set() for f in ("NFC", "NFD", "NFKC", "NFKD")}
    lower_fix: dict[str, str] = {}
    clean = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False, strip_accents=False, lowercase=False)
    strip_mn = normalizers.BertNormalizer(clean_text=False, handle_chinese_chars=False, strip_accents=True, lowercase=False)
    strip_m, low = normalizers.StripAccents(), normalizers.Lowercase()
    nf = {f: getattr(normalizers, f)() for f in nf_fixed}
    bert_pre, ws_pre = pre_tokenizers.BertPreTokenizer(), pre_tokenizers.Whitespace()
    join, pict = precompiled({"a": "X"}), precompiled({"\u00a9": "X"})
    for cp in CODE_POINTS:
        c = chr(cp)
        if c not in "\t\n\r\0\ufffd":
            other = clean.normalize_str(c) == ""
            if other != props.is_other(c):
                fixes["OTHER"].add(cp)
        pieces = len(bert_pre.pre_tokenize_str("a" + c + "a"))
        if pieces != 2 and (pieces == 3) != props.is_punctuation(c):
            fixes["PUNCT"].add(cp)
        for form, norm in nf.items():
            got = norm.normalize_str(c)
            if got != unicodedata.normalize(form, c):
                if got != c:
                    raise SystemExit(f"{form} of U+{cp:04X} is {got!r}: neither Python's nor the code point itself")
                nf_fixed[form].add(cp)
        if nf["NFD"].normalize_str(c) == c and (strip_mn.normalize_str(c) == "") != props.is_nonspacing_mark(c):
            fixes["MN"].add(cp)
        if (strip_m.normalize_str(c) == "") != props.is_combining_mark(c):
            fixes["MARK"].add(cp)
        lowered = low.normalize_str(c)
        if lowered != c.lower():
            lower_fix[c] = lowered
        pieces = len(ws_pre.pre_tokenize_str("a" + c + "a"))
        word = pieces == 1
        if word != (unicodedata.category(c)[0] in "LM" or unicodedata.category(c) in ("Nd", "Pc", "Nl")):
            fixes["WORD"].add(cp)
        if not word and (pieces == 2) != (c in props.WHITESPACE):
            fixes["SPACE"].add(cp)
        joined = join.normalize_str("a" + c) == "X"
        if c != "a" and joined != (props._base_class(c) in (props.EXTEND, props.ZWJ, props.SPACING)):
            fixes["JOIN"].add(cp)
        if not joined and c != "\u00a9":
            crate_pict = pict.normalize_str("\u00a9\u200d" + c) == "X\u200d" + c
            if crate_pict != (props._base_class(c) == props.PICT):
                fixes["PICT"].add(cp)
    print(f"swept {len(CODE_POINTS)} code points in {time.time() - t0:.0f} s", flush=True)
    # Prepend: a key for every code point of a block; c + "a" is one
    # cluster (looked up whole, the shortest key "c" replacing it) iff c
    # is Prepend.
    block = 4096
    for start in range(0, sys.maxunicode + 1, block):
        cps = [cp for cp in range(start, start + block) if not 0xD800 <= cp <= 0xDFFF and chr(cp) not in "a\n\r"]
        norm = precompiled({chr(cp): "Y" for cp in cps})
        for cp in cps:
            joined = norm.normalize_str(chr(cp) + "a") == "Y"
            if joined != (props._base_class(chr(cp)) == props.PREPEND):
                fixes["PREPEND"].add(cp)
    print(f"prepend probed in {time.time() - t0:.0f} s", flush=True)

    def fmt(rs) -> str:
        body = ", ".join(f"(0x{a:04X}, 0x{b:04X})" for a, b in rs)
        return f"({body},)" if rs else "()"

    lines = [
        '"""Code points where ``tokenizers`` ' + tokenizers.__version__ + "'s Unicode properties differ from",
        "models/unicode_props.py's derivations from Python's ``unicodedata`` (Unicode "
        + unicodedata.unidata_version + "),",
        "as inclusive ranges.  Written by scripts/tokenizer_unicode_tables.py; do not",
        'edit by hand."""',
        "",
    ]
    for key, cps in fixes.items():
        lines.append(f"{key}_FIX = {fmt(ranges(cps))}")
    lines.append("NF_FIXED = {" + ", ".join(f'"{f}": {fmt(ranges(cps))}' for f, cps in nf_fixed.items()) + "}")
    lines.append("LOWER_FIX = {" + ", ".join(f"{k!r}: {v!r}" for k, v in sorted(lower_fix.items())) + "}")
    OUT.write_text("\n".join(lines) + "\n")
    print({k: len(v) for k, v in {**fixes, **nf_fixed}.items()}, len(lower_fix), f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
